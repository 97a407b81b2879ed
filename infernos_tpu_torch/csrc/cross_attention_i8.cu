// Int8-direct cross-attention of one decode step, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the port of the reference's XLA path
// infernos_tpu/models/layers.py::cross_attention_step_i8 between its q and
// o projections (STTEngineConfig.cross_int8_direct).  For each (batch, head)
// it reads the int8 cross cache of one layer as it is stored, codes and
// per-position scales, and never writes a dequantized copy:
//   qs = max(|q|, 1e-8) / 127,  qq = clip(rint(q / qs), -127, 127)
//   logit[s] = float(qq . kq[s]) * qs * ks[s]    (NEG_INF where masked)
//   w = exp(logit - max) / sum,  wp = w * vs
//   ws = max(wp, 1e-20) / 127,  wq = clip(rint(wp / ws), 0, 127)
//   out = float(wq . vq) * ws                     (cast to q's type)
// Both dot products are s8 x s8 -> s32 and exact (127 * 127 * S < 2^31 for
// S < 133,144); rint rounds half to even, as jnp.round and torch.round do,
// and every quotient is an IEEE division, as the reference's.  A row whose
// positions are all masked gets uniform weights (NEG_INF is the finite
// -1e9), not NaN.
//
// Bound on an H100 SXM: the bytes.  At whisper-large-v3's decode step
// [B 16, H 20, S 1500, Dh 64] one call reads 30.72 MB of K codes, 3.84 MB
// of scales and the V rows whose weight's code is not 0 (11% of them at
// random data): 0.0114 ms at 3.35 TB/s, 32 calls a step.  The 61 M integer
// MACs are nothing beside that.  K rows of masked positions outside the
// span of a block's valid ones, and V rows of code 0, are not read.
//
// Design (ops/cross_attention_i8.py cross_i8_plan picks C and the threads;
// ops/cross_attention_i8_ablate.py times the parts):
// - each (batch, head) is a thread-block cluster of C blocks (1-8); block r
//   owns positions [r R, (r + 1) R), R = ceil(S / C), so that 320 heads
//   become one wave of blocks spread evenly over the 132 SMs;
// - one thread streams the K codes of the block's valid span through a
//   slot of NT rows by cp.async.bulk, one chunk at a time on one mbarrier,
//   the first issued at entry (after the mask's span where there is a
//   mask); the scales of the span go to shared memory by cp.async, waited
//   for after the K pass; 4 threads a K row, 4 rows a thread a chunk;
// - the row max, the sum of exps and the max of wp are merged across the
//   cluster through distributed shared memory: each block sends its value
//   to every peer by st.async, counted on the peer's mbarrier; the softmax
//   passes walk only the span (all of the range for a row masked whole);
// - the positions of non-zero weight codes are compacted into a list in
//   shared memory (a ballot per warp), and only those V rows are loaded,
//   by cp.async into the K slot and the scale arrays (free by then), up
//   to 8 batches of NT / 4 rows in flight;
// - every block sends its int32 P.V sums to the leader, which adds them
//   (integer sums are exact, so the split moves no output bit).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;       // head dim, compile-time
constexpr int SUB = 4;       // threads a 64-byte row, 16 bytes each
constexpr int MAXC = 8;      // cluster sizes 1, 2, 4, 8
constexpr int PASSES = 4;    // K rows a thread group takes from a chunk
constexpr int MAX_VBATCH = 8;  // V batches in flight
constexpr float NEG_INF = -1e9f;
constexpr int SMEM_MAX = 232448;
constexpr int STATIC_SMEM = 4096;  // an upper bound of the static arrays below
constexpr int RESIDENT_THREADS = 1280;  // __launch_bounds__: this many threads an SM

#ifdef XI8_TRACE
// per block: clock64() at the entry and after each phase, %globaltimer at
// the entry and the end (ops/cross_attention_i8_ablate.py reads it)
constexpr int TRACE_BLOCKS = 4096, TRACE_SLOTS = 8;
__device__ long long g_trace[TRACE_BLOCKS][TRACE_SLOTS];
__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(i)                                                                          \
  do {                                                                                    \
    __syncthreads();                                                                      \
    if (threadIdx.x == 0 && blockIdx.x < TRACE_BLOCKS) g_trace[blockIdx.x][i] = clock64(); \
  } while (0)
#else
#define TRACE(i) \
  do {           \
  } while (0)
#endif

struct Params {
  const void* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const uint8_t* mask;
  void* out;
  int8_t* codes;
  int H, S;
  int C, R;  // cluster size, positions a block
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------- async copies
__device__ __forceinline__ void mbar_init(uint32_t addr, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t addr, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(addr),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completion is counted on the mbarrier at mbar
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most n (0..MAX_VBATCH - 1) committed groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// ------------------------------------------------------- the cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the address of this block's shared `local` in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer(const void* local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(local)), "r"(rank));
  return out;
}

// 4 bytes into a peer's shared memory, counted on the peer's mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// ------------------------------------------------------- reductions
template <int WARPS>
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w]);
  return v;
}

template <int WARPS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < WARPS; ++w) v += red[w];
  return v;
}

// every block's v (each thread holds its block's) merged over the cluster
// in rank order: every block sends v into slot[rank] of every peer, each
// counted on the peer's mbarrier `bar` (armed for C - 1 values), and waits
// for the peers' values on its own
__device__ __forceinline__ float cluster_merge(float v, float* slot, uint64_t* bar, int C,
                                               int rank, bool is_max) {
  if (C == 1) return v;
  const int t = threadIdx.x;
  if (t < C && t != rank) st_async(peer(&slot[rank], t), __float_as_uint(v), peer(bar, t));
  mbar_wait(smem_u32(bar), 0);
  float r = rank == 0 ? v : slot[0];
  for (int i = 1; i < C; ++i) {
    const float x = i == rank ? v : slot[i];
    r = is_max ? fmaxf(r, x) : r + x;
  }
  return r;
}

// byte k (0..3) of x as a signed int
__device__ __forceinline__ int sbyte(int x, int k) { return (x << (24 - 8 * k)) >> 24; }

template <typename T, int NT>
__global__ void __launch_bounds__(NT, RESIDENT_THREADS / NT) cross_i8_kernel(const Params p) {
  constexpr int WARPS = NT / 32;
  constexpr int ROWS = NT / SUB;     // rows a pass of the block
  constexpr int SR = PASSES * ROWS;  // rows a K chunk: NT
  constexpr int OFF = SR * DH;       // bytes of the K slot, before the per-position arrays
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t kbar;
  __shared__ __align__(8) uint64_t xbar[4];  // the peers' values of xch[0..2], part
  __shared__ __align__(16) int8_t qq[DH];
  __shared__ float red[WARPS];
  __shared__ int span_lo[WARPS], span_hi[WARPS];
  __shared__ float qa_w[2];
  __shared__ float xch[3][MAXC];  // the cluster's maxima, sums, wp maxima
  __shared__ int part[MAXC][DH];  // the leader's: each block's P.V sums
  __shared__ int n_live;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid & (SUB - 1), row = tid / SUB;
  const int C = p.C, S = p.S, R = p.R;
  const int rank = C > 1 ? (int)cluster_rank() : 0;
  const int bh = blockIdx.x / C, b = bh / p.H;
  const int r0 = min(S, rank * R), r1 = min(S, r0 + R);  // the block's positions

  uint8_t* kslot = smem;
  float* ks_s = reinterpret_cast<float*>(smem + OFF);          // [R] K scales of the span
  float* vs_s = ks_s + ((R + 3) & ~3);                         // [R] V scales
  float* logit = vs_s + ((R + 3) & ~3);                        // [R] logits, exps, wp
  int* list = reinterpret_cast<int*>(logit + ((R + 3) & ~3));  // [R] mask bytes, then V rows
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(list);
  // once the codes are known, the K slot and both scale arrays hold V
  // rows: vslots batches of ROWS rows
  const int vslots = min(MAX_VBATCH, (OFF + 8 * ((R + 3) & ~3)) / (ROWS * DH));

#ifdef XI8_TRACE
  if (tid == 0 && blockIdx.x < TRACE_BLOCKS) g_trace[blockIdx.x][6] = gtimer();
#endif
  TRACE(0);
  // K rows [c SR, ...) of the span [v0, v0 + span) into the slot
  auto issue = [&](int c, int v0, int span) {
    const int n = min(SR, span - c * SR);
    const uint32_t bar = smem_u32(&kbar);
    mbar_expect_tx(bar, n * DH);
    bulk_g2s(smem_u32(kslot), p.kq + ((size_t)bh * S + v0 + (size_t)c * SR) * DH, n * DH, bar);
  };
  // q (its first two warps), ahead of the K rows in the memory's queues
  const float qv = tid < DH ? to_f32(static_cast<const T*>(p.q)[(size_t)bh * DH + tid]) : 0.f;
  if (tid == 0) {
    mbar_init(smem_u32(&kbar), 1);
    if (C > 1)
      for (int i = 0; i < 4; ++i) {
        mbar_init(smem_u32(&xbar[i]), 1);
        mbar_expect_tx(smem_u32(&xbar[i]), (i < 3 ? 4 : 4 * DH) * (C - 1));
      }
    n_live = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (p.mask == nullptr && r1 > r0)  // the span is the range: its K is in flight from here
      issue(0, r0, r1 - r0);
  }
  // the peers' barriers are armed before anything is sent to them
  if (C > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the span [v0, v1) of the range's valid positions
  int lo = r1, hi = r0 - 1;
  if (p.mask) {
    const uint8_t* mrow = p.mask + (size_t)b * S;
    for (int s0 = r0; s0 < r1; s0 += 4 * NT) {
      uint8_t mv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + u * NT + tid;
        mv[u] = s < r1 ? mrow[s] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + u * NT + tid;
        if (s < r1) mask_s[s - r0] = mv[u];
        if (mv[u]) {
          lo = min(lo, s);
          hi = max(hi, s);
        }
      }
    }
  } else if (r1 > r0) {
    lo = r0, hi = r1 - 1;
  }
  float a = fabsf(qv);
  for (int o = 16; o; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  }
  if (lane == 0) {
    span_lo[warp] = lo;
    span_hi[warp] = hi;
    if (warp < 2) qa_w[warp] = a;
  }
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    lo = min(lo, span_lo[w]);
    hi = max(hi, span_hi[w]);
  }
  const int v0 = lo <= hi ? lo : r0, v1 = lo <= hi ? hi + 1 : r0;  // the span
  const int span = v1 - v0;
  const int nchunks = (span + SR - 1) / SR;
  if (tid == 0 && p.mask && nchunks) issue(0, v0, span);
  // both scales of the span, waited for after the K pass
  for (int s = v0 + tid; s < v1; s += NT) {
    cp_async4(smem_u32(&ks_s[s - r0]), p.ks + (size_t)bh * S + s);
    cp_async4(smem_u32(&vs_s[s - r0]), p.vs + (size_t)bh * S + s);
  }
  cp_async_commit();
  // q's codes and scale
  const float qs = fmaxf(fmaxf(qa_w[0], qa_w[1]), 1e-8f) / 127.0f;
  if (tid < DH) qq[tid] = (int8_t)fminf(fmaxf(rintf(qv / qs), -127.0f), 127.0f);
  __syncthreads();
  TRACE(1);

  // qq . kq of the span times qs: 4 threads a K row, PASSES rows a thread
  // a chunk
  const int4 qv4 = reinterpret_cast<const int4*>(qq)[sub];
  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(smem_u32(&kbar), c & 1);
    const int4* rows4 = reinterpret_cast<const int4*>(kslot);
#pragma unroll
    for (int pp = 0; pp < PASSES; ++pp) {
      const int j = pp * ROWS + row;  // in the slot
      const int i = c * SR + j;       // in the span
      const bool in = i < span;
      const int4 kv = in ? rows4[j * SUB + sub] : make_int4(0, 0, 0, 0);
      int acc = __dp4a(kv.x, qv4.x, 0);
      acc = __dp4a(kv.y, qv4.y, acc);
      acc = __dp4a(kv.z, qv4.z, acc);
      acc = __dp4a(kv.w, qv4.w, acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (sub == 0 && in) logit[v0 + i - r0] = (float)acc * qs;
    }
    __syncthreads();  // the slot is read
    if (tid == 0 && c + 1 < nchunks) issue(c + 1, v0, span);
  }
  // the logits: K's scales and the mask
  cp_async_wait_all();
  __syncthreads();
  float mx = -INFINITY;
#pragma unroll 4
  for (int s = v0 + tid; s < v1; s += NT) {
    const float l = (p.mask == nullptr || mask_s[s - r0]) ? logit[s - r0] * ks_s[s - r0] : NEG_INF;
    logit[s - r0] = l;
    mx = fmaxf(mx, l);
  }
  TRACE(2);
#ifdef XI8_ABLATE_SOFTMAX  // the K pass alone
  if (tid < DH && rank == 0)
    store(static_cast<T*>(p.out) + (size_t)bh * DH + tid, span ? logit[tid % span] : 0.f);
  return;
#endif

  // softmax in fp32 over the cluster; masked positions outside the span
  // hold NEG_INF
  float m = block_max<WARPS>(mx, red);
  if (v0 > r0 || v1 < r1) m = fmaxf(m, NEG_INF);
  if (C > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const float M = cluster_merge(m, xch[0], &xbar[0], C, rank, true);
  // where exp(NEG_INF - M) is 0 (the row has a valid position), only the
  // span has weight; else every position of the range, whose V scales
  // load while the exponentials run
  const bool all = expf(NEG_INF - M) != 0.0f;
  const int w0 = all ? r0 : v0, w1 = all ? r1 : v1;
  if (all)
    for (int s = r0 + tid; s < r1; s += NT)
      cp_async4(smem_u32(&vs_s[s - r0]), p.vs + (size_t)bh * S + s);
  float sum = 0.0f;
#pragma unroll 4
  for (int s = w0 + tid; s < w1; s += NT) {
    const float x = s >= v0 && s < v1 ? logit[s - r0] : NEG_INF;
    const float e = expf(x - M);
    logit[s - r0] = e;
    sum += e;
  }
  if (all) cp_async_wait_all();
  const float L = cluster_merge(block_sum<WARPS>(sum, red), xch[1], &xbar[1], C, rank, false);
  float wmax = 0.0f;
#pragma unroll 4
  for (int s = w0 + tid; s < w1; s += NT) {
    const float w = logit[s - r0] / L;
    const float wp = w != 0.0f ? w * vs_s[s - r0] : 0.0f;
    logit[s - r0] = wp;
    wmax = fmaxf(wmax, wp);
  }
  const float ws =
      fmaxf(cluster_merge(block_max<WARPS>(wmax, red), xch[2], &xbar[2], C, rank, true),
            1e-20f) / 127.0f;
  // the weights' codes; the live ones (not 0) listed as (position << 8 | code)
  for (int base = r0; base < r1; base += NT) {
    const int s = base + tid;
    int c = 0;
    if (s < r1 && s >= w0 && s < w1)
      c = (int)fminf(fmaxf(rintf(logit[s - r0] / ws), 0.0f), 127.0f);
    if (p.codes && s < r1) p.codes[(size_t)bh * S + s] = (int8_t)c;
    const unsigned live = __ballot_sync(0xffffffffu, c != 0);
    int at = 0;
    if (lane == 0 && live) at = atomicAdd(&n_live, __popc(live));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (c) list[at + __popc(live & ((1u << lane) - 1))] = ((s - r0) << 8) | c;
  }
  __syncthreads();
  TRACE(3);
  const int n = n_live;
#ifdef XI8_ABLATE_V  // the K pass and the softmax
  if (tid < DH && rank == 0)
    store(static_cast<T*>(p.out) + (size_t)bh * DH + tid, (float)n * ws);
  return;
#endif

  // P.V over the live rows, ROWS a batch through the K slot and the scale
  // arrays (free now), vslots batches in flight (a cp.async group each, 16
  // bytes a thread): 4 threads a row, 16 dims each
  const int nb = (n + ROWS - 1) / ROWS;
  const int8_t* vbase = p.vq + ((size_t)bh * S + r0) * DH;
  uint8_t* vstage = kslot;  // the K slot, ks_s and vs_s: contiguous
  auto issue_v = [&](int j) {  // batch j into V slot j % vslots (an empty group past the end)
    const int k = j * ROWS + row;
    if (j < nb && k < n)
      cp_async16(smem_u32(vstage + ((j % vslots) * ROWS + row) * DH + sub * 16),
                 vbase + (size_t)(list[k] >> 8) * DH + sub * 16);
    cp_async_commit();
  };
  for (int j = 0; j < vslots; ++j) issue_v(j);
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int j = 0; j < nb; ++j) {
    cp_async_wait_pending(vslots - 1);
    __syncthreads();
    const int k = j * ROWS + row;
    if (k < n) {
      const int c = list[k] & 0xff;
      const int4 vv =
          reinterpret_cast<const int4*>(vstage + ((j % vslots) * ROWS + row) * DH)[sub];
      const int w4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b4 = 0; b4 < 4; ++b4) acc[4 * i + b4] += c * sbyte(w4[i], b4);
    }
    __syncthreads();  // the slot is read
    issue_v(j + vslots);
  }
  // sum over the 8 rows of a warp that share `sub` (lanes sub, sub + 4,
  // ...), over the warps, then over the cluster in the leader
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int v = acc[j];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    acc[j] = v;
  }
  TRACE(4);
  cp_async_wait_all();  // the empty groups
  int* wpart = reinterpret_cast<int*>(kslot);  // [WARPS][DH]: the slot is read
  if (lane < SUB) {
#pragma unroll
    for (int j = 0; j < 16; ++j) wpart[warp * DH + 16 * lane + j] = acc[j];
  }
  __syncthreads();
  int total = 0;
  if (tid < DH)
    for (int w = 0; w < WARPS; ++w) total += wpart[w * DH + tid];
  if (C > 1) {  // the peers send, the leader waits and adds
    if (tid < DH && rank > 0) st_async(peer(&part[rank][tid], 0), total, peer(&xbar[3], 0));
    if (rank == 0) {
      mbar_wait(smem_u32(&xbar[3]), 0);
      if (tid < DH)
        for (int r = 1; r < C; ++r) total += part[r][tid];
    }
  }
  if (rank == 0 && tid < DH)
    store(static_cast<T*>(p.out) + (size_t)bh * DH + tid, (float)total * ws);
  TRACE(5);
#ifdef XI8_TRACE
  if (tid == 0 && blockIdx.x < TRACE_BLOCKS) g_trace[blockIdx.x][7] = gtimer();
#endif
}

template <typename T, int NT>
cudaError_t launch(const Params& p, int blocks, int smem_bytes, cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      cross_i8_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX - STATIC_SMEM);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = p.C > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, cross_i8_kernel<T, NT>, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_threads(int threads, const Params& p, int blocks, int smem,
                           cudaStream_t s) {
  if (threads == 64) return launch<T, 64>(p, blocks, smem, s);
  if (threads == 128) return launch<T, 128>(p, blocks, smem, s);
  if (threads == 256) return launch<T, 256>(p, blocks, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

#ifdef XI8_TRACE
// the trace of the last launch: `n` blocks of TRACE_SLOTS values into `dst`
extern "C" int cross_attn_i8_trace(long long* dst, int n) {
  if (n > TRACE_BLOCKS) n = TRACE_BLOCKS;
  return (int)cudaMemcpyFromSymbol(dst, g_trace, (size_t)n * TRACE_SLOTS * sizeof(long long));
}
#endif

// q [B, H, 1, 64] (bf16 if `bf16`, else fp32); kq, vq int8 [B, H, S, 64]
// (16-byte aligned); ks, vs fp32 [B, H, S, 1]; mask bool [B, S] or null
// (every position valid); out [B, H, 1, 64] in q's type; codes int8 [B, H,
// S] or null (receives the weights' codes).  All contiguous, on the current
// device; launched on `stream`.  plan (ops/cross_attention_i8.py
// cross_i8_plan_ints): cluster size, threads a block, positions a block,
// shared-memory bytes.  A plan the kernel cannot run is refused
// (cudaErrorInvalidValue) before anything is launched.  Returns a
// cudaError_t.
extern "C" int cross_attn_i8(const void* q, const void* kq, const void* ks, const void* vq,
                             const void* vs, const void* mask, void* out, void* codes,
                             int bf16, int B, int H, int S, const int* plan, void* stream) {
  const int C = plan[0], threads = plan[1], R = plan[2], smem = plan[3];
  const long long blocks = (long long)B * H * C;
  const int R4 = (R + 3) & ~3;
  if (B <= 0 || H <= 0 || S <= 0 || (C != 1 && C != 2 && C != 4 && C != 8) ||
      (threads != 64 && threads != 128 && threads != 256) || R != (S + C - 1) / C ||
      smem != threads * DH + 16 * R4 || smem > SMEM_MAX - STATIC_SMEM || blocks > 0x7fffffffLL ||
      R >= (1 << 23) || (long long)S * 127 * 127 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kq = (const int8_t*)kq;
  p.ks = (const float*)ks;
  p.vq = (const int8_t*)vq;
  p.vs = (const float*)vs;
  p.mask = (const uint8_t*)mask;
  p.out = out;
  p.codes = (int8_t*)codes;
  p.H = H;
  p.S = S;
  p.C = C;
  p.R = R;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch_threads<__nv_bfloat16>(threads, p, (int)blocks, smem, st)
                    : launch_threads<float>(threads, p, (int)blocks, smem, st));
}
