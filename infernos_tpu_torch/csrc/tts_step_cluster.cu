// SpeechT5 autoregressive decoder step over fp32 caches for Hopper
// (sm_90a): thread-block clusters that keep the hidden state in shared
// memory.
//
// Replaces infernos_tpu/ops/tts_step.py::_layer_kernel (the Pallas fused
// decoder step) in the mode whose caches are fp32 (self_dtype and
// cross_dtype taken from the caches, tts_step.py:677-678): the tiny and
// tiny-real TTS engines, D 256, 4 heads, F 768, 3 layers, 8 slots, T 170,
// S 48.  Weights are bf16 (the reference packs them in bf16,
// tts_step.py:570) or int8 codes with an fp32 scale per output channel
// (the int8w branch, tts_step.py:175-181: y * scale + bias, then the
// activation).
//
// What bounds it on an H100: at the tiny-real shape one step must read
// about 4.7 MB of bf16 weights (they stay in the 50 MB L2 from step to
// step) and 4-7 MB of fp32 cache rows: a few microseconds of bytes.  The
// grid-wide design of csrc/tts_step.cu (one block per SM, the hidden state
// in global scratch, a grid barrier between phases) spends its time on
// chains of L2 round trips instead: every product phase re-reads and
// re-normalises x from L2 in every block, and every phase ends at a
// barrier of 132 blocks.  The Pallas kernel keeps x on chip (x_scr,
// tts_step.py:114) across its grid=(L,) walk; here the same is done on one
// thread-block cluster of 16 blocks per group of at most 8 slots (4 up to
// 16 slots, so that the attention items get more SMs):
// - every block of the cluster keeps its own copy of the residual h [R, D]
//   fp32 and of the product's input rows in bf16, so a LayerNorm is a
//   local pass over shared memory (every block computes the same rows in
//   the same order), never a round trip;
// - a product splits its output panels (16 columns) over the cluster's
//   blocks; each block pushes its finished columns straight into its
//   peers' shared memory (distributed shared memory stores): the q, k and
//   v of an attention item to the block that owns the item, an output
//   projection's h + y to every block (the next LayerNorm's input), the
//   FFN middle (after GELU, in bf16) to every block's input rows of the
//   next product; then the cluster meets at one barrier
//   (barrier.cluster.arrive.release / wait.acquire) instead of a grid one;
// - weights come from L2 through the async copy engine: each block
//   streams its panels of every product, in order, with cp.async.bulk
//   into a ring of shared-memory slots tracked by one mbarrier a slot, as
//   far ahead as the ring allows (a whole layer at the tiny-real shape),
//   so the copies run under the barriers and the attention phases; the
//   refills are started between a block's arrival at a cluster barrier
//   and its wait there, as are the copies of the next LayerNorm's
//   parameters; the biases (and int8 scales) of the block's columns are
//   copied in once, at the start;
// - products on the tensor cores (mma.sync m16n8k16, the weight tile as
//   the A operand in the panel layout of ops/tts_step.py pack_panels, the
//   <= 8 rows of x as B, fp32 accumulators), each block's panels and K
//   range split over its 8 warps; the partial sums of a column are added
//   in a fixed order (deterministic);
// - the (slot, head) items of an attention phase are spread over all the
//   cluster's blocks, each item to a team of 1-8 warps (as many teams as a
//   block has items); a team keeps a running softmax in registers, 8
//   lanes a key, and merges it once at the end; the layer's cache rows
//   are prefetched into L2 (cp.async.bulk.prefetch) at the start of the
//   layer, under its products.
// Clusters of one launch own disjoint slot groups and never wait for each
// other: a step of any number of slots is one launch.
//
// What is left is latency: 24 cluster phases at the tiny-real shape, each
// a barrier (about 0.65 us on an H100) plus a chain of shared-memory and
// L2 steps; ops/tts_step_ablate.py --tiny-real times the kernel with its
// parts compiled out and traces every phase (PERF.md has the numbers).
//
// Shapes: D = 64 H, F a multiple of 16, any T and S (the wrapper takes
// T, S <= 4096), at most 8 slots a cluster; the shared-memory plan comes
// from ops/tts_step.py cluster_plan, which refuses a shape whose state
// does not fit a block's 232,448 bytes (a product of more than 4096
// columns at 16 blocks a cluster).  x comes in as bf16 or fp32 [B, D]
// and h goes out in the same type; pos is int64 [B]; the encoder mask is
// bool [B, S] (false = -1e9 added), or null; the 1/sqrt(Dh) attention
// scale is folded into the q weights; caches canonical [L, Bc, H, T, 64]
// fp32 (Bc >= B slots a layer).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int DH = 64;         // head dim
constexpr int MAXR = 8;        // most slots a cluster owns: one n8 column tile
constexpr int MAXC = 16;       // most blocks a cluster
constexpr int TILE_ELEMS = 256;  // a 16 x 16 weight tile
constexpr int MAX_PAIRS = 32;  // (panel, K range) pairs of one block's product
constexpr int PPW = MAX_PAIRS / NWARP;  // pairs a warp holds at most
constexpr int MAX_NP = 16;     // most panels of one product a block owns
constexpr int MAX_SLOTS = 8;
constexpr float NEG_INF = -1e9f;
constexpr int COPIER = 32;  // the thread that starts the weight copies
constexpr int MAX_ITEMS = 16;  // attention items a block owns at most

enum { G_QKV, G_SO, G_CQ, G_CO, G_W1, G_W2, N_GEMMS };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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

// bytes (a multiple of 16) from global src to this block's shared dst,
// both 16-byte aligned; completion is counted on the mbarrier at mbar
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// a hint: bring bytes (a multiple of 16) at src into L2
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
               : "memory");
}

// the cluster barrier in two halves: what a block does between them
// overlaps the wait for the others
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// threads [32 W t, 32 W (t + 1)) meet at named barrier 1 + t
__device__ __forceinline__ void team_bar(int team, int nth) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(nth) : "memory");
}

// ------------------------------------------------------- tensor-core product
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four int8 codes -> two pairs of bf16, exactly (as csrc/tts_step.cu)
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  w ^= 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = pack2(f0, f1);
  hi = pack2(f2, f3);
}

// a lane's A fragment of one packed tile (ops/tts_step.py _frag_order)
__device__ __forceinline__ void load_frag(const bf16* tile, int lane, uint32_t (&a)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(tile + lane * 8);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void load_frag(const int8_t* tile, int lane, uint32_t (&a)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(tile + lane * 8);
  widen4(v.x, a[0], a[1]);
  widen4(v.y, a[2], a[3]);
}

// d += A B: A [16, 16] bf16 row-major fragment, B [16, 8] column-major
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float gelu(float s) {
  return 0.5f * s * (1.f + erff(s * 0.70710678118654752f));
}

// TRACE(c, k): thread 0 of every block writes clock64() at point k of the
// current phase c.ph (0 start, 1 x staged, 2 first weights in, 3 products,
// 4 partial sums out, 5 columns pushed, 7 arrival at the cluster barrier)
// into p.trace [grid, 8 L + 1, 8], in TTS_TRACE builds only
// (ops/tts_step_ablate.py; ops/build.py never defines it)
#ifdef TTS_TRACE
#define TRACE(c, k)                                                             \
  do {                                                                          \
    if (threadIdx.x == 0)                                                       \
      p.trace[((size_t)blockIdx.x * (8 * p.L + 1) + (c).ph) * 8 + (k)] = clock64(); \
  } while (0)
#else
#define TRACE(c, k) \
  do {              \
  } while (0)
#endif

// CLUSTER_ABLATE_PUSH (stores to peers kept in the block's own memory),
// CLUSTER_ABLATE_ATTN (attention phases compiled out), CLUSTER_ABLATE_LN
// (LayerNorm arithmetic out) and CLUSTER_ABLATE_MMA (products out, the
// weights still waited for) give the timing experiments of
// ops/tts_step_ablate.py (wrong results, on purpose).
// the address of this block's shared `local` in block `rank` of the
// cluster, and 16- or 8-byte stores there
__device__ __forceinline__ uint32_t peer(const void* local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(local))), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_peer(uint32_t addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y)
               : "memory");
}

#ifdef CLUSTER_ABLATE_PUSH
#define PEER(ptr, r) peer((ptr), c.rank)
#else
#define PEER(ptr, r) peer((ptr), (r))
#endif

// ------------------------------------------------------------- the plan
// Everything a block derives from the plan the same way as
// ops/tts_step.py cluster_plan does.
struct Params {
  const void* x;          // [B, D] step input, bf16 or fp32
  void* out;              // [B, D] hidden state out, x's type
  const long long* pos;   // [B] int64
  const uint8_t* mask;    // [B, S] bool, or null
  const void* w[N_GEMMS];      // panels [L, N/16, K/16, 256], bf16 or int8 codes
  const float* bias[N_GEMMS];  // [L, N]
  const float* scale[N_GEMMS]; // [L, N] (int8) or null
  const float* ln[6];          // ln1g, ln1b, ln2g, ln2b, ln3g, ln3b [L, D]
  float* self_k;  // fp32 caches [L, Bc, H, T, 64] / [L, Bc, H, S, 64]
  float* self_v;
  float* cross_k;
  float* cross_v;
  long long* trace;  // TTS_TRACE builds: [grid, 8 L + 1, 8] clock64()
  int L, B, H, T, S, F, x_bf16, Bc;
  float eps;
  int rows;        // slots a cluster owns (the last cluster may own fewer)
  int csize;       // blocks a cluster
  int teams;       // attention teams a block (NWARP / teams warps each)
  int ipb;         // attention items a block owns at most
  int nslot, slot_bytes, slot_tiles;
  int off_h, off_pre, off_xs0, off_xs1, off_qkv, off_red, off_ln, off_bias, off_small;
  int xs0_stride, xs1_stride;
};

__host__ __device__ __forceinline__ void gemm_kn(int D, int F, int g, int& K, int& N) {
  K = g == G_W2 ? F : D;
  N = g == G_QKV ? 3 * D : (g == G_W1 ? F : D);
}

// K ranges a product's panels are split into over the 8 warps: enough to
// give every warp the same number of (panel, range) pairs, at most 32 pairs
__host__ __device__ __forceinline__ int k_splits(int np) {
  int g = 8;
  while (np % g) g >>= 1;
  int q = NWARP / g;
  while (np * q > MAX_PAIRS && q > 1) q >>= 1;
  return q;
}

// One block's share of product g: panels [p0, p0 + np) over all K, in
// chunks of kc K tiles (one ring slot each).
struct Share {
  int K, N, KT, p0, np, kc, nch;
  int q;     // K ranges over the warps (k_splits)
  int cpre;  // where its columns start among the block's biases
};

__device__ __forceinline__ Share share_of(const Params& p, int g, int rank) {
  Share s;
  const int D = p.H * DH;
  gemm_kn(D, p.F, g, s.K, s.N);
  s.KT = s.K / 16;
  const int P = s.N / 16;
  s.p0 = rank * P / p.csize;
  s.np = (rank + 1) * P / p.csize - s.p0;
  s.kc = s.np ? min(s.KT, p.slot_tiles / s.np) : 1;
  s.nch = s.np ? (s.KT + s.kc - 1) / s.kc : 0;
  s.q = s.np ? k_splits(s.np) : 1;
  s.cpre = 0;
  for (int k = 0; k < g; ++k) {  // the most columns a block owns of each product before
    int K, N;
    gemm_kn(D, p.F, k, K, N);
    s.cpre += (N / 16 + p.csize - 1) / p.csize * 16;
  }
  return s;
}

// A block's view of its shared memory.
struct Ctx {
  uint8_t* ring;
  uint32_t ring_s;
  uint32_t mbar_s;
  float* h;     // [R, D] residual
  float* pre;   // [R, D] h + y of the last output projection (gathered)
  bf16* xs0;    // [8, D + 8] product input rows, from h
  bf16* xs1;    // [8, max(D, F) + 8] product input rows: attention out, FFN middle
  float* qkv;   // [ipb, 3, 64] q, k, v of this block's attention items
  float* red;   // [MAX_PAIRS, 8 rows, 16 cols] per-pair partial sums
  float* ln;    // [2, D] the next LayerNorm's g and b, copied in ahead
  float* bias;  // [L, colsum] the biases of the block's columns, then the scales
  const Share* shares;  // [N_GEMMS] the block's share of each product
  int colsum;   // the block's columns over the six products (at most)
  int bias_ready;
  uint32_t bias_mbar;
  float* accw;  // [NWARP, 64] per-warp attention sums
  float* tmax;  // [NWARP] per-warp running max and sum of an attention item
  float* tsum;  // [NWARP]
  int* last;    // [MAX_ITEMS] the row each self-attention item writes
  uint32_t ln_mbar;
  int rank, R, row0, D;
  int ph;        // the phase: 8 per layer
  int n_ln;      // LayerNorms done
  int consumed;  // chunks whose slot was used and freed (all threads)
  int started;   // chunks whose copies were started (COPIER)
  int nx_l, nx_g, nx_ch;  // the next chunk to start (COPIER)
};

// COPIER: start the copies of chunk ch of layer l's product g into the next slot
template <typename WT>
__device__ void start_chunk(const Params& p, Ctx& c, int l, int g, int ch) {
  const Share s = c.shares[g];
  const int kt0 = ch * s.kc, kcn = min(s.kc, s.KT - kt0);
  const uint32_t bytes = (uint32_t)kcn * TILE_ELEMS * sizeof(WT);
  const int slot = c.started % p.nslot;
  const uint32_t mbar = c.mbar_s + slot * 8;
  const uint32_t dst = c.ring_s + slot * p.slot_bytes;
  const int P = s.N / 16;
  const WT* src = static_cast<const WT*>(p.w[g]) +
                  (((size_t)l * P + s.p0) * s.KT + kt0) * TILE_ELEMS;
  mbar_expect_tx(mbar, bytes * s.np);
  for (int j = 0; j < s.np; ++j)
    bulk_g2s(dst + j * bytes, src + (size_t)j * s.KT * TILE_ELEMS, bytes, mbar);
  ++c.started;
}

// COPIER: keep every free slot filled with the block's next chunks
template <typename WT>
__device__ void top_up(const Params& p, Ctx& c) {
  while (c.started - c.consumed < p.nslot && c.nx_l < p.L) {
    if (c.nx_ch < c.shares[c.nx_g].nch) {
      start_chunk<WT>(p, c, c.nx_l, c.nx_g, c.nx_ch);
      ++c.nx_ch;
      continue;
    }
    c.nx_ch = 0;
    if (++c.nx_g == N_GEMMS) {
      c.nx_g = 0;
      ++c.nx_l;
    }
  }
}

// Where a product's finished values go.
enum Dest { TO_ITEMS, TO_PRE, TO_XS1 };

// This block's share of layer l's product g: y[R, N] = act((x @ w) * scale
// + bias) for its panels, x the bf16 rows xs (stride xstride); each
// finished quad of columns goes to dest in every block that needs it.
template <typename WT>
__device__ void product(const Params& p, Ctx& c, int l, int g, const bf16* xs, int xstride,
                        Dest dest) {
  const Share s = c.shares[g];
  if (s.np == 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int Q = s.q, pairs = s.np * Q;
  const int R = c.R, D = c.D, C = p.csize;
  const int nq = s.np * 4 * R;  // quads of columns to finish
  const bool int8w = p.scale[g] != nullptr;

  float acc[PPW][4];
#pragma unroll
  for (int j = 0; j < PPW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bf16* xk = xs + gq * xstride + 2 * t4;
  TRACE(c, 1);
  for (int ch = 0; ch < s.nch; ++ch) {
    const int slot = c.consumed % p.nslot;
    mbar_wait(c.mbar_s + slot * 8, (c.consumed / p.nslot) & 1);
    if (ch == 0) TRACE(c, 2);
    const int kt0 = ch * s.kc, kcn = min(s.kc, s.KT - kt0);
    const WT* base = reinterpret_cast<const WT*>(c.ring + slot * p.slot_bytes);
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      const int i = warp + NWARP * j;
      if (i < pairs) {
        const int pp = i / Q, q = i % Q;
        const int t0 = q * kcn / Q;
#ifdef CLUSTER_ABLATE_MMA
        const int t1 = t0;
#else
        const int t1 = (q + 1) * kcn / Q;
#endif
        const WT* tile = base + ((size_t)pp * kcn + t0) * TILE_ELEMS;
#pragma unroll 2
        for (int t = t0; t < t1; ++t, tile += TILE_ELEMS) {
          uint32_t a[4];
          load_frag(tile, lane, a);
          const bf16* xr = xk + (kt0 + t) * 16;
          mma16816(acc[j], a, *reinterpret_cast<const uint32_t*>(xr),
                   *reinterpret_cast<const uint32_t*>(xr + 8));
        }
      }
    }
    __syncthreads();  // every warp is done with the slot
    ++c.consumed;
    // refill now only what this product still needs; else at the barrier
    if (tid == COPIER && ch + 1 < s.nch) top_up<WT>(p, c);
  }
  TRACE(c, 3);
  // acc[j][e]: output column gq (+ 8 for e >= 2) of the pair's panel, row
  // 2 t4 (+ 1 for odd e)
#pragma unroll
  for (int j = 0; j < PPW; ++j) {
    const int i = warp + NWARP * j;
    if (i < pairs) {
      float* r = c.red + i * 128;
      const int n0 = 2 * t4;
      r[n0 * 16 + gq] = acc[j][0];
      r[(n0 + 1) * 16 + gq] = acc[j][1];
      r[n0 * 16 + gq + 8] = acc[j][2];
      r[(n0 + 1) * 16 + gq + 8] = acc[j][3];
    }
  }
  __syncthreads();
  TRACE(c, 4);

  // a quad per thread: its K ranges added in order, then scale, bias,
  // act; then stored to every block that needs it (a staged broadcast by
  // all the threads, a (quad, block) pair each, measured slower)
  if (!c.bias_ready) {
    mbar_wait(c.bias_mbar, 0);
    c.bias_ready = 1;
  }
  const float* bs = c.bias + l * c.colsum + s.cpre;  // the block's columns
  const float* sc = bs + p.L * c.colsum;
  for (int gi = tid; gi < nq; gi += NT) {
    const int n = gi / (s.np * 4), cq = gi % (s.np * 4), pp = cq / 4, m0 = (cq % 4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < Q; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(c.red + (pp * Q + q) * 128 + n * 16 + m0);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int cb = cq * 4;  // the quad's first column among the block's
    if (int8w) {
      const float4 sv = *reinterpret_cast<const float4*>(sc + cb);
      v.x *= sv.x;
      v.y *= sv.y;
      v.z *= sv.z;
      v.w *= sv.w;
    }
    const float4 bv = *reinterpret_cast<const float4*>(bs + cb);
    v.x += bv.x;
    v.y += bv.y;
    v.z += bv.z;
    v.w += bv.w;
    const int col = (s.p0 + pp) * 16 + m0;
    if (dest == TO_ITEMS) {  // q, k or v of item (n, head): to the block that owns it
      const int part = col / D, cc = col % D, item = n * p.H + cc / DH;
      st_peer(PEER(c.qkv + ((item / C) * 3 + part) * DH + cc % DH, item % C), v);
    } else if (dest == TO_PRE) {  // h + y: every block's next LayerNorm input
      const float4 hv = *reinterpret_cast<const float4*>(c.h + n * D + col);
      v.x += hv.x;
      v.y += hv.y;
      v.z += hv.z;
      v.w += hv.w;
      for (int r = 0; r < C; ++r) st_peer(PEER(c.pre + n * D + col, r), v);
    } else {  // GELU, then bf16 into every block's input rows of the next product
      const uint2 b2 = make_uint2(pack2(gelu(v.x), gelu(v.y)), pack2(gelu(v.z), gelu(v.w)));
      for (int r = 0; r < C; ++r) st_peer(PEER(c.xs1 + n * p.xs1_stride + col, r), b2);
    }
  }
  TRACE(c, 5);
}

// COPIER: start the copies of the biases (and scales) of the block's
// columns of every product of every layer into c.bias, once a launch
__device__ void start_bias(const Params& p, Ctx& c) {
  uint32_t total = 0;
  const int nmat = p.scale[0] ? 2 : 1;
  for (int g = 0; g < N_GEMMS; ++g) total += c.shares[g].np * 16 * 4;
  mbar_expect_tx(c.bias_mbar, total * p.L * nmat);
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(c.bias));
  for (int l = 0; l < p.L; ++l)
    for (int g = 0; g < N_GEMMS; ++g) {
      const Share s = c.shares[g];
      if (!s.np) continue;
      const uint32_t at = (l * c.colsum + s.cpre) * 4, bytes = s.np * 16 * 4;
      bulk_g2s(dst + at, p.bias[g] + (size_t)l * s.N + s.p0 * 16, bytes, c.bias_mbar);
      if (nmat == 2)
        bulk_g2s(dst + at + p.L * c.colsum * 4, p.scale[g] + (size_t)l * s.N + s.p0 * 16, bytes,
                 c.bias_mbar);
    }
}

// COPIER: start the copy of LayerNorm i's g and b (LN1, LN2, LN3 of layer
// 0, then of layer 1, ...) into c.ln
__device__ void start_ln(const Params& p, Ctx& c, int i) {
  const int k = 2 * (i % 3), l = i / 3, D = c.D;
  const uint32_t bytes = D * sizeof(float);
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(c.ln));
  mbar_expect_tx(c.ln_mbar, 2 * bytes);
  bulk_g2s(dst, p.ln[k] + (size_t)l * D, bytes, c.ln_mbar);
  bulk_g2s(dst + bytes, p.ln[k + 1] + (size_t)l * D, bytes, c.ln_mbar);
}

// h = LN(pre) with the parameters in c.ln (LayerNorm c.n_ln), over the
// cluster's R rows (a warp a row); the rows also go to xs0 in bf16, the
// next product's input.  The next LayerNorm's parameters are copied in at
// the next cluster barrier, a few phases ahead of it.
__device__ void layer_norm(const Params& p, Ctx& c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, D = c.D;
  const float* g = c.ln;
  const float* b = c.ln + D;
  mbar_wait(c.ln_mbar, c.n_ln & 1);
#ifdef CLUSTER_ABLATE_LN
  if (false)
#endif
  for (int n = warp; n < c.R; n += NWARP) {
    const float* x = c.pre + n * D;
    // sums of x - x[0] and of its square in one pass (shifted: no
    // cancellation while x[0] is near the mean), both warp sums together
    const float x0 = x[0];
    float s = 0.f, s2 = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float d = x[i] - x0;
      s += d;
      s2 = fmaf(d, d, s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float ms = s / D;
    const float mu = x0 + ms;
    const float rstd = rsqrtf(fmaxf(s2 / D - ms * ms, 0.f) + p.eps);
    for (int i = lane; i < D; i += 32) {
      const float y = (x[i] - mu) * rstd * g[i] + b[i];
      c.h[n * D + i] = y;
      c.xs0[n * p.xs0_stride + i] = __float2bfloat16(y);
    }
  }
  __syncthreads();
  ++c.n_ln;  // the next one's parameters are copied in at the next barrier
}

// ------------------------------------------------- single-query attention
// Item (n, head) of this cluster, its q (and in self mode the new k and v)
// in this block's qkv buffer at index kidx, by team `team` of W warps.
// Self mode writes the new K/V row at last = min(pos, T - 1) and attends
// keys 0..last (the row at last is read from shared memory); cross mode
// attends all S keys under the mask.  Flash-decoding in registers: 8 lanes
// a key (8 dims a lane, K and V rows loaded together, KB keys a lane at a
// time), a running max, sum and output per lane, merged over the warp's
// four key groups by shuffles and over the team's warps through shared
// memory at the end: one team barrier an item.  The output row goes to
// every block's xs1 in bf16 (the input of the next output projection).
constexpr int KB = 6;  // keys whose K and V rows a lane loads at once

__device__ __forceinline__ void merge(float& m, float& l, float (&o)[8], float m2, float l2,
                                      const float (&o2)[8]) {
  const float M = fmaxf(m, m2);
  const float c1 = m == -INFINITY ? 0.f : expf(m - M);
  const float c2 = m2 == -INFINITY ? 0.f : expf(m2 - M);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = o[e] * c1 + o2[e] * c2;
  m = M;
}

__device__ void attend(const Params& p, Ctx& c, int l, bool self, int kidx, int item, int team,
                       int W) {
  const int nth = 32 * W;
  const int tt = threadIdx.x - team * nth, wt = tt >> 5, lane = tt & 31;
  const int warp = threadIdx.x >> 5, sub = lane >> 3, d8 = (lane & 7) * 8;
  const int n = item / p.H, hd = item % p.H, b = c.row0 + n;
  const int Tn = self ? p.T : p.S;
  const size_t base = (((size_t)l * p.Bc + b) * p.H + hd) * Tn * DH;
  float* Kb = (self ? p.self_k : p.cross_k) + base;
  float* Vb = (self ? p.self_v : p.cross_v) + base;
  const float* qv = c.qkv + kidx * 3 * DH;
  const float* kn = qv + DH;
  const float* vn = qv + 2 * DH;
  const int last = self ? c.last[kidx] : p.S - 1;
  const int nk = last + 1;
  const int patch = self ? last : -1;
  const uint8_t* mrow = (!self && p.mask) ? p.mask + (size_t)b * p.S : nullptr;
  if (self) {
    for (int d = tt; d < DH; d += nth) {
      Kb[(size_t)last * DH + d] = kn[d];
      Vb[(size_t)last * DH + d] = vn[d];
    }
  }
  const float4 q0 = *reinterpret_cast<const float4*>(qv + d8);
  const float4 q1 = *reinterpret_cast<const float4*>(qv + d8 + 4);
  float m = -INFINITY, lsum = 0.f, o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = 0.f;
  const int stride = 4 * W;  // keys the team takes at a time
  for (int j0 = wt * 4; j0 < nk; j0 += stride * KB) {  // uniform over the warp
    float4 kr[KB][2], vr[KB][2];
    bool keep[KB];
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const int j = j0 + sub + i * stride;
      keep[i] = true;
      if (j < nk) {
        if (mrow) keep[i] = mrow[j];
        const float* kp = j == patch ? kn + d8 : Kb + (size_t)j * DH + d8;
        const float* vp = j == patch ? vn + d8 : Vb + (size_t)j * DH + d8;
        kr[i][0] = *reinterpret_cast<const float4*>(kp);
        kr[i][1] = *reinterpret_cast<const float4*>(kp + 4);
        vr[i][0] = *reinterpret_cast<const float4*>(vp);
        vr[i][1] = *reinterpret_cast<const float4*>(vp + 4);
      }
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const int j = j0 + sub + i * stride;
      float s = 0.f;
      if (j < nk) {
        s = q0.x * kr[i][0].x + q0.y * kr[i][0].y + q0.z * kr[i][0].z + q0.w * kr[i][0].w +
            q1.x * kr[i][1].x + q1.y * kr[i][1].y + q1.z * kr[i][1].z + q1.w * kr[i][1].w;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (j < nk) {
        if (!keep[i]) s += NEG_INF;
        const float M = fmaxf(m, s);
        const float corr = expf(m - M);  // 0 while m is -inf
        const float pj = expf(s - M);
        lsum = lsum * corr + pj;
        const float v[8] = {vr[i][0].x, vr[i][0].y, vr[i][0].z, vr[i][0].w,
                            vr[i][1].x, vr[i][1].y, vr[i][1].z, vr[i][1].w};
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaf(pj, v[e], o[e] * corr);
        m = M;
      }
    }
  }
  TRACE(c, 1);
  // the warp's four key groups (lanes xor 8, 16), then the team's warps
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1) {
    float o2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o2[e] = __shfl_xor_sync(0xffffffffu, o[e], off);
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, lsum, off);
    merge(m, lsum, o, m2, l2, o2);
  }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) c.accw[warp * DH + d8 + e] = o[e];
    if (lane == 0) {
      c.tmax[warp] = m;
      c.tsum[warp] = lsum;
    }
  }
  team_bar(team, nth);
  TRACE(c, 2);
  // four dims a thread, one 8-byte store to each block of the cluster
  for (int d = 4 * tt; d < DH; d += 4 * nth) {
    float M = -INFINITY;
    for (int w = 0; w < W; ++w) M = fmaxf(M, c.tmax[team * W + w]);
    float v[4] = {0.f, 0.f, 0.f, 0.f}, den = 0.f;
    for (int w = 0; w < W; ++w) {
      const float mw = c.tmax[team * W + w];
      const float cw = mw == -INFINITY ? 0.f : expf(mw - M);
      den += c.tsum[team * W + w] * cw;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += c.accw[(team * W + w) * DH + d + e] * cw;
    }
    const uint2 ob = make_uint2(pack2(v[0] / den, v[1] / den), pack2(v[2] / den, v[3] / den));
    bf16* dst = c.xs1 + n * p.xs1_stride + hd * DH + d;
    for (int r = 0; r < p.csize; ++r) st_peer(PEER(dst, r), ob);
  }
  TRACE(c, 3);
  team_bar(team, nth);  // accw and the sums are read: the team's next item may write
}

// every attention item of this block, a team an item, in rounds
__device__ void attention(const Params& p, Ctx& c, int l, bool self) {
  const int W = NWARP / p.teams, team = (threadIdx.x >> 5) / W;
  const int items = c.R * p.H;
#ifdef CLUSTER_ABLATE_ATTN
  return;
#endif
  for (int k = team; c.rank + k * p.csize < items; k += p.teams)
    attend(p, c, l, self, k, c.rank + k * p.csize, team, W);
}

// L2 prefetch of layer l's cache rows for this block's items
__device__ void prefetch_layer(const Params& p, Ctx& c, int l) {
  const int items = c.R * p.H;
  const int tid = threadIdx.x;
  for (int k = 0; k < p.ipb; ++k) {
    const int item = c.rank + k * p.csize;
    if (item >= items || tid >= 4) continue;
    const int n = item / p.H, hd = item % p.H, b = c.row0 + n;
    const bool self = tid < 2;
    const int Tn = self ? p.T : p.S;
    const int rows = self ? c.last[k] + 1 : p.S;
    const size_t base = (((size_t)l * p.Bc + b) * p.H + hd) * Tn * DH;
    const float* src = (tid == 0 ? p.self_k : tid == 1 ? p.self_v : tid == 2 ? p.cross_k
                                                                            : p.cross_v) + base;
    prefetch_l2(src, (uint32_t)rows * DH * sizeof(float));
  }
}

// ------------------------------------------------------------- the kernel
template <typename WT>
__global__ void __launch_bounds__(NT, 1) cluster_step_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cl = cg::this_cluster();
  Ctx c;
  c.D = p.H * DH;
  c.rank = (int)cl.block_rank();
  c.row0 = (int)(blockIdx.x / p.csize) * p.rows;
  c.R = min(p.rows, p.B - c.row0);
  c.ring = smem;
  c.ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  c.h = reinterpret_cast<float*>(smem + p.off_h);
  c.pre = reinterpret_cast<float*>(smem + p.off_pre);
  c.xs0 = reinterpret_cast<bf16*>(smem + p.off_xs0);
  c.xs1 = reinterpret_cast<bf16*>(smem + p.off_xs1);
  c.qkv = reinterpret_cast<float*>(smem + p.off_qkv);
  c.red = reinterpret_cast<float*>(smem + p.off_red);
  c.ln = reinterpret_cast<float*>(smem + p.off_ln);
  c.bias = reinterpret_cast<float*>(smem + p.off_bias);
  {
    const Share s = share_of(p, G_W2, c.rank);
    c.colsum = s.cpre + (s.N / 16 + p.csize - 1) / p.csize * 16;
  }
  c.bias_ready = 0;
  c.accw = reinterpret_cast<float*>(smem + p.off_small);
  c.tmax = c.accw + NWARP * DH;
  c.tsum = c.tmax + NWARP;
  c.last = reinterpret_cast<int*>(c.tsum + NWARP);
  c.ln_mbar = static_cast<uint32_t>(__cvta_generic_to_shared(c.last + MAX_ITEMS));
  c.bias_mbar = c.ln_mbar + 8;
  c.mbar_s = c.ln_mbar + 16;
  Share* shares = reinterpret_cast<Share*>(c.last + MAX_ITEMS + 2 * (MAX_SLOTS + 2));
  c.shares = shares;
  c.consumed = c.started = 0;
  c.nx_l = c.nx_g = c.nx_ch = 0;
  c.ph = c.n_ln = 0;
  const int D = c.D, tid = threadIdx.x;
#ifdef TTS_TRACE
  long long t_start = 0, g_start = 0;
  if (tid == 0) {
    t_start = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start));
  }
#endif

  if (tid < N_GEMMS) shares[tid] = share_of(p, tid, c.rank);
  if (tid == 0) {
    for (int i = 0; i < p.nslot; ++i) mbar_init(c.mbar_s + i * 8, 1);
    mbar_init(c.ln_mbar, 1);
    mbar_init(c.bias_mbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // x -> h and xs0; the padding rows of both input buffers zero
  for (int i = tid; i < MAXR * p.xs0_stride; i += NT) c.xs0[i] = __float2bfloat16(0.f);
  for (int i = tid; i < MAXR * p.xs1_stride; i += NT) c.xs1[i] = __float2bfloat16(0.f);
  // the row each of this block's self-attention items writes, read once
  for (int k = tid; k < p.ipb; k += NT) {
    const int item = c.rank + k * p.csize;
    c.last[k] = item < c.R * p.H
                    ? (int)min(p.pos[c.row0 + item / p.H], (long long)(p.T - 1)) : 0;
  }
  __syncthreads();
  if (tid == COPIER) {
    top_up<WT>(p, c);
    start_ln(p, c, 0);
    start_bias(p, c);
  }
  for (int i = tid; i < c.R * D; i += NT) {
    const int n = i / D, k = i % D;
    const size_t off = (size_t)(c.row0 + n) * D + k;
    const float v = p.x_bf16 ? __bfloat162float(static_cast<const bf16*>(p.x)[off])
                             : static_cast<const float*>(p.x)[off];
    c.h[i] = v;
    c.xs0[n * p.xs0_stride + k] = __float2bfloat16(v);
  }
  cl.sync();  // every block of the cluster has started: peers' memory is there

  // the 8 phases of a layer, each ending at a cluster barrier; while the
  // block waits there, COPIER refills the weight slots freed since the last
  // one and starts the next LayerNorm's parameters when the last is used
  int ln_started = 1;
  auto sync = [&]() {
    TRACE(c, 7);
    __syncwarp();
    cluster_arrive();
    if (tid == COPIER) {
      top_up<WT>(p, c);
      if (ln_started == c.n_ln && ln_started < 3 * p.L) start_ln(p, c, ln_started++);
    }
    __syncwarp();
    cluster_wait();
    ++c.ph;
    TRACE(c, 0);
  };
  // One loop over the 8 L phases, one call site each of layer_norm,
  // product and attention: the phases share their code, which then stays
  // in the SM's instruction cache.  A layer: qkv (after LN3 of the layer
  // before), self attention, so, cq (after LN1), cross attention, co, w1
  // (after LN2), w2.
  TRACE(c, 0);
  for (int ph = 0; ph < 8 * p.L; ++ph) {
    const int l = ph / 8, kind = ph % 8;
    if ((kind == 0 && l > 0) || kind == 3 || kind == 6) layer_norm(p, c);
    if (kind == 0) prefetch_layer(p, c, l);
    if (kind == 1 || kind == 4) {
      attention(p, c, l, kind == 1);
    } else {
      const int g = kind == 0 ? G_QKV : kind == 2 ? G_SO : kind == 3 ? G_CQ
                  : kind == 5 ? G_CO : kind == 6 ? G_W1 : G_W2;
      const bool from_h = g == G_QKV || g == G_CQ || g == G_W1;
      product<WT>(p, c, l, g, from_h ? c.xs0 : c.xs1,
                  from_h ? p.xs0_stride : p.xs1_stride,
                  g == G_QKV || g == G_CQ ? TO_ITEMS : g == G_W1 ? TO_XS1 : TO_PRE);
    }
    sync();
  }
  // the last LN3, computed by every block; each writes its share of the rows
  layer_norm(p, c);
  for (int i = c.rank * NT + tid; i < c.R * D; i += p.csize * NT) {
    const size_t off = (size_t)c.row0 * D + i;
    if (p.x_bf16)
      static_cast<bf16*>(p.out)[off] = __float2bfloat16(c.h[i]);
    else
      static_cast<float*>(p.out)[off] = c.h[i];
  }
  TRACE(c, 7);
#ifdef TTS_TRACE
  if (threadIdx.x == 0) {  // the clock rate: cycles and ns of this block's run
    long long g_end;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_end));
    long long* t = p.trace + ((size_t)blockIdx.x * (8 * p.L + 1) + 8 * p.L) * 8;
    t[1] = t_start;
    t[2] = clock64();
    t[3] = g_start;
    t[4] = g_end;
  }
#endif
}

// ptrs: x, out, pos, mask, then the 6 weights, 6 biases, 6 scales (null
// with bf16 weights), 6 LN parameters, self_k, self_v, cross_k, cross_v.
// dims: L, B, H, T, S, F, x_bf16, Bc.  plan (ops/tts_step.py cluster_plan,
// cluster_plan_ints): rows, csize, clusters, teams, ipb, nslot, slot_bytes,
// slot_tiles, the 9 shared-memory offsets, xs0_stride, xs1_stride,
// smem_bytes (20 ints).

template <typename WT>
int launch(const void* const* ptrs, const int* dims, const int* plan, float eps,
           void* stream) {
  Params p{};
  int i = 0;
  p.x = ptrs[i++];
  p.out = const_cast<void*>(ptrs[i++]);
  p.pos = static_cast<const long long*>(ptrs[i++]);
  p.mask = static_cast<const uint8_t*>(ptrs[i++]);
  for (int g = 0; g < N_GEMMS; ++g) p.w[g] = ptrs[i++];
  for (int g = 0; g < N_GEMMS; ++g) p.bias[g] = static_cast<const float*>(ptrs[i++]);
  for (int g = 0; g < N_GEMMS; ++g) p.scale[g] = static_cast<const float*>(ptrs[i++]);
  for (int k = 0; k < 6; ++k) p.ln[k] = static_cast<const float*>(ptrs[i++]);
  p.self_k = (float*)ptrs[i++];
  p.self_v = (float*)ptrs[i++];
  p.cross_k = (float*)ptrs[i++];
  p.cross_v = (float*)ptrs[i++];
#ifdef TTS_TRACE
  p.trace = (long long*)ptrs[i++];
#endif
  p.L = dims[0];
  p.B = dims[1];
  p.H = dims[2];
  p.T = dims[3];
  p.S = dims[4];
  p.F = dims[5];
  p.x_bf16 = dims[6];
  p.Bc = dims[7];
  p.eps = eps;
  int j = 0;
  p.rows = plan[j++];
  p.csize = plan[j++];
  const int clusters = plan[j++];
  p.teams = plan[j++];
  p.ipb = plan[j++];
  p.nslot = plan[j++];
  p.slot_bytes = plan[j++];
  p.slot_tiles = plan[j++];
  p.off_h = plan[j++];
  p.off_pre = plan[j++];
  p.off_xs0 = plan[j++];
  p.off_xs1 = plan[j++];
  p.off_qkv = plan[j++];
  p.off_red = plan[j++];
  p.off_ln = plan[j++];
  p.off_bias = plan[j++];
  p.off_small = plan[j++];
  p.xs0_stride = plan[j++];
  p.xs1_stride = plan[j++];
  const int smem_bytes = plan[j++];
  const int D = p.H * DH;
  if (p.B < 1 || p.Bc < p.B || p.L < 1 || p.T < 1 || p.S < 1 || p.F % 16 || p.rows < 1 ||
      p.rows > MAXR || p.csize < 1 || p.csize > MAXC || clusters * p.rows < p.B ||
      (clusters - 1) * p.rows >= p.B || (p.teams != 1 && p.teams != 2 && p.teams != 4 &&
                                         p.teams != 8) ||
      p.ipb * p.csize < p.rows * p.H || p.ipb > MAX_ITEMS || p.nslot < 1 || p.nslot > MAX_SLOTS ||
      p.slot_bytes % 128 || p.xs0_stride < D + 8 || p.xs1_stride < (D > p.F ? D : p.F) + 8 ||
      smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < N_GEMMS; ++g) {  // every block's share fits the plan
    int K, N;
    gemm_kn(D, p.F, g, K, N);
    const int P = N / 16, np = (P + p.csize - 1) / p.csize;
    if (np > MAX_NP || np * k_splits(np) > MAX_PAIRS || p.slot_tiles < np ||
        np * (p.slot_tiles / np < K / 16 ? p.slot_tiles / np : K / 16) * TILE_ELEMS *
                (int)sizeof(WT) > p.slot_bytes)
      return (int)cudaErrorInvalidValue;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * p.csize);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // more than 48 KB of dynamic shared memory and more than 8 blocks a
  // cluster have to be asked for; a cluster that cannot be resident at all
  // is refused here rather than run smaller
  static int ok_csize = 0, ok_smem = 0;
  if (ok_csize != p.csize || ok_smem != smem_bytes) {
    cudaError_t e = cudaFuncSetAttribute(cluster_step_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess && p.csize > 8)
      e = cudaFuncSetAttribute(cluster_step_kernel<WT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int active = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&active, cluster_step_kernel<WT>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return (int)cudaErrorLaunchOutOfResources;
    ok_csize = p.csize;
    ok_smem = smem_bytes;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_step_kernel<WT>, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename WT>
int max_active(int csize, int smem_bytes, int* active) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaFuncSetAttribute(cluster_step_kernel<WT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess && csize > 8)
    e = cudaFuncSetAttribute(cluster_step_kernel<WT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(active, cluster_step_kernel<WT>, &cfg);
  return (int)e;
}

// int8 weight codes need one fp32 scale per output channel and matrix
bool have_scales(const void* const* ptrs) {
  for (int g = 0; g < N_GEMMS; ++g)
    if (!ptrs[16 + g]) return false;
  return true;
}

}  // namespace

// One decoder step over fp32 caches, bf16 weights: one launch of
// ceil(B / rows) clusters.
extern "C" int tts_decode_step_fp32(const void* const* ptrs, const int* dims, const int* plan,
                                    float eps, void* stream) {
  return launch<bf16>(ptrs, dims, plan, eps, stream);
}

// int8 weight codes with one fp32 scale per output channel and matrix.
extern "C" int tts_decode_step_int8_fp32(const void* const* ptrs, const int* dims,
                                         const int* plan, float eps, void* stream) {
  if (!have_scales(ptrs)) return (int)cudaErrorInvalidValue;
  return launch<int8_t>(ptrs, dims, plan, eps, stream);
}

// How many clusters of csize blocks, each with smem_bytes of shared
// memory, the card holds at once (into *active); the cudaError_t.
extern "C" int tts_step_cluster_max_active(int csize, int smem_bytes, int int8w, int* active) {
  return int8w ? max_active<int8_t>(csize, smem_bytes, active)
               : max_active<bf16>(csize, smem_bytes, active);
}

