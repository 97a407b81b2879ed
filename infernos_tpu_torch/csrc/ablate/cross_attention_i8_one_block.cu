// The one-block-per-(batch, head) schedule that csrc/cross_attention_i8.cu
// replaced, with the switches of ops/cross_attention_i8_ablate.py
// (-DXI8_ABLATE_SOFTMAX, -DXI8_ABLATE_V, -DXI8_TRACE).  It computes the same
// function.  `python -m infernos_tpu_torch.ops.cross_attention_i8_ablate
// --parent` builds and times it; ops/build.py does not build it and no path
// of the port launches it.
//
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
// [B 16, H 20, S 1500, Dh 64] one call reads 61.44 MB of K and V codes
// and 3.84 MB of scales: 0.0195 ms at 3.35 TB/s, 32 calls a step; the
// 61 M integer MACs are nothing beside that.  Where the data lets it read
// less, it does: K rows of masked positions and V rows whose weight code is
// 0 are not read.
//
// Design (simple first): one block of 256 threads per (batch, head).
// - q's 64 codes go to shared memory; each K row (64 bytes) is read by 4
//   threads as one 16-byte load each, four __dp4a, and two shuffles; the
//   loads of 4 rows a thread are issued before their products;
// - the fp32 logits of all S positions stay in dynamic shared memory
//   (4 S bytes), then the weights' codes (S bytes);
// - block reductions for the softmax max and sum and for ws;
// - P.V: 4 threads a V row, each 16 dims of 16-byte loads, int32 partial
//   sums per dim, summed across the block by shuffles and shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;                // head dim, compile-time
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 4;                // threads a 64-byte row, 16 bytes each
constexpr int ROWS = THREADS / SUB;   // rows one pass of the block covers
constexpr int UNROLL = 4;             // rows a thread loads before their products
constexpr float NEG_INF = -1e9f;
constexpr int SMEM_MAX = 232448;
constexpr int STATIC_SMEM = 4096;     // an upper bound of the static arrays below

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
#define TRACE(i)                                                            \
  do {                                                                      \
    __syncthreads();                                                        \
    if (threadIdx.x == 0 && blockIdx.x < TRACE_BLOCKS) g_trace[blockIdx.x][i] = clock64(); \
  } while (0)
#else
#define TRACE(i) \
  do {           \
  } while (0)
#endif

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Every thread gets the block's max (sum) of v; `red` holds WARPS floats.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w]);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < WARPS; ++w) v += red[w];
  return v;
}

// byte k (0..3) of x as a signed int
__device__ __forceinline__ int sbyte(int x, int k) { return (x << (24 - 8 * k)) >> 24; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_i8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                const float* __restrict__ ks, const int8_t* __restrict__ vq,
                const float* __restrict__ vs, const uint8_t* __restrict__ mask,
                T* __restrict__ out, int8_t* __restrict__ codes_out, int H, int S) {
  extern __shared__ float logit[];                       // [S] logits, exps, then wp
  int8_t* wq = reinterpret_cast<int8_t*>(logit + S);     // [S] the weights' codes
  __shared__ float qf[DH];
  __shared__ __align__(16) int8_t qq[DH];
  __shared__ float red[WARPS];
  __shared__ int part[WARPS][DH];

  const int bh = blockIdx.x, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid & (SUB - 1), row = tid / SUB;

#ifdef XI8_TRACE
  if (tid == 0 && bh < TRACE_BLOCKS) g_trace[bh][6] = gtimer();
#endif
  TRACE(0);
  // q's codes and scale
  if (tid < DH) qf[tid] = to_f32(q[(size_t)bh * DH + tid]);
  __syncthreads();
  if (warp == 0) {
    float a = fmaxf(fabsf(qf[lane]), fabsf(qf[lane + 32]));
    for (int o = 16; o; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0) red[0] = fmaxf(a, 1e-8f);
  }
  __syncthreads();
  const float qs = red[0] / 127.0f;
  if (tid < DH) qq[tid] = (int8_t)fminf(fmaxf(rintf(qf[tid] / qs), -127.0f), 127.0f);
  __syncthreads();
  TRACE(1);

  // logits: 4 threads a K row
  const int4 qv = reinterpret_cast<const int4*>(qq)[sub];
  const int4* krows = reinterpret_cast<const int4*>(kq + (size_t)bh * S * DH);
  const float* ksb = ks + (size_t)bh * S;
  const uint8_t* mrow = mask ? mask + (size_t)b * S : nullptr;
  for (int s0 = 0; s0 < S; s0 += ROWS * UNROLL) {
    int4 kv[UNROLL];
    bool valid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * ROWS + row;
      valid[u] = s < S && (mrow == nullptr || mrow[s]);
      kv[u] = valid[u] ? __ldcs(krows + (size_t)s * SUB + sub) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * ROWS + row;
      int acc = __dp4a(kv[u].x, qv.x, 0);
      acc = __dp4a(kv[u].y, qv.y, acc);
      acc = __dp4a(kv[u].z, qv.z, acc);
      acc = __dp4a(kv[u].w, qv.w, acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (sub == 0 && s < S) logit[s] = valid[u] ? ((float)acc * qs) * ksb[s] : NEG_INF;
    }
  }
  __syncthreads();
  TRACE(2);
#ifdef XI8_ABLATE_SOFTMAX  // the K pass alone
  if (tid < DH) store(out + (size_t)bh * DH + tid, logit[tid % S]);
  return;
#endif

  // softmax in fp32, V's scales folded in, the weights' codes
  float m = -INFINITY;
  for (int s = tid; s < S; s += THREADS) m = fmaxf(m, logit[s]);
  m = block_max(m, red);
  float sum = 0.0f;
  for (int s = tid; s < S; s += THREADS) {
    const float e = expf(logit[s] - m);
    logit[s] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  const float* vsb = vs + (size_t)bh * S;
  float wmax = 0.0f;
  for (int s = tid; s < S; s += THREADS) {
    const float w = logit[s] / sum;
    const float wp = w != 0.0f ? w * vsb[s] : 0.0f;
    logit[s] = wp;
    wmax = fmaxf(wmax, wp);
  }
  const float ws = fmaxf(block_max(wmax, red), 1e-20f) / 127.0f;
  for (int s = tid; s < S; s += THREADS) {
    const int8_t c = (int8_t)fminf(fmaxf(rintf(logit[s] / ws), 0.0f), 127.0f);
    wq[s] = c;
    if (codes_out) codes_out[(size_t)bh * S + s] = c;
  }
  __syncthreads();
  TRACE(3);
#ifdef XI8_ABLATE_V  // the K pass and the softmax
  if (tid < DH) store(out + (size_t)bh * DH + tid, (float)wq[tid % S] * ws);
  return;
#endif

  // P.V: 4 threads a V row, 16 dims each; rows of code 0 are not read
  const int4* vrows = reinterpret_cast<const int4*>(vq + (size_t)bh * S * DH);
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int s0 = 0; s0 < S; s0 += ROWS * UNROLL) {
    int4 vv[UNROLL];
    int c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * ROWS + row;
      c[u] = s < S ? wq[s] : 0;
      vv[u] = c[u] ? __ldcs(vrows + (size_t)s * SUB + sub) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w4[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[4 * i + k] += c[u] * sbyte(w4[i], k);
    }
  }
  // sum over the 8 rows of a warp that share `sub` (lanes sub, sub + 4, ...)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int v = acc[j];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    acc[j] = v;
  }
  if (lane < SUB) {
#pragma unroll
    for (int j = 0; j < 16; ++j) part[warp][16 * lane + j] = acc[j];
  }
  __syncthreads();
  TRACE(4);
  if (tid < DH) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += part[w][tid];
    store(out + (size_t)bh * DH + tid, (float)total * ws);
  }
  TRACE(5);
#ifdef XI8_TRACE
  if (tid == 0 && bh < TRACE_BLOCKS) g_trace[bh][7] = gtimer();
#endif
}

template <typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* mask, void* out, void* codes, int B, int H, int S, cudaStream_t st) {
  const int smem = S * (int)(sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cross_i8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cross_i8_kernel<T><<<B * H, THREADS, smem, st>>>(
      (const T*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq, (const float*)vs,
      (const uint8_t*)mask, (T*)out, (int8_t*)codes, H, S);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, 1, 64] (bf16 if `bf16`, else fp32); kq, vq int8 [B, H, S, 64];
// ks, vs fp32 [B, H, S, 1]; mask bool [B, S] or null (every position
// valid); out [B, H, 1, 64] in q's type; codes int8 [B, H, S] or null
// (receives the weights' codes).  All contiguous, on the current device;
// launched on `stream`.  Returns a cudaError_t.
#ifdef XI8_TRACE
// the trace of the last launch: `n` blocks of TRACE_SLOTS values into `dst`
extern "C" int cross_attn_i8_trace(long long* dst, int n) {
  if (n > TRACE_BLOCKS) n = TRACE_BLOCKS;
  return (int)cudaMemcpyFromSymbol(dst, g_trace, (size_t)n * TRACE_SLOTS * sizeof(long long));
}
#endif

extern "C" int cross_attn_i8(const void* q, const void* kq, const void* ks, const void* vq,
                             const void* vs, const void* mask, void* out, void* codes,
                             int bf16, int B, int H, int S, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 0x7fffffffLL ||
      (long long)S * 5 + STATIC_SMEM > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(q, kq, ks, vq, vs, mask, out, codes, B, H, S, st)
              : launch<float>(q, kq, ks, vq, vs, mask, out, codes, B, H, S, st);
}
