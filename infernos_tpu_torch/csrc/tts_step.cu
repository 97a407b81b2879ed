// SpeechT5 autoregressive decoder step for Hopper (sm_90a).
//
// Replaces infernos_tpu/ops/tts_step.py::_layer_kernel (the Pallas fused
// decoder step behind fused_decode_step, called from TTSEngine._decode_chunk).
// One step for B slots, each at its own position, through all L layers.
// tts_decode_step() below launches, per layer, 11 kernels of three kinds:
//   qkv GEMM -> self attention (writes the new K/V row at pos) -> out GEMM
//   -> add+LN -> cross-q GEMM -> cross attention -> out GEMM -> add+LN
//   -> FFN-in GEMM (+exact GELU) -> FFN-out GEMM -> add+LN.
// The whole chain is launched from this one C call, so the host pays one
// foreign call per step and not one per kernel.
//
// Bound on an H100 SXM at full SpeechT5 width (D 768, F 3072, L 6, H 12,
// B 8): the step must read ~99 MB of bf16 decoder weights (about 30 us at
// 3.35 TB/s); at pos ~256 the self and cross caches add ~52 MB, about 45 us
// in all.  It is memory-bound: B <= 32 rows leave the tensor cores idle, so
// the GEMM streams each weight row once with coalesced 16-byte loads, keeps
// the B rows of x in shared memory and accumulates in fp32.  A 768-wide
// output has only 12 column tiles, so K is split across blocks as well
// (the last block of a tile to finish sums the partials in a fixed order:
// deterministic) to put enough blocks in flight to stream the weights.
// Fusing the whole step into one persistent kernel (no hidden-state round
// trips, no launch gaps) is later work.
//
// Hidden states are fp32 [B, D]; weights bf16 [K, N] row-major ([in, out],
// the 1/sqrt(Dh) attention scale already folded into the q weights and
// biases); caches bf16 canonical [L, B, H, T, 64].
//
// int8-weight mode (the int8w branch of the same Pallas kernel,
// tts_decode_step_int8 below): every big matrix is int8 codes [K, N] with
// an fp32 scale per output channel.  The codes widen to fp32 exactly
// (|code| <= 127) inside the same GEMM, the products accumulate unscaled in
// fp32 (split-K partials too), and the block that finishes a tile applies
// y * scale[n] + bias[n] and then the activation, in the TPU kernel's
// order.  The attention scale is folded into the q third of the SCALES and
// biases; the codes are untouched.  The step then reads ~49.5 MB of weights
// instead of ~99 MB; attention and add+LN kernels are shared by both modes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- small-M GEMM
constexpr int GN = 64;        // output columns per block
constexpr int GW = 8;         // warps per block; they split each K chunk
constexpr int GM = 8;         // x rows per block (blockIdx.y covers more)
constexpr int KC = 256;       // K chunk staged in shared memory
constexpr int KMIN = 64;      // fewest K rows one split takes
constexpr int TARGET_BLOCKS = 264;  // two blocks per SM on 132 SMs

// What one 16-byte load of a lane holds, by weight type: COLS output columns
// of one K row (8 bf16 or 16 int8), and how many of the block's GM x rows
// the lane accumulates for them.  ROWS * COLS = 64 accumulators either way:
// with all 8 rows an int8 lane would hold 128, which leaves one block per
// SM; so two int8 lanes read the same 16 bytes (one request, broadcast) and
// take four rows each.
template <typename WT> struct Lane;
template <> struct Lane<bf16> { static constexpr int COLS = 8, ROWS = 8; };
template <> struct Lane<int8_t> { static constexpr int COLS = 16, ROWS = 4; };

__device__ __forceinline__ void load_cols(const bf16* p, float* wv) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p2[e]);
    wv[2 * e] = f.x;
    wv[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load_cols(const int8_t* p, float* wv) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
  // code + 128 is a byte u in 1..255; placed in the low mantissa byte of
  // 2^23 it reads as the float 2^23 + u, so one byte permute and one
  // subtraction widen a code exactly, without an int-to-float conversion
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    wv[4 * e + 0] = __uint_as_float(__byte_perm(w[e], 0x4B000000u, 0x7540)) - 8388736.f;
    wv[4 * e + 1] = __uint_as_float(__byte_perm(w[e], 0x4B000000u, 0x7541)) - 8388736.f;
    wv[4 * e + 2] = __uint_as_float(__byte_perm(w[e], 0x4B000000u, 0x7542)) - 8388736.f;
    wv[4 * e + 3] = __uint_as_float(__byte_perm(w[e], 0x4B000000u, 0x7543)) - 8388736.f;
  }
}

// y = act(acc * scale + bias): the int8 mode's per-output-channel scale
// first (null for bf16 weights), then the bias, then the activation.
__device__ __forceinline__ float finish(float s, int col,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        int gelu) {
  if (scale) s *= scale[col];
  if (bias) s += bias[col];
  if (gelu) s = 0.5f * s * (1.f + erff(s * 0.70710678118654752f));
  return s;
}

// y[M, N] = act((x[M, K] @ w[K, N]) * scale + bias), N a multiple of the
// lane's COLS.  A lane reads COLS columns (one 16-byte load) of one K row
// and multiplies them with ROWS rows of x; 8 lanes cover the block's 64
// columns and 8 rows of one K row (bf16: 8 column groups; int8: 4 column
// groups x 2 row halves), and the warp's 4 such groups take 4 K rows at
// once, so a warp streams whole 128- or 64-byte row segments per load.
// blockIdx.z takes K rows [z * ks_len, (z + 1) * ks_len); with gridDim.z > 1
// each block writes its unscaled partial to part[z][M][N] and the last
// block of its (x, y) tile reduces them in split order.
template <typename WT>
__global__ void __launch_bounds__(GW * 32)
gemm_bias_act_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int M, int K, int N, int gelu, int ks_len,
                     float* __restrict__ part, int* __restrict__ counters) {
  constexpr int COLS = Lane<WT>::COLS, ROWS = Lane<WT>::ROWS;
  constexpr int LPR = GN / COLS;        // lanes across one row segment
  constexpr int LPK = LPR * GM / ROWS;  // lanes on one K row
  constexpr int RPW = 32 / LPK;         // K rows a warp reads at once
  constexpr int RPB = GW * RPW;         // K rows a block reads at once
  __shared__ float xs[GM][KC];
  __shared__ float red[GW][GM][GN];
  __shared__ int am_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane / LPK;            // K-row group of this lane
  const int r0 = (lane % LPK) / LPR * ROWS;  // its first x row
  const int c8 = (lane % LPR) * COLS;   // its columns inside the block's 64
  const int n = blockIdx.x * GN + c8;
  const int m0 = blockIdx.y * GM;
  const int kbeg = blockIdx.z * ks_len;
  const int kend = min(K, kbeg + ks_len);
  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += KC) {
    const int kc = min(KC, kend - k0);
    __syncthreads();
    for (int i = tid; i < GM * KC; i += GW * 32) {
      const int r = i / KC, c = i % KC;
      xs[r][c] = (m0 + r < M && c < kc) ? x[(size_t)(m0 + r) * K + k0 + c] : 0.f;
    }
    __syncthreads();
    if (n < N) {
#pragma unroll 4
      for (int kk = warp * RPW + rg; kk < kc; kk += RPB) {
        float wv[COLS];
        load_cols(w + (size_t)(k0 + kk) * N + n, wv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = xs[r0 + r][kk];
#pragma unroll
          for (int j = 0; j < COLS; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
        }
      }
    }
  }
  // sum the K-row groups of the warp, then the warps of the block
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][j] = v;
    }
  if (rg == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < COLS; ++j) red[warp][r0 + r][c8 + j] = acc[r][j];
  }
  __syncthreads();
  const int splits = gridDim.z;
  for (int i = tid; i < GM * GN; i += GW * 32) {
    const int r = i / GN, c = i % GN;
    const int col = blockIdx.x * GN + c;
    if (m0 + r >= M || col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < GW; ++q) s += red[q][r][c];
    if (splits > 1) {
      part[((size_t)blockIdx.z * M + m0 + r) * N + col] = s;
      continue;
    }
    y[(size_t)(m0 + r) * N + col] = finish(s, col, scale, bias, gelu);
  }
  if (splits == 1) return;

  // last block of this tile: sum the partials in split order
  __threadfence();
  __syncthreads();
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) am_last = (atomicAdd(counter, 1) == splits - 1);
  __syncthreads();
  if (!am_last) return;
  __threadfence();
  for (int i = tid; i < GM * GN; i += GW * 32) {
    const int r = i / GN, c = i % GN;
    const int col = blockIdx.x * GN + c;
    if (m0 + r >= M || col >= N) continue;
    float s = 0.f;
    for (int z = 0; z < splits; ++z)
      s += __ldcg(part + ((size_t)z * M + m0 + r) * N + col);
    y[(size_t)(m0 + r) * N + col] = finish(s, col, scale, bias, gelu);
  }
  if (tid == 0) *counter = 0;  // ready for the next GEMM
}

// ---------------------------------------------------- block reductions
constexpr int BT = 256;  // threads of the attention and LayerNorm blocks

__device__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < BT / 32; ++w) s += sh[w];
  return s;
}

__device__ float block_max(float v, float* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float m = sh[0];
#pragma unroll
  for (int w = 1; w < BT / 32; ++w) m = fmaxf(m, sh[w]);
  return m;
}

// ------------------------------------------------- single-query attention
// One block of 8 warps per (slot b, head h).  Self mode (pos != nullptr):
// first writes the new K/V row at p = min(pos[b], T - 1), then attends keys
// 0..p, so nothing past the slot's own position is read.  Cross mode:
// attends all T keys with the additive mask [B, T] (or none).  Pass 1 gives
// each thread one key (its 128-byte K row against q in shared memory) and
// keeps the scores in shared memory; the softmax is exact over them; pass 2
// gives each warp a strided subset of keys and each lane two dims, so V
// rows are read 128 contiguous bytes at a time.
constexpr int DH = 64;
constexpr int AW = BT / 32;
constexpr int MAXT = 4096;  // longest cache the score buffer holds

__global__ void __launch_bounds__(BT)
attn_step_kernel(const float* __restrict__ q, int q_stride,
                 const float* __restrict__ knew, const float* __restrict__ vnew,
                 int new_stride, bf16* __restrict__ Kc, bf16* __restrict__ Vc,
                 const int* __restrict__ pos, const float* __restrict__ mask,
                 int H, int T, float* __restrict__ out) {
  __shared__ float qs[DH];
  __shared__ float sc[MAXT];
  __shared__ float sh[AW];
  __shared__ float accs[AW][DH];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < DH) qs[tid] = q[(size_t)b * q_stride + h * DH + tid];
  const size_t cbase = ((size_t)b * H + h) * T * DH;
  bf16* Kb = Kc + cbase;
  bf16* Vb = Vc + cbase;

  int last = T - 1;
  if (pos != nullptr) {
    last = min(pos[b], T - 1);
    if (tid < DH / 2) {
      const int d = tid * 2;
      const size_t src = (size_t)b * new_stride + h * DH + d;
      *reinterpret_cast<__nv_bfloat162*>(Kb + (size_t)last * DH + d) =
          __floats2bfloat162_rn(knew[src], knew[src + 1]);
      *reinterpret_cast<__nv_bfloat162*>(Vb + (size_t)last * DH + d) =
          __floats2bfloat162_rn(vnew[src], vnew[src + 1]);
    }
  }
  __syncthreads();  // q staged; the row just written is read back below
  const int nk = last + 1;

  float mx = -INFINITY;
  for (int j = tid; j < nk; j += BT) {
    const uint4* kr = reinterpret_cast<const uint4*>(Kb + (size_t)j * DH);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const uint4 raw = kr[c];
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p2[e]);
        s = fmaf(qs[c * 8 + 2 * e], f.x, s);
        s = fmaf(qs[c * 8 + 2 * e + 1], f.y, s);
      }
    }
    if (mask != nullptr) s += mask[(size_t)b * T + j];
    sc[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, sh);
  float sum = 0.f;
  for (int j = tid; j < nk; j += BT) {
    const float p = expf(sc[j] - mx);
    sc[j] = p;
    sum += p;
  }
  sum = block_sum(sum, sh);  // its barriers also publish sc

  const int d = lane * 2;
  float a0 = 0.f, a1 = 0.f;
  for (int j = warp; j < nk; j += AW) {
    const float p = sc[j];
    const float2 vv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(Vb + (size_t)j * DH + d));
    a0 = fmaf(p, vv.x, a0);
    a1 = fmaf(p, vv.y, a1);
  }
  accs[warp][d] = a0;
  accs[warp][d + 1] = a1;
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < AW; ++w) o += accs[w][tid];
    out[(size_t)b * H * DH + h * DH + tid] = o / sum;
  }
}

// ------------------------------------------------------ residual + LayerNorm
// x[row] = LN(x[row] + h[row]) * g + b, in place; one block per row.
constexpr int LMAX = 4096;

__global__ void __launch_bounds__(BT)
add_ln_kernel(float* __restrict__ x, const float* __restrict__ h,
              const float* __restrict__ g, const float* __restrict__ bta,
              int D, float eps) {
  __shared__ float buf[LMAX];
  __shared__ float sh[BT / 32];
  float* xr = x + (size_t)blockIdx.x * D;
  const float* hr = h + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += BT) {
    const float v = xr[i] + hr[i];
    buf[i] = v;
    s += v;
  }
  const float mu = block_sum(s, sh) / D;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += BT) {
    const float c = buf[i] - mu;
    s2 += c * c;
  }
  const float rstd = rsqrtf(block_sum(s2, sh) / D + eps);
  for (int i = threadIdx.x; i < D; i += BT)
    xr[i] = (buf[i] - mu) * rstd * g[i] + bta[i];
}

// ---------------------------------------------------------------- launchers
struct Scratch {
  float* part;
  int part_cap;  // floats
  int* counters;
  int n_counters;
};

template <typename WT>
int gemm(const float* x, const WT* w, const float* scale, const float* bias,
         float* y, int M, int K, int N, int gelu, const Scratch& sc,
         cudaStream_t st) {
  constexpr int RPB =
      GW * 32 / (GN / Lane<WT>::COLS * GM / Lane<WT>::ROWS);  // as the kernel's
  const int nx = (N + GN - 1) / GN, ny = (M + GM - 1) / GM;
  int splits = (TARGET_BLOCKS + nx * ny - 1) / (nx * ny);
  splits = max(1, min(splits, K / KMIN));
  while (splits > 1 && (size_t)splits * M * N > (size_t)sc.part_cap) --splits;
  if (splits > 1 && nx * ny > sc.n_counters) splits = 1;
  int ks_len = (K + splits - 1) / splits;
  ks_len = (ks_len + RPB - 1) / RPB * RPB;
  splits = (K + ks_len - 1) / ks_len;
  gemm_bias_act_kernel<WT><<<dim3(nx, ny, splits), GW * 32, 0, st>>>(
      x, w, scale, bias, y, M, K, N, gelu, ks_len, sc.part, sc.counters);
  return (int)cudaGetLastError();
}

int attn(const float* q, int q_stride, const float* knew, const float* vnew,
         int new_stride, bf16* K, bf16* V, const int* pos, const float* mask,
         int B, int H, int T, float* out, cudaStream_t st) {
  attn_step_kernel<<<B * H, BT, 0, st>>>(q, q_stride, knew, vnew, new_stride,
                                         K, V, pos, mask, H, T, out);
  return (int)cudaGetLastError();
}

int add_ln(float* x, const float* h, const float* g, const float* b, int M,
           int D, float eps, cudaStream_t st) {
  add_ln_kernel<<<M, BT, 0, st>>>(x, h, g, b, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

#define TTS_TRY(call)          \
  do {                         \
    const int rc_ = (call);    \
    if (rc_ != 0) return rc_;  \
  } while (0)

// One decoder step through all L layers (11 launches per layer).
//   h [B, D] fp32, in: the step's input x, out: its hidden state;
//   pos [B] int32; mask [B, S] fp32 additive or null;
//   weights [L, K, N] bf16 (tts_decode_step) or int8 codes
//   (tts_decode_step_int8, with fp32 scales [L, N] per matrix); biases and
//   LN params [L, N] fp32;
//   self_k/v [L, B, H, T, 64] bf16 (row pos written), cross_k/v
//   [L, B, H, S, 64] bf16;
//   scratch: y [B, 3D], a [B, D], t [B, D], mid [B, F] fp32, part
//   (part_cap floats), counters (n_counters ints, zeroed here).
template <typename WT>
static int decode_step(
    void* h, const void* pos, const void* mask,
    const void* wqkv, const void* bqkv, const void* wso, const void* bso,
    const void* wcq, const void* bcq, const void* wco, const void* bco,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* ln1g, const void* ln1b, const void* ln2g, const void* ln2b,
    const void* ln3g, const void* ln3b,
    const void* sqkv, const void* sso, const void* scq, const void* sco,
    const void* s1, const void* s2,
    void* self_k, void* self_v, void* cross_k, void* cross_v,
    void* y, void* a, void* t, void* mid, void* part, int part_cap,
    void* counters, int n_counters,
    int L, int B, int H, int T, int S, int F, float eps, void* stream) {
  constexpr int COLS = Lane<WT>::COLS;
  const int D = H * DH;
  if (D > LMAX || (D % COLS) || (F % COLS) || T > MAXT || S > MAXT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch sc{(float*)part, part_cap, (int*)counters, n_counters};
  TTS_TRY((int)cudaMemsetAsync(counters, 0, sizeof(int) * n_counters, st));
  float* hp = (float*)h;
  float* yp = (float*)y;
  float* ap = (float*)a;
  float* tp = (float*)t;
  float* mp = (float*)mid;
  const WT* Wqkv = (const WT*)wqkv;
  const WT* Wso = (const WT*)wso;
  const WT* Wcq = (const WT*)wcq;
  const WT* Wco = (const WT*)wco;
  const WT* W1 = (const WT*)w1;
  const WT* W2 = (const WT*)w2;
  // layer l's scales, or null for bf16 weights
  auto sl = [](const void* s, size_t off) {
    return s ? (const float*)s + off : (const float*)nullptr;
  };
  const size_t self_l = (size_t)B * H * T * DH, cross_l = (size_t)B * H * S * DH;
  for (int l = 0; l < L; ++l) {
    bf16* sk = (bf16*)self_k + l * self_l;
    bf16* sv = (bf16*)self_v + l * self_l;
    bf16* ck = (bf16*)cross_k + l * cross_l;
    bf16* cv = (bf16*)cross_v + l * cross_l;
    const size_t lD = (size_t)l * D, lF = (size_t)l * F;
    TTS_TRY(gemm(hp, Wqkv + lD * 3 * D, sl(sqkv, 3 * lD),
                 (const float*)bqkv + 3 * lD, yp, B, D, 3 * D, 0, sc, st));
    TTS_TRY(attn(yp, 3 * D, yp + D, yp + 2 * D, 3 * D, sk, sv,
                 (const int*)pos, nullptr, B, H, T, ap, st));
    TTS_TRY(gemm(ap, Wso + lD * D, sl(sso, lD), (const float*)bso + lD, tp, B,
                 D, D, 0, sc, st));
    TTS_TRY(add_ln(hp, tp, (const float*)ln1g + lD, (const float*)ln1b + lD, B,
                   D, eps, st));
    TTS_TRY(gemm(hp, Wcq + lD * D, sl(scq, lD), (const float*)bcq + lD, yp, B,
                 D, D, 0, sc, st));
    TTS_TRY(attn(yp, D, nullptr, nullptr, 0, ck, cv, nullptr,
                 (const float*)mask, B, H, S, ap, st));
    TTS_TRY(gemm(ap, Wco + lD * D, sl(sco, lD), (const float*)bco + lD, tp, B,
                 D, D, 0, sc, st));
    TTS_TRY(add_ln(hp, tp, (const float*)ln2g + lD, (const float*)ln2b + lD, B,
                   D, eps, st));
    TTS_TRY(gemm(hp, W1 + lD * F, sl(s1, lF), (const float*)b1 + lF, mp, B, D,
                 F, 1, sc, st));
    TTS_TRY(gemm(mp, W2 + lF * D, sl(s2, lD), (const float*)b2 + lD, tp, B, F,
                 D, 0, sc, st));
    TTS_TRY(add_ln(hp, tp, (const float*)ln3g + lD, (const float*)ln3b + lD, B,
                   D, eps, st));
  }
  return 0;
}

// bf16 weights, no scales.
extern "C" int tts_decode_step(
    void* h, const void* pos, const void* mask,
    const void* wqkv, const void* bqkv, const void* wso, const void* bso,
    const void* wcq, const void* bcq, const void* wco, const void* bco,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* ln1g, const void* ln1b, const void* ln2g, const void* ln2b,
    const void* ln3g, const void* ln3b,
    void* self_k, void* self_v, void* cross_k, void* cross_v,
    void* y, void* a, void* t, void* mid, void* part, int part_cap,
    void* counters, int n_counters,
    int L, int B, int H, int T, int S, int F, float eps, void* stream) {
  return decode_step<bf16>(
      h, pos, mask, wqkv, bqkv, wso, bso, wcq, bcq, wco, bco, w1, b1, w2, b2,
      ln1g, ln1b, ln2g, ln2b, ln3g, ln3b, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, self_k, self_v, cross_k, cross_v, y, a, t, mid, part,
      part_cap, counters, n_counters, L, B, H, T, S, F, eps, stream);
}

// int8 weight codes with one fp32 scale per output channel and matrix
// (sqkv [L, 3D], sso, scq, sco, s2 [L, D], s1 [L, F]); D and F multiples
// of 16.
extern "C" int tts_decode_step_int8(
    void* h, const void* pos, const void* mask,
    const void* wqkv, const void* bqkv, const void* wso, const void* bso,
    const void* wcq, const void* bcq, const void* wco, const void* bco,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* ln1g, const void* ln1b, const void* ln2g, const void* ln2b,
    const void* ln3g, const void* ln3b,
    const void* sqkv, const void* sso, const void* scq, const void* sco,
    const void* s1, const void* s2,
    void* self_k, void* self_v, void* cross_k, void* cross_v,
    void* y, void* a, void* t, void* mid, void* part, int part_cap,
    void* counters, int n_counters,
    int L, int B, int H, int T, int S, int F, float eps, void* stream) {
  if (!sqkv || !sso || !scq || !sco || !s1 || !s2)
    return (int)cudaErrorInvalidValue;
  return decode_step<int8_t>(
      h, pos, mask, wqkv, bqkv, wso, bso, wcq, bcq, wco, bco, w1, b1, w2, b2,
      ln1g, ln1b, ln2g, ln2b, ln3g, ln3b, sqkv, sso, scq, sco, s1, s2,
      self_k, self_v, cross_k, cross_v, y, a, t, mid, part, part_cap,
      counters, n_counters, L, B, H, T, S, F, eps, stream);
}
