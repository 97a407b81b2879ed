// Encoder self-attention forward for Hopper (sm_90a), bf16 in, fp32 math.
//
// Replaces infernos_tpu/ops/attention.py::_attn_kernel (the Pallas block-q
// kernel behind fused_attention, called from whisper.encode).  It computes
// softmax(q k^T / sqrt(Dh) + mask_add) v for q, k, v [BH, S, 64] bf16 and an
// additive fp32 key mask [BH, S]; the output has the input dtype.
//
// Bound on an H100 SXM at whisper-large-v3 width (BH = 20, S = 1500): one
// call does 4 * 20 * 1500^2 * 64 = 11.5 GFLOP, 11.6 us at 989 TFLOP/s bf16,
// against 15.4 MB of q, k, v, o (4.6 us at 3.35 TB/s): compute-bound, about
// 0.37 ms for the 32 calls of one encode.
//
// Design (a flash-attention forward; wgmma and TMA come later):
// - one block of 4 warps per (bh, 64-row q tile); each warp owns 16 q rows
//   and keeps their Q fragments in registers for the whole K/V loop;
// - K/V are staged 64 keys at a time in shared memory by cp.async, two
//   stages deep, so the next tile's copy overlaps this tile's products;
// - fragments come from shared memory by ldmatrix (V with .trans, so V
//   stays row-major); products use mma.sync m16n8k16 bf16 with fp32
//   accumulators;
// - online softmax in fp32 (base-2 exponent with log2(e) folded into the
//   scale); the S.P tile is reused in registers as the A operand of P.V;
// - the ragged edge is masked here: keys >= S get -inf and zero-filled K/V
//   rows, rows >= S are computed on zero Q and never stored -- so S = 1500
//   needs no padding to a tile multiple.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;       // head dim, compile-time
constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // keys per staged tile
constexpr int LDS = DH + 8;  // padded shared-memory row (bf16): 144 B, so the
                             // 8 rows of an ldmatrix hit 8 distinct bank groups
constexpr int NT = 128;      // threads per block
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four blocks per SM: the 480 blocks of a large-v3 call (20 heads x 24 q
// tiles) then run in one wave on 132 SMs
__global__ void __launch_bounds__(NT, 4)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ mask,
                bf16* __restrict__ o, int S, float scale_log2) {
  __shared__ __align__(128) bf16 Qs[BQ][LDS];
  __shared__ __align__(128) bf16 Ks[2][BK][LDS];
  __shared__ __align__(128) bf16 Vs[2][BK][LDS];
  __shared__ float Ms[2][BK];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * S * DH;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const float* mb = mask + (size_t)bh * S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto load_tile = [&](int st, int k0) {
    for (int i = tid; i < BK * DH / 8; i += NT) {
      const int r = i >> 3, c = (i & 7) * 8;
      const bool ok = k0 + r < S;
      const size_t off = (size_t)(ok ? k0 + r : 0) * DH + c;
      cp_async16(&Ks[st][r][c], kb + off, ok);
      cp_async16(&Vs[st][r][c], vb + off, ok);
    }
    if (tid < BK)
      Ms[st][tid] = (k0 + tid < S) ? mb[k0 + tid] * LOG2E : -INFINITY;
  };

  for (int i = tid; i < BQ * DH / 8; i += NT) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = q0 + r < S;
    cp_async16(&Qs[r][c], qb + (size_t)(ok ? q0 + r : 0) * DH + c, ok);
  }
  load_tile(0, 0);
  cp_async_commit();

  uint32_t qf[4][4];
  float oacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (S + BK - 1) / BK;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // start the next tile's copy, then wait for this one
      load_tile(st ^ 1, (it + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        ldsm_x4(qf[kc], &Qs[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t b[4];
        ldsm_x4(b, &Ks[st][n * 8 + (lane & 7)]
                      [(kp * 2 + (lane >> 4)) * 16 + ((lane >> 3) & 1) * 8]);
        mma16816(s[n], qf[2 * kp], b[0], b[1]);
        mma16816(s[n], qf[2 * kp + 1], b[2], b[3]);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float ma = Ms[st][n * 8 + t * 2], mc = Ms[st][n * 8 + t * 2 + 1];
      s[n][0] = s[n][0] * scale_log2 + ma;
      s[n][1] = s[n][1] * scale_log2 + mc;
      s[n][2] = s[n][2] * scale_log2 + ma;
      s[n][3] = s[n][3] * scale_log2 + mc;
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key 0 of every row is a real key, so the running max is finite from
    // the first tile on and exp2(-inf - m) is a clean 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }
    l0 = l0 * a0 + sum0;  // per-thread partial; summed over the quad at the end
    l1 = l1 * a1 + sum1;

    // O += P V: P from registers, V fragments by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4];
      a[0] = pack2(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack2(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, &Vs[st][kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)]
                        [(2 * np + (lane >> 4)) * 8]);
        mma16816(oacc[2 * np], a, b[0], b[1]);
        mma16816(oacc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = warp * 16 + g;
  const int row0 = q0 + r0, row1 = q0 + r0 + 8;
  bf16* ob = o + base;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * DH + c) =
          __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * DH + c) =
          __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

}  // namespace

extern "C" int attn_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* mask, void* o, int BH, int S,
                             float scale, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  dim3 grid((S + BQ - 1) / BQ, BH);
  attn_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask,
      (bf16*)o, S, scale * LOG2E);
  return (int)cudaGetLastError();
}
