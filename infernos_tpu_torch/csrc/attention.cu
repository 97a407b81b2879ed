// Encoder self-attention forward for Hopper (sm_90a): the bf16 mode (bf16
// in and out, fp32 math).  The fp32 mode is csrc/attention_fp32.cu.
//
// Replaces infernos_tpu/ops/attention.py::_attn_kernel (the Pallas block-q
// kernel behind fused_attention, called from whisper.encode), which takes
// its dtype from q: bf16 at full width, fp32 for the tiny and tiny-real
// encoders and the trainers.  It computes softmax(q k^T / sqrt(Dh) +
// mask_add) v per (batch, head) for q, k, v of one dtype
// and an optional additive fp32 key mask [B, S] (one row per batch element,
// shared by its heads; a null pointer means no mask).  Heads are read and
// written where they lie: every tensor comes with element strides for batch,
// head and row (the 64 values of a head's row are contiguous), so [B, S, D]
// projections (row stride D, head offset h * 64) need no transposed copy and
// [BH, S, 64] is the same call with H = 1.
//
// Bound on an H100 SXM at whisper-large-v3 width (20 heads, S = 1500): one
// call does 4 * 20 * 1500^2 * 64 = 11.5 GFLOP, 11.6 us at 989 TFLOP/s bf16,
// against 15.4 MB of q, k, v, o (4.6 us at 3.35 TB/s): compute-bound, about
// 0.37 ms for the 32 calls of one encode.  The softmax is dearer than the
// products at this head dim.  A 64 x 64 score tile costs the tensor cores
// 256 cycles of an SM and its 4,096 exponentials 256 cycles of the SFU pipe
// (16 a cycle), and per score the other pipes run a max (half rate), an
// fma, an add and half a bf16 pack: with copies and descriptors about 280
// instructions a thread and tile.  ops/attention_ablate.py times the
// kernel with parts compiled out: without the products it keeps five
// sixths of its time, without the exponentials nineteen twentieths, and
// with products, exponentials and copies all out still two thirds.  What
// is left to win is in the instruction count of the softmax and in
// overlapping the pipes, not in the products.
//
// Design of the bf16 mode (a flash-attention forward on wgmma; loads by
// cp.async):
// - a block is two warpgroups (256 threads) and owns 128 q rows of one
//   (batch, head); each warpgroup owns 64 of them, the M of one wgmma;
// - Q, K and V tiles lie in shared memory as rows of 128 bytes in the
//   128-byte-swizzled layout that wgmma descriptors name (SWIZZLE_128B):
//   16-byte chunk c of row r sits at chunk c ^ (r & 7), tiles start on
//   1,024-byte boundaries, 8-row groups are 1,024 bytes apart.  The 16-byte
//   cp.async copies write that layout themselves; no tensor map is needed.
//   Each thread keeps one pointer per tensor and moves it a tile on;
// - K/V are staged 128 keys at a time, two stages deep, one __syncthreads a
//   stage: the copy of stage j+1 is started right after the barrier that
//   frees its buffer and lands under the products of stage j.  Both
//   warpgroups share the staged K/V, which halves the L2 traffic of a block
//   per q row against one warpgroup a block;
// - S = Q K^T: wgmma m64n64k16, A (Q) and B (K, K-major) from shared memory,
//   four k-steps over the head dim, descriptors advanced by 32 bytes a step;
// - online softmax in fp32 registers (base-2 exponent, log2(e) folded into
//   the scale).  A thread's accumulators lie as in mma.sync: rows g and g+8
//   of its warp's 16, shared by a quad, hence two shuffle rounds.  A tile
//   with no mask and no ragged edge takes the short path: max over the raw
//   scores, then one fma and one ex2 per score.  The reference max of a row
//   moves only when a tile outgrows it by more than 2^8, so O is rescaled
//   on the first tile and hardly ever after;
// - O += P V: P goes in as the A operand from registers (the accumulator
//   layout of S is the A layout of the next product), V [keys, 64] is the B
//   operand with N contiguous: MN-major, the transpose bit set, 8-key groups
//   1,024 bytes apart (SBO), descriptors advanced by 2,048 bytes a k-step.
//   Each k-step of 16 keys is started as soon as its P fragment is packed,
//   so the product runs under the exponentials of the next fragment;
// - keys are processed 64 at a time (two halves of a stage): 32 score and
//   32 output accumulators plus 16 packed P registers a thread stay under the
//   128 registers that four warpgroups an SM allow.  The four resident
//   warpgroups are what overlaps softmax (one warpgroup) with products
//   (another);
// - the ragged edge is masked here: keys >= S get -inf and zero-filled K/V
//   rows, rows >= S are computed on zero Q and never stored, so S = 1500
//   needs no padding, and S smaller than a tile works.
//
// Waves at large-v3 (20 heads x S 1500): 12 q tiles of 128 rows x 20 = 240
// blocks; 83 KB of shared memory and 256 threads x <= 128 registers let two
// blocks share an SM: 264 places on 132 SMs, one wave.  One warpgroup a
// block with 128-key products would need about 170 registers: three blocks
// an SM, 396 places for 480 blocks, a second wave a fifth full.
//
// The ATTN_ABLATE_* switches compile parts of the kernel out for the timing
// experiments of ops/attention_ablate.py (wrong results, on purpose);
// ops/build.py never defines them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int DH = 64;             // head dim, compile-time
constexpr int WG_ROWS = 64;        // q rows per warpgroup: the M of a wgmma
constexpr int NWG = 2;             // warpgroups per block
constexpr int BQ = WG_ROWS * NWG;  // q rows per block
constexpr int KT = 128;            // keys per staged tile
constexpr int KSUB = 64;           // keys per product: the N of S, the K of PV
constexpr int NT = 128 * NWG;      // threads per block
constexpr int ROW_BYTES = DH * 2;  // one swizzle atom wide
constexpr int Q_BYTES = BQ * ROW_BYTES;
constexpr int KV_BYTES = KT * ROW_BYTES;
constexpr int OFF_K = Q_BYTES;
constexpr int OFF_V = OFF_K + 2 * KV_BYTES;
constexpr int OFF_M = OFF_V + 2 * KV_BYTES;
// + 1,024: the dynamic segment's start is rounded up to a swizzle boundary
constexpr int SMEM_BYTES = OFF_M + 2 * KT * 4 + 1024;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Strides {  // in elements
  long long b, h, r;
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
#ifdef ATTN_ABLATE_EXP
  return x * 1e-3f;
#endif
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// makes this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile with rows of 128 bytes:
// start address, LBO 1 (unused: the tile is one atom wide), SBO 1,024 bytes
// between 8-row groups, layout SWIZZLE_128B
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving uses of the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC32(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define ACC32_REGS                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (+)= A B^T: A [64, 16] and B [64, 16], both K-major in shared memory;
// accumulate == 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B: A [64, 16] from registers (the mma.sync A fragment of each
// warp's 16 rows), B [16, 64] MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t* a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// two blocks per SM (see the note on waves above)
__global__ void __launch_bounds__(NT, 2)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ mask,
                bf16* __restrict__ o, Strides sq, Strides sk, Strides sv,
                Strides so, int H, int S, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  float* Ms = reinterpret_cast<float*>(
      smem_raw + (smem - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw))) +
      OFF_M);

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const float* mb = mask ? mask + (size_t)b * S : nullptr;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // a thread copies 16-byte chunk lc of rows lr, lr + 32, lr + 64, lr + 96 of
  // every tile; 32 rows on, the swizzle phase (row & 7) is the same, so the
  // four destinations are 4,096 bytes apart
  const int lr = tid >> 3, lc = tid & 7;
  const uint32_t ldst = smem + swz(lr, lc);
  const bf16* kp = kb + lr * sk.r + lc * 8;  // this thread's chunk of tile 0
  const bf16* vp = vb + lr * sv.r + lc * 8;

  // copies tile (kp, vp) into stage st and moves the pointers one tile on
  auto load_tile = [&](int st, int k0) {
#pragma unroll
    for (int j = 0; j < KT / 32; ++j) {
      const bool ok = k0 + lr + 32 * j < S;
      const uint32_t dst = ldst + st * KV_BYTES + j * 32 * ROW_BYTES;
      cp_async16(dst + OFF_K, ok ? kp + j * 32 * sk.r : kb, ok);
      cp_async16(dst + OFF_V, ok ? vp + j * 32 * sv.r : vb, ok);
    }
    kp += KT * sk.r;
    vp += KT * sv.r;
    // the mask row of the tile; a tile with no mask and no ragged edge never
    // reads it
    if (tid < KT && (mb != nullptr || k0 + KT > S))
      Ms[st * KT + tid] = (k0 + tid < S)
                              ? (mb ? mb[k0 + tid] * LOG2E : 0.f)
                              : -INFINITY;
  };

#pragma unroll
  for (int j = 0; j < BQ / 32; ++j) {
    const bool ok = q0 + lr + 32 * j < S;
    cp_async16(ldst + j * 32 * ROW_BYTES,
               ok ? qb + (long long)(q0 + lr + 32 * j) * sq.r + lc * 8 : qb, ok);
  }
  load_tile(0, 0);
  cp_async_commit();

  // this warpgroup's 64 q rows: 8 whole swizzle groups into the Q tile
  const uint64_t desc_q = make_desc(smem + wg * WG_ROWS * ROW_BYTES);
  const uint64_t desc_k0 = make_desc(smem + OFF_K);
  const uint64_t desc_v0 = make_desc(smem + OFF_V);

  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (S + KT - 1) / KT;
  // one staged tile; st is a compile-time constant so that the descriptors
  // of its two halves are constants away from the stage-0 ones
  auto tile = [&](int it, auto st_c) {
    constexpr int st = decltype(st_c)::value;
    cp_async_wait_all();
    fence_async_proxy();
    // tile `it` has landed for every thread, and every thread is done with
    // the other stage (its products were waited for), so that stage may be
    // refilled while this one is used
    __syncthreads();
#ifndef ATTN_ABLATE_LOADS
    if (it + 1 < n_tiles) {
      load_tile(st ^ 1, (it + 1) * KT);
      cp_async_commit();
    }
#endif

#pragma unroll
    for (int half = 0; half < KT / KSUB; ++half) {
      const int k0 = it * KT + half * KSUB;
      if (k0 >= S) break;
      constexpr int sub16 = (st * KV_BYTES) >> 4;  // descriptor units
      const uint64_t desc_k = desc_k0 + sub16 + half * (KSUB * ROW_BYTES >> 4);
      const uint64_t desc_v = desc_v0 + sub16 + half * (KSUB * ROW_BYTES >> 4);

      // S = Q K^T for this warpgroup's 64 rows x 64 keys
      float s[32];
#ifdef ATTN_ABLATE_PRODUCTS
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 1.f + i;
#else
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)  // 16 head-dim values = 32 bytes
        wgmma_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
#endif

      // online softmax; s[4n..4n+1] are row g, s[4n+2..4n+3] row g + 8,
      // keys 8n + 2t and 8n + 2t + 1 of this half
      const bool masked = mb != nullptr || k0 + KSUB > S;
      float mx0 = -INFINITY, mx1 = -INFINITY;
      if (masked) {
        const float* ms = Ms + st * KT + half * KSUB + t * 2;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 mm = *reinterpret_cast<const float2*>(ms + n * 8);
          s[4 * n + 0] = fmaf(s[4 * n + 0], scale_log2, mm.x);
          s[4 * n + 1] = fmaf(s[4 * n + 1], scale_log2, mm.y);
          s[4 * n + 2] = fmaf(s[4 * n + 2], scale_log2, mm.x);
          s[4 * n + 3] = fmaf(s[4 * n + 3], scale_log2, mm.y);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n + 0], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // the running max lives in the scaled domain; the scale is positive,
      // so the max of the raw scores scales to the max of the scaled ones
      const float ps = masked ? 1.f : scale_log2;
      mx0 *= ps;
      mx1 *= ps;
      // The reference max moves only when some row of the warp outgrows its
      // own by more than 2^8: until then P stays under 256, well inside
      // bf16 and fp32, the output is the same softmax (any reference max
      // cancels in O / l), and the 32 multiplies that rescale O are skipped
      // on nearly every tile.  Key k0 of every row is a real key, so the
      // first tile always moves it off -inf to a finite value, and
      // ex2(-inf - m) is a clean 0.
      if (__any_sync(0xffffffffu, mx0 > m0 + 8.f || mx1 > m1 + 8.f)) {
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          oacc[4 * n + 0] *= a0;
          oacc[4 * n + 1] *= a0;
          oacc[4 * n + 2] *= a1;
          oacc[4 * n + 3] *= a1;
        }
      }

      // O += P V, 16 keys at a time: each k-step's product is started as soon
      // as its P fragment is packed and runs under the next one's
      // exponentials.  Ordinary instructions wrote oacc and pa, hence the
      // fences.
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[16];  // P as the A fragments of four k-steps of 16 keys
      fence_regs(oacc);
#pragma unroll
      for (int kc = 0; kc < KSUB / 16; ++kc) {
#pragma unroll
        for (int n = 2 * kc; n < 2 * kc + 2; ++n) {  // keys 0-7, 8-15 of the step
          const float p0 = ex2(fmaf(s[4 * n + 0], ps, -m0));
          const float p1 = ex2(fmaf(s[4 * n + 1], ps, -m0));
          const float p2 = ex2(fmaf(s[4 * n + 2], ps, -m1));
          const float p3 = ex2(fmaf(s[4 * n + 3], ps, -m1));
          sum0 += p0 + p1;
          sum1 += p2 + p3;
          pa[4 * kc + (n & 1) * 2 + 0] = pack2(p0, p1);
          pa[4 * kc + (n & 1) * 2 + 1] = pack2(p2, p3);
        }
#ifdef ATTN_ABLATE_PRODUCTS
#pragma unroll
        for (int i = 0; i < 4; ++i) oacc[4 * kc + i] += __uint_as_float(pa[4 * kc + i]);
#else
        wgmma_fence();
        // 16 keys on = 16 rows = 2,048 bytes
        wgmma_rs_tb(oacc, pa + 4 * kc, desc_v + kc * (16 * ROW_BYTES >> 4));
#endif
      }
      l0 += sum0;  // per-thread partials; summed over the quad at the end
      l1 += sum1;
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
    }
  };
  for (int it = 0; it < n_tiles; it += 2) {
    tile(it, std::integral_constant<int, 0>{});
    if (it + 1 < n_tiles) tile(it + 1, std::integral_constant<int, 1>{});
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + wg * WG_ROWS + warp * 16 + g, row1 = row0 + 8;
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * so.r + c) =
          __floats2bfloat162_rn(oacc[4 * n + 0] * inv0, oacc[4 * n + 1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * so.r + c) =
          __floats2bfloat162_rn(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and o in turn;
// mask may be null
extern "C" int attn_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* mask, void* o,
                             const long long* strides, int B, int H, int S,
                             float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  // more than 48 KB of dynamic shared memory has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const Strides* st = reinterpret_cast<const Strides*>(strides);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  attn_fwd_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask,
      (bf16*)o, st[0], st[1], st[2], st[3], H, S, scale * LOG2E);
  return (int)cudaGetLastError();
}
