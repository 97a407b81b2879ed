// SpeechT5 autoregressive decoder step for Hopper (sm_90a): one persistent
// kernel per step.
//
// Replaces infernos_tpu/ops/tts_step.py::_layer_kernel (the Pallas fused
// decoder step behind fused_decode_step, called from TTSEngine._decode_chunk).
// One step for B slots (1..32), each at its own position, through all L
// layers, in ONE cooperative launch: one block per SM walks the phases of
// every layer, separated by a grid-wide barrier:
//   qkv GEMM -> self attention (writes the new K/V row at pos) -> out GEMM
//   -> cross-q GEMM -> cross attention -> out GEMM -> FFN-in GEMM (+GELU)
//   -> FFN-out GEMM, then the next layer's qkv GEMM.
// 8 barriers a layer.  Residual + LayerNorm is no phase of its own: the
// blocks that finish an output projection also sum h + t and its square
// over their columns, per row, and every block of the next GEMM normalises
// its own rows of x from those sums (the TPU kernel keeps the hidden state
// on chip in x_scr in the same spirit); the blocks of its first column
// group write the new residual h into the other of two buffers.
//
// Bound on an H100 SXM at full SpeechT5 width (D 768, F 3072, L 6, H 12,
// B 8): the step must read ~85 MB of bf16 decoder weights (about 25 us at
// 3.35 TB/s; half of it in int8); at pos ~256 the self and cross caches add
// ~52 MB, about 45 us in all.  It is memory-bound: B <= 32 rows leave the
// tensor cores idle.  What the design does about it:
// - weights stream ahead.  Each product is cut into at most one item per
//   block (G panels of 16 output columns over one range of input rows; the
//   plan comes from ops/tts_step.py, and the items of successive products
//   start one block further on, so that no block always takes the biggest
//   share).  The weights are packed once into panels
//   ([L, N/16, K/16, 256]: ops/tts_step.py pack_panels), so an item is G
//   contiguous byte ranges.  Each block keeps a ring of shared-memory slots
//   and starts cp.async.bulk copies of its items of the next products at
//   the first grid barrier after a slot is freed (one thread starts them
//   while another waits there), tracked by one mbarrier a slot: the copies
//   run under the barriers, the attention phases and the other products, as the
//   TPU kernel's cross-phase DMAs do (tts_step.py:109-113);
// - products on the tensor cores, with A and B swapped: the weight tile is
//   the A operand (16 output columns x 16 rows, stored in the A fragment
//   order of mma.sync m16n8k16, so a lane takes its fragment with one
//   16-byte or 8-byte load) and x^T, B rounded to bf16 and padded to a
//   multiple of 8, the B operand from shared memory; fp32 accumulators.
//   mma.sync rather than wgmma: a product has 8 to 32 columns of x and a
//   few k-steps per warp, the tensor cores are not the bound, and the
//   fragment order lets the packed weights go from shared memory to
//   registers without ldmatrix or a swizzle;
// - split-K partials are summed in fixed split order by the last block of
//   each column group (deterministic; the group counters reset themselves).
//
// Hidden states are fp32 scratch [B, D]; x comes in as bf16 or fp32 [B, D]
// and the output goes out in the same type; pos is the engine's int64 [B];
// the encoder mask is bool [B, S] (false = -1e9 added, as the plain
// version), or null; the 1/sqrt(Dh) attention scale is folded into the q
// weights and biases; caches canonical [L, B, H, T, 64] bf16.
//
// The caches' element type is the template argument CT of step_kernel<WT,
// CT> and attn_item<CT> (Chunk<CT> below); this source instantiates bf16
// caches only.  The fp32-cache mode of the same Pallas kernel (self_dtype
// and cross_dtype from its caches: fp32 for the tiny and tiny-real engines)
// is csrc/tts_step_cluster.cu, designed for the tiny-real step it serves.
//
// int8-weight mode (the int8w branch of the same Pallas kernel,
// tts_decode_step_int8 below): every big matrix is int8 codes with an fp32
// scale per output channel.  The codes widen to bf16 exactly (|code| <= 127
// fits bf16's significand) as a lane loads its fragment; the products
// accumulate unscaled in fp32 (split-K partials too), and the block that
// finishes a column group applies y * scale[n] + bias[n] and then the
// activation, in the TPU kernel's order (tts_step.py:175-181).  The step
// then streams half the bytes.
//
// The grid barrier counts arrivals on one word that only grows within a
// launch; the last block to leave resets it, so neither a step nor a
// CUDA-graph replay needs a memset.  Data written inside the kernel by
// other blocks is read with ld.global.cg (L2), never through a possibly
// stale L1 line.
//
// TTS_ABLATE_GEMM and TTS_ABLATE_ATTN compile the products or the
// attention phases out, and TTS_ABLATE_COPY the weight copies (the products
// then read whatever the ring holds), for the timing experiments of
// ops/tts_step_ablate.py (wrong results, on purpose); TTS_TRACE makes
// thread 0 of every block write clock64() at the points of each phase
// into one more buffer (TRACE below).  ops/build.py never defines them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;       // threads per block
constexpr int NWARP = NT / 32;
constexpr int DH = 64;        // head dim
constexpr int MAXT = 4096;    // longest cache the score buffer holds
constexpr int MAXD = 4096;    // widest hidden state the final LN holds
constexpr int MAXB = 32;      // most slots
constexpr int TILE_ELEMS = 256;  // a 16 x 16 weight tile
constexpr int FIN_COLS = 128;    // most columns one item finishes (8 panels)
constexpr int MAX_SPLITS = 8;    // most K splits of a product
constexpr int SLOT_VEC = FIN_COLS * 4;  // a slot ends in the item's bias and scale
constexpr int HV = MAXB * FIN_COLS / NT;  // finished values a thread holds at most
constexpr float NEG_INF = -1e9f;
// the thread that starts the weight copies: one of warp 1, so that it can
// do so while thread 0 waits at the grid barrier
constexpr int COPIER = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
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

// ------------------------------------------------------- tensor-core product
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four int8 codes -> two pairs of bf16, exactly: code + 128 is a byte u in
// 1..255; placed in the low mantissa byte of 2^23 it reads as the float
// 2^23 + u, so one byte permute and one subtraction give the code in fp32
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

// y = act(acc * scale + bias): the int8 mode's per-output-channel scale
// first (null for bf16 weights), then the bias, then the activation.
__device__ __forceinline__ float finish(float s, int col, const float* __restrict__ scale,
                                        const float* __restrict__ bias, int gelu) {
  if (scale) s *= scale[col];  // both in shared memory: the item's columns
  s += bias[col];
  if (gelu) s = 0.5f * s * (1.f + erff(s * 0.70710678118654752f));
  return s;
}

// ------------------------------------------------- single-query attention
// One block of 8 warps per (slot b, head h).  Self mode (pos != nullptr):
// writes the new K/V row at p = min(pos[b], T - 1), then attends keys
// 0..p, so nothing past the slot's own position is read.  Cross mode:
// attends all T keys with the bool mask [B, T] (or none).  Pass 1 gives
// each thread one key (its 128-byte K row against q in shared memory) and
// keeps the scores in shared memory; the softmax is exact over them; pass 2
// gives each warp four keys at a time and each lane 16 bytes of a V row.
// Every load that does not need pos goes out first, together: each
// thread's first K row, each lane's first VPF V rows, the mask, q and the
// new row; so an item waits for memory about once and not once a pass.
// The rows loaded before the new row was written are patched from shared
// memory where they are that row.
// CT is the caches' element type (bf16 here).  A K row is DH * sizeof(CT)
// bytes (8 loads of 16 bytes a thread) and a lane's 8 dims of a V row one
// such load; the rows go from memory to registers, never through shared
// memory.
template <typename CT>
struct Chunk;  // 16 bytes of a cache row as floats, and back

template <>
struct Chunk<bf16> {
  static constexpr int N = 8;    // values in 16 bytes
  static constexpr int VPF = 8;  // V rows a lane loads ahead: keys < VPF * 32
  static __device__ __forceinline__ void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(p2[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  }
  // the chunk of a row stored as the fp32 values f (already bf16 values)
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
  static __device__ __forceinline__ bf16 store(float v) { return __float2bfloat16(v); }
  static __device__ __forceinline__ float load(bf16 v) { return __bfloat162float(v); }
};


struct AttnSmem {
  float qs[DH];
  float kn[DH];  // the new K and V rows as stored (cache values), self mode
  float vn[DH];
  float sc[MAXT];
  float sh[NWARP];
  float accs[NWARP][DH];
};

__device__ float block_sum(float v, float* sh) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) s += sh[w];
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
  for (int w = 1; w < NWARP; ++w) m = fmaxf(m, sh[w]);
  return m;
}

template <typename CT>
__device__ void attn_item(const float* q, int q_stride, const float* knew,
                          const float* vnew, int new_stride, CT* Kc,
                          CT* Vc, const long long* pos,
                          const uint8_t* mask, int H, int T, float* out,
                          int b, int h, AttnSmem& sm) {
  using C = Chunk<CT>;
  constexpr int KC = DH / C::N;  // 16-byte loads of a K row
  constexpr int VC = 8 / C::N;   // 16-byte loads of a lane's 8 dims of a V row
  constexpr int VPF = C::VPF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane >> 3, d8 = (lane & 7) * 8;
  __syncthreads();  // the block's previous item is done with sm
  const size_t cbase = ((size_t)b * H + h) * T * DH;
  CT* Kb = Kc + cbase;
  CT* Vb = Vc + cbase;

  uint4 kr[KC];
  if (tid < T) {
#pragma unroll
    for (int c = 0; c < KC; ++c)
      kr[c] = *reinterpret_cast<const uint4*>(Kb + (size_t)tid * DH + c * C::N);
  }
  uint4 vr[VPF][VC];
#pragma unroll
  for (int i = 0; i < VPF; ++i) {
    const int j = warp * 4 + sub + i * NWARP * 4;
    if (j < T) {
#pragma unroll
      for (int c = 0; c < VC; ++c)
        vr[i][c] = *reinterpret_cast<const uint4*>(Vb + (size_t)j * DH + d8 + c * C::N);
    }
  }
  const bool keep0 = mask == nullptr || tid >= T || mask[(size_t)b * T + tid];
  float qv = 0.f, kv = 0.f, vv = 0.f;
  if (tid < DH) {
    qv = __ldcg(q + (size_t)b * q_stride + h * DH + tid);
    if (pos != nullptr) {
      kv = __ldcg(knew + (size_t)b * new_stride + h * DH + tid);
      vv = __ldcg(vnew + (size_t)b * new_stride + h * DH + tid);
    }
  }
  const int last = pos != nullptr ? (int)min(pos[b], (long long)(T - 1)) : T - 1;
  if (tid < DH) {
    sm.qs[tid] = qv;
    if (pos != nullptr) {
      const CT kb = C::store(kv), vb = C::store(vv);
      Kb[(size_t)last * DH + tid] = kb;
      Vb[(size_t)last * DH + tid] = vb;
      sm.kn[tid] = C::load(kb);
      sm.vn[tid] = C::load(vb);
    }
  }
  __syncthreads();  // q and the new row staged; the row written is visible
  const int nk = last + 1;
  const int patch = pos != nullptr ? last : -1;  // the row loaded before it was written

  float mx = -INFINITY;
  for (int j = tid; j < nk; j += NT) {
    if (j != tid) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        kr[c] = *reinterpret_cast<const uint4*>(Kb + (size_t)j * DH + c * C::N);
    } else if (j == patch) {
#pragma unroll
      for (int c = 0; c < KC; ++c) kr[c] = C::pack(sm.kn + c * C::N);
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float f[C::N];
      C::unpack(kr[c], f);
#pragma unroll
      for (int e = 0; e < C::N; ++e) s = fmaf(sm.qs[c * C::N + e], f[e], s);
    }
    if (!(j == tid ? keep0 : mask == nullptr || mask[(size_t)b * T + j])) s += NEG_INF;
    sm.sc[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, sm.sh);
  float sum = 0.f;
  for (int j = tid; j < nk; j += NT) {
    const float p = expf(sm.sc[j] - mx);
    sm.sc[j] = p;
    sum += p;
  }
  sum = block_sum(sum, sm.sh);  // its barriers also publish sc

  float o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = 0.f;
  // a lane's 8 dims of one V row, from VC loads of 16 bytes
  auto acc_row = [&](float p, const uint4 (&raw)[VC]) {
#pragma unroll
    for (int c = 0; c < VC; ++c) {
      float f[C::N];
      C::unpack(raw[c], f);
#pragma unroll
      for (int e = 0; e < C::N; ++e) o[c * C::N + e] = fmaf(p, f[e], o[c * C::N + e]);
    }
  };
#pragma unroll
  for (int i = 0; i < VPF; ++i) {
    const int j = warp * 4 + sub + i * NWARP * 4;
    if (j < nk) {
      if (j == patch) {
        uint4 pr[VC];
#pragma unroll
        for (int c = 0; c < VC; ++c) pr[c] = C::pack(sm.vn + d8 + c * C::N);
        acc_row(sm.sc[j], pr);
      } else {
        acc_row(sm.sc[j], vr[i]);
      }
    }
  }
#pragma unroll 4
  for (int j = warp * 4 + sub + VPF * NWARP * 4; j < nk; j += NWARP * 4) {
    uint4 raw[VC];
#pragma unroll
    for (int c = 0; c < VC; ++c)
      raw[c] = *reinterpret_cast<const uint4*>(Vb + (size_t)j * DH + d8 + c * C::N);
    acc_row(sm.sc[j], raw);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    o[e] += __shfl_xor_sync(0xffffffffu, o[e], 8);
    o[e] += __shfl_xor_sync(0xffffffffu, o[e], 16);
  }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sm.accs[warp][d8 + e] = o[e];
  }
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) o += sm.accs[w][tid];
    out[(size_t)b * H * DH + h * DH + tid] = o / sum;
  }
}

// ------------------------------------------ last residual + LayerNorm
// out[row] = LN(h[row] + t[row]) * g + b in the output's type.
struct LnSmem {
  float buf[MAXD];
  float sh[NWARP];
};

__device__ void ln_out_row(const float* h, const float* t, const float* g,
                           const float* bta, void* out, int out_bf16, int row,
                           int D, float eps, LnSmem& sm) {
  __syncthreads();
  const float* hr = h + (size_t)row * D;
  const float* tr = t + (size_t)row * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += NT) {
    const float v = __ldcg(hr + i) + __ldcg(tr + i);
    sm.buf[i] = v;
    s += v;
  }
  const float mu = block_sum(s, sm.sh) / D;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += NT) {
    const float c = sm.buf[i] - mu;
    s2 += c * c;
  }
  const float rstd = rsqrtf(block_sum(s2, sm.sh) / D + eps);
  for (int i = threadIdx.x; i < D; i += NT) {
    const float v = (sm.buf[i] - mu) * rstd * g[i] + bta[i];
    if (out_bf16)
      static_cast<bf16*>(out)[(size_t)row * D + i] = __float2bfloat16(v);
    else
      static_cast<float*>(out)[(size_t)row * D + i] = v;
  }
}

// ------------------------------------------------------------ grid barrier
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// after a __syncthreads: publishes the block's writes with one gpu-scope
// release (as cooperative groups' grid sync, by one thread)
__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned atom_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// bar[1] counts the blocks that have passed the last barrier; the last of
// them resets both words for the next launch
__device__ __forceinline__ void grid_exit(unsigned* bar) {
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    atomicExch(bar, 0u);
    atomicExch(bar + 1, 0u);
  }
}

// ------------------------------------------------------------- the kernel
enum { G_QKV, G_SO, G_CQ, G_CO, G_W1, G_W2, N_GEMMS };

struct GemmPlan {
  int G, splits;  // panels of 16 columns per item, K splits
};

struct Params {
  const void* x;          // [B, D] step input, bf16 or fp32
  void* out;              // [B, D] hidden state out, x's type
  const long long* pos;   // [B] int64
  const uint8_t* mask;    // [B, S] bool, or null
  const void* w[N_GEMMS];      // panels [L, N/16, K/16, 256], bf16 or int8 codes
  const float* bias[N_GEMMS];  // [L, N]
  const float* scale[N_GEMMS]; // [L, N] (int8) or null
  const float* ln[6];          // ln1g, ln1b, ln2g, ln2b, ln3g, ln3b [L, D]
  void* self_k;  // the caches, CT of step_kernel<WT, CT>
  void* self_v;
  void* cross_k;
  void* cross_v;
  float* hbuf;   // [2, B, D] residual, ping-pong
  float* y;      // [B, 3D] qkv or cross q
  float* a;      // [B, D] attention output
  float* t;      // [B, D] sublayer output before the residual add
  float* mid;    // [B, F]
  float* part;   // split-K partials [splits, B, N]
  float* stats;  // [groups, B, 2] sums of h + t and of its square
  int* counters; // one per column group, zero between products
  unsigned* bar; // grid barrier: arrivals, exits
  long long* trace;  // TTS_TRACE builds: [grid, 8 L + 1, 8] clock64()
  int L, B, H, T, S, F, x_bf16;
  int Bc;  // slots of the caches' layer: x's B slots start at the caches' pointers
  float eps;
  GemmPlan plan[N_GEMMS];
  int groups[N_GEMMS], items[N_GEMMS], prefix[N_GEMMS], per_layer;
  int nslot, slot_bytes, xs_stride, work_bytes;
};

// Where a GEMM's x rows come from.  Either the step input (xin, bf16 or
// fp32), or a = rows written earlier in this step, plus t before a
// LayerNorm with (g, b) when g is set, whose row sums are in stats
// (ngroups column groups).  hnew, when set, receives the rows as staged
// (the new residual) from the items of column group 0.
struct XSrc {
  const float* a;
  const float* t;
  const float* g;
  const float* b;
  const float* stats;
  int ngroups;
  const void* xin;
  int xin_bf16;
  float* hnew;
  float eps;
};

// A block's view of its shared memory and of its weight ring.
struct Ctx {
  uint8_t* ring;      // nslot slots of slot_bytes
  uint32_t ring_s;    // the same, as a shared-window address
  uint8_t* work;      // xs + red + fin, or attention, or LN scratch
  bf16* xs;           // [bpad][xs_stride] bf16 rows of x for one item
  float* red;         // [NWARP][bpad][16] per-warp products
  float* fin;         // [bpad][FIN_COLS] finished h + t of one item
  uint32_t mbar_s;    // nslot mbarriers
  float* mu;          // [MAXB]
  float* rstd;        // [MAXB]
  int* flag;
  int bpad;
  unsigned nbar;      // barriers passed: the index of the current phase
  int consumed;       // items whose slot was used and freed (all threads)
  int started;        // items whose copies were started (COPIER)
  int next_gi;        // next product to look at for copies (COPIER)
};

// TRACE(c, k): point k (0 start, 1 x staged, 2 weights in, 3 products,
// 4 own sums or partials out, 5 split sums, 6 LN sums, 7 end) of the
// current phase
#ifdef TTS_TRACE
#define TRACE(c, k)                                                           \
  do {                                                                        \
    if (threadIdx.x == 0)                                                     \
      p.trace[((size_t)blockIdx.x * (8 * p.L + 1) + (c).nbar) * 8 + (k)] = clock64(); \
  } while (0)
#else
#define TRACE(c, k) \
  do {              \
  } while (0)
#endif

__host__ __device__ __forceinline__ void gemm_kn(const Params& p, int g, int& K, int& N) {
  const int D = p.H * DH;
  K = g == G_W2 ? p.F : D;
  N = g == G_QKV ? 3 * D : (g == G_W1 ? p.F : D);
}

// this block's item of product gi (= 6 * layer + kind), or -1: the items of
// product gi start at block (items of all products before it) mod grid
__device__ __forceinline__ int item_of(const Params& p, int gi) {
#ifdef TTS_ABLATE_GEMM
  return -1;
#endif
  const int g = gi % N_GEMMS, l = gi / N_GEMMS;
  const int n = (int)gridDim.x;
  const int rot = (l * p.per_layer + p.prefix[g]) % n;
  const int it = ((int)blockIdx.x - rot + n) % n;
  return it < p.items[g] ? it : -1;
}

// COPIER: start the copies of item `item` of product gi into the next slot
template <typename WT>
__device__ void start_copies(const Params& p, Ctx& c, int gi, int item) {
  const int g = gi % N_GEMMS, l = gi / N_GEMMS;
  int K, N;
  gemm_kn(p, g, K, N);
  const int P = N / 16, KT = K / 16, G = p.plan[g].G, splits = p.plan[g].splits;
  const int pg = item / splits, s = item % splits;
  const int kt0 = s * KT / splits, kt1 = (s + 1) * KT / splits;
  const int np = min(G, P - pg * G);
  const uint32_t bytes = (uint32_t)(kt1 - kt0) * TILE_ELEMS * sizeof(WT);
  const uint32_t vec = np * 16 * 4;  // bias (and scale) of the item's columns
  const int slot = c.started % p.nslot;
  const uint32_t mbar = c.mbar_s + slot * 8;
  const uint32_t dst = c.ring_s + slot * p.slot_bytes;
  const WT* src = static_cast<const WT*>(p.w[g]) + (size_t)l * K * N +
                  ((size_t)pg * G * KT + kt0) * TILE_ELEMS;
  const size_t col0 = (size_t)l * N + pg * G * 16;
  mbar_expect_tx(mbar, bytes * np + vec * (p.scale[g] ? 2 : 1));
  for (int j = 0; j < np; ++j)
    bulk_g2s(dst + j * bytes, src + (size_t)j * KT * TILE_ELEMS, bytes, mbar);
  bulk_g2s(dst + p.slot_bytes - 2 * SLOT_VEC, p.bias[g] + col0, vec, mbar);
  if (p.scale[g]) bulk_g2s(dst + p.slot_bytes - SLOT_VEC, p.scale[g] + col0, vec, mbar);
  ++c.started;
}

// COPIER: keep every free slot filled with the block's next items
template <typename WT>
__device__ void top_up(const Params& p, Ctx& c) {
#ifdef TTS_ABLATE_COPY
  return;
#endif
  const int total = p.L * N_GEMMS;
  while (c.started - c.consumed < p.nslot && c.next_gi < total) {
    const int it = item_of(p, c.next_gi);
    if (it >= 0) start_copies<WT>(p, c, c.next_gi, it);
    ++c.next_gi;
  }
}

// Barrier number c.nbar + 1 of the launch: bar[0] only grows, so it is
// passed when bar[0] reaches (c.nbar + 1) * gridDim.x.  Safe only when
// every block of the grid is resident: the launch is cooperative.  While
// thread 0 arrives and waits, COPIER refills the slots freed since the last
// barrier: starting the copies (about 1 us) then overlaps the wait instead
// of delaying the block's arrival.
template <typename WT>
__device__ __forceinline__ void grid_sync(const Params& p, Ctx& c) {
  TRACE(c, 7);
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release(p.bar, 1u);
    const unsigned target = (c.nbar + 1) * gridDim.x;
    while (ld_acquire(p.bar) < target) {
    }
  } else if (threadIdx.x == COPIER) {
    top_up<WT>(p, c);
  }
  __syncthreads();
  ++c.nbar;
  TRACE(c, 0);
}

// This block's item of product gi: y[B, N] = act((x @ w) * scale + bias)
// for G panels of columns, over one split of K.  With stats_h the rows of
// h + y that the block finishes are summed for the next LayerNorm.
template <typename WT>
__device__ void gemm(const Params& p, Ctx& c, int gi, const XSrc& src, float* y, int gelu,
                     const float* stats_h) {
  const int item = item_of(p, gi);
  if (item < 0) return;
  const int g = gi % N_GEMMS, l = gi / N_GEMMS;
  int K, N;
  gemm_kn(p, g, K, N);
  const int P = N / 16, KT = K / 16, G = p.plan[g].G, splits = p.plan[g].splits;
  const int pg = item / splits, s = item % splits;
  const int kt0 = s * KT / splits, kt1 = (s + 1) * KT / splits;
  const int nkt = kt1 - kt0, nk = nkt * 16, k0 = kt0 * 16;
  const int np = min(G, P - pg * G), NC = np * 16, col0 = pg * G * 16;
  const int B = p.B, bpad = c.bpad, stride = p.xs_stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. x rows of this item's K range, in bf16.  Every load goes out before
  // any is used: the producer's LayerNorm sums of each row (a warp a row,
  // lanes over the column groups) and XB groups of four columns a thread
  // (x, or a + t, and the LN parameters); one wait for L2, then the
  // statistics, one __syncthreads, and the normalised rows.
  constexpr int XB = 6;
  constexpr int RW = MAXB / NWARP;  // rows a warp sums
  constexpr int QG = 5;             // column groups a lane sums (up to 160)
  const int nk4 = nk / 4, n4 = bpad * nk4;
  float s1[RW], s2[RW];
  if (src.g) {  // unrolled and guarded, so these loads go out with the rest
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      s1[r] = s2[r] = 0.f;
      const int b = warp + r * NWARP;
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        const int q = lane + 32 * j;
        if (b < B && q < src.ngroups) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(src.stats) + q * B + b);
          s1[r] += v.x;
          s2[r] += v.y;
        }
      }
    }
  }
  for (int base = 0; base < n4; base += XB * NT) {  // the same trips for every thread
    float4 v[XB], gg[XB], bb[XB];
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int i = base + u * NT + tid, b = i / nk4, k = k0 + (i - b * nk4) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n4 && b < B) {
        const size_t off = (size_t)b * K + k;
        if (src.xin && src.xin_bf16) {
          const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(src.xin) + off);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          v[u] = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else if (src.xin) {
          v[u] = *reinterpret_cast<const float4*>(static_cast<const float*>(src.xin) + off);
        } else {
          v[u] = __ldcg(reinterpret_cast<const float4*>(src.a + off));
          if (src.t) {
            const float4 w = __ldcg(reinterpret_cast<const float4*>(src.t + off));
            v[u].x += w.x;
            v[u].y += w.y;
            v[u].z += w.z;
            v[u].w += w.w;
          }
        }
        if (src.g) {
          gg[u] = *reinterpret_cast<const float4*>(src.g + k);
          bb[u] = *reinterpret_cast<const float4*>(src.b + k);
        }
      }
    }
    if (src.g && base == 0) {  // the statistics, once, while the loads fly
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int b = warp + r * NWARP;
        const float t1 = warp_sum(s1[r]), t2 = warp_sum(s2[r]);
        if (lane == 0 && b < B) {
          const float mu = t1 / K;
          c.mu[b] = mu;
          c.rstd[b] = rsqrtf(fmaxf(t2 / K - mu * mu, 0.f) + src.eps);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int i = base + u * NT + tid, b = i / nk4, cc = (i - b * nk4) * 4, k = k0 + cc;
      if (i >= n4) break;
      float4 x = v[u];
      if (b < B && src.g) {
        const float mu = c.mu[b], rs = c.rstd[b];
        x = make_float4((x.x - mu) * rs * gg[u].x + bb[u].x, (x.y - mu) * rs * gg[u].y + bb[u].y,
                        (x.z - mu) * rs * gg[u].z + bb[u].z, (x.w - mu) * rs * gg[u].w + bb[u].w);
      }
      if (b < B && src.hnew && pg == 0)
        *reinterpret_cast<float4*>(src.hnew + (size_t)b * K + k) = x;
      *reinterpret_cast<uint2*>(c.xs + b * stride + cc) = make_uint2(pack2(x.x, x.y), pack2(x.z, x.w));
    }
  }
  TRACE(c, 1);
  // 2. this item's weights, copied in ahead
  const int slot = c.consumed % p.nslot;
#ifndef TTS_ABLATE_COPY
  mbar_wait(c.mbar_s + slot * 8, (c.consumed / p.nslot) & 1);
#endif
  __syncthreads();

  TRACE(c, 2);
  // 3. products: warp = q * G + mi takes panel mi over row range q of Q
  const int Q = NWARP / G, mi = warp % G, q = warp / G;
  const int gq = lane >> 2, t4 = lane & 3;
  if (mi < np) {
    float acc[MAXB / 8][4];
#pragma unroll
    for (int nt = 0; nt < MAXB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    const int t0 = q * nkt / Q, t1 = (q + 1) * nkt / Q;
    const WT* tile = reinterpret_cast<const WT*>(c.ring + slot * p.slot_bytes) +
                     ((size_t)mi * nkt + t0) * TILE_ELEMS;
    const bf16* xk = c.xs + gq * stride + 2 * t4;
#pragma unroll 2
    for (int kt = t0; kt < t1; ++kt, tile += TILE_ELEMS) {
      uint32_t a[4];
      load_frag(tile, lane, a);
#pragma unroll
      for (int nt = 0; nt < MAXB / 8; ++nt) {
        if (nt * 8 < bpad) {
          const bf16* xr = xk + nt * 8 * stride + kt * 16;
          mma16816(acc[nt], a, *reinterpret_cast<const uint32_t*>(xr),
                   *reinterpret_cast<const uint32_t*>(xr + 8));
        }
      }
    }
    // acc[nt]: columns gq and gq + 8 of the panel, slots nt*8 + 2t4 (+1)
    float* r = c.red + (size_t)warp * bpad * 16;
#pragma unroll
    for (int nt = 0; nt < MAXB / 8; ++nt) {
      if (nt * 8 < bpad) {
        const int n0 = nt * 8 + 2 * t4;
        r[n0 * 16 + gq] = acc[nt][0];
        r[(n0 + 1) * 16 + gq] = acc[nt][1];
        r[n0 * 16 + gq + 8] = acc[nt][2];
        r[(n0 + 1) * 16 + gq + 8] = acc[nt][3];
      }
    }
  }
  __syncthreads();

  TRACE(c, 3);
  // 4. the block's sums over its row ranges; with splits, the last block of
  // the column group adds the partials in split order
  const uint8_t* slot_end = c.ring + (slot + 1) * p.slot_bytes;
  const float* sbias = reinterpret_cast<const float*>(slot_end - 2 * SLOT_VEC) - col0;
  const float* sscale =
      p.scale[g] ? reinterpret_cast<const float*>(slot_end - SLOT_VEC) - col0 : nullptr;
  auto own = [&](int b, int cc) {
    const int m = cc & 15, w0 = cc >> 4;
    float v = 0.f;
    for (int qq = 0; qq < Q; ++qq) v += c.red[((size_t)(qq * G + w0) * bpad + b) * 16 + m];
    return v;
  };
  auto store = [&](int b, int cc, float v) {
    const int col = col0 + cc;
    v = finish(v, col, sscale, sbias, gelu);
    y[(size_t)b * N + col] = v;
    if (stats_h) c.fin[b * FIN_COLS + cc] = v + __ldcg(stats_h + (size_t)b * N + col);
  };
  bool done = true;
  if (splits == 1) {
    for (int u = 0; u < HV; ++u) {
      const int i = tid + u * NT;
      if (i < B * NC) store(i / NC, i % NC, own(i / NC, i % NC));
    }
  } else {
    for (int i = tid; i < B * NC; i += NT) {
      const int b = i / NC, cc = i % NC;
      p.part[((size_t)s * B + b) * N + col0 + cc] = own(b, cc);
    }
    __syncthreads();
    if (tid == 0)
      *c.flag = atom_acq_rel(reinterpret_cast<unsigned*>(p.counters + pg), 1u) == splits - 1;
    __syncthreads();
    TRACE(c, 4);
    done = *c.flag;
    if (done) {
      // the partials of SU elements all out before any is added; each
      // element's are added in split order
      constexpr int SU = 4;
      const size_t zs = (size_t)B * N;
      for (int u0 = 0; u0 < HV && tid + u0 * NT < B * NC; u0 += SU) {
        float pv[SU][MAX_SPLITS];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int i = tid + (u0 + u) * NT;
          const float* pp = p.part + (size_t)(i / NC) * N + col0 + i % NC;
#pragma unroll
          for (int z = 0; z < MAX_SPLITS; ++z)
            pv[u][z] = i < B * NC && z < splits ? __ldcg(pp + z * zs) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int i = tid + (u0 + u) * NT;
          float v = 0.f;
#pragma unroll
          for (int z = 0; z < MAX_SPLITS; ++z)
            if (z < splits) v += pv[u][z];
          if (i < B * NC) store(i / NC, i % NC, v);
        }
      }
      if (tid == 0) p.counters[pg] = 0;  // ready for the next product
    }
  }
  TRACE(c, 5);
  if (stats_h && done) {  // row sums of h + y over this group's columns
    __syncthreads();
    for (int b = warp; b < B; b += NWARP) {
      float s1 = 0.f, s2 = 0.f;
      for (int cc = lane; cc < NC; cc += 32) {
        const float v = c.fin[b * FIN_COLS + cc];
        s1 += v;
        s2 += v * v;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        p.stats[(pg * B + b) * 2] = s1;
        p.stats[(pg * B + b) * 2 + 1] = s2;
      }
    }
  }

  TRACE(c, 6);
  // 5. the slot is free: the next grid barrier refills it
  __syncthreads();
  ++c.consumed;
}

template <typename WT, typename CT>
__global__ void __launch_bounds__(NT, 1) step_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int D = p.H * DH, B = p.B, H = p.H;
  const size_t self_l = (size_t)p.Bc * H * p.T * DH, cross_l = (size_t)p.Bc * H * p.S * DH;

  Ctx c;
  c.ring = smem;
  c.ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  c.work = smem + p.nslot * p.slot_bytes;
  c.bpad = (B + 7) / 8 * 8;
  c.xs = reinterpret_cast<bf16*>(c.work);
  c.red = reinterpret_cast<float*>(c.work + (c.bpad * p.xs_stride * 2 + 15) / 16 * 16);
  c.fin = c.red + NWARP * c.bpad * 16;
  uint8_t* small = c.work + p.work_bytes;
  c.mbar_s = static_cast<uint32_t>(__cvta_generic_to_shared(small));
  c.mu = reinterpret_cast<float*>(small + 8 * 8);
  c.rstd = c.mu + MAXB;
  c.flag = reinterpret_cast<int*>(c.rstd + MAXB);
  c.consumed = c.started = c.next_gi = 0;
  c.nbar = 0;
#ifdef TTS_TRACE
  long long t_start = 0, g_start = 0;
  if (threadIdx.x == 0) {
    t_start = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start));
  }
#endif
  TRACE(c, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.nslot; ++i) mbar_init(c.mbar_s + i * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == COPIER) top_up<WT>(p, c);
  AttnSmem& as = *reinterpret_cast<AttnSmem*>(c.work);

  auto LN = [&](int k, int l) { return p.ln[k] + (size_t)l * D; };
  float* hb[2] = {p.hbuf, p.hbuf + (size_t)B * D};
  int cur = 0;  // which residual buffer holds h
  auto plain = [](const float* a) {
    XSrc s{};
    s.a = a;
    return s;
  };
  // LN(h + t) with layer l's parameters k (g) and k + 1 (b), from the sums
  // of product g_sums; the new h goes to the other buffer
  auto normed = [&](int k, int l, int g_sums) {
    XSrc s{};
    s.a = hb[cur];
    s.t = p.t;
    s.g = LN(k, l);
    s.b = LN(k + 1, l);
    s.stats = p.stats;
    s.ngroups = p.groups[g_sums];
    s.hnew = hb[cur ^ 1];
    s.eps = p.eps;
    cur ^= 1;
    return s;
  };

  // One loop over the 8 L phases, one call site of gemm and one of
  // attn_item: the phases share their code, which then stays in the SM's
  // instruction cache (a copy per phase made the kernel ~180k instructions
  // and every phase started on code fetched from L2).
  for (int ph = 0; ph < 8 * p.L; ++ph) {
    const int l = ph / 8, kind = ph % 8;
    const int g = kind == 0 ? G_QKV : kind == 2 ? G_SO : kind == 3 ? G_CQ
                : kind == 5 ? G_CO : kind == 6 ? G_W1 : kind == 7 ? G_W2 : -1;
    if (g >= 0) {
      XSrc s{};
      float* y = g == G_W1 ? p.mid : (g == G_QKV || g == G_CQ ? p.y : p.t);
      const float* stats_h = nullptr;
      if (g == G_QKV && l == 0) {
        s.xin = p.x;
        s.xin_bf16 = p.x_bf16;
        s.hnew = hb[0];
      } else if (g == G_QKV) {
        s = normed(4, l - 1, G_W2);  // LN3 of the layer before
      } else if (g == G_CQ) {
        s = normed(0, l, G_SO);  // LN1
      } else if (g == G_W1) {
        s = normed(2, l, G_CO);  // LN2
      } else {  // an output projection: its rows are summed for the next LN
        s = plain(g == G_W2 ? p.mid : p.a);
        stats_h = hb[cur];
      }
      gemm<WT>(p, c, l * N_GEMMS + g, s, y, g == G_W1, stats_h);
    } else {
#ifndef TTS_ABLATE_ATTN
      const bool self = kind == 1;
      const size_t off = l * (self ? self_l : cross_l);
      for (int it = blockIdx.x; it < B * H; it += gridDim.x)
        attn_item<CT>(p.y, self ? 3 * D : D, self ? p.y + D : nullptr, self ? p.y + 2 * D : nullptr,
                      3 * D, static_cast<CT*>(self ? p.self_k : p.cross_k) + off,
                      static_cast<CT*>(self ? p.self_v : p.cross_v) + off, self ? p.pos : nullptr,
                      self ? nullptr : p.mask, H, self ? p.T : p.S, p.a, it / H, it % H, as);
#endif
    }
    grid_sync<WT>(p, c);
  }
  for (int r = blockIdx.x; r < B; r += gridDim.x)
    ln_out_row(hb[cur], p.t, LN(4, p.L - 1), LN(5, p.L - 1), p.out, p.x_bf16, r, D, p.eps,
               *reinterpret_cast<LnSmem*>(c.work));
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
  grid_exit(p.bar);
}

// ptrs: x, out, pos, mask, then the 6 weights, 6 biases, 6 scales (null in
// bf16 mode), 6 LN parameters, self_k, self_v, cross_k, cross_v, hbuf, y, a,
// t, mid, part, stats, counters, bar.  dims: L, B, H, T, S, F, x_bf16, Bc (the
// caches hold Bc slots a layer; the B slots of this step start at their
// pointers, so a group of slots runs on a slot slice of larger caches).
// plan: (G, splits) per GEMM in the order qkv, so, cq, co, w1, w2, then
// nslot, slot_bytes, xs_stride, work_bytes, smem_bytes (ops/tts_step.py
// step_plan); grid: blocks, all resident.
template <typename WT, typename CT>
int launch(const void* const* ptrs, const int* dims, const int* plan, float eps, int grid,
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
  p.self_k = const_cast<void*>(ptrs[i++]);
  p.self_v = const_cast<void*>(ptrs[i++]);
  p.cross_k = const_cast<void*>(ptrs[i++]);
  p.cross_v = const_cast<void*>(ptrs[i++]);
  p.hbuf = (float*)ptrs[i++];
  p.y = (float*)ptrs[i++];
  p.a = (float*)ptrs[i++];
  p.t = (float*)ptrs[i++];
  p.mid = (float*)ptrs[i++];
  p.part = (float*)ptrs[i++];
  p.stats = (float*)ptrs[i++];
  p.counters = (int*)ptrs[i++];
  p.bar = (unsigned*)ptrs[i++];
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
  const int D = p.H * DH;
  if (p.B < 1 || p.B > MAXB || p.Bc < p.B || D > MAXD || p.F % 16 || p.T > MAXT || p.S > MAXT)
    return (int)cudaErrorInvalidValue;
  p.per_layer = 0;
  for (int g = 0; g < N_GEMMS; ++g) {
    int K, N;
    gemm_kn(p, g, K, N);
    p.plan[g] = GemmPlan{plan[2 * g], plan[2 * g + 1]};
    const int G = p.plan[g].G, splits = p.plan[g].splits;
    if ((G != 1 && G != 2 && G != 4 && G != 8) || splits < 1 || splits > K / 16 ||
        splits > MAX_SPLITS)
      return (int)cudaErrorInvalidValue;
    p.groups[g] = (N / 16 + G - 1) / G;
    p.items[g] = p.groups[g] * splits;
    if (p.items[g] > grid) return (int)cudaErrorInvalidValue;
    p.prefix[g] = p.per_layer;
    p.per_layer += p.items[g];
  }
  p.nslot = plan[12];
  p.slot_bytes = plan[13];
  p.xs_stride = plan[14];
  p.work_bytes = plan[15];
  const int smem_bytes = plan[16];
  if (p.nslot < 1 || p.nslot > 8 || p.slot_bytes % 128) return (int)cudaErrorInvalidValue;

  // more than 48 KB of dynamic shared memory has to be asked for; the
  // cooperative launch fails unless the grid is resident at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(step_kernel<WT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, step_kernel<WT, CT>, NT,
                                                      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (grid < 1 || grid > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;  // all blocks resident: the barrier's premise
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, step_kernel<WT, CT>, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

namespace {
// int8 weight codes need one fp32 scale per output channel and matrix
bool have_scales(const void* const* ptrs) {
  for (int g = 0; g < N_GEMMS; ++g)
    if (!ptrs[16 + g]) return false;
  return true;
}
}  // namespace

// One decoder step through all L layers: one cooperative launch.  bf16
// weights over bf16 caches.
extern "C" int tts_decode_step(const void* const* ptrs, const int* dims, const int* plan,
                               float eps, int grid, void* stream) {
  return launch<bf16, bf16>(ptrs, dims, plan, eps, grid, stream);
}

// int8 weight codes with one fp32 scale per output channel and matrix.
extern "C" int tts_decode_step_int8(const void* const* ptrs, const int* dims, const int* plan,
                                    float eps, int grid, void* stream) {
  if (!have_scales(ptrs)) return (int)cudaErrorInvalidValue;
  return launch<int8_t, bf16>(ptrs, dims, plan, eps, grid, stream);
}
