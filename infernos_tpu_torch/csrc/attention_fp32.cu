// Encoder self-attention forward for Hopper (sm_90a), fp32 mode: fp32 q,
// k, v in and an fp32 output, every product a full fp32 FFMA on the CUDA
// cores (TF32 keeps about three digits and is no fp32 mode).
//
// Replaces infernos_tpu/ops/attention.py::_attn_kernel (the pallas_call in
// _pallas_attention) in the dtype the tiny and tiny-real encoders, the
// trainers and the dry run run it in on the TPU, where the kernel takes its
// dtype from q.  It computes softmax(q k^T / sqrt(64) + mask_add) v per
// (batch, head), with an optional additive fp32 key mask [B, S] (one row
// per batch element, shared by its heads; null means none).  Heads are read
// and written where they lie, through (batch, head, row) element strides.
// The bf16 mode is csrc/attention.cu.
//
// Bound on an H100 SXM: 4 * S^2 * 64 operations a head at the 67 TFLOP/s
// of fp32 outside the tensor cores: 0.17 ms at whisper-large-v3's
// [20, 1500, 64], compute-bound.  The main path runs far smaller calls: a
// tiny-real encode [4|8, 100|250, 64] (0.15 to 1.9 us of operations), a
// tiny STT trainer step [32, 250, 64] (7.6 us).  There a grid of one block
// per 64 q rows holds 8 to 32 blocks for 132 SMs, and each block walks
// every key tile in turn.
//
// What bounds the products on the card is each SM's shared-memory reads,
// not its FMAs: a warp's 16-byte read costs four wavefronts whatever lanes
// it broadcasts to, one wavefront a cycle an SM, against four warp FFMAs a
// cycle.  A thread whose register tile is Rr rows by Rk keys (or dims)
// reads (Rr + Rk) / (Rr Rk) wavefronts per FFMA; at 4 x 8 that is 0.375,
// 1.5x the FFMA time, and it matches the products' share measured at
// [20, 1500] (ops/attention_ablate.py --fp32).  8 x 8 would be FFMA-bound
// but leaves a 64 x 64 tile two warps and measured slower.
//
// Design (the launch plan is ops/attention.py fp32_plan, handed in as ints):
// - a block of 128 threads is 128 / X row groups of X threads and owns
//   `rows` q rows of one (batch, head); thread (ty, tx) owns rows ty + G i,
//   of a 64-key tile keys tx + X j for the scores and of the output dims
//   4 tx + 4 X c.  Three shapes: 64 rows, 8 threads a row (4 x 8 tiles,
//   the large calls); 32 and 16 rows, 16 a row (4 x 4 and 2 x 4 tiles:
//   more blocks for the small calls).  Blocks of 256 threads measured
//   slower in every plan;
// - where q tiles alone leave the card idle, a thread-block cluster of
//   `split` (2, 4 or 8) blocks shares one q tile and splits its key tiles
//   into contiguous ranges, none empty.  Each block runs the online softmax
//   over its range and keeps its rows' (m, l, O).  Then every block pushes
//   its partials of the rows block r finishes (rows [r R, (r + 1) R),
//   R = rows / split) into block r's shared memory (mapa +
//   st.shared::cluster), the cluster meets at one barrier (arrive.release /
//   wait.acquire), and block r merges
//     O = sum_i 2^(m_i - M) O_i / sum_i 2^(m_i - M) l_i,  M = max_i m_i,
//   a block whose m_i is -inf left out (a range with no real key; the plan
//   gives no block an empty range, so none has, but the merge does not
//   count on it).  No second kernel, no scratch in device memory, no
//   atomics.  An arrival at the kernel's start, waited for before the first
//   push, makes sure every block of the cluster is running before its
//   memory is written;
// - the plan aims at about one block an SM: more share an SM's reads and
//   add loads and merging, and a cluster of 4 or 8 merges dearer than one
//   of 2;
// - Q and K rows lie in shared memory with a stride of 68 floats, so the
//   float4 reads of a warp's rows (keys) hit distinct banks; V rows keep
//   their 64.  P goes from the threads of the scores to those of the
//   output through shared memory in rows of 64 + X floats (bank X ty + tx:
//   no conflict).  The X threads of a row are lanes of one warp, so a
//   __syncwarp hands P over: one __syncthreads a tile, the stage's;
// - K/V tiles by 16-byte cp.async, two stages where a block has two tiles
//   or more, the next tile's copy started right after the barrier; keys >= S
//   are zero-filled and get -inf from the mask row (the mask's own -1e9 is
//   finite and stays so); rows >= S are computed on zero Q, never stored;
// - the softmax is exact fp32 in base 2 (log2(e) folded into the scale and
//   the mask): a row's max over a tile by log2(X) shuffles among its X
//   threads, O and the row sum rescaled whenever the max moves.
//
// The ATTN_FP32_ABLATE_* switches compile parts out for the timing
// experiments of ops/attention_ablate.py --fp32 (wrong results, on
// purpose); ops/build.py never defines them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;        // head dim, compile-time
constexpr int KT = 64;        // keys per staged tile
constexpr int NT = 128;       // threads per block
constexpr int LD = DH + 4;    // row of Q, K and a pushed partial (floats)
constexpr int K_FLOATS = KT * LD;
constexpr int V_FLOATS = KT * DH;
constexpr int STAGE_FLOATS = K_FLOATS + V_FLOATS + KT;  // K, V, mask row
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // in elements
  long long b, h, r;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;
  float* o;
  Strides sq, sk, sv, so;
  int H, S;
  float scale_log2;
  int split, off_p, off_stage, off_recv;  // offsets in bytes
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier in two halves
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of this block's shared `local` in block `rank` of the cluster
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

__device__ __forceinline__ void st_peer(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

__device__ __forceinline__ float ex2(float x) {
#ifdef ATTN_FP32_ABLATE_EXP
  return fmaf(x, 1e-3f, 1.f);
#else
  return exp2f(x);
#endif
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void axpy4(float p, const float4 v, float* o) {
  o[0] = fmaf(p, v.x, o[0]);
  o[1] = fmaf(p, v.y, o[1]);
  o[2] = fmaf(p, v.z, o[2]);
  o[3] = fmaf(p, v.w, o[3]);
}

// G = NT / X row groups of X threads.  Thread (ty, tx) owns rows ty + G i
// (i < RI) of the block's q tile; of each 64-key tile, keys tx + X j
// (j < 64 / X) for the scores; of the output, dims 4 tx + 4 X c (64 / X dims)
template <int X, int RI>
__global__ void __launch_bounds__(NT, (RI * (KT / X) >= 32) ? 2 : 4)
    attn_fp32_kernel(const Params p) {
  constexpr int G = NT / X;        // row groups
  constexpr int BQ = G * RI;       // q rows of the block
  constexpr int KJ = KT / X;       // keys (and dims) of a thread
  constexpr int DC = DH / 4 / X;   // its float4 chunks of a V or O row
  constexpr int LDP = DH + X;      // P row (floats): bank X ty + tx
  extern __shared__ float4 smem_f4[];
  char* smem = reinterpret_cast<char*>(smem_f4);
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = reinterpret_cast<float*>(smem + p.off_p);
  float* stages = reinterpret_cast<float*>(smem + p.off_stage);
  float* recv = reinterpret_cast<float*>(smem + p.off_recv);
  const uint32_t stages_s = static_cast<uint32_t>(__cvta_generic_to_shared(stages));

  const int S = p.S, split = p.split;
  const int rank = split > 1 ? (int)cluster_rank() : 0;
#ifndef ATTN_FP32_ABLATE_MERGE
  // waited for before the first push: every block of the cluster runs
  if (split > 1) cluster_arrive_relaxed();
#endif
  const int pair = blockIdx.x / split;
  const int n_qt = (S + BQ - 1) / BQ, n_kt = (S + KT - 1) / KT;
  const int bh = pair / n_qt, q0 = (pair % n_qt) * BQ;
  const int b = bh / p.H, h = bh % p.H;
  const int t0 = rank * n_kt / split, t1 = (rank + 1) * n_kt / split;
  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;
  const float* mb = p.mask ? p.mask + (size_t)b * S : nullptr;
  const int tid = threadIdx.x, ty = tid / X, tx = tid % X;

  // a tile of 64 rows is 1,024 16-byte chunks, chunk tid + NT u is chunk
  // (c & 15) of row c >> 4
  auto load_tile = [&](int st, int k0, bool kv) {
    const uint32_t base = stages_s + st * STAGE_FLOATS * 4;
    if (kv) {
#pragma unroll
      for (int u = 0; u < KT * DH / 4 / NT; ++u) {
        const int c = tid + u * NT, r = c >> 4, c4 = (c & 15) * 4;
        const bool ok = k0 + r < S;
        cp_async16(base + (r * LD + c4) * 4, ok ? kb + (long long)(k0 + r) * p.sk.r + c4 : kb,
                   ok);
        cp_async16(base + (K_FLOATS + r * DH + c4) * 4,
                   ok ? vb + (long long)(k0 + r) * p.sv.r + c4 : vb, ok);
      }
    }
    if (tid < KT) {
      float* ms = stages + st * STAGE_FLOATS + K_FLOATS + V_FLOATS;
      ms[tid] = k0 + tid < S ? (mb ? mb[k0 + tid] * LOG2E : 0.f) : -INFINITY;
    }
  };

  const uint32_t qs_s = static_cast<uint32_t>(__cvta_generic_to_shared(Qs));
#pragma unroll
  for (int u = 0; u < BQ * DH / 4 / NT; ++u) {
    const int c = tid + u * NT, r = c >> 4, c4 = (c & 15) * 4;
    const bool ok = q0 + r < S;
    cp_async16(qs_s + (r * LD + c4) * 4, ok ? qb + (long long)(q0 + r) * p.sq.r + c4 : qb, ok);
  }
  load_tile(0, t0 * KT, true);
  cp_async_commit();

  float oacc[RI][4 * DC], m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * DC; ++e) oacc[i][e] = 0.f;
  }

  for (int it = t0; it < t1; ++it) {
    const int st = (it - t0) & 1;
    cp_async_wait_all();
    // tile `it` has landed for every thread, and every thread is done with
    // the other stage, so it may be written again
    __syncthreads();
    if (it + 1 < t1) {
#ifdef ATTN_FP32_ABLATE_LOADS
      load_tile(st ^ 1, (it + 1) * KT, false);
#else
      load_tile(st ^ 1, (it + 1) * KT, true);
#endif
      cp_async_commit();
    }
    const float* Ks = stages + st * STAGE_FLOATS;
    const float* Vs = Ks + K_FLOATS;
    const float* Ms = Vs + V_FLOATS;

    // S = Q K^T for rows ty + G i and keys tx + X j
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#ifndef ATTN_FP32_ABLATE_PRODUCTS
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[RI], ka[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + G * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + X * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = dot4(qa[i], ka[j], s[i][j]);
    }
#endif

    // online softmax in base 2; the X threads of a row are adjacent lanes,
    // so log2(X) shuffles give the row's max and, at the end, its sum
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = fmaf(s[i][j], p.scale_log2, Ms[tx + X * j]);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < X; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key it * 64 is a real key of every row, so the max is finite from
      // the block's first tile on and exp2f(-inf - mn) is a clean 0
      const float mn = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float e = ex2(s[i][j] - mn);
        sum += e;
        Ps[(ty + G * i) * LDP + tx + X * j] = e;
      }
      l[i] = l[i] * alpha + sum;  // this thread's share; summed at the end
#pragma unroll
      for (int e = 0; e < 4 * DC; ++e) oacc[i][e] *= alpha;
    }
    __syncwarp();  // P of a row is written by, and read by, lanes of one warp

    // O += P V for rows ty + G i and dims 4 tx + 4 X c
#pragma unroll 4
    for (int kk = 0; kk < KT; kk += 4) {
      float4 pa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + G * i) * LDP + kk);
#ifdef ATTN_FP32_ABLATE_PRODUCTS
#pragma unroll
      for (int i = 0; i < RI; ++i) oacc[i][0] += pa[i].x + pa[i].y + pa[i].z + pa[i].w;
#else
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 va[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c)
          va[c] = *reinterpret_cast<const float4*>(Vs + (kk + u) * DH + 4 * tx + 4 * X * c);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pu = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) axpy4(pu, va[c], oacc[i] + 4 * c);
        }
      }
#endif
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int off = 1; off < X; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

  float* ob = p.o + b * p.so.b + h * p.so.h;
#ifdef ATTN_FP32_ABLATE_MERGE
  if (true) {  // each block stores its own partial: the merge's cost out
#else
  if (split == 1) {
#endif
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + G * i;
      if (row < S) {
        const float inv = 1.f / l[i];
        float* orow = ob + (long long)row * p.so.r;
#pragma unroll
        for (int c = 0; c < DC; ++c)
          *reinterpret_cast<float4*>(orow + 4 * tx + 4 * X * c) =
              make_float4(oacc[i][4 * c] * inv, oacc[i][4 * c + 1] * inv,
                          oacc[i][4 * c + 2] * inv, oacc[i][4 * c + 3] * inv);
      }
    }
    return;
  }

  // the key split: push, meet, merge.  Row r of the tile is finished by
  // block r / R; this block's partial of it goes to slot rank * R + r % R
  // there: O (64 floats), m, l
  const int R = BQ / split;
  cluster_wait();  // every block of the cluster is running
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + G * i, dst = r / R;
    float* slot = recv + (rank * R + r % R) * LD;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      st_peer(peer(slot + 4 * tx + 4 * X * c, dst),
              make_float4(oacc[i][4 * c], oacc[i][4 * c + 1], oacc[i][4 * c + 2],
                          oacc[i][4 * c + 3]));
    if (tx == 0) st_peer(peer(slot + DH, dst), m[i], l[i]);
  }
  cluster_arrive();  // release: this block's pushes
  cluster_wait();    // acquire: every push into this block

  // rows rank * R.. of the tile: R rows x 16 float4, a float4 a thread
  for (int item = tid; item < R * 16; item += NT) {
    const int rr = item >> 4, c4 = (item & 15) * 4;
    float M = -INFINITY;
    for (int i = 0; i < split; ++i) M = fmaxf(M, recv[(i * R + rr) * LD + DH]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < split; ++i) {
      const float* slot = recv + (i * R + rr) * LD;
      const float mi = slot[DH];
      if (mi == -INFINITY) continue;  // a range with no real key holds nothing
      const float w = exp2f(mi - M);
      L = fmaf(w, slot[DH + 1], L);
      const float4 oi = *reinterpret_cast<const float4*>(slot + c4);
      acc.x = fmaf(w, oi.x, acc.x);
      acc.y = fmaf(w, oi.y, acc.y);
      acc.z = fmaf(w, oi.z, acc.z);
      acc.w = fmaf(w, oi.w, acc.w);
    }
    const int row = q0 + rank * R + rr;
    if (row < S) {
      const float inv = 1.f / L;
      *reinterpret_cast<float4*>(ob + (long long)row * p.so.r + c4) =
          make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    }
  }
}

template <int X, int RI>
cudaError_t launch(const Params& p, int blocks, int smem_bytes, cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fp32_kernel<X, RI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_fp32_kernel<X, RI>, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the (rows, X) shapes built: ops/attention.py FP32_SHAPES
cudaError_t launch_shape(int rows, int x, const Params& p, int blocks, int smem,
                         cudaStream_t s) {
  if (x == 8 && rows == 64) return launch<8, 4>(p, blocks, smem, s);
  if (x == 16 && rows == 32) return launch<16, 4>(p, blocks, smem, s);
  if (x == 16 && rows == 16) return launch<16, 2>(p, blocks, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o fp32 (rows and batches 16-byte aligned: strides multiples of 4
// elements); strides: 12 element strides, (batch, head, row) of q, k, v and
// o in turn; mask [B, S] fp32 or null.  plan (ops/attention.py
// fp32_plan_ints): rows, X, split, stages, P offset, stage offset, partials
// offset, shared-memory bytes.  A plan the kernel cannot
// run is refused (cudaErrorInvalidValue) before anything is launched.
extern "C" int attn_fwd_fp32(const void* q, const void* k, const void* v, const void* mask,
                             void* o, const long long* strides, int B, int H, int S,
                             float scale, const int* plan, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int rows = plan[0], x = plan[1], split = plan[2], stages = plan[3];
  const int off_p = plan[4], off_stage = plan[5], off_recv = plan[6], smem_bytes = plan[7];
  const int n_kt = (S + KT - 1) / KT;
  const long long blocks = (long long)B * H * ((S + rows - 1) / rows) * split;
  const int stage_bytes = stages * STAGE_FLOATS * 4, part_bytes = rows * LD * 4;
  const bool recv_ok = split == 1 || (off_recv >= off_stage + stage_bytes &&
                                      smem_bytes >= off_recv + part_bytes);
  if ((x != 8 && x != 16) || (split != 1 && split != 2 && split != 4 && split != 8) ||
      split > n_kt || rows % split || stages != ((n_kt + split - 1) / split > 1 ? 2 : 1) ||
      off_p < rows * LD * 4 ||
      off_stage < off_p + rows * (DH + x) * 4 || off_p % 16 || off_stage % 16 ||
      off_recv % 16 || !recv_ok || smem_bytes < off_stage + stage_bytes ||
      smem_bytes > SMEM_MAX || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides* st = reinterpret_cast<const Strides*>(strides);
  Params p;
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.mask = (const float*)mask;
  p.o = (float*)o;
  p.sq = st[0];
  p.sk = st[1];
  p.sv = st[2];
  p.so = st[3];
  p.H = H;
  p.S = S;
  p.scale_log2 = scale * LOG2E;
  p.split = split;
  p.off_p = off_p;
  p.off_stage = off_stage;
  p.off_recv = off_recv;
  return (int)launch_shape(rows, x, p, (int)blocks, smem_bytes, (cudaStream_t)stream);
}
