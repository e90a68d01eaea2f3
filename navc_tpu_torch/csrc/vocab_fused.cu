// Vocab projection fused with an online softmax: argmax id + max probability
// (K3), the probability of a given target id (K4) and the top-k log-probs
// with their ids (K5), without writing the (rows, V) logits to device memory.
//
// Replaces: navc_tpu/ops/vocab_fused.py fused_project_argmax (pallas_call at
// :128, body _kernel :36), fused_project_gather_prob (pallas_call at :229,
// body _gather_kernel :152) and fused_project_topk (pallas_call at :350, body
// _topk_kernel :246).
//
// What bounds it on the H100: the product h @ W^T. At the main path's dense
// shape (12288 x 512 x 10048) that is 126 GFLOP against ~23 MB of operands,
// so the bf16 tensor-core rate bounds it (~0.13 ms at 989 TFLOP/s); every
// block streams all of W (10 MB, resident in the 50 MB L2) once.
//
// Design: one block of 8 warps per 64-row tile of h. The h tile stays in
// shared memory; a loop inside the block walks W in 64-column vocab tiles (it
// replaces the TPU's sequential vocab grid axis). Each tile is staged in
// shared memory in nn.Linear's own (V, D) layout, which is the col-major B
// operand of a bf16 wmma 16x16x16 product with float32 accumulation. Scores
// go to a small float tile; each of 4 threads per row keeps a running (max,
// sum-exp, argmax[, target logit]) over its 16 columns of every tile, in
// registers, and the 4 merge with warp shuffles at the end. The ragged vocab
// edge is skipped by index, so W needs no padded copy. Ties go to the lowest
// id (strict '>' in column order inside a thread, lower id on equal maxima in
// the merge), as the Pallas kernel's argmax does.
//
// K5 (the AR beam step's top-k): the same tile loop, but each thread also
// keeps the MAX_K best (value, id) pairs of its columns in registers, sorted
// by value and then by lower id (strict '>' in column order; the lower id
// wins a tie in every merge, which is lax.top_k's order). At serving shapes
// the beam step has few rows (320 at 64 videos x beam 5: 5 row tiles), so one
// block per row tile would leave most of the 132 SMs idle; the vocab axis is
// therefore split across blockIdx.y, each block writes its partial (max,
// sum-exp, top MAX_K) per row, and a second small kernel (a warp per row)
// merges the splits and writes (logit - max) - log(sum-exp) for the first k.
// At 320 x 512 x 10048 the bound is the W read and the 3.3 GFLOP product, a
// few microseconds; the split keeps each block's share of W to a few tiles.
// Not yet done (later work): cp.async/TMA double-buffering of the W tiles and
// wgmma; the staging and the products do not overlap here.

#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;          // rows of h per block
constexpr int TV = 64;          // vocab columns per tile
constexpr int NTHREADS = 256;   // 8 warps
constexpr int PAD = 8;          // bf16 row padding of the staged tiles
constexpr int SC_LD = TV + 4;   // float row stride of the score tile

size_t smem_bytes(int d) {
  return (size_t)(TM + TV) * (d + PAD) * sizeof(bf16) + (size_t)TM * SC_LD * sizeof(float);
}

// Shared-memory layout of every kernel here: the h tile (TM x d), one W tile
// (TV x d), the float score tile (TM x SC_LD).
__device__ __forceinline__ void stage_h(bf16* hs, const bf16* __restrict__ h, int row0, int rows,
                                        int d) {
  const int ld = d + PAD, vecs = d / 8;
  for (int i = threadIdx.x; i < TM * vecs; i += NTHREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) val = *reinterpret_cast<const uint4*>(h + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(hs + r * ld + c) = val;
  }
}

// Stages the W tile of vocab columns [v0, v0 + TV) and leaves the (TM x TV)
// float scores h_tile @ W_tile^T in sc, visible to the whole block. Columns
// at or past v are zero.
__device__ __forceinline__ void score_tile(const bf16* hs, bf16* ws, float* sc,
                                           const bf16* __restrict__ w, int v0, int v, int d) {
  const int ld = d + PAD, vecs = d / 8;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int tr = warp >> 1;        // output tile row of this warp
  const int tc = (warp & 1) * 2;   // first of its two output tile columns
  __syncthreads();  // the previous tile's scores are consumed
  for (int i = tid; i < TV * vecs; i += NTHREADS) {
    const int vr = i / vecs, c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (v0 + vr < v) val = *reinterpret_cast<const uint4*>(w + (size_t)(v0 + vr) * d + c);
    *reinterpret_cast<uint4*>(ws + vr * ld + c) = val;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
  wmma::fill_fragment(acc0, 0.f);
  wmma::fill_fragment(acc1, 0.f);
  for (int k = 0; k < d; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0, b1;
    wmma::load_matrix_sync(a, hs + tr * 16 * ld + k, ld);
    wmma::load_matrix_sync(b0, ws + tc * 16 * ld + k, ld);
    wmma::load_matrix_sync(b1, ws + (tc + 1) * 16 * ld + k, ld);
    wmma::mma_sync(acc0, a, b0, acc0);
    wmma::mma_sync(acc1, a, b1, acc1);
  }
  wmma::store_matrix_sync(sc + tr * 16 * SC_LD + tc * 16, acc0, SC_LD, wmma::mem_row_major);
  wmma::store_matrix_sync(sc + tr * 16 * SC_LD + (tc + 1) * 16, acc1, SC_LD, wmma::mem_row_major);
  __syncthreads();
}

template <bool GATHER>
__global__ void __launch_bounds__(NTHREADS)
vocab_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
             const float* __restrict__ bias, const int* __restrict__ targets,
             int* __restrict__ ids, float* __restrict__ out, int rows, int d, int v) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + PAD;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + TM * ld;
  float* sc = reinterpret_cast<float*>(ws + TV * ld);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  stage_h(hs, h, row0, rows, d);

  // this thread's row and its 16 columns of every vocab tile
  const int r = tid >> 2;
  const int part = tid & 3;
  const bool row_ok = row0 + r < rows;
  const int tgt = (GATHER && row_ok) ? targets[row0 + r] : -1;
  float m = -INFINITY, s = 0.f, g = -1e30f;
  int arg = 0x7fffffff;

  for (int v0 = 0; v0 < v; v0 += TV) {
    score_tile(hs, ws, sc, w, v0, v, d);

    const float* srow = sc + r * SC_LD + part * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = v0 + part * 16 + j;
      if (col < v) {
        const float x = srow[j] + (bias ? bias[col] : 0.f);
        if (GATHER && col == tgt) g = x;
        if (x > m) {
          s = s * expf(m - x) + 1.f;
          m = x;
          arg = col;
        } else {
          s += expf(x - m);
        }
      }
    }
  }

  // merge the 4 partial states of a row (lanes 4k .. 4k+3 of one warp)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const int a2 = __shfl_xor_sync(0xffffffffu, arg, off);
    const float g2 = __shfl_xor_sync(0xffffffffu, g, off);
    const float mn = fmaxf(m, m2);
    const float sa = (m == -INFINITY) ? 0.f : s * expf(m - mn);
    const float sb = (m2 == -INFINITY) ? 0.f : s2 * expf(m2 - mn);
    s = sa + sb;
    if (m2 > m || (m2 == m && a2 < arg)) arg = a2;
    m = mn;
    g = fmaxf(g, g2);
  }
  if (part == 0 && row_ok) {
    if (GATHER) {
      out[row0 + r] = expf(g - m) / s;
    } else {
      ids[row0 + r] = arg;
      out[row0 + r] = 1.f / s;  // max prob = exp(m - m) / sum-exp
    }
  }
}

template <bool GATHER>
int launch(const void* h, const void* w, const void* bias, const void* targets, void* ids,
           void* out, int rows, int d, int v, void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(vocab_kernel<GATHER>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((rows + TM - 1) / TM);
  vocab_kernel<GATHER><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(targets), static_cast<int*>(ids), static_cast<float*>(out), rows, d,
      v);
  return (int)cudaGetLastError();
}

constexpr int MAX_K = 8;  // beam sizes 1..8; the wrapper refuses more

// (a, ia) ranks before (b, ib): larger value, then lower id (lax.top_k's order)
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// Insert (x, id) into the sorted register list (tv, ti), dropping its last
// entry; fully unrolled so the list stays in registers.
__device__ __forceinline__ void topk_insert(float (&tv)[MAX_K], int (&ti)[MAX_K], float x, int id) {
  if (!before(x, id, tv[MAX_K - 1], ti[MAX_K - 1])) return;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (before(x, id, tv[j], ti[j])) {
      const float fv = tv[j];
      const int fi = ti[j];
      tv[j] = x;
      ti[j] = id;
      x = fv;
      id = fi;
    }
  }
}

// Merge two (max, sum-exp) states of one row.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  const float sa = (m == -INFINITY) ? 0.f : s * expf(m - mn);
  const float sb = (m2 == -INFINITY) ? 0.f : s2 * expf(m2 - mn);
  s = sa + sb;
  m = mn;
}

// Grid (row tiles, vocab splits): block (i, j) walks the vocab tiles of split
// j for rows [64 i, 64 i + 64) and writes each row's partial state: max and
// sum-exp (pm, ps: rows x splits) and its MAX_K best (pv, pi: rows x splits x
// MAX_K).
__global__ void __launch_bounds__(NTHREADS)
topk_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ pm, float* __restrict__ ps,
            float* __restrict__ pv, int* __restrict__ pi, int rows, int d, int v,
            int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + PAD;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + TM * ld;
  float* sc = reinterpret_cast<float*>(ws + TV * ld);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int split = blockIdx.y, splits = gridDim.y;
  stage_h(hs, h, row0, rows, d);

  const int r = tid >> 2;
  const int part = tid & 3;
  float m = -INFINITY, s = 0.f;
  float tv[MAX_K];
  int ti[MAX_K];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    tv[j] = -INFINITY;
    ti[j] = 0x7fffffff;
  }

  const int v_begin = split * tiles_per_split * TV;
  const int v_end = min(v, v_begin + tiles_per_split * TV);
  for (int v0 = v_begin; v0 < v_end; v0 += TV) {
    score_tile(hs, ws, sc, w, v0, v, d);
    const float* srow = sc + r * SC_LD + part * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = v0 + part * 16 + j;
      if (col < v) {
        const float x = srow[j] + (bias ? bias[col] : 0.f);
        if (x > m) {
          s = s * expf(m - x) + 1.f;
          m = x;
        } else {
          s += expf(x - m);
        }
        topk_insert(tv, ti, x, col);
      }
    }
  }

  // merge the 4 partial states of a row (lanes 4k .. 4k+3 of one warp); the
  // partner's list is read whole before this thread's list changes
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    float ov[MAX_K];
    int oi[MAX_K];
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      ov[j] = __shfl_xor_sync(0xffffffffu, tv[j], off);
      oi[j] = __shfl_xor_sync(0xffffffffu, ti[j], off);
    }
    lse_merge(m, s, m2, s2);
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) topk_insert(tv, ti, ov[j], oi[j]);
  }
  if (part == 0 && row0 + r < rows) {
    const size_t at = (size_t)(row0 + r) * splits + split;
    pm[at] = m;
    ps[at] = s;
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      pv[at * MAX_K + j] = tv[j];
      pi[at * MAX_K + j] = ti[j];
    }
  }
}

// One warp per row: lane j folds splits j, j + 32, ... into its state, the
// 32 states merge by shuffles, and lane 0 writes the first k log-probs
// (logit - max) - log(sum-exp) with their ids.
__global__ void topk_merge_kernel(const float* __restrict__ pm, const float* __restrict__ ps,
                                  const float* __restrict__ pv, const int* __restrict__ pi,
                                  float* __restrict__ lp, int* __restrict__ ids, int rows,
                                  int splits, int k) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp: row is the warp's
  const size_t base = (size_t)row * splits;
  float m = -INFINITY, s = 0.f;
  float tv[MAX_K];
  int ti[MAX_K];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    tv[j] = -INFINITY;
    ti[j] = 0x7fffffff;
  }
  for (int j = lane; j < splits; j += 32) {
    lse_merge(m, s, pm[base + j], ps[base + j]);
#pragma unroll
    for (int q = 0; q < MAX_K; ++q)
      topk_insert(tv, ti, pv[(base + j) * MAX_K + q], pi[(base + j) * MAX_K + q]);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    float ov[MAX_K];
    int oi[MAX_K];
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      ov[j] = __shfl_xor_sync(0xffffffffu, tv[j], off);
      oi[j] = __shfl_xor_sync(0xffffffffu, ti[j], off);
    }
    lse_merge(m, s, m2, s2);
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) topk_insert(tv, ti, ov[j], oi[j]);
  }
  if (lane == 0) {
    const float lse = logf(s);
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      if (j < k) {
        lp[(size_t)row * k + j] = (tv[j] - m) - lse;
        ids[(size_t)row * k + j] = ti[j];
      }
    }
  }
}

}  // namespace

// h (rows, d) bf16; w (v, d) bf16; bias (v,) f32 or null -> ids (rows,) i32,
// maxp (rows,) f32.
NAVC_EXPORT int navc_project_argmax(const void* h, const void* w, const void* bias, void* ids,
                                    void* maxp, int rows, int d, int v, void* stream) {
  return launch<false>(h, w, bias, nullptr, ids, maxp, rows, d, v, stream);
}

// h (rows, d) bf16; w (v, d) bf16; targets (rows,) i32; bias (v,) f32 or
// null -> prob (rows,) f32.
NAVC_EXPORT int navc_project_gather_prob(const void* h, const void* w, const void* bias,
                                         const void* targets, void* prob, int rows, int d, int v,
                                         void* stream) {
  return launch<true>(h, w, bias, targets, nullptr, prob, rows, d, v, stream);
}

// h (rows, d) bf16; w (v, d) bf16; bias (v,) f32 or null -> lp (rows, k) f32
// descending, ids (rows, k) i32. Scratch from the caller: pm, ps (rows x
// splits) f32, pv (rows x splits x 8) f32, pi (rows x splits x 8) i32; the
// vocab is cut into `splits` runs of tiles_per_split 64-column tiles.
NAVC_EXPORT int navc_project_topk(const void* h, const void* w, const void* bias, void* lp,
                                  void* ids, void* pm, void* ps, void* pv, void* pi, int rows,
                                  int d, int v, int k, int splits, int tiles_per_split,
                                  void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + TM - 1) / TM, splits);
  topk_kernel<<<grid, NTHREADS, smem, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<float*>(pm), static_cast<float*>(ps), static_cast<float*>(pv),
      static_cast<int*>(pi), rows, d, v, tiles_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(ps), static_cast<const float*>(pv),
      static_cast<const int*>(pi), static_cast<float*>(lp), static_cast<int*>(ids), rows, splits,
      k);
  return (int)cudaGetLastError();
}
