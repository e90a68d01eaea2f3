// Vocab projection fused with an online softmax: argmax id + max probability
// (K3) and the probability of a given target id (K4), without writing the
// (rows, V) logits to device memory.
//
// Replaces: navc_tpu/ops/vocab_fused.py fused_project_argmax (pallas_call at
// :128, body _kernel :36) and fused_project_gather_prob (pallas_call at :229,
// body _gather_kernel :152).
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
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TM;
  const int vecs = d / 8;  // 16-byte vectors per row

  for (int i = tid; i < TM * vecs; i += NTHREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) val = *reinterpret_cast<const uint4*>(h + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(hs + r * ld + c) = val;
  }

  // this thread's row and its 16 columns of every vocab tile
  const int r = tid >> 2;
  const int part = tid & 3;
  const bool row_ok = row0 + r < rows;
  const int tgt = (GATHER && row_ok) ? targets[row0 + r] : -1;
  float m = -INFINITY, s = 0.f, g = -1e30f;
  int arg = 0x7fffffff;

  const int tr = warp >> 1;        // output tile row of this warp
  const int tc = (warp & 1) * 2;   // first of its two output tile columns

  for (int v0 = 0; v0 < v; v0 += TV) {
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
