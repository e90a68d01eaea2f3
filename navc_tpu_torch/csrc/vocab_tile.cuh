// Tile-and-score code shared by the vocab-projection kernels: vocab_fused.cu
// (K3-K5, decode) and vocab_ce.cu (K9/K10, the training loss). A block of
// NTHREADS threads holds a TM-row tile of h and one TV-column tile of W (in
// nn.Linear's own (V, D) layout, the col-major B operand) in shared memory,
// and forms their (TM x TV) float32 scores with bf16 wmma 16x16x16 products.
// The ragged vocab edge and the rows past the end are zero-filled by index,
// so W and h need no padded copies.
#pragma once

#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;          // rows of h per tile
constexpr int TV = 64;          // vocab columns per tile
constexpr int NTHREADS = 256;   // 8 warps
constexpr int PAD = 8;          // bf16 row padding of the staged tiles
constexpr int SC_LD = TV + 4;   // float row stride of the score tile

// The h tile (TM x d), one W tile (TV x d) and the float score tile (TM x
// SC_LD), in that order from the start of dynamic shared memory.
__host__ __device__ inline size_t tile_smem_bytes(int d) {
  return (size_t)(TM + TV) * (d + PAD) * sizeof(bf16) + (size_t)TM * SC_LD * sizeof(float);
}

// Rows [row0, row0 + TM) of h into hs; rows at or past `rows` are zero.
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

// Vocab rows [v0, v0 + TV) of W into ws; rows at or past v are zero.
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* __restrict__ w, int v0, int v,
                                        int d) {
  const int ld = d + PAD, vecs = d / 8;
  for (int i = threadIdx.x; i < TV * vecs; i += NTHREADS) {
    const int vr = i / vecs, c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (v0 + vr < v) val = *reinterpret_cast<const uint4*>(w + (size_t)(v0 + vr) * d + c);
    *reinterpret_cast<uint4*>(ws + vr * ld + c) = val;
  }
}

// sc = hs @ ws^T (TM x TV, float32), visible to the whole block on return;
// hs and ws must be staged and visible on entry.
__device__ __forceinline__ void tile_scores(const bf16* hs, const bf16* ws, float* sc, int d) {
  const int ld = d + PAD;
  const int warp = threadIdx.x >> 5;
  const int tr = warp >> 1;        // output tile row of this warp
  const int tc = (warp & 1) * 2;   // first of its two output tile columns
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

// Stages the W tile of vocab columns [v0, v0 + TV) and leaves the (TM x TV)
// float scores h_tile @ W_tile^T in sc, visible to the whole block. Columns
// at or past v are zero.
__device__ __forceinline__ void score_tile(const bf16* hs, bf16* ws, float* sc,
                                           const bf16* __restrict__ w, int v0, int v, int d) {
  __syncthreads();  // the previous tile's scores are consumed
  stage_w(ws, w, v0, v, d);
  __syncthreads();
  tile_scores(hs, ws, sc, d);
}

}  // namespace
