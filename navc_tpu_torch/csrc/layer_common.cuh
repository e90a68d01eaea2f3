// Device code shared by the whole-layer kernels: fused_layer.cu (K1/K2, the
// eval layer of the NAR decode) and fused_layer_train.cu (K11 and K12b's
// recompute of it). Both run one block of NT threads per sequence of at most
// MR rows, keep the layer in shared memory in the layout below, multiply with
// bf16 wmma 16x16x16 fragments accumulating in float32, and share the
// per-head softmax and the chunked FFN, so the forward of the two sources
// does the same arithmetic in the same order.
#pragma once

#include "common.cuh"

#include <mma.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int MR = 32;             // rows held per block (queries and keys)
constexpr int FFN_CH = 256;        // FFN intermediate columns per chunk
constexpr int SREG = MR * 32 * 4;  // per-warp 32x32 float32 score slice, bytes
constexpr float MASK_FILL = -10e6f;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

// Shared memory of the layer forward.
struct LayerSmem {
  float* xf;   // [MR][H] residual stream, f32
  bf16* xb;    // [MR][ldb] bf16 A operand; per-warp score slices alias it
  bf16* qb;    // [MR][ldb] queries, then attention context
  bf16* kb;    // [MR][ldb] keys; FFN chunk activations alias it
  bf16* vb;    // [MR][ldb] values
  float* stg;  // [NW][256] per-warp accumulator staging
  int ldb;
};

// One bf16 tile of the layout: MR rows of H, the warps' score slices, or
// the FFN chunk's activations, whichever is largest.
__host__ __device__ inline size_t tile_bytes(int H) {
  const size_t a = (size_t)MR * (H + 8) * sizeof(bf16);
  const size_t b = (size_t)NW * SREG;
  const size_t c = (size_t)MR * (FFN_CH + 8) * sizeof(bf16);
  size_t m = a > b ? a : b;
  m = m > c ? m : c;
  return (m + 127) / 128 * 128;
}

__host__ __device__ inline size_t layer_smem_bytes(int H) {
  return (size_t)MR * H * sizeof(float) + 4 * tile_bytes(H) + (size_t)NW * 256 * sizeof(float);
}

__device__ inline LayerSmem layer_layout(unsigned char* smem, int H) {
  LayerSmem s;
  s.ldb = H + 8;
  const size_t tb = tile_bytes(H);
  s.xf = reinterpret_cast<float*>(smem);
  unsigned char* p = smem + (size_t)MR * H * sizeof(float);
  s.xb = reinterpret_cast<bf16*>(p);
  s.qb = reinterpret_cast<bf16*>(p + tb);
  s.kb = reinterpret_cast<bf16*>(p + 2 * tb);
  s.vb = reinterpret_cast<bf16*>(p + 3 * tb);
  s.stg = reinterpret_cast<float*>(p + 4 * tb);
  return s;
}

__device__ __forceinline__ float gelu_new(float x) {
  return 0.5f * x * (1.f + tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x * x * x)));
}

// C[rows 0 .. mt*16, cols 0 .. n_out) = A @ B over k_in, A bf16 row-major
// (shared or global memory, lda). BROW false: W is (n_out, k_in) row-major
// (nn.Linear's weight, the col-major B); BROW true: W is (k_in, n_out)
// row-major with leading dimension ldw. Warp w takes output column tiles w,
// w + NW, ...; epi(row, col, value) consumes every accumulated element.
template <bool BROW = false, typename Epi>
__device__ void gemm_rows(const bf16* A, int lda, int mt, const bf16* W, int ldw, int n_out,
                          int k_in, float* stg, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int ct = warp; ct < n_out / 16; ct += NW) {
    Acc acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k = 0; k < k_in; k += 16) {
      typename std::conditional<BROW, BRow, BCol>::type b;
      if constexpr (BROW)
        wmma::load_matrix_sync(b, W + (size_t)k * ldw + ct * 16, ldw);
      else
        wmma::load_matrix_sync(b, W + (size_t)ct * 16 * ldw + k, ldw);
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        if (rt < mt) {
          ARow a;
          wmma::load_matrix_sync(a, A + (size_t)rt * 16 * lda + k, lda);
          wmma::mma_sync(acc[rt], a, b, acc[rt]);
        }
      }
    }
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      if (rt < mt) {
        wmma::store_matrix_sync(stg, acc[rt], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) epi(rt * 16 + e / 16, ct * 16 + e % 16, stg[e]);
        __syncwarp();
      }
    }
  }
}

// One head's probabilities (warp): scores Q_h K_h^T into sreg (32x32 f32),
// then lane i holds row i's softmax in p (0 outside the live block).
// masked(i, j) adds MASK_FILL to the score of query i and key j.
template <typename Masked>
__device__ void head_probs(const bf16* Q, int ldq, const bf16* K, int ldk, int c0, int d, int mtq,
                           int mtk, float scale, Masked masked, float* sreg, float (&p)[32]) {
  const int lane = threadIdx.x & 31;
  for (int rt = 0; rt < mtq; ++rt)
    for (int kt = 0; kt < mtk; ++kt) {
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < d; k += 16) {
        ARow a;
        BCol b;
        wmma::load_matrix_sync(a, Q + (size_t)rt * 16 * ldq + c0 + k, ldq);
        wmma::load_matrix_sync(b, K + (size_t)kt * 16 * ldk + c0 + k, ldk);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sreg + rt * 16 * 32 + kt * 16, acc, 32, wmma::mem_row_major);
    }
  __syncwarp();
  const int i = lane, nk = mtk * 16;
  const bool live = i < mtq * 16;
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    p[j] = 0.f;
    if (live && j < nk) {
      p[j] = sreg[i * 32 + j] * scale + (masked(i, j) ? MASK_FILL : 0.f);
      mx = fmaxf(mx, p[j]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (live && j < nk) {
      p[j] = expf(p[j] - mx);
      sum += p[j];
    }
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (live && j < nk) p[j] = p[j] / sum;
  __syncwarp();  // every lane has read its scores before P overwrites them
}

// Per-head attention of the forward, one warp per head. Queries: qb rows
// 0 .. mtq*16; keys/values: kb/vb rows 0 .. mtk*16. The context (bf16)
// replaces each head's query columns in qb. Score slices alias xb.
template <typename Masked>
__device__ void attend(const LayerSmem& s, int H, int n_head, int mtq, int mtk, float scale,
                       Masked masked) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = H / n_head, ldb = s.ldb, nk = mtk * 16;
  float* sreg = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.xb) + warp * SREG);
  bf16* preg = reinterpret_cast<bf16*>(sreg);
  float* stg = s.stg + warp * 256;
  for (int hd = warp; hd < n_head; hd += NW) {
    const int c0 = hd * d;
    float p[32];
    head_probs(s.qb, ldb, s.kb, ldb, c0, d, mtq, mtk, scale, masked, sreg, p);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (lane < mtq * 16 && j < nk) preg[lane * 32 + j] = __float2bfloat16(p[j]);
    __syncwarp();
    for (int rt = 0; rt < mtq; ++rt)
      for (int dt = 0; dt < d / 16; ++dt) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kt = 0; kt < mtk; ++kt) {
          ARow a;
          BRow b;
          wmma::load_matrix_sync(a, preg + rt * 16 * 32 + kt * 16, 32);
          wmma::load_matrix_sync(b, s.vb + kt * 16 * ldb + c0 + dt * 16, ldb);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(stg, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          s.qb[(rt * 16 + e / 16) * ldb + c0 + dt * 16 + e % 16] = __float2bfloat16(stg[e]);
        __syncwarp();
      }
    __syncwarp();
  }
}

// The FFN of xb's rows 0 .. mt*16 (bf16): per FFN_CH-column chunk, the
// up-projection + bi + gelu_new into bf16 (aliasing kb), then its share of
// the down-projection accumulates in register fragments, so the rows x I
// float intermediate never exists. Warp w owns output column tiles w,
// w + NW, ... (at most 4: H <= 512). epi(row, col, value) then consumes
// every element of the down-projection, without its bias.
template <typename Epi>
__device__ __forceinline__ void ffn_rows(const LayerSmem& s, int H, int I, int mt, const bf16* wi,
                                         const float* bi, const bf16* wo2, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ctw = H / 16 / NW, ldb = s.ldb;
  float* stg = s.stg + warp * 256;
  Acc down[2][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(down[rt][t], 0.f);
  bf16* ib = s.kb;
  const int ldi = FFN_CH + 8;
  for (int c0 = 0; c0 < I; c0 += FFN_CH) {
    const int cw = min(FFN_CH, I - c0);
    const float* bc = bi + c0;
    gemm_rows(s.xb, ldb, mt, wi + (size_t)c0 * H, H, cw, H, stg, [=](int i, int j, float v) {
      ib[i * ldi + j] = __float2bfloat16(gelu_new(v + bc[j]));
    });
    __syncthreads();
    for (int k = 0; k < cw; k += 16) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < ctw) {
          const int ct = warp + NW * t;
          BCol b;
          wmma::load_matrix_sync(b, wo2 + (size_t)ct * 16 * I + c0 + k, I);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            if (rt < mt) {
              ARow fa;
              wmma::load_matrix_sync(fa, ib + rt * 16 * ldi + k, ldi);
              wmma::mma_sync(down[rt][t], fa, b, down[rt][t]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < ctw) {
      const int ct = warp + NW * t;
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        if (rt < mt) {
          wmma::store_matrix_sync(stg, down[rt][t], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) epi(rt * 16 + e / 16, ct * 16 + e % 16, stg[e]);
          __syncwarp();
        }
      }
    }
  }
}

}  // namespace
