// Device code shared by the whole-layer kernels: fused_layer.cu (K1/K2, the
// eval layer of the NAR decode, and K1u) and fused_layer_train.cu (K11 and
// K12b's recompute of it). Both run one block of NT threads per sequence of at most
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

// ---------------------------------------------------------------------------
// The layer forward with the cross K/V projected in the kernel and the
// training layer's hash dropout: K11 and K12b's recompute of it
// (fused_layer_train.cu), and K1u at p = 0 (fused_layer.cu).
// ---------------------------------------------------------------------------

namespace {

// navc_tpu's int32 constants, as uint32 (its comments' hex differs for MC3, MM2)
constexpr unsigned MC1 = 0x9E3779B9u, MC2 = 0x85EBCA6Bu, MC3 = 0xC2B2AE3Du;
constexpr unsigned MM1 = 0x7FEB352Du, MM2 = 0x849E368Bu;
enum { SITE_SELF_OUT = 0, SITE_CROSS_OUT, SITE_FFN_DOWN, SITE_FFN_FINAL, SITE_INPUT };
enum { WS_X, WS_C1, WS_R1, WS_C2, WS_DO1, WS_DQ1, WS_DK1, WS_DV1, WS_DO2, WS_DQ2,
       WS_ENC, WS_DK2, WS_DV2, WS_G, WS_DA, WS_DD };
enum { P_BQS, P_BKS, P_BVS, P_BOS, P_BQC, P_BKC, P_BVC, P_BOC, P_BI, P_BO2 };
enum { S_Q1, S_K1, S_V1, S_Q2, S_K2, S_V2 };

}  // namespace

// Mirrored field by field by navc_tpu_torch/ops/fused_layer_train.py
// (TrainArgs). Matrices are nn.Linear's (out, in), row-major.
struct TrainArgs {
  const float* x;           // (N, L, H) post-embedding rows
  const float* enc;         // (N, Le, H) encoder output
  const unsigned char* kp;  // (N, L) 1 at PAD
  const bf16* w[8];         // wq_s wk_s wv_s wo_s wq_c wk_c wv_c wo_c: (H, H)
  const float* b[8];
  const bf16* wi;           // (I, H)
  const float* bi;
  const bf16* wo2;          // (H, I)
  const float* bo2;
  void* out;                // K11: (N, L, H) bf16 or f32
  bf16* r2;                 // K11 out / K12a in: (N, Lp, H)
  const float* dy;          // K12a: (N, L, H)
  float* dr2;               // K12a out / K12b in: (N, L, H)
  float* dx;                // K12b: (N, L, H)
  float* denc;              // K12b: (N, Le, H)
  bf16* ws[16];             // operand rows (N * Lp or N * Lep, H or I), WS_*
  float* part[10];          // per-sequence bias column sums (N, H or I), P_*
  bf16* scr[6];             // K12b scratch: Q/K/V of both attentions, S_*
  int out_bf16, n, L, Le, H, I, n_head, causal, Lp, Lep, on_hidden, on_input;
  unsigned seed, th_hidden, th_input;
  float keep_hidden, keep_input, scale;
};

namespace {

__device__ __forceinline__ unsigned hash24(unsigned seed, unsigned tile, unsigned site,
                                           unsigned r, unsigned c) {
  const unsigned key = seed + (tile * 11u + site) * MC3;
  unsigned x = r * MC1 + c * MC2 + key;
  x ^= x >> 16;
  x *= MM1;
  x ^= x >> 13;
  x *= MM2;
  x ^= x >> 16;
  return x & 0x00FFFFFFu;
}

// Dropout of one sequence's elements: v * (bits >= th ? 1 / (1 - p) : 0).
struct Drop {
  unsigned seed, tile, rbase, th_h, th_i;
  float keep_h, keep_i;
  bool on_h, on_i;

  __device__ float hidden(float v, int site, int i, int j) const {
    if (!on_h) return v;
    return v * (hash24(seed, tile, site, rbase + i, j) >= th_h ? keep_h : 0.f);
  }
  __device__ float input(float v, int i, int j) const {
    if (!on_i) return v;
    return v * (hash24(seed, tile, SITE_INPUT, rbase + i, j) >= th_i ? keep_i : 0.f);
  }
};

__device__ Drop make_drop(const TrainArgs& a, int n) {
  Drop d;
  d.seed = a.seed;
  d.tile = (unsigned)(n / 8);
  d.rbase = (unsigned)((n % 8) * ((a.L + 7) / 8 * 8));
  d.th_h = a.th_hidden;
  d.th_i = a.th_input;
  d.keep_h = a.keep_hidden;
  d.keep_i = a.keep_input;
  d.on_h = a.on_hidden != 0;
  d.on_i = a.on_input != 0;
  return d;
}

// rows x H bf16 from src (ld lds) to dst (ld H), zero from row `valid` on.
__device__ void copy_rows(const bf16* src, int lds, bf16* dst, int valid, int rows, int H) {
  for (int idx = threadIdx.x; idx < rows * H; idx += NT) {
    const int r = idx / H, c = idx % H;
    dst[(size_t)r * H + c] = r < valid ? src[r * lds + c] : __float2bfloat16(0.f);
  }
}

// x' = input dropout of x; self-attention; cross-attention over enc. Leaves
// r2 in xf (f32) and xb (bf16). With `save`, writes the backward's operand
// rows (x', c1, r1, c2, enc) and the Q/K/V scratch of both attentions.
__device__ void self_cross_fwd(const TrainArgs& a, const LayerSmem& s, int n, const Drop& dr,
                               const float* kmask, const float* npm, bool save) {
  const int H = a.H, L = a.L, Le = a.Le, ldb = s.ldb;
  const int warp = threadIdx.x >> 5;
  const int mt = (L + 15) / 16, mte = (Le + 15) / 16;
  float* stg = s.stg + warp * 256;
  const size_t drow = (size_t)n * a.Lp, erow = (size_t)n * a.Lep;

  for (int idx = threadIdx.x; idx < MR * H; idx += NT) {
    const int r = idx / H, c = idx % H;
    const float v = r < L ? dr.input(a.x[((size_t)n * L + r) * H + c], r, c) : 0.f;
    s.xf[r * H + c] = v;
    s.xb[r * ldb + c] = __float2bfloat16(v);
    if (save && r < a.Lp) a.ws[WS_X][(drow + r) * H + c] = __float2bfloat16(v);
  }
  __syncthreads();

  auto to_bf16 = [&](bf16* dst, const float* bias) {
    return [=](int i, int j, float v) { dst[i * ldb + j] = __float2bfloat16(v + bias[j]); };
  };
  gemm_rows<false>(s.xb, ldb, mt, a.w[1], H, H, H, stg, to_bf16(s.kb, a.b[1]));
  gemm_rows<false>(s.xb, ldb, mt, a.w[2], H, H, H, stg, to_bf16(s.vb, a.b[2]));
  gemm_rows<false>(s.xb, ldb, mt, a.w[0], H, H, H, stg, to_bf16(s.qb, a.b[0]));
  __syncthreads();
  if (save) {
    copy_rows(s.qb, ldb, a.scr[S_Q1] + drow * H, a.Lp, a.Lp, H);
    copy_rows(s.kb, ldb, a.scr[S_K1] + drow * H, a.Lp, a.Lp, H);
    copy_rows(s.vb, ldb, a.scr[S_V1] + drow * H, a.Lp, a.Lp, H);
    __syncthreads();  // the attention overwrites qb
  }

  const bool causal = a.causal != 0;
  attend(s, H, a.n_head, mt, mt, a.scale,
             [=](int i, int j) { return kmask[j] > 0.5f || (causal && j > i); });
  __syncthreads();
  if (save) copy_rows(s.qb, ldb, a.ws[WS_C1] + drow * H, L, a.Lp, H);

  auto residual = [&](const float* bias, int site) {
    return [=](int i, int j, float v) {
      const float o = dr.hidden(v + bias[j], site, i, j);
      const float y = (o + s.xf[i * H + j]) * npm[i];
      s.xf[i * H + j] = y;
      s.xb[i * ldb + j] = __float2bfloat16(y);
    };
  };
  gemm_rows<false>(s.qb, ldb, mt, a.w[3], H, H, H, stg, residual(a.b[3], SITE_SELF_OUT));
  __syncthreads();
  if (save) copy_rows(s.xb, ldb, a.ws[WS_R1] + drow * H, L, a.Lp, H);

  // cross K/V from the encoder rows (bf16 in qb)
  for (int idx = threadIdx.x; idx < MR * H; idx += NT) {
    const int r = idx / H, c = idx % H;
    const bf16 v = __float2bfloat16(r < Le ? a.enc[((size_t)n * Le + r) * H + c] : 0.f);
    s.qb[r * ldb + c] = v;
    if (save && r < a.Lep) a.ws[WS_ENC][(erow + r) * H + c] = v;
  }
  __syncthreads();
  gemm_rows<false>(s.qb, ldb, mte, a.w[5], H, H, H, stg, to_bf16(s.kb, a.b[5]));
  gemm_rows<false>(s.qb, ldb, mte, a.w[6], H, H, H, stg, to_bf16(s.vb, a.b[6]));
  __syncthreads();
  gemm_rows<false>(s.xb, ldb, mt, a.w[4], H, H, H, stg, to_bf16(s.qb, a.b[4]));
  __syncthreads();
  if (save) {
    copy_rows(s.qb, ldb, a.scr[S_Q2] + drow * H, a.Lp, a.Lp, H);
    copy_rows(s.kb, ldb, a.scr[S_K2] + erow * H, a.Lep, a.Lep, H);
    copy_rows(s.vb, ldb, a.scr[S_V2] + erow * H, a.Lep, a.Lep, H);
    __syncthreads();
  }
  attend(s, H, a.n_head, mt, mte, a.scale, [=](int, int j) { return j >= Le; });
  __syncthreads();
  if (save) copy_rows(s.qb, ldb, a.ws[WS_C2] + drow * H, L, a.Lp, H);
  gemm_rows<false>(s.qb, ldb, mt, a.w[7], H, H, H, stg, residual(a.b[7], SITE_CROSS_OUT));
  __syncthreads();
}

__device__ void init_masks(const TrainArgs& a, int n, float* kmask, float* npm) {
  if (threadIdx.x < MR) {
    const int j = threadIdx.x;
    kmask[j] = (j < a.L) ? (a.kp[(size_t)n * a.L + j] ? 1.f : 0.f) : 1.f;
    npm[j] = (j < a.L) ? 1.f - kmask[j] : 0.f;
  }
  __syncthreads();
}

// The layer forward of sequence blockIdx.x with the cross K/V projected in
// the kernel: K11 (fused_layer_train.cu), and K1u (fused_layer.cu) with both
// dropout probabilities 0 and no r2. r2 is written when a.r2 is not null.
// FFN as K1; out = drop_final(drop_down(down + bo2) + r2) * npm.
__device__ __forceinline__ void layer_fwd(const TrainArgs& a, unsigned char* smem, float* kmask,
                                          float* npm) {
  const int n = blockIdx.x, H = a.H, L = a.L;
  init_masks(a, n, kmask, npm);
  const LayerSmem s = layer_layout(smem, H);
  const Drop dr = make_drop(a, n);
  self_cross_fwd(a, s, n, dr, kmask, npm, false);
  if (a.r2 != nullptr) copy_rows(s.xb, s.ldb, a.r2 + (size_t)n * a.Lp * H, L, a.Lp, H);

  const float* bo2 = a.bo2;
  const float* npm_p = npm;
  void* out = a.out;
  const bool out_bf16 = a.out_bf16 != 0;
  ffn_rows(s, H, a.I, (L + 15) / 16, a.wi, a.bi, a.wo2, [=](int i, int j, float v) {
    if (i < L) {
      const float dd = dr.hidden(v + bo2[j], SITE_FFN_DOWN, i, j);
      const float t2 = dr.hidden(dd + s.xf[i * H + j], SITE_FFN_FINAL, i, j);
      const float y = t2 * npm_p[i];
      const size_t o = ((size_t)n * L + i) * H + j;
      if (out_bf16)
        static_cast<bf16*>(out)[o] = __float2bfloat16(y);
      else
        static_cast<float*>(out)[o] = y;
    }
  });
}

// One block of NT threads per sequence.
template <typename Kernel>
int launch_rows(Kernel kernel, const TrainArgs* args, size_t smem, void* stream) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<args->n, NT, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace
