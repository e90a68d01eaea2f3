// Device code shared by the layer kernels of fused_layer.cu (K1, K2: the
// eval layer of the NAR decode) and fused_layer_train.cu (K11, K12a, K12b:
// the training layer, and K1u, K11 at p = 0). Their attention launches run
// a block of NT threads per sequence of at most MR rows, copy the
// sequence's Q/K/V rows into the shared-memory layout below and take the
// per-head softmax (`attend`, bf16 wmma 16x16x16 fragments accumulating in
// float32), so every kernel's attention does the same arithmetic in the same
// order. Then the training layer's arguments and its hash dropout.
#pragma once

#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int MR = 32;             // rows held per block (queries and keys)
constexpr int SREG = MR * 32 * 4;  // per-warp 32x32 float32 score slice, bytes
constexpr float MASK_FILL = -10e6f;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

// Shared memory of an attention launch.
struct LayerSmem {
  bf16* xb;    // the warps' score slices
  bf16* qb;    // [MR][ldb] queries, then attention context
  bf16* kb;    // [MR][ldb] keys
  bf16* vb;    // [MR][ldb] values
  float* stg;  // [NW][256] per-warp accumulator staging
  int ldb;
};

// One bf16 tile of the layout: MR rows of H or the warps' score slices,
// whichever is larger.
__host__ __device__ inline size_t tile_bytes(int H) {
  const size_t a = (size_t)MR * (H + 8) * sizeof(bf16);
  const size_t b = (size_t)NW * SREG;
  return ((a > b ? a : b) + 127) / 128 * 128;
}

__device__ __forceinline__ float gelu_new(float x) {
  return 0.5f * x * (1.f + tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x * x * x)));
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

// rows x H bf16 from global src (ld H) into shared dst (ld ldb), 16 bytes a
// thread, zero from row `valid` on.
__device__ void load_rows(const bf16* src, bf16* dst, int ldb, int valid, int rows, int H) {
  const int per = H / 8;
  for (int idx = threadIdx.x; idx < rows * per; idx += NT) {
    const int r = idx / per, c = (idx % per) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldb + c) =
        r < valid ? *reinterpret_cast<const uint4*>(src + (size_t)r * H + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// rows x H bf16 from shared src (ld lds) to global dst (ld H), 16 bytes a
// thread, zero from row `valid` on.
__device__ void copy_rows(const bf16* src, int lds, bf16* dst, int valid, int rows, int H) {
  const int per = H / 8;
  for (int idx = threadIdx.x; idx < rows * per; idx += NT) {
    const int r = idx / per, c = (idx % per) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * H + c) =
        r < valid ? *reinterpret_cast<const uint4*>(src + r * lds + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
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

}  // namespace

// ---------------------------------------------------------------------------
// The training layer's arguments and hash dropout (fused_layer_train.cu).
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
  const int* seed;          // (1,) the dropout stream's seed, read on the card
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
  bf16* scr[6];             // K11 / K12b scratch: Q/K/V of both attentions, S_*
  int out_bf16, n, L, Le, H, I, n_head, causal, Lp, Lep, on_hidden, on_input;
  unsigned th_hidden, th_input;
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
  d.seed = (unsigned)__ldg(a.seed);
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

__device__ void init_masks(const TrainArgs& a, int n, float* kmask, float* npm) {
  if (threadIdx.x < MR) {
    const int j = threadIdx.x;
    kmask[j] = (j < a.L) ? (a.kp[(size_t)n * a.L + j] ? 1.f : 0.f) : 1.f;
    npm[j] = (j < a.L) ? 1.f - kmask[j] : 0.f;
  }
  __syncthreads();
}

}  // namespace
