// The decoder layer of the training step: forward (K11), FFN backward
// (K12a), attention backward by recompute (K12b), and the weight-gradient
// reduction, as four kernels.
//
// Replaces: navc_tpu/ops/fused_layer_train.py — pallas_call at :411
// (_fwd_kernel :218 with _self_cross_fwd :187), :447 (_ffn_bwd_kernel :241)
// and :499 (_attn_bwd_kernel :286). The rounding points are the JAX
// kernels': every product takes bf16 operands and sums in float32; biases,
// softmax, residuals and bias gradients stay float32. Dropout masks are the
// JAX kernels' counter hash (murmur3 fmix over (seed, tile, site, row,
// column)) on the JAX lattice — sequence s, position j is row (s % 8) *
// round_up(L, 8) + j of tile s / 8 — so forward and backward, and the
// port's plain versions, see the same masks bit for bit.
//
// What bounds them on the H100: per sequence of L = 30 rows at H = 512,
// FFN 2048, the forward does ~0.3 GFLOP of matmuls against ~8 MB of bf16
// weights (in L2) and the backward twice that with the recompute; the
// weight-gradient products are 16 GFLOP per call at B = 64. All are
// bound by the tensor cores at B = 64 (the bytes are ~40 MB of operands),
// and these simple kernels reach a few percent of that: the per-sequence
// kernels stream weight fragments from L2 for 32 rows per block, as K1.
//
// Design: K11 is K1's one-block-per-sequence layer (csrc/fused_layer.cu;
// the shared-memory layout, row GEMM, per-head softmax and FFN are
// layer_common.cuh's, shared by both, and so is K11's own forward,
// self_cross_fwd and layer_fwd, which K1u runs at p = 0) with the self and cross K/V
// projected in the kernel from the
// post-embedding rows and enc, dropout in the epilogues, and r2 written out
// (bf16, rows padded to a multiple of 16). K12b runs the same device
// function (self_cross_fwd) to recompute the forward, so its probabilities
// and contexts are K11's bit for bit; it saves Q/K/V of both attentions to a
// per-sequence global scratch (L2-resident) and then walks the backward
// with one warp per head. The TPU kernels accumulate the 20 weight
// gradients across their sequential grid; CUDA blocks run in parallel, so
// K12a/K12b write each product's per-row operands (bf16, zero rows past L)
// and per-sequence float32 column sums of each bias operand, and
// train_wgrad_kernel forms every dW = P^T Q over all rows (64x64 output
// tiles, rows in a fixed order) and every bias gradient (sequences in
// order): deterministic, no atomics.
// Not yet done (later work): wgmma/TMA, several sequences per block,
// staging the reduction's operands in shared memory.

#include "layer_common.cuh"

// Mirrored by _ProductArgs / _WgradArgs.
struct ProductArgs {
  const bf16* P;      // (R, M)
  const bf16* Q;      // (R, K)
  float* C;           // (M, K) = P^T Q
  const float* part;  // (N, M)
  float* db;          // (M,) = sum over N of part
  int R, M, K, N;
};
constexpr int MAX_PRODUCTS = 8;
struct WgradArgs {
  ProductArgs prod[MAX_PRODUCTS];
  int count;
};

namespace {

__device__ __forceinline__ float gelu_new_grad(float a) {
  const float u = SQRT_2_OVER_PI * (a + 0.044715f * a * a * a);
  const float th = tanhf(u);
  const float du = SQRT_2_OVER_PI * (1.f + 0.134145f * a * a);
  return 0.5f * (1.f + th) + 0.5f * a * (1.f - th * th) * du;
}

// K11
__global__ void __launch_bounds__(NT, 1) train_fwd_kernel(const TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float kmask[MR], npm[MR];
  layer_fwd(a, smem, kmask, npm);
}

// K12a: the FFN backward for one sequence. dt = drop_final(dy * npm),
// dd = drop_down(dt); per FFN chunk: a = r2 Wi^T + bi (recomputed), g =
// gelu(a), da = (dd Wo2) * gelu'(a); dr2 = dt + da Wi accumulates in
// registers. Writes g, da, dd as operand rows and their bias column sums.
__host__ __device__ inline size_t ffn_smem(int H) {
  return 2 * tile_bytes(H) + (size_t)MR * FFN_CH * sizeof(float) +
         ((size_t)MR * (FFN_CH + 8) * sizeof(bf16) + 127) / 128 * 128 +
         (size_t)NW * 256 * sizeof(float);
}

__global__ void __launch_bounds__(NT, 1) train_ffn_bwd_kernel(const TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float kmask[MR], npm[MR];
  const int n = blockIdx.x, H = a.H, L = a.L, I = a.I;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_masks(a, n, kmask, npm);
  const Drop dr = make_drop(a, n);
  const int ldb = H + 8, ldd = FFN_CH + 8, mt = (L + 15) / 16, ctw = H / 16 / NW;
  const size_t tb = tile_bytes(H);
  bf16* r2b = reinterpret_cast<bf16*>(smem);
  bf16* ddb = reinterpret_cast<bf16*>(smem + tb);
  float* af = reinterpret_cast<float*>(smem + 2 * tb);
  bf16* dab = reinterpret_cast<bf16*>(smem + 2 * tb + (size_t)MR * FFN_CH * sizeof(float));
  float* stg = reinterpret_cast<float*>(smem + ffn_smem(H) - (size_t)NW * 256 * sizeof(float)) +
               warp * 256;
  const size_t drow = (size_t)n * a.Lp;
  bf16* ws_g = a.ws[WS_G];
  bf16* ws_da = a.ws[WS_DA];

  for (int c = threadIdx.x; c < H; c += NT) {
    float sum = 0.f;
    for (int i = 0; i < MR; ++i) {
      float dd = 0.f;
      if (i < L) {
        const float dt = dr.hidden(a.dy[((size_t)n * L + i) * H + c] * npm[i], SITE_FFN_FINAL, i, c);
        dd = dr.hidden(dt, SITE_FFN_DOWN, i, c);
        sum += dd;
      }
      ddb[i * ldb + c] = __float2bfloat16(dd);
      if (i < a.Lp) a.ws[WS_DD][(drow + i) * H + c] = __float2bfloat16(dd);
      r2b[i * ldb + c] = i < a.Lp ? a.r2[(drow + i) * H + c] : __float2bfloat16(0.f);
    }
    a.part[P_BO2][(size_t)n * H + c] = sum;
  }
  __syncthreads();

  Acc acc[2][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[rt][t], 0.f);
  for (int c0 = 0; c0 < I; c0 += FFN_CH) {
    const int cw = min(FFN_CH, I - c0);
    const float* bi = a.bi + c0;
    const int Lp = a.Lp;
    gemm_rows<false>(r2b, ldb, mt, a.wi + (size_t)c0 * H, H, cw, H, stg, [=](int i, int j, float v) {
      const float av = v + bi[j];
      af[i * FFN_CH + j] = av;
      if (i < Lp) ws_g[(drow + i) * I + c0 + j] = __float2bfloat16(i < L ? gelu_new(av) : 0.f);
    });
    __syncthreads();
    gemm_rows<true>(ddb, ldb, mt, a.wo2 + c0, I, cw, H, stg, [=](int i, int j, float v) {
      const float da = i < L ? v * gelu_new_grad(af[i * FFN_CH + j]) : 0.f;
      af[i * FFN_CH + j] = da;
      dab[i * ldd + j] = __float2bfloat16(da);
      if (i < Lp) ws_da[(drow + i) * I + c0 + j] = __float2bfloat16(da);
    });
    __syncthreads();
    for (int j = threadIdx.x; j < cw; j += NT) {
      float sum = 0.f;
      for (int i = 0; i < L; ++i) sum += af[i * FFN_CH + j];
      a.part[P_BI][(size_t)n * I + c0 + j] = sum;
    }
    for (int k = 0; k < cw; k += 16) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < ctw) {
          const int ct = warp + NW * t;
          BRow b;
          wmma::load_matrix_sync(b, a.wi + (size_t)(c0 + k) * H + ct * 16, H);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            if (rt < mt) {
              ARow fa;
              wmma::load_matrix_sync(fa, dab + rt * 16 * ldd + k, ldd);
              wmma::mma_sync(acc[rt][t], fa, b, acc[rt][t]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // dr2 = dt + da Wi
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < ctw) {
      const int ct = warp + NW * t;
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        if (rt < mt) {
          wmma::store_matrix_sync(stg, acc[rt][t], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int i = rt * 16 + e / 16, j = ct * 16 + e % 16;
            if (i < L) {
              const size_t o = ((size_t)n * L + i) * H + j;
              const float dt = dr.hidden(a.dy[o] * npm[i], SITE_FFN_FINAL, i, j);
              a.dr2[o] = dt + stg[e];
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

// K12b: the attention backward for one sequence, recomputing the forward
// with K11's device code.
struct HeadOut {
  bf16 *dq, *dk, *dv;      // operand rows of this sequence (ld H)
  float *pq, *pk, *pv;     // their bias column sums (H,)
  int q_valid, k_valid;    // rows past these are written as zero
};

// A 16x16 float32 tile of an attention gradient: bf16 into out rows
// row0.., columns col.. (zero past `valid`), and its column sums into colsum
// (lanes 0-15), rows in order.
__device__ void emit_tile(const Acc& acc, float* stg, bf16* out, int H, int row0, int col,
                          int valid, float& colsum) {
  const int lane = threadIdx.x & 31;
  wmma::store_matrix_sync(stg, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int r = row0 + e / 16;
    out[(size_t)r * H + col + e % 16] = __float2bfloat16(r < valid ? stg[e] : 0.f);
  }
  if (lane < 16)
    for (int r = 0; r < 16; ++r)
      if (row0 + r < valid) colsum += stg[r * 16 + lane];
  __syncwarp();
}

// One warp per head: recompute P, then dV = P^T dC, dP = dC V^T,
// dS = (dP - rowsum(dP * P)) * P * scale, dQ = dS K, dK = dS^T Q.
template <typename Masked>
__device__ void attn_bwd_heads(const bf16* Q, const bf16* K, const bf16* V, int ld,
                               const bf16* dcb, int ldb, int H, int n_head, int mtq, int mtk,
                               float scale, Masked masked, unsigned char* wscr, float* stg_all,
                               const HeadOut o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = H / n_head, nk = mtk * 16;
  float* sreg = reinterpret_cast<float*>(wscr + warp * (SREG + MR * 32 * sizeof(bf16)));
  bf16* pb = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sreg) + SREG);
  float* stg = stg_all + warp * 256;
  for (int hd = warp; hd < n_head; hd += NW) {
    const int c0 = hd * d;
    float p[32];
    head_probs(Q, ld, K, ld, c0, d, mtq, mtk, scale, masked, sreg, p);
    const bool live = lane < mtq * 16;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      pb[lane * 32 + j] = __float2bfloat16(live && j < nk ? p[j] : 0.f);
    __syncwarp();

    for (int dt = 0; dt < d / 16; ++dt) {  // dV = P^T dC
      float colsum = 0.f;
      for (int kt = 0; kt < mtk; ++kt) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
        for (int qt = 0; qt < mtq; ++qt) {
          ACol a;
          BRow b;
          wmma::load_matrix_sync(a, pb + qt * 16 * 32 + kt * 16, 32);
          wmma::load_matrix_sync(b, dcb + qt * 16 * ldb + c0 + dt * 16, ldb);
          wmma::mma_sync(acc, a, b, acc);
        }
        emit_tile(acc, stg, o.dv, H, kt * 16, c0 + dt * 16, o.k_valid, colsum);
      }
      if (lane < 16) o.pv[c0 + dt * 16 + lane] = colsum;
    }

    for (int qt = 0; qt < mtq; ++qt)  // dP = dC V^T
      for (int kt = 0; kt < mtk; ++kt) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k = 0; k < d; k += 16) {
          ARow a;
          BCol b;
          wmma::load_matrix_sync(a, dcb + qt * 16 * ldb + c0 + k, ldb);
          wmma::load_matrix_sync(b, V + (size_t)kt * 16 * ld + c0 + k, ld);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(sreg + qt * 16 * 32 + kt * 16, acc, 32, wmma::mem_row_major);
      }
    __syncwarp();
    if (live) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < nk) rs += sreg[lane * 32 + j] * p[j];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        pb[lane * 32 + j] =
            __float2bfloat16(j < nk ? (sreg[lane * 32 + j] - rs) * p[j] * scale : 0.f);
    }
    __syncwarp();

    for (int dt = 0; dt < d / 16; ++dt) {  // dQ = dS K
      float colsum = 0.f;
      for (int qt = 0; qt < mtq; ++qt) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kt = 0; kt < mtk; ++kt) {
          ARow a;
          BRow b;
          wmma::load_matrix_sync(a, pb + qt * 16 * 32 + kt * 16, 32);
          wmma::load_matrix_sync(b, K + (size_t)kt * 16 * ld + c0 + dt * 16, ld);
          wmma::mma_sync(acc, a, b, acc);
        }
        emit_tile(acc, stg, o.dq, H, qt * 16, c0 + dt * 16, o.q_valid, colsum);
      }
      if (lane < 16) o.pq[c0 + dt * 16 + lane] = colsum;
    }
    for (int dt = 0; dt < d / 16; ++dt) {  // dK = dS^T Q
      float colsum = 0.f;
      for (int kt = 0; kt < mtk; ++kt) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
        for (int qt = 0; qt < mtq; ++qt) {
          ACol a;
          BRow b;
          wmma::load_matrix_sync(a, pb + qt * 16 * 32 + kt * 16, 32);
          wmma::load_matrix_sync(b, Q + (size_t)qt * 16 * ld + c0 + dt * 16, ld);
          wmma::mma_sync(acc, a, b, acc);
        }
        emit_tile(acc, stg, o.dk, H, kt * 16, c0 + dt * 16, o.k_valid, colsum);
      }
      if (lane < 16) o.pk[c0 + dt * 16 + lane] = colsum;
    }
    __syncwarp();
  }
}

// Shared memory of K12b's backward phase (reuses the forward's):
// dr [MR][H] f32 (dr1, then dx), dcb [MR][ldb] bf16 (dC of one attention),
// per warp a 32x32 f32 slice and a 32x32 bf16 one, staging.
__host__ __device__ inline size_t bwd_smem(int H) {
  return (size_t)MR * H * sizeof(float) + tile_bytes(H) +
         (size_t)NW * (SREG + MR * 32 * sizeof(bf16)) + (size_t)NW * 256 * sizeof(float);
}

__host__ __device__ inline size_t attn_bwd_smem(int H) {
  return layer_smem_bytes(H) > bwd_smem(H) ? layer_smem_bytes(H) : bwd_smem(H);
}

// One pass over the columns of a (rows, H) gradient held in dr: y = dr *
// npm; the dropped-out y (site) goes to the operand rows `out` (zero past
// L) and its column sums to `psum`; dr keeps y. Column per thread, rows in
// order.
__device__ void output_grad(float* dr, const float* npm, const Drop& drop, int site, int L,
                            int Lp, int H, bf16* out, float* psum) {
  for (int c = threadIdx.x; c < H; c += NT) {
    float sum = 0.f;
    for (int i = 0; i < MR; ++i) {
      const float y = dr[i * H + c] * npm[i];
      const float o = drop.hidden(y, site, i, c);
      dr[i * H + c] = y;
      if (i < Lp) out[(size_t)i * H + c] = __float2bfloat16(i < L ? o : 0.f);
      if (i < L) sum += o;
    }
    psum[c] = sum;
  }
}

__global__ void __launch_bounds__(NT, 1) train_attn_bwd_kernel(const TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float kmask[MR], npm[MR];
  const int n = blockIdx.x, H = a.H, L = a.L, Le = a.Le, Lp = a.Lp;
  const int warp = threadIdx.x >> 5;
  init_masks(a, n, kmask, npm);
  const Drop dr = make_drop(a, n);
  self_cross_fwd(a, layer_layout(smem, H), n, dr, kmask, npm, true);

  const int ldb = H + 8, mt = (L + 15) / 16, mte = (Le + 15) / 16;
  float* g = reinterpret_cast<float*>(smem);  // dr1, then dx
  bf16* dcb = reinterpret_cast<bf16*>(smem + (size_t)MR * H * sizeof(float));
  unsigned char* wscr = smem + (size_t)MR * H * sizeof(float) + tile_bytes(H);
  float* stg_all = reinterpret_cast<float*>(wscr + (size_t)NW * (SREG + MR * 32 * sizeof(bf16)));
  float* stg = stg_all + warp * 256;
  const size_t drow = (size_t)n * Lp, erow = (size_t)n * a.Lep;
  auto ws = [&](int k, size_t row) { return a.ws[k] + row * H; };
  auto part = [&](int k) { return a.part[k] + (size_t)n * H; };
  float* denc = a.denc + (size_t)n * Le * H;

  // cross output: dr1 = dr2 * npm, do2 = drop(dr1)
  for (int idx = threadIdx.x; idx < MR * H; idx += NT) {
    const int i = idx / H, c = idx % H;
    g[idx] = i < L ? a.dr2[((size_t)n * L + i) * H + c] : 0.f;
  }
  __syncthreads();
  output_grad(g, npm, dr, SITE_CROSS_OUT, L, Lp, H, ws(WS_DO2, drow), part(P_BOC));
  __syncthreads();
  auto to_dcb = [=](int i, int j, float v) { dcb[i * ldb + j] = __float2bfloat16(v); };
  gemm_rows<true>(ws(WS_DO2, drow), H, mt, a.w[7], H, H, H, stg, to_dcb);
  __syncthreads();
  attn_bwd_heads(a.scr[S_Q2] + drow * H, a.scr[S_K2] + erow * H, a.scr[S_V2] + erow * H, H, dcb,
                 ldb, H, a.n_head, mt, mte, a.scale, [=](int, int j) { return j >= Le; }, wscr,
                 stg_all,
                 HeadOut{ws(WS_DQ2, drow), ws(WS_DK2, erow), ws(WS_DV2, erow), part(P_BQC),
                         part(P_BKC), part(P_BVC), L, Le});
  __syncthreads();
  auto add_g = [=](int i, int j, float v) { g[i * H + j] += v; };
  gemm_rows<true>(ws(WS_DQ2, drow), H, mt, a.w[4], H, H, H, stg, add_g);
  gemm_rows<true>(ws(WS_DK2, erow), H, mte, a.w[5], H, H, H, stg, [=](int i, int j, float v) {
    if (i < Le) denc[(size_t)i * H + j] = v;
  });
  __syncthreads();
  gemm_rows<true>(ws(WS_DV2, erow), H, mte, a.w[6], H, H, H, stg, [=](int i, int j, float v) {
    if (i < Le) denc[(size_t)i * H + j] += v;
  });
  __syncthreads();

  // self output: dx = dr1 * npm, do1 = drop(dx)
  output_grad(g, npm, dr, SITE_SELF_OUT, L, Lp, H, ws(WS_DO1, drow), part(P_BOS));
  __syncthreads();
  gemm_rows<true>(ws(WS_DO1, drow), H, mt, a.w[3], H, H, H, stg, to_dcb);
  __syncthreads();
  const bool causal = a.causal != 0;
  attn_bwd_heads(a.scr[S_Q1] + drow * H, a.scr[S_K1] + drow * H, a.scr[S_V1] + drow * H, H, dcb,
                 ldb, H, a.n_head, mt, mt, a.scale,
                 [=](int i, int j) { return kmask[j] > 0.5f || (causal && j > i); }, wscr,
                 stg_all,
                 HeadOut{ws(WS_DQ1, drow), ws(WS_DK1, drow), ws(WS_DV1, drow), part(P_BQS),
                         part(P_BKS), part(P_BVS), L, L});
  __syncthreads();
  gemm_rows<true>(ws(WS_DQ1, drow), H, mt, a.w[0], H, H, H, stg, add_g);
  __syncthreads();
  gemm_rows<true>(ws(WS_DK1, drow), H, mt, a.w[1], H, H, H, stg, add_g);
  __syncthreads();
  gemm_rows<true>(ws(WS_DV1, drow), H, mt, a.w[2], H, H, H, stg, add_g);
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * H; idx += NT) {
    const int i = idx / H, c = idx % H;
    a.dx[((size_t)n * L + i) * H + c] = dr.input(g[idx], i, c);
  }
}

// Weight gradients: blocks of 4 warps; the first blocks take 64x64 output
// tiles of the products in turn (each warp a 32x32 quarter, the rows in
// order, fragments loaded straight from the operand rows), the rest the
// bias sums, 128 columns each.
constexpr int WG_NT = 128;

__device__ int wgrad_tiles(const ProductArgs& g) { return ((g.M + 63) / 64) * ((g.K + 63) / 64); }

__global__ void __launch_bounds__(WG_NT) train_wgrad_kernel(const WgradArgs a) {
  int blk = blockIdx.x;
  for (int p = 0; p < a.count; ++p) {
    const ProductArgs& g = a.prod[p];
    const int tiles = wgrad_tiles(g);
    if (blk < tiles) {
      const int tk = (g.K + 63) / 64, warp = threadIdx.x >> 5;
      const int m0 = (blk / tk) * 64 + (warp >> 1) * 32, k0 = (blk % tk) * 64 + (warp & 1) * 32;
      if (m0 >= g.M || k0 >= g.K) return;
      Acc acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int r = 0; r < g.R; r += 16) {
        ACol fa[2];
        BRow fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(fa[i], g.P + (size_t)r * g.M + m0 + i * 16, g.M);
          wmma::load_matrix_sync(fb[i], g.Q + (size_t)r * g.K + k0 + i * 16, g.K);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(g.C + (size_t)(m0 + i * 16) * g.K + k0 + j * 16, acc[i][j], g.K,
                                  wmma::mem_row_major);
      return;
    }
    blk -= tiles;
  }
  for (int p = 0; p < a.count; ++p) {
    const ProductArgs& g = a.prod[p];
    const int blocks = (g.M + WG_NT - 1) / WG_NT;
    if (blk < blocks) {
      const int c = blk * WG_NT + threadIdx.x;
      if (c < g.M) {
        float sum = 0.f;
        for (int s = 0; s < g.N; ++s) sum += g.part[(size_t)s * g.M + c];
        g.db[c] = sum;
      }
      return;
    }
    blk -= blocks;
  }
}

}  // namespace

NAVC_EXPORT int navc_train_fwd(const TrainArgs* args, void* stream) {
  return launch_rows(train_fwd_kernel, args, layer_smem_bytes(args->H), stream);
}

NAVC_EXPORT int navc_train_ffn_bwd(const TrainArgs* args, void* stream) {
  return launch_rows(train_ffn_bwd_kernel, args, ffn_smem(args->H), stream);
}

NAVC_EXPORT int navc_train_attn_bwd(const TrainArgs* args, void* stream) {
  return launch_rows(train_attn_bwd_kernel, args, attn_bwd_smem(args->H), stream);
}

NAVC_EXPORT int navc_train_wgrad(const WgradArgs* args, void* stream) {
  int blocks = 0;
  for (int p = 0; p < args->count; ++p) {
    const ProductArgs& g = args->prod[p];
    blocks += ((g.M + 63) / 64) * ((g.K + 63) / 64) + (g.M + WG_NT - 1) / WG_NT;
  }
  train_wgrad_kernel<<<blocks, WG_NT, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
