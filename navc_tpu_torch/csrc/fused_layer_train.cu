// The decoder layer of the training step: forward (K11), FFN backward
// (K12a), attention backward by recompute (K12b), and the weight-gradient
// reduction, as four kernels.
//
// Replaces: navc_tpu/ops/fused_layer_train.py — pallas_call at :411
// (_fwd_kernel :218, its attention forward :187), :447 (_ffn_bwd_kernel :241)
// and :499 (_attn_bwd_kernel :286). The rounding points are the JAX
// kernels': every product takes bf16 operands and sums in float32; biases,
// softmax, residuals and bias gradients stay float32. Dropout masks are the
// JAX kernels' counter hash (murmur3 fmix over (seed, tile, site, row,
// column)) on the JAX lattice — sequence s, position j is row (s % 8) *
// round_up(L, 8) + j of tile s / 8 — so forward and backward, and the
// port's plain versions, see the same masks bit for bit. The seed is a (1,)
// int32 on the card (TrainArgs::seed, the JAX kernels' seed_ref operand),
// read by each thread that draws a mask: a captured launch reads the value
// the stream left there, so a replayed step draws fresh masks.
//
// What bounds them on the H100: the products. Per sequence of L = 30 rows
// at H = 512, FFN 2048, the forward does ~0.25 GFLOP of matmuls against ~8
// MB of bf16 weights (in L2) and the backward twice that with the
// recompute: at B = 2048, over every padded row, K11 ~0.52 TFLOP, K12a
// ~0.41 and K12b ~0.53, 0.4-0.55 ms each at the bf16 tensor-core rate.
//
// Design: K11, K12a and K12b multiply all N * Lp decoder rows (and the N *
// Lep encoder rows) at once on the row walk (row_gemm.cuh: TMA, an mbarrier
// ring, wgmma; each weight tile feeds 64 or 128 rows), each as a sequence of
// launches from one C entry: an elementwise pass (row_prep_kernel); the
// products, whose epilogues add the biases, apply gelu and its derivative,
// the residuals times npm and the hash dropout of each site on the JAX
// lattice (flat row r is position r % Lp of sequence r / Lp), and sum each
// sequence's bias columns; and the per-(sequence, head) attention
// (row_attn_kernel, a block per sequence on layer_common.cuh's `attend`;
// the backward one warp per head). K11's residual stream stays float32 in
// a scratch of N * Lp rows beside the bf16 operand rows of each product;
// only out and r2 outlive the call. K12b recomputes only the forward its
// backward reads (the same launches as K11's up to Q2, then the cross
// context): Q/K/V of both attentions (to a global scratch), the contexts
// and r1, not the cross-attention output. K1u, the eval layer on embedded
// rows (navc_tpu/ops/fused_layer.py, pallas_call at :303, body _kernel
// :133), is K11 at p = p_input = 0: navc_fused_layer_unfolded (below)
// issues K11's launches with both dropout sites off. The TPU
// kernels accumulate the 20 weight gradients across their sequential grid;
// CUDA blocks run in parallel, so K12a/K12b write each product's per-row
// operands (bf16, zero rows past L) and per-sequence float32 column sums of
// each bias operand, and train_wgrad_kernel (below) forms every dW = P^T Q
// over all rows and every bias gradient: deterministic, no atomics.
//
// The reduction, train_wgrad_kernel: replaces the accumulation of the
// weight and bias gradients across the grid in
// navc_tpu/ops/fused_layer_train.py (FFN :267-281, pallas_call :447;
// attention :348-362, pallas_call :499). What bounds it on the H100: the
// products, 2 x M x K x R FLOPs over each product's operands (R = B x 32
// rows, read once). At B = 2048 (R = 65536) a backward pass holds ~515
// GFLOP against ~1.2 GB of operands: 0.52 ms at the bf16 tensor-core rate,
// 0.36 ms at the HBM rate. Design: a block takes one 128 x 128 output tile
// of one product (128 tiles per call at H 512 / FFN 2048: one wave on the
// 132 SMs, every tile walking the rows in step, so L2 serves the reuse and
// each operand leaves HBM about once). P (R, M) and Q (R, K) both have the
// rows outermost, so they are MN-major wgmma operands, read as stored
// through the transpose bits: a producer warp streams 64-row chunks of
// both (two 64 x 64 TMA boxes of P, two of Q, 128-byte swizzle; 32 KB a
// stage, 6 stages) through a full/empty mbarrier ring, and two consumer
// warpgroups each multiply their 64 rows of M by all 128 columns of K
// (m64n128k16, float32 accumulators in registers), freeing each stage once
// its products are done. TMA zero-fills the ragged last chunk of rows and
// the M and K edges of a tile; the epilogue stores by index. The rows are
// summed in a fixed order per tile; the bias gradients are further blocks,
// a thread per column summing the sequences in order.

#include "layer_common.cuh"
#include "row_gemm.cuh"

// Mirrored by _ProductArgs / _WgradArgs; the blocks are planned by
// ops/fused_layer_train.py wgrad_plan.
struct ProductArgs {
  const bf16* P;      // (R, M)
  const bf16* Q;      // (R, K)
  float* C;           // (M, K) = P^T Q
  const float* part;  // (N, M)
  float* db;          // (M,) = sum over N of part
  int R, M, K, N;
  int tile0;          // first block of its output tiles (row-major over the tile grid)
  int bias0;          // first block of its bias sums
};
constexpr int MAX_PRODUCTS = 8;
struct WgradArgs {
  ProductArgs prod[MAX_PRODUCTS];
  int count, blocks;
};
// The TMA maps of each product's P and Q, encoded by navc_train_wgrad.
struct WgradMaps {
  CUtensorMap p[MAX_PRODUCTS], q[MAX_PRODUCTS];
};

namespace {

__device__ __forceinline__ float gelu_new_grad(float a) {
  const float u = SQRT_2_OVER_PI * (a + 0.044715f * a * a * a);
  const float th = tanhf(u);
  const float du = SQRT_2_OVER_PI * (1.f + 0.134145f * a * a);
  return 0.5f * (1.f + th) + 0.5f * a * (1.f - th * th) * du;
}

// K12b's per-head backward: the gradients of one sequence's attention.
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

// K11, K12a and K12b on the row walk (row_gemm.cuh). Their phases, each a
// launch on the caller's stream: an elementwise pass, then products over
// the flattened rows whose epilogues do the per-element work of the layer,
// and the per-(sequence, head) attention between them.

// The elementwise first phase, a thread per (sequence, column), rows in
// order. PREP_FFN (K12a): dd = drop_down(drop_final(dy * npm)) as WS_DD
// rows and P_BO2. PREP_ATTN (K12b): x' = drop_input(x) as WS_X rows, do2 =
// drop_cross(dr2 * npm) as WS_DO2 rows and P_BOC, enc as WS_ENC rows.
// PREP_FWD (K11): x' and enc only.
enum { PREP_FFN, PREP_ATTN, PREP_FWD };

__global__ void __launch_bounds__(128) row_prep_kernel(const TrainArgs a, int mode) {
  const int n = blockIdx.x, c = blockIdx.y * 128 + threadIdx.x, H = a.H, L = a.L;
  if (c >= H) return;
  const Drop dr = make_drop(a, n);
  const size_t drow = (size_t)n * a.Lp;
  float sum = 0.f;
  for (int i = 0; i < a.Lp; ++i) {
    float o = 0.f, xo = 0.f;
    if (i < L) {
      const size_t idx = ((size_t)n * L + i) * H + c;
      const float npm = a.kp[(size_t)n * L + i] ? 0.f : 1.f;
      if (mode == PREP_FFN) {
        o = dr.hidden(dr.hidden(a.dy[idx] * npm, SITE_FFN_FINAL, i, c), SITE_FFN_DOWN, i, c);
      } else {
        xo = dr.input(a.x[idx], i, c);
        if (mode == PREP_ATTN) o = dr.hidden(a.dr2[idx] * npm, SITE_CROSS_OUT, i, c);
      }
      sum += o;
    }
    const size_t at = (drow + i) * H + c;
    if (mode == PREP_FFN) {
      a.ws[WS_DD][at] = __float2bfloat16(o);
    } else {
      a.ws[WS_X][at] = __float2bfloat16(xo);
      if (mode == PREP_ATTN) a.ws[WS_DO2][at] = __float2bfloat16(o);
    }
  }
  if (mode != PREP_FWD) a.part[mode == PREP_ATTN ? P_BOC : P_BO2][(size_t)n * H + c] = sum;
  if (mode != PREP_FFN)
    for (int i = 0; i < a.Lep; ++i)
      a.ws[WS_ENC][((size_t)n * a.Lep + i) * H + c] =
          __float2bfloat16(i < a.Le ? a.enc[((size_t)n * a.Le + i) * H + c] : 0.f);
}

// What a product's epilogue does with its float32 tile (pairs of columns c,
// c + 1 of row r, position i of sequence n; `live`: i < valid):
//  E_BF16   + the group's bias (if any), bf16 into out[group]
//  E_RESID  r1 = (drop_self(v + bo_s) + drop_input(x)) * npm, bf16 (WS_R1)
//           and, given outf, float32 into outf
//  E_R2     r2 = (drop_cross(v + bo_c) + r1) * npm, r1 read from outf: bf16
//           into out[0] (r2), float32 into outf in place
//  E_GELU   gelu_new(v + bi), bf16
//  E_OUT    out = drop_final(drop_down(v + bo2) + r2) * npm, r2 read from
//           outf, into a.out (N, L, H) in its dtype
//  E_DR1    y = (dr2 * npm + v) * npm into dx (float32, kept for E_DX);
//           do1 = drop_self(y), bf16 (WS_DO1), and its column sums (P_BOS)
//  E_DENC   into denc, float32
//  E_DX     dx = drop_input(dx + v)
//  E_FFN1   (DUAL) a = v0 + bi: gelu_new(a) (WS_G), da = v1 gelu'(a) (WS_DA),
//           and da's column sums (P_BI)
//  E_DR2    dr2 = drop_final(dy * npm) + v
enum { E_BF16, E_RESID, E_DR1, E_DENC, E_DX, E_FFN1, E_DR2, E_R2, E_GELU, E_OUT };

template <int BN, int BT, int EPI, int WG>
__global__ void __launch_bounds__(rg_threads(WG))
row_gemm_kernel(const __grid_constant__ TrainArgs a, const __grid_constant__ RowGemm g,
                const __grid_constant__ RowMaps m) {
  constexpr bool DUAL = EPI == E_FFN1, SUMS = EPI == E_DR1 || EPI == E_FFN1;
  constexpr bool NPM = EPI == E_RESID || EPI == E_DR1 || EPI == E_DR2 || EPI == E_R2 ||
                       EPI == E_OUT;  // decoder rows only
  constexpr int CONSUMERS = 128 * WG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = rg_ring(smem_raw);
  const int grp = blockIdx.x / g.tiles, c0 = (blockIdx.x % g.tiles) * BN;
  const int row0 = blockIdx.y * WG * RG_BM;
  float acc0[BN / 2], acc1[BN / 2];
  if (!rg_tile<BN, BT, DUAL, WG>(m, g, ring, grp, c0, row0, acc0, acc1)) return;

  // acc[4j + 2h + e]: row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
  const int lane = threadIdx.x & 31;
  const int rl = (threadIdx.x >> 5) * 16 + (lane >> 2);
  float* stg = reinterpret_cast<float*>(ring);  // column-sum staging, ld BN + 1
  if constexpr (SUMS) named_barrier(1, CONSUMERS);  // every warp's products have read the ring
  const int H = a.H, L = a.L;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rl + 8 * h;
    const int n = r / g.seq_rows, i = r % g.seq_rows;
    const bool in = r < g.rows, live = in && i < g.valid;
    const Drop dr = make_drop(a, n);
    const float npm = NPM && live && !a.kp[(size_t)n * L + i] ? 1.f : 0.f;
    const size_t drow = ((size_t)n * L + i) * H;  // the row of an (N, L, H) tensor
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + 2 * (lane & 3), c = c0 + cl;
      float v[2] = {acc0[4 * j + 2 * h], acc0[4 * j + 2 * h + 1]};
      float s[2] = {0.f, 0.f};
      if (in && c < g.cols) {  // cols is a multiple of 32: a pair is in or out whole
        const size_t o = (size_t)r * g.cols + c;
        if constexpr (EPI == E_BF16) {
          const float* b = g.bias[grp];
          *reinterpret_cast<__nv_bfloat162*>(g.out[grp] + o) =
              __floats2bfloat162_rn(v[0] + (b ? b[c] : 0.f), v[1] + (b ? b[c + 1] : 0.f));
        } else if constexpr (EPI == E_RESID) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = live ? (dr.hidden(v[e] + g.bias[0][c + e], SITE_SELF_OUT, i, c + e) +
                           dr.input(a.x[drow + c + e], i, c + e)) * npm
                        : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(g.out[0] + o) = __floats2bfloat162_rn(v[0], v[1]);
          if (g.outf) *reinterpret_cast<float2*>(g.outf + o) = make_float2(v[0], v[1]);
        } else if constexpr (EPI == E_R2) {
          const float2 r1 = *reinterpret_cast<const float2*>(g.outf + o);
          const float r1v[2] = {r1.x, r1.y};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = live ? (dr.hidden(v[e] + g.bias[0][c + e], SITE_CROSS_OUT, i, c + e) +
                           r1v[e]) * npm
                        : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(g.out[0] + o) = __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<float2*>(g.outf + o) = make_float2(v[0], v[1]);
        } else if constexpr (EPI == E_GELU) {
          float gl[2] = {0.f, 0.f};
          if (live)
#pragma unroll
            for (int e = 0; e < 2; ++e) gl[e] = gelu_new(v[e] + g.bias[0][c + e]);
          *reinterpret_cast<__nv_bfloat162*>(g.out[0] + o) = __floats2bfloat162_rn(gl[0], gl[1]);
        } else if constexpr (EPI == E_OUT) {
          if (live) {
            const float2 r2 = *reinterpret_cast<const float2*>(g.outf + o);
            const float r2v[2] = {r2.x, r2.y};
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = dr.hidden(dr.hidden(v[e] + g.bias[0][c + e], SITE_FFN_DOWN, i, c + e) +
                                   r2v[e],
                               SITE_FFN_FINAL, i, c + e) * npm;
            if (a.out_bf16)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + drow + c) =
                  __floats2bfloat162_rn(v[0], v[1]);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(a.out) + drow + c) =
                  make_float2(v[0], v[1]);
          }
        } else if constexpr (EPI == E_DR1) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (live) {
              const float y = (a.dr2[drow + c + e] * npm + v[e]) * npm;
              a.dx[drow + c + e] = y;
              s[e] = dr.hidden(y, SITE_SELF_OUT, i, c + e);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(g.out[0] + o) = __floats2bfloat162_rn(s[0], s[1]);
        } else if constexpr (EPI == E_DENC) {
          if (live)
            *reinterpret_cast<float2*>(a.denc + ((size_t)n * a.Le + i) * H + c) =
                make_float2(v[0], v[1]);
        } else if constexpr (EPI == E_DX) {
          if (live)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              a.dx[drow + c + e] = dr.input(a.dx[drow + c + e] + v[e], i, c + e);
        } else if constexpr (EPI == E_FFN1) {
          float gl[2] = {0.f, 0.f};
          if (live)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float av = v[e] + g.bias[0][c + e];
              gl[e] = gelu_new(av);
              s[e] = acc1[4 * j + 2 * h + e] * gelu_new_grad(av);
            }
          *reinterpret_cast<__nv_bfloat162*>(g.out[0] + o) = __floats2bfloat162_rn(gl[0], gl[1]);
          *reinterpret_cast<__nv_bfloat162*>(g.out[1] + o) = __floats2bfloat162_rn(s[0], s[1]);
        } else if constexpr (EPI == E_DR2) {
          if (live)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              a.dr2[drow + c + e] =
                  dr.hidden(a.dy[drow + c + e] * npm, SITE_FFN_FINAL, i, c + e) + v[e];
        }
      }
      if constexpr (SUMS) {
        stg[(rl + 8 * h) * (BN + 1) + cl] = s[0];
        stg[(rl + 8 * h) * (BN + 1) + cl + 1] = s[1];
      }
    }
  }
  if constexpr (SUMS) {
    named_barrier(2, CONSUMERS);
    rg_column_sums<BN, WG>(stg, g, row0, c0);
  }
}

// The per-(sequence, head) attention of K11 and K12b, a block of NT threads
// per sequence, a warp per head, on the Q/K/V the products wrote (bf16,
// S_*), copied into shared memory first.
// ATT_SELF_FWD: the self-attention context (WS_C1) with `attend`;
// ATT_CROSS_FWD: the cross-attention context (WS_C2);
// ATT_CROSS: the cross-attention context, then its backward from dC2 (in
// dc) with attn_bwd_heads: dQ2, dK2, dV2 and their column sums;
// ATT_SELF_BWD: the self-attention backward from dC1 (in dc).
enum { ATT_SELF_FWD, ATT_CROSS_FWD, ATT_CROSS, ATT_SELF_BWD };

// Shared memory: Q, K, V and dC tiles (MR rows, ld H + 8), the backward's
// per-warp scratch (the forward's score slices alias it), staging.
constexpr size_t ATT_WSCR = (size_t)NW * (SREG + MR * 32 * sizeof(bf16));
__host__ __device__ inline size_t row_attn_smem(int H) {
  return 4 * tile_bytes(H) + ATT_WSCR + (size_t)NW * 256 * sizeof(float);
}

template <int MODE>
__global__ void __launch_bounds__(NT, 1) row_attn_kernel(const TrainArgs a, const bf16* dc) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float kmask[MR], npm[MR];
  const int n = blockIdx.x, H = a.H, L = a.L, Le = a.Le, Lp = a.Lp, Lep = a.Lep;
  init_masks(a, n, kmask, npm);
  const int mt = Lp / 16, mte = Lep / 16;
  const size_t drow = (size_t)n * Lp, erow = (size_t)n * Lep;
  const bool self = MODE == ATT_SELF_FWD || MODE == ATT_SELF_BWD, causal = a.causal != 0;
  auto self_masked = [=](int i, int j) { return kmask[j] > 0.5f || (causal && j > i); };
  auto cross_masked = [=](int, int j) { return j >= Le; };
  const bf16* Q = a.scr[self ? S_Q1 : S_Q2] + drow * H;
  const size_t kvrow = self ? drow : erow;
  const int mtk = self ? mt : mte;
  const size_t tb = tile_bytes(H);
  const int ldb = H + 8;
  bf16* qb = reinterpret_cast<bf16*>(smem);
  bf16* kb = reinterpret_cast<bf16*>(smem + tb);
  bf16* vb = reinterpret_cast<bf16*>(smem + 2 * tb);
  bf16* db = reinterpret_cast<bf16*>(smem + 3 * tb);
  unsigned char* wscr = smem + 4 * tb;
  float* stg_all = reinterpret_cast<float*>(wscr + ATT_WSCR);
  load_rows(Q, qb, ldb, Lp, Lp, H);
  load_rows(a.scr[self ? S_K1 : S_K2] + kvrow * H, kb, ldb, mtk * 16, mtk * 16, H);
  load_rows(a.scr[self ? S_V1 : S_V2] + kvrow * H, vb, ldb, mtk * 16, mtk * 16, H);
  if constexpr (MODE == ATT_SELF_BWD) load_rows(dc + drow * H, db, ldb, Lp, Lp, H);
  __syncthreads();
  if constexpr (MODE != ATT_SELF_BWD) {
    LayerSmem s;
    s.ldb = ldb;
    s.xb = reinterpret_cast<bf16*>(wscr);  // the warps' score slices
    s.qb = qb;
    s.kb = kb;
    s.vb = vb;
    s.stg = stg_all;
    if constexpr (MODE == ATT_SELF_FWD)
      attend(s, H, a.n_head, mt, mt, a.scale, self_masked);
    else
      attend(s, H, a.n_head, mt, mte, a.scale, cross_masked);
    __syncthreads();
    copy_rows(qb, ldb, a.ws[self ? WS_C1 : WS_C2] + drow * H, L, Lp, H);
    if constexpr (MODE == ATT_SELF_FWD || MODE == ATT_CROSS_FWD) return;
    __syncthreads();  // the context has left qb: Q and dC2 in
    load_rows(Q, qb, ldb, Lp, Lp, H);
    load_rows(dc + drow * H, db, ldb, Lp, Lp, H);
    __syncthreads();
  }
  auto ws = [&](int k, size_t row) { return a.ws[k] + row * H; };
  auto part = [&](int k) { return a.part[k] + (size_t)n * H; };
  if constexpr (MODE == ATT_CROSS)
    attn_bwd_heads(qb, kb, vb, ldb, db, ldb, H, a.n_head, mt, mte, a.scale, cross_masked, wscr,
                   stg_all,
                   HeadOut{ws(WS_DQ2, drow), ws(WS_DK2, erow), ws(WS_DV2, erow), part(P_BQC),
                           part(P_BKC), part(P_BVC), L, Le});
  else if constexpr (MODE == ATT_SELF_BWD)
    attn_bwd_heads(qb, kb, vb, ldb, db, ldb, H, a.n_head, mt, mt, a.scale, self_masked, wscr,
                   stg_all,
                   HeadOut{ws(WS_DQ1, drow), ws(WS_DK1, drow), ws(WS_DV1, drow), part(P_BQS),
                           part(P_BKS), part(P_BVS), L, L});
}

// Host: one product of the walk with epilogue EPI on the tile rg_plan
// picks for its rows and all its columns; A and B as rg_maps takes them.
template <int BN, int BT, int EPI, int WG>
int rg_tile_launch(const TrainArgs& a, const RowGemm& g, std::initializer_list<const bf16*> A,
                   std::initializer_list<const bf16*> B, cudaStream_t st) {
  constexpr bool DUAL = EPI == E_FFN1;
  return rg_launch<row_gemm_kernel<BN, BT, EPI, WG>, BN, DUAL, WG>(a, g, A, B, DUAL ? 0 : BT,
                                                                  DUAL ? 1 : BT, st);
}

template <int BT, int EPI>
int rg_run(const TrainArgs& a, const RowGemm& g, std::initializer_list<const bf16*> A,
           std::initializer_list<const bf16*> B, cudaStream_t st) {
  constexpr bool DUAL = EPI == E_FFN1;
  const RgTile t = rg_plan(g.rows, g.cols * g.groups, DUAL);
  if (t.wg == 2) return rg_tile_launch<DUAL ? 64 : 128, BT, EPI, 2>(a, g, A, B, st);
  if constexpr (!DUAL)
    if (t.bn == 128) return rg_tile_launch<128, BT, EPI, 1>(a, g, A, B, st);
  return rg_tile_launch<64, BT, EPI, 1>(a, g, A, B, st);
}

// Host: a product over the decoder rows (enc false) or the encoder rows.
RowGemm rg_rows(const TrainArgs& a, bool enc, int K, int nseg, int cols, int groups) {
  RowGemm g = {};
  g.seq_rows = enc ? a.Lep : a.Lp;
  g.rows = a.n * g.seq_rows;
  g.valid = enc ? a.Le : a.L;
  g.K = K;
  g.nseg = nseg;
  g.cols = cols;
  g.groups = groups;
  return g;
}

// Host: a product of the H-wide inputs of one row set into `groups` H-wide
// column groups with the weights and biases b0, b0 + 1, ... into o0, o1, o2.
RowGemm proj(const TrainArgs& a, bool enc, int groups, int b0, bf16* o0, bf16* o1, bf16* o2) {
  RowGemm g = rg_rows(a, enc, a.H, 1, a.H, groups);
  bf16* outs[RG_MAX] = {o0, o1, o2};
  for (int k = 0; k < groups; ++k) {
    g.bias[k] = a.b[b0 + k];
    g.out[k] = outs[k];
  }
  return g;
}

// Host: the attention phase MODE, a block per sequence (H <= 512).
template <int MODE>
int attn_launch(const TrainArgs& a, const bf16* dc, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      row_attn_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_attn_smem(512));
  if (attr != cudaSuccess) return (int)attr;
  row_attn_kernel<MODE><<<a.n, NT, row_attn_smem(a.H), st>>>(a, dc);
  return (int)cudaGetLastError();
}

// The weight-gradient reduction (the design is in the header above).
constexpr int WT = 128;                    // output tile: WT of M x WT of K
constexpr int WR = 64;                     // rows of the reduction per stage
constexpr int W_BOX = WR * 64 * 2;         // one box: 64 rows x 64 bf16, 8 KB
constexpr int W_STAGE = 4 * W_BOX;         // P's two boxes (M), then Q's two (K)
constexpr int W_STAGES = 6;
constexpr int W_THREADS = 288;             // two consumer warpgroups and a producer warp
constexpr int W_SMEM = 1024 + W_STAGES * W_STAGE + 2 * W_STAGES * 8;

__global__ void __launch_bounds__(W_THREADS, 1)
train_wgrad_kernel(const __grid_constant__ WgradArgs a, const __grid_constant__ WgradMaps maps) {
  const int blk = blockIdx.x;
  int p = a.count - 1;
  while (p > 0 && blk < (blk >= a.prod[0].bias0 ? a.prod[p].bias0 : a.prod[p].tile0)) --p;
  const ProductArgs& g = a.prod[p];
  if (blk >= a.prod[0].bias0) {  // a bias gradient: a thread per column, sequences in order
    const int c = (blk - g.bias0) * W_THREADS + threadIdx.x;
    if (c < g.M) {
      float sum = 0.f;
      for (int s = 0; s < g.N; ++s) sum += g.part[(size_t)s * g.M + c];
      g.db[c] = sum;
    }
    return;
  }
  const int t = blk - g.tile0, tk = (g.K + WT - 1) / WT;
  const int m0 = (t / tk) * WT, k0 = (t % tk) * WT;
  const int chunks = (g.R + WR - 1) / WR;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = rg_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + W_STAGES * W_STAGE);
  uint64_t* empty = full + W_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < W_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer: chunk c's boxes into stage c % W_STAGES
    if (threadIdx.x == 256) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % W_STAGES;
        unsigned char* dst = ring + s * W_STAGE;
        mbar_wait(&empty[s], ((c / W_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], W_STAGE);
        tma_load_2d(dst, &maps.p[p], &full[s], m0, c * WR);
        tma_load_2d(dst + W_BOX, &maps.p[p], &full[s], m0 + 64, c * WR);
        tma_load_2d(dst + 2 * W_BOX, &maps.q[p], &full[s], k0, c * WR);
        tma_load_2d(dst + 3 * W_BOX, &maps.q[p], &full[s], k0 + 64, c * WR);
      }
    }
    return;
  }
  // consumer warpgroup wg: output rows m0 + 64 wg .. + 63 (P's box wg), all
  // WT columns (Q's two boxes, W_BOX apart: the descriptor's N stride)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % W_STAGES;
    const unsigned char* st = ring + s * W_STAGE;
    mbar_wait(&full[s], (c / W_STAGES) & 1);
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int k = 0; k < WR / 16; ++k)  // 16 rows of the reduction: 2 KB into each box
      wgmma_m64n128k16<1>(acc, desc_mn_sw128(st + wg * W_BOX + k * 2048, W_BOX),
                          desc_mn_sw128(st + 2 * W_BOX + k * 2048, W_BOX), 1);
    wgmma_commit();
    if (c > 0) {  // the previous chunk's products are done: free its stage
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[(c - 1) % W_STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  // acc[4j + 2h + e]: row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
  const int row = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < WT / 8; ++j) {
    const int col = k0 + 8 * j + 2 * (lane & 3);
    if (col >= g.K) continue;  // K is even: a pair is in or out whole
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < g.M)
        *reinterpret_cast<float2*>(g.C + (size_t)(row + 8 * h) * g.K + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

}  // namespace

// The forward of K11 and of K12b's recompute after row_prep_kernel (x',
// enc): [Q1 K1 V1] = x' [Wq Wk Wv]^T + b; [K2 V2] = enc [Wk_c Wv_c]^T + b;
// the self attention; r1 = (drop(c1 Wo_s^T + bo_s) + x') npm, bf16 (WS_R1)
// and, given res, float32; Q2 = r1 Wq_c^T + bq_c.
int fwd_to_q2(const TrainArgs& a, float* res, cudaStream_t st) {
  const bf16* const* w = a.w;
  int e;
  if ((e = rg_run<0, E_BF16>(a, proj(a, false, 3, 0, a.scr[S_Q1], a.scr[S_K1], a.scr[S_V1]),
                             {a.ws[WS_X]}, {w[0], w[1], w[2]}, st)))
    return e;
  if ((e = rg_run<0, E_BF16>(a, proj(a, true, 2, 5, a.scr[S_K2], a.scr[S_V2], nullptr),
                             {a.ws[WS_ENC]}, {w[5], w[6]}, st)))
    return e;
  if ((e = attn_launch<ATT_SELF_FWD>(a, nullptr, st))) return e;
  RowGemm g = proj(a, false, 1, 3, a.ws[WS_R1], nullptr, nullptr);
  g.outf = res;
  if ((e = rg_run<0, E_RESID>(a, g, {a.ws[WS_C1]}, {w[3]}, st))) return e;
  return rg_run<0, E_BF16>(a, proj(a, false, 1, 4, a.scr[S_Q2], nullptr, nullptr),
                           {a.ws[WS_R1]}, {w[4]}, st);
}

// K11: the elementwise pass (x', enc); the products and attention to Q2;
// the cross context; r2 = (drop(c2 Wo_c^T + bo_c) + r1) npm (bf16 into
// a.r2, float32 into res); g = gelu_new(r2 Wi^T + bi); out =
// drop_final(drop_down(g Wo2^T + bo2) + r2) npm. res (N * Lp, H) float32
// holds the residual stream, r1 then r2.
NAVC_EXPORT int navc_train_fwd(const TrainArgs* args, float* res, void* stream) {
  const TrainArgs& a = *args;
  if (!a.seed) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_prep_kernel<<<dim3(a.n, (a.H + 127) / 128), 128, 0, st>>>(a, PREP_FWD);
  int e = (int)cudaGetLastError();
  if (e || (e = fwd_to_q2(a, res, st)) || (e = attn_launch<ATT_CROSS_FWD>(a, nullptr, st)))
    return e;
  RowGemm g = proj(a, false, 1, 7, a.r2, nullptr, nullptr);
  g.outf = res;
  if ((e = rg_run<0, E_R2>(a, g, {a.ws[WS_C2]}, {a.w[7]}, st))) return e;
  g = rg_rows(a, false, a.H, 1, a.I, 1);
  g.bias[0] = a.bi;
  g.out[0] = a.ws[WS_G];
  if ((e = rg_run<0, E_GELU>(a, g, {a.r2}, {a.wi}, st))) return e;
  g = rg_rows(a, false, a.I, 1, a.H, 1);
  g.bias[0] = a.bo2;
  g.outf = res;
  return rg_run<0, E_OUT>(a, g, {a.ws[WS_G]}, {a.wo2}, st);
}

// K1u: x (N, L, H) f32 embedded rows, enc (N, Le, H) f32; K11 with no
// dropout.
NAVC_EXPORT int navc_fused_layer_unfolded(const TrainArgs* args, float* res, void* stream) {
  if (args->on_hidden || args->on_input) return (int)cudaErrorInvalidValue;
  return navc_train_fwd(args, res, stream);
}

// K12a: the elementwise pass (dd, P_BO2); one product walk over the FFN
// columns with two accumulators (a = r2 Wi^T, t = dd Wo2: g, da, P_BI);
// dr2 = dt + da Wi (K = FFN).
NAVC_EXPORT int navc_train_ffn_bwd(const TrainArgs* args, void* stream) {
  const TrainArgs& a = *args;
  if (!a.seed) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_prep_kernel<<<dim3(a.n, (a.H + 127) / 128), 128, 0, st>>>(a, PREP_FFN);
  int e = (int)cudaGetLastError();
  if (e) return e;
  RowGemm g = rg_rows(a, false, a.H, 1, a.I, 1);
  g.bias[0] = a.bi;
  g.out[0] = a.ws[WS_G];
  g.out[1] = a.ws[WS_DA];
  g.part = a.part[P_BI];
  if ((e = rg_run<0, E_FFN1>(a, g, {a.r2, a.ws[WS_DD]}, {a.wi, a.wo2}, st))) return e;
  return rg_run<1, E_DR2>(a, rg_rows(a, false, a.I, 1, a.H, 1), {a.ws[WS_DA]}, {a.wi}, st);
}

// K12b: the elementwise pass (x', do2, enc); the forward's products and
// attention up to the cross-attention context; the backward from dC2 to
// dx. dc (N * Lp, H) bf16 holds dC2, then dC1.
NAVC_EXPORT int navc_train_attn_bwd(const TrainArgs* args, bf16* dc, void* stream) {
  const TrainArgs& a = *args;
  if (!a.seed) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = a.H;
  const bf16* const* w = a.w;
  auto to_dc = [&]() {
    RowGemm g = rg_rows(a, false, H, 1, H, 1);
    g.out[0] = dc;
    return g;
  };
  row_prep_kernel<<<dim3(a.n, (H + 127) / 128), 128, 0, st>>>(a, PREP_ATTN);
  int e = (int)cudaGetLastError();
  if (e || (e = fwd_to_q2(a, nullptr, st))) return e;
  // dC2 = do2 Wo_c; the cross attention and its backward
  if ((e = rg_run<1, E_BF16>(a, to_dc(), {a.ws[WS_DO2]}, {w[7]}, st))) return e;
  if ((e = attn_launch<ATT_CROSS>(a, dc, st))) return e;
  // dr1 = dr2 npm + dQ2 Wq_c: y = dr1 npm into dx, do1 = drop(y)
  RowGemm g = rg_rows(a, false, H, 1, H, 1);
  g.out[0] = a.ws[WS_DO1];
  g.part = a.part[P_BOS];
  if ((e = rg_run<1, E_DR1>(a, g, {a.ws[WS_DQ2]}, {w[4]}, st))) return e;
  // denc = [dK2 dV2] [Wk_c; Wv_c]
  if ((e = rg_run<1, E_DENC>(a, rg_rows(a, true, H, 2, H, 1), {a.ws[WS_DK2], a.ws[WS_DV2]},
                             {w[5], w[6]}, st)))
    return e;
  // dC1 = do1 Wo_s; the self-attention backward
  if ((e = rg_run<1, E_BF16>(a, to_dc(), {a.ws[WS_DO1]}, {w[3]}, st))) return e;
  if ((e = attn_launch<ATT_SELF_BWD>(a, dc, st))) return e;
  // dx = drop_input(y + [dQ1 dK1 dV1] [Wq; Wk; Wv])
  return rg_run<1, E_DX>(a, rg_rows(a, false, H, 3, H, 1),
                         {a.ws[WS_DQ1], a.ws[WS_DK1], a.ws[WS_DV1]}, {w[0], w[1], w[2]}, st);
}

NAVC_EXPORT int navc_train_wgrad(const WgradArgs* args, void* stream) {
  if (args->count < 1 || args->count > MAX_PRODUCTS || args->blocks < 1)
    return (int)cudaErrorInvalidValue;
  WgradMaps maps = {};
  for (int p = 0; p < args->count; ++p) {
    const ProductArgs& g = args->prod[p];
    if (g.R > 0 && (!encode_map(&maps.p[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g.P, g.R, g.M,
                                WR, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
                     !encode_map(&maps.q[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g.Q, g.R, g.K,
                                 WR, 64, CU_TENSOR_MAP_SWIZZLE_128B)))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e =
      cudaFuncSetAttribute(train_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (e != cudaSuccess) return (int)e;
  train_wgrad_kernel<<<args->blocks, W_THREADS, W_SMEM, static_cast<cudaStream_t>(stream)>>>(
      *args, maps);
  return (int)cudaGetLastError();
}
