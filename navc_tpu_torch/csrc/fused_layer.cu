// The post-LN BertLayer of the NAR decode (eval mode): the embedding
// LayerNorm prologue, masked self-attention, cross-attention over hoisted
// K/V, and the gelu_new FFN, with the residual times the non-pad multiplier
// after every stage. Two forms: the dense one (K1, every canvas row is a
// query; `causal` masks future keys for the AR teacher) and the
// sparse-query one (K2, only the re-masked slots named by an index tensor
// are queries; keys and values span the whole canvas). K1u, the layer on
// embedded rows (fused_nar_decoder_layer's unfolded form, pallas_call at
// :303), is the training forward K11 at p = 0 and runs K11's launches: its
// entry is in fused_layer_train.cu.
//
// Replaces: navc_tpu/ops/fused_layer.py fused_nar_decoder_layer in its fold +
// pre_kv form (pallas_call at :289, body _kernel_fold :143 -> _layer_body
// :108 -> _attend_2d :50) and fused_nar_decoder_layer_qsub (pallas_call at
// :461, body _kernel_fold_qsub :337). The bf16 rounding points are those of
// _attend_2d / _layer_body: bf16 matmul operands with float32 accumulation,
// float32 bias, LayerNorm, softmax and residual, the result in the output
// dtype.
//
// What bounds it on the H100: the products. A decode's sparse step (K2, N =
// 384 canvases of 32, K = 24 query slots) does ~71 GFLOP of matmuls against
// ~8 MB of bf16 weights, 0.07 ms at the bf16 tensor-core rate; a dense call
// (K1) ~90 GFLOP over its non-PAD rows, 0.05 ms; the bytes (rows in and out,
// weights) take ~0.03 ms. One block per sequence, K1's earlier design
// (wmma 16x16x16 with B fragments streamed from L2, each weight fragment
// feeding 2 row tiles, ~202 KB of shared memory and so one block per SM),
// reached a few percent of that rate: 1.6 ms a call.
//
// Design of K1 and K2: the serving walk, a sequence of launches from one C
// entry on the caller's stream. A LayerNorm pass, a warp per row, forms the
// canvas rows x = LN(raw + static) (bf16; K2: N * Lp rows, zero past L; K1:
// the N * L rows, which are its query rows, also float32 into the residual
// stream) and, for K2, the query rows xq = LN(<mask> + static[qidx])
// (float32 and bf16, N * K rows flattened: the products take no
// per-sequence sums, so the query rows need no sequence alignment). The
// products run on row_gemm.cuh's walk (TMA, an mbarrier ring, wgmma; each
// weight tile feeds 64 or 128 rows) with serving epilogues (bias; the
// residual times the row's multiplier on a float32 residual stream kept in
// place; gelu_new; the output in its dtype): K1 [Q1 K1 V1] over its N * L
// rows as one 3-group product, K2 [K1 V1] over the canvas rows and Q1 over
// the query rows; then Wo_s, Q2, Wo_c, Wi and Wo2 over the query rows. The
// two attentions run a block per sequence on layer_common.cuh's `attend`,
// the sequence's query rows zero-filled to 16-row tiles in shared memory;
// K1's self mask adds the causal term for the AR teacher. The multiplier is
// 1 - kp at a K1 row, 1 at a used K2 slot (qidx >= 0): PAD rows and unused
// slots come out as zero rows.

#include "layer_common.cuh"
#include "row_gemm.cuh"

// Mirrored field by field by navc_tpu_torch/ops/fused_layer.py (_LayerArgs).
struct LayerArgs {
  const bf16* raw;      // (N, L, H) raw word embeddings of the canvas
  const bf16* stat;     // (N, L, H) static features (position, category, enc mean)
  const float* lns;     // (H,) embedding LayerNorm scale
  const float* lnb;     // (H,) embedding LayerNorm bias
  const unsigned char* kp;  // (N, L) 1 where the canvas token is PAD
  const bf16* ke;       // (N, Le, H) hoisted cross keys
  const bf16* ve;       // (N, Le, H) hoisted cross values
  const int* qidx;      // K2: (N, K) canvas position per query slot, -1 unused; K1: null
  const bf16* mrow;     // K2: (H,) <mask> word embedding
  const bf16* w[8];     // wq_s, wk_s, wv_s, wo_s, wq_c, wk_c, wv_c, wo_c: (H, H) (out, in)
  const float* b[8];    // their biases (H,)
  const bf16* wi;       // (I, H)
  const float* bi;      // (I,)
  const bf16* wo2;      // (H, I)
  const float* bo2;     // (H,)
  void* out;            // (N, L or K, H) bf16 or f32
  bf16* ws[6];          // the walk's scratch rows, QS_*: canvas rows (K2: N * Lp), query
                        // rows (K2: N * K; K1: its N * L canvas rows), (rows, H)
  bf16* g;              // (query rows, I) FFN activations
  float* res;           // (query rows, H) the float32 residual stream
  int out_bf16;
  int n, L, Le, K, H, I, n_head, causal;
  float scale, eps;
};

namespace {

// LayerNorm of one H-wide f32 row held 16 values per lane (c = lane + 32 j),
// as _kernel_fold: mean, mean of squared deviations, rsqrt(var + eps).
__device__ __forceinline__ void ln_row(float (&x)[16], int H, const float* lns, const float* lnb,
                                       float eps) {
  const int lane = threadIdx.x & 31;
  const int per = H / 32;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < per) sum += x[j];
  const float mu = warp_sum(sum) / H;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < per) sq += (x[j] - mu) * (x[j] - mu);
  const float rstd = rsqrtf(warp_sum(sq) / H + eps);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < per) {
      const int c = lane + 32 * j;
      x[j] = (x[j] - mu) * rstd * lns[c] + lnb[c];
    }
}

// The serving walk (K1 and K2). Its scratch rows in LayerArgs::ws: the
// canvas rows x, the self keys and values, the query rows' bf16 residual
// (K1: x itself), Q, the attention context.
enum { QS_X, QS_K1, QS_V1, QS_XQ, QS_Q, QS_C };

// The walk's first pass, a warp per row: the N * Lp canvas rows x = LN(raw
// + static) (bf16, zero past L), then K2's N * K query rows xq = LN(<mask>
// + static[qidx]), float32 into res and bf16; an unused slot reads
// LN(<mask>) and is zeroed by its multiplier downstream. K1 (qidx null,
// Lp = L) has no other query rows: its canvas rows also go float32 into
// res.
__global__ void __launch_bounds__(256) qsub_ln_kernel(const LayerArgs a, int Lp) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int H = a.H, L = a.L, per = H / 32, canvas = a.n * Lp;
  const bool dense = a.qidx == nullptr;
  if (row >= canvas + (dense ? 0 : a.n * a.K)) return;
  float x[16];
  bf16* dst;
  float* f = nullptr;
  if (row < canvas) {
    const int n = row / Lp, i = row % Lp;
    dst = a.ws[QS_X] + (size_t)row * H;
    if (dense) f = a.res + (size_t)row * H;
    if (i >= L) {
      for (int c = lane; c < H; c += 32) dst[c] = __float2bfloat16(0.f);
      return;
    }
    const size_t base = ((size_t)n * L + i) * H;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < per) {
        const int c = lane + 32 * j;
        x[j] = __bfloat162float(a.raw[base + c]) + __bfloat162float(a.stat[base + c]);
      }
  } else {
    const int q = row - canvas, n = q / a.K, pos = a.qidx[q];
    dst = a.ws[QS_XQ] + (size_t)q * H;
    f = a.res + (size_t)q * H;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < per) {
        const int c = lane + 32 * j;
        x[j] = __bfloat162float(a.mrow[c]) +
               (pos >= 0 ? __bfloat162float(a.stat[((size_t)n * L + pos) * H + c]) : 0.f);
      }
  }
  ln_row(x, H, a.lns, a.lnb, a.eps);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < per) {
      const int c = lane + 32 * j;
      dst[c] = __float2bfloat16(x[j]);
      if (f) f[c] = x[j];
    }
}

// The walk's attention, a block of NT threads per sequence, a warp per
// head (`attend`): the sequence's K query rows (QS_Q, zero-filled to 16-row
// tiles; K1: K = L) against the canvas keys (QS_K1 / QS_V1, kstride rows a
// sequence, zero-filled; PAD keys masked, and with `causal` the keys after
// the query's position) or, with CROSS, the hoisted cross keys (ke / ve,
// zero-filled, keys from Le on masked); the context rows into QS_C. Shared
// memory: the warps' score slices, then Q, K and V tiles (MR rows, ld H +
// 8), then staging.
__host__ __device__ inline size_t qsub_attn_smem(int H) {
  return 4 * tile_bytes(H) + (size_t)NW * 256 * sizeof(float);
}

template <bool CROSS>
__global__ void __launch_bounds__(NT, 1) qsub_attn_kernel(const LayerArgs a, int kstride) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float kmask[MR];  // 1 where the self-attention key is masked
  const int n = blockIdx.x, H = a.H, L = a.L, K = a.K, Le = a.Le;
  const int mtq = (K + 15) / 16, mtk = (CROSS ? Le + 15 : L + 15) / 16;
  if (threadIdx.x < MR) {
    const int j = threadIdx.x;
    kmask[j] = (j < L) ? (a.kp[(size_t)n * L + j] ? 1.f : 0.f) : 1.f;
  }
  const size_t tb = tile_bytes(H);
  LayerSmem s;
  s.ldb = H + 8;
  s.xb = reinterpret_cast<bf16*>(smem);
  s.qb = reinterpret_cast<bf16*>(smem + tb);
  s.kb = reinterpret_cast<bf16*>(smem + 2 * tb);
  s.vb = reinterpret_cast<bf16*>(smem + 3 * tb);
  s.stg = reinterpret_cast<float*>(smem + 4 * tb);
  const size_t qrow = (size_t)n * K * H;
  load_rows(a.ws[QS_Q] + qrow, s.qb, s.ldb, K, mtq * 16, H);
  if constexpr (CROSS) {
    load_rows(a.ke + (size_t)n * Le * H, s.kb, s.ldb, Le, mtk * 16, H);
    load_rows(a.ve + (size_t)n * Le * H, s.vb, s.ldb, Le, mtk * 16, H);
  } else {
    load_rows(a.ws[QS_K1] + (size_t)n * kstride * H, s.kb, s.ldb, kstride, mtk * 16, H);
    load_rows(a.ws[QS_V1] + (size_t)n * kstride * H, s.vb, s.ldb, kstride, mtk * 16, H);
  }
  __syncthreads();
  if constexpr (CROSS) {
    attend(s, H, a.n_head, mtq, mtk, a.scale, [=](int, int j) { return j >= Le; });
  } else {
    const float* kmask_p = kmask;
    const bool causal = a.causal != 0;
    attend(s, H, a.n_head, mtq, mtk, a.scale,
           [=](int i, int j) { return kmask_p[j] > 0.5f || (causal && j > i); });
  }
  __syncthreads();
  copy_rows(s.qb, s.ldb, a.ws[QS_C] + qrow, K, K, H);
}

// What a walk product's epilogue does with its float32 tile (pairs of
// columns c, c + 1 of flattened query row r; npm 1 where K2's slot r is
// used, 1 - kp[r] at K1's row r, the canvas row itself):
//  S_BF16   + the group's bias, bf16 into out[group]
//  S_RESID  y = (v + bias + res) * npm, res read from outf: float32 into
//           outf in place, bf16 into out[0]
//  S_GELU   gelu_new(v + bias), bf16 into out[0]
//  S_OUT    (v + bias + res) * npm into a.out (query rows, H) in its dtype
enum { S_BF16, S_RESID, S_GELU, S_OUT };

template <int BN, int EPI, int WG>
__global__ void __launch_bounds__(rg_threads(WG))
qsub_gemm_kernel(const __grid_constant__ LayerArgs a, const __grid_constant__ RowGemm g,
                 const __grid_constant__ RowMaps m) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = rg_ring(smem_raw);
  const int grp = blockIdx.x / g.tiles, c0 = (blockIdx.x % g.tiles) * BN;
  const int row0 = blockIdx.y * WG * RG_BM;
  float acc0[BN / 2], acc1[BN / 2];
  if (!rg_tile<BN, 0, false, WG>(m, g, ring, grp, c0, row0, acc0, acc1)) return;

  // acc[4j + 2h + e]: row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
  const int lane = threadIdx.x & 31;
  const int rl = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const float* b = g.bias[grp];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rl + 8 * h;
    if (r >= g.rows) continue;
    float npm = 0.f;
    if constexpr (EPI == S_RESID || EPI == S_OUT)
      npm = (a.qidx ? a.qidx[r] >= 0 : !a.kp[r]) ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j + 2 * (lane & 3);
      if (c >= g.cols) continue;  // cols is even: a pair is in or out whole
      const size_t o = (size_t)r * g.cols + c;
      float v[2] = {acc0[4 * j + 2 * h] + b[c], acc0[4 * j + 2 * h + 1] + b[c + 1]};
      if constexpr (EPI == S_GELU) {
        v[0] = gelu_new(v[0]);
        v[1] = gelu_new(v[1]);
      }
      if constexpr (EPI == S_RESID || EPI == S_OUT) {
        const float2 res = *reinterpret_cast<const float2*>(g.outf + o);
        v[0] = (v[0] + res.x) * npm;
        v[1] = (v[1] + res.y) * npm;
      }
      if constexpr (EPI == S_RESID)
        *reinterpret_cast<float2*>(g.outf + o) = make_float2(v[0], v[1]);
      if constexpr (EPI == S_OUT) {
        if (a.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + o) =
              __floats2bfloat162_rn(v[0], v[1]);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) = make_float2(v[0], v[1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(g.out[grp] + o) = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

// Host: one walk product with epilogue EPI on the tile rg_plan picks; A and B
// (K-major weights) as rg_maps takes them.
template <int BN, int EPI, int WG>
int qs_tile_launch(const LayerArgs& a, const RowGemm& g, std::initializer_list<const bf16*> A,
                   std::initializer_list<const bf16*> B, cudaStream_t st) {
  return rg_launch<qsub_gemm_kernel<BN, EPI, WG>, BN, false, WG>(a, g, A, B, 0, 0, st);
}

template <int EPI>
int qs_run(const LayerArgs& a, const RowGemm& g, std::initializer_list<const bf16*> A,
           std::initializer_list<const bf16*> B, cudaStream_t st) {
  const RgTile t = rg_plan(g.rows, g.cols * g.groups, false);
  if (t.wg == 2) return qs_tile_launch<128, EPI, 2>(a, g, A, B, st);
  if (t.bn == 128) return qs_tile_launch<128, EPI, 1>(a, g, A, B, st);
  return qs_tile_launch<64, EPI, 1>(a, g, A, B, st);
}

// Host: a walk product of one column group, K of each row, into cols columns.
RowGemm qs_rows(int rows, int K, int cols, const float* bias, bf16* out, float* outf) {
  RowGemm g = {};
  g.rows = rows;
  g.K = K;
  g.nseg = 1;
  g.cols = cols;
  g.groups = 1;
  g.bias[0] = bias;
  g.out[0] = out;
  g.outf = outf;
  return g;
}

// Host: the walk's attention, CROSS or self, a block per sequence (H <= 512);
// kstride canvas rows a sequence in QS_K1 / QS_V1.
template <bool CROSS>
int qs_attn(const LayerArgs& a, int kstride, cudaStream_t st) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(qsub_attn_kernel<CROSS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)qsub_attn_smem(512));
  if (attr != cudaSuccess) return (int)attr;
  qsub_attn_kernel<CROSS><<<a.n, NT, qsub_attn_smem(a.H), st>>>(a, kstride);
  return (int)cudaGetLastError();
}

// Host: the walk from the self attention on, over the nq query rows: c1 =
// attention; att1 = (c1 Wo_s^T + bo_s + xq) npm; Q2 = att1 Wq_c^T + bq_c;
// c2 = the cross attention; att2 = (c2 Wo_c^T + bo_c + att1) npm; g =
// gelu_new(att2 Wi^T + bi); out = (g Wo2^T + bo2 + att2) npm. The query
// rows' scratch is reused: xq, att1 and att2 in QS_XQ (bf16) and res
// (float32), Q1 then Q2 in QS_Q, c1 then c2 in QS_C.
int walk_tail(const LayerArgs& a, int nq, int kstride, cudaStream_t st) {
  const int H = a.H;
  bf16* const* ws = a.ws;
  int e;
  if ((e = qs_attn<false>(a, kstride, st)) ||
      (e = qs_run<S_RESID>(a, qs_rows(nq, H, H, a.b[3], ws[QS_XQ], a.res), {ws[QS_C]},
                           {a.w[3]}, st)) ||
      (e = qs_run<S_BF16>(a, qs_rows(nq, H, H, a.b[4], ws[QS_Q], nullptr), {ws[QS_XQ]},
                          {a.w[4]}, st)) ||
      (e = qs_attn<true>(a, kstride, st)) ||
      (e = qs_run<S_RESID>(a, qs_rows(nq, H, H, a.b[7], ws[QS_XQ], a.res), {ws[QS_C]},
                           {a.w[7]}, st)) ||
      (e = qs_run<S_GELU>(a, qs_rows(nq, H, a.I, a.bi, a.g, nullptr), {ws[QS_XQ]}, {a.wi},
                          st)))
    return e;
  return qs_run<S_OUT>(a, qs_rows(nq, a.I, H, a.bo2, nullptr, a.res), {a.g}, {a.wo2}, st);
}

}  // namespace

// K2: the LayerNorm pass; [K1 V1] = x [Wk Wv]^T + b over the canvas rows;
// Q1 = xq Wq^T + bq over the query rows; then walk_tail over the N * K
// query rows.
NAVC_EXPORT int navc_fused_layer_qsub(const LayerArgs* args, void* stream) {
  const LayerArgs& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = a.H, Lp = (a.L + 15) / 16 * 16, canvas = a.n * Lp, nq = a.n * a.K;
  bf16* const* ws = a.ws;
  qsub_ln_kernel<<<(canvas + nq + 7) / 8, 256, 0, st>>>(a, Lp);
  int e = (int)cudaGetLastError();
  if (e) return e;
  RowGemm g = qs_rows(canvas, H, H, a.b[1], ws[QS_K1], nullptr);
  g.groups = 2;
  g.bias[1] = a.b[2];
  g.out[1] = ws[QS_V1];
  if ((e = qs_run<S_BF16>(a, g, {ws[QS_X]}, {a.w[1], a.w[2]}, st)) ||
      (e = qs_run<S_BF16>(a, qs_rows(nq, H, H, a.b[0], ws[QS_Q], nullptr), {ws[QS_XQ]},
                          {a.w[0]}, st)))
    return e;
  return walk_tail(a, nq, Lp, st);
}

// K1: every canvas row a query row (K = L, qidx null), the N * L rows
// flattened with no sequence padding; x and its residual successors in
// QS_X, which serves as QS_XQ. The LayerNorm pass; [Q1 K1 V1] = x [Wq Wk
// Wv]^T + b as one 3-group product; then walk_tail over the N * L rows.
NAVC_EXPORT int navc_fused_layer(const LayerArgs* args, void* stream) {
  LayerArgs a = *args;
  a.K = a.L;
  a.qidx = nullptr;
  a.ws[QS_XQ] = a.ws[QS_X];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = a.H, nq = a.n * a.L;
  qsub_ln_kernel<<<(nq + 7) / 8, 256, 0, st>>>(a, a.L);
  int e = (int)cudaGetLastError();
  if (e) return e;
  RowGemm g = qs_rows(nq, H, H, a.b[0], a.ws[QS_Q], nullptr);
  g.groups = 3;
  g.bias[1] = a.b[1];
  g.out[1] = a.ws[QS_K1];
  g.bias[2] = a.b[2];
  g.out[2] = a.ws[QS_V1];
  if ((e = qs_run<S_BF16>(a, g, {a.ws[QS_X]}, {a.w[0], a.w[1], a.w[2]}, st))) return e;
  return walk_tail(a, nq, a.L, st);
}
