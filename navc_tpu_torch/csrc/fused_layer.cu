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
// entry on the caller's stream, over each sequence's live rows only. A
// canvas's extent is 1 + its last non-PAD position (rows past it are PAD:
// zero rows, as their multiplier makes them; PAD inside it is computed and
// masked as any row); K2's query extent is 1 + its last used slot (qidx >=
// 0). The plan, two launches: a thread per sequence writes its extents; one
// block scans them into row offsets (the rows of the sequences before; the
// last, the rows live) and adds the live rows and the dense walk's to a
// running count (LayerArgs::rows). A LayerNorm pass, a warp per row of the
// capacity, forms each live canvas row x = LN(raw + static) (bf16; K1's
// canvas rows are its query rows, also float32 into the residual stream)
// and, for K2, each live query row xq = LN(<mask> + static[qidx]) (float32
// and bf16), compacted at the offsets, and the row map (each live query
// row's place n * Kq + i in the output); a dead query row is written as
// the output's zero row there. The products run on row_gemm.cuh's persistent
// walk (TMA, an mbarrier ring, wgmma; each weight tile feeds 64 or 128 rows;
// a fixed grid walks the tiles of the live count read on the card) with
// serving epilogues (bias; the residual times the row's multiplier on a
// float32 residual stream kept in place; gelu_new; the output in its dtype
// through the row map): K1 [Q1 K1 V1] over its live rows as one 3-group
// product, K2 [K1 V1] over the live canvas rows and Q1 over the live query
// rows; then Wo_s, Q2, Wo_c, Wi and Wo2 over the live query rows. The two
// attentions run a block per sequence on layer_common.cuh's `attend`, the
// sequence's live query rows and keys zero-filled to 16-row tiles in shared
// memory: a key past the extent is PAD, masked, and its exp is 0 in float32,
// so leaving it out leaves every sum as it was. K1's self mask adds the
// causal term for the AR teacher. The multiplier is 1 - kp at a K1 row, 1
// at a used K2 slot. The rows are computed as the dense walk computes them
// (the same tile plan, on the capacity): a row's bits do not depend on the
// other sequences' extents.

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
  int* plan;            // the walk's plan, 2 (N + 1) + N * Kq int32 (plan_*)
  unsigned long long* rows;  // (2,) live rows and the dense walk's rows, added to, or null
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

// The serving walk (K1 and K2). Its scratch rows in LayerArgs::ws, each
// compacted to the live rows: the canvas rows x, the self keys and values,
// the query rows' bf16 residual (K1: x itself), Q, the attention context.
enum { QS_X, QS_K1, QS_V1, QS_XQ, QS_Q, QS_C };

// The walk's plan (LayerArgs::plan): coff[N + 1], the live canvas rows
// before each sequence (coff[N]: all of them); qoff[N + 1], the same of the
// query rows (K1, whose query rows are its canvas rows: coff); the row
// map, the output row n * Kq + i of each live query row (Kq = L for K1, K
// for K2).
__host__ __device__ inline int* plan_coff(const LayerArgs& a) { return a.plan; }
__host__ __device__ inline int* plan_qoff(const LayerArgs& a) {
  return a.qidx ? a.plan + a.n + 1 : a.plan;
}
__host__ __device__ inline int* plan_map(const LayerArgs& a) { return a.plan + 2 * (a.n + 1); }

// The plan's first pass, a thread per sequence: its canvas extent into
// coff[n + 1] and, for K2, its query extent into qoff[n + 1].
__global__ void __launch_bounds__(256) walk_extent_kernel(const LayerArgs a) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= a.n) return;
  const unsigned char* kp = a.kp + (size_t)n * a.L;
  int e = 0;
  for (int j = 0; j < a.L; ++j)
    if (!kp[j]) e = j + 1;
  a.plan[n + 1] = e;
  if (a.qidx) {
    const int* q = a.qidx + (size_t)n * a.K;
    int eq = 0;
    for (int s = 0; s < a.K; ++s)
      if (q[s] >= 0) eq = s + 1;
    plan_qoff(a)[n + 1] = eq;
  }
}

// The plan's second pass, one block: coff (and K2's qoff) scanned in place
// from extents into offsets, a thread per run of consecutive sequences;
// the live rows, and the `dense` rows the walk would take without its plan,
// added to a.rows.
constexpr int SCAN_NT = 1024;

__global__ void __launch_bounds__(SCAN_NT) walk_scan_kernel(const LayerArgs a, long long dense) {
  __shared__ int warp_run[SCAN_NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (a.n + SCAN_NT - 1) / SCAN_NT, lo = threadIdx.x * per;
  const int hi = lo + per < a.n ? lo + per : a.n;
  long long live = 0;
  for (int pass = 0; pass < (a.qidx ? 2 : 1); ++pass) {
    int* off = pass ? plan_qoff(a) : plan_coff(a);
    int sum = 0;
    for (int n = lo; n < hi; ++n) sum += off[n + 1];
    int inc = sum;  // inclusive scan of the threads' sums: in the warp, then over warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += v;
    }
    if (lane == 31) warp_run[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int own = warp_run[lane];
      int w = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += v;
      }
      warp_run[lane] = w - own;
    }
    __syncthreads();
    int run = warp_run[warp] + inc - sum;
    for (int n = lo; n < hi; ++n) {
      run += off[n + 1];
      off[n + 1] = run;
    }
    if (threadIdx.x == 0) off[0] = 0;
    live += run;  // the last thread's run: all the rows
    __syncthreads();  // warp_run is read before the next pass writes it
  }
  if (a.rows && threadIdx.x == SCAN_NT - 1) {
    a.rows[0] += (unsigned long long)live;
    a.rows[1] += (unsigned long long)dense;
  }
}

// Query row q of the output (N * Kq rows of H) as a zero row (a warp).
__device__ __forceinline__ void zero_out_row(const LayerArgs& a, int q) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < a.H; c += 32) {
    if (a.out_bf16)
      static_cast<bf16*>(a.out)[(size_t)q * a.H + c] = __float2bfloat16(0.f);
    else
      static_cast<float*>(a.out)[(size_t)q * a.H + c] = 0.f;
  }
}

// The walk's LayerNorm pass, a warp per row of the capacity: the N * L
// canvas rows, then K2's N * K query slots. A live canvas row (i below its
// extent) x = LN(raw + static) bf16 into QS_X at its offset; a live query
// slot xq = LN(<mask> + static[qidx]) (LN(<mask>) at an unused slot, which
// its multiplier zeroes downstream), float32 into res and bf16 into QS_XQ,
// and its place in the row map; a dead query slot a zero row of out. K1
// (qidx null): every canvas row is a query row, x also float32 into res.
__global__ void __launch_bounds__(256) qsub_ln_kernel(const LayerArgs a) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int H = a.H, L = a.L, per = H / 32, canvas = a.n * L;
  const bool dense = a.qidx == nullptr;
  if (row >= canvas + (dense ? 0 : a.n * a.K)) return;
  const bool on_canvas = row < canvas, query = dense || !on_canvas;
  const int q = on_canvas ? row : row - canvas, kq = on_canvas ? L : a.K;
  const int n = q / kq, i = q % kq;
  const int* off = on_canvas ? plan_coff(a) : plan_qoff(a);
  const int o = off[n] + i;
  if (o >= off[n + 1]) {  // past the extent
    if (query) zero_out_row(a, q);
    return;
  }
  if (query && lane == 0) plan_map(a)[o] = q;
  float x[16];
  bf16* dst;
  float* f = query ? a.res + (size_t)o * H : nullptr;
  if (on_canvas) {
    dst = a.ws[QS_X] + (size_t)o * H;
    const size_t base = (size_t)q * H;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < per) {
        const int c = lane + 32 * j;
        x[j] = __bfloat162float(a.raw[base + c]) + __bfloat162float(a.stat[base + c]);
      }
  } else {
    const int pos = a.qidx[q];
    dst = a.ws[QS_XQ] + (size_t)o * H;
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
// head (`attend`): the sequence's live query rows (QS_Q at its query
// offset, zero-filled to 16-row tiles; K1: its canvas rows) against its
// live canvas keys (QS_K1 / QS_V1 at its canvas offset, zero-filled; PAD
// keys and those past the extent masked, and with `causal` the keys after
// the query's position) or, with CROSS, the hoisted cross keys (ke / ve,
// zero-filled, keys from Le on masked); the context rows into QS_C at the
// query offset. Shared memory: the warps' score slices, then Q, K and V
// tiles (MR rows, ld H + 8), then staging.
__host__ __device__ inline size_t qsub_attn_smem(int H) {
  return 4 * tile_bytes(H) + (size_t)NW * 256 * sizeof(float);
}

template <bool CROSS>
__global__ void __launch_bounds__(NT, 1) qsub_attn_kernel(const LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float kmask[MR];  // 1 where the self-attention key is masked
  const int n = blockIdx.x, H = a.H, L = a.L, Le = a.Le;
  const int* coff = plan_coff(a);
  const int* qoff = plan_qoff(a);
  const int q0 = qoff[n], nq = qoff[n + 1] - q0, k0 = coff[n], e = coff[n + 1] - k0;
  if (nq == 0) return;
  // a query whose keys are all masked (no decode makes one) attends to the
  // first zero-filled tile
  const int mtq = (nq + 15) / 16, mtk = CROSS ? (Le + 15) / 16 : (e > 0 ? (e + 15) / 16 : 1);
  if (threadIdx.x < MR) {
    const int j = threadIdx.x;
    kmask[j] = (j < e) ? (a.kp[(size_t)n * L + j] ? 1.f : 0.f) : 1.f;
  }
  const size_t tb = tile_bytes(H);
  LayerSmem s;
  s.ldb = H + 8;
  s.xb = reinterpret_cast<bf16*>(smem);
  s.qb = reinterpret_cast<bf16*>(smem + tb);
  s.kb = reinterpret_cast<bf16*>(smem + 2 * tb);
  s.vb = reinterpret_cast<bf16*>(smem + 3 * tb);
  s.stg = reinterpret_cast<float*>(smem + 4 * tb);
  const size_t qrow = (size_t)q0 * H;
  load_rows(a.ws[QS_Q] + qrow, s.qb, s.ldb, nq, mtq * 16, H);
  if constexpr (CROSS) {
    load_rows(a.ke + (size_t)n * Le * H, s.kb, s.ldb, Le, mtk * 16, H);
    load_rows(a.ve + (size_t)n * Le * H, s.vb, s.ldb, Le, mtk * 16, H);
  } else {
    load_rows(a.ws[QS_K1] + (size_t)k0 * H, s.kb, s.ldb, e, mtk * 16, H);
    load_rows(a.ws[QS_V1] + (size_t)k0 * H, s.vb, s.ldb, e, mtk * 16, H);
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
  copy_rows(s.qb, s.ldb, a.ws[QS_C] + qrow, nq, nq, H);
}

// What a walk product's epilogue does with its float32 tile (pairs of
// columns c, c + 1 of compacted row r; q = the row map's r, the query row
// of the output; npm 1 where K2's slot q is used, 1 - kp[q] at K1's row q):
//  S_BF16   + the group's bias, bf16 into out[group]
//  S_RESID  y = (v + bias + res) * npm, res read from outf: float32 into
//           outf in place, bf16 into out[0]
//  S_GELU   gelu_new(v + bias), bf16 into out[0]
//  S_OUT    (v + bias + res) * npm into a.out row q (N * Kq rows, H) in its dtype
enum { S_BF16, S_RESID, S_GELU, S_OUT };

template <int BN, int EPI, int WG>
__global__ void __launch_bounds__(rg_threads(WG))
qsub_gemm_kernel(const __grid_constant__ LayerArgs a, const __grid_constant__ RowGemm g,
                 const __grid_constant__ RowMaps m) {
  extern __shared__ unsigned char smem_raw[];
  // acc[4j + 2h + e]: row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
  const int lane = threadIdx.x & 31;
  const int rl = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int* map = plan_map(a);
  rg_walk<BN, WG>(m, g, rg_ring(smem_raw), [&](int grp, int c0, int row0, int live,
                                               const float(&acc0)[BN / 2]) {
    const float* b = g.bias[grp];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + rl + 8 * h;
      if (r >= live) continue;
      float npm = 0.f;
      size_t orow = 0;
      if constexpr (EPI == S_RESID || EPI == S_OUT) {
        const int q = map[r];
        npm = (a.qidx ? a.qidx[q] >= 0 : !a.kp[q]) ? 1.f : 0.f;
        orow = (size_t)q * g.cols;
      }
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
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + orow + c) =
                __floats2bfloat162_rn(v[0], v[1]);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + orow + c) =
                make_float2(v[0], v[1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(g.out[grp] + o) = __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  });
}

// Host: one walk product with epilogue EPI on the tile rg_plan picks for
// the capacity (g.rows); A and B (K-major weights) as rg_maps takes them.
template <int BN, int EPI, int WG>
int qs_tile_launch(const LayerArgs& a, const RowGemm& g, std::initializer_list<const bf16*> A,
                   std::initializer_list<const bf16*> B, cudaStream_t st) {
  return rg_launch_walk<qsub_gemm_kernel<BN, EPI, WG>, BN, WG>(a, g, A, B, st);
}

template <int EPI>
int qs_run(const LayerArgs& a, const RowGemm& g, std::initializer_list<const bf16*> A,
           std::initializer_list<const bf16*> B, cudaStream_t st) {
  const RgTile t = rg_plan(g.rows, g.cols * g.groups, false);
  if (t.wg == 2) return qs_tile_launch<128, EPI, 2>(a, g, A, B, st);
  if (t.bn == 128) return qs_tile_launch<128, EPI, 1>(a, g, A, B, st);
  return qs_tile_launch<64, EPI, 1>(a, g, A, B, st);
}

// Host: a walk product of one column group over `rows` rows of capacity,
// *live of them live (the plan's count on the card), K of each row, into
// cols columns.
RowGemm qs_rows(int rows, const int* live, int K, int cols, const float* bias, bf16* out,
                float* outf) {
  RowGemm g = {};
  g.rows = rows;
  g.live = live;
  g.K = K;
  g.nseg = 1;
  g.cols = cols;
  g.groups = 1;
  g.bias[0] = bias;
  g.out[0] = out;
  g.outf = outf;
  return g;
}

// Host: the walk's attention, CROSS or self, a block per sequence (H <= 512).
template <bool CROSS>
int qs_attn(const LayerArgs& a, cudaStream_t st) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(qsub_attn_kernel<CROSS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)qsub_attn_smem(512));
  if (attr != cudaSuccess) return (int)attr;
  qsub_attn_kernel<CROSS><<<a.n, NT, qsub_attn_smem(a.H), st>>>(a);
  return (int)cudaGetLastError();
}

// Host: the walk's plan and its LayerNorm pass; `dense`, the rows the walk
// would take without its plan, goes to the running count beside the live rows.
int walk_head(const LayerArgs& a, long long dense, cudaStream_t st) {
  walk_extent_kernel<<<(a.n + 255) / 256, 256, 0, st>>>(a);
  walk_scan_kernel<<<1, SCAN_NT, 0, st>>>(a, dense);
  const int rows = a.n * a.L + (a.qidx ? a.n * a.K : 0);
  qsub_ln_kernel<<<(rows + 7) / 8, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Host: the walk from the self attention on, over the live query rows (nq
// of capacity): c1 = attention; att1 = (c1 Wo_s^T + bo_s + xq) npm; Q2 =
// att1 Wq_c^T + bq_c; c2 = the cross attention; att2 = (c2 Wo_c^T + bo_c +
// att1) npm; g = gelu_new(att2 Wi^T + bi); out = (g Wo2^T + bo2 + att2) npm.
// The query rows' scratch is reused: xq, att1 and att2 in QS_XQ (bf16) and
// res (float32), Q1 then Q2 in QS_Q, c1 then c2 in QS_C.
int walk_tail(const LayerArgs& a, int nq, cudaStream_t st) {
  const int H = a.H;
  const int* live = plan_qoff(a) + a.n;
  bf16* const* ws = a.ws;
  int e;
  if ((e = qs_attn<false>(a, st)) ||
      (e = qs_run<S_RESID>(a, qs_rows(nq, live, H, H, a.b[3], ws[QS_XQ], a.res), {ws[QS_C]},
                           {a.w[3]}, st)) ||
      (e = qs_run<S_BF16>(a, qs_rows(nq, live, H, H, a.b[4], ws[QS_Q], nullptr), {ws[QS_XQ]},
                          {a.w[4]}, st)) ||
      (e = qs_attn<true>(a, st)) ||
      (e = qs_run<S_RESID>(a, qs_rows(nq, live, H, H, a.b[7], ws[QS_XQ], a.res), {ws[QS_C]},
                           {a.w[7]}, st)) ||
      (e = qs_run<S_GELU>(a, qs_rows(nq, live, H, a.I, a.bi, a.g, nullptr), {ws[QS_XQ]},
                          {a.wi}, st)))
    return e;
  return qs_run<S_OUT>(a, qs_rows(nq, live, a.I, H, a.bo2, nullptr, a.res), {a.g}, {a.wo2}, st);
}

}  // namespace

// K2: the plan and the LayerNorm pass; [K1 V1] = x [Wk Wv]^T + b over the
// live canvas rows (capacity N * Lp, as the dense walk plans its tiles);
// Q1 = xq Wq^T + bq over the live query rows; then walk_tail over them
// (capacity N * K).
NAVC_EXPORT int navc_fused_layer_qsub(const LayerArgs* args, void* stream) {
  const LayerArgs& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = a.H, Lp = (a.L + 15) / 16 * 16, canvas = a.n * Lp, nq = a.n * a.K;
  bf16* const* ws = a.ws;
  int e = walk_head(a, (long long)canvas + nq, st);
  if (e) return e;
  RowGemm g = qs_rows(canvas, plan_coff(a) + a.n, H, H, a.b[1], ws[QS_K1], nullptr);
  g.groups = 2;
  g.bias[1] = a.b[2];
  g.out[1] = ws[QS_V1];
  if ((e = qs_run<S_BF16>(a, g, {ws[QS_X]}, {a.w[1], a.w[2]}, st)) ||
      (e = qs_run<S_BF16>(a, qs_rows(nq, plan_qoff(a) + a.n, H, H, a.b[0], ws[QS_Q], nullptr),
                          {ws[QS_XQ]}, {a.w[0]}, st)))
    return e;
  return walk_tail(a, nq, st);
}

// K1: every canvas row a query row (K = L, qidx null), the live rows
// compacted; x and its residual successors in QS_X, which serves as QS_XQ.
// The plan and the LayerNorm pass; [Q1 K1 V1] = x [Wq Wk Wv]^T + b as one
// 3-group product; then walk_tail over the live rows (capacity N * L).
NAVC_EXPORT int navc_fused_layer(const LayerArgs* args, void* stream) {
  LayerArgs a = *args;
  a.K = a.L;
  a.qidx = nullptr;
  a.ws[QS_XQ] = a.ws[QS_X];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = a.H, nq = a.n * a.L;
  int e = walk_head(a, nq, st);
  if (e) return e;
  RowGemm g = qs_rows(nq, plan_coff(a) + a.n, H, H, a.b[0], a.ws[QS_Q], nullptr);
  g.groups = 3;
  g.bias[1] = a.b[1];
  g.out[1] = a.ws[QS_K1];
  g.bias[2] = a.b[2];
  g.out[2] = a.ws[QS_V1];
  if ((e = qs_run<S_BF16>(a, g, {a.ws[QS_X]}, {a.w[0], a.w[1], a.w[2]}, st))) return e;
  return walk_tail(a, nq, st);
}
