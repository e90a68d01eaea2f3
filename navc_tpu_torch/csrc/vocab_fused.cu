// Vocab projection fused with an online softmax: argmax id + max probability
// (K3), the probability of a given target id (K4), the top-k log-probs with
// their ids (K5) and the training loss's per-row label log-prob, argmax id
// and log-sum-exp (K9), without writing the (rows, V) logits to device
// memory.
//
// Replaces: navc_tpu/ops/vocab_fused.py fused_project_argmax (pallas_call at
// :128, body _kernel :36), fused_project_gather_prob (pallas_call at :229,
// body _gather_kernel :152) and fused_project_topk (pallas_call at :350, body
// _topk_kernel :246); navc_tpu/ops/vocab_ce.py vocab_ce_train's forward
// (pallas_call at :118, body _fwd_kernel :55).
//
// What bounds it on the H100: the product h @ W^T. At the main path's dense
// shape (12288 x 512 x 10048) that is 126 GFLOP against ~23 MB of operands,
// so the bf16 tensor-core rate bounds it: 0.128 ms at 989 TFLOP/s. W (10 MB)
// stays in the 50 MB L2; a block of 128 rows reads 128 bytes of W from L2
// for every 256 bf16 FLOPs. K9 is the same product at the training step's
// rows (0.64 ms at B = 2048: 61440 x 512 x 10048). K5's beam step (320 x 512 x 10048) is bounded
// alike by operations and by bytes (~0.0033 ms): at so few rows what costs
// is filling the card and the top-k bookkeeping, not the product. The
// MLAMoE language model's beam step (2560 x 2048 x 163840, 1.72 TFLOP, W
// 671 MB) is bounded by operations: 1.74 ms at 989 TFLOP/s; there h (128
// rows x 2048 = 512 KB) cannot stay in shared memory, so K5 streams it (the
// `stream` layout below).
//
// One walk serves all four (argmax_kernel<MODE, K, HALF> +
// argmax_merge_kernel<MODE, K>): a block's two consumer warpgroups take
// 128 rows of h and one vocab split.
// - Ring: the h rows are loaded once (resident: ceil(D/64) TMA boxes of
//   128 x 64 bf16, 128-byte swizzle; K5 at D > 768 keeps none and loads each
//   D chunk's h box beside its W box into the same stage, 3 stages of 32 KB
//   a warpgroup, the rows read again from L2 for every tile); W streams in nn.Linear's own (V, D)
//   layout, one 128 x 64 box per stage, with full/empty mbarriers. The ring
//   has a half per consumer warpgroup, 3 stages each (1 for D > 512, where
//   h takes up to 192 KB); the 128 bias values of each vocab tile come by
//   TMA into that warpgroup's slot, once per tile. TMA zero-fills the ragged
//   row edge and the D and vocab edges: W and h need no padded copies.
// - Loads: K3 / K4 / K9 have a producer warpgroup whose first thread loads in
//   tile order (setmaxnreg moves registers from it to the consumers at run
//   time). K5 has none: its lists need registers that ptxas does not give
//   a 384-thread block, whose SM register-file quarters hold three warps
//   each (it allocated 168 a thread whatever setmaxnreg gave the consumers,
//   and K5 spilled); with 256 threads, two warps a quarter, it may use 255.
//   Each consumer warpgroup's first thread fills its half of the ring and
//   refills a stage once the four warps have freed it. The same self-loading
//   ring made K3 1.6x slower than the producer's, so K3 / K4 keep theirs.
// - wgmma: h (R, D) is the K-major A operand and W (V, D) the K-major B
//   operand, so neither is transposed. Consumer warpgroup w takes the
//   split's vocab tiles w, w + 2, ... for all 128 rows (two m64n128k16
//   products per 16 of D, float32 accumulators in 128 registers a thread)
//   and frees each stage once the products on it are done. Warpgroup 1's
//   first boxes come after warpgroup 0's (K5: it starts when warpgroup 0's
//   first tile's products are done), so the two run half a step apart and
//   one's epilogue overlaps the other's products (with both warpgroups on
//   the same tiles, 64 rows each, they ran in lockstep and the tensor cores
//   idled through every epilogue).
// - Epilogue on the accumulator registers: each thread holds 4 rows x 32
//   columns of a tile, adds the staged bias, masks columns >= V by index
//   (zero is not -inf) on the last tile only, takes each row's tile max and
//   its first column, then rescales the running sum once and adds exp2 of
//   every score with log2(e) folded in; K4 and K9 keep the target's (the
//   label's) logit, K9 (MODE CE) the argmax too. No score tile goes through
//   shared memory. K5 (MODE TOPK) also keeps, per row, a sorted register list of
//   its K best (value, id) pairs (K a template parameter, 1..8, so the
//   beam's k = 5 pays for 5 pairs): a score enters only if it beats the
//   list's last value, and then takes its slot in one pass of compares
//   against the new score (no compares between list entries, so equal
//   values keep their order). At the end the 4 lanes of a row merge their
//   states (and lists) by shuffles, and warpgroup 1 hands its rows' states
//   to warpgroup 0 through the (then idle) ring.
// - Split: the grid is row tiles x vocab splits, planned on the host
//   (ops/vocab_fused.py `argmax_splits`) so that every call fills the 132
//   SMs in whole waves (K5's 320-row beam step: 3 row tiles x 40 splits of
//   2 tiles, a tile per warpgroup); each block writes a partial (max,
//   sum-exp, and argmax | target logit | both | K pairs) per row, and a
//   second small kernel (a thread per row) folds the splits in order and
//   writes the argmax and max prob, the target's prob, K9's label log-prob
//   (logit - max) - log(sum-exp) with the argmax and max + log(sum-exp), or
//   the K log-probs with their ids. No atomics: deterministic.
// - Ties: the lowest id wins within a thread (strict '>' in rising column
//   order), across a warpgroup's tiles (a later tile must be strictly
//   greater), across lanes and warpgroups (lower id on equal values) and
//   across splits (folded in order; K5's lists merge by (value, lower id)),
//   as the Pallas kernels' first argmax and lax.top_k do. A target outside
//   [0, V) matches no column: its logit stays -1e30 and its prob is 0. Columns
//   past V are -inf and never enter a list (a list starts as (-inf, INT_MAX)
//   pairs and k <= V).

#include "hopper.cuh"

namespace {

constexpr int MAX_K = 8;  // beam sizes 1..8; the wrapper refuses more
constexpr int ARGMAX = 0, GATHER = 1, TOPK = 2, CE = 3;  // the walk's modes: K3, K4, K5, K9

// The modes that keep the argmax id, and those that keep the target logit.
__host__ __device__ constexpr bool keeps_arg(int mode) { return mode == ARGMAX || mode == CE; }
__host__ __device__ constexpr bool keeps_target(int mode) { return mode == GATHER || mode == CE; }

// (a, ia) ranks before (b, ib): larger value, then lower id (lax.top_k's order)
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// Merge two (max, sum-exp) states of one row.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  const float sa = (m == -INFINITY) ? 0.f : s * expf(m - mn);
  const float sb = (m2 == -INFINITY) ? 0.f : s2 * expf(m2 - mn);
  s = sa + sb;
  m = mn;
}

// K ids of a list: 32 bits each, or (PACKED) 16 bits two to a register,
// which the walk's lists take (ids from the block's first column: a split
// spans at most 65535 columns) to leave K5 room in its 255 registers.
template <int K, bool PACKED>
struct TopIds {
  static constexpr int kNone = 0x7fffffff;
  int x[K];
  __device__ __forceinline__ int get(int j) const { return x[j]; }
  __device__ __forceinline__ void set(int j, int id) { x[j] = id; }
};
template <int K>
struct TopIds<K, true> {
  static constexpr int kNone = 0xffff;
  uint32_t x[(K + 1) / 2];
  __device__ __forceinline__ int get(int j) const { return (x[j >> 1] >> (16 * (j & 1))) & 0xffff; }
  __device__ __forceinline__ void set(int j, int id) {
    x[j >> 1] = (j & 1) ? (x[j >> 1] & 0xffffu) | ((uint32_t)id << 16)
                        : (x[j >> 1] & 0xffff0000u) | (uint32_t)id;
  }
};

// A row's K best (value, id) pairs in `before` order, in registers (every
// loop unrolls); no id is kNone but an empty entry's.
template <int K, bool PACKED = false>
struct TopList {
  float v[K];
  TopIds<K, PACKED> i;

  __device__ __forceinline__ TopList() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = -INFINITY;
      i.set(j, TopIds<K, PACKED>::kNone);
    }
  }

  // ahead(j): the new pair ranks before entry j (false up to its slot,
  // true from there on). Entries from the slot move down one; the last
  // drops. Going up from the end, entries j and j - 1 are still the old
  // ones when ahead(j) and ahead(j - 1) read them.
  template <class Ahead>
  __device__ __forceinline__ void shift_in(Ahead ahead, float x, int id) {
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (ahead(j)) {
        const bool up = ahead(j - 1);
        v[j] = up ? v[j - 1] : x;
        i.set(j, up ? i.get(j - 1) : id);
      }
    }
    if (ahead(0)) {
      v[0] = x;
      i.set(0, id);
    }
  }

  // A score of this thread's next column: its id is above every id in the
  // list, so it must be strictly greater to go ahead of an entry.
  __device__ __forceinline__ void push(float x, int id) {
    if (x > v[K - 1]) shift_in([&](int j) { return x > v[j]; }, x, id);
  }

  // A pair of another list.
  __device__ __forceinline__ void merge(float x, int id) {
    if (before(x, id, v[K - 1], i.get(K - 1)))
      shift_in([&](int j) { return before(x, id, v[j], i.get(j)); }, x, id);
  }
};

constexpr int AM = 128;            // rows of h per block: two consumer warpgroups of 64
constexpr int AN = 128;            // vocab columns per tile (the wgmma's N)
constexpr int AK = 64;             // D per TMA box: 64 bf16, one 128-byte swizzled row
constexpr int A_BOX = AM * AK * 2; // bytes of one h box and of one W box (AN == AM)
constexpr int A_SMEM = 232448;     // shared memory a block may use on the H100
constexpr float LOG2E = 1.4426950408889634f;

constexpr int MAX_D_RESIDENT = 768;  // the widest h tile that stays in shared memory
constexpr int MAX_D_STREAM = 8192;   // K5's streamed walk (D > 768)

// W ring stages per consumer warpgroup: 3 while the h tile takes at most
// 128 KB (D <= 512), else 1 (D <= 768: h takes up to 192 KB). K5 at D > 768
// (`stream`) keeps no h tile: each of its 3 stages a warpgroup holds a W box
// and the h box of the same D chunk.
__host__ __device__ inline int ring_half(int d) { return d <= 512 ? 3 : 1; }

// Byte offsets from the 1024-aligned base of dynamic shared memory: the
// resident h tile (nk boxes; none when `stream`), the ring of W (and, when
// `stream`, h) boxes, two bias tiles, the barriers; `bytes` (at most A_SMEM)
// includes the alignment slack.
struct ArgLayout {
  int nk, stages, w, bias, bars, bytes;
};

__host__ __device__ inline ArgLayout arg_layout(int d, bool stream = false) {
  ArgLayout L;
  L.nk = (d + AK - 1) / AK;
  L.w = stream ? 0 : L.nk * A_BOX;
  L.stages = stream ? 6 : 2 * ring_half(d);
  L.bias = L.w + L.stages * (stream ? 2 : 1) * A_BOX;
  L.bars = L.bias + 2 * AN * 4;  // full, empty (stages each), bfull, bempty, h, go
  L.bytes = 1024 + L.bars + 256;
  return L;
}

// One row's running state: max, sum of exp(x - max), first argmax, target logit.
struct RowState {
  float m = -INFINITY, s = 0.f, g = -1e30f;
  int arg = 0x7fffffff;
};

// Folds one tile's scores of a row (this thread's 32 of its 128 columns,
// acc[4j + OFF], acc[4j + OFF + 1]) into the row's state; tmax is their
// max, first reached at column targ (K5 keeps no argmax: its list has it).
template <int MODE, int OFF>
__device__ __forceinline__ void absorb(RowState& r, float tmax, int targ, const float (&acc)[64]) {
  const float mn = fmaxf(r.m, tmax);
  const float mref = mn == -INFINITY ? 0.f : mn * LOG2E;
  // The running sum's rescale comes from the difference of the maxima, so
  // it is exactly 1 while the max holds; fmaf(r.m, LOG2E, -mref) would be
  // 2^d, d the rounding error of mn * LOG2E, once per tile, and drift the
  // sum over a long split (1.6e-4 over 274 tiles at logits near 52).
  float s0 = mn == -INFINITY ? 0.f : r.s * ex2((r.m - mn) * LOG2E), s1 = 0.f;
#pragma unroll
  for (int j = 0; j < AN / 8; ++j) {
    s0 += ex2(fmaf(acc[4 * j + OFF], LOG2E, -mref));
    s1 += ex2(fmaf(acc[4 * j + OFF + 1], LOG2E, -mref));
  }
  r.s = s0 + s1;
  if (MODE != TOPK && tmax > r.m) r.arg = targ;  // a tie keeps the earlier (lower) column
  r.m = mn;
}

// The epilogue of one vocab tile on the accumulator registers. This
// thread holds rows (lane / 4) and (lane / 4 + 8) of its warp's 16, and
// columns 8j + 2q + {0, 1} (q = lane % 4) of the tile, in rising order.
// EDGE: the tile passes the vocab's end, whose columns are masked by index
// (TMA zero-filled them; zero is not -inf). TOPK also pushes every score
// into the row's list (l0, l1) that reaches the row's threshold (th0, th1):
// the largest last value of the lists of the row's 4 lanes, below which K
// better scores are known. Its ids count from the split's first column:
// the tile starts at vr.
template <int MODE, int K, bool EDGE>
__device__ __forceinline__ void fold(float (&acc)[64], const float* b, bool has_bias, int v0,
                                     int vr, int v, int q, int tg0, int tg1, RowState& r0,
                                     RowState& r1, TopList<K, true>& l0, TopList<K, true>& l1,
                                     float th0, float th1) {
  float t0 = -INFINITY, t1 = -INFINITY;
  int i0 = 0, i1 = 0;
  const int rel0 = tg0 - v0 - 2 * q, rel1 = tg1 - v0 - 2 * q;
#pragma unroll
  for (int j = 0; j < AN / 8; ++j) {
    float2 bb = make_float2(0.f, 0.f);
    if (has_bias) bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * q);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + e;  // this thread's column in the tile, less 2q
      const float be = e ? bb.y : bb.x;
      float x0 = acc[4 * j + e] + be, x1 = acc[4 * j + 2 + e] + be;
      if (EDGE && v0 + 2 * q + col >= v) x0 = x1 = -INFINITY;
      acc[4 * j + e] = x0;
      acc[4 * j + 2 + e] = x1;
      if (x0 > t0) { t0 = x0; i0 = col; }
      if (x1 > t1) { t1 = x1; i1 = col; }
      if (keeps_target(MODE)) {
        if (col == rel0) r0.g = x0;
        if (col == rel1) r1.g = x1;
      }
      if (MODE == TOPK) {
        if (x0 >= th0) l0.push(x0, vr + 2 * q + col);
        if (x1 >= th1) l1.push(x1, vr + 2 * q + col);
      }
    }
  }
  absorb<MODE, 0>(r0, t0, v0 + 2 * q + i0, acc);
  absorb<MODE, 2>(r1, t1, v0 + 2 * q + i1, acc);
}

// Merges another state of the same row into r; the lower id wins a tie.
template <int MODE>
__device__ __forceinline__ void merge_state(RowState& r, float m2, float s2, float g2, int a2) {
  if (keeps_arg(MODE) && (m2 > r.m || (m2 == r.m && a2 < r.arg))) r.arg = a2;
  lse_merge(r.m, r.s, m2, s2);
  if (keeps_target(MODE)) r.g = fmaxf(r.g, g2);
}

// Merges the states (and K5's lists) of the 4 lanes that share a row; each
// lane reads its partner's whole list before its own changes.
template <int MODE, int K>
__device__ __forceinline__ void lane_merge(RowState& r, TopList<K, true>& l) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    float ov[K];
    int oi[K];
    if (MODE == TOPK) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        ov[j] = __shfl_xor_sync(0xffffffffu, l.v[j], off);
        oi[j] = __shfl_xor_sync(0xffffffffu, l.i.get(j), off);
      }
    }
    merge_state<MODE>(r, __shfl_xor_sync(0xffffffffu, r.m, off),
                      __shfl_xor_sync(0xffffffffu, r.s, off), __shfl_xor_sync(0xffffffffu, r.g, off),
                      __shfl_xor_sync(0xffffffffu, r.arg, off));
    if (MODE == TOPK) {
#pragma unroll
      for (int j = 0; j < K; ++j) l.merge(ov[j], oi[j]);
    }
  }
}

// A row's state as warpgroup 1 hands it to warpgroup 0.
template <int K>
struct RowHandoff {
  RowState st;
  float v[K];
  int i[K];
};

// Grid (row tiles of AM, vocab splits): block (i, j) keeps rows [AM i,
// AM i + AM) of h in shared memory and walks the vocab tiles of split j,
// writing each row's partial state to pm, ps and, by MODE, pa (argmax), pg
// (target logit), both (K9) or pg / pa (K5's K values / ids, (splits, rows,
// K)), laid out (splits, rows). Consumer warpgroup w multiplies all AM rows by the
// split's tiles w, w + 2, ... and folds their scores, on its half of the
// ring. K3 / K4 (HALF, the ring half, fixed): a producer warpgroup's first
// thread loads by TMA in tile order, so warpgroup 1's boxes arrive after
// warpgroup 0's. K5 (HALF 0: ring_half(d)): no producer (its lists need the
// registers), each warpgroup's first thread fills its half and refills a
// stage with the box `half` ahead once the four warps have arrived on its
// empty barrier; warpgroup 1 starts its products when warpgroup 0's first
// tile's are done. Either way the two run half a step apart and one's
// epilogue overlaps the other's products. At the end warpgroup 1 hands its
// row states to warpgroup 0 through shared memory. K5 at D > 768 (HALF -1,
// `kStream`): K5's walk with no resident h, each box of the ring a W box and
// the h box of its D chunk (the h rows come again from L2 for every tile),
// 3 stages a warpgroup.
template <int MODE, int K, int HALF>
__global__ void __launch_bounds__(MODE == TOPK ? 256 : 384, 1)
argmax_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap bmap, bool has_bias,
              const int* __restrict__ targets, float* __restrict__ pm, float* __restrict__ ps,
              int* __restrict__ pa, float* __restrict__ pg, int rows, int d, int v,
              int tiles_per_split) {
  constexpr bool kProducer = MODE != TOPK;
  constexpr bool kStream = HALF < 0;
  constexpr int SB = kStream ? 2 * A_BOX : A_BOX;  // bytes of a ring stage
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes need 1024-byte aligned shared addresses
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const ArgLayout L = arg_layout(d, kStream);
  unsigned char* hs = base;
  unsigned char* ws = base + L.w;
  float* bs = reinterpret_cast<float*>(base + L.bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + L.stages;
  uint64_t* bfull = empty + L.stages;  // bias slot w serves warpgroup w's tiles
  uint64_t* bempty = bfull + 2;
  uint64_t* hbar = bempty + 2;
  uint64_t* go = hbar + 1;  // K5: warpgroup 0's first tile's products are done

  const int half = kStream ? 3 : HALF ? HALF : ring_half(d);
  const int tile0 = blockIdx.y * tiles_per_split;
  const int ntiles = min(tiles_per_split, (v + AN - 1) / AN - tile0);
  const int row_base = blockIdx.x * AM;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per warp of the warpgroup it serves
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bfull[i], 1);
      mbar_init(&bempty[i], 4);
    }
    mbar_init(hbar, 1);
    mbar_init(go, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (kProducer && threadIdx.x >= 256) {
    // producer: the h tile once, then per vocab tile its bias and nk W boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(hbar, L.nk * A_BOX);
      for (int c = 0; c < L.nk; ++c) tma_load_2d(hs + c * A_BOX, &hmap, hbar, c * AK, row_base);
      for (int t = 0; t < ntiles; ++t) {
        const int v0 = (tile0 + t) * AN, w = t & 1;
        if (has_bias) {
          mbar_wait(&bempty[w], ((t >> 1) & 1) ^ 1);
          mbar_expect_tx(&bfull[w], AN * 4);
          tma_load_1d(bs + w * AN, &bmap, &bfull[w], v0);
        }
        for (int c = 0; c < L.nk; ++c) {
          const int it = (t >> 1) * L.nk + c, st = w * half + it % half;
          mbar_wait(&empty[st], ((it / half) & 1) ^ 1);
          mbar_expect_tx(&full[st], A_BOX);
          tma_load_2d(ws + st * A_BOX, &wmap, &full[st], c * AK, v0);
        }
      }
    }
    return;
  }
  if (kProducer) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // warp-uniform as the compiler can see it, which keeps the wgmmas unserialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31, q = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const int mine = (ntiles - wg + 1) >> 1;  // this warpgroup's tiles: wg, wg + 2, ...
  const int boxes = mine * L.nk;
  // K5: box `it` of this warpgroup (its tile it / nk, D chunk it % nk) into its stage.
  auto load_box = [&](int it) {
    const int s = wg * half + it % half;
    mbar_expect_tx(&full[s], SB);
    tma_load_2d(ws + s * SB, &wmap, &full[s], (it % L.nk) * AK,
                (tile0 + wg + 2 * (it / L.nk)) * AN);
    if (kStream) tma_load_2d(ws + s * SB + A_BOX, &hmap, &full[s], (it % L.nk) * AK, row_base);
  };
  auto load_bias = [&](int ti) {
    mbar_expect_tx(&bfull[wg], AN * 4);
    tma_load_1d(bs + wg * AN, &bmap, &bfull[wg], (tile0 + wg + 2 * ti) * AN);
  };
  // The products on box `it` are done in this warp. K5: once all four
  // warps are, the leader refills its stage with box it + half; the whole
  // warpgroup waits, and the leader's branch holds no loop: a wait inside a
  // one-thread branch makes the compiler serialize the wgmmas (C7520).
  auto release = [&](int it) {
    const int s = wg * half + it % half;
    if (lane == 0) mbar_arrive(&empty[s]);
    if (!kProducer && it + half < boxes) {
      mbar_wait(&empty[s], (it / half) & 1);
      if (leader) load_box(it + half);
    }
  };
  if (!kProducer) {
    if (!kStream && threadIdx.x == 0) mbar_expect_tx(hbar, L.nk * A_BOX);
#pragma unroll
    for (int c = 0; c < (MAX_D_RESIDENT + AK - 1) / AK; ++c)
      if (!kStream && threadIdx.x == 0 && c < L.nk)
        tma_load_2d(hs + c * A_BOX, &hmap, hbar, c * AK, row_base);
#pragma unroll
    for (int it = 0; it < 3; ++it)
      if (leader && it < min(half, boxes)) load_box(it);
    if (leader && has_bias && mine > 0) load_bias(0);
  }

  // this thread's rows: acc0 holds rows r and r + 8, acc1 rows r + 64 and r + 72
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  int tg[4] = {-1, -1, -1, -1};
  if (keeps_target(MODE)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row_base + r + (i & 1) * 8 + (i >> 1) * 64;
      if (row < rows) tg[i] = targets[row];
    }
  }
  RowState st[4];
  TopList<K, true> tl[4];  // ids from the split's first column, tile0 * AN
  float th[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  if (!kStream && mine > 0) mbar_wait(hbar, 0);
  if (!kProducer && wg == 1 && mine > 1) mbar_wait(go, 0);
  for (int ti = 0; ti < mine; ++ti) {
    const int v0 = (tile0 + wg + 2 * ti) * AN;
    wgmma_fence();
    fence_acc(acc0);
    fence_acc(acc1);
    for (int c = 0; c < L.nk; ++c) {
      const int it = ti * L.nk + c, s = wg * half + it % half;
      mbar_wait(&full[s], (it / half) & 1);
      // rows 64..127 of a box start 8 KB in: 512 in the descriptor's 16-byte units
      const uint64_t da = desc_sw128(kStream ? ws + s * SB + A_BOX : hs + c * A_BOX),
                     db = desc_sw128(ws + s * SB);
#pragma unroll
      for (int k = 0; k < AK / 16; ++k) {
        wgmma_m64n128k16(acc0, da + 2 * k, db + 2 * k, c | k);
        wgmma_m64n128k16(acc1, da + 512 + 2 * k, db + 2 * k, c | k);
      }
      wgmma_commit();
      if (half == 1) {  // one stage: free it before the next box
        wgmma_wait<0>();
        release(it);
      } else if (c > 0) {  // the previous box's products are done: free its stage
        wgmma_wait<1>();
        release(it - 1);
      }
    }
    wgmma_wait<0>();
    if (half > 1) release(ti * L.nk + L.nk - 1);
    fence_acc(acc0);
    fence_acc(acc1);
    if (!kProducer && wg == 0 && ti == 0 && threadIdx.x == 0) mbar_arrive(go);

    const float* b = bs + wg * AN;
    if (has_bias) mbar_wait(&bfull[wg], ti & 1);
    const int vr = v0 - tile0 * AN;  // the tile's first column in the split
    if (v0 + AN > v) {
      fold<MODE, K, true>(acc0, b, has_bias, v0, vr, v, q, tg[0], tg[1], st[0], st[1], tl[0],
                          tl[1], th[0], th[1]);
      fold<MODE, K, true>(acc1, b, has_bias, v0, vr, v, q, tg[2], tg[3], st[2], st[3], tl[2],
                          tl[3], th[2], th[3]);
    } else {
      fold<MODE, K, false>(acc0, b, has_bias, v0, vr, v, q, tg[0], tg[1], st[0], st[1], tl[0],
                           tl[1], th[0], th[1]);
      fold<MODE, K, false>(acc1, b, has_bias, v0, vr, v, q, tg[2], tg[3], st[2], st[3], tl[2],
                           tl[3], th[2], th[3]);
    }
    if (MODE == TOPK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        th[i] = fmaxf(tl[i].v[K - 1], __shfl_xor_sync(0xffffffffu, tl[i].v[K - 1], 1));
        th[i] = fmaxf(th[i], __shfl_xor_sync(0xffffffffu, th[i], 2));
      }
    }
    if (has_bias) {  // the slot is read (K5: the leader loads the next tile's bias into it)
      if (lane == 0) mbar_arrive(&bempty[wg]);
      if (!kProducer && ti + 1 < mine) {
        mbar_wait(&bempty[wg], ti & 1);
        if (leader) load_bias(ti + 1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) lane_merge<MODE, K>(st[i], tl[i]);

  // Both warpgroups are past their last product and every box is
  // consumed, so the W ring is free: warpgroup 1's states go through it.
  RowHandoff<K>* xs = reinterpret_cast<RowHandoff<K>*>(ws);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (wg == 1 && q == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      RowHandoff<K>& x = xs[r + (i & 1) * 8 + (i >> 1) * 64];
      x.st = st[i];
      if (MODE == TOPK) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          x.v[j] = tl[i].v[j];
          x.i[j] = tl[i].i.get(j);
        }
      }
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (wg == 0 && q == 0) {
    const size_t at = (size_t)blockIdx.y * rows;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rt = r + (i & 1) * 8 + (i >> 1) * 64;
      const RowHandoff<K>& o = xs[rt];
      merge_state<MODE>(st[i], o.st.m, o.st.s, o.st.g, o.st.arg);
      if (MODE == TOPK) {
#pragma unroll
        for (int j = 0; j < K; ++j) tl[i].merge(o.v[j], o.i[j]);
      }
      const int row = row_base + rt;
      if (row < rows) {
        pm[at + row] = st[i].m;
        ps[at + row] = st[i].s;
        if (keeps_target(MODE)) pg[at + row] = st[i].g;
        if (keeps_arg(MODE)) pa[at + row] = st[i].arg;
        if (MODE == TOPK) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int id = tl[i].i.get(j);
            pg[(at + row) * K + j] = tl[i].v[j];
            pa[(at + row) * K + j] = id == TopIds<K, true>::kNone ? 0x7fffffff : tile0 * AN + id;
          }
        }
      }
    }
  }
}

// Folds the splits' partial states; no atomics. K3 / K4 / K9: a thread per
// row, splits in order, so the earlier split (the lower id) keeps a tie;
// writes the argmax id and max prob 1 / sum-exp, prob = exp(target logit -
// max) / sum-exp, or (K9) the label log-prob (logit - max) - log(sum-exp)
// with the argmax id and z = max + log(sum-exp) into out2. K5: a warp per
// row (a row has up to ~80 splits), lane j folding splits j, j + 32, ...,
// then the lanes by shuffles in a fixed order (pairs rank by value, then the
// lower id, in any order); writes the K best log-probs (logit - max) -
// log(sum-exp) with their ids, (rows, K) each.
template <int MODE, int K>
__global__ void argmax_merge_kernel(const float* __restrict__ pm, const float* __restrict__ ps,
                                    const int* __restrict__ pa, const float* __restrict__ pg,
                                    int* __restrict__ ids, float* __restrict__ out,
                                    float* __restrict__ out2, int rows, int splits) {
  if constexpr (MODE == TOPK) {
    const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
    if (r >= rows) return;  // the whole warp: the row is the warp's
    float m = -INFINITY, s = 0.f;
    TopList<K> t;
    for (int j = lane; j < splits; j += 32) {
      const size_t at = (size_t)j * rows + r;
      lse_merge(m, s, pm[at], ps[at]);
#pragma unroll
      for (int q = 0; q < K; ++q) t.merge(pg[at * K + q], pa[at * K + q]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float ov[K];
      int oi[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        ov[q] = __shfl_xor_sync(0xffffffffu, t.v[q], off);
        oi[q] = __shfl_xor_sync(0xffffffffu, t.i.get(q), off);
      }
      lse_merge(m, s, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, s, off));
#pragma unroll
      for (int q = 0; q < K; ++q) t.merge(ov[q], oi[q]);
    }
    if (lane == 0) {
      const float lse = logf(s);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        out[(size_t)r * K + q] = (t.v[q] - m) - lse;
        ids[(size_t)r * K + q] = t.i.get(q);
      }
    }
  } else {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    float m = pm[r], s = ps[r], g = keeps_target(MODE) ? pg[r] : 0.f;
    int arg = keeps_arg(MODE) ? pa[r] : 0;
    for (int j = 1; j < splits; ++j) {
      const size_t at = (size_t)j * rows + r;
      const float m2 = pm[at];
      if (keeps_target(MODE)) g = fmaxf(g, pg[at]);
      if (keeps_arg(MODE) && m2 > m) arg = pa[at];
      lse_merge(m, s, m2, ps[at]);
    }
    if (MODE == CE) {
      const float lse = logf(s);
      out[r] = (g - m) - lse;
      ids[r] = arg;
      out2[r] = m + lse;
    } else if (MODE == GATHER) {
      out[r] = expf(g - m) / s;
    } else {
      ids[r] = arg;
      out[r] = 1.f / s;  // max prob = exp(m - m) / sum-exp
    }
  }
}

template <int MODE, int K>
int launch_walk(const void* h, const void* w, const void* bias, const void* targets, void* ids,
                void* out, void* out2, void* pm, void* ps, void* pa, void* pg, int rows, int d,
                int v, int splits, int tiles_per_split, void* stream) {
  const int tiles = (v + AN - 1) / AN;
  const bool streamed = MODE == TOPK && d > MAX_D_RESIDENT;  // K5's h streamed with W
  if (rows < 1 || v < 1 || d < 16 || d % 16 || d > (streamed ? MAX_D_STREAM : MAX_D_RESIDENT) ||
      splits < 1 || tiles_per_split < 1 || (splits - 1) * tiles_per_split >= tiles ||
      splits * tiles_per_split < tiles)
    return (int)cudaErrorInvalidValue;
  const ArgLayout L = arg_layout(d, streamed);
  if (L.bytes > A_SMEM || (MODE == TOPK && tiles_per_split * AN > 65535))
    return (int)cudaErrorInvalidValue;  // K5's lists hold 16-bit ids within a split
  CUtensorMap hmap, wmap, bmap;
  if (!encode_map(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h, rows, d, AM, AK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, v, d, AN, AK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      (bias && !encode_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bias, 0, v, 1, AN,
                           CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  if (!bias) bmap = wmap;  // never read
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, bool, const int*, float*, float*, int*,
                 float*, int, int, int, int);
  if constexpr (MODE == TOPK)
    kernel = streamed ? argmax_kernel<MODE, K, -1> : argmax_kernel<MODE, K, 0>;
  else
    kernel = ring_half(d) == 3 ? argmax_kernel<MODE, K, 3> : argmax_kernel<MODE, K, 1>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((rows + AM - 1) / AM, splits), MODE == TOPK ? 256 : 384, L.bytes, st>>>(
      hmap, wmap, bmap, bias != nullptr, static_cast<const int*>(targets),
      static_cast<float*>(pm), static_cast<float*>(ps), static_cast<int*>(pa),
      static_cast<float*>(pg), rows, d, v, tiles_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int merge_threads = MODE == TOPK ? rows * 32 : rows;
  argmax_merge_kernel<MODE, K><<<(merge_threads + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(ps), static_cast<const int*>(pa),
      static_cast<const float*>(pg), static_cast<int*>(ids), static_cast<float*>(out),
      static_cast<float*>(out2), rows, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// h (rows, d) bf16; w (v, d) bf16; bias (v,) f32 or null -> lp (rows, k) f32
// descending, ids (rows, k) i32. All 16-byte aligned. Scratch from the
// caller: pm, ps (splits x rows) f32, pv (splits x rows x k) f32, pi (splits
// x rows x k) i32; the vocab is cut into `splits` runs of tiles_per_split
// 128-column tiles, none empty, each at most 511 tiles (65535 columns: the
// lists' 16-bit ids; ops/vocab_fused.py argmax_splits with TOPK_MAX_TILES).
NAVC_EXPORT int navc_project_topk(const void* h, const void* w, const void* bias, void* lp,
                                  void* ids, void* pm, void* ps, void* pv, void* pi, int rows,
                                  int d, int v, int k, int splits, int tiles_per_split,
                                  void* stream) {
  if (k < 1 || k > MAX_K || k > v) return (int)cudaErrorInvalidValue;
#define NAVC_TOPK(K)                                                                          \
  case K:                                                                                      \
    return launch_walk<TOPK, K>(h, w, bias, nullptr, ids, lp, nullptr, pm, ps, pi, pv, rows, d, v, \
                                splits, tiles_per_split, stream);
  switch (k) {
    NAVC_TOPK(1)
    NAVC_TOPK(2)
    NAVC_TOPK(3)
    NAVC_TOPK(4)
    NAVC_TOPK(5)
    NAVC_TOPK(6)
    NAVC_TOPK(7)
    NAVC_TOPK(8)
  }
#undef NAVC_TOPK
  return (int)cudaErrorInvalidValue;
}

// h (rows, d) bf16; w (v, d) bf16; bias (v,) f32 or null -> ids (rows,) i32,
// maxp (rows,) f32. All 16-byte aligned. Scratch from the caller: pm, ps
// (splits x rows) f32, pa (splits x rows) i32; the vocab is cut into
// `splits` runs of tiles_per_split 128-column tiles, none empty.
NAVC_EXPORT int navc_project_argmax(const void* h, const void* w, const void* bias, void* ids,
                                    void* maxp, void* pm, void* ps, void* pa, int rows, int d,
                                    int v, int splits, int tiles_per_split, void* stream) {
  return launch_walk<ARGMAX, 1>(h, w, bias, nullptr, ids, maxp, nullptr, pm, ps, pa, nullptr, rows,
                                d, v, splits, tiles_per_split, stream);
}

// As navc_project_argmax, with targets (rows,) i32 -> prob (rows,) f32;
// pg (splits x rows) f32 takes the place of pa.
NAVC_EXPORT int navc_project_gather_prob(const void* h, const void* w, const void* bias,
                                         const void* targets, void* prob, void* pm, void* ps,
                                         void* pg, int rows, int d, int v, int splits,
                                         int tiles_per_split, void* stream) {
  return launch_walk<GATHER, 1>(h, w, bias, targets, nullptr, prob, nullptr, pm, ps, nullptr, pg,
                                rows, d, v, splits, tiles_per_split, stream);
}

// K9: as navc_project_argmax and navc_project_gather_prob together, with
// labels (rows,) i32 in [0, V) -> g (rows,) f32 label log-prob, pred (rows,)
// i32 first argmax, z (rows,) f32 log-sum-exp; scratch pa (splits x rows) i32
// and pg (splits x rows) f32 both.
NAVC_EXPORT int navc_ce_fwd(const void* h, const void* w, const void* bias, const void* labels,
                            void* g, void* pred, void* z, void* pm, void* ps, void* pa, void* pg,
                            int rows, int d, int v, int splits, int tiles_per_split,
                            void* stream) {
  return launch_walk<CE, 1>(h, w, bias, labels, pred, g, z, pm, ps, pa, pg, rows, d, v, splits,
                            tiles_per_split, stream);
}
