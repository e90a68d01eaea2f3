// Vocab projection fused with an online softmax: argmax id + max probability
// (K3), the probability of a given target id (K4) and the top-k log-probs
// with their ids (K5), without writing the (rows, V) logits to device memory.
//
// Replaces: navc_tpu/ops/vocab_fused.py fused_project_argmax (pallas_call at
// :128, body _kernel :36), fused_project_gather_prob (pallas_call at :229,
// body _gather_kernel :152) and fused_project_topk (pallas_call at :350, body
// _topk_kernel :246).
//
// What bounds it on the H100: the product h @ W^T. At the main path's dense
// shape (12288 x 512 x 10048) that is 126 GFLOP against ~23 MB of operands,
// so the bf16 tensor-core rate bounds it: 0.128 ms at 989 TFLOP/s. W (10 MB)
// stays in the 50 MB L2; a block of 128 rows reads 128 bytes of W from L2
// for every 256 bf16 FLOPs.
//
// K3 / K4 (argmax_kernel + argmax_merge_kernel): a block of three
// warpgroups takes 128 rows of h and one vocab split.
// - Ring: the producer warpgroup's first thread loads the block's h rows
//   once (resident: ceil(D/64) TMA boxes of 128 x 64 bf16, 128-byte
//   swizzle), then streams W in nn.Linear's own (V, D) layout, one 128 x 64
//   box per stage, with full/empty mbarriers. The ring has a half per
//   consumer warpgroup, 3 stages each (1 for D > 512, where h takes up to
//   192 KB); the 128 bias values of each vocab tile come by TMA into that
//   warpgroup's slot, once per tile. TMA zero-fills the ragged row edge and
//   the D and vocab edges: W and h need no padded copies.
// - wgmma: h (R, D) is the K-major A operand and W (V, D) the K-major B
//   operand, so neither is transposed. Consumer warpgroup w takes the
//   split's vocab tiles w, w + 2, ... for all 128 rows (two m64n128k16
//   products per 16 of D, float32 accumulators in 128 registers a thread;
//   setmaxnreg moves registers from the producer to the consumers) and
//   frees each stage once the products on it are done. The producer loads
//   tile by tile, so warpgroup 1's boxes arrive after warpgroup 0's: the two
//   run half a step apart, and one's epilogue overlaps the other's products
//   (with both warpgroups on the same tiles, 64 rows each, they ran in
//   lockstep and the tensor cores idled through every epilogue).
// - Epilogue on the accumulator registers: each thread holds 4 rows x 32
//   columns of a tile, adds the staged bias, masks columns >= V by index
//   (zero is not -inf) on the last tile only, takes each row's tile max and
//   its first column, then rescales the running sum once and adds exp2 of
//   every score with log2(e) folded in. No score tile goes through shared
//   memory. At the end the 4 lanes of a row merge by shuffles, and
//   warpgroup 1 hands its rows' states to warpgroup 0 through the (then
//   idle) ring.
// - Split: the grid is row tiles x vocab splits, planned on the host
//   (ops/vocab_fused.py `argmax_splits`) so that the dense call and each
//   sparse call fill the 132 SMs in whole waves; each block writes a partial
//   (max, sum-exp, argmax | target logit) per row, and a second small kernel
//   (a thread per row) folds the splits in order. No atomics: deterministic.
// - Ties: the lowest id wins within a thread (strict '>' in rising column
//   order), across a warpgroup's tiles (a later tile must be strictly
//   greater), across lanes and warpgroups (lower id on equal maxima) and
//   across splits (folded in order, strict '>'), as the Pallas kernel's
//   first argmax does. A target outside [0, V) matches no column: its logit
//   stays -1e30 and its prob is 0.
//
// K5 (the AR beam step's top-k) still runs the older tile loop of
// vocab_tile.cuh (wmma 16x16x16, W staged by hand, no load/product
// overlap): each thread also keeps the MAX_K best (value, id) pairs of its
// columns in registers, sorted by value and then by lower id (strict '>' in
// column order; the lower id wins a tie in every merge, which is
// lax.top_k's order). At serving shapes the beam step has few rows (320 at
// 64 videos x beam 5: 5 row tiles), so one block per row tile would leave
// most of the 132 SMs idle; the vocab axis is therefore split across
// blockIdx.y, each block writes its partial (max, sum-exp, top MAX_K) per
// row, and a second small kernel (a warp per row) merges the splits and
// writes (logit - max) - log(sum-exp) for the first k.

#include "hopper.cuh"
#include "vocab_tile.cuh"

namespace {

constexpr int MAX_K = 8;  // beam sizes 1..8; the wrapper refuses more

// (a, ia) ranks before (b, ib): larger value, then lower id (lax.top_k's order)
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// Insert (x, id) into the sorted register list (tv, ti), dropping its last
// entry; fully unrolled so the list stays in registers.
__device__ __forceinline__ void topk_insert(float (&tv)[MAX_K], int (&ti)[MAX_K], float x, int id) {
  if (!before(x, id, tv[MAX_K - 1], ti[MAX_K - 1])) return;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (before(x, id, tv[j], ti[j])) {
      const float fv = tv[j];
      const int fi = ti[j];
      tv[j] = x;
      ti[j] = id;
      x = fv;
      id = fi;
    }
  }
}

// Merge two (max, sum-exp) states of one row.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  const float sa = (m == -INFINITY) ? 0.f : s * expf(m - mn);
  const float sb = (m2 == -INFINITY) ? 0.f : s2 * expf(m2 - mn);
  s = sa + sb;
  m = mn;
}

// Grid (row tiles, vocab splits): block (i, j) walks the vocab tiles of split
// j for rows [64 i, 64 i + 64) and writes each row's partial state: max and
// sum-exp (pm, ps: rows x splits) and its MAX_K best (pv, pi: rows x splits x
// MAX_K).
__global__ void __launch_bounds__(NTHREADS)
topk_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ pm, float* __restrict__ ps,
            float* __restrict__ pv, int* __restrict__ pi, int rows, int d, int v,
            int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + PAD;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + TM * ld;
  float* sc = reinterpret_cast<float*>(ws + TV * ld);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int split = blockIdx.y, splits = gridDim.y;
  stage_h(hs, h, row0, rows, d);

  const int r = tid >> 2;
  const int part = tid & 3;
  float m = -INFINITY, s = 0.f;
  float tv[MAX_K];
  int ti[MAX_K];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    tv[j] = -INFINITY;
    ti[j] = 0x7fffffff;
  }

  const int v_begin = split * tiles_per_split * TV;
  const int v_end = min(v, v_begin + tiles_per_split * TV);
  for (int v0 = v_begin; v0 < v_end; v0 += TV) {
    score_tile(hs, ws, sc, w, v0, v, d);
    const float* srow = sc + r * SC_LD + part * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = v0 + part * 16 + j;
      if (col < v) {
        const float x = srow[j] + (bias ? bias[col] : 0.f);
        if (x > m) {
          s = s * expf(m - x) + 1.f;
          m = x;
        } else {
          s += expf(x - m);
        }
        topk_insert(tv, ti, x, col);
      }
    }
  }

  // merge the 4 partial states of a row (lanes 4k .. 4k+3 of one warp); the
  // partner's list is read whole before this thread's list changes
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    float ov[MAX_K];
    int oi[MAX_K];
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      ov[j] = __shfl_xor_sync(0xffffffffu, tv[j], off);
      oi[j] = __shfl_xor_sync(0xffffffffu, ti[j], off);
    }
    lse_merge(m, s, m2, s2);
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) topk_insert(tv, ti, ov[j], oi[j]);
  }
  if (part == 0 && row0 + r < rows) {
    const size_t at = (size_t)(row0 + r) * splits + split;
    pm[at] = m;
    ps[at] = s;
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      pv[at * MAX_K + j] = tv[j];
      pi[at * MAX_K + j] = ti[j];
    }
  }
}

// One warp per row: lane j folds splits j, j + 32, ... into its state, the
// 32 states merge by shuffles, and lane 0 writes the first k log-probs
// (logit - max) - log(sum-exp) with their ids.
__global__ void topk_merge_kernel(const float* __restrict__ pm, const float* __restrict__ ps,
                                  const float* __restrict__ pv, const int* __restrict__ pi,
                                  float* __restrict__ lp, int* __restrict__ ids, int rows,
                                  int splits, int k) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp: row is the warp's
  const size_t base = (size_t)row * splits;
  float m = -INFINITY, s = 0.f;
  float tv[MAX_K];
  int ti[MAX_K];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    tv[j] = -INFINITY;
    ti[j] = 0x7fffffff;
  }
  for (int j = lane; j < splits; j += 32) {
    lse_merge(m, s, pm[base + j], ps[base + j]);
#pragma unroll
    for (int q = 0; q < MAX_K; ++q)
      topk_insert(tv, ti, pv[(base + j) * MAX_K + q], pi[(base + j) * MAX_K + q]);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    float ov[MAX_K];
    int oi[MAX_K];
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      ov[j] = __shfl_xor_sync(0xffffffffu, tv[j], off);
      oi[j] = __shfl_xor_sync(0xffffffffu, ti[j], off);
    }
    lse_merge(m, s, m2, s2);
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) topk_insert(tv, ti, ov[j], oi[j]);
  }
  if (lane == 0) {
    const float lse = logf(s);
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      if (j < k) {
        lp[(size_t)row * k + j] = (tv[j] - m) - lse;
        ids[(size_t)row * k + j] = ti[j];
      }
    }
  }
}

// ---- K3 / K4: the TMA + wgmma tile walk with a vocab split ----------------

constexpr int AM = 128;            // rows of h per block: two consumer warpgroups of 64
constexpr int AN = 128;            // vocab columns per tile (the wgmma's N)
constexpr int AK = 64;             // D per TMA box: 64 bf16, one 128-byte swizzled row
constexpr int A_THREADS = 384;     // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int A_BOX = AM * AK * 2; // bytes of one h box and of one W box (AN == AM)
constexpr int A_SMEM = 232448;     // shared memory a block may use on the H100
constexpr float LOG2E = 1.4426950408889634f;

// W ring stages per consumer warpgroup: 3 while the h tile takes at most
// 128 KB (D <= 512), else 1 (D <= 768: h takes up to 192 KB).
__host__ __device__ inline int ring_half(int d) { return d <= 512 ? 3 : 1; }

// Byte offsets from the 1024-aligned base of dynamic shared memory: the
// resident h tile (nk boxes), the ring of W boxes, two bias tiles, the
// barriers; `bytes` (at most A_SMEM) includes the alignment slack.
struct ArgLayout {
  int nk, stages, w, bias, bars, bytes;
};

__host__ __device__ inline ArgLayout arg_layout(int d) {
  ArgLayout L;
  L.nk = (d + AK - 1) / AK;
  L.w = L.nk * A_BOX;
  L.stages = 2 * ring_half(d);
  L.bias = L.w + L.stages * A_BOX;
  L.bars = L.bias + 2 * AN * 4;
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
// max, first reached at column targ.
template <int OFF>
__device__ __forceinline__ void absorb(RowState& r, float tmax, int targ, const float (&acc)[64]) {
  const float mn = fmaxf(r.m, tmax);
  const float mref = mn == -INFINITY ? 0.f : mn * LOG2E;
  float s0 = r.s * ex2(fmaf(r.m, LOG2E, -mref)), s1 = 0.f;
#pragma unroll
  for (int j = 0; j < AN / 8; ++j) {
    s0 += ex2(fmaf(acc[4 * j + OFF], LOG2E, -mref));
    s1 += ex2(fmaf(acc[4 * j + OFF + 1], LOG2E, -mref));
  }
  r.s = s0 + s1;
  if (tmax > r.m) r.arg = targ;  // a tie keeps the earlier (lower) column
  r.m = mn;
}

// The epilogue of one vocab tile on the accumulator registers. This
// thread holds rows (lane / 4) and (lane / 4 + 8) of its warp's 16, and
// columns 8j + 2q + {0, 1} (q = lane % 4) of the tile, in rising order.
// EDGE: the tile passes the vocab's end, whose columns are masked by index
// (TMA zero-filled them; zero is not -inf).
template <bool GATHER, bool EDGE>
__device__ __forceinline__ void fold(float (&acc)[64], const float* b, bool has_bias, int v0,
                                     int v, int q, int tg0, int tg1, RowState& r0, RowState& r1) {
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
      if (GATHER) {
        if (col == rel0) r0.g = x0;
        if (col == rel1) r1.g = x1;
      }
    }
  }
  absorb<0>(r0, t0, v0 + 2 * q + i0, acc);
  absorb<2>(r1, t1, v0 + 2 * q + i1, acc);
}

// Merges another state of the same row into r; the lower id wins a tie.
__device__ __forceinline__ void merge_state(RowState& r, float m2, float s2, float g2, int a2) {
  if (m2 > r.m || (m2 == r.m && a2 < r.arg)) r.arg = a2;
  lse_merge(r.m, r.s, m2, s2);
  r.g = fmaxf(r.g, g2);
}

// Merges the states of the 4 lanes that share a row.
__device__ __forceinline__ void lane_merge(RowState& r) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
    merge_state(r, __shfl_xor_sync(0xffffffffu, r.m, off), __shfl_xor_sync(0xffffffffu, r.s, off),
                __shfl_xor_sync(0xffffffffu, r.g, off), __shfl_xor_sync(0xffffffffu, r.arg, off));
}

// Grid (row tiles of AM, vocab splits): block (i, j) keeps rows [AM i,
// AM i + AM) of h in shared memory and walks the vocab tiles of split j,
// writing each row's partial state to pm, ps and pa (argmax) or pg (target
// logit), laid out (splits, rows). Warpgroup 2's first thread loads by TMA,
// in tile order. Consumer warpgroup w multiplies all AM rows by the split's
// tiles w, w + 2, ... and folds their scores. Each has its half of the ring
// (so it waits on no barrier more than one phase ahead), and its tiles'
// boxes are loaded after the other's: the two run half a step apart and
// one's epilogue overlaps the other's products. At the end warpgroup 1
// hands its row states to warpgroup 0 through shared memory.
template <bool GATHER, int HALF>
__global__ void __launch_bounds__(A_THREADS, 1)
argmax_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap bmap, bool has_bias,
              const int* __restrict__ targets, float* __restrict__ pm, float* __restrict__ ps,
              int* __restrict__ pa, float* __restrict__ pg, int rows, int d, int v,
              int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes need 1024-byte aligned shared addresses
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const ArgLayout L = arg_layout(d);
  unsigned char* hs = base;
  unsigned char* ws = base + L.w;
  float* bs = reinterpret_cast<float*>(base + L.bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + L.stages;
  uint64_t* bfull = empty + L.stages;  // bias slot w serves warpgroup w's tiles
  uint64_t* bempty = bfull + 2;
  uint64_t* hbar = bempty + 2;

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: the h tile once, then per vocab tile its bias and nk W boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(hbar, L.nk * A_BOX);
      for (int c = 0; c < L.nk; ++c) tma_load_2d(hs + c * A_BOX, &hmap, hbar, c * AK, row_base);
      constexpr int half = HALF;
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
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // warp-uniform as the compiler can see it, which keeps the wgmmas unserialized
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
    constexpr int half = HALF;
    const int lane = threadIdx.x & 31, q = lane & 3;
    // this thread's rows: acc0 holds rows r and r + 8, acc1 rows r + 64 and r + 72
    const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    int tg[4] = {-1, -1, -1, -1};
    if (GATHER) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row_base + r + (i & 1) * 8 + (i >> 1) * 64;
        if (row < rows) tg[i] = targets[row];
      }
    }
    RowState st[4];
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    mbar_wait(hbar, 0);
    for (int t = wg; t < ntiles; t += 2) {
      const int v0 = (tile0 + t) * AN;
      wgmma_fence();
      fence_acc(acc0);
      fence_acc(acc1);
      for (int c = 0; c < L.nk; ++c) {
        const int it = (t >> 1) * L.nk + c, s = wg * half + it % half;
        mbar_wait(&full[s], (it / half) & 1);
        // rows 64..127 of a box start 8 KB in: 512 in the descriptor's 16-byte units
        const uint64_t da = desc_sw128(hs + c * A_BOX), db = desc_sw128(ws + s * A_BOX);
#pragma unroll
        for (int k = 0; k < AK / 16; ++k) {
          wgmma_m64n128k16(acc0, da + 2 * k, db + 2 * k, c | k);
          wgmma_m64n128k16(acc1, da + 512 + 2 * k, db + 2 * k, c | k);
        }
        wgmma_commit();
        if constexpr (HALF == 1) {  // one stage: free it before the next box
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(&empty[s]);
        } else if (c > 0) {  // the previous box's products are done: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[wg * half + (it - 1) % half]);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
      if (HALF > 1 && lane == 0)
        mbar_arrive(&empty[wg * half + ((t >> 1) * L.nk + L.nk - 1) % half]);

      const float* b = bs + wg * AN;
      if (has_bias) mbar_wait(&bfull[wg], (t >> 1) & 1);
      if (v0 + AN > v) {
        fold<GATHER, true>(acc0, b, has_bias, v0, v, q, tg[0], tg[1], st[0], st[1]);
        fold<GATHER, true>(acc1, b, has_bias, v0, v, q, tg[2], tg[3], st[2], st[3]);
      } else {
        fold<GATHER, false>(acc0, b, has_bias, v0, v, q, tg[0], tg[1], st[0], st[1]);
        fold<GATHER, false>(acc1, b, has_bias, v0, v, q, tg[2], tg[3], st[2], st[3]);
      }
      if (has_bias && lane == 0) mbar_arrive(&bempty[wg]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) lane_merge(st[i]);

    // Both warpgroups are past their last product and every box is
    // consumed, so the W ring is free: warpgroup 1's states go through it.
    RowState* xs = reinterpret_cast<RowState*>(ws);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 1 && q == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[r + (i & 1) * 8 + (i >> 1) * 64] = st[i];
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 0 && q == 0) {
      const size_t at = (size_t)blockIdx.y * rows;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rt = r + (i & 1) * 8 + (i >> 1) * 64;
        const RowState o = xs[rt];
        merge_state(st[i], o.m, o.s, o.g, o.arg);
        const int row = row_base + rt;
        if (row < rows) {
          pm[at + row] = st[i].m;
          ps[at + row] = st[i].s;
          if (GATHER) pg[at + row] = st[i].g; else pa[at + row] = st[i].arg;
        }
      }
    }
  }
}

// A thread per row folds the splits' partial states in split order, so the
// earlier split (the lower id) keeps a tie; no atomics. Writes the argmax id
// and max prob 1 / sum-exp, or prob = exp(target logit - max) / sum-exp.
template <bool GATHER>
__global__ void argmax_merge_kernel(const float* __restrict__ pm, const float* __restrict__ ps,
                                    const int* __restrict__ pa, const float* __restrict__ pg,
                                    int* __restrict__ ids, float* __restrict__ out, int rows,
                                    int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = pm[r], s = ps[r], g = GATHER ? pg[r] : 0.f;
  int arg = GATHER ? 0 : pa[r];
  for (int j = 1; j < splits; ++j) {
    const size_t at = (size_t)j * rows + r;
    const float m2 = pm[at];
    if (GATHER) g = fmaxf(g, pg[at]);
    else if (m2 > m) arg = pa[at];
    lse_merge(m, s, m2, ps[at]);
  }
  if (GATHER) {
    out[r] = expf(g - m) / s;
  } else {
    ids[r] = arg;
    out[r] = 1.f / s;  // max prob = exp(m - m) / sum-exp
  }
}

template <bool GATHER>
int launch_argmax(const void* h, const void* w, const void* bias, const void* targets, void* ids,
                  void* out, void* pm, void* ps, void* px, int rows, int d, int v, int splits,
                  int tiles_per_split, void* stream) {
  const int tiles = (v + AN - 1) / AN;
  if (rows < 1 || v < 1 || d < 16 || d % 16 || d > 768 || splits < 1 || tiles_per_split < 1 ||
      (splits - 1) * tiles_per_split >= tiles || splits * tiles_per_split < tiles)
    return (int)cudaErrorInvalidValue;
  const ArgLayout L = arg_layout(d);
  if (L.bytes > A_SMEM) return (int)cudaErrorInvalidValue;
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
                 float*, int, int, int, int) =
      ring_half(d) == 3 ? argmax_kernel<GATHER, 3> : argmax_kernel<GATHER, 1>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* pa = GATHER ? nullptr : static_cast<int*>(px);
  float* pg = GATHER ? static_cast<float*>(px) : nullptr;
  kernel<<<dim3((rows + AM - 1) / AM, splits), A_THREADS, L.bytes, st>>>(
      hmap, wmap, bmap, bias != nullptr, static_cast<const int*>(targets),
      static_cast<float*>(pm), static_cast<float*>(ps), pa, pg, rows, d, v, tiles_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  argmax_merge_kernel<GATHER><<<(rows + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(ps), pa, pg,
      static_cast<int*>(ids), static_cast<float*>(out), rows, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// h (rows, d) bf16; w (v, d) bf16; bias (v,) f32 or null -> lp (rows, k) f32
// descending, ids (rows, k) i32. Scratch from the caller: pm, ps (rows x
// splits) f32, pv (rows x splits x 8) f32, pi (rows x splits x 8) i32; the
// vocab is cut into `splits` runs of tiles_per_split 64-column tiles.
NAVC_EXPORT int navc_project_topk(const void* h, const void* w, const void* bias, void* lp,
                                  void* ids, void* pm, void* ps, void* pv, void* pi, int rows,
                                  int d, int v, int k, int splits, int tiles_per_split,
                                  void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + TM - 1) / TM, splits);
  topk_kernel<<<grid, NTHREADS, smem, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<float*>(pm), static_cast<float*>(ps), static_cast<float*>(pv),
      static_cast<int*>(pi), rows, d, v, tiles_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(ps), static_cast<const float*>(pv),
      static_cast<const int*>(pi), static_cast<float*>(lp), static_cast<int*>(ids), rows, splits,
      k);
  return (int)cudaGetLastError();
}

// h (rows, d) bf16; w (v, d) bf16; bias (v,) f32 or null -> ids (rows,) i32,
// maxp (rows,) f32. All 16-byte aligned. Scratch from the caller: pm, ps
// (splits x rows) f32, pa (splits x rows) i32; the vocab is cut into
// `splits` runs of tiles_per_split 128-column tiles, none empty.
NAVC_EXPORT int navc_project_argmax(const void* h, const void* w, const void* bias, void* ids,
                                    void* maxp, void* pm, void* ps, void* pa, int rows, int d,
                                    int v, int splits, int tiles_per_split, void* stream) {
  return launch_argmax<false>(h, w, bias, nullptr, ids, maxp, pm, ps, pa, rows, d, v, splits,
                              tiles_per_split, stream);
}

// As navc_project_argmax, with targets (rows,) i32 -> prob (rows,) f32;
// pg (splits x rows) f32 takes the place of pa.
NAVC_EXPORT int navc_project_gather_prob(const void* h, const void* w, const void* bias,
                                         const void* targets, void* prob, void* pm, void* ps,
                                         void* pg, int rows, int d, int v, int splits,
                                         int tiles_per_split, void* stream) {
  return launch_argmax<true>(h, w, bias, targets, nullptr, prob, pm, ps, pg, rows, d, v, splits,
                             tiles_per_split, stream);
}
