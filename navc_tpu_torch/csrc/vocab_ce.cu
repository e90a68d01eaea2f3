// The backward of the vocab projection fused with the training step's
// cross-entropy (K10): dh, dW and db without writing the (rows, V) logits or
// their gradient to device memory. Its forward (K9) is a mode of
// vocab_fused.cu's walk (navc_ce_fwd), which leaves z = m + lse per row.
//
// Replaces: navc_tpu/ops/vocab_ce.py vocab_ce_train's backward (pallas_call
// at :152, body _bwd_kernel :69). Rounding points are the JAX kernel's: bf16
// operands, float32 scores (+ float32 bias), ds = bf16(dg * (onehot(y) -
// exp(s - z))), dh = ds W and dW = ds^T h summed in float32, db = the float32
// sum of the bf16 ds. A row whose dg is 0 (a PAD label, a row the valid_mask
// drops) gives an exactly zero ds row, so an exactly zero dh row.
//
// What bounds it on the H100: the products. The function is 6 N D V FLOPs
// (4 to dh: the score recompute and ds W; 2 to dW) against ~12 MB of
// operands at the B = 64 NACF pass (N = 1920, D = 512, V = 10048): the bf16
// tensor cores bound it (0.060 ms at 989 TFLOP/s; 1.92 ms at B = 2048, N =
// 61440). Each launch recomputes the scores, so the port does 8 N D V. A
// block of 64 rows (dh) or 64 vocab rows (dW) reads its streamed operand
// from L2 at 128 FLOPs per byte: on the H100 both launches stream 3.8-5.2
// TB/s through L2 (chip_smoke.py), its bandwidth the next limit.
//
// Two launches, no atomics (the TPU sums dW in VMEM over a sequential grid;
// CUDA blocks run in parallel), both TMA + wgmma on hopper.cuh with two
// warpgroups and no producer warp: 128 float32 accumulators a thread need
// more than the 168 registers ptxas gives a block whose SM register-file
// quarters hold three warps (288 threads spilled and serialized the
// wgmmas), so the first thread loads the ring; warpgroup 0 waits until both
// have freed a stage and that thread refills it.
//  * ce_bwd_dh_kernel, a flash-attention forward with the vocab in place of
//    the keys: a block keeps 64 rows of h resident (K-major boxes of 64
//    bf16, 128-byte swizzle) and streams W in 64-row vocab tiles through an
//    mbarrier ring of 2 stages (a 128-row tile leaves room for one stage
//    beside h and timed 10% slower at B = 2048: PERF.md). Per tile each
//    warpgroup computes its 32 columns of S = h W_tile^T, forms ds on the accumulator registers (bias, label, the
//    vocab edge masked by index: TMA zero-fills past V, and zero is not
//    -inf) and writes it into shared memory as bf16 in the swizzled K-major
//    layout; after a named barrier both multiply the whole ds tile by the
//    same W tile, which the boxes written as S's K-major B hold as this
//    product's MN-major B (rows along K = vocab, 64 of N = D each): W is
//    loaded once per tile and read through two descriptors. dh (64 x 512)
//    is 256 float32 accumulators a thread in one warpgroup, too many, so
//    warpgroup w owns D columns [256 w, 256 w + 256) (128 a thread; for D
//    <= 256 warpgroup 1 has none and skips the product). ds is double
//    buffered: a warpgroup writes tile t + 1's while the other may still
//    read tile t's. When the row tiles do not fill the card (N = 1920: 30),
//    the vocab is split across blocks (ops/vocab_ce.py `dh_plan`) into
//    float32 partial dh, summed in split order by a second small pass.
//  * ce_bwd_dw_kernel, the weight-gradient reduction with ds formed in
//    place: a block keeps one 64-row vocab tile of W resident and streams
//    64-row chunks of h. Per chunk: S = h_chunk W_tile^T (warpgroup w: vocab
//    columns [32 w, 32 w + 32)), ds into shared memory (bf16, rows
//    outermost) and into this thread's float32 column sums for db, then
//    dW_tile += ds^T h_chunk. Both operands of that product have the
//    reduction axis (rows) outermost, so both are MN-major, read through the
//    transpose bits (train_wgrad_kernel's product): the h boxes written as
//    S's K-major A are its MN-major B. At B = 2048 the rows are split across
//    blocks (ops/vocab_ce.py `dw_plan`) so that vocab tiles x splits fill
//    whole waves of 132 SMs (157 tiles alone leave a second wave of 25), and
//    a second pass sums the float32 partial dW and db in split order; at B
//    = 64 a split's partial dW costs more than the half-empty second wave.
// Rows with dg = 0 (PAD labels: about 51% and 73% of the rows of the B =
// 2048 bench batch's two passes, PERF.md) give exactly zero ds rows, so
// neither launch runs them. A compaction first (navc_ce_live_first: one
// block scans dg, then a gather) puts the rows with dg != 0 first, in a
// stable order `order`, gathering h, labels, z and dg into it, and leaves
// their count on the device, `live`: no host sync, and one call where
// PyTorch's sort, count and gathers took four operators and ~185 us of host
// time a call beside an H100 (chip_smoke.py); the host bounds the B = 64
// step. A dh block past the live rows exits (the wrapper zeroes dh) and the
// others scatter their rows back through `order`; the dW launch cuts the
// live rows' chunks into its row splits on the device. Both are
// deterministic: every sum runs in a fixed order, so two calls give the
// same bits.

#include "hopper.cuh"

namespace {

constexpr int CT = 64;                 // rows per dh block and per dW chunk; vocab per dW block
constexpr int CK = 64;                 // D per TMA box: 64 bf16, one 128-byte swizzled row
constexpr int TV = 64;                 // vocab rows per dh tile
constexpr int MAX_D = 512;             // 256 of D per warpgroup's accumulators
constexpr int NBOX = MAX_D / CK;       // D boxes of a tile
constexpr int BOX = CT * CK * 2;       // one 64-row box: 8 KB
constexpr int THREADS = 256;           // two warpgroups; thread 0 also loads
constexpr int SMEM_MAX = 232448;       // shared memory a block may use on the H100
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of element (r, c) of a tile of 128-byte rows (64 bf16) as TMA
// writes it with the 128-byte swizzle (tile 1024-byte aligned): 16-byte chunk
// c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// ds of one score before its bf16 rounding: dg * (onehot - exp(x - z)), with
// zl = z log2(e) (+inf for a row past the end, which makes it 0); 0 past the
// vocab's end.
__device__ __forceinline__ float ds_of(float x, int col, int v, int lab, float zl, float dg) {
  if (col >= v) return 0.f;
  return dg * ((col == lab ? 1.f : 0.f) - ex2(fmaf(x, LOG2E, -zl)));
}

// This thread's two rows (r0, r0 + 8 of the 64 from `row0`): label, z log2(e)
// and dg; a row past the end gets no label, zl = +inf and dg = 0.
__device__ __forceinline__ void row_data(const int* __restrict__ labels,
                                         const float* __restrict__ z,
                                         const float* __restrict__ dg, int row0, int r0, int rows,
                                         int (&lab)[2], float (&zl)[2], float (&dgr)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r0 + 8 * h;
    const bool ok = row < rows;
    lab[h] = ok ? labels[row] : -1;
    zl[h] = ok ? z[row] * LOG2E : INFINITY;
    dgr[h] = ok ? dg[row] : 0.f;
  }
}

// K10's compaction, one block: order (the caller's row of each row, those
// with dg != 0 first, each group in the caller's order), labels, z and dg
// in that order, and live (their count) into meta (5, rows) int32 (z and dg
// as float32 bits; live at meta[4 rows]). Thread t owns rows [t per, t per +
// per): it counts its rows with dg != 0, a block scan gives each thread its
// place in both groups, and it writes its rows there.
constexpr int LF_THREADS = 1024;
__global__ void __launch_bounds__(LF_THREADS)
ce_live_first_kernel(const int* __restrict__ labels, const float* __restrict__ z,
                     const float* __restrict__ dg, int rows, int* __restrict__ meta) {
  __shared__ int warp_sum[LF_THREADS / 32];
  const int per = (rows + LF_THREADS - 1) / LF_THREADS;
  const int b = min(rows, (int)threadIdx.x * per), e = min(rows, b + per);
  int mine = 0;
  for (int r = b; r < e; ++r) mine += dg[r] != 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;  // inclusive scan over the warp, then over the warps' sums
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  const int nlive = warp_sum[LF_THREADS / 32 - 1];
  int live_at = incl - mine + (warp ? warp_sum[warp - 1] : 0);
  int dead_at = nlive + b - live_at;
  float* zo = reinterpret_cast<float*>(meta + 2 * rows);
  float* dgo = reinterpret_cast<float*>(meta + 3 * rows);
  for (int r = b; r < e; ++r) {
    const float g = dg[r];
    const int at = g != 0.f ? live_at++ : dead_at++;
    meta[at] = r;
    meta[rows + at] = labels[r];
    zo[at] = z[r];
    dgo[at] = g;
  }
  if (threadIdx.x == 0) meta[4 * rows] = nlive;
}

// hl's row i = h's row order[i], a warp a row in 16-byte pieces (a row of d
// bf16, d % 32 == 0, starts 16-byte aligned), for the rows up to the end of
// the last 64-row tile that holds a row with dg != 0: the launches read no
// others, and every row they read is a row of h, finite where h is.
__global__ void ce_gather_rows_kernel(const uint4* __restrict__ h, const int* __restrict__ meta,
                                      uint4* __restrict__ hl, int rows, int pieces) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int nlive = meta[4 * rows];
  if (row >= min(rows, (nlive + CT - 1) / CT * CT)) return;
  const uint4* src = h + (size_t)meta[row] * pieces;
  uint4* dst = hl + (size_t)row * pieces;
  for (int c = threadIdx.x & 31; c < pieces; c += 32) dst[c] = src[c];
}

// Shared memory of the dh launch, from the 1024-aligned base: h (NBOX
// boxes), the W ring (a stage holds NBOX boxes of TV vocab rows: warpgroup
// w's product reads boxes 4w .. 4w + 3 whatever D is; boxes past D are never
// loaded and only feed columns that are not stored), two ds tiles, barriers.
struct DhLayout {
  static constexpr int WBOX = TV * 128;
  static constexpr int STAGE = NBOX * WBOX;
  static constexpr int STAGES = 2;
  static constexpr int DS = CT * TV * 2;
  static constexpr int W = NBOX * BOX;
  static constexpr int DSOFF = W + STAGES * STAGE;
  static constexpr int BARS = DSOFF + 2 * DS;
  static constexpr int BYTES = 1024 + BARS + 8 * (2 * STAGES + 1);
  static_assert(BYTES <= SMEM_MAX, "dh tiles exceed shared memory");
};

// Grid (row tiles of 64, vocab splits): block (i, j) computes dh for rows
// [64 i, 64 i + 64) of h (in live-first order; rows from *live on have dg =
// 0 and are skipped) over the vocab tiles of split j, into dh's rows
// order[row] (dh_bf16 ? bf16 : f32) or, with splits, into part (splits,
// rows, d) f32 by h's row.
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_dh_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ bias, const int* __restrict__ labels,
                 const float* __restrict__ z, const float* __restrict__ dg,
                 const int* __restrict__ live, const int* __restrict__ order,
                 void* __restrict__ dh, int dh_bf16, float* __restrict__ part, int rows, int d,
                 int v, int tiles_per_split) {
  using L = DhLayout;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes need 1024-byte aligned shared addresses
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* hs = base;
  unsigned char* ws = base + L::W;
  unsigned char* ds = base + L::DSOFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + L::STAGES;
  uint64_t* hbar = empty + L::STAGES;

  const int nk = (d + CK - 1) / CK;
  const int row0 = blockIdx.x * CT;
  const int nlive = *live;
  if (row0 >= nlive) return;  // every row of the tile has dg = 0
  const int tile0 = blockIdx.y * tiles_per_split;
  const int ntiles = min(tiles_per_split, (v + TV - 1) / TV - tile0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per warp
    }
    mbar_init(hbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // vocab tile t of the split into stage t % STAGES
  auto load_tile = [&](int t) {
    const int s = t % L::STAGES;
    mbar_expect_tx(&full[s], nk * L::WBOX);
    for (int c = 0; c < nk; ++c)
      tma_load_2d(ws + s * L::STAGE + c * L::WBOX, &wmap, &full[s], c * CK, (tile0 + t) * TV);
  };
  if (threadIdx.x == 0) {  // the h rows once, then the first tiles
    mbar_expect_tx(hbar, nk * BOX);
    for (int c = 0; c < nk; ++c) tma_load_2d(hs + c * BOX, &hmap, hbar, c * CK, row0);
    for (int t = 0; t < min(L::STAGES, ntiles); ++t) load_tile(t);
  }
  // warp-uniform as the compiler can see it, which keeps the wgmmas unserialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the tile
  const bool dh_work = 4 * wg < nk;        // warpgroup 1 owns D columns only for D > 256
  int lab[2];
  float zl[2], dgr[2];
  row_data(labels, z, dg, row0, r0, nlive, lab, zl, dgr);
  constexpr int NJ = TV / 16;  // 8-column groups of this warpgroup's TV / 2 score columns
  float acc[128];              // dh: rows r0 + 8h, D columns 256 wg + 8j + 2q + e at [4j + 2h + e]
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mbar_wait(hbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % L::STAGES;
    const int v0 = (tile0 + t) * TV;
    const unsigned char* wst = ws + s * L::STAGE;
    unsigned char* dst = ds + (t & 1) * L::DS;
    float2 bb[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = v0 + wg * (TV / 2) + 8 * j + 2 * q;
      bb[j].x = bias && col < v ? bias[col] : 0.f;
      bb[j].y = bias && col + 1 < v ? bias[col + 1] : 0.f;
    }
    mbar_wait(&full[s], (t / L::STAGES) & 1);
    // S: this warpgroup's TV / 2 vocab columns of the tile, all 64 rows
    float sc[TV / 4];
    wgmma_fence();
    for (int c = 0; c < nk; ++c) {
      const uint64_t da = desc_sw128(hs + c * BOX);
      const uint64_t db = desc_sw128(wst + c * L::WBOX + wg * (TV / 2) * 128);
#pragma unroll
      for (int k = 0; k < CK / 16; ++k) wgmma_m64n32k16(sc, da + 2 * k, db + 2 * k, c | k);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    // ds (64 rows x TV vocab, bf16, K-major: one 64-column atom of 8 KB)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = wg * (TV / 2) + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            ds_of(sc[4 * j + 2 * h] + bb[j].x, v0 + col, v, lab[h], zl[h], dgr[h]),
            ds_of(sc[4 * j + 2 * h + 1] + bb[j].y, v0 + col + 1, v, lab[h], zl[h], dgr[h]));
        *reinterpret_cast<__nv_bfloat162*>(dst + sw128(r0 + 8 * h, col)) = p;
      }
    }
    fence_proxy_async();
    named_barrier(1, 256);  // both halves of ds are written
    // dh += ds (64 x TV, K-major A) x W_tile (TV x 256 of this warpgroup's D, MN-major B)
    if (dh_work) {
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int k = 0; k < TV / 16; ++k)
        wgmma_m64n256k16<0, 1>(acc, desc_sw128(dst) + 2 * k,
                               desc_mn_sw128(wst + 4 * wg * L::WBOX + k * 2048, L::WBOX), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the W stage
    // once both warpgroups are, thread 0 refills it; the whole warpgroup
    // waits (a wait in a one-thread branch serializes the wgmmas)
    if (wg == 0 && t + L::STAGES < ntiles) {
      mbar_wait(&empty[s], (t / L::STAGES) & 1);
      if (threadIdx.x == 0) load_tile(t + L::STAGES);
    }
  }

  if (!dh_work) return;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 256 * wg + 8 * j + 2 * q;
    if (col >= d) continue;  // D is a multiple of 32: a pair is in or out whole
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r0 + 8 * h;
      if (row >= nlive) continue;
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      const size_t out = (size_t)order[row] * d + col;
      if (part)
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.y * rows + row) * d + col) =
            make_float2(a0, a1);
      else if (dh_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dh) + out) =
            __floats2bfloat162_rn(a0, a1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(dh) + out) = make_float2(a0, a1);
    }
  }
}

// Shared memory of the dW launch, from the 1024-aligned base: the resident
// W tile (NBOX boxes of 64 vocab rows), the h ring (2 stages of NBOX boxes
// of 64 rows: warpgroup w's product reads boxes 4w .. 4w + 3), two ds tiles,
// db's cross-warp sums, barriers.
struct DwLayout {
  static constexpr int STAGES = 2;
  static constexpr int STAGE = NBOX * BOX;
  static constexpr int H = NBOX * BOX;
  static constexpr int DSOFF = H + STAGES * STAGE;
  static constexpr int RED = DSOFF + 2 * BOX;
  static constexpr int BARS = RED + 2 * 4 * 32 * 4;
  static constexpr int BYTES = 1024 + BARS + 8 * (2 * STAGES + 1);
  static_assert(BYTES <= SMEM_MAX, "dW tiles exceed shared memory");
};

// Grid (vocab tiles of 64, row splits): block (i, j) computes dW for vocab
// rows [64 i, 64 i + 64) and db for those columns over the 64-row chunks of
// split j of the live rows (the first *live rows of h, cut into gridDim.y
// runs of equal length; a run past them adds nothing), into dw (v, d) / db
// (v,) or, with splits, into part (splits, v, d) / dbpart (splits, v); db
// only when bias is given.
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_dw_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ bias, const int* __restrict__ labels,
                 const float* __restrict__ z, const float* __restrict__ dg,
                 const int* __restrict__ live, float* __restrict__ dw, float* __restrict__ db,
                 float* __restrict__ part, float* __restrict__ dbpart, int d, int v) {
  using L = DwLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* wres = base;
  unsigned char* hr = base + L::H;
  unsigned char* ds = base + L::DSOFF;
  float* red = reinterpret_cast<float*>(base + L::RED);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + L::STAGES;
  uint64_t* wbar = empty + L::STAGES;

  const int nk = (d + CK - 1) / CK;
  const int v0 = blockIdx.x * CT;
  const int rows = *live, chunks = (rows + CT - 1) / CT;
  const int per = (chunks + gridDim.y - 1) / gridDim.y;
  const int chunk0 = blockIdx.y * per;
  const int nchunks = max(0, min(per, chunks - chunk0));
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // row chunk i of the split into stage i % STAGES
  auto load_chunk = [&](int i) {
    const int s = i % L::STAGES;
    mbar_expect_tx(&full[s], nk * BOX);
    for (int c = 0; c < nk; ++c)
      tma_load_2d(hr + s * L::STAGE + c * BOX, &hmap, &full[s], c * CK, (chunk0 + i) * CT);
  };
  if (threadIdx.x == 0) {  // the W tile once, then the first chunks
    mbar_expect_tx(wbar, nk * BOX);
    for (int c = 0; c < nk; ++c) tma_load_2d(wres + c * BOX, &wmap, wbar, c * CK, v0);
    for (int i = 0; i < min(L::STAGES, nchunks); ++i) load_chunk(i);
  }
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);
  const bool dw_work = 4 * wg < nk;
  float2 bb[4];  // bias of this thread's score columns 32 wg + 8j + 2q + {0, 1}
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = v0 + 32 * wg + 8 * j + 2 * q;
    bb[j].x = bias && col < v ? bias[col] : 0.f;
    bb[j].y = bias && col + 1 < v ? bias[col + 1] : 0.f;
  }
  float dbs[8];   // db over this thread's rows of every chunk, columns as bb
  float acc[128]; // dW: vocab rows 16 warp + lane / 4 + 8h, D columns 256 wg + 8j + 2q + e
#pragma unroll
  for (int i = 0; i < 8; ++i) dbs[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int lab[2];
  float zl[2], dgr[2];
  row_data(labels, z, dg, chunk0 * CT, r0, rows, lab, zl, dgr);
  mbar_wait(wbar, 0);

  for (int i = 0; i < nchunks; ++i) {
    const int s = i % L::STAGES;
    const unsigned char* hst = hr + s * L::STAGE;
    unsigned char* dst = ds + (i & 1) * BOX;
    int nlab[2];
    float nzl[2], ndg[2];
    if (i + 1 < nchunks) row_data(labels, z, dg, (chunk0 + i + 1) * CT, r0, rows, nlab, nzl, ndg);
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    float sc[16];
    wgmma_fence();
    for (int c = 0; c < nk; ++c) {
      const uint64_t da = desc_sw128(hst + c * BOX);
      const uint64_t db_ = desc_sw128(wres + c * BOX + wg * 32 * 128);
#pragma unroll
      for (int k = 0; k < CK / 16; ++k) wgmma_m64n32k16(sc, da + 2 * k, db_ + 2 * k, c | k);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    // ds (64 rows x 64 vocab, bf16, rows outermost: the MN-major A of dW)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * wg + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            ds_of(sc[4 * j + 2 * h] + bb[j].x, v0 + col, v, lab[h], zl[h], dgr[h]),
            ds_of(sc[4 * j + 2 * h + 1] + bb[j].y, v0 + col + 1, v, lab[h], zl[h], dgr[h]));
        dbs[2 * j] += __low2float(p);
        dbs[2 * j + 1] += __high2float(p);
        *reinterpret_cast<__nv_bfloat162*>(dst + sw128(r0 + 8 * h, col)) = p;
      }
    }
    fence_proxy_async();
    named_barrier(1, 256);
    // dW_tile (64 vocab x 256 of this warpgroup's D) += ds^T x h_chunk, both MN-major
    if (dw_work) {
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int k = 0; k < CT / 16; ++k)
        wgmma_m64n256k16<1, 1>(acc, desc_mn_sw128(dst + k * 2048, BOX),
                               desc_mn_sw128(hst + 4 * wg * BOX + k * 2048, BOX), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    if (lane == 0) mbar_arrive(&empty[s]);
    if (wg == 0 && i + L::STAGES < nchunks) {  // as the dh launch refills its ring
      mbar_wait(&empty[s], (i / L::STAGES) & 1);
      if (threadIdx.x == 0) load_chunk(i + L::STAGES);
    }
    if (i + 1 < nchunks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lab[h] = nlab[h];
        zl[h] = nzl[h];
        dgr[h] = ndg[h];
      }
    }
  }

  // db: the 8 lanes of a column's q, then the warps in order
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) dbs[e] += __shfl_xor_sync(0xffffffffu, dbs[e], off);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[(wg * 4 + warp) * 32 + 8 * j + 2 * q] = dbs[2 * j];
      red[(wg * 4 + warp) * 32 + 8 * j + 2 * q + 1] = dbs[2 * j + 1];
    }
  }
  named_barrier(1, 256);
  if (bias && threadIdx.x < 64) {
    const int cw = threadIdx.x >> 5, cl = threadIdx.x & 31, col = v0 + threadIdx.x;
    const float sum = ((red[(cw * 4) * 32 + cl] + red[(cw * 4 + 1) * 32 + cl]) +
                       red[(cw * 4 + 2) * 32 + cl]) + red[(cw * 4 + 3) * 32 + cl];
    if (col < v) {
      if (dbpart)
        dbpart[(size_t)blockIdx.y * v + col] = sum;
      else
        db[col] = sum;
    }
  }
  if (!dw_work) return;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 256 * wg + 8 * j + 2 * q;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int vr = v0 + r0 + 8 * h;
      if (vr >= v) continue;
      float* out = part ? part + ((size_t)blockIdx.y * v + vr) * d : dw + (size_t)vr * d;
      *reinterpret_cast<float2*>(out + col) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// The second passes of the two launches, named apart so that a profile
// charges each to its launch. dh's sums the live rows' partials (rows, d)
// into dh's rows order[row].
__global__ void ce_bwd_dh_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       bf16* __restrict__ out16, const int* __restrict__ live,
                                       const int* __restrict__ order, int rows, int d,
                                       int splits) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int row = (int)(i / d);
  if (row >= *live) return;
  const long long n = (long long)rows * d;
  float4 a = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < splits; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(part + (size_t)s * n + i);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  const size_t o = (size_t)order[row] * d + (i - (long long)row * d);
  if (out) {
    *reinterpret_cast<float4*>(out + o) = a;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(out16 + o) = __floats2bfloat162_rn(a.x, a.y);
    *reinterpret_cast<__nv_bfloat162*>(out16 + o + 2) = __floats2bfloat162_rn(a.z, a.w);
  }
}
// dW's (and db's) sum over the splits' partials, four elements a thread (one
// where n is not a multiple of 4).
__global__ void ce_bwd_dw_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       long long n, int splits) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if ((n & 3) == 0) {
    float4 a = *reinterpret_cast<const float4*>(part + i);
    for (int s = 1; s < splits; ++s) {
      const float4 b = *reinterpret_cast<const float4*>(part + (size_t)s * n + i);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    *reinterpret_cast<float4*>(out + i) = a;
    return;
  }
  for (long long e = i; e < i + 4 && e < n; ++e) {
    float a = part[e];
    for (int s = 1; s < splits; ++s) a += part[(size_t)s * n + e];
    out[e] = a;
  }
}

unsigned merge_blocks(long long n) { return (unsigned)(((n + 3) / 4 + 255) / 256); }

// A split of `units` tiles into `splits` runs of `per`, none empty.
bool bad_split(int units, int splits, int per) {
  return splits < 1 || per < 1 || (splits - 1) * per >= units || splits * per < units;
}

bool encode_rows(CUtensorMap* map, const void* t, int rows, int d, int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, t, rows, d, box_rows, CK,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// K10's compaction: h (rows, d) bf16, labels (rows,) i32, z and dg (rows,)
// f32 -> hl (rows, d) bf16, h's rows in live-first order up to the end of
// the last 64-row tile holding a row with dg != 0 (the rest unwritten), and
// meta (5, rows) i32: order, labels, z bits, dg bits in that order and the
// live count at meta[4 rows]. h and hl 16-byte aligned; d % 32 == 0.
NAVC_EXPORT int navc_ce_live_first(const void* h, const void* labels, const void* z,
                                   const void* dg, void* hl, void* meta, int rows, int d,
                                   void* stream) {
  if (rows < 1 || d < 32 || d % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ce_live_first_kernel<<<1, LF_THREADS, 0, st>>>(static_cast<const int*>(labels),
                                                 static_cast<const float*>(z),
                                                 static_cast<const float*>(dg), rows,
                                                 static_cast<int*>(meta));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_gather_rows_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const uint4*>(h), static_cast<const int*>(meta), static_cast<uint4*>(hl), rows,
      d / 8);
  return (int)cudaGetLastError();
}

// K10, first launch, on navc_ce_live_first's outputs: h (rows, d) bf16
// with its rows in live-first order, w (v, d) bf16, bias (v,) f32 or null,
// labels (rows,) i32, z and dg (rows,) f32 in h's order, live (one i32: the
// rows with dg != 0, first in h), order (rows,) i32 (the caller's row of
// each row of h) -> the live rows of dh (rows, d) in the caller's order,
// bf16 when dh_bf16 else f32, zeroed by the caller. h, w, bias
// 16-byte aligned; 32 <= d <= 512, d % 32 == 0. The vocab is cut into
// `splits` runs of tiles_per_split tiles of 64 columns, none empty; with
// splits > 1, part is (splits, rows, d) f32 scratch, summed by a second pass
// in split order.
NAVC_EXPORT int navc_ce_bwd_dh(const void* h, const void* w, const void* bias, const void* labels,
                               const void* z, const void* dg, const void* live, const void* order,
                               void* dh, int dh_bf16, void* part, int rows, int d, int v,
                               int splits, int tiles_per_split, void* stream) {
  if (rows < 1 || v < 1 || d < 32 || d % 32 || d > MAX_D || (splits > 1 && !part) ||
      bad_split((v + TV - 1) / TV, splits, tiles_per_split))
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  if (!encode_rows(&hmap, h, rows, d, CT) || !encode_rows(&wmap, w, v, d, TV))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ce_bwd_dh_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, DhLayout::BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ce_bwd_dh_kernel<<<dim3((rows + CT - 1) / CT, splits), THREADS, DhLayout::BYTES, st>>>(
      hmap, wmap, static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(z), static_cast<const float*>(dg),
      static_cast<const int*>(live), static_cast<const int*>(order), dh, dh_bf16,
      splits > 1 ? static_cast<float*>(part) : nullptr, rows, d, v, tiles_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  ce_bwd_dh_merge_kernel<<<merge_blocks((long long)rows * d), 256, 0, st>>>(
      static_cast<const float*>(part), dh_bf16 ? nullptr : static_cast<float*>(dh),
      dh_bf16 ? static_cast<bf16*>(dh) : nullptr, static_cast<const int*>(live),
      static_cast<const int*>(order), rows, d, splits);
  return (int)cudaGetLastError();
}

// K10, second launch -> dw (v, d) f32 and, when bias is given, db (v,) f32.
// The live rows' 64-row chunks are cut into `splits` runs of equal length;
// with splits > 1, part (splits, v, d) and, with a bias, dbpart (splits, v)
// are f32 scratch, summed by a second pass in split order. Operands as
// navc_ce_bwd_dh.
NAVC_EXPORT int navc_ce_bwd_dw(const void* h, const void* w, const void* bias, const void* labels,
                               const void* z, const void* dg, const void* live, void* dw, void* db,
                               void* part, void* dbpart, int rows, int d, int v, int splits,
                               void* stream) {
  if (rows < 1 || v < 1 || d < 32 || d % 32 || d > MAX_D || splits < 1 ||
      (splits > 1 && (!part || (bias && !dbpart))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  if (!encode_rows(&hmap, h, rows, d, CT) || !encode_rows(&wmap, w, v, d, CT))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ce_bwd_dw_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, DwLayout::BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = splits > 1;
  ce_bwd_dw_kernel<<<dim3((v + CT - 1) / CT, splits), THREADS, DwLayout::BYTES, st>>>(
      hmap, wmap, static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(z), static_cast<const float*>(dg), static_cast<const int*>(live),
      static_cast<float*>(dw), static_cast<float*>(db), split ? static_cast<float*>(part) : nullptr,
      split && bias ? static_cast<float*>(dbpart) : nullptr, d, v);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return (int)e;
  const long long n = (long long)v * d;
  ce_bwd_dw_merge_kernel<<<merge_blocks(n), 256, 0, st>>>(static_cast<const float*>(part),
                                                          static_cast<float*>(dw), n, splits);
  if (bias)
    ce_bwd_dw_merge_kernel<<<merge_blocks(v), 256, 0, st>>>(static_cast<const float*>(dbpart),
                                                            static_cast<float*>(db), v, splits);
  return (int)cudaGetLastError();
}
