// The row-batched product walk of the layer kernels: C = A B over all
// flattened operand rows of a batch at once, where the per-sequence kernels
// multiplied one sequence's 32 rows by every weight matrix. The training
// layer's forward and backward (K11, K12a, K12b in fused_layer_train.cu)
// walk the N * Lp decoder rows and N * Lep encoder rows; the NAR decode's
// sparse-query layer (K2 in fused_layer.cu) walks the N * Lp canvas rows and
// the N * K query rows. Each kernel brings its own epilogues (rg_tile
// below hands them the tile in registers).
//
// A block computes one output tile of 64 WG rows by BN (64 or 128)
// columns, WG (1 or 2) consumer warpgroups of 64 rows sharing each B tile.
// One producer thread streams the K dimension in chunks of 64 through an
// mbarrier ring: per chunk WG 64 x 64 boxes of A (the bf16 operand rows,
// K-major, 128-byte swizzle) and the matching B tile. B is a weight in
// nn.Linear's (out, in) layout, read one of two ways:
//  * BT = 0, x W^T: W's rows are the output columns, K contiguous: a
//    K-major B, one box of BN rows x 64 of K;
//  * BT = 1, dY W: W's rows are K, the output columns contiguous: an
//    MN-major B through the wgmma transpose bit, BN / 64 boxes of 64 rows of
//    K x 64 columns.
// Each consumer warpgroup multiplies its rows of each chunk with wgmma
// (m64nBNk16, float32 accumulators in registers) and frees the stage. The
// tile is the largest that still gives every SM a block (rg_plan): at B =
// 2048, 128 x 128, where each weight tile feeds 128 rows and each operand
// row 128 columns; at B = 64, 64 x 64. TMA zero-fills
// the ragged edges: rows past R, columns past N, K past its end (FFN 1056 is
// a multiple of 32, not of 64), so the products need no masks; the
// epilogue stores by index. A product may have up to 3 segments along K
// (dx = [dQ dK dV] [Wq; Wk; Wv] is one K = 3H product) or up to 3 column
// groups along N, each with its own weight (x [Wq Wk Wv]^T), never both;
// the DUAL walk accumulates two products of one K into two accumulator sets
// (K12a's a = r2 Wi^T, K-major, and t = dd Wo2, MN-major).
//
// Per-sequence column sums (the bias gradients' `part` rows) come from the
// epilogue: Lp (16 or 32) divides 64, so every sequence's rows lie in one
// tile; the tile's values go to shared memory and a thread sums one
// column of one sequence in row order. No atomics: two calls give the same
// bits.
//
// The training kernels launch a block per tile (rg_launch). The serving walk
// (rg_walk, rg_launch_walk) launches a fixed grid, as many blocks as the
// SMs hold, each walking its share of the tiles of the rows live, a count
// an earlier launch wrote on the card: the rows past it (PAD rows, unused
// query slots) are never scheduled, and the grid, fixed by the rows' capacity,
// is the same in every call, so a CUDA graph captures it.
#pragma once

#include "hopper.cuh"

#include <initializer_list>

namespace {

constexpr int RG_BM = 64;               // rows per consumer warpgroup
constexpr int RG_BK = 64;               // K per chunk: one 128-byte swizzled row
constexpr int RG_BOX = RG_BM * RG_BK * 2;  // one 64 x 64 bf16 box, 8 KB
constexpr int RG_MAX = 3;               // K segments or column groups of one product
constexpr int RG_RING = 98304;          // ring bytes: two blocks fit an SM

// WG consumer warpgroups and a producer warp.
__host__ __device__ constexpr int rg_threads(int wg) { return 128 * wg + 32; }

// Shared memory of one block, from its 1024-aligned base: the ring of
// STAGES stages, each [A: WG boxes][B] (and [A1][B1] for the DUAL walk),
// then the full and empty barriers. The epilogue's column-sum staging
// reuses the ring once the products are done.
template <int BN, bool DUAL, int WG>
struct RgLayout {
  static constexpr int PROD = WG * RG_BOX + BN * RG_BK * 2;
  static constexpr int STAGE = (DUAL ? 2 : 1) * PROD;
  static constexpr int FIT = RG_RING / STAGE;
  static constexpr int STAGES = FIT < 2 ? 2 : FIT > 4 ? 4 : FIT;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int BYTES = 1024 + BARS + 2 * STAGES * 8;
  static_assert(WG * RG_BM * (BN + 1) * 4 <= BARS, "column-sum staging exceeds the ring");
};

// d (64 x 128 per warpgroup) += A (64 x 16, K-major) x B (16 x 128): B
// K-major (TB = 0, 128 rows of K) or MN-major (TB = 1, through the
// transpose bit).
template <int TB>
__device__ __forceinline__ void rg_wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %66;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TB), "r"(1));
}

// The same with 64 columns (32 accumulators a thread).
template <int TB>
__device__ __forceinline__ void rg_wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %34;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TB), "r"(1));
}

template <int BN, int TB>
__device__ __forceinline__ void rg_wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    rg_wgmma_n128<TB>(d, da, db);
  else
    rg_wgmma_n64<TB>(d, da, db);
}

// The wgmma descriptor of 16 of K (step k of a chunk) in a stage's B tile.
template <int TB>
__device__ __forceinline__ uint64_t rg_desc_b(const unsigned char* b, int k) {
  if constexpr (TB == 0) return desc_sw128(b) + 2 * k;
  return desc_mn_sw128(b + k * 2048, RG_BOX);
}

}  // namespace

// One product of the walk, filled by the C entries of fused_layer_train.cu
// and fused_layer.cu. Rows are flattened: in the training layer, row r is
// position r % seq_rows of sequence r / seq_rows, and positions from `valid`
// on are padding.
struct RowGemm {
  int rows;               // R = N * seq_rows
  int seq_rows;           // Lp or Lep: 16 or 32
  int valid;              // L or Le
  int K;                  // K of each segment
  int nseg;               // segments along K (1 when groups > 1)
  int cols;               // output columns of each group
  int groups;             // column groups (1 when nseg > 1)
  int tiles;              // BN-wide column tiles of one group
  const float* bias[RG_MAX];  // per group, or null
  bf16* out[RG_MAX];          // bf16 outputs (rows, cols) per group (DUAL: g, da)
  float* outf;                // the float32 residual rows (rows, cols) an epilogue
                              // reads and writes, or null
  float* part;                // per-sequence column sums (N, cols), or null
  const int* live;            // the serving walk: the rows live (<= rows), on the card
};

// TMA maps: A of each segment (DUAL: A0, A1); B of each segment or group
// (DUAL: B0 K-major, B1 MN-major).
struct RowMaps {
  CUtensorMap a[RG_MAX], b[RG_MAX];
};

namespace {

// The producer thread: every chunk of the tile's K walk into the ring. base:
// the chunks the block's ring took before this tile (the serving walk's
// earlier tiles), which sets the stages and the barriers' phases.
template <int BN, int BT, bool DUAL, int WG>
__device__ void rg_produce(const RowMaps& m, const RowGemm& g, unsigned char* ring,
                           uint64_t* full, uint64_t* empty, int grp, int n0, int row0,
                           int base = 0) {
  using Lay = RgLayout<BN, DUAL, WG>;
  const int kc = (g.K + RG_BK - 1) / RG_BK, chunks = g.nseg * kc;
  for (int c = 0; c < chunks; ++c) {
    const int s = (base + c) % Lay::STAGES, seg = c / kc, k0 = (c % kc) * RG_BK;
    unsigned char* st = ring + s * Lay::STAGE;
    mbar_wait(&empty[s], (((base + c) / Lay::STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], Lay::STAGE);
#pragma unroll
    for (int p = 0; p < (DUAL ? 2 : 1); ++p) {
      unsigned char* pa = st + p * Lay::PROD;
      const int ai = DUAL ? p : seg, bi = DUAL ? p : grp * g.nseg + seg;
      const int bt = DUAL ? p : BT;
#pragma unroll
      for (int w = 0; w < WG; ++w)
        tma_load_2d(pa + w * RG_BOX, &m.a[ai], &full[s], k0, row0 + w * RG_BM);
      unsigned char* pb = pa + WG * RG_BOX;
      if (bt == 0) {
        tma_load_2d(pb, &m.b[bi], &full[s], k0, n0);
      } else {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(pb + b * RG_BOX, &m.b[bi], &full[s], n0 + 64 * b, k0);
      }
    }
  }
}

// Consumer warpgroup wg: acc0 (+ acc1 for DUAL) = its 64 rows of the
// tile's products. base as rg_produce's; release: free the last chunk's
// stage too, for a producer that goes on to another tile.
template <int BN, int BT, bool DUAL, int WG>
__device__ __forceinline__ void rg_consume(const RowGemm& g, const unsigned char* ring,
                                           uint64_t* full, uint64_t* empty, int wg,
                                           float (&acc0)[BN / 2], float (&acc1)[BN / 2],
                                           int base = 0, bool release = false) {
  using Lay = RgLayout<BN, DUAL, WG>;
  const int kc = (g.K + RG_BK - 1) / RG_BK, chunks = g.nseg * kc;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = (base + c) % Lay::STAGES;
    const unsigned char* st = ring + s * Lay::STAGE;
    mbar_wait(&full[s], ((base + c) / Lay::STAGES) & 1);
    wgmma_fence();
    fence_acc(acc0);
    if constexpr (DUAL) fence_acc(acc1);
#pragma unroll
    for (int k = 0; k < RG_BK / 16; ++k) {
      if constexpr (DUAL) {
        rg_wgmma<BN, 0>(acc0, desc_sw128(st + wg * RG_BOX) + 2 * k,
                        rg_desc_b<0>(st + WG * RG_BOX, k));
        rg_wgmma<BN, 1>(acc1, desc_sw128(st + Lay::PROD + wg * RG_BOX) + 2 * k,
                        rg_desc_b<1>(st + Lay::PROD + WG * RG_BOX, k));
      } else {
        rg_wgmma<BN, BT>(acc0, desc_sw128(st + wg * RG_BOX) + 2 * k,
                         rg_desc_b<BT>(st + WG * RG_BOX, k));
      }
    }
    wgmma_commit();
    if (c > 0) {  // the previous chunk's products are done: free its stage
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[(base + c - 1) % Lay::STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc0);
  if constexpr (DUAL) fence_acc(acc1);
  if (release && lane == 0) mbar_arrive(&empty[(base + chunks - 1) % Lay::STAGES]);
}

// The 1024-aligned start of a block's dynamic shared memory: 128-byte
// swizzled TMA boxes need 1024-byte aligned shared addresses.
__device__ __forceinline__ unsigned char* rg_ring(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The ring's full and empty barriers, made by thread 0 before the block's
// first chunk (the caller synchronises the block after).
template <int BN, bool DUAL, int WG>
__device__ __forceinline__ uint64_t* rg_barriers(unsigned char* ring) {
  using Lay = RgLayout<BN, DUAL, WG>;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Lay::BARS);
  if (threadIdx.x == 0) {
    for (int i = 0; i < Lay::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&full[Lay::STAGES + i], 4 * WG);  // empty: one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return full;
}

// One block's tile of a product (ring from rg_ring): the producer thread
// streams the K walk and the producer warp returns false; each consumer
// thread returns true with its warpgroup's 64 rows of the tile in acc0
// (and acc1 for DUAL), the ring free for the epilogue's staging.
template <int BN, int BT, bool DUAL, int WG>
__device__ __forceinline__ bool rg_tile(const RowMaps& m, const RowGemm& g, unsigned char* ring,
                                        int grp, int c0, int row0, float (&acc0)[BN / 2],
                                        float (&acc1)[BN / 2]) {
  using Lay = RgLayout<BN, DUAL, WG>;
  uint64_t* full = rg_barriers<BN, DUAL, WG>(ring);
  uint64_t* empty = full + Lay::STAGES;
  __syncthreads();
  if (threadIdx.x >= 128 * WG) {
    if (threadIdx.x == 128 * WG)
      rg_produce<BN, BT, DUAL, WG>(m, g, ring, full, empty, grp, c0, row0);
    return false;
  }
  // warp-uniform as the compiler can see it, which keeps the wgmmas unserialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  rg_consume<BN, BT, DUAL, WG>(g, ring, full, empty, wg, acc0, acc1);
  return true;
}

// The serving walk's products: the block walks the tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ... of the *g.live rows (read on the card), tile
// t the row tile t / (tiles * groups) and the column tile t % (tiles *
// groups), the order of rg_launch's grid. Its ring and barriers persist
// across its tiles: the producer streams the next tile's chunks while the
// consumer warpgroups run epi(group, column 0, row 0, live, acc) on the last.
// K-major B, one segment.
template <int BN, int WG, typename Epi>
__device__ __forceinline__ void rg_walk(const RowMaps& m, const RowGemm& g, unsigned char* ring,
                                        Epi&& epi) {
  using Lay = RgLayout<BN, false, WG>;
  uint64_t* full = rg_barriers<BN, false, WG>(ring);
  uint64_t* empty = full + Lay::STAGES;
  __syncthreads();
  const int live = *g.live, cols = g.tiles * g.groups, bm = WG * RG_BM;
  const int tiles = (live + bm - 1) / bm * cols, chunks = (g.K + RG_BK - 1) / RG_BK;
  if (threadIdx.x >= 128 * WG) {
    if (threadIdx.x == 128 * WG)
      for (int t = blockIdx.x, base = 0; t < tiles; t += gridDim.x, base += chunks) {
        const int ct = t % cols;
        rg_produce<BN, 0, false, WG>(m, g, ring, full, empty, ct / g.tiles,
                                     (ct % g.tiles) * BN, t / cols * bm, base);
      }
    return;
  }
  // warp-uniform as the compiler can see it, which keeps the wgmmas unserialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  float acc0[BN / 2], acc1[BN / 2];
  for (int t = blockIdx.x, base = 0; t < tiles; t += gridDim.x, base += chunks) {
    const int ct = t % cols;
    rg_consume<BN, 0, false, WG>(g, ring, full, empty, wg, acc0, acc1, base, true);
    epi(ct / g.tiles, (ct % g.tiles) * BN, t / cols * bm, live, acc0);
  }
}

// The per-sequence column sums of a tile: stg holds the tile's 64 WG x BN
// float32 values (ld BN + 1, zero where they add nothing); a thread sums
// one column of one sequence over its `valid` rows in row order into
// part[(sequence) * cols + column]. Called by the 128 WG consumer threads.
template <int BN, int WG>
__device__ void rg_column_sums(const float* stg, const RowGemm& g, int row0, int c0) {
  const int per = WG * RG_BM / g.seq_rows, nseq = g.rows / g.seq_rows;
  for (int p = threadIdx.x; p < BN * per; p += 128 * WG) {
    const int c = p % BN, sq = p / BN, n = row0 / g.seq_rows + sq;
    if (n >= nseq || c0 + c >= g.cols) continue;
    float sum = 0.f;
    for (int i = 0; i < g.valid; ++i) sum += stg[(sq * g.seq_rows + i) * (BN + 1) + c];
    g.part[(size_t)n * g.cols + c0 + c] = sum;
  }
}

// Host: the maps of one product. A (rows, K) per segment; B per segment or
// group: K-major (cols, K) with boxes of BN rows, or MN-major (K, cols)
// with boxes of 64 x 64. False if the driver refuses a map.
inline bool rg_maps(RowMaps* m, const RowGemm& g, const bf16* const* a, const bf16* const* b,
                    int na, int nb, int bn, int bt0, int bt1) {
  for (int i = 0; i < na; ++i)
    if (!encode_map(&m->a[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a[i], g.rows, g.K, RG_BM,
                    RG_BK, CU_TENSOR_MAP_SWIZZLE_128B))
      return false;
  for (int i = 0; i < nb; ++i) {
    const bool kmajor = (i == 0 ? bt0 : bt1) == 0;
    const bool ok = kmajor ? encode_map(&m->b[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b[i],
                                        g.cols, g.K, bn, RG_BK, CU_TENSOR_MAP_SWIZZLE_128B)
                           : encode_map(&m->b[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b[i],
                                        g.K, g.cols, RG_BK, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!ok) return false;
  }
  return true;
}

// Host: one product on tiles of 64 WG rows x BN columns, launched as
// KERNEL, the instance of a row-walk kernel (args, RowGemm, RowMaps) for
// that tile; A and B as rg_maps takes them (bt0 / bt1: B K-major or
// MN-major).
template <auto KERNEL, int BN, bool DUAL, int WG, typename Args>
int rg_launch(const Args& a, RowGemm g, std::initializer_list<const bf16*> A,
              std::initializer_list<const bf16*> B, int bt0, int bt1, cudaStream_t st) {
  constexpr int BM = WG * RG_BM;
  using Lay = RgLayout<BN, DUAL, WG>;
  if (g.rows == 0) return 0;
  g.tiles = (g.cols + BN - 1) / BN;
  if ((g.rows + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  RowMaps m = {};
  if (!rg_maps(&m, g, A.begin(), B.begin(), (int)A.size(), (int)B.size(), BN, bt0, bt1))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(g.tiles * g.groups, (g.rows + BM - 1) / BM);
  KERNEL<<<grid, rg_threads(WG), Lay::BYTES, st>>>(a, g, m);
  return (int)cudaGetLastError();
}

// Host: the SM count of the current device, read once.
inline int rg_sms() {
  static int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// Host: the tile of a product, as consumer warpgroups (rows / 64) and
// columns: the largest of 128 x 128, 64 x 128 and 64 x 64 that still gives
// every SM a block (B = 64 at N = H: 64 x 64, 32 x 8 tiles). The DUAL
// walk, two accumulator sets a thread, takes 64 columns (128 x 128 timed
// 8% slower at B = 2048: PERF.md).
struct RgTile {
  int wg, bn;
};
inline RgTile rg_plan(int rows, int cols, bool dual) {
  auto tiles = [&](int bm, int bn) {
    return (long)((rows + bm - 1) / bm) * ((cols + bn - 1) / bn);
  };
  if (tiles(128, dual ? 64 : 128) >= rg_sms()) return {2, dual ? 64 : 128};
  if (!dual && tiles(64, 128) >= rg_sms()) return {1, 128};
  return {1, 64};
}

// Host: the serving walk's products (rg_walk) on tiles of 64 WG rows x BN
// columns planned on g.rows, the capacity; KERNEL as rg_launch's, A and B
// K-major. The grid: the blocks the SMs hold at once, or the tiles of the
// capacity where they are fewer.
template <auto KERNEL, int BN, int WG, typename Args>
int rg_launch_walk(const Args& a, RowGemm g, std::initializer_list<const bf16*> A,
                   std::initializer_list<const bf16*> B, cudaStream_t st) {
  constexpr int BM = WG * RG_BM;
  using Lay = RgLayout<BN, false, WG>;
  if (g.rows == 0) return 0;
  g.tiles = (g.cols + BN - 1) / BN;
  RowMaps m = {};
  if (!rg_maps(&m, g, A.begin(), B.begin(), (int)A.size(), (int)B.size(), BN, 0, 0))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, KERNEL, rg_threads(WG), Lay::BYTES);
    return b > 0 ? b : 1;
  }();
  const long tiles = (long)((g.rows + BM - 1) / BM) * g.tiles * g.groups;
  const long grid = tiles < (long)per_sm * rg_sms() ? tiles : (long)per_sm * rg_sms();
  KERNEL<<<(unsigned)grid, rg_threads(WG), Lay::BYTES, st>>>(a, g, m);
  return (int)cudaGetLastError();
}

}  // namespace
