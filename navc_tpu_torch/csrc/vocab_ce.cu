// Vocab projection fused with the cross-entropy of the training step: the
// forward (K9) returns per row the label log-prob, the argmax id and the
// log-sum-exp residual; the backward (K10) returns dh, dW and db. Neither
// writes the (rows, V) logits or their gradient to device memory.
//
// Replaces: navc_tpu/ops/vocab_ce.py vocab_ce_train — forward pallas_call at
// :118 (body _fwd_kernel :55), backward pallas_call at :152 (body _bwd_kernel
// :69). Rounding points are the JAX kernels': bf16 operands, float32 scores
// (+ float32 bias), g = (s[y] - m) - lse, z = m + lse; in the backward
// ds = bf16(dg * (onehot(y) - exp(s - z))), dh = ds W and dW = ds^T h summed
// in float32, db = the float32 sum of the bf16 ds. A row whose dg is 0 (a PAD
// label, a row the valid_mask drops) gives an exactly zero ds row.
//
// What bounds them on the H100: the products. The forward is 2 N D V FLOPs
// (19.8 GFLOP at the B = 64 NACF pass, N = 1920, D = 512, V = 10048) and the
// backward 6 N D V counting each product once, against ~12 MB of operands:
// the bf16 tensor cores bound both (0.020 and 0.060 ms at 989 TFLOP/s).
//
// Design (simple first, as K3/K4): the tile-and-score code is vocab_fused.cu's
// (vocab_tile.cuh).
//  * ce_fwd_kernel: one block per 64-row tile of h walks W in 64-column
//    vocab tiles; each of 4 threads per row keeps a running (max, sum-exp,
//    argmax, label logit) over its 16 columns of every tile and the four
//    merge with warp shuffles. Ties go to the lowest id, as jnp.argmax. The
//    online sum-exp rescales where JAX takes max then sum: the two differ by
//    a few float32 ulps of lse (tolerance 1e-5 absolute at f32 scores).
//  * The backward is two launches and no atomics: the TPU accumulates dW in
//    VMEM across a sequential grid, CUDA blocks run in parallel.
//    ce_bwd_dh_kernel: one block per row tile loops over the vocab tiles,
//    recomputes the scores, forms ds in shared memory and accumulates
//    dh += ds W_tile in register fragments (warp w: row tile w % 4, every
//    other 16-column tile of D from w / 4).
//    ce_bwd_dw_kernel: one block per 64-column vocab tile (157 blocks at V =
//    10048) keeps its W tile staged, walks every row tile in a fixed order,
//    recomputes the scores, forms ds, accumulates dW_tile += ds^T h in
//    register fragments and db in float32 per column: deterministic.
//  The recompute makes the backward 8 N D V FLOPs, the port's own cost over
//  the function's 6 N D V.
// Not yet done (later work): wgmma, cp.async/TMA staging that overlaps the
// products, a split of the dW rows across blocks.

#include "vocab_tile.cuh"

namespace {

constexpr int DS_LD = TV + 8;    // bf16 row stride of the ds tile
constexpr int MAX_D = 512;       // accumulator fragments: D / 32 per warp
constexpr int NFRAG = MAX_D / 32;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// Shared memory of the backward: hs, ws, sc as vocab_tile.cuh, then ds.
size_t bwd_smem_bytes(int d) {
  return tile_smem_bytes(d) + (size_t)TM * DS_LD * sizeof(bf16);
}

__global__ void __launch_bounds__(NTHREADS)
ce_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const float* __restrict__ bias, const int* __restrict__ labels,
              float* __restrict__ g_out, int* __restrict__ pred, float* __restrict__ z_out,
              int rows, int d, int v) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + PAD;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + TM * ld;
  float* sc = reinterpret_cast<float*>(ws + TV * ld);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  stage_h(hs, h, row0, rows, d);

  const int r = tid >> 2, part = tid & 3;
  const bool row_ok = row0 + r < rows;
  const int lab = row_ok ? labels[row0 + r] : -1;
  float m = -INFINITY, s = 0.f, g = -INFINITY;
  int arg = 0x7fffffff;
  for (int v0 = 0; v0 < v; v0 += TV) {
    score_tile(hs, ws, sc, w, v0, v, d);
    const float* srow = sc + r * SC_LD + part * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = v0 + part * 16 + j;
      if (col < v) {
        const float x = srow[j] + (bias ? bias[col] : 0.f);
        if (col == lab) g = x;
        if (x > m) {
          s = s * expf(m - x) + 1.f;
          m = x;
          arg = col;
        } else {
          s += expf(x - m);
        }
      }
    }
  }
  // merge the 4 partial states of a row (lanes 4k .. 4k+3 of one warp);
  // exactly one of them saw the label column
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const int a2 = __shfl_xor_sync(0xffffffffu, arg, off);
    const float g2 = __shfl_xor_sync(0xffffffffu, g, off);
    const float mn = fmaxf(m, m2);
    const float sa = (m == -INFINITY) ? 0.f : s * expf(m - mn);
    const float sb = (m2 == -INFINITY) ? 0.f : s2 * expf(m2 - mn);
    s = sa + sb;
    if (m2 > m || (m2 == m && a2 < arg)) arg = a2;
    m = mn;
    g = fmaxf(g, g2);
  }
  if (part == 0 && row_ok) {
    const float lse = logf(s);
    g_out[row0 + r] = (g - m) - lse;
    pred[row0 + r] = arg;
    z_out[row0 + r] = m + lse;
  }
}

// ds of the staged score tile (rows row0.., vocab columns v0..) into dsb:
// bf16(dg * (onehot(label) - exp(s + b - z))), zero past the rows and the
// vocab edge. Thread: row tid / 4, columns (tid % 4) * 16 .. + 16.
__device__ __forceinline__ void form_ds(const float* sc, bf16* dsb, const float* __restrict__ bias,
                                        const int* __restrict__ labels,
                                        const float* __restrict__ z, const float* __restrict__ dg,
                                        int row0, int rows, int v0, int v) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const bool row_ok = row0 + r < rows;
  const int lab = row_ok ? labels[row0 + r] : -1;
  const float zr = row_ok ? z[row0 + r] : 0.f;
  const float dgr = row_ok ? dg[row0 + r] : 0.f;
  const float* srow = sc + r * SC_LD + part * 16;
  bf16* drow = dsb + r * DS_LD + part * 16;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = v0 + part * 16 + j;
    float ds = 0.f;
    if (row_ok && col < v) {
      const float x = srow[j] + (bias ? bias[col] : 0.f);
      ds = dgr * ((col == lab ? 1.f : 0.f) - expf(x - zr));
    }
    drow[j] = __float2bfloat16(ds);
  }
}

// Writes the warp's accumulator fragments (row tile rt, column tiles
// cg + 2 j) through its 256-float staging slice: out(row, col, value).
template <typename Out>
__device__ __forceinline__ void store_frags(Acc (&acc)[NFRAG], int nfrag, int rt, int cg,
                                            float* stg, Out out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) {
    if (j < nfrag) {
      wmma::store_matrix_sync(stg, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) out(rt * 16 + e / 16, (cg + 2 * j) * 16 + e % 16, stg[e]);
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
ce_bwd_dh_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                 const float* __restrict__ bias, const int* __restrict__ labels,
                 const float* __restrict__ z, const float* __restrict__ dg, void* __restrict__ dh,
                 int dh_bf16, int rows, int d, int v) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + PAD;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + TM * ld;
  float* sc = reinterpret_cast<float*>(ws + TV * ld);
  bf16* dsb = reinterpret_cast<bf16*>(sc + TM * SC_LD);

  const int warp = threadIdx.x >> 5;
  const int rt = warp & 3, cg = warp >> 2, nfrag = d / 32;
  const int row0 = blockIdx.x * TM;
  stage_h(hs, h, row0, rows, d);

  Acc acc[NFRAG];
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int v0 = 0; v0 < v; v0 += TV) {
    score_tile(hs, ws, sc, w, v0, v, d);
    form_ds(sc, dsb, bias, labels, z, dg, row0, rows, v0, v);
    __syncthreads();
    // dh[rows, D] += ds[rows, TV] @ W_tile[TV, D]; W_tile is (TV, D) row-major
    for (int k = 0; k < TV; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, dsb + rt * 16 * DS_LD + k, DS_LD);
#pragma unroll
      for (int j = 0; j < NFRAG; ++j) {
        if (j < nfrag) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + k * ld + (cg + 2 * j) * 16, ld);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }
  __syncthreads();  // sc is free: per-warp staging
  store_frags(acc, nfrag, rt, cg, sc + warp * 256, [=](int i, int c, float val) {
    if (row0 + i < rows) {
      const size_t o = (size_t)(row0 + i) * d + c;
      if (dh_bf16)
        static_cast<bf16*>(dh)[o] = __float2bfloat16(val);
      else
        static_cast<float*>(dh)[o] = val;
    }
  });
}

__global__ void __launch_bounds__(NTHREADS, 1)
ce_bwd_dw_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                 const float* __restrict__ bias, const int* __restrict__ labels,
                 const float* __restrict__ z, const float* __restrict__ dg, float* __restrict__ dw,
                 float* __restrict__ db, int rows, int d, int v) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + PAD;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + TM * ld;
  float* sc = reinterpret_cast<float*>(ws + TV * ld);
  bf16* dsb = reinterpret_cast<bf16*>(sc + TM * SC_LD);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int rt = warp & 3, cg = warp >> 2, nfrag = d / 32;
  const int v0 = blockIdx.x * TV;
  stage_w(ws, w, v0, v, d);

  Acc acc[NFRAG];
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) wmma::fill_fragment(acc[j], 0.f);
  float dbsum = 0.f;  // column v0 + tid, tid < TV
  for (int row0 = 0; row0 < rows; row0 += TM) {
    __syncthreads();  // the previous row tile's products are done
    stage_h(hs, h, row0, rows, d);
    __syncthreads();
    tile_scores(hs, ws, sc, d);
    form_ds(sc, dsb, bias, labels, z, dg, row0, rows, v0, v);
    __syncthreads();
    if (tid < TV)
      for (int i = 0; i < TM; ++i) dbsum += __bfloat162float(dsb[i * DS_LD + tid]);
    // dW_tile[TV, D] += ds^T[TV, rows] @ h_tile[rows, D]; ds^T is ds read
    // col-major
    for (int k = 0; k < TM; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, dsb + k * DS_LD + rt * 16, DS_LD);
#pragma unroll
      for (int j = 0; j < NFRAG; ++j) {
        if (j < nfrag) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, hs + k * ld + (cg + 2 * j) * 16, ld);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }
  __syncthreads();  // sc is free: per-warp staging
  store_frags(acc, nfrag, rt, cg, sc + warp * 256, [=](int i, int c, float val) {
    if (v0 + i < v) dw[(size_t)(v0 + i) * d + c] = val;
  });
  if (db && tid < TV && v0 + tid < v) db[v0 + tid] = dbsum;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// K9. h (rows, d) bf16; w (v, d) bf16; bias (v,) f32 or null; labels (rows,)
// i32 -> g (rows,) f32 label log-prob, pred (rows,) i32, z (rows,) f32.
NAVC_EXPORT int navc_ce_fwd(const void* h, const void* w, const void* bias, const void* labels,
                            void* g, void* pred, void* z, int rows, int d, int v, void* stream) {
  if (d % 32 || d > MAX_D) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(d);
  cudaError_t e = set_smem((const void*)ce_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ce_fwd_kernel<<<(rows + TM - 1) / TM, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<float*>(g), static_cast<int*>(pred),
      static_cast<float*>(z), rows, d, v);
  return (int)cudaGetLastError();
}

// K10, first launch. z from K9; dg (rows,) f32 -> dh (rows, d), bf16 when
// dh_bf16 else f32.
NAVC_EXPORT int navc_ce_bwd_dh(const void* h, const void* w, const void* bias, const void* labels,
                               const void* z, const void* dg, void* dh, int dh_bf16, int rows,
                               int d, int v, void* stream) {
  if (d % 32 || d > MAX_D) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t e = set_smem((const void*)ce_bwd_dh_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ce_bwd_dh_kernel<<<(rows + TM - 1) / TM, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(z),
      static_cast<const float*>(dg), dh, dh_bf16, rows, d, v);
  return (int)cudaGetLastError();
}

// K10, second launch -> dw (v, d) f32 and, when bias is given, db (v,) f32.
NAVC_EXPORT int navc_ce_bwd_dw(const void* h, const void* w, const void* bias, const void* labels,
                               const void* z, const void* dg, void* dw, void* db, int rows, int d,
                               int v, void* stream) {
  if (d % 32 || d > MAX_D) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t e = set_smem((const void*)ce_bwd_dw_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ce_bwd_dw_kernel<<<(v + TV - 1) / TV, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(z),
      static_cast<const float*>(dg), static_cast<float*>(dw), static_cast<float*>(db), rows, d,
      v);
  return (int)cudaGetLastError();
}
