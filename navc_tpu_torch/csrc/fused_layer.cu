// Whole post-LN BertLayer of the NAR decode (eval mode) in one kernel: the
// embedding LayerNorm prologue, masked self-attention, cross-attention over
// hoisted K/V, and the gelu_new FFN, with the residual times the non-pad
// multiplier after every stage. The same source serves the dense form (K1,
// every canvas row is a query; `causal` masks future keys for the AR
// teacher) and the sparse-query form (K2, only the re-masked slots named by
// an index tensor are queries; keys and values span the whole canvas).
//
// Replaces: navc_tpu/ops/fused_layer.py fused_nar_decoder_layer in its fold +
// pre_kv form (pallas_call at :289, body _kernel_fold :143 -> _layer_body
// :108 -> _attend_2d :50) and fused_nar_decoder_layer_qsub (pallas_call at
// :461, body _kernel_fold_qsub :337). The bf16 rounding points are those of
// _attend_2d / _layer_body: bf16 matmul operands with float32 accumulation,
// float32 bias, LayerNorm and softmax, the result in the output dtype.
//
// What bounds it on the H100: per sequence it does ~235 MFLOP of matmuls
// (L = 32 rows, H = 512, FFN 2048) against ~8 MB of bf16 weights. The
// weights sit in L2, but with 32 rows per block each weight element feeds
// only 2 wmma row tiles, so the block is bound by reading weight fragments
// from L2, not by the tensor cores; across the grid the FLOP bound is ~0.09
// ms and the device-memory byte bound ~0.03 ms per dense call.
//
// Design: one block (8 warps) per sequence, since L <= 32 — per-sequence
// attention replaces the TPU kernel's block-diagonal (T, T) scoring trick
// (fused_layer.py:12-23). The residual stream stays in shared memory as
// float32, with a bf16 copy as the A operand of every product. Products are
// bf16 wmma 16x16x16 with float32 accumulation; B fragments come straight
// from the weights in nn.Linear's (out, in) layout, which is the col-major
// B operand. One warp per head computes its 32x32 scores into a private
// slice of shared memory, softmaxes a row per lane, and multiplies by V. The
// FFN walks the 2048 intermediate columns 256 at a time: up-projection,
// gelu_new, bf16, then its share of the down-projection accumulates into
// register fragments, so the 32x2048 float intermediate never exists.
// Shared memory: 32x512 f32 residual + 4 bf16 32x520 tiles + staging, ~202 KB.
// Not yet done (later work): several sequences per block to reuse weight
// fragments, cp.async/TMA staging of weight tiles, wgmma.

#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int MR = 32;           // rows held per block (queries and keys)
constexpr int FFN_CH = 256;      // FFN intermediate columns per chunk
constexpr int SREG = MR * 32 * 4;  // per-warp score slice, bytes
constexpr float MASK_FILL = -10e6f;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

}  // namespace

// Mirrored field by field by navc_tpu_torch/ops/fused_layer.py (_LayerArgs).
struct LayerArgs {
  const bf16* raw;      // (N, L, H) raw word embeddings of the canvas
  const bf16* stat;     // (N, L, H) static features (position, category, enc mean)
  const float* lns;     // (H,) embedding LayerNorm scale
  const float* lnb;     // (H,) embedding LayerNorm bias
  const unsigned char* kp;  // (N, L) 1 where the canvas token is PAD
  const bf16* ke;       // (N, Le, H) hoisted cross keys
  const bf16* ve;       // (N, Le, H) hoisted cross values
  const int* qidx;      // (N, K) canvas position per query slot, -1 unused; null = dense
  const bf16* mrow;     // (H,) <mask> word embedding (sparse form)
  const bf16* w[8];     // wq_s, wk_s, wv_s, wo_s, wq_c, wk_c, wv_c, wo_c: (H, H) (out, in)
  const float* b[8];    // their biases (H,)
  const bf16* wi;       // (I, H)
  const float* bi;      // (I,)
  const bf16* wo2;      // (H, I)
  const float* bo2;     // (H,)
  void* out;            // (N, L or K, H) bf16 or f32
  int out_bf16;
  int n, L, Le, K, H, I, n_head, causal;
  float scale, eps;
};

namespace {

struct Smem {
  float* xf;   // [MR][H] residual stream, f32
  bf16* xb;    // [MR][ldb] bf16 A operand; per-warp score slices alias it
  bf16* qb;    // [MR][ldb] queries, then attention context
  bf16* kb;    // [MR][ldb] keys; FFN chunk activations alias it
  bf16* vb;    // [MR][ldb] values
  float* stg;  // [NW][256] per-warp accumulator staging
  int ldb;
};

__host__ __device__ inline size_t tile_bytes(int H) {
  const size_t a = (size_t)MR * (H + 8) * sizeof(bf16);
  const size_t b = (size_t)NW * SREG;
  const size_t c = (size_t)MR * (FFN_CH + 8) * sizeof(bf16);
  size_t m = a > b ? a : b;
  m = m > c ? m : c;
  return (m + 127) / 128 * 128;
}

inline size_t smem_bytes(int H) {
  return (size_t)MR * H * sizeof(float) + 4 * tile_bytes(H) + (size_t)NW * 256 * sizeof(float);
}

__device__ __forceinline__ float gelu_new(float x) {
  return 0.5f * x * (1.f + tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x * x * x)));
}

// C[rows 0 .. mt*16, cols 0 .. n_out) = A @ W^T, A bf16 row-major in shared
// memory (lda), W (n_out, k_in) bf16 row-major in global memory (ldw), i.e.
// the col-major B operand. Each warp takes output column tiles warp,
// warp + NW, ...; epi(row, col, value) consumes every accumulated element.
template <typename Epi>
__device__ void gemm_rows(const bf16* A, int lda, int mt, const bf16* W, int ldw, int n_out,
                          int k_in, float* stg, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int ct = warp; ct < n_out / 16; ct += NW) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    const bf16* wp = W + (size_t)ct * 16 * ldw;
    for (int k = 0; k < k_in; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, wp + k, ldw);
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        if (rt < mt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + rt * 16 * lda + k, lda);
          wmma::mma_sync(acc[rt], a, b, acc[rt]);
        }
      }
    }
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      if (rt < mt) {
        wmma::store_matrix_sync(stg, acc[rt], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) epi(rt * 16 + e / 16, ct * 16 + e % 16, stg[e]);
        __syncwarp();
      }
    }
  }
}

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

// Per-head attention over the block's rows. Queries: qb rows 0 .. mtq*16;
// keys/values: kb/vb rows 0 .. mtk*16. key_masked(i, j) adds MASK_FILL. The
// context (bf16) replaces each head's query columns in qb.
template <typename Masked>
__device__ void attend(const Smem& s, int H, int n_head, int mtq, int mtk, float scale,
                       Masked key_masked) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = H / n_head;
  const int ldb = s.ldb;
  float* sreg = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.xb) + warp * SREG);
  bf16* preg = reinterpret_cast<bf16*>(sreg);
  float* stg = s.stg + warp * 256;
  const int nk = mtk * 16;

  for (int hd = warp; hd < n_head; hd += NW) {
    const int c0 = hd * d;
    for (int rt = 0; rt < mtq; ++rt)
      for (int kt = 0; kt < mtk; ++kt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k = 0; k < d; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, s.qb + rt * 16 * ldb + c0 + k, ldb);
          wmma::load_matrix_sync(b, s.kb + kt * 16 * ldb + c0 + k, ldb);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(sreg + rt * 16 * 32 + kt * 16, acc, 32, wmma::mem_row_major);
      }
    __syncwarp();

    // softmax: lane i owns query row i
    const int i = lane;
    float p[32];
    const bool live = i < mtq * 16;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      p[j] = 0.f;
      if (live && j < nk) {
        p[j] = sreg[i * 32 + j] * scale + (key_masked(i, j) ? MASK_FILL : 0.f);
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
    __syncwarp();  // every lane has read its scores before P overwrites them
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (live && j < nk) preg[i * 32 + j] = __float2bfloat16(p[j] / sum);
    __syncwarp();

    for (int rt = 0; rt < mtq; ++rt)
      for (int dt = 0; dt < d / 16; ++dt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kt = 0; kt < mtk; ++kt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
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

__global__ void __launch_bounds__(NT, 1) fused_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, L = a.L, n = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool dense = a.qidx == nullptr;
  const int nq = dense ? L : a.K;
  const int mtq = (nq + 15) / 16, mtk = (L + 15) / 16, mte = (a.Le + 15) / 16;
  const int per = H / 32;

  Smem s;
  s.ldb = H + 8;
  const size_t tb = tile_bytes(H);
  s.xf = reinterpret_cast<float*>(smem);
  unsigned char* p = smem + (size_t)MR * H * sizeof(float);
  s.xb = reinterpret_cast<bf16*>(p);
  s.qb = reinterpret_cast<bf16*>(p + tb);
  s.kb = reinterpret_cast<bf16*>(p + 2 * tb);
  s.vb = reinterpret_cast<bf16*>(p + 3 * tb);
  s.stg = reinterpret_cast<float*>(p + 4 * tb);
  float* stg = s.stg + warp * 256;
  const int ldb = s.ldb;

  __shared__ float kmask[MR];  // 1 where the self-attention key is masked
  __shared__ float npm[MR];    // non-pad multiplier of each query row
  __shared__ int qpos[MR];     // canvas position of each query row
  if (threadIdx.x < MR) {
    const int j = threadIdx.x;
    kmask[j] = (j < L) ? (a.kp[(size_t)n * L + j] ? 1.f : 0.f) : 1.f;
    if (dense) {
      qpos[j] = j;
      npm[j] = (j < L) ? 1.f - kmask[j] : 0.f;
    } else {
      qpos[j] = (j < a.K) ? a.qidx[(size_t)n * a.K + j] : -1;
      npm[j] = qpos[j] >= 0 ? 1.f : 0.f;
    }
  }

  // 1. canvas rows: x = LN(raw + static) -> bf16 A operand (and the f32
  //    residual in the dense form)
  for (int r = warp; r < MR; r += NW) {
    float x[16];
    if (r < L) {
      const size_t base = ((size_t)n * L + r) * H;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < per) {
          const int c = lane + 32 * j;
          x[j] = __bfloat162float(a.raw[base + c]) + __bfloat162float(a.stat[base + c]);
        }
      ln_row(x, H, a.lns, a.lnb, a.eps);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < per) {
        const int c = lane + 32 * j;
        s.xb[r * ldb + c] = __float2bfloat16(x[j]);
        if (dense) s.xf[r * H + c] = x[j];
      }
  }
  __syncthreads();

  // 2. self-attention K, V (and Q in the dense form) from the canvas rows
  auto to_bf16 = [&](bf16* dst, const float* bias) {
    return [=](int i, int j, float v) { dst[i * ldb + j] = __float2bfloat16(v + bias[j]); };
  };
  gemm_rows(s.xb, ldb, mtk, a.w[1], H, H, H, stg, to_bf16(s.kb, a.b[1]));
  gemm_rows(s.xb, ldb, mtk, a.w[2], H, H, H, stg, to_bf16(s.vb, a.b[2]));
  if (dense) gemm_rows(s.xb, ldb, mtq, a.w[0], H, H, H, stg, to_bf16(s.qb, a.b[0]));
  __syncthreads();

  if (!dense) {
    // 3. query slots: x_q = LN(<mask> row + static[pos]); unused slots read
    //    LN(<mask> row) and are zeroed by their multiplier
    for (int r = warp; r < MR; r += NW) {
      float x[16];
      const int pos = qpos[r];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < per) {
          const int c = lane + 32 * j;
          x[j] = __bfloat162float(a.mrow[c]) +
                 (pos >= 0 ? __bfloat162float(a.stat[((size_t)n * L + pos) * H + c]) : 0.f);
        }
      ln_row(x, H, a.lns, a.lnb, a.eps);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < per) {
          const int c = lane + 32 * j;
          s.xf[r * H + c] = x[j];
          s.xb[r * ldb + c] = __float2bfloat16(x[j]);
        }
    }
    __syncthreads();
    gemm_rows(s.xb, ldb, mtq, a.w[0], H, H, H, stg, to_bf16(s.qb, a.b[0]));
    __syncthreads();
  }

  // 4. masked self-attention; the context replaces Q in qb
  const bool causal = a.causal != 0;
  const float* kmask_p = kmask;
  const int* qpos_p = qpos;
  attend(s, H, a.n_head, mtq, mtk, a.scale, [=](int i, int j) {
    return kmask_p[j] > 0.5f || (causal && j > qpos_p[i]);
  });
  __syncthreads();

  // 5. self output: att = (ctx @ Wo + bo + x) * npm
  const float* npm_p = npm;
  auto residual = [&](const float* bias) {
    return [=](int i, int j, float v) {
      const float y = (v + bias[j] + s.xf[i * H + j]) * npm_p[i];
      s.xf[i * H + j] = y;
      s.xb[i * ldb + j] = __float2bfloat16(y);
    };
  };
  gemm_rows(s.qb, ldb, mtq, a.w[3], H, H, H, stg, residual(a.b[3]));
  __syncthreads();

  // 6. cross-attention over the hoisted K/V
  {
    const int vecs = H / 8;
    for (int i = threadIdx.x; i < mte * 16 * vecs; i += NT) {
      const int r = i / vecs, c = (i % vecs) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (r < a.Le) {
        const size_t off = ((size_t)n * a.Le + r) * H + c;
        kv = *reinterpret_cast<const uint4*>(a.ke + off);
        vv = *reinterpret_cast<const uint4*>(a.ve + off);
      }
      *reinterpret_cast<uint4*>(s.kb + r * ldb + c) = kv;
      *reinterpret_cast<uint4*>(s.vb + r * ldb + c) = vv;
    }
  }
  gemm_rows(s.xb, ldb, mtq, a.w[4], H, H, H, stg, to_bf16(s.qb, a.b[4]));
  __syncthreads();
  const int Le = a.Le;
  attend(s, H, a.n_head, mtq, mte, a.scale, [=](int, int j) { return j >= Le; });
  __syncthreads();
  gemm_rows(s.qb, ldb, mtq, a.w[7], H, H, H, stg, residual(a.b[7]));
  __syncthreads();

  // 7. FFN: per 256-column chunk, up-projection + gelu_new into bf16, then
  //    its share of the down-projection accumulates in registers. Warp w
  //    owns output column tiles w, w + NW, ... (at most 4: H <= 512).
  const int ctw = H / 16 / NW;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> down[2][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(down[rt][t], 0.f);
  bf16* ib = s.kb;
  const int ldi = FFN_CH + 8;
  for (int c0 = 0; c0 < a.I; c0 += FFN_CH) {
    const int cw = min(FFN_CH, a.I - c0);
    const float* bi = a.bi + c0;
    gemm_rows(s.xb, ldb, mtq, a.wi + (size_t)c0 * H, H, cw, H, stg,
              [=](int i, int j, float v) { ib[i * ldi + j] = __float2bfloat16(gelu_new(v + bi[j])); });
    __syncthreads();
    for (int k = 0; k < cw; k += 16) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < ctw) {
          const int ct = warp + NW * t;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, a.wo2 + (size_t)ct * 16 * a.I + c0 + k, a.I);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            if (rt < mtq) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
              wmma::load_matrix_sync(fa, ib + rt * 16 * ldi + k, ldi);
              wmma::mma_sync(down[rt][t], fa, b, down[rt][t]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // out = (down + bo2 + att) * npm, rows of real queries only
  const int rows_out = dense ? L : a.K;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < ctw) {
      const int ct = warp + NW * t;
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        if (rt < mtq) {
          wmma::store_matrix_sync(stg, down[rt][t], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int i = rt * 16 + e / 16, j = ct * 16 + e % 16;
            if (i < rows_out) {
              const float y = (stg[e] + a.bo2[j] + s.xf[i * H + j]) * npm[i];
              const size_t o = ((size_t)n * rows_out + i) * H + j;
              if (a.out_bf16)
                static_cast<bf16*>(a.out)[o] = __float2bfloat16(y);
              else
                static_cast<float*>(a.out)[o] = y;
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

}  // namespace

NAVC_EXPORT int navc_fused_layer(const LayerArgs* args, void* stream) {
  const size_t smem = smem_bytes(args->H);
  cudaError_t e = cudaFuncSetAttribute(fused_layer_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_layer_kernel<<<args->n, NT, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
