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
// :108 -> _attend_2d :50), fused_nar_decoder_layer_qsub (pallas_call at
// :461, body _kernel_fold_qsub :337) and, as K1u, fused_nar_decoder_layer
// in its unfolded form (pallas_call at :303, body _kernel :133: the layer on
// embedded rows, cross K/V projected in the kernel). K1u is K11's forward
// (layer_common.cuh layer_fwd) with both dropout probabilities 0. The bf16 rounding points are those of
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
// The layout, the row GEMM, the per-head softmax and the FFN live in
// layer_common.cuh, shared with the training layer (fused_layer_train.cu).
// Not yet done (later work): several sequences per block to reuse weight
// fragments, cp.async/TMA staging of weight tiles, wgmma.

#include "layer_common.cuh"

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

__global__ void __launch_bounds__(NT, 1) fused_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, L = a.L, n = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool dense = a.qidx == nullptr;
  const int nq = dense ? L : a.K;
  const int mtq = (nq + 15) / 16, mtk = (L + 15) / 16, mte = (a.Le + 15) / 16;
  const int per = H / 32;

  const LayerSmem s = layer_layout(smem, H);
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

  // 7. FFN; out = (down + bo2 + att) * npm, rows of real queries only
  const int rows_out = dense ? L : a.K;
  const float* bo2 = a.bo2;
  void* out = a.out;
  const bool out_bf16 = a.out_bf16 != 0;
  ffn_rows(s, H, a.I, mtq, a.wi, a.bi, a.wo2, [=](int i, int j, float v) {
    if (i < rows_out) {
      const float y = (v + bo2[j] + s.xf[i * H + j]) * npm_p[i];
      const size_t o = ((size_t)n * rows_out + i) * H + j;
      if (out_bf16)
        static_cast<bf16*>(out)[o] = __float2bfloat16(y);
      else
        static_cast<float*>(out)[o] = y;
    }
  });
}

// K1u
__global__ void __launch_bounds__(NT, 1) unfolded_layer_kernel(const TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float kmask[MR], npm[MR];
  layer_fwd(a, smem, kmask, npm);
}

}  // namespace

// K1u: x (N, L, H) f32 embedded rows, enc (N, Le, H) f32, no dropout, no r2.
NAVC_EXPORT int navc_fused_layer_unfolded(const TrainArgs* args, void* stream) {
  if (args->on_hidden || args->on_input || args->r2) return (int)cudaErrorInvalidValue;
  return launch_rows(unfolded_layer_kernel, args, layer_smem_bytes(args->H), stream);
}

NAVC_EXPORT int navc_fused_layer(const LayerArgs* args, void* stream) {
  const size_t smem = layer_smem_bytes(args->H);
  cudaError_t e = cudaFuncSetAttribute(fused_layer_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_layer_kernel<<<args->n, NT, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
