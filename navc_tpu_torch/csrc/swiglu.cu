// SwiGLU's activation for the MLAMoE language model's MLPs (K13): out[p, j]
// = silu(gu[p, j]) * gu[p, inter + j] * w[p], the gate and up halves of one
// (rows, 2 * inter) product, w a routed pair's weight (or 1), in float32,
// rounded once to bf16.
//
// Replaces: no TPU kernel (the JAX package has no MoE model). It was added
// because PyTorch takes three passes over the routed pairs' activations
// (silu of the gate half, its product with the up half, the product with
// the pair's weight), each a strided, unvectorized elementwise kernel that
// rounds to bf16: at 15,360 pairs x 1408 per MoE layer step they took about
// 9% of the decode on the H100.
//
// What bounds it on the H100: bytes. Each row reads 2 * inter bf16 values
// and one float32 weight and writes inter bf16 values (15,360 x 1408 per
// MoE layer step: 86.5 MB read, 43.3 MB written, ~39 us at 3.35 TB/s).
//
// Design: a thread per 8 output columns of one row: one 16-byte load of the
// gate's 8 values and one of the up's, float32 arithmetic, one 16-byte
// store; consecutive threads take consecutive column groups, rows follow
// one another (a grid-stride loop over rows x inter / 8 groups).

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
swiglu_kernel(const uint4* __restrict__ gu, const float* __restrict__ w, uint4* __restrict__ out,
              long long groups, int per_row) {
  for (long long i = blockIdx.x * (long long)NTHREADS + threadIdx.x; i < groups;
       i += (long long)gridDim.x * NTHREADS) {
    const long long row = i / per_row;
    const int col = (int)(i - row * per_row);
    const uint4 g = gu[row * 2 * per_row + col];
    const uint4 u = gu[row * 2 * per_row + per_row + col];
    const float scale = w ? w[row] : 1.f;
    const bf16* gv = reinterpret_cast<const bf16*>(&g);
    const bf16* uv = reinterpret_cast<const bf16*>(&u);
    uint4 o;
    bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = __bfloat162float(gv[e]);
      const float silu = x / (1.f + __expf(-x));
      ov[e] = __float2bfloat16(silu * __bfloat162float(uv[e]) * scale);
    }
    out[i] = o;
  }
}

}  // namespace

// gu (rows, 2 * inter) bf16 -> out (rows, inter) bf16; w (rows,) f32 or
// null. inter a multiple of 8, every pointer 16-byte aligned.
NAVC_EXPORT int navc_swiglu(const void* gu, const void* w, void* out, long long rows, int inter,
                            int sms, void* stream) {
  if (inter < 8 || inter % 8 != 0 || rows < 0) return (int)cudaErrorInvalidValue;
  const long long groups = rows * (inter / 8);
  if (groups == 0) return (int)cudaSuccess;
  const long long want = (groups + NTHREADS - 1) / NTHREADS;
  const int blocks = (int)(want < 16LL * sms ? want : 16LL * sms);
  swiglu_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(gu), static_cast<const float*>(w), static_cast<uint4*>(out),
      groups, inter / 8);
  return (int)cudaGetLastError();
}
