// Beam-ancestry permute of the AR beam search's two K/V caches (K8): output
// row i*k + j is input row i*k + prev_k[i, j], whole rows, exactly.
//
// Replaces: navc_tpu/ops/beam_permute.py permute_beam_caches (pallas_call at
// :101, body _kernel :49). The TPU kernel selects rows with a block-diagonal
// one-hot matmul on the MXU, because Mosaic has no row gather; on Hopper it
// is a plain row gather.
//
// What bounds it on the H100: bytes. Each output row is one copy of an input
// row, so the work is reading and writing both caches once (at 320 rows of
// 30 x 512 bf16: 2 x 9.8 MB read, 2 x 9.8 MB written, ~12 us at 3.35 TB/s).
//
// Design: one block per output row; its threads copy the row in 16-byte
// vectors, neighbouring threads on neighbouring addresses, for both caches.
// The copy is out of place (the wrapper allocates the outputs), so blocks
// never read a row that another block writes. The payload is bytes: any
// element type whose row is a multiple of 16 bytes.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
permute_kernel(const uint4* __restrict__ kc, const uint4* __restrict__ vc,
               const int* __restrict__ prev_k, uint4* __restrict__ okc, uint4* __restrict__ ovc,
               int k, int vecs) {
  const int row = blockIdx.x;
  const int src = (row / k) * k + prev_k[row];
  const uint4* ks = kc + (size_t)src * vecs;
  const uint4* vs = vc + (size_t)src * vecs;
  uint4* kd = okc + (size_t)row * vecs;
  uint4* vd = ovc + (size_t)row * vecs;
  for (int i = threadIdx.x; i < vecs; i += NTHREADS) {
    kd[i] = ks[i];
    vd[i] = vs[i];
  }
}

}  // namespace

// kc, vc (n, row_bytes) -> okc, ovc (n, row_bytes); prev_k (n / k, k) i32.
// row_bytes must be a multiple of 16 and every pointer 16-byte aligned.
NAVC_EXPORT int navc_permute_beam_caches(const void* kc, const void* vc, const void* prev_k,
                                         void* okc, void* ovc, int n, int k, int row_bytes,
                                         void* stream) {
  if (row_bytes % 16 != 0 || k < 1 || n % k != 0) return (int)cudaErrorInvalidValue;
  permute_kernel<<<n, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(kc), static_cast<const uint4*>(vc),
      static_cast<const int*>(prev_k), static_cast<uint4*>(okc), static_cast<uint4*>(ovc), k,
      row_bytes / 16);
  return (int)cudaGetLastError();
}
