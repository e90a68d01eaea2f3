// The AR beam step's attention: the fused cached self-attention step (K6)
// and the beam cross-attention over the encoder positions (K7).
//
// Replaces: navc_tpu/ops/beam_attend.py beam_attend_step (pallas_call at
// :371, body _kernel :125) and cross_attend (pallas_call at :301, body
// _cross_kernel :225).
//
// K6, one launch per beam step, does three things:
//   1. permutes both caches by the PREVIOUS step's beam ancestry (output row
//      i*k + j takes row i*k + prev_k[i, j]) at positions [0, tpos);
//   2. writes the new K/V row at position tpos (rounded to the cache type);
//   3. computes the causal cached attention of each row's query over
//      positions 0..tpos with the additive mask and a float32 softmax.
// The caches are updated IN PLACE, as the JAX kernel aliases them. Blocks run
// in parallel, so a block that wrote row i*k + j while another still read it
// as an ancestor would corrupt the cache. The design that avoids it: one
// block owns a whole instance (its k rows). It stages the k source rows of a
// run of positions in shared memory, synchronises, writes the permuted rows
// back, synchronises, and walks on to the next run; no other block touches
// those rows. An identity ancestry (the first step, and every instance whose
// beams kept their slots) skips the copy. Positions past tpos are left as
// they were: the caller treats them as unspecified, as in JAX.
// Attention: one warp per (row, head); each lane holds dh/32 of the head's
// dimensions, the dot product is a warp sum, and an online softmax walks the
// positions, so no score vector is kept. It reads the rows the block has just
// written (after a barrier, through plain loads: the read-only path could
// serve stale data).
//
// K7: the same warp-per-(row, head) online softmax over the Te encoder
// positions, without a mask. The k beams of an instance share its encoder
// K/V, so the kernel reads the per-instance (b, Te, H) tensors at row / k;
// the JAX wrapper's per-decode expansion to b*k rows is not needed.
//
// What bounds them on the H100: bytes. K6 reads and writes the ancestry-
// moved cache prefix and reads the attended prefix once (at 320 rows, tpos
// 15: ~10 MB, ~3 us); K7 reads q and the per-instance encoder K/V (~2 MB at
// 64 videos). The arithmetic is a few MFLOP. The kernels are simple rather
// than fast: the attention's loads are serialised through the softmax chain
// and K6 keeps only b blocks in flight (64 at 64 videos on 132 SMs).

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_BEAM = 32;         // rows of one instance (k)
constexpr int MAX_DL = 4;            // head width <= 32 * MAX_DL
constexpr int STAGE_BYTES = 96 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// One warp: softmax(q . K[p] * scale + mask[p]) over positions 0..np-1,
// applied to V. q_row, att_row: this head's slice; kb, vb: position 0 of this
// head's slice, positions `stride` elements apart; mask null for none.
template <typename T>
__device__ __forceinline__ void warp_attend(const float* q_row, const T* kb, const T* vb,
                                            size_t stride, const float* mask, int np, int dh,
                                            float scale, float* att_row) {
  const int lane = threadIdx.x & 31;
  float qv[MAX_DL], acc[MAX_DL];
#pragma unroll
  for (int j = 0; j < MAX_DL; ++j) {
    const int d = lane + 32 * j;
    qv[j] = d < dh ? q_row[d] : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, s = 0.f;
  for (int p = 0; p < np; ++p) {
    const T* kp = kb + (size_t)p * stride;
    const T* vp = vb + (size_t)p * stride;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_DL; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) part += qv[j] * to_f32(kp[d]);
    }
    const float sc = warp_sum(part) * scale + (mask ? mask[p] : 0.f);
    const float mn = fmaxf(m, sc);
    const float a = expf(m - mn);
    const float e = expf(sc - mn);
    s = s * a + e;
#pragma unroll
    for (int j = 0; j < MAX_DL; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) acc[j] = acc[j] * a + e * to_f32(vp[d]);
    }
    m = mn;
  }
#pragma unroll
  for (int j = 0; j < MAX_DL; ++j) {
    const int d = lane + 32 * j;
    if (d < dh) att_row[d] = acc[j] / s;
  }
}

// Grid: one block per instance. kc, vc (b*k, L*H) in place.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
attend_step_kernel(T* kc, T* vc, const float* __restrict__ q, const float* __restrict__ kt,
                   const float* __restrict__ vt, const int* __restrict__ prev_k,
                   const float* __restrict__ amask, float* __restrict__ att, int k, int L, int H,
                   int nh, int tpos, float scale, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int src[MAX_BEAM];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * k;
  const size_t row_elems = (size_t)L * H;

  if (tid < k) src[tid] = prev_k[row0 + tid];
  __syncthreads();
  bool identity = true;
  for (int j = 0; j < k; ++j) identity = identity && src[j] == j;

  // 1. permute positions [0, tpos), a run of `chunk` positions at a time
  if (!identity) {
    uint4* stage = reinterpret_cast<uint4*>(smem);
    uint4* kc4 = reinterpret_cast<uint4*>(kc);
    uint4* vc4 = reinterpret_cast<uint4*>(vc);
    const int pos_vecs = H * (int)sizeof(T) / 16;
    const size_t row_vecs = (size_t)L * pos_vecs;
    for (int p0 = 0; p0 < tpos; p0 += chunk) {
      const int per_row = min(chunk, tpos - p0) * pos_vecs;
      const int total = 2 * k * per_row;
      for (int i = tid; i < total; i += NTHREADS) {
        const int c = i / (k * per_row);
        const int rem = i - c * k * per_row;
        const int r = rem / per_row;
        const uint4* from = (c ? vc4 : kc4) + (size_t)(row0 + src[r]) * row_vecs +
                            (size_t)p0 * pos_vecs;
        stage[i] = from[rem - r * per_row];
      }
      __syncthreads();
      for (int i = tid; i < total; i += NTHREADS) {
        const int c = i / (k * per_row);
        const int rem = i - c * k * per_row;
        const int r = rem / per_row;
        uint4* to = (c ? vc4 : kc4) + (size_t)(row0 + r) * row_vecs + (size_t)p0 * pos_vecs;
        to[rem - r * per_row] = stage[i];
      }
      __syncthreads();
    }
  }

  // 2. the new K/V row at tpos
  for (int i = tid; i < k * H; i += NTHREADS) {
    const int r = i / H, c = i - r * H;
    const size_t at = (size_t)(row0 + r) * row_elems + (size_t)tpos * H + c;
    kc[at] = from_f32<T>(kt[(size_t)(row0 + r) * H + c]);
    vc[at] = from_f32<T>(vt[(size_t)(row0 + r) * H + c]);
  }
  __syncthreads();

  // 3. attention over positions 0..tpos, one warp per (row, head)
  const int dh = H / nh;
  for (int item = tid >> 5; item < k * nh; item += NWARPS) {
    const int r = item / nh, hd = item - r * nh;
    const size_t row = row0 + r;
    const T* kb = kc + row * row_elems + hd * dh;
    const T* vb = vc + row * row_elems + hd * dh;
    warp_attend<T>(q + row * H + hd * dh, kb, vb, H, amask + row * L, tpos + 1, dh, scale,
                   att + row * H + hd * dh);
  }
}

// Grid: one block per row; warps walk the heads. ke, ve (b, Te, H).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
cross_kernel(const float* __restrict__ q, const T* __restrict__ ke, const T* __restrict__ ve,
             float* __restrict__ att, int k, int te, int H, int nh, float scale) {
  const size_t row = blockIdx.x;
  const size_t inst = row / k;
  const int dh = H / nh;
  for (int hd = threadIdx.x >> 5; hd < nh; hd += blockDim.x >> 5) {
    warp_attend<T>(q + row * H + hd * dh, ke + inst * te * H + hd * dh,
                   ve + inst * te * H + hd * dh, H, nullptr, te, dh, scale,
                   att + row * H + hd * dh);
  }
}

bool shape_ok(int k, int H, int nh, int esz) {
  return k >= 1 && k <= MAX_BEAM && nh >= 1 && H % nh == 0 && H / nh <= 32 * MAX_DL &&
         (H * esz) % 16 == 0;
}

template <typename T>
int launch_step(void* kc, void* vc, const void* q, const void* kt, const void* vt,
                const void* prev_k, const void* amask, void* att, int n, int k, int L, int H,
                int nh, int tpos, float scale, cudaStream_t st) {
  const int per_pos = 2 * k * H * (int)sizeof(T);
  const int chunk = min(L, STAGE_BYTES / per_pos);
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int smem = chunk * per_pos;
  cudaError_t e = cudaFuncSetAttribute(attend_step_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  attend_step_kernel<T><<<n / k, NTHREADS, smem, st>>>(
      static_cast<T*>(kc), static_cast<T*>(vc), static_cast<const float*>(q),
      static_cast<const float*>(kt), static_cast<const float*>(vt),
      static_cast<const int*>(prev_k), static_cast<const float*>(amask),
      static_cast<float*>(att), k, L, H, nh, tpos, scale, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cross(const void* q, const void* ke, const void* ve, void* att, int n, int k, int te,
                 int H, int nh, float scale, cudaStream_t st) {
  const int threads = 32 * min(nh, NWARPS);
  cross_kernel<T><<<n, threads, 0, st>>>(static_cast<const float*>(q),
                                         static_cast<const T*>(ke), static_cast<const T*>(ve),
                                         static_cast<float*>(att), k, te, H, nh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// kc, vc (n, L*H) f32 (cache_f32 = 1) or bf16, updated in place; q, kt, vt
// (n, H) f32; prev_k (n / k, k) i32; amask (n, L) f32 -> att (n, H) f32.
NAVC_EXPORT int navc_beam_attend_step(void* kc, void* vc, const void* q, const void* kt,
                                      const void* vt, const void* prev_k, const void* amask,
                                      void* att, int n, int k, int L, int H, int nh, int tpos,
                                      float scale, int cache_f32, void* stream) {
  const int esz = cache_f32 ? 4 : 2;
  if (!shape_ok(k, H, nh, esz) || n % k != 0 || tpos < 0 || tpos >= L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cache_f32 ? launch_step<float>(kc, vc, q, kt, vt, prev_k, amask, att, n, k, L, H, nh,
                                        tpos, scale, st)
                   : launch_step<bf16>(kc, vc, q, kt, vt, prev_k, amask, att, n, k, L, H, nh,
                                       tpos, scale, st);
}

// q (n, H) f32; ke, ve (n / k, te, H) f32 (kv_f32 = 1) or bf16 -> att (n, H)
// f32.
NAVC_EXPORT int navc_cross_attend(const void* q, const void* ke, const void* ve, void* att, int n,
                                  int k, int te, int H, int nh, float scale, int kv_f32,
                                  void* stream) {
  const int esz = kv_f32 ? 4 : 2;
  if (!shape_ok(k, H, nh, esz) || n % k != 0 || te < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_f32 ? launch_cross<float>(q, ke, ve, att, n, k, te, H, nh, scale, st)
                : launch_cross<bf16>(q, ke, ve, att, n, k, te, H, nh, scale, st);
}
