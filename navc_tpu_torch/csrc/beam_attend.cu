// The AR beam step's attention: the fused cached self-attention step (K6)
// and the beam cross-attention over the encoder positions (K7).
//
// Replaces: navc_tpu/ops/beam_attend.py beam_attend_step (pallas_call at
// :371, body _kernel :125) and cross_attend (pallas_call at :301, body
// _cross_kernel :225).
//
// K6, one call per beam step, does three things:
//   1. permutes both caches by the PREVIOUS step's beam ancestry (output row
//      i*k + j takes row i*k + prev_k[i, j]) at positions [0, tpos);
//   2. writes the new K/V row at position tpos (rounded to the cache type);
//   3. computes the causal cached attention of each row's query over
//      positions 0..tpos with the additive mask and a float32 softmax.
// The caches are updated IN PLACE, as the JAX kernel aliases them. Positions
// past tpos are left as they were: the caller treats them as unspecified,
// as in JAX.
//
// What bounds it on the H100: bytes. The permute reads the cache prefix [0,
// tpos) of both caches and writes [0, tpos]; the attention needs the same
// rows once more, and the arithmetic is a few MFLOP. At 320 rows (64 videos,
// beam 5), H 512, bf16, tpos 14: ~21.6 MB, 6.5 us at 3.35 TB/s; at the
// B=1024 decode's 5120 rows ~346 MB, 0.10 ms. In the earlier design one
// block owned an instance (64 blocks on 132 SMs at 64 videos), staged each
// run of positions, wrote it back, then read the prefix again from device
// memory for the attention, one warp per (row, head) walking the positions
// one by one through an online-softmax chain: twice the bytes of the bound,
// the loads serialised behind the chain.
//
// Design: a position-split pass. A block per (instance, run of positions):
// the run [p0, p0 + run) of the k rows, cut at tpos. Blocks that own
// disjoint runs of one instance touch disjoint cache positions (the permute
// at position p mixes only the k rows of one instance at p), so they permute
// in place with no hazard between them. A block stages the k ancestor rows
// of its run in shared memory with 16-byte cp.async copies, all in flight at
// once (position rows padded by 16 bytes, so that threads reading different
// positions hit different banks), puts the new row at tpos into the stage if
// its run holds tpos, writes the stage back (an identity ancestry, the first
// step and every instance whose beams kept their slots, writes back only the
// tpos row), and computes from the same stage each (row, head)'s partial
// softmax over its positions: a thread per score (a run holds a few
// positions, so a warp per (row, head) would leave most lanes idle), a
// thread per (row, head) for the max and the sum of exponentials, a thread
// per column for the weighted V sums. The cache prefix is read once and
// written once. With one run the block writes the attention itself;
// otherwise the partials go to a float32 scratch and each (row, column)'s
// are merged in run order: by the instance's last block to finish (a counter
// per instance, one atomic add a block) when the blocks take more than one
// wave, so that the merges overlap other blocks' work and find the partials
// in L2 (the runs of an instance are neighbours in launch order); else by a
// second launch, a thread per (row, column), since a last block's merge
// would run alone after the pass. Either way the sums do not depend on the
// blocks' timing, and two calls give the same bits. The run length is
// planned on the host (navc_tpu_torch/ops/beam_attend.py attend_runs) from
// the instances, k, tpos, H, the heads and the SM count.
//
// K7: a warp per (row, head) walks the Te encoder positions with an online
// softmax (warp_attend), without a mask. The k beams of an instance share
// its encoder K/V, so the kernel reads the per-instance (b, Te, H) tensors
// at row / k; the JAX wrapper's per-decode expansion to b*k rows is not
// needed. It reads q and the per-instance encoder K/V (~2 MB at 64 videos):
// bytes bound it too; its loads are serialised through the softmax chain.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_BEAM = 32;         // rows of one instance (k)
constexpr int MAX_DL = 4;            // head width <= 32 * MAX_DL
constexpr int MAX_RUN = 32;          // K6 positions a block owns, at most
constexpr int STAGE_MAX = 192 * 1024;  // K6 shared memory a block, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// One warp (K7): softmax(q . K[p] * scale) over positions 0..np-1, applied
// to V. q_row, att_row: this head's slice; kb, vb: position 0 of this head's
// slice, positions `stride` elements apart.
template <typename T>
__device__ __forceinline__ void warp_attend(const float* q_row, const T* kb, const T* vb,
                                            size_t stride, int np, int dh, float scale,
                                            float* att_row) {
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
    const float sc = warp_sum(part) * scale;
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

// 16 bytes from global src to shared dst, asynchronously (cp.async).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The even (low half) and odd (high half) bf16 of a 32-bit pair as floats.
__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// One staged position row: H elements and 16 bytes of padding.
template <typename T>
__host__ __device__ inline int stage_ld(int H) { return H + 16 / (int)sizeof(T); }

// q . K[p] over the head's dh dimensions: kr this head's slice of a staged
// position row, qr its slice of the query row (float32, device memory).
template <typename T>
__device__ __forceinline__ float dot_head(const float* qr, const T* kr, int dh) {
  float s0 = 0.f, s1 = 0.f;
  if ((dh * (int)sizeof(T)) % 16 != 0) {  // head slices not 16-byte aligned
    for (int d = 0; d < dh; ++d) s0 += qr[d] * to_f32(kr[d]);
    return s0;
  }
#pragma unroll 4
  for (int d = 0; d < dh; d += 16 / (int)sizeof(T)) {
    const uint4 kv = *reinterpret_cast<const uint4*>(kr + d);
    const float4 qa = *reinterpret_cast<const float4*>(qr + d);
    if constexpr (sizeof(T) == 4) {
      s0 += qa.x * __uint_as_float(kv.x) + qa.y * __uint_as_float(kv.y);
      s1 += qa.z * __uint_as_float(kv.z) + qa.w * __uint_as_float(kv.w);
    } else {
      const float4 qb = *reinterpret_cast<const float4*>(qr + d + 4);
      s0 += qa.x * bf_lo(kv.x) + qa.y * bf_hi(kv.x) + qa.z * bf_lo(kv.y) + qa.w * bf_hi(kv.y);
      s1 += qb.x * bf_lo(kv.z) + qb.y * bf_hi(kv.z) + qb.z * bf_lo(kv.w) + qb.w * bf_hi(kv.w);
    }
  }
  return s0 + s1;
}

// K6's merge of a (row, head) over its instance's runs, in run order: the
// largest partial max M and sum_s l_s exp(m_s - M). m: the (row, head)'s
// (max, sum) of run 0, a run's nh float2 apart. The partials were written
// by other blocks: read past L1 (__ldcg).
__device__ __forceinline__ float2 merge_max_sum(const float2* m, int runs, int nh) {
  float mx = -INFINITY, l = 0.f;
#pragma unroll 8
  for (int j = 0; j < runs; ++j) mx = fmaxf(mx, __ldcg(&m[j * nh]).x);
#pragma unroll 8
  for (int j = 0; j < runs; ++j) {
    const float2 p = __ldcg(&m[j * nh]);
    l += p.y * expf(p.x - mx);
  }
  return make_float2(mx, l);
}

// ... and of one of its columns: sum_s pacc_s exp(m_s - M); a: the column's
// weighted V sum of run 0, a run's H floats apart.
__device__ __forceinline__ float merge_sum(const float* a, const float2* m, int runs, int nh,
                                           int H, float mx) {
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < runs; ++j)
    acc += __ldcg(&a[(size_t)j * H]) * expf(__ldcg(&m[j * nh]).x - mx);
  return acc;
}

// K6. Block i * runs + s owns positions [p0, p1) of instance i's k rows,
// p0 = s * run, p1 = min(p0 + run, tpos + 1): the runs of an instance are
// neighbours in launch order. Shared memory: the staged K rows
// [k][run][ld], the V rows, each (row, head)'s (max, sum of exponentials)
// [k][nh], its scores [k][nh][run]. kc, vc (b*k, L*H) in place; att (b*k,
// H). With runs > 1: the partials pacc (b*k, runs, H) weighted V sums and
// pml (b*k, runs, nh) (max, sum of exponentials) as float2; with `fuse`
// the instance's last block merges them (cnt (b,): the runs of each
// instance done, zero on entry), else step_merge_kernel does.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 4)
step_run_kernel(T* kc, T* vc, const float* __restrict__ q, const float* __restrict__ kt,
                const float* __restrict__ vt, const int* __restrict__ prev_k,
                const float* __restrict__ amask, float* __restrict__ att, float* pacc,
                float2* pml, int* cnt, int k, int L, int H, int nh, int tpos, float scale,
                int run, int runs, int fuse) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int src[MAX_BEAM];
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int inst = blockIdx.x / runs, s = blockIdx.x - inst * runs, row0 = inst * k;
  const int p0 = s * run, np = min(run, tpos + 1 - p0), nold = min(np, tpos - p0);
  const int ld = stage_ld<T>(H), ld_vecs = ld * (int)sizeof(T) / 16;
  const int pos_vecs = H * (int)sizeof(T) / 16;
  const size_t row_vecs = (size_t)L * pos_vecs;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)k * run * ld;
  float2* ml = reinterpret_cast<float2*>(vs + (size_t)k * run * ld);
  float* sc = reinterpret_cast<float*>(ml + k * nh);

  if (tid < k) src[tid] = prev_k[row0 + tid];
  __syncthreads();
  bool identity = true;
  for (int j = 0; j < k; ++j) identity = identity && src[j] == j;

  // 1. stage positions [p0, p0 + nold) of the ancestor rows, row r of the
  //    stage holding row src[r]: a warp per position row, its lanes on the
  //    row's 16-byte vectors
  for (int c = 0; c < 2; ++c)
    for (int r = 0; r < k; ++r)
      for (int pp = warp; pp < nold; pp += NWARPS) {
        const uint4* from = reinterpret_cast<const uint4*>(c ? vc : kc) +
                            (size_t)(row0 + src[r]) * row_vecs + (size_t)(p0 + pp) * pos_vecs;
        uint4* to = reinterpret_cast<uint4*>(c ? vs : ks) + (size_t)(r * run + pp) * ld_vecs;
        for (int v = lane; v < pos_vecs; v += 32) cp_async16(to + v, from + v);
      }
  // 2. the new K/V row of each of the k rows at tpos, if this run holds it
  if (nold < np) {
    const int pp = tpos - p0;
    for (int r = warp; r < k; r += NWARPS) {
      const size_t at = (size_t)(r * run + pp) * ld, from = (size_t)(row0 + r) * H;
      for (int c = lane; c < H; c += 32) {
        ks[at + c] = from_f32<T>(kt[from + c]);
        vs[at + c] = from_f32<T>(vt[from + c]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. write the stage back: every position of the run, or only tpos's
  //    row for an identity ancestry; a warp per position row
  for (int c = 0; c < 2; ++c)
    for (int r = 0; r < k; ++r)
      for (int pp = (identity ? nold : 0) + warp; pp < np; pp += NWARPS) {
        const uint4* from =
            reinterpret_cast<const uint4*>(c ? vs : ks) + (size_t)(r * run + pp) * ld_vecs;
        uint4* to = reinterpret_cast<uint4*>(c ? vc : kc) + (size_t)(row0 + r) * row_vecs +
                    (size_t)(p0 + pp) * pos_vecs;
        for (int v = lane; v < pos_vecs; v += 32) to[v] = from[v];
      }

  // 4. the attention over the run's positions, from the stage: a thread per
  //    score (row, head, position); a thread per (row, head) for the max,
  //    the exponentials and their sum; a thread per column for the
  //    weighted V sums of every row
  const int dh = H / nh;
  for (int t = tid; t < k * nh * np; t += NTHREADS) {
    const int item = t / np, p = t - item * np, r = item / nh, hd = item - r * nh;
    const size_t row = row0 + r;
    const T* kr = ks + (size_t)(r * run + p) * ld + hd * dh;
    sc[item * run + p] =
        dot_head<T>(q + row * H + hd * dh, kr, dh) * scale + amask[row * L + p0 + p];
  }
  __syncthreads();
  for (int item = tid; item < k * nh; item += NTHREADS) {
    float* sr = sc + item * run;
    float mx = -INFINITY, l = 0.f;
    for (int p = 0; p < np; ++p) mx = fmaxf(mx, sr[p]);
    for (int p = 0; p < np; ++p) {
      const float e = expf(sr[p] - mx);
      sr[p] = e;
      l += e;
    }
    ml[item] = make_float2(mx, l);
    if (runs > 1) {
      const int r = item / nh;
      pml[((size_t)(row0 + r) * runs + s) * nh + item - r * nh] = make_float2(mx, l);
    }
  }
  __syncthreads();
  for (int c = tid; c < H; c += NTHREADS) {
    const int hd = c / dh;
    for (int r = 0; r < k; ++r) {
      const float* e = sc + (r * nh + hd) * run;
      const T* vr = vs + (size_t)r * run * ld + c;
      float acc = 0.f;
      for (int p = 0; p < np; ++p) acc += e[p] * to_f32(vr[(size_t)p * ld]);
      const size_t row = row0 + r;
      if (runs == 1)
        att[row * H + c] = acc / ml[r * nh + hd].y;
      else
        pacc[(row * runs + s) * H + c] = acc;
    }
  }
  if (runs == 1 || !fuse) return;

  // 5. the instance's last block to finish merges its runs' partials,
  //    whichever block it is (the sums' order is the runs')
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&cnt[inst], 1) == runs - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int item = tid; item < k * nh; item += NTHREADS) {
    const int r = item / nh;
    ml[item] = merge_max_sum(pml + (size_t)(row0 + r) * runs * nh + item - r * nh, runs, nh);
  }
  __syncthreads();
  for (int o = tid; o < k * H; o += NTHREADS) {
    const int r = o / H, c = o - r * H, hd = c / dh;
    const size_t row = row0 + r;
    const float2 tot = ml[r * nh + hd];
    att[row * H + c] =
        merge_sum(pacc + row * runs * H + c, pml + row * runs * nh + hd, runs, nh, H, tot.x) /
        tot.y;
  }
}

// K6's merge as a launch of its own, a thread per (row, column): taken when
// the pass's blocks fit the card at once, where a last block's merge would
// run alone after the others.
__global__ void __launch_bounds__(NTHREADS)
step_merge_kernel(const float* pacc, const float2* pml, float* __restrict__ att, int n, int H,
                  int nh, int runs) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n * H) return;
  const int row = i / H, c = i - row * H;
  const float2* m = pml + (size_t)row * runs * nh + c / (H / nh);
  const float2 tot = merge_max_sum(m, runs, nh);
  att[i] = merge_sum(pacc + (size_t)row * runs * H + c, m, runs, nh, H, tot.x) / tot.y;
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
                   ve + inst * te * H + hd * dh, H, te, dh, scale,
                   att + row * H + hd * dh);
  }
}

bool shape_ok(int k, int H, int nh, int esz) {
  return k >= 1 && k <= MAX_BEAM && nh >= 1 && H % nh == 0 && H / nh <= 32 * MAX_DL &&
         (H * esz) % 16 == 0;
}

// Host: K6's shared memory a block at run length `run`: the staged rows,
// then each (row, head)'s (max, sum) and scores.
template <typename T>
size_t stage_bytes(int k, int H, int nh, int run) {
  return 2 * (size_t)k * run * stage_ld<T>(H) * sizeof(T) + (size_t)k * nh * (8 + 4 * run);
}

template <typename T>
int launch_step(void* kc, void* vc, const void* q, const void* kt, const void* vt,
                const void* prev_k, const void* amask, void* att, void* part, int n, int k, int L,
                int H, int nh, int tpos, float scale, int run, cudaStream_t st) {
  if (run < 1 || run > MAX_RUN) return (int)cudaErrorInvalidValue;
  const int runs = (tpos + run) / run;  // ceil((tpos + 1) / run)
  const size_t smem = stage_bytes<T>(k, H, nh, run);
  if (smem > STAGE_MAX || (runs > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      step_run_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_MAX);
  if (attr != cudaSuccess) return (int)attr;
  float* pacc = static_cast<float*>(part);
  float2* pml = runs > 1 ? reinterpret_cast<float2*>(pacc + (size_t)runs * n * H) : nullptr;
  int* cnt = runs > 1 ? reinterpret_cast<int*>(pml + (size_t)runs * n * nh) : nullptr;
  const long blocks = (long)(n / k) * runs;
  if (blocks > 0x7fffffffL || (long)n * H > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // fuse the merge into the pass when its blocks take more than one wave:
  // the last blocks' merges then overlap the other blocks' work
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, step_run_kernel<T>,
                                                                NTHREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int fuse = runs > 1 && blocks > (long)per_sm * sms;
  step_run_kernel<T><<<(unsigned)blocks, NTHREADS, smem, st>>>(
      static_cast<T*>(kc), static_cast<T*>(vc), static_cast<const float*>(q),
      static_cast<const float*>(kt), static_cast<const float*>(vt),
      static_cast<const int*>(prev_k), static_cast<const float*>(amask),
      static_cast<float*>(att), pacc, pml, cnt, k, L, H, nh, tpos, scale, run, runs, fuse);
  e = cudaGetLastError();
  if (e != cudaSuccess || runs == 1 || fuse) return (int)e;
  step_merge_kernel<<<(n * H + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
      pacc, pml, static_cast<float*>(att), n, H, nh, runs);
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
// run: positions a block owns (<= 32); part, with runs = ceil((tpos + 1) /
// run) > 1: the float32 partials, runs * n * (H + 2 nh), then n / k int32
// counters, zero on entry (null for one run).
NAVC_EXPORT int navc_beam_attend_step(void* kc, void* vc, const void* q, const void* kt,
                                      const void* vt, const void* prev_k, const void* amask,
                                      void* att, void* part, int n, int k, int L, int H, int nh,
                                      int tpos, float scale, int cache_f32, int run,
                                      void* stream) {
  const int esz = cache_f32 ? 4 : 2;
  if (!shape_ok(k, H, nh, esz) || n % k != 0 || tpos < 0 || tpos >= L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cache_f32 ? launch_step<float>(kc, vc, q, kt, vt, prev_k, amask, att, part, n, k, L, H,
                                        nh, tpos, scale, run, st)
                   : launch_step<bf16>(kc, vc, q, kt, vt, prev_k, amask, att, part, n, k, L, H,
                                       nh, tpos, scale, run, st);
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
