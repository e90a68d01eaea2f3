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
// K7, one call per beam step: the mask-free attention of each beam row over
// its instance's Te encoder positions. The k beams of an instance share its
// encoder K/V, so the kernel reads the per-instance (b, Te, H) tensors; the
// JAX wrapper's per-decode expansion to b*k rows is not needed.
//
// What bounds it on the H100: bytes. It reads q (n, H) float32 and the
// per-instance K/V and writes att (n, H) float32: at the B=1024 decode's
// 5120 rows (Te 16, H 512, bf16 K/V) 54.5 MB, 0.016 ms at 3.35 TB/s, against
// 84 MFLOP, 0.0013 ms at the float32 rate. In the earlier design a block
// owned a beam row and a warp a head, walking the positions one by one
// through an online softmax (a shuffle reduction and two expf a position):
// the loads were serialised behind that chain, and the k blocks of an
// instance each read its K/V again through L2.
//
// Design: a block per (instance, group of g heads), g planned on the host
// (navc_tpu_torch/ops/beam_attend.py cross_groups) from the instances, k,
// Te, H, the heads and the SM count. The block stages its instance's Te x
// g*dh slice of K and its k query rows' g*dh float32 columns, then the V
// slice, in shared memory with 16-byte cp.async copies, all in flight at
// once, V landing while the scores are computed (position rows padded by
// 16 bytes, so that threads reading different positions hit different
// banks): each instance's K/V leaves device memory once. From the stage:
// the scores, float32 dot products of dh; each (row, head)'s softmax over
// the positions; the weighted V sums over the positions in order, divided
// by the sum. Two thread layouts, planned on the host with g. Where the
// grid gives each SM several blocks (the card's throughput sets the time),
// or where the group is wide enough that its column pairs fill a block: a
// thread per (head, position) scores all k rows, a thread per (row, head)
// takes the softmax and a thread per pair of columns sums all k rows, each
// K and V element and each exponential read once for all the rows (a
// thread per (row, column) spends most of the time reading shared memory
// there). Else a block's latency sets it: a group of lanes per (row, head)
// scores its positions and takes their max and sum by shuffles, and a
// thread per (row, column) sums, as many threads as a block's short phases
// can use. No atomics: two calls
// give the same bits. The tensor cores would not help: at ~1.5 FLOP a byte
// the products are far below the ~295 at which bf16 wgmma binds, and a
// bf16 q would drop the float32 q.K that the TPU kernel keeps with its
// segment passes.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_BEAM = 32;         // rows of one instance (k)
constexpr int MAX_DH = 128;          // head width, at most
constexpr int CROSS_R = 8;           // K7 rows a thread's sums cover at once
constexpr int MAX_RUN = 32;          // K6 positions a block owns, at most
constexpr int STAGE_MAX = 192 * 1024;  // K6 / K7 shared memory a block, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

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

// Close this thread's group of cp.async copies; wait until at most N of its
// groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The even (low half) and odd (high half) bf16 of a 32-bit pair as floats.
__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// One staged position row: H elements and 16 bytes of padding.
template <typename T>
__host__ __device__ inline int stage_ld(int H) { return H + 16 / (int)sizeof(T); }

// 16 bytes of staged T (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float (&out)[16 / sizeof(T)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  } else {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = bf_lo(w[i]);
      out[2 * i + 1] = bf_hi(w[i]);
    }
  }
}

// The max and the sum of v over an aligned group of P lanes (P a power of
// two, at most 32); every lane of the warp must call it.
__device__ __forceinline__ float group_max(float v, int P) {
  for (int o = P / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int P) {
  for (int o = P / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 2 staged T (4 or 8 bytes, aligned) as floats.
template <typename T>
__device__ __forceinline__ void load2(const T* src, float (&out)[2]) {
  if constexpr (sizeof(T) == 4) {
    const float2 u = *reinterpret_cast<const float2*>(src);
    out[0] = u.x;
    out[1] = u.y;
  } else {
    const unsigned u = *reinterpret_cast<const unsigned*>(src);
    out[0] = bf_lo(u);
    out[1] = bf_hi(u);
  }
}

// K7's output of row r at column c (head hd) of the group: the exponentials
// ex (head-major, [te][kp] a head, hs floats apart) times the staged V
// column over the positions in order, over the (row, head)'s sum.
template <typename T>
__device__ __forceinline__ float weighted_v(const float* ex, const T* vs, const float* sum, int hd,
                                            int r, int c, int te, int kp, int hs, int ldk,
                                            int g) {
  const float* e = ex + hd * hs + r;
  float acc = 0.f;
  for (int p = 0; p < te; ++p) acc += e[p * kp] * to_f32(vs[p * ldk + c]);
  return acc / sum[r * g + hd];
}

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

// K7. Block inst * (nh / g) + gi owns instance inst's k rows and heads [gi
// g, (gi + 1) g): the gw = g dh columns from c0 = gi gw. Shared memory: the
// staged K rows [te][gw + pad], the V rows, the query rows [k][gw + 4]
// (float32), the exponentials [g][te][kp] + 4 floats a head (kp = k rounded
// up to 4: a position's rows are float4s; the 4 keep the heads' rows on
// different banks), each (row, head)'s sum [k][g]. q, att (n, H) float32;
// ke, ve (n / k, te, H). `reuse`: a thread per (head, position) scores all
// k rows and a thread per pair of columns sums them, so each K and V
// element and each exponential is read once for every row; else a group of
// lanes per (row, head) and a thread per (row, column), the most threads a
// block's short phases can use.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
cross_kernel(const float* __restrict__ q, const T* __restrict__ ke, const T* __restrict__ ve,
             float* __restrict__ att, int k, int te, int H, int nh, int g, float scale,
             int reuse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, groups = nh / g;
  const int inst = blockIdx.x / groups, gi = blockIdx.x - inst * groups;
  const int dh = H / nh, gw = g * dh, c0 = gi * gw, row0 = inst * k;
  const int ldk = stage_ld<T>(gw), ldq = gw + 4, kp = (k + 3) / 4 * 4, hs = te * kp + 4;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)te * ldk;
  float* qs = reinterpret_cast<float*>(vs + (size_t)te * ldk);
  float* ex = qs + (size_t)k * ldq;
  float* sum = ex + (size_t)g * hs;

  // 1. stage K and the query columns, then V, which lands while the scores
  //    are computed: 16-byte vectors, a position's (a row's) on neighbouring
  //    threads; vector i of a K/V slice is at stage_at(i) in the stage and
  //    src_at(i) in the instance's (te, H) rows
  constexpr int EV = 16 / (int)sizeof(T);  // elements a vector
  const int kv_vecs = gw / EV, q_vecs = gw / 4;
  auto stage_at = [=](int i) { return (i / kv_vecs) * ldk + (i % kv_vecs) * EV; };
  auto src_at = [=](int i) {
    const int p = i / kv_vecs, e = (i - p * kv_vecs) * EV;
    return (size_t)p * H + c0 + e;
  };
  const T* kin = ke + (size_t)inst * te * H;
  const T* vin = ve + (size_t)inst * te * H;
  for (int i = tid; i < te * kv_vecs; i += nt) cp_async16(ks + stage_at(i), kin + src_at(i));
  for (int i = tid; i < k * q_vecs; i += nt) {
    const int r = i / q_vecs, e = (i - r * q_vecs) * 4;
    cp_async16(qs + r * ldq + e, q + (size_t)(row0 + r) * H + c0 + e);
  }
  cp_async_commit();
  for (int i = tid; i < te * kv_vecs; i += nt) cp_async16(vs + stage_at(i), vin + src_at(i));
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 2. the scores q . K[p] * scale and their softmax: the exponentials
  //    into ex, each (row, head)'s sum into sum
  if (reuse) {
    // a thread per (head, position) scores CROSS_R rows at a time
    const bool vec = (dh * (int)sizeof(T)) % 16 == 0;  // head slices of whole vectors
    for (int t = tid; t < g * te; t += nt) {
      const int hd = t / te, p = t - hd * te;
      const T* kr = ks + p * ldk + hd * dh;
      for (int r0 = 0; r0 < k; r0 += CROSS_R) {
        const float* qr = qs + (size_t)r0 * ldq + hd * dh;
        float acc[CROSS_R];
#pragma unroll
        for (int j = 0; j < CROSS_R; ++j) acc[j] = 0.f;
        if (vec) {
          for (int d = 0; d < dh; d += EV) {
            float kv[EV];
            load_vec<T>(kr + d, kv);
#pragma unroll
            for (int j = 0; j < CROSS_R; ++j) {
              if (r0 + j < k) {
                const float* qj = qr + j * ldq + d;
#pragma unroll
                for (int e = 0; e < EV; e += 4) {
                  const float4 qa = *reinterpret_cast<const float4*>(qj + e);
                  acc[j] += qa.x * kv[e] + qa.y * kv[e + 1] + qa.z * kv[e + 2] + qa.w * kv[e + 3];
                }
              }
            }
          }
        } else {
          for (int d = 0; d < dh; ++d) {
            const float kv = to_f32(kr[d]);
#pragma unroll
            for (int j = 0; j < CROSS_R; ++j)
              if (r0 + j < k) acc[j] += qr[j * ldq + d] * kv;
          }
        }
#pragma unroll
        for (int j = 0; j < CROSS_R; ++j)
          if (r0 + j < k) ex[hd * hs + p * kp + r0 + j] = acc[j] * scale;
      }
    }
    __syncthreads();
    // a thread per (row, head): the max, the exponentials, their sum, over
    // the positions in order (fewer instructions than a group of lanes
    // each, which is what counts here)
    for (int item = tid; item < k * g; item += nt) {
      const int hd = item / k, r = item - hd * k;
      float* sr = ex + hd * hs + r;
      float mx = -INFINITY, l = 0.f;
      for (int p = 0; p < te; ++p) mx = fmaxf(mx, sr[p * kp]);
      for (int p = 0; p < te; ++p) {
        sr[p * kp] = expf(sr[p * kp] - mx);
        l += sr[p * kp];
      }
      sum[r * g + hd] = l;
    }
  } else {
    // a group of P lanes (te rounded up to a power of two, at most 32) per
    // (row, head), lane j taking positions j, j + P, ...: each lane keeps
    // its scores' max and then sum of exponentials, the group's by
    // shuffles (every lane of a warp runs them: the count is rounded up to
    // 32), with no pass of a thread walking all the positions
    int P = 1;
    while (P < te && P < 32) P *= 2;
    for (int t = tid; t < (k * g * P + 31) / 32 * 32; t += nt) {
      const int item = t / P, lane = t - item * P, hd = item / k, r = item - hd * k;
      const bool live = item < k * g;
      float* er = ex + hd * hs + r;
      float mx = -INFINITY, l = 0.f;
      for (int p = lane; live && p < te; p += P) {
        const float x = dot_head<T>(qs + r * ldq + hd * dh, ks + p * ldk + hd * dh, dh) * scale;
        er[p * kp] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx, P);
      for (int p = lane; live && p < te; p += P) {
        const float x = expf(er[p * kp] - mx);
        er[p * kp] = x;
        l += x;
      }
      l = group_sum(l, P);
      if (live && lane == 0) sum[r * g + hd] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // 3. the weighted V sums over the positions in order, over the sum
  if (reuse) {  // a thread per pair of columns, CROSS_R rows at a time
    for (int c = 2 * tid; c < gw; c += 2 * nt) {
      const int hd = c / dh;
      if (hd != (c + 1) / dh) {  // the pair straddles two heads: one by one
        for (int cc = c; cc < c + 2; ++cc)
          for (int r = 0; r < k; ++r)
            att[(size_t)(row0 + r) * H + c0 + cc] =
                weighted_v(ex, vs, sum, cc / dh, r, cc, te, kp, hs, ldk, g);
        continue;
      }
      for (int r0 = 0; r0 < k; r0 += CROSS_R) {
        const float* er = ex + hd * hs + r0;
        float acc[CROSS_R][2];
#pragma unroll
        for (int j = 0; j < CROSS_R; ++j) acc[j][0] = acc[j][1] = 0.f;
        for (int p = 0; p < te; ++p) {
          float v[2];
          load2<T>(vs + p * ldk + c, v);
#pragma unroll
          for (int j = 0; j < CROSS_R; j += 4) {
            if (r0 + j < k) {
              const float4 e = *reinterpret_cast<const float4*>(er + p * kp + j);
              const float ej[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                acc[j + jj][0] += ej[jj] * v[0];
                acc[j + jj][1] += ej[jj] * v[1];
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < CROSS_R; ++j) {
          if (r0 + j < k) {
            const float s = sum[(r0 + j) * g + hd];
            *reinterpret_cast<float2*>(att + (size_t)(row0 + r0 + j) * H + c0 + c) =
                make_float2(acc[j][0] / s, acc[j][1] / s);
          }
        }
      }
    }
  } else {  // a thread per (row, column)
    for (int o = tid; o < k * gw; o += nt) {
      const int r = o / gw, c = o - r * gw;
      att[(size_t)(row0 + r) * H + c0 + c] =
          weighted_v(ex, vs, sum, c / dh, r, c, te, kp, hs, ldk, g);
    }
  }
}

bool shape_ok(int k, int H, int nh, int esz) {
  return k >= 1 && k <= MAX_BEAM && nh >= 1 && H % nh == 0 && H / nh <= MAX_DH &&
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

// Host: K7's shared memory a block with heads in groups of g (as
// ops/beam_attend.py cross_stage_bytes).
template <typename T>
size_t cross_bytes(int k, int te, int H, int nh, int g) {
  const int gw = g * (H / nh), kp = (k + 3) / 4 * 4;
  return 2 * (size_t)te * stage_ld<T>(gw) * sizeof(T) + (size_t)k * (gw + 4) * 4 +
         (size_t)g * (te * kp + 4) * 4 + (size_t)k * g * 4;
}

template <typename T>
int launch_cross(const void* q, const void* ke, const void* ve, void* att, int n, int k, int te,
                 int H, int nh, int g, int reuse, float scale, cudaStream_t st) {
  const size_t smem = cross_bytes<T>(k, te, H, nh, g);
  const long blocks = (long)(n / k) * (nh / g);
  if (g < 1 || nh % g != 0 || (g * (H / nh) * (int)sizeof(T)) % 16 != 0 || smem > STAGE_MAX ||
      blocks > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      cross_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_MAX);
  if (attr != cudaSuccess) return (int)attr;
  // threads for the layout's widest phase, fewer where the group is narrow
  const int gw = g * (H / nh);
  const int want = reuse ? max(gw / 2, g * te) : k * max(gw, g * te);
  const int threads = min(NTHREADS, max(64, (want + 31) / 32 * 32));
  cross_kernel<T><<<(unsigned)blocks, threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(ke), static_cast<const T*>(ve),
      static_cast<float*>(att), k, te, H, nh, g, scale, reuse);
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
// f32. groups: heads a block owns (divides nh; g dh elements a multiple of
// 16 bytes); reuse: the thread layout (both planned by
// navc_tpu_torch/ops/beam_attend.py cross_groups).
NAVC_EXPORT int navc_cross_attend(const void* q, const void* ke, const void* ve, void* att, int n,
                                  int k, int te, int H, int nh, float scale, int kv_f32,
                                  int groups, int reuse, void* stream) {
  const int esz = kv_f32 ? 4 : 2;
  if (!shape_ok(k, H, nh, esz) || n % k != 0 || te < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_f32 ? launch_cross<float>(q, ke, ve, att, n, k, te, H, nh, groups, reuse != 0,
                                     scale, st)
                : launch_cross<bf16>(q, ke, ve, att, n, k, te, H, nh, groups, reuse != 0, scale,
                                     st);
}
