// rel_cache: the relational (BS) engine's frozen per-block-row caches (K9).
//
// Replaces `build_rel_caches` and its `moments` in
// libfm_tpu/learners/mcmc_rel_vector.py: per block row b, over the train
// cases joined to it (case_ids[case_off[b] .. case_off[b+1]]), the sums of
// the per-case table A = [e | Q]:
//   C[b] = [we0 | we2_0 | SQ0 (k) | SQe0 (k) | SQQ0 (T)]
//   we0 = sum e, we2_0 = sum e^2, SQ0 = sum Q, SQe0 = sum Q e,
//   SQQ0 = sum Q Q^T, its T = k(k+1)/2 upper triangle in np.triu_indices
//   order; the sentinel row nb = 0.
// Every entry is one sum of products u_a u_b over the row's cases, with
// u = [1 | e | Q]: (0,1), (1,1), (0,2+i), (1,2+i), (2+i,2+j).
//
// Bound on the H100: bytes. It reads A's train rows once ((k+1) * 4 B a
// case, 132 MB at bench_bs's 1M cases, k = 32) and writes (nb+1) *
// (2 + 2k + T) floats (9.5 MB there); about 2 * 594 FLOP a case (1.2 GFLOP).
// 0.042 ms at 3.35 TB/s.
// Design: one CTA a block row. Its 256 threads stage 32 of the row's cases
// at a time into shared memory: the case ids first, then the 32 x (k+1)
// floats spread over all threads, each thread's loads issued before its
// stores, so that the random row gathers from A are in flight together (a
// warp copying its rows one after another, each row's load waiting on its
// id's, took 0.2745 ms at bench_bs; this 0.2534, beside a torch.bmm
// yardstick of 0.2569: H100 80GB HBM3, 700 W, chip_smoke.py --bench-bs).
// Each thread owns up to kPer(KP) of the row's 2 + 2k + T sums in
// registers and adds each staged case's product in case order: no
// atomics, every run the same bits. The row's sums are written once. What
// holds it now is shared memory: two reads a multiply-add (~37 warp-wide
// reads a case at k = 32); register tiles of the outer product, as
// slot_stats has, would cut them.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 32;  // cases staged at a time

__host__ __device__ constexpr int cache_width(int k) { return 2 + 2 * k + k * (k + 1) / 2; }

// The (a, b) columns of u = [1 | e | Q] whose product sums into entry o.
__device__ __forceinline__ void cache_pair(int o, int k, int* a, int* b) {
  if (o < 2) {
    *a = o;
    *b = 1;
  } else if (o < 2 + k) {
    *a = 0;
    *b = o;
  } else if (o < 2 + 2 * k) {
    *a = 1;
    *b = o - k;
  } else {
    int t = o - 2 - 2 * k, i = 0;
    while (t >= k - i) {
      t -= k - i;
      ++i;
    }
    *a = 2 + i;
    *b = 2 + i + t;
  }
}

template <int KP>
__global__ void __launch_bounds__(kThreads)
    rel_cache_kernel(const float* __restrict__ A, const long long* __restrict__ case_off,
                     const int* __restrict__ case_ids, float* __restrict__ C, int nb, int k) {
  constexpr int kPer = (cache_width(KP) + kThreads - 1) / kThreads;
  constexpr int kRow = KP + 2;  // u's staged width
  constexpr int kLoads = (kStage * (KP + 1) + kThreads - 1) / kThreads;
  __shared__ float u[kStage][kRow];
  __shared__ int ids[kStage];
  const int b = blockIdx.x;
  const int cw = cache_width(k);
  const int d = k + 1;
  float* out = C + (long long)b * cw;
  if (b == nb) {
    for (int o = threadIdx.x; o < cw; o += kThreads) out[o] = 0.0f;
    return;
  }
  int pa[kPer], pb[kPer];
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    acc[j] = 0.0f;
    const int o = threadIdx.x + j * kThreads;
    if (o < cw) {
      cache_pair(o, k, &pa[j], &pb[j]);
    } else {
      pa[j] = pb[j] = 0;
    }
  }
  const long long lo = case_off[b], hi = case_off[b + 1];
  for (long long c0 = lo; c0 < hi; c0 += kStage) {
    const int n = (int)(hi - c0 < kStage ? hi - c0 : kStage);
    __syncthreads();  // the previous stage is read
    if (threadIdx.x < n) {
      ids[threadIdx.x] = case_ids[c0 + threadIdx.x];
      u[threadIdx.x][0] = 1.0f;
    }
    __syncthreads();
    // the stage's n x d floats: each thread issues all its loads before its
    // first store, so the gathers are in flight together
    float v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = threadIdx.x + q * kThreads, r = i / d;
      v[q] = i < n * d ? A[(long long)ids[r] * d + (i - r * d)] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = threadIdx.x + q * kThreads, r = i / d;
      if (i < n * d) u[r][1 + i - r * d] = v[q];
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = fmaf(u[r][pa[j]], u[r][pb[j]], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int o = threadIdx.x + j * kThreads;
    if (o < cw) out[o] = acc[j];
  }
}

}  // namespace

// C [nb+1, 2 + 2k + k(k+1)/2] out; A [nc, k+1]; case_off int64 [nb+1],
// case_ids int32; kp = the padded width (16, 32, 64 or 128) holding k.
extern "C" int rel_cache_launch(const float* A, const long long* case_off,
                                const int* case_ids, float* C, int nb, int k, int kp,
                                cudaStream_t stream) {
  if (!libfm::valid_padded_width(kp, k) || nb < 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)nb + 1;
#define REL_CACHE_LAUNCH(KP) \
  rel_cache_kernel<KP><<<grid, kThreads, 0, stream>>>(A, case_off, case_ids, C, nb, k)
  switch (kp) {
    case 16: REL_CACHE_LAUNCH(16); break;
    case 32: REL_CACHE_LAUNCH(32); break;
    case 64: REL_CACHE_LAUNCH(64); break;
    default: REL_CACHE_LAUNCH(128); break;
  }
#undef REL_CACHE_LAUNCH
  return (int)cudaGetLastError();
}
