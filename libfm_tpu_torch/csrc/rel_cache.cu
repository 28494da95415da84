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
//
// The narrow form, k <= 2 (rel_cache_cols_launch): the exact BS engine's
// per-row sums over [e | q'] (k = 1, 5 sums; libfm_tpu/learners/
// mcmc_relational.py:540-547), 1 + k launches an iteration. On the
// template above a CTA of 256 threads owned those 5 sums, staged the
// cases 32 at a time through shared memory with three barriers a stage,
// and the caller copied the two columns into an [nc, 2] table first: 0.0935
// ms at bench_bs_ctx against 0.0925 for its torch.bmm (H100 80GB HBM3,
// 700 W). Bound: bytes, the case id and two floats a case (12 MB at 1M
// cases, each float a random sector), 0.0036 ms counted as bytes read.
// Here one warp owns a block row, 8 rows a CTA: its lanes stride over the
// row's cases, a lane's loads for kNarrowUnroll cases issued before its
// first sum, its 2 + 2k + k(k+1)/2 sums in registers; a shuffle tree in
// fixed order adds the lanes' sums and lane 0 writes the row. No shared
// memory, no barrier; e and each q column are read where they lie (any
// stride), so the caller copies nothing. It takes 0.0214 ms there, the
// bmm 0.0930 (H100 80GB HBM3, 700 W; chip_smoke.py --exact).

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

constexpr int kNarrowWarps = 8;   // block rows a CTA
constexpr int kNarrowUnroll = 4;  // cases a lane has in flight

struct Cols {
  const float* e;
  long long se;
  const float* q[2];
  long long sq[2];
};

template <int K>
__global__ void __launch_bounds__(kNarrowWarps * 32)
    rel_cache_narrow_kernel(Cols c, const long long* __restrict__ case_off,
                            const int* __restrict__ case_ids, float* __restrict__ C, int nb) {
  constexpr int W = cache_width(K);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kNarrowWarps + threadIdx.x / 32;
  if (b > nb) return;
  float acc[W];
#pragma unroll
  for (int o = 0; o < W; ++o) acc[o] = 0.0f;
  const long long lo = b < nb ? case_off[b] : 0, hi = b < nb ? case_off[b + 1] : 0;
  for (long long c0 = lo + lane; c0 < hi; c0 += 32 * kNarrowUnroll) {
    int id[kNarrowUnroll];
#pragma unroll
    for (int u = 0; u < kNarrowUnroll; ++u) {
      const long long i = c0 + 32 * u;
      id[u] = i < hi ? case_ids[i] : -1;
    }
    float ev[kNarrowUnroll], qv[kNarrowUnroll][K];
#pragma unroll
    for (int u = 0; u < kNarrowUnroll; ++u) {
      const long long r = id[u] < 0 ? 0 : id[u];
      ev[u] = id[u] < 0 ? 0.0f : c.e[r * c.se];
#pragma unroll
      for (int i = 0; i < K; ++i) qv[u][i] = id[u] < 0 ? 0.0f : c.q[i][r * c.sq[i]];
    }
#pragma unroll
    for (int u = 0; u < kNarrowUnroll; ++u) {
      if (id[u] < 0) continue;
      const float e = ev[u];
      acc[0] = __fadd_rn(acc[0], e);
      acc[1] = fmaf(e, e, acc[1]);
      int o = 2 + 2 * K;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        acc[2 + i] = __fadd_rn(acc[2 + i], qv[u][i]);
        acc[2 + K + i] = fmaf(qv[u][i], e, acc[2 + K + i]);
#pragma unroll
        for (int j = i; j < K; ++j, ++o) acc[o] = fmaf(qv[u][i], qv[u][j], acc[o]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < W; ++o) acc[o] = libfm::warp_sum(acc[o]);
  if (lane == 0) {
    float* out = C + (long long)b * W;
#pragma unroll
    for (int o = 0; o < W; ++o) out[o] = acc[o];
  }
}

}  // namespace

// The narrow form, k = 1 or 2: C [nb+1, 2 + 2k + k(k+1)/2] out, the sums
// of u = [1 | e | q0 (| q1)] over each row's cases, each column read at
// its own stride (floats); q1 null for k = 1.
extern "C" int rel_cache_cols_launch(const float* e, long long se, const float* q0,
                                     long long sq0, const float* q1, long long sq1, int k,
                                     const long long* case_off, const int* case_ids, float* C,
                                     int nb, cudaStream_t stream) {
  if (k < 1 || k > 2 || nb < 0 || !e || !q0 || (k == 2 && !q1) || !case_off || !C ||
      (nb > 0 && !case_ids))
    return (int)cudaErrorInvalidValue;
  const Cols c{e, se, {q0, q1}, {sq0, sq1}};
  const unsigned grid = (unsigned)((nb + kNarrowWarps) / kNarrowWarps);  // nb + 1 rows
  constexpr int threads = kNarrowWarps * 32;
  if (k == 1)
    rel_cache_narrow_kernel<1><<<grid, threads, 0, stream>>>(c, case_off, case_ids, C, nb);
  else
    rel_cache_narrow_kernel<2><<<grid, threads, 0, stream>>>(c, case_off, case_ids, C, nb);
  return (int)cudaGetLastError();
}

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
