// rel_scores and rel_refresh: the relational (BS) engine's block scores and
// the FM forward of cases joined to block rows.
//
// Replace, in libfm_tpu/learners/mcmc_rel_vector.py, `_rel_scores` (one
// relation's per-block-row scores) and `_chunk_pred` with the regression
// branch of `refresh_A_and_train_metric`, its test-tail `te_chunk` and
// `predict_test` (K12, the relation half). With an empty main table a
// case's forward is a sum over its joined rows:
//   rel_scores: per block row b, SC[b] = [qB | sqB | linB] with
//     qB = sum x V[col], sqB = sum x^2 |V[col]|^2, linB = sum x w[col]
//     over b's design entries; the sentinel row nb is 0.
//   rel_refresh: per case c, Q = sum_r qB_r, pred = 1/2 (|Q|^2 - sum_r sqB_r)
//     + sum_r linB_r + w0, reading SC at maps[r, c] (the relations' tables
//     stacked in one). Train mode writes A[c] = [pred - y | Q] and a per-CTA
//     partial of the clipped squared error; tail mode writes [pred | Q].
//
// Bound on the H100: bytes. rel_refresh writes A ((k+1) * 4 B a case) and
// reads the maps (4 R B) and y (4 B); the score tables (bench_bs: 4,001 x
// 34 floats, 0.5 MB) stay in L2. At bench_bs's 1M train cases, k = 32:
// ~140 MB, 0.042 ms at 3.35 TB/s. rel_scores is latency-bound and small
// (64,000 entries, once a refresh).
// Design: one warp a block row (rel_scores) or a case (rel_refresh), lanes
// over the factors (up to 4 a lane, k <= 128), the row reads and writes
// coalesced across the warp. rel_scores walks its row's entries in order,
// as the JAX engine's segment sums do. rel_refresh runs a grid of at most
// `npart` CTAs whose warps stride over the cases; each warp sums its cases'
// errors in order, the CTA its warps in order: no atomics, the same bits on
// every run for a given npart.

#include "common.cuh"

namespace {

using libfm::kMaxK;
using libfm::kWarp;
using libfm::warp_sum;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kLaneFactors = kMaxK / kWarp;  // 4

__global__ void __launch_bounds__(kThreads)
    rel_scores_kernel(const float* __restrict__ P, const long long* __restrict__ indptr,
                      const int* __restrict__ cols, const float* __restrict__ vals,
                      float* __restrict__ SC, int nb, int k, int use_linear) {
  const int row = (int)((blockIdx.x * (long long)kThreads + threadIdx.x) / kWarp);
  const int lane = threadIdx.x & (kWarp - 1);
  if (row > nb) return;
  const int d = k + 1;
  float q[kLaneFactors] = {0.0f, 0.0f, 0.0f, 0.0f};
  float sq = 0.0f, lin = 0.0f;
  if (row < nb) {
    for (long long e = indptr[row]; e < indptr[row + 1]; ++e) {
      const float x = vals[e];
      const float* p = P + (long long)cols[e] * d;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kLaneFactors; ++i) {
        const int f = lane + kWarp * i;
        if (f < k) {
          const float vx = __fmul_rn(p[1 + f], x);
          q[i] += vx;
          s = fmaf(vx, vx, s);
        }
      }
      sq += warp_sum(s);
      if (use_linear) lin += __fmul_rn(p[0], x);
    }
  }
  float* out = SC + (long long)row * (k + 2);
#pragma unroll
  for (int i = 0; i < kLaneFactors; ++i) {
    const int f = lane + kWarp * i;
    if (f < k) out[f] = q[i];
  }
  if (lane == 0) {
    out[k] = sq;
    out[k + 1] = use_linear ? lin : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    rel_refresh_kernel(const float* __restrict__ SC, const int* __restrict__ maps,
                       const float* __restrict__ w0p, const float* __restrict__ y,
                       float* __restrict__ A, float* __restrict__ part, long long nc, int R,
                       int k, int use_linear, int use_bias, float min_t, float max_t,
                       int npart) {
  __shared__ float warp_err[kWarps];
  const int lane = threadIdx.x & (kWarp - 1);
  const int wid = threadIdx.x / kWarp;
  const long long nwarps = (long long)gridDim.x * kWarps;
  const int d = k + 1, w = k + 2;
  const float w0 = use_bias ? *w0p : 0.0f;
  float err = 0.0f;
  for (long long c = (long long)blockIdx.x * kWarps + wid; c < nc; c += nwarps) {
    float q[kLaneFactors] = {0.0f, 0.0f, 0.0f, 0.0f};
    float sq = 0.0f, lin = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float* s = SC + (long long)maps[(long long)r * nc + c] * w;
#pragma unroll
      for (int i = 0; i < kLaneFactors; ++i) {
        const int f = lane + kWarp * i;
        if (f < k) q[i] += s[f];
      }
      sq += s[k];
      lin += s[k + 1];
    }
    float qq = 0.0f;
#pragma unroll
    for (int i = 0; i < kLaneFactors; ++i) qq = fmaf(q[i], q[i], qq);
    qq = warp_sum(qq);
    float pred = __fmul_rn(0.5f, __fsub_rn(qq, sq));
    if (use_linear) pred = __fadd_rn(pred, lin);
    if (use_bias) pred = __fadd_rn(pred, w0);
    float* a = A + c * d;
#pragma unroll
    for (int i = 0; i < kLaneFactors; ++i) {
      const int f = lane + kWarp * i;
      if (f < k) a[1 + f] = q[i];
    }
    if (y != nullptr) {
      const float yc = y[c];
      if (lane == 0) a[0] = __fsub_rn(pred, yc);
      const float ec = __fsub_rn(fminf(fmaxf(pred, min_t), max_t), yc);
      err = fmaf(ec, ec, err);
    } else if (lane == 0) {
      a[0] = pred;
    }
  }
  if (part == nullptr) return;
  if (lane == 0) warp_err[wid] = err;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += warp_err[i];
    part[blockIdx.x] = s;
    for (int i = gridDim.x + blockIdx.x; i < npart; i += gridDim.x) part[i] = 0.0f;
  }
}

}  // namespace

// SC [nb+1, k+2] out; indptr int64 [nb+1], cols int32 (global feature ids
// into P [n, k+1]), vals.
extern "C" int rel_scores_launch(const float* P, const long long* indptr, const int* cols,
                                 const float* vals, float* SC, int nb, int k,
                                 int use_linear, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || nb < 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)nb + 1;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  rel_scores_kernel<<<grid, kThreads, 0, stream>>>(P, indptr, cols, vals, SC, nb, k,
                                                   use_linear);
  return (int)cudaGetLastError();
}

// SC [rows, k+2] (the relations' score tables stacked), maps int32 [R, nc]
// (rows of SC), w0p the device scalar w0, A [nc, k+1] out. Train mode: y
// [nc] and part [npart] given; every entry of part is written (past the
// grid with 0). Tail mode: y == part == NULL.
extern "C" int rel_refresh_launch(const float* SC, const int* maps, const float* w0p,
                                  const float* y, float* A, float* part, long long nc,
                                  int R, int k, int use_linear, int use_bias, float min_t,
                                  float max_t, int npart, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || R < 1 || nc < 1 || (y != nullptr) != (part != nullptr) ||
      (part != nullptr && npart < 1))
    return (int)cudaErrorInvalidValue;
  const long long ctas = (nc + kWarps - 1) / kWarps;
  const int cap = part != nullptr ? npart : 65536;
  const unsigned grid = (unsigned)(ctas < cap ? ctas : cap);
  rel_refresh_kernel<<<grid, kThreads, 0, stream>>>(SC, maps, w0p, y, A, part, nc, R, k,
                                                    use_linear, use_bias, min_t, max_t,
                                                    npart);
  return (int)cudaGetLastError();
}
