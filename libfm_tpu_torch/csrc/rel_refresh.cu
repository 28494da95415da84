// rel_scores and rel_refresh: the relational (BS) engine's block scores and
// the FM forward of cases joined to block rows.
//
// Replace, in libfm_tpu/learners/mcmc_rel_vector.py, `_rel_scores` (one
// relation's per-block-row scores) and `_chunk_pred` with both branches of
// `refresh_A_and_train_metric`, its test-tail `te_chunk` and
// `predict_test` (K12). A case's forward sums its main-table entries and
// its joined rows' scores:
//   rel_scores: per block row b, SC[b] = [qB | sqB | linB] with
//     qB = sum x V[col], sqB = sum x^2 |V[col]|^2, linB = sum x w[col]
//     over b's design entries; the sentinel row nb is 0.
//   rel_refresh: per case c, over its main entries (ids, vals) [L] first
//     and then its rows maps[r, c] of SC (the relations' tables stacked in
//     one), Q = sum_l x_l V[id_l] + sum_r qB_r,
//     pred = 1/2 (|Q|^2 - sum_l x_l^2 |V[id_l]|^2 - sum_r sqB_r)
//            + sum_l x_l w[id_l] + sum_r linB_r + w0.
//     Train mode writes A[c] = [pred - y | Q] and a per-CTA partial of the
//     clipped squared error; its probit mode (classification) instead
//     takes a latent from N(pred, 1) truncated to y's side of 0, drawn
//     from the uniform U[c] or as its expectation (ALS), writes latent[c]
//     and A[c] = [pred - latent | Q], and counts the correct cases
//     (Phi(pred) against y's sign), with common.cuh's device functions
//     (fm_refresh's). Tail mode writes [pred | Q]; test mode the pred.
//
// Bound on the H100: bytes. Train mode writes A ((k+1) * 4 B a case) and
// reads the maps (4 R B), y (4 B), the main entries (8 L B) and in probit
// mode U and the latents (8 B); the score tables (bench_bs: 4,001 x 34
// floats, 0.5 MB) and the main features' rows of P stay in L2. At
// bench_bs's 1M train cases, k = 32: ~140 MB, 0.042 ms at 3.35 TB/s (with
// bench_bs_ctx's two main entries ~156 MB, 0.047 ms). rel_scores is
// latency-bound and small (64,000 entries, once a refresh).
// Design: one warp a block row (rel_scores) or a case (rel_refresh), lanes
// over the factors (up to 4 a lane, k <= 128), the row reads and writes
// coalesced across the warp; a main entry's id and value are one
// broadcast load. rel_scores walks its row's entries in order, as the JAX
// engine's segment sums do. rel_refresh runs a grid of at most `npart`
// CTAs whose warps stride over the cases; lane 0 of each warp sums its
// cases' errors (or correct counts) in order, the CTA its warps in order:
// no atomics, the same bits on every run for a given npart.

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
                       float* __restrict__ A, float* __restrict__ pred_out,
                       float* __restrict__ part, const float* __restrict__ P,
                       const int* __restrict__ ids, const float* __restrict__ vals,
                       const float* __restrict__ U, float* __restrict__ latent,
                       long long nc, int R, int L, int k, int use_linear, int use_bias,
                       float min_t, float max_t, int npart, int probit) {
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
    // the case's main entries first (padding: value 0), then its joined
    // block rows' scores, relation by relation
    float s2 = 0.0f;
    for (int l = 0; l < L; ++l) {
      const float x = vals[c * L + l];
      const float* p = P + (long long)ids[c * L + l] * d;
#pragma unroll
      for (int i = 0; i < kLaneFactors; ++i) {
        const int f = lane + kWarp * i;
        if (f < k) {
          const float vx = __fmul_rn(p[1 + f], x);
          q[i] += vx;
          s2 = fmaf(vx, vx, s2);
        }
      }
      if (use_linear) lin += __fmul_rn(p[0], x);
    }
    if (L > 0) sq = warp_sum(s2);
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
    if (A == nullptr) {  // test mode
      if (lane == 0) pred_out[c] = pred;
      continue;  // warp-uniform: the warp's lanes share c
    }
    float* a = A + c * d;
#pragma unroll
    for (int i = 0; i < kLaneFactors; ++i) {
      const int f = lane + kWarp * i;
      if (f < k) a[1 + f] = q[i];
    }
    if (lane == 0) {
      if (y == nullptr) {  // tail mode
        a[0] = pred;
      } else if (probit) {
        const float yc = y[c];
        const float lat = libfm::probit_latent(pred, yc, probit == 1 ? U[c] : 0.0f,
                                               probit == 1);
        a[0] = __fsub_rn(pred, lat);
        latent[c] = lat;
        err += libfm::probit_correct(pred, yc);
      } else {
        const float yc = y[c];
        a[0] = __fsub_rn(pred, yc);
        const float ec = __fsub_rn(fminf(fmaxf(pred, min_t), max_t), yc);
        err = fmaf(ec, ec, err);
      }
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
// (rows of SC), w0p the device scalar w0. Main rows (L > 0): ids int32 and
// vals [nc, L] (padding: value 0) into P [n, k+1]. Train mode: A [nc, k+1],
// y [nc] and part [npart] given; every entry of part is written (past the
// grid with 0). probit (train mode only): 0 regression, 1 latents drawn
// from U [nc], 2 latents as expectations; latent [nc] required. Tail mode:
// A given, y == part == NULL. Test mode: A == NULL, pred_out [nc] given.
extern "C" int rel_refresh_launch(const float* SC, const int* maps, const float* w0p,
                                  const float* y, float* A, float* pred_out, float* part,
                                  const float* P, const int* ids, const float* vals,
                                  const float* U, float* latent, long long nc, int R, int L,
                                  int k, int use_linear, int use_bias, float min_t,
                                  float max_t, int npart, int probit,
                                  cudaStream_t stream) {
  const bool train = y != nullptr;
  if (k < 1 || k > kMaxK || R < 1 || L < 0 || nc < 1 ||
      train != (part != nullptr) || (train && (A == nullptr || npart < 1)) ||
      (A == nullptr && (pred_out == nullptr || train)) ||
      (L > 0 && (P == nullptr || ids == nullptr || vals == nullptr)) || probit < 0 ||
      probit > 2 || (probit && (!train || latent == nullptr || (probit == 1 && U == nullptr))))
    return (int)cudaErrorInvalidValue;
  const long long ctas = (nc + kWarps - 1) / kWarps;
  const int cap = train ? npart : 65536;
  const unsigned grid = (unsigned)(ctas < cap ? ctas : cap);
  rel_refresh_kernel<<<grid, kThreads, 0, stream>>>(SC, maps, w0p, y, A, pred_out, part, P,
                                                    ids, vals, U, latent, nc, R, L, k,
                                                    use_linear, use_bias, min_t, max_t,
                                                    npart, probit);
  return (int)cudaGetLastError();
}
