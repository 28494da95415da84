// sgda_lambda: one lambda step of SGDA on a validation batch: the
// look-ahead prediction and one gradient step on the per-group
// regularizers reg_w [G] and reg_v [G, k], clamped at 0, in place.
//
// Replaces K13's lambda_step, libfm_tpu/learners/sgda.py:109-173 (libFM
// fm_learn_sgd_element_adapt_reg.h:171-248). With the packed table
// P = [w | V] and the gradient caches Gc = [grad_w | grad_v] of the last
// theta step, for each entry (b, l) of id i, group g = attr_group[i] and
// value x:
//   w' = w - lr (gw + 2 reg_w[g] w),  v' = v - lr (gv + 2 reg_v[g] v)
//   pred = w0 + sum_l w' x + 1/2 (|sum_l v' x|^2 - sum_l |v' x|^2)
//          (w0 is not looked ahead)
//   gl   = SGDA's multiplier of pred (0 on padded rows)
//   S_w[g]    += gl x w                      (lam_w, :139-156)
//   S_v[g, f] += gl (v x) (sum_l v' x - v' x)_f  (sum_f_g, sum_fdf_g, :157-170)
//   reg_w[g] <- max(reg_w[g] - lr (-2 lr S_w[g]), 0)      (with a linear term)
//   reg_v[g] <- max(reg_v[g] - lr (-2 lr S_v[g]), 0)
// In "pair" and "onehot" modes the values are not read: x is the row mask.
//
// The reduction to G x (1+k) is taken in a fixed order with no
// floating-point atomics: each warp adds its rows' terms into its own
// shared-memory copy of S (the lane groups of a warp in turn, each lane
// on its own columns, the entries in order); the CTA adds its warps' copies
// in warp order into its partial; the CTA that finishes last (a ticket
// after a fence) adds the partials in CTA order, updates the
// regularizers (every CTA read them before its ticket) and zeroes the
// ticket. The copies take kWarps * G * (1+k) floats of shared memory, so
// one call takes G * (1+k) <= kMaxGD = 7,168 (7,168 * 8 * 4 = 229,376 B of
// the 232,448 a CTA may have): k = 128 with G <= 55, k = 16 with G <= 421.
//
// Bound on the H100: bytes. A call reads the batch (ids, vals in general
// mode, y, mask), each touched row of P and of Gc and its group id, and
// reads and writes the regularizers: at configs #1 and #4b 1.5-5 MB a
// validation batch, 0.5-1.5 us at 3.35 TB/s. It is bound by latency: the
// launch, each row's chain of gathers and sums, and the last CTA's sums
// over the partials.
// Design (a first version, simple): lane groups of G lanes (8 for k <= 8,
// 16 for k <= 16, else 32) take one row each, NPL factors a lane and the
// w column on lane 0; each row is read twice (the prediction, then the
// terms). At most two CTAs an SM, so that the last CTA's sums over the
// partials stay short. Element offsets are int64.

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kMaxK;
using libfm::kWarp;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxGD = 7168;   // G * (1+k) one call takes
constexpr int kMaxCtas = 264;  // CTA partials the scratch holds
constexpr int kPair = 0, kGeneral = 2;  // the modes; "onehot" is 1

template <int G, int NPL>
__global__ void __launch_bounds__(kThreads)
sgda_lambda_kernel(const float* __restrict__ P, const float* __restrict__ Gc,
                   const int* __restrict__ ids, const float* __restrict__ vals,
                   const float* __restrict__ y, const unsigned char* __restrict__ row_mask,
                   const int* __restrict__ attr_group, float* reg_w, float* reg_v,
                   const float* __restrict__ w0p, float* __restrict__ part,
                   int* __restrict__ ticket, int B, int L, int k, int ng, int mode, int task,
                   int use_linear, int use_bias, float lr, float min_t, float max_t) {
  constexpr int kGroups = kWarp / G;
  extern __shared__ float acc[];  // [kWarps][ng * d]
  __shared__ int s_last;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane / G;
  const int gl = lane % G;
  const int d = k + 1;
  const int gd = ng * d;
  const bool ones = mode != kGeneral;
  float* S = acc + (long long)warp * gd;
  for (int j = threadIdx.x; j < kWarps * gd; j += kThreads) acc[j] = 0.0f;
  __syncthreads();
  const float w0 = use_bias ? *w0p : 0.0f;
  const long long stride = (long long)gridDim.x * kWarps * kGroups;

  // the warp's rows rb + grp; the loop is uniform over the warp (group
  // sums, and the lane groups' turns at S)
  for (long long rb = ((long long)blockIdx.x * kWarps + warp) * kGroups; rb < B;
       rb += stride) {
    const long long row = rb + grp;
    const bool live = row < B;
    const float m = live && row_mask[row] ? 1.0f : 0.0f;
    const float yv = live ? y[row] : 0.0f;
    // the look-ahead prediction
    float sfd[NPL], sq = 0.0f, wx = 0.0f;
#pragma unroll
    for (int t = 0; t < NPL; ++t) sfd[t] = 0.0f;
    for (int l = 0; l < L; ++l) {
      const long long e = row * L + l;
      const int id = live ? ids[e] : 0;
      const float x = ones ? m : (live ? vals[e] : 0.0f);
      const int gi = attr_group[id];
      const float* p = P + (long long)id * d;
      const float* q = Gc + (long long)id * d;
      if (gl == 0 && use_linear) {
        const float w = p[0];
        wx += (w - lr * (q[0] + 2.0f * reg_w[gi] * w)) * x;
      }
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int f = gl + G * t;
        if (f < k) {
          const float v = p[1 + f];
          const float vx = (v - lr * (q[1 + f] + 2.0f * reg_v[(long long)gi * k + f] * v)) * x;
          sfd[t] += vx;
          sq += vx * vx;
        }
      }
    }
    float qq = -sq;
#pragma unroll
    for (int t = 0; t < NPL; ++t) qq += sfd[t] * sfd[t];
    float pred = 0.5f * libfm::lane_group_sum<G>(qq);
    const float wsum = __shfl_sync(kFullMask, wx, grp * G);
    if (use_linear) pred += wsum;
    if (use_bias) pred += w0;
    const float gloss =
        m != 0.0f ? libfm::sgda_multiplier(pred, yv, task, min_t, max_t) : 0.0f;

    // the terms, added to the warp's S by one lane group after another
    for (int l = 0; l < L; ++l) {
      const long long e = row * L + l;
      const int id = live ? ids[e] : 0;
      const float x = ones ? m : (live ? vals[e] : 0.0f);
      const int gi = attr_group[id];
      const float* p = P + (long long)id * d;
      const float* q = Gc + (long long)id * d;
      const float cw = gl == 0 && use_linear ? gloss * (x * p[0]) : 0.0f;
      float cv[NPL];
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int f = gl + G * t;
        cv[t] = 0.0f;
        if (f < k) {
          const float v = p[1 + f];
          const float vx = v * x;
          const float vdx = (v - lr * (q[1 + f] + 2.0f * reg_v[(long long)gi * k + f] * v)) * x;
          cv[t] = gloss * (vx * (sfd[t] - vdx));
        }
      }
      float* s = S + (long long)gi * d;
#pragma unroll
      for (int turn = 0; turn < kGroups; ++turn) {
        if (turn == grp && live) {
          if (gl == 0 && use_linear) s[0] += cw;
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const int f = gl + G * t;
            if (f < k) s[1 + f] += cv[t];
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // this CTA's partial: the warps' copies in warp order
  for (int j = threadIdx.x; j < gd; j += kThreads) {
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) a += acc[(long long)w * gd + j];
    part[(long long)blockIdx.x * gd + j] = a;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last CTA: the partials in CTA order, eight running sums a column
  // (partial c into sum c % 8) added in order at the end
  __threadfence();
  const int nparts = (int)gridDim.x;
  for (int j = threadIdx.x; j < gd; j += kThreads) {
    float a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = 0.0f;
    for (int c = 0; c < nparts; c += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c + u < nparts) a[u] += __ldcg(part + (long long)(c + u) * gd + j);
    }
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) s += a[u];
    const int g = j / d, col = j % d;
    if (col == 0) {
      if (use_linear) reg_w[g] = fmaxf(reg_w[g] - lr * (-2.0f * lr * s), 0.0f);
    } else {
      float* r = reg_v + (long long)g * k + (col - 1);
      *r = fmaxf(*r - lr * (-2.0f * lr * s), 0.0f);
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int G, int NPL>
int launch(const float* P, const float* Gc, const int* ids, const float* vals,
           const float* y, const unsigned char* row_mask, const int* attr_group,
           float* reg_w, float* reg_v, const float* w0p, float* scratch, int B, int L, int k,
           int ng, int mode, int task, int use_linear, int use_bias, float lr, float min_t,
           float max_t, cudaStream_t stream) {
  constexpr auto kernel = sgda_lambda_kernel<G, NPL>;
  constexpr int kRows = kWarps * (kWarp / G);  // a CTA's rows at once
  constexpr int kDevices = 64;
  static bool opted[kDevices];
  const int gd = ng * (k + 1);
  const size_t smem = (size_t)kWarps * gd * sizeof(float);
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {  // the largest area any call asks for, once a device
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kWarps * kMaxGD * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  if ((err = libfm::device_sms(&sms)) != cudaSuccess) return (int)err;
  long long grid = ((long long)B + kRows - 1) / kRows;
  if (grid > 2LL * sms) grid = 2LL * sms;
  if (grid > kMaxCtas) grid = kMaxCtas;
  int* ticket = reinterpret_cast<int*>(scratch + (long long)kMaxCtas * gd);
  sgda_lambda_kernel<G, NPL><<<(unsigned)grid, kThreads, smem, stream>>>(
      P, Gc, ids, vals, y, row_mask, attr_group, reg_w, reg_v, w0p, scratch, ticket, B, L, k,
      ng, mode, task, use_linear, use_bias, lr, min_t, max_t);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest G * (1+k) one call takes, and the floats of scratch a call
// with G groups of width d = 1+k needs: the CTA partials and the ticket.
extern "C" int sgda_lambda_max_width() { return kMaxGD; }
extern "C" long long sgda_lambda_scratch_floats(int ng, int d) {
  return (long long)kMaxCtas * ng * d + 4;
}

// P [n, d]; Gc [n+1, d]; ids, vals [B, L] (vals read in general mode
// only); y, row_mask [B]; attr_group [n] with values in [0, ng); reg_w
// [ng] and reg_v [ng, k], updated in place; w0p -> w0; scratch
// [sgda_lambda_scratch_floats(ng, d)], zero before the first call (each
// call leaves its ticket zero).
extern "C" int sgda_lambda_launch(const float* P, const float* Gc, const int* ids,
                                  const float* vals, const float* y,
                                  const unsigned char* row_mask, const int* attr_group,
                                  float* reg_w, float* reg_v, const float* w0p, float* scratch,
                                  int B, int L, int d, int ng, int mode, int task,
                                  int use_linear, int use_bias, float lr, float min_t,
                                  float max_t, cudaStream_t stream) {
  const int k = d - 1;
  if (k < 1 || k > kMaxK || B < 1 || L < 1 || ng < 1 || (long long)ng * d > kMaxGD ||
      (long long)B * L > 0x7fffffffLL || mode < kPair || mode > kGeneral ||
      (mode == kPair && L != 2))
    return (int)cudaErrorInvalidValue;
#define SGDA_LAMBDA_LAUNCH(G, NPL)                                                           \
  launch<G, NPL>(P, Gc, ids, vals, y, row_mask, attr_group, reg_w, reg_v, w0p, scratch, B, L, \
                 k, ng, mode, task, use_linear, use_bias, lr, min_t, max_t, stream)
  if (k <= 8) return SGDA_LAMBDA_LAUNCH(8, 1);
  if (k <= 16) return SGDA_LAMBDA_LAUNCH(16, 1);
  if (k <= 32) return SGDA_LAMBDA_LAUNCH(32, 1);
  if (k <= 64) return SGDA_LAMBDA_LAUNCH(32, 2);
  return SGDA_LAMBDA_LAUNCH(32, 4);
#undef SGDA_LAMBDA_LAUNCH
}
