// sgda_step: one mini-batch theta step of SGDA (SGD with adaptive
// per-group regularization) on the packed table P = [w | V] [n, 1+k], up
// to the scatter: the gather, the prediction, the SGDA multiplier, the
// per-entry update rows, the gradient caches, the batch sum and w0.
//
// Replaces K13's theta_step, libfm_tpu/learners/sgda.py:70-107 (libFM
// fm_learn_sgd_element_adapt_reg.h:136-169):
//   pred  = w0 + sum_l w x + 1/2 (|sum_l v x|^2 - sum_l |v x|^2)
//   mult  = 2 (clamp(pred, min, max) - y)   (regression)
//         = y (sigmoid(y pred) - 1)         (classification), 0 on padded rows
//   gw = mult x,  gv = mult x (vsum - v x)
//   upd_w = -lr (gw + 2 reg_w[g] w m),  upd_v = -lr (gv + 2 reg_v[g] v m)
//   Gc[id] = [gw | gv]  (set, not added: the caches of the look-ahead)
//   w0 <- w0 - lr sum mult   (no regularizer)
// with g = attr_group[id] and the entry mask m = (x != 0). In "pair" and
// "onehot" modes the values are not read: x is the row mask (1 on a real
// row, 0 on a padded one, as the padded rows' stored values); "pair" is
// "onehot" at L = 2 (SGDA predicts by the general formula, as JAX does).
// reg_w [G] and reg_v [G, k] are read on the device, so a step needs no
// host value of them.
//
// The update rows go out at each entry's sorted position order[b, l], for
// table_scatter. Gc row gc_row[b, l] is written with
// the entry's gradients when it is below n; the caller sets it to the
// entry's id for the last entry of value != 0 of each id in entry order
// (the write that `grad.at[sids].set` keeps on XLA's CPU backend) and to
// n for every other entry, so each row has one writer and nothing races.
// The batch's sum of mult goes to red[0]: each CTA writes a partial, and
// the CTA that finishes last (a ticket after a fence) adds the partials
// in a fixed order, writes red, updates w0 in place (every CTA read w0
// before its ticket) and zeroes the ticket. No floating-point atomics: red
// and w0 are bitwise repeatable.
//
// Bound on the H100: bytes. A step reads the batch (ids, order, gc_row
// and in general mode vals: 12-16 B an entry, y and the mask 5 B a row),
// gathers each touched table row and its group id, and writes B*L update
// rows and each written cache row ((1+k) * 4 B each). At configs #1 and
// #4b that is 4-9 MB a batch, a few microseconds at 3.35 TB/s, and the
// table stays in the 50 MB L2: a step is bound by latency, the launch and
// each row's chain of id -> row gathers -> sums -> stores.
// Design (a first version, simple): lane groups of G lanes (8 for k <= 8,
// 16 for k <= 16, else 32) take one row each, NPL factors a lane and the
// w column on the group's lane 0; a warp holds 32/G rows at once and a
// row's sums are reduced inside its group. Each row is read twice: once
// for the prediction, again (from L1/L2) for the update and cache rows.
// A persistent grid of one wave of resident CTAs. Element offsets are
// int64.

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kMaxK;
using libfm::kWarp;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxParts = 4096;  // CTA partials the scratch holds
constexpr int kPair = 0, kGeneral = 2;  // the modes; "onehot" is 1

template <int G, int NPL>
__global__ void __launch_bounds__(kThreads)
sgda_step_kernel(const float* __restrict__ P, const int* __restrict__ ids,
                 const float* __restrict__ vals, const float* __restrict__ y,
                 const unsigned char* __restrict__ row_mask, const int* __restrict__ order,
                 const int* __restrict__ gc_row, const int* __restrict__ attr_group,
                 const float* __restrict__ reg_w, const float* __restrict__ reg_v, float* w0p,
                 float* __restrict__ upd, float* __restrict__ Gc, float* __restrict__ part,
                 int* __restrict__ ticket, float* __restrict__ red, int B, int L, int k, int n,
                 int mode, int task, int use_linear, int use_bias, float lr, float min_t,
                 float max_t) {
  constexpr int kGroups = kWarp / G;
  __shared__ float s_m[kWarps];
  __shared__ float t_m[kThreads];
  __shared__ int s_last;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane / G;
  const int gl = lane % G;
  const int d = k + 1;
  const bool ones = mode != kGeneral;
  const float w0 = *w0p;
  const long long stride = (long long)gridDim.x * kWarps * kGroups;

  float msum = 0.0f;
  // the warp's rows rb + grp; the loop is uniform over the warp, since
  // every lane takes part in the group sums
  for (long long rb = ((long long)blockIdx.x * kWarps + warp) * kGroups; rb < B;
       rb += stride) {
    const long long row = rb + grp;
    const bool live = row < B;
    const float m = live && row_mask[row] ? 1.0f : 0.0f;
    const float yv = live ? y[row] : 0.0f;
    float vs[NPL], sq = 0.0f, wx = 0.0f;
#pragma unroll
    for (int t = 0; t < NPL; ++t) vs[t] = 0.0f;
    for (int l = 0; l < L; ++l) {
      const long long e = row * L + l;
      const int id = live ? ids[e] : 0;
      const float x = ones ? m : (live ? vals[e] : 0.0f);
      const float* p = P + (long long)id * d;
      if (gl == 0) wx += p[0] * x;
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int f = gl + G * t;
        const float vx = (f < k ? p[1 + f] : 0.0f) * x;
        vs[t] += vx;
        sq += vx * vx;
      }
    }
    float qq = -sq;
#pragma unroll
    for (int t = 0; t < NPL; ++t) qq += vs[t] * vs[t];
    float pred = 0.5f * libfm::lane_group_sum<G>(qq);
    const float wsum = __shfl_sync(kFullMask, wx, grp * G);
    if (use_linear) pred += wsum;
    if (use_bias) pred += w0;
    const float mult = m != 0.0f ? libfm::sgda_multiplier(pred, yv, task, min_t, max_t) : 0.0f;
    if (!live) continue;
    if (gl == 0) msum += mult;

    // the update rows and the cache rows, the row read again
    for (int l = 0; l < L; ++l) {
      const long long e = row * L + l;
      const int id = ids[e];
      const float x = ones ? m : vals[e];
      const float em = x != 0.0f ? 1.0f : 0.0f;
      const int gi = attr_group[id];
      const float* p = P + (long long)id * d;
      float* out = upd + (long long)order[e] * d;
      const int tgt = gc_row[e];
      float* gc = tgt < n ? Gc + (long long)tgt * d : nullptr;
      if (gl == 0) {
        float u = 0.0f;
        if (use_linear) {
          const float gw = mult * x;
          u = -lr * (gw + 2.0f * reg_w[gi] * p[0] * em);
          if (gc) gc[0] = gw;
        }
        out[0] = u;
      }
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int f = gl + G * t;
        if (f < k) {
          const float v = p[1 + f];
          const float gv = mult * (x * (vs[t] - v * x));
          out[1 + f] = -lr * (gv + 2.0f * reg_v[(long long)gi * k + f] * v * em);
          if (gc) gc[1 + f] = gv;
        }
      }
    }
  }

  // this CTA's sum of mult, lanes and warps in a fixed order
  msum = libfm::warp_sum(msum);
  if (lane == 0) s_m[warp] = msum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) a += s_m[w];
    part[blockIdx.x] = a;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last CTA: the partials in CTA order (strided sums, then a tree)
  __threadfence();
  float a = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) a += __ldcg(part + i);
  t_m[threadIdx.x] = a;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) t_m[threadIdx.x] += t_m[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float r0 = t_m[0];
    red[0] = r0;
    // w0 - lr * red0 rounded once, as JAX's line is (XLA fuses it into an
    // FMA) and as the plain version's w0_update rounds it
    if (use_bias) *w0p = __fmaf_rn(-lr, r0, w0);
    *ticket = 0;
  }
}

template <int G, int NPL>
int launch(const float* P, const int* ids, const float* vals, const float* y,
           const unsigned char* row_mask, const int* order, const int* gc_row,
           const int* attr_group, const float* reg_w, const float* reg_v, float* w0p,
           float* upd, float* Gc, float* scratch, float* red, int B, int L, int k, int n,
           int mode, int task, int use_linear, int use_bias, float lr, float min_t,
           float max_t, cudaStream_t stream) {
  constexpr auto kernel = sgda_step_kernel<G, NPL>;
  constexpr int kRows = kWarps * (kWarp / G);  // a CTA's rows at once
  unsigned grid;
  const cudaError_t err =
      libfm::one_wave_grid<kernel>(kThreads, ((long long)B + kRows - 1) / kRows, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid > (unsigned)kMaxParts) grid = kMaxParts;
  int* ticket = reinterpret_cast<int*>(scratch + kMaxParts);
  sgda_step_kernel<G, NPL><<<grid, kThreads, 0, stream>>>(
      P, ids, vals, y, row_mask, order, gc_row, attr_group, reg_w, reg_v, w0p, upd, Gc, scratch,
      ticket, red, B, L, k, n, mode, task, use_linear, use_bias, lr, min_t, max_t);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a call needs: the CTA partials and the ticket.
extern "C" int sgda_step_scratch_floats() { return kMaxParts + 4; }

// P [n, d]; ids, vals, order, gc_row [B, L] (vals read in general mode
// only); y, row_mask [B]; attr_group [n] with
// values in [0, G); reg_w [G]; reg_v [G, k]; w0p -> w0 (updated in place
// when use_bias); upd [B*L, d]; Gc [n+1, d] (rows below n written where
// gc_row says); scratch [sgda_step_scratch_floats()], zero before the
// first call (each call leaves its ticket zero); red [1].
extern "C" int sgda_step_launch(const float* P, const int* ids, const float* vals,
                                const float* y, const unsigned char* row_mask,
                                const int* order, const int* gc_row, const int* attr_group,
                                const float* reg_w, const float* reg_v, float* w0p, float* upd,
                                float* Gc, float* scratch, float* red, int B, int L, int d,
                                int n, int mode, int task, int use_linear, int use_bias,
                                float lr, float min_t, float max_t, cudaStream_t stream) {
  const int k = d - 1;
  if (k < 1 || k > kMaxK || B < 1 || L < 1 || n < 1 || (long long)B * L > 0x7fffffffLL ||
      mode < kPair || mode > kGeneral || (mode == kPair && L != 2))
    return (int)cudaErrorInvalidValue;
#define SGDA_STEP_LAUNCH(G, NPL)                                                         \
  launch<G, NPL>(P, ids, vals, y, row_mask, order, gc_row, attr_group, reg_w, reg_v, w0p, \
                 upd, Gc, scratch, red, B, L, k, n, mode, task, use_linear, use_bias, lr, \
                 min_t, max_t, stream)
  if (k <= 8) return SGDA_STEP_LAUNCH(8, 1);
  if (k <= 16) return SGDA_STEP_LAUNCH(16, 1);
  if (k <= 32) return SGDA_STEP_LAUNCH(32, 1);
  if (k <= 64) return SGDA_STEP_LAUNCH(32, 2);
  return SGDA_STEP_LAUNCH(32, 4);
#undef SGDA_STEP_LAUNCH
}
