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
// Bound on the H100: bytes. A call reads the batch (ids, vals in general
// mode, y, mask), each touched row of P and of Gc and its group id, and
// reads and writes the regularizers: at configs #1 and #4b 1.5-5 MB a
// validation batch, 0.5-1.5 us at 3.35 TB/s. It is bound by latency: the
// launch, each row's chain of gathers (ids -> attr_group, P, Gc ->
// reg_v) and the sum over the CTAs.
//
// Design (redesigned for the H100; the host's plan, kernels/sgda_lambda.py
// `lambda_plan`, sizes the launch):
// - A lane group of LG lanes (8 for k <= 8, 16 for k <= 16, else 32) takes
//   one row a pass, NPL factors a lane and the w column on lane 0. A row's
//   entries are read in chunks of 4 / NPL (`Row::gather`): every id and
//   value of the chunk first, then every row of P and of Gc, each load
//   issued before any is used (a warp issues in order, so a chain of loads
//   an entry would wait on each entry in turn). The first two entries
//   stay in registers from the prediction to the terms (a row of at most
//   two, config #1's, is read once); later entries are read again, from
//   L1, for the terms. One code path (`Row::terms`, `Terms::predict`,
//   `Terms::add`) for both.
// - Each lane group adds its rows' terms, the entries in order, into its
//   own copy of S in shared memory: no turns, no atomics. Where the copies
//   of all G (1+k) columns do not fit, the columns are taken in tiles of
//   `tile`, the CTA's rows read once a tile. A CTA's partial is its copies
//   added in order, a thread a column.
// - The grid is sized to the batch (`grid` CTAs of `passes` row passes
//   each, up to what the SMs hold at once), so a small batch makes few,
//   full partials.
// - The sum over the CTAs takes two levels of at most kFan partials: the
//   last CTA of each run of kFan CTAs to finish (a ticket after a fence)
//   adds their partials into a level partial (a thread a column, its
//   <= kFan loads all in flight); the last of those adds the level
//   partials the same way and updates the regularizers (every CTA read
//   them before its ticket), then zeroes the tickets. The partials are
//   added in CTA order: the same bits on every run. (Thread-block
//   clusters of 8, the first level through distributed shared memory,
//   were tried and measured slower at configs #1's and #4b's shapes.)

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kMaxK;
using libfm::kWarp;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxCtas = 512;               // CTAs a launch at most
constexpr int kFan = 32;                    // partials one CTA of the tail adds
constexpr int kMaxFans = kMaxCtas / kFan;   // level partials at most
constexpr int kTicketFloats = 64;           // the tickets at the scratch's start
constexpr int kMaxColumns = 1 << 24;        // G (1+k) (int offsets within a partial)
constexpr int kMaxDynamic = 232448 - 256;   // a CTA's dynamic shared memory at most
constexpr int kPair = 0, kGeneral = 2;      // the modes; "onehot" is 1

// Column j of the n <= kFan partials (rows of stride gd) at `part`, added
// in partial order; every load in flight at once.
__device__ __forceinline__ float partials_sum(const float* part, int gd, int n, int j) {
  float x[kFan];
#pragma unroll
  for (int u = 0; u < kFan; ++u) x[u] = u < n ? __ldcg(part + (long long)u * gd + j) : 0.0f;
  float a = 0.0f;
#pragma unroll
  for (int u = 0; u < kFan; ++u)
    if (u < n) a += x[u];
  return a;
}

// N entries of a row as one gather reads them: group, value, the w and V
// columns this lane owns of the entry's rows of P and of Gc.
template <int N, int NPL>
struct Entries {
  int gi[N];
  float x[N], w[N], gw[N], v[N][NPL], gv[N][NPL];

  // w' = w - lr (gw + 2 reg_w[g] w) and v' = v - lr (gv + 2 reg_v[g] v)
  // (the regularizers read through the read-only cache: this launch's
  // last CTA writes them only after every CTA has read them)
  __device__ __forceinline__ float look_ahead_w(int u, const float* reg_w, float lr) const {
    return w[u] - lr * (gw[u] + 2.0f * __ldg(reg_w + gi[u]) * w[u]);
  }
  __device__ __forceinline__ float look_ahead_v(int u, int t, int f, int k, const float* reg_v,
                                                float lr) const {
    const float r = __ldg(reg_v + (long long)gi[u] * k + f);
    return (v[u][t] - lr * (gv[u][t] + 2.0f * r * v[u][t])) * x[u];
  }
};

// N entries of a row in the form the prediction and the terms read: the
// group's column 0 (-1 past L), x, x w and w' (w lane), and each of this
// lane's factors' v x and v' x. After the prediction the terms need only
// c0, xw, vx and vd.
template <int N, int NPL>
struct Terms {
  int c0[N];
  float x[N], xw[N], wd[N], vx[N][NPL], vd[N][NPL];

  // the entries' shares of the prediction, in entry order
  template <int LG>
  __device__ __forceinline__ void predict(int gl, int k, bool wlane, float (&sfd)[NPL],
                                          float& sq, float& wx) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (c0[u] < 0) continue;
      if (wlane) wx += wd[u] * x[u];
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        if (gl + LG * t < k) {
          sfd[t] += vd[u][t];
          sq += vd[u][t] * vd[u][t];
        }
      }
    }
  }

  // the entries' terms, in entry order, into the copy S of the tile's wt
  // columns from j0
  template <int LG>
  __device__ __forceinline__ void add(float* S, float gloss, const float (&sfd)[NPL], int j0,
                                      int wt, int gl, int k, bool wlane) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (c0[u] < 0) continue;
      const int c = c0[u] - j0;
      if (wlane && c >= 0 && c < wt) S[c] += gloss * xw[u];
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int f = gl + LG * t;
        const int col = c + 1 + f;
        if (f < k && col >= 0 && col < wt) S[col] += gloss * (vx[u][t] * (sfd[t] - vd[u][t]));
      }
    }
  }
};

// One row's entries (row e0 / L of the batch, or a dead row past B).
struct Row {
  const int* __restrict__ ids;
  const float* __restrict__ vals;
  const int* __restrict__ attr_group;
  const float* __restrict__ P;
  const float* __restrict__ Gc;
  long long e0;
  int L;
  bool live, ones;
  float m;  // the row mask, the value of every entry in "pair" / "onehot" mode
  bool wlane;
  int gl, k;

  // Entries l0 .. l0 + N - 1 (those below L): every id and value first,
  // then every gather, each load issued before any is used (a warp issues
  // in order, so a chain of loads an entry would wait on each in turn).
  template <int LG, int N, int NPL>
  __device__ __forceinline__ void gather(int l0, Entries<N, NPL>& e) const {
    const int d = k + 1;
    int id[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      id[u] = 0;
      e.x[u] = ones ? m : 0.0f;
      if (l0 + u < L && live) {
        id[u] = ids[e0 + l0 + u];
        if (!ones) e.x[u] = vals[e0 + l0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      e.gi[u] = 0;
      e.w[u] = e.gw[u] = 0.0f;
#pragma unroll
      for (int t = 0; t < NPL; ++t) e.v[u][t] = e.gv[u][t] = 0.0f;
      if (l0 + u < L) {
        e.gi[u] = attr_group[id[u]];
        const float* p = P + (long long)id[u] * d;
        const float* q = Gc + (long long)id[u] * d;
        if (wlane) {
          e.w[u] = p[0];
          e.gw[u] = q[0];
        }
#pragma unroll
        for (int t = 0; t < NPL; ++t) {
          const int f = gl + LG * t;
          if (f < k) {
            e.v[u][t] = p[1 + f];
            e.gv[u][t] = q[1 + f];
          }
        }
      }
    }
  }

  // Entries l0 .. l0 + N - 1 gathered and formed for the prediction and
  // the terms.
  template <int LG, int N, int NPL>
  __device__ __forceinline__ void terms(int l0, const float* reg_w, const float* reg_v,
                                        float lr, Terms<N, NPL>& c) const {
    Entries<N, NPL> e;
    gather<LG>(l0, e);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const bool in = l0 + u < L;
      c.c0[u] = in ? e.gi[u] * (k + 1) : -1;
      c.x[u] = e.x[u];
      c.xw[u] = e.x[u] * e.w[u];
      c.wd[u] = in && wlane ? e.look_ahead_w(u, reg_w, lr) : 0.0f;
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int f = gl + LG * t;
        c.vx[u][t] = c.vd[u][t] = 0.0f;
        if (in && f < k) {
          c.vx[u][t] = e.v[u][t] * e.x[u];
          c.vd[u][t] = e.look_ahead_v(u, t, f, k, reg_v, lr);
        }
      }
    }
  }
};

template <int LG, int NPL>
__global__ void __launch_bounds__(kThreads, 4)
sgda_lambda_kernel(const float* __restrict__ P, const float* __restrict__ Gc,
                   const int* __restrict__ ids, const float* __restrict__ vals,
                   const float* __restrict__ y, const unsigned char* __restrict__ row_mask,
                   const int* __restrict__ attr_group, float* reg_w, float* reg_v,
                   const float* __restrict__ w0p, float* __restrict__ scratch, int B, int L,
                   int k, int ng, int passes, int tile, int stride, int mode, int task,
                   int use_linear, int use_bias, float lr, float min_t, float max_t) {
  constexpr int kGroups = kWarp / LG;        // lane groups a warp
  constexpr int kRows = kWarps * kGroups;    // rows a CTA takes a pass; copies of S
  constexpr int kHead = 2;                   // entries kept from the prediction to the terms
  constexpr int kChunk = 4 / NPL;            // entries gathered at once after them
  extern __shared__ float acc[];             // [kRows][stride]: a tile of S a lane group
  __shared__ int s_last;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane / LG;
  const int gl = lane % LG;
  const int d = k + 1;
  const int gd = ng * d;
  const bool ones = mode != kGeneral;
  const bool wlane = gl == 0 && use_linear;
  float* S = acc + (warp * kGroups + grp) * stride;
  int* tickets = reinterpret_cast<int*>(scratch);              // [kMaxFans + 1]
  float* part = scratch + kTicketFloats;                        // [grid][gd]
  float* part2 = part + (long long)gridDim.x * gd;              // [runs of kFan][gd]
  const float w0 = use_bias ? *w0p : 0.0f;
  const long long first = (long long)blockIdx.x * passes * kRows + warp * kGroups + grp;

  for (int j0 = 0; j0 < gd; j0 += tile) {
    const int wt = min(tile, gd - j0);
    for (int j = threadIdx.x; j < kRows * stride; j += kThreads) acc[j] = 0.0f;
    __syncthreads();
    // the passes are uniform over the warp (the lane groups' sums)
    for (int pass = 0; pass < passes; ++pass) {
      const long long row = first + (long long)pass * kRows;
      const bool live = row < B;
      const float m = live && row_mask[row] ? 1.0f : 0.0f;
      const float yv = live ? y[row] : 0.0f;
      const long long e0 = live ? row * L : 0;
      const Row r{ids, vals, attr_group, P, Gc, e0, L, live, ones, m, wlane, gl, k};
      // the look-ahead prediction; the row's first kHead entries kept in
      // registers for the terms (config #1's rows: one pass), later ones
      // kChunk at a time
      float sfd[NPL], sq = 0.0f, wx = 0.0f;
#pragma unroll
      for (int t = 0; t < NPL; ++t) sfd[t] = 0.0f;
      Terms<kHead, NPL> head;
      r.template terms<LG>(0, reg_w, reg_v, lr, head);
      head.template predict<LG>(gl, k, wlane, sfd, sq, wx);
      for (int l0 = kHead; l0 < L; l0 += kChunk) {
        Terms<kChunk, NPL> c;
        r.template terms<LG>(l0, reg_w, reg_v, lr, c);
        c.template predict<LG>(gl, k, wlane, sfd, sq, wx);
      }
      float qq = -sq;
#pragma unroll
      for (int t = 0; t < NPL; ++t) qq += sfd[t] * sfd[t];
      float pred = 0.5f * libfm::lane_group_sum<LG>(qq);
      const float wsum = __shfl_sync(kFullMask, wx, grp * LG);
      if (use_linear) pred += wsum;
      if (use_bias) pred += w0;
      if (m == 0.0f) continue;  // a padded row adds nothing (its multiplier is 0)
      const float gloss = libfm::sgda_multiplier(pred, yv, task, min_t, max_t);

      // the terms, into this lane group's copy (the columns of this tile);
      // the entries after the head read again (L1)
      head.template add<LG>(S, gloss, sfd, j0, wt, gl, k, wlane);
      for (int l0 = kHead; l0 < L; l0 += kChunk) {
        Terms<kChunk, NPL> c;
        r.template terms<LG>(l0, reg_w, reg_v, lr, c);
        c.template add<LG>(S, gloss, sfd, j0, wt, gl, k, wlane);
      }
    }
    __syncthreads();
    // this CTA's partial of the tile: the lane groups' copies in order
    for (int j = threadIdx.x; j < wt; j += kThreads) {
      float a = 0.0f;
      for (int c = 0; c < kRows; ++c) a += acc[c * stride + j];
      part[(long long)blockIdx.x * gd + j0 + j] = a;
    }
    __syncthreads();  // the copies are read before the next tile zeroes them
  }

  // the sum over the CTAs: runs of kFan CTAs, then the runs' partials
  __threadfence();
  __syncthreads();
  const int grid = (int)gridDim.x;
  const int fan = (int)blockIdx.x / kFan;
  const int nfans = (grid + kFan - 1) / kFan;
  const int in_fan = min(kFan, grid - fan * kFan);
  if (threadIdx.x == 0) s_last = atomicAdd(tickets + fan, 1) == in_fan - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* src = part + (long long)fan * kFan * gd;
  int n = in_fan;
  if (nfans > 1) {
    for (int j = threadIdx.x; j < gd; j += kThreads)
      part2[(long long)fan * gd + j] = partials_sum(src, gd, in_fan, j);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(tickets + kMaxFans, 1) == nfans - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    src = part2;
    n = nfans;
  }
  for (int j = threadIdx.x; j < gd; j += kThreads) {
    const float s = partials_sum(src, gd, n, j);
    const int g = j / d, col = j % d;
    if (col == 0) {
      if (use_linear) reg_w[g] = fmaxf(reg_w[g] - lr * (-2.0f * lr * s), 0.0f);
    } else {
      float* r = reg_v + (long long)g * k + (col - 1);
      *r = fmaxf(*r - lr * (-2.0f * lr * s), 0.0f);
    }
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < nfans; ++i) tickets[i] = 0;
    tickets[kMaxFans] = 0;
  }
}

template <int LG, int NPL>
int launch(const float* P, const float* Gc, const int* ids, const float* vals,
           const float* y, const unsigned char* row_mask, const int* attr_group,
           float* reg_w, float* reg_v, const float* w0p, float* scratch, int B, int L, int k,
           int ng, int mode, int task, int use_linear, int use_bias, float lr, float min_t,
           float max_t, int grid, int passes, int tile, int stride, cudaStream_t stream) {
  constexpr auto kernel = sgda_lambda_kernel<LG, NPL>;
  constexpr int kRows = kWarps * (kWarp / LG);
  constexpr int kDevices = 64;
  static int opted[kDevices];
  const long long smem = (long long)kRows * stride * sizeof(float);
  if ((long long)grid * passes * kRows < B || smem > kMaxDynamic)
    return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (smem > opted[dev]) {  // the largest area asked for so far
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = (int)smem;
  }
  kernel<<<(unsigned)grid, kThreads, (size_t)smem, stream>>>(
      P, Gc, ids, vals, y, row_mask, attr_group, reg_w, reg_v, w0p, scratch, B, L, k, ng,
      passes, tile, stride, mode, task, use_linear, use_bias, lr, min_t, max_t);
  return (int)cudaGetLastError();
}

}  // namespace

// P [n, d]; Gc [n+1, d]; ids, vals [B, L] (vals read in general mode
// only); y, row_mask [B]; attr_group [n] with values in [0, ng); reg_w
// [ng] and reg_v [ng, k], updated in place; w0p -> w0; scratch: the
// tickets, kMaxFans + 1 ints in its first kTicketFloats floats, zero
// before the first call (each call leaves them zero), then (grid +
// ceil(grid / kFan)) * ng * d floats of partials. The plan
// (kernels/sgda_lambda.py `lambda_plan`): `grid` CTAs of `passes` passes,
// S's columns in tiles of `tile`, the lane groups' copies `stride` floats
// apart.
extern "C" int sgda_lambda_launch(const float* P, const float* Gc, const int* ids,
                                  const float* vals, const float* y,
                                  const unsigned char* row_mask, const int* attr_group,
                                  float* reg_w, float* reg_v, const float* w0p, float* scratch,
                                  int B, int L, int d, int ng, int mode, int task,
                                  int use_linear, int use_bias, float lr, float min_t,
                                  float max_t, int grid, int passes, int tile,
                                  int stride, cudaStream_t stream) {
  const int k = d - 1;
  if (k < 1 || k > kMaxK || B < 1 || L < 1 || ng < 1 || (long long)ng * d > kMaxColumns ||
      (long long)B * L > 0x7fffffffLL || mode < kPair || mode > kGeneral ||
      (mode == kPair && L != 2) || grid < 1 || grid > kMaxCtas || passes < 1 || tile < 1 ||
      stride < tile)
    return (int)cudaErrorInvalidValue;
#define SGDA_LAMBDA_LAUNCH(G, NPL)                                                         \
  launch<G, NPL>(P, Gc, ids, vals, y, row_mask, attr_group, reg_w, reg_v, w0p, scratch, B, L, k, \
                 ng, mode, task, use_linear, use_bias, lr, min_t, max_t, grid, passes, tile,    \
                 stride, stream)
  if (k <= 8) return SGDA_LAMBDA_LAUNCH(8, 1);
  if (k <= 16) return SGDA_LAMBDA_LAUNCH(16, 1);
  if (k <= 32) return SGDA_LAMBDA_LAUNCH(32, 1);
  if (k <= 64) return SGDA_LAMBDA_LAUNCH(32, 2);
  return SGDA_LAMBDA_LAUNCH(32, 4);
#undef SGDA_LAMBDA_LAUNCH
}
