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
// Design (sgd_step's, with SGDA's parts): lane groups of G lanes (8 for
// k <= 8, 16 for k <= 16, else 32), NPL factors a lane, the w column on
// the group's lane 0 as one more register; a warp holds 32/G groups and a
// group R rows at once (2 in pair mode), and a row's sums are reduced
// inside its group. Each entry's table row and its group id
// (attr_group[id], issued with the row) are gathered once and kept in
// registers between the prediction and the update and cache rows, up to
// LR entries a row (16, or 8 above k = 32; longer rows gather again in a
// second pass). Each warp stages its rows' ids, values, sorted positions,
// cache rows and y by cp.async kDepth items ahead; a slot is refilled
// once its rows' stores have read their positions and cache rows from it.
// The regularizers are copied into shared memory once a CTA (by
// cp.async, beside the first items) where the host's plan says so
// (G (1+k) <= kRegFloats: kernels/sgda_step.py `regs_shared`), else read
// from global memory. A persistent grid of one
// wave of resident CTAs, launched to overlap the end of the grid before
// it on the stream (programmatic dependent launch): every thread waits
// for that grid before it reads anything (the grid before may have
// written any input), and lets the next grid (table_scatter's in the
// epoch) start launching at once. Each row's sums run in one order (a
// fixed lane -> factor map, the group's butterfly sums) whatever the
// grid, so the update rows and the cache rows are the same bits at any
// grid; red and w0 round by this grid's partials. Element offsets are
// int64.

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kMaxK;
using libfm::kWarp;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kDepth = 2;           // items staged ahead
constexpr int kMaxParts = 4096;     // CTA partials the scratch holds
constexpr int kRegFloats = 4096;    // the regularizers' shared copy: G (1+k) floats at most
constexpr int kPair = 0, kGeneral = 2;  // the modes; "onehot" is 1

// G lanes a row, NPL factors a lane, LR entries a row in registers, R
// rows a group at once
template <int G, int NPL, int LR, int R>
struct Shape {
  static constexpr int kGroups = kWarp / G;
  static constexpr int kRows = kGroups * R;         // a warp's rows in a pass
  static constexpr int kTileRows = kWarps * kRows;  // a CTA's rows in a pass
  static constexpr int kEnt = kRows * LR;           // entries an item stages
  // ids, values, positions, cache rows, y
  static constexpr int kSlot = 4 * kEnt + kRows;
};

template <int G, int NPL, int LR, int R>
__global__ void __launch_bounds__(kThreads)
sgda_step_kernel(const float* __restrict__ P, const int* __restrict__ ids,
                 const float* __restrict__ vals, const float* __restrict__ y,
                 const unsigned char* __restrict__ row_mask, const int* __restrict__ order,
                 const int* __restrict__ gc_row, const int* __restrict__ attr_group,
                 const float* __restrict__ reg_w, const float* __restrict__ reg_v, float* w0p,
                 float* __restrict__ upd, float* __restrict__ Gc, float* __restrict__ part,
                 int* __restrict__ ticket, float* __restrict__ red, int B, int L, int k, int n,
                 int num_groups, int regs_shared, int mode, int task, int use_linear,
                 int use_bias, float lr, float min_t, float max_t) {
  using S = Shape<G, NPL, LR, R>;
  constexpr int RW = S::kRows;
  constexpr int kEnt = S::kEnt;
  __shared__ __align__(16) float ring[kWarps][kDepth][S::kSlot];
  __shared__ float s_reg[kRegFloats];
  __shared__ float s_m[kWarps];
  __shared__ float t_m[kThreads];
  __shared__ int s_last;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane / G;
  const int gl = lane % G;
  const int d = k + 1;
  const bool ones = mode != kGeneral;
  const long long npass = ((long long)B + S::kTileRows - 1) / S::kTileRows;
  const int nchunk = (L + LR - 1) / LR;

  // The warp's items (pass, chunk of LR entries a row) in order, kDepth
  // ahead: lane j copies entries e = j + 32 m (row e / LR of the warp's
  // rows, entry e % LR of the chunk), and on a pass's first chunk the
  // rows' y. Padding reads nothing and lands as zeros.
  long long fpass = blockIdx.x;
  int fch = 0;
  auto fetch = [&](float* slot) {
    const long long rw0 = fpass * S::kTileRows + warp * RW;
    const bool live = fpass < npass;
    for (int e = lane; e < kEnt; e += kWarp) {
      const long long r = rw0 + e / LR;
      const int j = fch * LR + e % LR;
      const bool ok = live && r < B && j < L;
      const long long off = ok ? r * L + j : 0;
      const int bytes = ok ? 4 : 0;
      libfm::cp_async4(slot + e, reinterpret_cast<const float*>(ids + off), bytes);
      if (!ones) libfm::cp_async4(slot + kEnt + e, vals + off, bytes);
      libfm::cp_async4(slot + 2 * kEnt + e, reinterpret_cast<const float*>(order + off),
                       bytes);
      libfm::cp_async4(slot + 3 * kEnt + e, reinterpret_cast<const float*>(gc_row + off),
                       bytes);
    }
    if (lane < RW) {
      const bool ok = live && fch == 0 && rw0 + lane < B;
      libfm::cp_async4(slot + 4 * kEnt + lane, y + (ok ? rw0 + lane : 0), ok ? 4 : 0);
    }
    libfm::cp_async_commit();
    if (++fch == nchunk) {
      fch = 0;
      fpass += gridDim.x;
    }
  };
  libfm::grid_dep_launch();
  libfm::grid_dep_wait();  // the grid before may have written any input
  // the regularizers' copy (its own cp.async group), then the first items
  if (regs_shared) {
    for (int i = threadIdx.x; i < num_groups; i += kThreads)
      libfm::cp_async4(s_reg + i, reg_w + i);
    for (int i = threadIdx.x; i < num_groups * k; i += kThreads)
      libfm::cp_async4(s_reg + num_groups + i, reg_v + i);
  }
  libfm::cp_async_commit();
#pragma unroll
  for (int i = 0; i < kDepth; ++i) fetch(ring[warp][i]);
  const float* rw = regs_shared ? s_reg : reg_w;
  const float* rv = regs_shared ? s_reg + num_groups : reg_v;
  const float w0 = *w0p;
  libfm::cp_async_wait<kDepth>();  // this thread's share of the copy has landed
  __syncthreads();

  float msum = 0.0f;
  int item = 0;
  for (long long pass = blockIdx.x; pass < npass; pass += gridDim.x) {
    const long long rw0 = pass * S::kTileRows + warp * RW;
    long long row[R];
    bool live[R];
    float m[R], yv[R], sq[R], wx[R], vs[R][NPL];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      row[u] = rw0 + grp * R + u;
      live[u] = row[u] < B;
      m[u] = live[u] && row_mask[row[u]] ? 1.0f : 0.0f;
      yv[u] = sq[u] = wx[u] = 0.0f;
#pragma unroll
      for (int t = 0; t < NPL; ++t) vs[u][t] = 0.0f;
    }
    // the current chunk's rows: factors, w (group lane 0) and group ids
    float cv[R][LR][NPL], cw[R][LR];
    int cg[R][LR];
    const float* slot = ring[warp][item];
    for (int ch = 0; ch < nchunk; ++ch) {
      libfm::cp_async_wait<kDepth - 1>();  // this item's copies have landed
      __syncwarp();
      slot = ring[warp][item];
      if (ch == 0) {
#pragma unroll
        for (int u = 0; u < R; ++u) yv[u] = slot[4 * kEnt + grp * R + u];
      }
      // every gather of the chunk before the first add
#pragma unroll
      for (int j = 0; j < LR; ++j) {
        const bool in = ch * LR + j < L;
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int e = (grp * R + u) * LR + j;
          const int id = __float_as_int(slot[e]);
          const float* p = P + (long long)id * d;
          cg[u][j] = in && nchunk == 1 ? attr_group[id] : 0;
          cw[u][j] = in && gl == 0 ? p[0] : 0.0f;
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const int f = gl + G * t;
            cv[u][j][t] = in && f < k ? p[1 + f] : 0.0f;
          }
        }
      }
      // the prediction's sums, entry by entry in order
#pragma unroll
      for (int j = 0; j < LR; ++j) {
        if (ch * LR + j < L) {
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const int e = (grp * R + u) * LR + j;
            const float x = ones ? m[u] : slot[kEnt + e];
            if (gl == 0) wx[u] += cw[u][j] * x;
#pragma unroll
            for (int t = 0; t < NPL; ++t) {
              const float vx = cv[u][j][t] * x;
              vs[u][t] += vx;
              sq[u] += vx * vx;
            }
          }
        }
      }
      if (nchunk > 1) {  // the second pass reads the rows from global memory
        __syncwarp();
        fetch(ring[warp][item]);
        item = item + 1 == kDepth ? 0 : item + 1;
      }
    }

    float mult[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float qq = -sq[u];
#pragma unroll
      for (int t = 0; t < NPL; ++t) qq += vs[u][t] * vs[u][t];
      float pred = 0.5f * libfm::lane_group_sum<G>(qq);
      const float wsum = __shfl_sync(kFullMask, wx[u], grp * G);
      if (use_linear) pred += wsum;
      if (use_bias) pred += w0;
      mult[u] = m[u] != 0.0f ? libfm::sgda_multiplier(pred, yv[u], task, min_t, max_t) : 0.0f;
      if (gl == 0 && live[u]) msum += mult[u];
    }

    if (nchunk == 1) {
      // the update and cache rows from the kept rows; the positions and
      // cache rows (and values) from the slot, then the slot is refilled
#pragma unroll
      for (int j = 0; j < LR; ++j) {
        if (j >= L) break;
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (!live[u]) continue;
          const int e = (grp * R + u) * LR + j;
          const float x = ones ? m[u] : slot[kEnt + e];
          const float em = x != 0.0f ? 1.0f : 0.0f;
          const int gi = cg[u][j];
          float* out = upd + (long long)__float_as_int(slot[2 * kEnt + e]) * d;
          const int tgt = __float_as_int(slot[3 * kEnt + e]);
          float* gc = tgt < n ? Gc + (long long)tgt * d : nullptr;
          if (gl == 0) {
            float uw = 0.0f;
            if (use_linear) {
              const float gw = mult[u] * x;
              uw = -lr * (gw + 2.0f * rw[gi] * cw[u][j] * em);
              if (gc) gc[0] = gw;
            }
            out[0] = uw;
          }
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const int f = gl + G * t;
            if (f < k) {
              const float v = cv[u][j][t];
              const float gv = mult[u] * (x * (vs[u][t] - v * x));
              out[1 + f] = -lr * (gv + 2.0f * rv[(long long)gi * k + f] * v * em);
              if (gc) gc[1 + f] = gv;
            }
          }
        }
      }
      __syncwarp();  // every lane is done with the slot: refill it
      fetch(ring[warp][item]);
      item = item + 1 == kDepth ? 0 : item + 1;
    } else {  // rows longer than LR entries: gather them again
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (!live[u]) continue;
        for (int l = 0; l < L; ++l) {
          const long long e = row[u] * L + l;
          const int id = ids[e];
          const float x = ones ? m[u] : vals[e];
          const float em = x != 0.0f ? 1.0f : 0.0f;
          const int gi = attr_group[id];
          const float* p = P + (long long)id * d;
          float* out = upd + (long long)order[e] * d;
          const int tgt = gc_row[e];
          float* gc = tgt < n ? Gc + (long long)tgt * d : nullptr;
          if (gl == 0) {
            float uw = 0.0f;
            if (use_linear) {
              const float gw = mult[u] * x;
              uw = -lr * (gw + 2.0f * rw[gi] * p[0] * em);
              if (gc) gc[0] = gw;
            }
            out[0] = uw;
          }
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const int f = gl + G * t;
            if (f < k) {
              const float v = p[1 + f];
              const float gv = mult[u] * (x * (vs[u][t] - v * x));
              out[1 + f] = -lr * (gv + 2.0f * rv[(long long)gi * k + f] * v * em);
              if (gc) gc[1 + f] = gv;
            }
          }
        }
      }
    }
  }
  libfm::cp_async_wait<0>();  // the fetches past the last item

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

template <int G, int NPL, int LR, int R>
int launch(const float* P, const int* ids, const float* vals, const float* y,
           const unsigned char* row_mask, const int* order, const int* gc_row,
           const int* attr_group, const float* reg_w, const float* reg_v, float* w0p,
           float* upd, float* Gc, float* scratch, float* red, int B, int L, int k, int n,
           int num_groups, int regs_shared, int mode, int task, int use_linear,
           int use_bias, float lr, float min_t, float max_t, cudaStream_t stream) {
  constexpr auto kernel = sgda_step_kernel<G, NPL, LR, R>;
  constexpr int T = Shape<G, NPL, LR, R>::kTileRows;
  unsigned grid;
  const cudaError_t err =
      libfm::one_wave_grid<kernel>(kThreads, 0, ((long long)B + T - 1) / T, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid > (unsigned)kMaxParts) grid = kMaxParts;
  int* ticket = reinterpret_cast<int*>(scratch + kMaxParts);
  return (int)libfm::launch_pdl(kernel, grid, kThreads, stream, P, ids, vals, y, row_mask,
                                 order, gc_row, attr_group, reg_w, reg_v, w0p, upd, Gc,
                                 scratch, ticket, red, B, L, k, n, num_groups, regs_shared,
                                 mode, task, use_linear, use_bias, lr, min_t, max_t);
}

}  // namespace

// Floats of scratch a call needs: the CTA partials and the ticket.
extern "C" int sgda_step_scratch_floats() { return kMaxParts + 4; }

// The regularizers' shared copy at most, in floats.
extern "C" int sgda_step_reg_floats() { return kRegFloats; }

// P [n, d]; ids, vals, order, gc_row [B, L] (vals read in general mode
// only); y, row_mask [B]; attr_group [n] with values in [0, G); reg_w
// [G]; reg_v [G, k] (copied into shared memory when regs_shared, which
// needs G (1+k) <= kRegFloats); w0p -> w0 (updated in place when
// use_bias); upd [B*L, d]; Gc [n+1, d] (rows below n written where gc_row
// says); scratch [sgda_step_scratch_floats()], zero before the first call
// (each call leaves its ticket zero); red [1].
extern "C" int sgda_step_launch(const float* P, const int* ids, const float* vals,
                                const float* y, const unsigned char* row_mask,
                                const int* order, const int* gc_row, const int* attr_group,
                                const float* reg_w, const float* reg_v, float* w0p, float* upd,
                                float* Gc, float* scratch, float* red, int B, int L, int d,
                                int n, int num_groups, int regs_shared, int mode, int task,
                                int use_linear, int use_bias, float lr, float min_t,
                                float max_t, cudaStream_t stream) {
  const int k = d - 1;
  if (k < 1 || k > kMaxK || B < 1 || L < 1 || n < 1 || num_groups < 1 ||
      (long long)B * L > 0x7fffffffLL || mode < kPair || mode > kGeneral ||
      (mode == kPair && L != 2) ||
      (regs_shared && (long long)num_groups * d > kRegFloats))
    return (int)cudaErrorInvalidValue;
#define SGDA_STEP_LAUNCH(G, NPL, LR, R)                                                  \
  launch<G, NPL, LR, R>(P, ids, vals, y, row_mask, order, gc_row, attr_group, reg_w,    \
                        reg_v, w0p, upd, Gc, scratch, red, B, L, k, n, num_groups,      \
                        regs_shared, mode, task, use_linear, use_bias, lr, min_t, max_t, \
                        stream)
  if (mode == kPair) {
    if (k <= 8) return SGDA_STEP_LAUNCH(8, 1, 2, 2);
    if (k <= 16) return SGDA_STEP_LAUNCH(16, 1, 2, 2);
    if (k <= 32) return SGDA_STEP_LAUNCH(32, 1, 2, 2);
    if (k <= 64) return SGDA_STEP_LAUNCH(32, 2, 2, 2);
    return SGDA_STEP_LAUNCH(32, 4, 2, 2);
  }
  if (k <= 8) return SGDA_STEP_LAUNCH(8, 1, 16, 1);
  if (k <= 16) return SGDA_STEP_LAUNCH(16, 1, 16, 1);
  if (k <= 32) return SGDA_STEP_LAUNCH(32, 1, 16, 1);
  if (k <= 64) return SGDA_STEP_LAUNCH(32, 2, 8, 1);
  return SGDA_STEP_LAUNCH(32, 4, 8, 1);
#undef SGDA_STEP_LAUNCH
}
