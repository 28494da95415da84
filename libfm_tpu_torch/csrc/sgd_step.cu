// sgd_step: one mini-batch SGD step of the FM on the packed table
// P = [w | V] [n, 1+k], up to the scatter: the gather, the prediction, the
// multiplier, the per-entry update rows, the batch sums and the w0 update.
//
// Replaces the hand-laid chunk body K8 of libfm_tpu/learners/sgd.py:128-213
// (`pair_step` and `packed_step`, modes "pair", "onehot" and "general",
// with their w0 line :145-147, :195-197), the exact fm_SGD formulas
// (libFM fm_sgd.h:33-51):
//   pred  = w0 + sum_l w x + 1/2 (|sum_l v x|^2 - sum_l |v x|^2)
//           (pair mode: w0 + w_u + w_i + v_u . v_i, the direct product)
//   mult  = clamp(pred, min, max) - y   (regression)
//         = -y (1 - sigmoid(y pred))     (classification), 0 on padded rows
//   upd_w = -lr1 (mult x + regw w m),  upd_v = -lr2 (mult (vsum x - v x^2) + regv v m)
//   w0   <- w0 - lr0 (sum mult + (n_real reg0) w0)
// with the entry mask m = row mask in pair and onehot modes and x != 0 in
// general mode. The update rows go out in entry order [B*L, 1+k], or at
// each entry's sorted position order[b, l], so that table_scatter reads
// them in order. The batch's sum of mult and its count of real rows go to
// red[2]: each CTA writes a partial, and the CTA that finishes last (a
// ticket after a fence) adds the partials in a fixed order, writes red,
// updates w0 in place when asked (every CTA read w0 before its ticket)
// and zeroes the ticket. No floating-point atomics: red and w0 are
// bitwise repeatable.
//
// Bound on the H100: bytes. A step reads the batch (ids, vals, y, mask:
// 9 B per entry + 5 B per row), gathers B*L table rows and writes B*L
// update rows ((1+k)*4 B each). The table (3 MB at config #1, 4.4 MB at
// config #4b) stays in the 50 MB L2, so a step is bound by latency: the
// launch, each row's chain of id -> row gathers -> sums -> stores, and
// the last CTA's sums.
// Design: lane groups of G lanes (8 for k <= 8, 16 for k <= 16, else 32),
// NPL factors a lane, the w column on the group's lane 0 as one more
// register; a warp holds 32/G groups and a group R rows at once (2 in
// pair mode), so every lane is busy and a row's sums are reduced inside
// its group. Each entry row is gathered once and kept in registers
// between the prediction and the update rows (up to LR entries a row:
// 16, or 8 above k=32; longer rows gather again in the second pass).
// Each warp stages its rows' ids, values, sorted positions and y by
// cp.async kDepth items ahead; the row mask is read when a pass starts.
// A persistent grid of one wave of resident CTAs, launched to overlap the
// end of the grid before it on the stream (programmatic dependent
// launch: table_scatter's, in the SGD epoch): every thread waits for that
// grid before it reads or writes anything, so the overlap is the launch
// and the CTAs' set-up. It lets the next grid (table_scatter's) start
// launching at once, so that grid's launch overlaps this one.
// Element offsets are int64.

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kMaxK;
using libfm::kWarp;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kDepth = 2;         // items staged ahead
constexpr int kMaxParts = 4096;   // CTA partials the scratch holds
constexpr int kPair = 0, kOnehot = 1, kGeneral = 2;

// G lanes a row, NPL factors a lane, LR entries a row in registers, R
// rows a group at once
template <int G, int NPL, int LR, int R>
struct Shape {
  static constexpr int kGroups = kWarp / G;
  static constexpr int kRows = kGroups * R;             // a warp's rows in a pass
  static constexpr int kTileRows = kWarps * kRows;      // a CTA's rows in a pass
  static constexpr int kEnt = kRows * LR;               // entries an item stages
  static constexpr int kSlot = 3 * kEnt + kRows;        // ids, values, positions, y
};

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float multiplier(float pred, float y, int task,
                                            float min_t, float max_t) {
  if (task == 0) return fminf(fmaxf(pred, min_t), max_t) - y;
  return -y * (1.0f - 1.0f / (1.0f + expf(-y * pred)));
}

template <int G, int NPL, int LR, int R>
__global__ void __launch_bounds__(kThreads)
sgd_step_kernel(const float* __restrict__ P, const int* __restrict__ ids,
                const float* __restrict__ vals, const float* __restrict__ y,
                const unsigned char* __restrict__ row_mask,
                const int* __restrict__ order, float* w0p, float* __restrict__ upd,
                float* __restrict__ part, int* __restrict__ ticket,
                float* __restrict__ red, int B, int L, int k, int mode, int task,
                int use_linear, int use_bias, int update_w0, float lr0, float reg0,
                float lr1, float lr2, float regw, float regv, float min_t, float max_t) {
  using S = Shape<G, NPL, LR, R>;
  constexpr int RW = S::kRows;
  constexpr int kEnt = S::kEnt;
  __shared__ __align__(16) float ring[kWarps][kDepth][S::kSlot];
  __shared__ float s_m[kWarps], s_c[kWarps];
  __shared__ float t_m[kThreads], t_c[kThreads];
  __shared__ int s_last;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane / G;
  const int gl = lane % G;
  const int d = k + 1;
  constexpr bool kIsPair = LR == 2;    // the pair instantiations
  const bool ones = mode != kGeneral;  // pair and onehot: values 1
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
      if (order)
        libfm::cp_async4(slot + 2 * kEnt + e, reinterpret_cast<const float*>(order + off),
                         bytes);
    }
    if (lane < RW) {
      const bool ok = live && fch == 0 && rw0 + lane < B;
      libfm::cp_async4(slot + 3 * kEnt + lane, y + (ok ? rw0 + lane : 0), ok ? 4 : 0);
    }
    libfm::cp_async_commit();
    if (++fch == nchunk) {
      fch = 0;
      fpass += gridDim.x;
    }
  };
  libfm::grid_dep_launch();
  libfm::grid_dep_wait();  // the grid before may have written any input
#pragma unroll
  for (int i = 0; i < kDepth; ++i) fetch(ring[warp][i]);
  const float w0 = use_bias || update_w0 ? *w0p : 0.0f;

  float msum = 0.0f, cnt = 0.0f;
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
    // the current chunk's rows: factors, w (group lane 0), value, and the
    // update row's index
    float cv[R][LR][NPL], cw[R][LR], cx[R][LR];
    int co[R][LR];
    for (int ch = 0; ch < nchunk; ++ch) {
      libfm::cp_async_wait<kDepth - 1>();  // this item's copies have landed
      __syncwarp();
      const float* slot = ring[warp][item];
      if (ch == 0) {
#pragma unroll
        for (int u = 0; u < R; ++u) yv[u] = slot[3 * kEnt + grp * R + u];
      }
      // every gather of the chunk before the first add
#pragma unroll
      for (int j = 0; j < LR; ++j) {
        const bool in = ch * LR + j < L;
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int e = (grp * R + u) * LR + j;
          const float* p = P + (long long)__float_as_int(slot[e]) * d;
          cx[u][j] = ones ? 1.0f : slot[kEnt + e];
          co[u][j] = order ? __float_as_int(slot[2 * kEnt + e])
                           : (int)(row[u] * L + ch * LR + j);
          cw[u][j] = in && gl == 0 ? p[0] : 0.0f;
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const int f = gl + G * t;
            cv[u][j][t] = in && f < k ? p[1 + f] : 0.0f;
          }
        }
      }
      __syncwarp();  // every lane is done with the slot: refill it
      fetch(ring[warp][item]);
      item = item + 1 == kDepth ? 0 : item + 1;
      if constexpr (kIsPair) continue;
#pragma unroll
      for (int j = 0; j < LR; ++j) {
        if (ch * LR + j < L) {
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const float x = cx[u][j];
            wx[u] += ones ? cw[u][j] : cw[u][j] * x;
#pragma unroll
            for (int t = 0; t < NPL; ++t) {
              const float vx = ones ? cv[u][j][t] : cv[u][j][t] * x;
              vs[u][t] += vx;
              sq[u] += vx * vx;
            }
          }
        }
      }
    }

    float mult[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float pred;
      if constexpr (kIsPair) {
        float dot = 0.0f;
#pragma unroll
        for (int t = 0; t < NPL; ++t) dot += cv[u][0][t] * cv[u][1][t];
        pred = group_sum<G>(dot);
        if (use_linear) pred += __shfl_sync(kFullMask, cw[u][0] + cw[u][1], grp * G);
      } else {
        float qq = -sq[u];
#pragma unroll
        for (int t = 0; t < NPL; ++t) qq += vs[u][t] * vs[u][t];
        pred = 0.5f * group_sum<G>(qq);
        if (use_linear) pred += __shfl_sync(kFullMask, wx[u], grp * G);
      }
      if (use_bias) pred += w0;
      mult[u] = m[u] != 0.0f ? multiplier(pred, yv[u], task, min_t, max_t) : 0.0f;
      if (gl == 0 && live[u]) {
        msum += mult[u];
        cnt += m[u];
      }
    }

    // the update rows: the kept rows when the whole row fits in one chunk
    if (nchunk == 1) {
#pragma unroll
      for (int j = 0; j < LR; ++j) {
        if (j >= L) break;
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (!live[u]) continue;
          float* out = upd + (long long)co[u][j] * d;
          if constexpr (kIsPair) {
            const int o = 1 - j;  // the other entry of the pair
            if (gl == 0)
              out[0] = use_linear ? -lr1 * (mult[u] + regw * cw[u][j] * m[u]) : -lr1 * 0.0f;
#pragma unroll
            for (int t = 0; t < NPL; ++t) {
              const int f = gl + G * t;
              if (f < k)
                out[1 + f] = -lr2 * (mult[u] * cv[u][o][t] + regv * cv[u][j][t] * m[u]);
            }
          } else {
            const float x = cx[u][j];
            const float em = ones ? m[u] : (x != 0.0f ? 1.0f : 0.0f);
            if (gl == 0) {
              const float g = use_linear
                  ? (ones ? mult[u] : mult[u] * x) + regw * cw[u][j] * em : 0.0f;
              out[0] = -lr1 * g;
            }
#pragma unroll
            for (int t = 0; t < NPL; ++t) {
              const int f = gl + G * t;
              if (f < k) {
                const float v = cv[u][j][t];
                const float g = (ones ? mult[u] * (vs[u][t] - v)
                                      : mult[u] * (vs[u][t] * x - v * (x * x)))
                                + regv * v * em;
                out[1 + f] = -lr2 * g;
              }
            }
          }
        }
      }
    } else {  // rows longer than LR entries: gather them again
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (!live[u]) continue;
        for (int l = 0; l < L; ++l) {
          const long long e = row[u] * L + l;
          const float* p = P + (long long)ids[e] * d;
          const float x = ones ? 1.0f : vals[e];
          const float em = ones ? m[u] : (x != 0.0f ? 1.0f : 0.0f);
          float* out = upd + (order ? (long long)order[e] : e) * d;
          if (gl == 0) {
            const float g = use_linear
                ? (ones ? mult[u] : mult[u] * x) + regw * p[0] * em : 0.0f;
            out[0] = -lr1 * g;
          }
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const int f = gl + G * t;
            if (f < k) {
              const float v = p[1 + f];
              const float g = (ones ? mult[u] * (vs[u][t] - v)
                                    : mult[u] * (vs[u][t] * x - v * (x * x)))
                              + regv * v * em;
              out[1 + f] = -lr2 * g;
            }
          }
        }
      }
    }
  }
  libfm::cp_async_wait<0>();  // the fetches past the last item

  // this CTA's sum of mult and real-row count, lanes and warps in a fixed order
  msum = libfm::warp_sum(msum);
  cnt = libfm::warp_sum(cnt);
  if (lane == 0) {
    s_m[warp] = msum;
    s_c[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, b = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      a += s_m[w];
      b += s_c[w];
    }
    part[2 * blockIdx.x] = a;
    part[2 * blockIdx.x + 1] = b;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last CTA: the partials in CTA order (strided sums, then a tree)
  __threadfence();
  float a = 0.0f, b = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    a += __ldcg(part + 2 * i);
    b += __ldcg(part + 2 * i + 1);
  }
  t_m[threadIdx.x] = a;
  t_c[threadIdx.x] = b;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      t_m[threadIdx.x] += t_m[threadIdx.x + s];
      t_c[threadIdx.x] += t_c[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float r0 = t_m[0], r1 = t_c[0];
    red[0] = r0;
    red[1] = r1;
    if (update_w0) {
      // w0 - lr0 * (red0 + red1 * reg0 * w0) as XLA rounds JAX's line on
      // the CPU (and kernels/sgd_step.py's sgd_w0_update): red1 * reg0,
      // then two fused multiply-adds, each rounded once
      const float g = __fmaf_rn(__fmul_rn(r1, reg0), w0, r0);
      *w0p = __fmaf_rn(-lr0, g, w0);
    }
    *ticket = 0;
  }
}

template <int G, int NPL, int LR, int R>
int launch(const float* P, const int* ids, const float* vals, const float* y,
           const unsigned char* row_mask, const int* order, float* w0p, float* upd,
           float* scratch, float* red, int B, int L, int k, int mode, int task,
           int use_linear, int use_bias, int update_w0, float lr0, float reg0, float lr1,
           float lr2, float regw, float regv, float min_t, float max_t,
           cudaStream_t stream) {
  constexpr auto kernel = sgd_step_kernel<G, NPL, LR, R>;
  constexpr int T = Shape<G, NPL, LR, R>::kTileRows;
  unsigned grid;
  const cudaError_t err =
      libfm::one_wave_grid<kernel>(kThreads, 0, ((long long)B + T - 1) / T, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid > (unsigned)kMaxParts) grid = kMaxParts;
  int* ticket = reinterpret_cast<int*>(scratch + 2 * kMaxParts);
  return (int)libfm::launch_pdl(kernel, grid, kThreads, stream, P, ids, vals, y, row_mask,
                                 order, w0p, upd, scratch, ticket, red, B, L, k, mode, task,
                                 use_linear, use_bias, update_w0, lr0, reg0, lr1, lr2, regw,
                                 regv, min_t, max_t);
}

}  // namespace

// Floats of scratch a call needs: the CTA partials and the ticket.
extern "C" int sgd_step_scratch_floats() { return 2 * kMaxParts + 4; }

// P [n, d]; ids, vals [B, L]; y, row_mask [B]; order [B, L] (the sorted
// position of each entry's update row, or NULL for entry order); w0p ->
// w0 (updated in place when update_w0); upd [B*L, d]; scratch
// [sgd_step_scratch_floats()], zero before the first call (each call
// leaves its ticket zero); red [2].
extern "C" int sgd_step_launch(const float* P, const int* ids, const float* vals,
                               const float* y, const unsigned char* row_mask,
                               const int* order, float* w0p, float* upd, float* scratch,
                               float* red, int B, int L, int d, int mode, int task,
                               int use_linear, int use_bias, int update_w0, float lr0,
                               float reg0, float lr1, float lr2, float regw, float regv,
                               float min_t, float max_t, cudaStream_t stream) {
  const int k = d - 1;
  if (k < 1 || k > kMaxK || B < 1 || L < 1 || (long long)B * L > 0x7fffffffLL ||
      mode < kPair || mode > kGeneral || (mode == kPair && L != 2))
    return (int)cudaErrorInvalidValue;
#define SGD_STEP_LAUNCH(G, NPL, LR, R)                                                   \
  launch<G, NPL, LR, R>(P, ids, vals, y, row_mask, order, w0p, upd, scratch, red, B, L, \
                        k, mode, task, use_linear, use_bias, update_w0, lr0, reg0, lr1,  \
                        lr2, regw, regv, min_t, max_t, stream)
  if (mode == kPair) {
    if (k <= 8) return SGD_STEP_LAUNCH(8, 1, 2, 2);
    if (k <= 16) return SGD_STEP_LAUNCH(16, 1, 2, 2);
    if (k <= 32) return SGD_STEP_LAUNCH(32, 1, 2, 2);
    if (k <= 64) return SGD_STEP_LAUNCH(32, 2, 2, 2);
    return SGD_STEP_LAUNCH(32, 4, 2, 2);
  }
  if (k <= 8) return SGD_STEP_LAUNCH(8, 1, 16, 1);
  if (k <= 16) return SGD_STEP_LAUNCH(16, 1, 16, 1);
  if (k <= 32) return SGD_STEP_LAUNCH(32, 1, 16, 1);
  if (k <= 64) return SGD_STEP_LAUNCH(32, 2, 8, 1);
  return SGD_STEP_LAUNCH(32, 4, 8, 1);
#undef SGD_STEP_LAUNCH
}
