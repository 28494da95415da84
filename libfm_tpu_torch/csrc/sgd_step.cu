// sgd_step: one mini-batch SGD step of the FM on the packed table
// P = [w | V] [n, 1+k], up to the scatter: the gather, the prediction, the
// multiplier and the per-entry update rows.
//
// Replaces the hand-laid chunk body K8 of libfm_tpu/learners/sgd.py:128-213
// (`pair_step` and `packed_step`, modes "pair", "onehot" and "general"),
// the exact fm_SGD formulas (libFM fm_sgd.h:33-51):
//   pred  = w0 + sum_l w x + 1/2 (|sum_l v x|^2 - sum_l |v x|^2)
//           (pair mode: w0 + w_u + w_i + v_u . v_i, the direct product)
//   mult  = clamp(pred, min, max) - y   (regression)
//         = -y (1 - sigmoid(y pred))     (classification), 0 on padded rows
//   upd_w = -lr1 (mult x + regw w m),  upd_v = -lr2 (mult (vsum x - v x^2) + regv v m)
// with the entry mask m = row mask in pair and onehot modes and x != 0 in
// general mode. The update rows go out in entry order [B*L, 1+k]; the
// table_scatter kernel then applies them in the host-presorted order.
// The batch's sum of mult and its count of real rows go to red[2]: each
// CTA writes a partial, and a second, one-CTA launch adds the partials
// in a fixed order, so the sums do not depend on scheduling (no atomics).
//
// Bound on the H100: bytes. A step reads the batch (ids, vals, y, mask:
// 9 B per entry + 5 B per row), gathers B*L table rows and writes B*L
// update rows ((1+k)*4 B each). The table (3 MB at config #1, 4.4 MB at
// config #4b) stays in the 50 MB L2.
// Layout: one warp per row, lanes over the 1+k columns (5 per lane at
// most, k <= 128). Pass 1 gathers the row's entries and forms vsum, the
// squared sum and the linear term by warp shuffles; pass 2 gathers them
// again (L2 hits) and writes the update rows, so no per-row buffer caps L.
// Pair mode keeps both rows in registers and does one pass.
// Element offsets are int64.

#include "common.cuh"

namespace {

using libfm::kMaxK;
using libfm::kWarp;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kCols = (kMaxK + 1 + kWarp - 1) / kWarp;
constexpr int kPair = 0, kOnehot = 1, kGeneral = 2;

__device__ __forceinline__ float multiplier(float pred, float y, int task,
                                            float min_t, float max_t) {
  if (task == 0) return fminf(fmaxf(pred, min_t), max_t) - y;
  return -y * (1.0f - 1.0f / (1.0f + expf(-y * pred)));
}

__global__ void __launch_bounds__(kThreads)
sgd_step_kernel(const float* __restrict__ P, const int* __restrict__ ids,
                const float* __restrict__ vals, const float* __restrict__ y,
                const unsigned char* __restrict__ row_mask,
                const float* __restrict__ w0p, float* __restrict__ upd,
                float* __restrict__ part, int B, int L, int d, int mode,
                int task, int use_linear, int use_bias, float lr1, float lr2,
                float regw, float regv, float min_t, float max_t) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = gridDim.x * kWarps;
  const float w0 = use_bias ? *w0p : 0.0f;
  float msum = 0.0f, cnt = 0.0f;
  for (int r = blockIdx.x * kWarps + warp; r < B; r += nwarps) {
    const float m = row_mask[r] ? 1.0f : 0.0f;
    const float yr = y[r];
    const long long e0 = (long long)r * L;
    float mult;
    if (mode == kPair) {
      const float* pu = P + (long long)ids[e0] * d;
      const float* pi = P + (long long)ids[e0 + 1] * d;
      float a[kCols], b[kCols];
      float dot = 0.0f;
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = lane + kWarp * t;
        a[t] = c < d ? pu[c] : 0.0f;
        b[t] = c < d ? pi[c] : 0.0f;
        if (c > 0) dot += a[t] * b[t];
      }
      dot = libfm::warp_sum(dot);
      float pred = dot;
      if (use_linear)
        pred += __shfl_sync(0xffffffffu, a[0], 0) + __shfl_sync(0xffffffffu, b[0], 0);
      if (use_bias) pred += w0;
      mult = m != 0.0f ? multiplier(pred, yr, task, min_t, max_t) : 0.0f;
      float* uu = upd + e0 * d;
      float* ui = uu + d;
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = lane + kWarp * t;
        if (c == 0) {
          uu[0] = use_linear ? -lr1 * (mult + regw * a[0] * m) : -lr1 * 0.0f;
          ui[0] = use_linear ? -lr1 * (mult + regw * b[0] * m) : -lr1 * 0.0f;
        } else if (c < d) {
          uu[c] = -lr2 * (mult * b[t] + regv * a[t] * m);
          ui[c] = -lr2 * (mult * a[t] + regv * b[t] * m);
        }
      }
    } else {
      const bool onehot = mode == kOnehot;
      float vs[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) vs[t] = 0.0f;
      float sq = 0.0f, wx = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float* p = P + (long long)ids[e0 + l] * d;
        const float x = onehot ? 1.0f : vals[e0 + l];
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int c = lane + kWarp * t;
          if (c == 0) {
            wx += onehot ? p[0] : p[0] * x;
          } else if (c < d) {
            const float vx = onehot ? p[c] : p[c] * x;
            vs[t] += vx;
            sq += vx * vx;
          }
        }
      }
      float qq = 0.0f;
#pragma unroll
      for (int t = 0; t < kCols; ++t) qq += vs[t] * vs[t];
      qq = libfm::warp_sum(qq);
      sq = libfm::warp_sum(sq);
      wx = __shfl_sync(0xffffffffu, wx, 0);
      float pred = 0.5f * (qq - sq);
      if (use_linear) pred += wx;
      if (use_bias) pred += w0;
      mult = m != 0.0f ? multiplier(pred, yr, task, min_t, max_t) : 0.0f;
      for (int l = 0; l < L; ++l) {
        const float* p = P + (long long)ids[e0 + l] * d;
        const float x = onehot ? 1.0f : vals[e0 + l];
        const float em = onehot ? m : (x != 0.0f ? 1.0f : 0.0f);
        float* u = upd + (e0 + l) * d;
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int c = lane + kWarp * t;
          if (c == 0) {
            const float g = use_linear
                ? (onehot ? mult : mult * x) + regw * p[0] * em : 0.0f;
            u[0] = -lr1 * g;
          } else if (c < d) {
            const float v = p[c];
            const float g = (onehot ? mult * (vs[t] - v)
                                    : mult * (vs[t] * x - v * (x * x)))
                            + regv * v * em;
            u[c] = -lr2 * g;
          }
        }
      }
    }
    msum += mult;
    cnt += m;
  }

  // this CTA's sum of mult and real-row count, warps in a fixed order
  __shared__ float s_m[kWarps], s_c[kWarps];
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
  }
}

// One CTA: red = the sum of the CTAs' partials, in a fixed order.
__global__ void __launch_bounds__(kThreads)
sgd_step_sums(const float* __restrict__ part, int nblk, float* __restrict__ red) {
  __shared__ float t_m[kThreads], t_c[kThreads];
  float a = 0.0f, b = 0.0f;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    a += part[2 * i];
    b += part[2 * i + 1];
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
    red[0] = t_m[0];
    red[1] = t_c[0];
  }
}

}  // namespace

// P [n, d]; ids, vals [B, L]; y, row_mask [B]; w0p -> w0; upd [B*L, d];
// part scratch [2 grid]; red [2].
extern "C" int sgd_step_launch(const float* P, const int* ids, const float* vals,
                               const float* y, const unsigned char* row_mask,
                               const float* w0p, float* upd, float* part,
                               float* red, int B, int L,
                               int d, int mode, int task, int use_linear,
                               int use_bias, float lr1, float lr2, float regw,
                               float regv, float min_t, float max_t, int grid,
                               cudaStream_t stream) {
  if (d < 1 || d > kMaxK + 1 || B < 1 || L < 1 || grid < 1 || mode < kPair ||
      mode > kGeneral || (mode == kPair && L != 2))
    return (int)cudaErrorInvalidValue;
  sgd_step_kernel<<<grid, kThreads, 0, stream>>>(
      P, ids, vals, y, row_mask, w0p, upd, part, B, L, d, mode, task,
      use_linear, use_bias, lr1, lr2, regw, regv, min_t, max_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sgd_step_sums<<<1, kThreads, 0, stream>>>(part, grid, red);
  return (int)cudaGetLastError();
}
