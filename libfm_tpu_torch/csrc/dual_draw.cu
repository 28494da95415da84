// dual_draw: joint draw of theta_j = (w_j, v_j) per feature through the
// c x c Woodbury (dual) system of its c slots, with the Cholesky
// factorisation and both triangular solves fused in.
//
// Replaces, in libfm_tpu/learners/mcmc_vector.py, sweep_block.dual_chunk
// (its `_slot_hM` rows included), together with libfm_tpu/ops/lane_chol.py
// cholesky_lanes and cho_solve_lanes. Per feature, with v = theta_old[1:]
// (the pre-draw factors), x_s and the A row [e_s | Q_s] of slot s:
//   h_s   = x_s [1 | Q_s - x_s v]    (h_s[0] = 0 when use_linear is off)
//   D^-1  = 1 / lam,  Phi = sqrt(alpha) h
//   ytil_s = sqrt(alpha) (h_s . (theta_old - mu) - e_s)
//   K     = Phi D^-1 Phi^T + I = L L^T                      (c x c)
//   u'    = sqrt(D^-1) u,  v_s = Phi_s . u' + dl_s   (0 and 0 under ALS)
//   w     = K^-1 (ytil - v),  theta = mu + u' + D^-1 Phi^T w
// A non-finite theta, or one with |theta| > bound, keeps the old theta and
// sets the feature's reject flag. The noise u and dl comes from the
// caller's generator, so the kernel is deterministic. The JAX engine pads
// each segment to its bucket's width W; here every feature runs at its
// real count c, which gives the same theta (a padding slot has h = 0 and
// e = 0: its row of K is a row of I and its noise never reaches theta).
//
// Bound on the H100 at config #5 (k=128, ~890K dual features of 1 to 32
// slots, 5.06M slots an iteration): bytes, the A row of every slot (516 B)
// and its case, value and noise dl (12 B), theta_old/lam/mu/u/theta_new
// a feature (2,580 B): 4.98 GB = 1.49 ms at 3.35 TB/s; the FLOPs (the
// Gram, c(c+1)/2 dot products of length d a feature, h, the c^3/3
// factorisation and the solves), 14 GFLOP = 0.21 ms at 67 TFLOP/s.
// chip_smoke.py counts both from the run's data. The kernel is bound by
// latency: each feature is a chain of dependent steps (the slot ids, the
// A rows, the warp sums, c steps of the factorisation and of each solve),
// so the design puts as many features in flight as the SM holds.
//
// Design (Hopper, fp32 FMA on the CUDA cores, no TF32):
// - One warp per feature, up to 16 warps a CTA, each warp with its own
//   shared area sized by its feature's own count; the warps never wait
//   for each other (only __syncwarp and shuffles inside a feature). Most
//   features are tiny (a third of #5's have c <= 2, 81% c <= 8), so a CTA
//   a feature would leave the SMs idle, and an area sized for the longest
//   list would let few warps onto an SM. The host's plan
//   (kernels/dual_draw.py DualPlan, made once a block) packs the features
//   in order into CTAs whose areas fit the CTA's memory, which holds 4
//   areas of the longest list: 4 features of 32 slots a CTA, or 16 of 8.
// - The warp starts a cp.async copy of each slot's A row into its H area
//   (lanes over the row, 4-byte pieces: rows are 516 B at d=129, so they
//   rarely start on 16 bytes), then reads theta_old, lam, mu and u while
//   the copies fly. h replaces the A rows in place.
// - The slots' ids, values and noise come in one read a lane (slots lane
//   and lane + 32) and go round by shuffles.
// - ytil and v are warp sums over the lanes' columns; each entry of K is
//   one warp sum of h_s D^-1 h_t (lanes over the d columns), four entries'
//   sums at a time so that their shuffles overlap.
// - K is factored in place column by column, lanes over rows; both
//   solves run on it the same way.
// - A feature's area: H [c][d], K [c rows of stride c | 1] (odd, so a
//   column read by the lanes over rows hits distinct banks), the
//   right-hand side [c]: 20.9 KB at c = 32, d = 129, 0.5 KB at c = 1.

#include <math.h>

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kWarp;
constexpr int kMaxC = 64;  // slots of a dual feature (the JAX engine's W <= 64)
constexpr int kNQ = (libfm::kMaxK + 1 + kWarp - 1) / kWarp;  // columns a lane
constexpr int kMaxWarps = 16;  // features a CTA holds at most
constexpr int kGramBatch = 4;  // entries of K whose warp sums run together
constexpr int kMaxSmem = 227 * 1024;  // shared memory a CTA may take

__device__ __forceinline__ float from_lane(float lo, float hi, int s) {
  return __shfl_sync(kFullMask, s < kWarp ? lo : hi, s & (kWarp - 1));
}

__global__ void __launch_bounds__(kMaxWarps * kWarp)
    dual_draw_kernel(const float* __restrict__ A, const long long* __restrict__ off,
                     const int* __restrict__ slot_case, const float* __restrict__ slot_val,
                     const float* __restrict__ theta, const float* __restrict__ lam,
                     const float* __restrict__ mu, const float* __restrict__ u,
                     const float* __restrict__ dl, const float* __restrict__ alpha_p,
                     const int* __restrict__ cta_first, const int* __restrict__ area,
                     float* __restrict__ out, int* __restrict__ rej, int d, int floats,
                     int sample, int use_linear, float bound) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int j = cta_first[blockIdx.x] + threadIdx.x / kWarp;
  if (j >= cta_first[blockIdx.x + 1]) return;  // the whole warp: no CTA barrier follows
  const long long s0 = off[j];
  const int c = static_cast<int>(off[j + 1] - s0);
  const int ldk = c | 1;  // odd, so the lanes' rows of a column hit distinct banks
  float* H = smem + area[j];
  float* K = H + c * d;
  float* rhs = K + c * ldk;
  // the plan gave the feature an area of c rows inside the CTA's memory
  if (c < 0 || c > kMaxC || area[j] + c * d + c * ldk + c > floats) __trap();

  // cases, values and noise: lane l holds slots l and l + 32
  int cs_lo = 0, cs_hi = 0;
  float x_lo = 0.f, x_hi = 0.f, dl_lo = 0.f, dl_hi = 0.f;
  if (lane < c) {
    cs_lo = slot_case[s0 + lane];
    x_lo = slot_val[s0 + lane];
    if (sample) dl_lo = dl[s0 + lane];
  }
  if (lane + kWarp < c) {
    cs_hi = slot_case[s0 + lane + kWarp];
    x_hi = slot_val[s0 + lane + kWarp];
    if (sample) dl_hi = dl[s0 + lane + kWarp];
  }
  for (int s = 0; s < c; ++s) {
    const int cs = __shfl_sync(kFullMask, s < kWarp ? cs_lo : cs_hi, s & (kWarp - 1));
    const float* row = A + static_cast<size_t>(cs) * d;
    for (int i = lane; i < d; i += kWarp) libfm::cp_async4(H + s * d + i, row + i);
  }
  libfm::cp_async_commit();

  // the feature's rows while the copies fly
  const size_t fr = static_cast<size_t>(j) * d;
  float th[kNQ], m[kNQ], dinv[kNQ], up[kNQ];
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
    const int i = lane + kWarp * q;
    th[q] = m[q] = dinv[q] = up[q] = 0.f;
    if (i < d) {
      th[q] = theta[fr + i];
      m[q] = mu[fr + i];
      dinv[q] = 1.0f / lam[fr + i];
      if (sample) up[q] = sqrtf(dinv[q]) * u[fr + i];
    }
  }
  const float alpha = *alpha_p;
  const float sqa = sqrtf(alpha);
  libfm::cp_async_wait<0>();
  __syncwarp();
  const float e_lo = lane < c ? H[lane * d] : 0.f;
  const float e_hi = lane + kWarp < c ? H[(lane + kWarp) * d] : 0.f;
  __syncwarp();

  // h in place of the A rows; rhs = ytil - v
  for (int s = 0; s < c; ++s) {
    const float x = from_lane(x_lo, x_hi, s);
    const float e = from_lane(e_lo, e_hi, s);
    const float noise = from_lane(dl_lo, dl_hi, s);
    float* hs = H + s * d;
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      const int i = lane + kWarp * q;
      if (i < d) {
        const float hv = i == 0 ? (use_linear ? x : 0.f) : x * (hs[i] - x * th[q]);
        hs[i] = hv;
        p1 += hv * (th[q] - m[q]);
        p2 += hv * up[q];
      }
    }
    p1 = libfm::warp_sum(p1);
    p2 = libfm::warp_sum(p2);
    if (lane == 0) rhs[s] = sqa * (p1 - e) - (sample ? sqa * p2 + noise : 0.f);
  }
  __syncwarp();

  // K = alpha h D^-1 h^T + I, lower triangle
  for (int s = 0; s < c; ++s) {
    const float* hs = H + s * d;
    float g[kNQ];
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      const int i = lane + kWarp * q;
      g[q] = i < d ? hs[i] * dinv[q] : 0.f;
    }
    // kGramBatch entries of the row at once: their warp sums interleave
    for (int t0 = 0; t0 <= s; t0 += kGramBatch) {
      float p[kGramBatch];
#pragma unroll
      for (int b = 0; b < kGramBatch; ++b) {
        const float* ht = H + min(t0 + b, s) * d;
        p[b] = 0.f;
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          const int i = lane + kWarp * q;
          if (i < d) p[b] += g[q] * ht[i];
        }
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
        for (int b = 0; b < kGramBatch; ++b) p[b] += __shfl_xor_sync(kFullMask, p[b], o);
      if (lane < kGramBatch) {
        float v = p[0];
#pragma unroll
        for (int b = 1; b < kGramBatch; ++b) v = lane == b ? p[b] : v;
        const int t = t0 + lane;
        if (t <= s) K[s * ldk + t] = alpha * v + (s == t ? 1.0f : 0.0f);
      }
    }
  }
  __syncwarp();

  // K = L L^T in place, column by column, lanes over rows. A pivot that is
  // not positive gives NaN or inf, and the guard rejects the draw.
  for (int jj = 0; jj < c; ++jj) {
    const float ljj = sqrtf(K[jj * ldk + jj]);
    const float inv = 1.0f / ljj;
    __syncwarp();
    if (lane == 0) K[jj * ldk + jj] = ljj;
    for (int r = jj + 1 + lane; r < c; r += kWarp) K[r * ldk + jj] *= inv;
    __syncwarp();
    for (int r = jj + 1 + lane; r < c; r += kWarp) {
      const float lrj = K[r * ldk + jj];
      for (int t = jj + 1; t <= r; ++t) K[r * ldk + t] -= lrj * K[t * ldk + jj];
    }
    __syncwarp();
  }
  // L y = rhs, then L^T w = y, in place
  for (int jj = 0; jj < c; ++jj) {
    const float y = rhs[jj] / K[jj * ldk + jj];
    __syncwarp();
    if (lane == 0) rhs[jj] = y;
    for (int r = jj + 1 + lane; r < c; r += kWarp) rhs[r] -= K[r * ldk + jj] * y;
    __syncwarp();
  }
  for (int jj = c - 1; jj >= 0; --jj) {
    const float w = rhs[jj] / K[jj * ldk + jj];
    __syncwarp();
    if (lane == 0) rhs[jj] = w;
    for (int r = lane; r < jj; r += kWarp) rhs[r] -= K[jj * ldk + r] * w;
    __syncwarp();
  }

  // theta = mu + u' + D^-1 Phi^T w, and the guard
  float nv[kNQ];
  bool ok = true;
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
    const int i = lane + kWarp * q;
    nv[q] = 0.f;
    if (i < d) {
      float acc = 0.f;
      for (int s = 0; s < c; ++s) acc += H[s * d + i] * rhs[s];
      nv[q] = m[q] + (up[q] + dinv[q] * (sqa * acc));
      ok = ok && fabsf(nv[q]) <= bound;  // false for NaN
    }
  }
  ok = __all_sync(kFullMask, ok);
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
    const int i = lane + kWarp * q;
    if (i < d) out[fr + i] = ok ? nv[q] : th[q];
  }
  if (lane == 0) rej[j] = ok ? 0 : 1;
}

}  // namespace

extern "C" int dual_draw_launch(const float* A, const long long* off, const int* slot_case,
                                const float* slot_val, const float* theta, const float* lam,
                                const float* mu, const float* u, const float* dl,
                                const float* alpha, const int* cta_first, const int* area,
                                float* out, int* rej, int ctas, int k, int floats, int sample,
                                int use_linear, float bound, cudaStream_t stream) {
  if (ctas <= 0) return 0;
  const int smem = floats * static_cast<int>(sizeof(float));
  if (k < 1 || k > libfm::kMaxK || floats < 1 || smem > kMaxSmem) return cudaErrorInvalidValue;
  const int d = k + 1;
  cudaError_t err = cudaFuncSetAttribute(
      dual_draw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified L1/shared memory as shared memory: as many CTAs
  // an SM as their areas allow
  err = cudaFuncSetAttribute(dual_draw_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dual_draw_kernel<<<static_cast<unsigned>(ctas), kMaxWarps * kWarp, smem, stream>>>(
      A, off, slot_case, slot_val, theta, lam, mu, u, dl, alpha, cta_first, area, out, rej,
      d, floats, sample, use_linear, bound);
  return cudaGetLastError();
}
