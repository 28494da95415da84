// fm_refresh: FM forward over padded rows; rewrites the per-case cache
// A = [e | Q] (train) or writes the predictions (test).
//
// Replaces, in libfm_tpu/learners/mcmc_vector.py, refresh_A_and_train_metric
// (regression), _chunk_pred_q and predict_padded: a row gather of the
// packed table P = [w | V] over the [nr, L] padded case layout, then
//   pred = w0 + sum_l w x + 1/2 (|sum_l v x|^2 - sum_l |v x|^2),  Q = sum_l v x.
// Train mode writes A[r] = [pred - y | Q] and a per-block partial of the
// clipped squared error (clip(pred, min, max) - y)^2; test mode writes pred.
// The probit train mode (classification, K5b: the probit branch of
// refresh_A_and_train_metric) draws each case's latent instead, from the
// uniform U[r] (probit 1: N(pred, 1) truncated to the side of 0 that y's
// sign gives) or as the truncated normal's expectation (probit 2, ALS),
// writes latent[r] and A[r] = [pred - latent | Q], and sums the correct
// cases (Phi(pred) >= 0.5 against y's sign) in place of the squared error.
//
// Bound on the H100: bytes. Train mode moves ids + vals (8 L B/row), y
// (4 B/row) and the A write ((k+1)*4 B/row, 2.34 GB at ML-10M, k=64),
// besides the P rows it gathers (n*(k+1)*4 B, 21.4 MB there). Test mode
// writes 4 B/row, so it is latency- and launch-bound: each row is a chain
// ids load -> P row gathers -> sums. The P rows do not stay in L2 under
// the A stream: on the H100 at config #3 (chip_smoke.py's
// gather-against-streaming line) train mode takes 1.02 ms with every id
// on row 0 (hot in L1), 1.37 on the first 1,024 rows (hot in L2) and
// 1.61 with the real ids.
// Design: lane groups of KP lanes (8, or 16 above k=64), NPL factors a
// lane; a group carries R rows at once (4, or 2 above k=16) and issues
// the P-row gathers of all of them, two ids at a time, before the first
// FMA, so several L2 round trips overlap. Narrow groups keep the work of
// a row to few instructions: at k=64 one shuffle serves 4 rows and a
// row's sums take 3 levels, in one reduction of |Q|^2 - sum |v x|^2 (one
// warp a row, 32 lanes, took 10 shuffles a row). Both modes are issue-
// and latency-bound well before the memory is: a first design of this
// layout with 32-lane groups ran 2.20 ms (train) and 0.19 ms (test) at
// config #3. Each warp stages its rows' ids and values, kChunk columns
// at a time, and in train mode their y, by coalesced cp.async into a ring
// of kDepth slots in shared memory, kDepth items ahead (one item ahead in
// registers left the DRAM latency of y and ids exposed: 1.79 against
// 1.61 ms in train mode at config #3). Train mode stages each warp's
// [RW, k+1] output rows in shared memory (two buffers a warp) and writes
// them with a 1-D bulk store (TMA) from one lane, under an evict-first L2
// policy (5% faster than without at config #3; an L2 policy on the P
// gathers instead slowed both modes by a third); ragged last rows go out
// by plain stores. Nothing but the final error sum synchronises a CTA's
// warps, so their gathers and stores overlap.
// The error partials are per CTA, each summed in a fixed order; no
// atomics. A persistent grid of one wave of resident CTAs.
// Element offsets are int64: nr * (k+1) passes 2^31 at 33M rows.
// The pure linear model (k = 0, P = [w], A = [e]) runs the k <= 8
// instance: its factor loops read nothing, pred = w0 + sum w x.

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kMaxK;
using libfm::kWarp;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kChunk = 8;  // columns of a row staged at a time
constexpr int kDepth = 3;  // items (a pass's chunk of columns) staged ahead

// KP lanes a row, R rows a lane group at once
template <int KP, int R>
struct Shape {
  static constexpr int kGroups = kWarp / KP;
  static constexpr int kWarpRows = kGroups * R;         // a warp's rows in a pass
  static constexpr int kTileRows = kWarps * kWarpRows;  // a CTA's rows in a pass
  static constexpr int kStaged = kWarpRows * kChunk;    // (id, value) pairs a warp stages
  static constexpr int kPerLane = kStaged / kWarp;
  static constexpr int kSlot = 2 * kStaged + kWarpRows;  // ids, values, y
  static_assert(kWarpRows % 4 == 0, "a warp's rows of A are whole 16-byte pieces");
};

template <int KP>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = KP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <int KP, int R>
size_t smem_bytes(bool train, int d) {
  using S = Shape<KP, R>;
  return (train ? 2 * (size_t)S::kTileRows * d * 4 : 0) +
         (size_t)kWarps * kDepth * S::kSlot * 4;
}

template <int KP, int NPL, int R>
__global__ void __launch_bounds__(kThreads)
fm_refresh_kernel(const float* __restrict__ P, const int* __restrict__ ids,
                  const float* __restrict__ vals, const float* __restrict__ y,
                  const float* __restrict__ w0p, float* __restrict__ A,
                  float* __restrict__ pred_out, float* __restrict__ sse_part,
                  const float* __restrict__ U, float* __restrict__ latent,
                  long long nr, int L, int k, int use_linear, int use_bias,
                  float min_t, float max_t, int npart, int probit) {
  using S = Shape<KP, R>;
  constexpr int T = S::kTileRows;
  constexpr int RW = S::kWarpRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane / KP;
  const int gl = lane % KP;
  const int d = k + 1;
  const bool train = A != nullptr;
  // train: each warp's two [RW, d] output tiles
  float* out = reinterpret_cast<float*>(smem) + warp * 2 * RW * d;
  const float w0 = use_bias ? *w0p : 0.0f;
  const uint64_t pol = train ? libfm::policy_evict_first() : 0;
  const long long npass = (nr + T - 1) / T;
  const int nchunk = L > kChunk ? (L + kChunk - 1) / kChunk : 1;  // L = 0: one empty

  // The warp's items (pass, chunk) in order, kDepth ahead: item i's ids
  // and values (lane j copies the pairs e = j + 32 m: row e / kChunk of the
  // warp, column e % kChunk of the chunk), and in train mode on a pass's
  // first chunk the rows' y, land by cp.async in slot i % kDepth of the
  // warp's ring. Padding reads nothing and lands as zeros.
  float* ring = reinterpret_cast<float*>(smem) + (train ? 2 * T * d : 0) +
                warp * kDepth * S::kSlot;
  long long fpass = blockIdx.x;  // the next item to fetch
  int fch = 0;
  auto fetch = [&](float* slot) {
    const long long rw0 = fpass * T + warp * RW;
    const bool live = fpass < npass;
#pragma unroll
    for (int m = 0; m < S::kPerLane; ++m) {
      const int e = lane + kWarp * m;
      const int j = fch * kChunk + e % kChunk;
      const long long r = rw0 + e / kChunk;
      const bool ok = live && j < L && r < nr;
      const long long off = ok ? r * L + j : 0;
      libfm::cp_async4(slot + e, reinterpret_cast<const float*>(ids + off), ok ? 4 : 0);
      libfm::cp_async4(slot + S::kStaged + e, vals + off, ok ? 4 : 0);
    }
    if (train && lane < RW) {
      const bool ok = live && fch == 0 && rw0 + lane < nr;
      libfm::cp_async4(slot + 2 * S::kStaged + lane, y + (ok ? rw0 + lane : 0), ok ? 4 : 0);
    }
    libfm::cp_async_commit();
    if (++fch == nchunk) {
      fch = 0;
      fpass += gridDim.x;
    }
  };
#pragma unroll
  for (int i = 0; i < kDepth; ++i) fetch(ring + i * S::kSlot);

  float sse = 0.0f;
  long long it = 0;
  int item = 0;  // slot of the current item
  for (long long pass = blockIdx.x; pass < npass; pass += gridDim.x, ++it) {
    const long long r0 = pass * T;
    const long long rw0 = r0 + warp * RW;
    float* o = out + (it & 1) * RW * d;
    if (train) {
      // the warp's bulk store of two passes ago has read this buffer
      if (lane == 0) libfm::bulk_wait_read<1>();
      __syncwarp();
    }
    float yl = 0.0f;
    float q[R][NPL], sq[R], wx[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      sq[u] = wx[u] = 0.0f;
#pragma unroll
      for (int t = 0; t < NPL; ++t) q[u][t] = 0.0f;
    }
    for (int ch = 0; ch < nchunk; ++ch) {
      libfm::cp_async_wait<kDepth - 1>();  // this item's copies have landed
      __syncwarp();
      float* slot = ring + item * S::kSlot;
      const float* sx = slot + S::kStaged;
      if (train && ch == 0 && lane < RW) yl = slot[2 * S::kStaged + lane];
      const int lc = min(kChunk, L - ch * kChunk);
#pragma unroll 2
      for (int j = 0; j < lc; ++j) {
        float pw[R], xs[R], pv[R][NPL];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int e = (grp * R + u) * kChunk + j;
          const float* p = P + (long long)__float_as_int(slot[e]) * d;
          xs[u] = sx[e];
          pw[u] = p[0];
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const int f = gl + KP * t;
            pv[u][t] = f < k ? p[1 + f] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          wx[u] += pw[u] * xs[u];
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const float vx = pv[u][t] * xs[u];
            q[u][t] += vx;
            sq[u] += vx * vx;
          }
        }
      }
      __syncwarp();  // every lane is done with the slot: refill it
      fetch(slot);
      item = item + 1 == kDepth ? 0 : item + 1;
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      // |Q|^2 - sum_l |v x|^2, summed over the group's lanes in one go
      float qq = -sq[u];
#pragma unroll
      for (int t = 0; t < NPL; ++t) qq += q[u][t] * q[u][t];
      float pred = 0.5f * group_sum<KP>(qq);
      if (use_linear) pred += wx[u];
      if (use_bias) pred += w0;
      const int i = grp * R + u;  // the row within the warp's rows
      const long long r = rw0 + i;
      if (train) {
        const float yr = __shfl_sync(kFullMask, yl, i);
        float* a = o + i * d;
        if (r < nr) {
          if (gl == 0) {
            if (probit) {
              const float lat =
                  libfm::probit_latent(pred, yr, probit == 1 ? U[r] : 0.0f, probit == 1);
              a[0] = pred - lat;
              latent[r] = lat;
              sse += libfm::probit_correct(pred, yr);
            } else {
              a[0] = pred - yr;
              const float err = fminf(fmaxf(pred, min_t), max_t) - yr;
              sse += err * err;
            }
          }
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const int f = gl + KP * t;
            if (f < k) a[1 + f] = q[u][t];
          }
        }
      } else if (gl == 0 && r < nr) {
        pred_out[r] = pred;
      }
    }
    if (train) {
      libfm::fence_proxy_async();
      __syncwarp();
      const long long rows = nr - rw0 < RW ? nr - rw0 : RW;
      if (rows == RW) {
        if (lane == 0) {
          libfm::bulk_store(A + rw0 * d, o, (unsigned)(RW * d * 4), pol);
          libfm::bulk_commit();
        }
      } else {  // the ragged last rows
        for (long long e = lane; e < rows * d; e += kWarp) A[rw0 * d + e] = o[e];
      }
    }
  }
  libfm::cp_async_wait<0>();  // the fetches past the last item
  if (train) {
    if (lane == 0) libfm::bulk_wait<0>();
    __shared__ float part[kWarps];
    sse = libfm::warp_sum(sse);
    if (lane == 0) part[warp] = sse;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += part[w];
      sse_part[blockIdx.x] = s;
      if (blockIdx.x == 0)
        for (int b = gridDim.x; b < npart; ++b) sse_part[b] = 0.0f;
    }
  }
}

template <int KP, int NPL, int R>
int launch(const float* P, const int* ids, const float* vals, const float* y,
           const float* w0p, float* A, float* pred_out, float* sse_part, const float* U,
           float* latent, long long nr, int L, int k, int use_linear, int use_bias,
           float min_t, float max_t, int npart, int probit, cudaStream_t stream) {
  const bool train = A != nullptr;
  const int d = k + 1;
  const size_t smem = smem_bytes<KP, R>(train, d);  // < 48 KB for every k <= kMaxK
  auto kernel = fm_refresh_kernel<KP, NPL, R>;
  // per mode and width d: resident CTAs an SM (0 = not yet asked)
  static int sms = 0;
  static int resident[2][kMaxK + 2] = {};
  cudaError_t err;
  if (resident[train][d] == 0) {
    int dev;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    int occ = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                             smem)) != cudaSuccess)
      return (int)err;
    resident[train][d] = occ > 0 ? occ : 1;
  }
  constexpr int T = Shape<KP, R>::kTileRows;
  const long long npass = (nr + T - 1) / T;
  long long grid = (long long)sms * resident[train][d];
  if (grid > npass) grid = npass > 0 ? npass : 1;
  if (train && grid > npart) grid = npart;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(P, ids, vals, y, w0p, A, pred_out,
                                                     sse_part, U, latent, nr, L, k,
                                                     use_linear, use_bias, min_t, max_t,
                                                     npart, probit);
  return (int)cudaGetLastError();
}

}  // namespace

// Train mode: A != NULL (16-byte aligned; y and sse_part [npart]
// required; every entry of sse_part is written, those past the grid with
// 0). Test mode: A == NULL, pred_out [nr] required. w0p points at the
// device scalar w0. probit (train mode only): 0 regression, 1 latents
// drawn from U [nr], 2 latents as expectations; latent [nr] required.
extern "C" int fm_refresh_launch(const float* P, const int* ids,
                                 const float* vals, const float* y,
                                 const float* w0p, float* A, float* pred_out,
                                 float* sse_part, const float* U, float* latent,
                                 long long nr, int L, int k, int use_linear,
                                 int use_bias, float min_t, float max_t, int npart,
                                 int probit, cudaStream_t stream) {
  const bool train = A != nullptr;
  if (k < 0 || k > kMaxK || L < 0 || probit < 0 || probit > 2 ||
      (train && ((reinterpret_cast<uintptr_t>(A) & 15) != 0 || npart < 1)) ||
      (probit && (!train || latent == nullptr || (probit == 1 && U == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (nr == 0 && !train) return (int)cudaSuccess;
#define FM_REFRESH_LAUNCH(KP, NPL, R)                                                  \
  launch<KP, NPL, R>(P, ids, vals, y, w0p, A, pred_out, sse_part, U, latent, nr, L, k,  \
                     use_linear, use_bias, min_t, max_t, npart, probit, stream)
  if (k <= 8) return FM_REFRESH_LAUNCH(8, 1, 4);
  if (k <= 16) return FM_REFRESH_LAUNCH(8, 2, 4);
  if (k <= 32) return FM_REFRESH_LAUNCH(8, 4, 2);
  if (k <= 64) return FM_REFRESH_LAUNCH(8, 8, 2);
  return FM_REFRESH_LAUNCH(16, 8, 2);
#undef FM_REFRESH_LAUNCH
}
