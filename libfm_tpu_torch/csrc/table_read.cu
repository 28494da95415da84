// table_read: repeated random row reads of a table, summed per lane,
// with a carried accumulator:
//   S_r[c]      = sum_{i < n_used} T[(ids[i] + r) % nsub][c]
//   acc_{r+1}   = scale * acc_r + S_r,   acc_0 = 0,   out = acc_reps.
//
// Replaces the Pallas probes studies/pallas_gather.py:79 (P1,
// make_read_kernel, scale 8: each of its 8 unrolled accumulators starts
// from the carried acc, so a rep adds 8 acc + S_r) and :147 (P3,
// make_take_kernel, scale 1, chunked `take`).
//
// The TPU kernel walks the ids in order on one core with the table in
// VMEM. Here the work is cut into CTAs over (id range, rep); each warp
// sums its ids' rows with lanes over the columns, the CTA adds its warps
// in a fixed order and writes one lane partial per (rep, CTA). A second,
// one-CTA launch adds the partials of each rep in CTA order and runs the
// reps' carries. The result does not depend on scheduling (no atomics).
//
// Bound on the H100: bytes. At the studies' shape (T 10256 x 128 f32,
// 5.25 MB, 16384 ids, 20 reps) the inputs are read from HBM once; the
// 20 x 16384 row reads (168 MB) hit the 50 MB L2, which stands in for
// the TPU kernel's VMEM (no SM's shared memory holds the table).
// Offsets into T are int64.

#include "common.cuh"

namespace {

using libfm::kWarp;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kCols = 4;  // columns per lane in one tile
constexpr int kTile = kWarp * kCols;

__global__ void __launch_bounds__(kThreads)
table_read_partials(const float* __restrict__ T, const int* __restrict__ ids,
                    long long n_used, int nsub, int W, long long per_cta,
                    float* __restrict__ part) {
  __shared__ float wsum[kWarps][kTile];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int r = blockIdx.y;
  const long long lo = (long long)blockIdx.x * per_cta;
  const long long hi = min(lo + per_cta, n_used);
  float* out = part + ((long long)r * gridDim.x + blockIdx.x) * W;
  for (int c0 = 0; c0 < W; c0 += kTile) {
    float acc[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[t] = 0.0f;
#pragma unroll 4
    for (long long i = lo + warp; i < hi; i += kWarps) {
      const long long row = ((long long)ids[i] + r) % nsub;
      const float* p = T + row * W;
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = c0 + lane + kWarp * t;
        if (c < W) acc[t] += p[c];
      }
    }
#pragma unroll
    for (int t = 0; t < kCols; ++t) wsum[warp][lane + kWarp * t] = acc[t];
    __syncthreads();
    for (int c = threadIdx.x; c < kTile && c0 + c < W; c += kThreads) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += wsum[w][c];
      out[c0 + c] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
table_read_combine(const float* __restrict__ part, int nblk, int reps, int W,
                   float scale, float* __restrict__ out) {
  for (int c = threadIdx.x; c < W; c += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < reps; ++r) {
      float s = 0.0f;
#pragma unroll 8
      for (int b = 0; b < nblk; ++b) s += part[((long long)r * nblk + b) * W + c];
      acc = scale * acc + s;
    }
    out[c] = acc;
  }
}

}  // namespace

// T [nsub, W]; ids [>= n_used]; part scratch [reps, nblk, W]; out [W].
extern "C" int table_read_launch(const float* T, const int* ids, float* part,
                                 float* out, long long n_used, int nsub, int W,
                                 int reps, float scale, int nblk,
                                 long long per_cta, cudaStream_t stream) {
  if (W < 1 || nsub < 1 || reps < 1 || nblk < 1 || reps > 65535)
    return (int)cudaErrorInvalidValue;
  table_read_partials<<<dim3(nblk, reps), kThreads, 0, stream>>>(
      T, ids, n_used, nsub, W, per_cta, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  table_read_combine<<<1, kThreads, 0, stream>>>(part, nblk, reps, W, scale, out);
  return (int)cudaGetLastError();
}
