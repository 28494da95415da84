// probit_latent: the probit latents' resample between two refreshes
// (classification), in place on the residual column of A = [e | Q].
//
// Replaces, in libfm_tpu/learners/mcmc_vector.py, one_step's
// classification fast path (K5b): the sweeps keep e = pred - latent
// current, so per train case
//   pred = e + latent,  correct += [Phi(pred) >= 0.5 against y's sign],
//   latent' = a draw of N(pred, 1) truncated to the side of 0 that y's
//             sign gives, from the uniform U[r] (or its expectation, ALS),
//   e' = pred - latent',
// with e' written back into A[r, 0] and latent' into latent[r]. The same
// pass sums e' and e'^2 (each square capped at 1e30, a non-finite one
// counted as 1e30: draw_alpha's rule), which the next iteration's alpha
// and w0 draws take instead of reading A's column again.
//
// Bound on the H100 at config #4 (1.8M cases): bytes, e read and written
// (a 4-byte piece of each 68-byte A row: every 32-byte sector of A is
// touched, so the strided column costs A's size, 122 MB, both ways)
// plus latent, y and U: ~0.09 ms. Design: a grid-stride loop, one case
// a thread, the truncated-normal draw of common.cuh; per-CTA partials of
// the correct count and the two sums, in registers, summed in a fixed
// order by the wrapper (no atomics: the same bits on every run).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 3;  // the correct count, sum e', sum of capped e'^2

__global__ void __launch_bounds__(kThreads)
    probit_latent_kernel(float* __restrict__ A, int d, float* __restrict__ latent,
                         const float* __restrict__ y, const float* __restrict__ U,
                         long long nc, int sample, float* __restrict__ part, int npart) {
  float sums[kSums] = {0.0f, 0.0f, 0.0f};
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x; r < nc;
       r += (long long)gridDim.x * kThreads) {
    const float yr = y[r];
    const float pred = A[r * d] + latent[r];
    sums[0] += libfm::probit_correct(pred, yr);
    const float lat = libfm::probit_latent(pred, yr, sample ? U[r] : 0.0f, sample != 0);
    const float e = pred - lat;
    A[r * d] = e;
    latent[r] = lat;
    sums[1] += e;
    const float e2 = __fmul_rn(e, e);
    sums[2] += isfinite(e2) ? fminf(e2, 1e30f) : 1e30f;
  }
  __shared__ float warp_part[kSums][kThreads / libfm::kWarp];
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const float v = libfm::warp_sum(sums[i]);
    if (threadIdx.x % libfm::kWarp == 0) warp_part[i][threadIdx.x / libfm::kWarp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    const int i = threadIdx.x;
    float s = 0.0f;
    for (int w = 0; w < kThreads / libfm::kWarp; ++w) s += warp_part[i][w];
    part[i * npart + blockIdx.x] = s;
    if (blockIdx.x == 0)
      for (int b = gridDim.x; b < npart; ++b) part[i * npart + b] = 0.0f;
  }
}

}  // namespace

// A [nc, d] (the residual is column 0, stride d floats); latent, y [nc];
// U [nc] when sample != 0 (uniforms in [0, 1)), else unused. Writes every
// entry of part [3, npart], those past the grid with 0: its rows' sums are
// the number of correct cases, the sum of the new e and that of its
// capped squares.
extern "C" int probit_latent_launch(float* A, int d, float* latent, const float* y,
                                    const float* U, long long nc, int sample, float* part,
                                    int npart, cudaStream_t stream) {
  if (d < 1 || npart < 1 || (sample && U == nullptr)) return (int)cudaErrorInvalidValue;
  long long grid = (nc + kThreads - 1) / kThreads;
  if (grid > npart) grid = npart;
  if (grid < 1) grid = 1;
  probit_latent_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(A, d, latent, y, U, nc,
                                                                sample, part, npart);
  return (int)cudaGetLastError();
}
