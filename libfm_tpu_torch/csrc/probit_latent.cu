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
// with e' written back into A[r, 0] and latent' into latent[r].
//
// Bound on the H100 at config #4 (1.8M cases): bytes, e read and written
// (a 4-byte piece of each 68-byte A row: every 32-byte sector of A is
// touched, so the strided column costs A's size, 122 MB, both ways)
// plus latent, y and U: ~0.09 ms. Design: a grid-stride loop, one case
// a thread, the truncated-normal draw of common.cuh; per-CTA partial
// counts summed in a fixed order by the wrapper (no atomics).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    probit_latent_kernel(float* __restrict__ A, int d, float* __restrict__ latent,
                         const float* __restrict__ y, const float* __restrict__ U,
                         long long nc, int sample, float* __restrict__ part, int npart) {
  float correct = 0.0f;
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x; r < nc;
       r += (long long)gridDim.x * kThreads) {
    const float yr = y[r];
    const float pred = A[r * d] + latent[r];
    correct += libfm::probit_correct(pred, yr);
    const float lat = libfm::probit_latent(pred, yr, sample ? U[r] : 0.0f, sample != 0);
    A[r * d] = pred - lat;
    latent[r] = lat;
  }
  __shared__ float warp_part[kThreads / libfm::kWarp];
  correct = libfm::warp_sum(correct);
  if (threadIdx.x % libfm::kWarp == 0) warp_part[threadIdx.x / libfm::kWarp] = correct;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / libfm::kWarp; ++w) s += warp_part[w];
    part[blockIdx.x] = s;
    if (blockIdx.x == 0)
      for (int b = gridDim.x; b < npart; ++b) part[b] = 0.0f;
  }
}

}  // namespace

// A [nc, d] (the residual is column 0, stride d floats); latent, y [nc];
// U [nc] when sample != 0 (uniforms in [0, 1)), else unused. Writes every
// entry of part [npart], those past the grid with 0: their sum is the
// number of correct cases.
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
