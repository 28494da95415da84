// probit_latent's traffic without its math: the floor its memory access
// sets on the card (libfm_tpu_torch/studies/probit_latent_floor.py).
//
// col_rmw reads and writes column 0 of A [nc, d] (stride d floats), reads
// latent, y and U [nc] and writes latent, one case a thread over a
// grid-stride loop, as csrc/probit_latent.cu does; with d = 1 the column
// is a vector of its own. rows_rmw reads and writes every float of A (16
// bytes a thread) beside the same vectors: what streaming A's whole rows
// costs. The arithmetic is a few adds, so that each value is used.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    col_rmw(float* __restrict__ A, int d, float* __restrict__ latent,
            const float* __restrict__ y, const float* __restrict__ U, long long nc) {
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x; r < nc;
       r += (long long)gridDim.x * kThreads) {
    const float l = latent[r], u = U[r];
    A[r * d] = A[r * d] + l - y[r];
    latent[r] = l + u;
  }
}

__global__ void __launch_bounds__(kThreads)
    rows_rmw(float4* __restrict__ A4, long long n4, float* __restrict__ latent,
             const float* __restrict__ y, const float* __restrict__ U, long long nc) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n4; i += stride) {
    float4 a = A4[i];
    a.x += 1.0f;
    a.y += 1.0f;
    a.z += 1.0f;
    a.w += 1.0f;
    A4[i] = a;
  }
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x; r < nc; r += stride) {
    const float l = latent[r];
    latent[r] = l + U[r] - y[r];
  }
}

}  // namespace

// rows == 0: col_rmw on A's column 0 (stride d); rows != 0: rows_rmw over
// A's nc * d floats (a multiple of 4, A 16-byte aligned). grid CTAs of 256.
extern "C" int probit_floor_launch(float* A, int d, float* latent, const float* y,
                                   const float* U, long long nc, int grid, int rows,
                                   cudaStream_t stream) {
  if (d < 1 || grid < 1 || nc < 0) return (int)cudaErrorInvalidValue;
  if (rows) {
    if ((nc * d) % 4 != 0 || reinterpret_cast<unsigned long long>(A) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    rows_rmw<<<grid, kThreads, 0, stream>>>(reinterpret_cast<float4*>(A), nc * d / 4,
                                            latent, y, U, nc);
  } else {
    col_rmw<<<grid, kThreads, 0, stream>>>(A, d, latent, y, U, nc);
  }
  return (int)cudaGetLastError();
}
