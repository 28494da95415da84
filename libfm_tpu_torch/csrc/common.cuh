// Shared helpers of the port's kernels (fp32 on the CUDA cores; no TF32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace libfm {

// Largest number of latent factors the kernels take (k <= 128, d <= 129).
constexpr int kMaxK = 128;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Position of (i, j), i <= j, in np.triu_indices(k) order: the packed
// upper triangle of the per-feature Gram in a GG row.
__host__ __device__ __forceinline__ int tri_index(int i, int j, int k) {
  return i * k - (i * (i - 1)) / 2 + (j - i);
}

// Floats in one GG row: [Qq upper triangle | qa | qe | aa | ae].
__host__ __device__ __forceinline__ int gg_width(int k) {
  return k * (k + 1) / 2 + 2 * k + 2;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// ---- cp.async (sm_80+): global -> shared copies that bypass registers.
// A thread's copies are visible to it after cp_async_wait; other threads
// see them after a barrier (__syncwarp / __syncthreads) that follows.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes; src_bytes == 0 reads nothing and writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 16 bytes; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp copies n floats from src (4-byte aligned) to shared memory at
// base16 (16-byte aligned, room for n + 3 floats) with cp.async: 16-byte
// pieces where the source is aligned, 4-byte pieces at either end. The
// row keeps its source's offset within 16 bytes; returns where element 0
// lands. Every lane of the warp calls it.
__device__ __forceinline__ float* warp_copy_row(float* base16, const float* src, int n,
                                                int lane) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* dst = base16 + mis;
  const int head = min((4 - mis) & 3, n);
  const int nbody = (n - head) >> 2;
  const int tail = head + 4 * nbody;
  if (lane < head) cp_async4(dst + lane, src + lane);
  for (int c = lane; c < nbody; c += kWarp)
    cp_async16(dst + head + 4 * c, src + head + 4 * c);
  if (lane < n - tail) cp_async4(dst + tail + lane, src + tail + lane);
  return dst;
}

// ---- Hopper bulk copies (TMA without a tensor map) and mbarriers.
// A bulk copy moves `bytes` (a multiple of 16, both addresses 16-byte
// aligned) between global and shared memory; loads complete on an
// mbarrier's transaction count, stores in bulk groups of the issuing
// thread. Shared-memory writes by ordinary stores must be fenced
// (fence_proxy_async) before a bulk store reads them.

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The L2 policy for the .L2::cache_hint forms of data read or written
// once: evict first.
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// The L2 policy of data read again and again: evict last.
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// Global -> shared, completing on `bar`, under L2 policy `pol`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(pol)
      : "memory");
}

// Shared -> global, in this thread's current bulk group, under L2 policy `pol`.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes,
                                           uint64_t pol) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are unfinished.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (0 is __syncthreads) over `threads` threads, a
// multiple of 32, of the CTA.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- Programmatic dependent launch (sm_90). A grid launched with
// launch_pdl may start while the grid before it on the stream still runs;
// grid_dep_wait blocks until that grid has finished and its writes are
// visible, so every thread calls it before it touches what an earlier
// grid wrote. grid_dep_launch lets the next grid start launching; it does
// so once every CTA of this grid has called it (or exited), that is once
// all of this grid's CTAs are resident.

__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... Params, typename... Args>
inline cudaError_t launch_pdl(void (*kernel)(Params...), unsigned grid, unsigned block,
                              cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The grid of `kKernel` (`threads` a CTA, `smem` bytes of dynamic shared
// memory) for `wanted` CTAs, capped at one wave: the CTAs resident on the
// current device at once. A grid whose CTAs wait on one another
// (table_scatter's look-back) needs the cap, or a waiting CTA could hold
// the SM that the CTA it waits for needs; a persistent grid takes one
// wave. Above the default 48 KB the kernel is first allowed `smem` bytes.
// The occupancy is asked once for each (device, threads, smem) of the last
// kKeep seen.
template <auto kKernel>
inline cudaError_t one_wave_grid(int threads, int smem, long long wanted, unsigned* grid) {
  struct Seen {
    int dev, threads, smem, sms, resident;
  };
  constexpr int kKeep = 16, kDevices = 64;
  static Seen seen[kKeep];
  static int allowed[kDevices], next;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  int i = 0;
  while (i < kKeep && !(seen[i].resident > 0 && seen[i].dev == dev &&
                        seen[i].threads == threads && seen[i].smem == smem))
    ++i;
  if (i == kKeep) {
    if (smem > 48 * 1024 && smem > allowed[dev]) {
      if ((err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem)) != cudaSuccess)
        return err;
      allowed[dev] = smem;
    }
    int n = 0, occ = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kKernel, threads,
                                                             (size_t)smem)) != cudaSuccess)
      return err;
    i = next;
    next = (next + 1) % kKeep;
    seen[i] = {dev, threads, smem, n, occ > 0 ? occ : 1};
  }
  const long long wave = (long long)seen[i].sms * seen[i].resident;
  *grid = (unsigned)(wanted < 1 ? 1 : wanted < wave ? wanted : wave);
  return cudaSuccess;
}

// ---- Probit classification (the JAX package's ops/samplers.py), in the
// plain versions' order of operations (libfm_tpu_torch/ops/samplers.py):
// no FMA contraction where they round twice.

constexpr float kSqrt2 = 1.41421356237309515f;
constexpr float kInvSqrt2 = 0.70710678118654757f;
// nextafter(1, 0): the inverse-CDF draw keeps u inside (-1, 1), where
// erfinvf is finite (erff rounds to exactly +-1 from |x| ~ 3.83 on)
constexpr float kOneBelow = 0.99999994f;

// Phi(x) >= 0.5 predicts y > 0, Phi(x) < 0.5 predicts y < 0; 1 if right.
__device__ __forceinline__ float probit_correct(float pred, float y) {
  const float p = __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(pred, kInvSqrt2))));
  return ((p >= 0.5f && y > 0.0f) || (p < 0.5f && y < 0.0f)) ? 1.0f : 0.0f;
}

// phi(a) / (1 - Phi(a)): erfc up to a = 6, the asymptotic series above.
__device__ __forceinline__ float normal_hazard(float a) {
  if (a > 6.0f) {
    const float a3 = __fmul_rn(__fmul_rn(a, a), a);
    const float a5 = __fmul_rn(__fmul_rn(a3, a), a);
    return __fadd_rn(__fsub_rn(__fadd_rn(a, __fdiv_rn(1.0f, a)), __fdiv_rn(2.0f, a3)),
                     __fdiv_rn(10.0f, a5));
  }
  const float pdf = __fdiv_rn(expf(__fmul_rn(__fmul_rn(-0.5f, a), a)), 2.50662827463100024f);
  return __fdiv_rn(pdf, fmaxf(__fmul_rn(0.5f, erfcf(__fmul_rn(a, kInvSqrt2))), 1e-38f));
}

// The probit latent of a case with prediction `pred` and target y: a draw
// of N(pred, 1) truncated to [0, inf) when y >= 0, to (-inf, 0] else,
// from the uniform u in [0, 1) by jax.random.truncated_normal's inverse
// CDF; or (sample false) the truncated normal's expectation.
__device__ __forceinline__ float probit_latent(float pred, float y, float u, bool sample) {
  if (!sample)
    return y >= 0.0f ? __fadd_rn(pred, normal_hazard(-pred))
                     : __fsub_rn(pred, normal_hazard(pred));
  const float inf = __int_as_float(0x7f800000);
  const float lo = y >= 0.0f ? -pred : -inf;
  const float hi = y >= 0.0f ? inf : -pred;
  const float a = erff(__fmul_rn(lo, kInvSqrt2));
  const float b = erff(__fmul_rn(hi, kInvSqrt2));
  float v = fmaxf(a, __fadd_rn(__fmul_rn(u, __fsub_rn(b, a)), a));
  v = fminf(fmaxf(v, -kOneBelow), kOneBelow);
  float z = __fmul_rn(kSqrt2, erfinvf(v));
  z = fminf(fmaxf(z, nextafterf(lo, inf)), nextafterf(hi, -inf));
  return __fadd_rn(pred, z);
}

// The compile-time widths the kernels are built for; the launchers take
// the one chosen on the host (kernels.padded_width) and check it.
// kmin = 0 for the flat engine's kernels, which take the pure linear
// model (k = 0) at the first width; the BS kernels keep k >= 1
__host__ __forceinline__ bool valid_padded_width(int kp, int k, int kmin = 1) {
  return (kp == 16 || kp == 32 || kp == 64 || kp == 128) && k >= kmin && k <= kp &&
         (kp == 16 || k > kp / 2);
}

// ---- SGDA (libfm_tpu/learners/sgda.py): sgda_step.cu and sgda_lambda.cu

// The sum over a lane group of G lanes (G a power of two dividing 32,
// groups aligned in the warp); every lane of the warp calls it and every
// lane of a group gets its group's sum.
template <int G>
__device__ __forceinline__ float lane_group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// SGDA's loss derivative (sgda.py:39-44, adapt_reg.h:139-144):
// 2 (clamp(pred) - y) for regression (task 0), y (sigmoid(y pred) - 1)
// for classification.
__device__ __forceinline__ float sgda_multiplier(float pred, float y, int task, float min_t,
                                                 float max_t) {
  if (task == 0) return 2.0f * (fminf(fmaxf(pred, min_t), max_t) - y);
  return y * (1.0f / (1.0f + expf(-y * pred)) - 1.0f);
}

// The multiprocessors of the current device, asked once a device.
inline cudaError_t device_sms(int* sms) {
  constexpr int kDevices = 64;
  static int cached[kDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

}  // namespace libfm
