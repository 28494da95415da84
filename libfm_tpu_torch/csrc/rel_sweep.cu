// rel_stats and rel_resync: the relational (BS) engine's sweep over one
// relation (K10).
//
// Replace, in libfm_tpu/learners/mcmc_rel_vector.py `sweep_relation`, the
// per-block `block_step`: its `corrected` caches, `mom_chunk` moments and
// the reconstruction of GG (rel_stats); and `resync_chunk`, `resync_te`
// and the deferred `_te_chunk` (rel_resync). Its `upd_chunk`, the draw's
// shift into SD, runs inside schur_draw's relational form
// (schur_draw.cu).
//
// rel_stats, per feature j of one conflict-free block, over its entries
// (b, x): the caches of row b corrected by SD[b] = [s | dQB] from the frozen
// ones C[b] = [we0 | we2_0 | SQ0 | SQe0 | SQQ0 (T)] and wnum[b],
//   SQ = SQ0 + wnum dQB, we = we0 + wnum s + SQ0 . dQB,
//   SQe = SQe0 + s SQ0 + SQQ0 dQB + dQB we,
//   SQQ = SQQ0 + dQB SQ0^T + SQ0 dQB^T + wnum dQB dQB^T,
// summed x-power weighted into the moments M2 = sum x^2 SQQ, S2 = sum x^2
// SQ, S3 = sum x^3 SQ, SQe = sum x SQe, m2, m3, m4 = sum x^2, x^3, x^4
// wnum, mxe = sum x we, m2e = sum x^2 we; then GG's row [Qq (T) | qa | qe |
// aa | ae] with Qq = M2 - v S3^T - S3 v^T + m4 v v^T, qa = S2 - m3 v,
// qe = SQe - m2e v, aa = m2, ae = mxe (qa, aa, ae 0 without the linear
// term), v the feature's pre-draw factors. The moments never leave the CTA.
// rel_resync, per case c of row m = map[c]: e += s_m + dQB_m . Q (the Q
// before the update), Q += dQB_m; or (read-only) return e + s_m + dQB_m . Q.
//
// Bounds on the H100. rel_stats: bytes, writing GG (T + 2k + 2 floats a
// feature: 45 MB an iteration at bench_bs's 19,147 features, k = 32) and
// reading each entry's cache row (2.4 KB, L2-resident: C is 9.5 MB);
// ~0.014 ms an iteration at 3.35 TB/s. rel_resync: bytes, the
// map and A's row read (and written back) a case, and the SD rows (L2).
// Design. rel_stats (redesigned for the H100): one CTA a feature (128
// threads up to k = 32, eight CTAs an SM, so that bench_bs's blocks of
// ~1,000 features take one wave; 256 above), its v staged at once and
// its entries taken in batches of `nbatch`, sized by k on the
// host (kernels/rel_sweep.py `stats_batch`: 8 entries up to k = 24, 4 at
// k = 32, 1 from k = 52, so that a batch's rows stay near 12 KB). A
// batch's cache rows, SD rows and wnum are staged in shared memory with
// cp.async (16-byte pieces where the row allows, 4-byte ones at its ends:
// C's rows start on 4- or 8-byte boundaries), one warp an entry, every
// copy issued before any is used; the next batch is staged while this one
// is summed (two buffers), so a feature's entries cost one round of loads,
// not several round trips each. Per batch, all threads form each staged
// entry's (SQQ0 dQB)_i, one thread an (entry, i), and the warps the dots
// SQ0 . dQB and we; then each thread adds x^2 SQQ to the upper-triangle
// moments it owns in registers (up to 33 at k = 128), threads i < k the
// vector moments, thread 0 the scalars, the entries in order from shared
// memory. Each sum is taken in the first version's order (the same
// operations in the same order: the same bits). The reconstruction reads
// S3, m4, m2e, m3 and v from shared memory and writes the GG row. No
// atomics, the same bits every run; a long feature is one CTA's loop over
// its batches, with no CTA waiting on another. rel_resync: one warp a
// case, lanes over the factors, the dot product by warp shuffles.

#include "common.cuh"

namespace {

using libfm::kMaxK;
using libfm::kWarp;
using libfm::round4;
using libfm::tri_index;
using libfm::warp_sum;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kLaneFactors = kMaxK / kWarp;  // 4
constexpr int kMaxBatch = kWarps;            // entries a batch: one warp stages each

__host__ __device__ constexpr int tri_count(int k) { return k * (k + 1) / 2; }

// Floats of one staged entry: its cache row, then its SD row, each with
// room to keep its source's offset within 16 bytes.
__host__ __device__ inline int stats_slot(int k) {
  return round4(2 + 2 * k + tri_count(k) + 3) + round4(k + 1 + 3);
}

// rel_stats' CTA: 128 threads up to k = 32 (8 CTAs an SM, so that a
// block's ~1,000 features at bench_bs take one wave), 256 above.
__host__ __device__ constexpr int stats_threads(int kp) { return kp <= 32 ? 128 : 256; }
__host__ __device__ constexpr int stats_min_ctas(int kp) { return kp <= 32 ? 8 : 1; }

template <int KP>
__global__ void __launch_bounds__(stats_threads(KP), stats_min_ctas(KP))
    rel_stats_kernel(const float* __restrict__ C, const float* __restrict__ SD,
                     const float* __restrict__ wnum, const long long* __restrict__ feat_off,
                     const int* __restrict__ entry_b, const float* __restrict__ entry_x,
                     const int* __restrict__ feat_id, const float* __restrict__ P,
                     float* __restrict__ GG, int k, int use_linear, int nbatch) {
  constexpr int kThreads = stats_threads(KP);
  constexpr int kWarps = kThreads / kWarp;
  constexpr int kPer = (tri_count(KP) + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float stage[];  // [2][nbatch][stats_slot(k)]
  __shared__ float s_mv[kMaxBatch][KP];          // a batch's (SQQ0 dQB)
  __shared__ float s_we[kMaxBatch], s_wn[2][kMaxBatch], s_x[2][kMaxBatch];
  __shared__ int s_c[2][kMaxBatch], s_sd[2][kMaxBatch];  // rows' offsets in `stage`
  __shared__ float s_S3[KP], s_v[KP];
  __shared__ float s_scal[4];  // at the end: m4, m2e, m3
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int T = tri_count(k);
  const int d = k + 1;
  const int cw = 2 + 2 * k + T;
  const int slot = stats_slot(k);
  // the feature's pre-draw v, for the reconstruction: its own copy group
  if (tid < k) libfm::cp_async4(&s_v[tid], P + (long long)feat_id[f] * d + 1 + tid);
  libfm::cp_async_commit();
  int pij[kPer];  // the (i, g) this thread owns in each slot, packed i | g << 8
  float M2[kPer];
  int row = 0, row_start = 0;  // the triangle's row of the slot, walked on from slot to slot
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    M2[j] = 0.0f;
    const int t = tid + j * kThreads;
    pij[j] = 0;
    if (t < T) {
      while (t - row_start >= k - row) {
        row_start += k - row;
        ++row;
      }
      pij[j] = row | (row + t - row_start) << 8;
    }
  }
  float S2 = 0.0f, S3 = 0.0f, SQe = 0.0f;           // thread i < k: factor i
  float m2 = 0.0f, m3 = 0.0f, m4 = 0.0f, mxe = 0.0f, m2e = 0.0f;  // thread 0
  const long long e_beg = feat_off[f], e_end = feat_off[f + 1];
  const long long batches = (e_end - e_beg + nbatch - 1) / nbatch;

  // stage batch t's rows into buffer t & 1 (every thread commits a group)
  auto issue = [&](long long t) {
    const int buf = (int)(t & 1);
    const long long e0 = e_beg + t * nbatch;
    const int n = (int)min((long long)nbatch, e_end - e0);
    for (int j = warp; j < n; j += kWarps) {
      const int b = entry_b[e0 + j];
      float* base = stage + (buf * nbatch + j) * slot;
      const float* c = libfm::warp_copy_row(base, C + (long long)b * cw, cw, lane);
      const float* sd = libfm::warp_copy_row(base + round4(cw + 3), SD + (long long)b * d, d,
                                             lane);
      if (lane == 0) {
        libfm::cp_async4(&s_wn[buf][j], wnum + b);
        s_x[buf][j] = entry_x[e0 + j];
        s_c[buf][j] = (int)(c - stage);
        s_sd[buf][j] = (int)(sd - stage);
      }
    }
    libfm::cp_async_commit();
  };

  if (batches > 0) issue(0);
  for (long long t = 0; t < batches; ++t) {
    const int buf = (int)(t & 1);
    const int n = (int)min((long long)nbatch, e_end - e_beg - t * nbatch);
    if (t + 1 < batches) {
      issue(t + 1);  // its buffer was freed by the barrier that ended batch t - 1
      libfm::cp_async_wait<1>();
    } else {
      libfm::cp_async_wait<0>();
    }
    __syncthreads();  // batch t staged and visible
    // each entry's SQ0 . dQB (a warp, as the first version's warp 0) and we
    for (int j = warp; j < n; j += kWarps) {
      const float* c = stage + s_c[buf][j];
      const float* sd = stage + s_sd[buf][j];
      float p = 0.0f;
      for (int i = lane; i < k; i += kWarp) p = fmaf(c[2 + i], sd[1 + i], p);
      p = warp_sum(p);
      // we = we0 + wnum s + SQ0 . dQB
      if (lane == 0) s_we[j] = __fadd_rn(__fadd_rn(c[0], __fmul_rn(s_wn[buf][j], sd[0])), p);
    }
    // each entry's (SQQ0 dQB)_i over the packed triangle, a thread an (entry, i)
    for (int q = tid; q < n * k; q += kThreads) {
      const int j = q / k, i = q - j * k;
      const float* sqq0 = stage + s_c[buf][j] + 2 + 2 * k;
      const float* dq = stage + s_sd[buf][j] + 1;
      // g ascending, as the first version: (g, i) in row g while g < i,
      // then (i, g) in row i; one loop, so a warp's threads keep in step
      const int ii = tri_index(i, i, k);
      float mv = 0.0f;
      for (int g = 0, gg = 0; g < k; gg += k - g, ++g)  // gg = tri_index(g, g)
        mv = fmaf(sqq0[g < i ? gg + (i - g) : ii + (g - i)], dq[g], mv);
      s_mv[j][i] = mv;
    }
    __syncthreads();
    // the moments, the entries in order
    for (int j = 0; j < n; ++j) {
      const float* c = stage + s_c[buf][j];
      const float* sd = stage + s_sd[buf][j];
      const float* sq0v = c + 2;
      const float* dqv = sd + 1;
      const float x = s_x[buf][j], wn = s_wn[buf][j], we = s_we[j], s = sd[0];
      const float x2 = __fmul_rn(x, x);
      if (tid < k) {
        const float sq0 = sq0v[tid], dq = dqv[tid];
        const float SQc = fmaf(wn, dq, sq0);
        // SQe0 + s SQ0 + SQQ0 dQB + dQB we
        const float SQec = __fadd_rn(
            __fadd_rn(__fadd_rn(c[2 + k + tid], __fmul_rn(s, sq0)), s_mv[j][tid]),
            __fmul_rn(dq, we));
        S2 = fmaf(x2, SQc, S2);
        S3 = fmaf(__fmul_rn(x2, x), SQc, S3);
        SQe = fmaf(x, SQec, SQe);
      }
      if (tid == 0) {
        const float x3 = __fmul_rn(x2, x), x4 = __fmul_rn(x2, x2);
        m2 = fmaf(x2, wn, m2);
        m3 = fmaf(x3, wn, m3);
        m4 = fmaf(x4, wn, m4);
        mxe = fmaf(x, we, mxe);
        m2e = fmaf(x2, we, m2e);
      }
      const float* sqq0 = c + 2 + 2 * k;
#pragma unroll
      for (int jj = 0; jj < kPer; ++jj) {
        const int tt = tid + jj * kThreads;
        if (tt < T) {
          const int i = pij[jj] & 0xff, g = pij[jj] >> 8;
          const float dqi = dqv[i], dqg = dqv[g];
          float q = __fadd_rn(sqq0[tt], __fmul_rn(dqi, sq0v[g]));
          q = __fadd_rn(q, __fmul_rn(sq0v[i], dqg));
          q = __fadd_rn(q, __fmul_rn(wn, __fmul_rn(dqi, dqg)));
          M2[jj] = fmaf(x2, q, M2[jj]);
        }
      }
    }
    __syncthreads();  // batch t's buffer, s_we and s_mv are read
  }
  // the reconstruction, with the feature's pre-draw v (staged at the start)
  libfm::cp_async_wait<0>();
  if (tid < k) s_S3[tid] = S3;
  if (tid == 0) {
    s_scal[0] = m4;
    s_scal[1] = m2e;
    s_scal[2] = m3;
  }
  __syncthreads();
  const float M4 = s_scal[0], M2E = s_scal[1], M3 = s_scal[2];
  float* g = GG + (long long)f * (T + 2 * k + 2);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int t = tid + j * kThreads;
    if (t < T) {
      const int i = pij[j] & 0xff, q = pij[j] >> 8;
      const float vi = s_v[i], vq = s_v[q];
      float r = __fsub_rn(M2[j], __fmul_rn(vi, s_S3[q]));
      r = __fsub_rn(r, __fmul_rn(s_S3[i], vq));
      g[t] = __fadd_rn(r, __fmul_rn(M4, __fmul_rn(vi, vq)));
    }
  }
  if (tid < k) {
    const float v = s_v[tid];
    g[T + tid] = use_linear ? __fsub_rn(S2, __fmul_rn(M3, v)) : 0.0f;
    g[T + k + tid] = __fsub_rn(SQe, __fmul_rn(M2E, v));
  }
  if (tid == 0) {
    g[T + 2 * k] = use_linear ? m2 : 0.0f;
    g[T + 2 * k + 1] = use_linear ? mxe : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    rel_resync_kernel(const float* __restrict__ SD, const int* __restrict__ row_map,
                      float* __restrict__ A, float* __restrict__ out, long long nc, int k) {
  const long long c = (blockIdx.x * (long long)kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  if (c >= nc) return;
  const int d = k + 1;
  const float* sd = SD + (long long)row_map[c] * d;
  float* a = A + c * d;
  float dq[kLaneFactors], q[kLaneFactors];
  const float a0 = a[0];
  float p = 0.0f;
#pragma unroll
  for (int i = 0; i < kLaneFactors; ++i) {
    const int f = lane + kWarp * i;
    dq[i] = q[i] = 0.0f;
    if (f < k) {
      dq[i] = sd[1 + f];
      q[i] = a[1 + f];
      p = fmaf(dq[i], q[i], p);
    }
  }
  p = warp_sum(p);  // every lane has read its part of a
  const float e = __fadd_rn(__fadd_rn(a0, sd[0]), p);
  if (out != nullptr) {
    if (lane == 0) out[c] = e;
    return;
  }
#pragma unroll
  for (int i = 0; i < kLaneFactors; ++i) {
    const int f = lane + kWarp * i;
    if (f < k) a[1 + f] = __fadd_rn(q[i], dq[i]);
  }
  if (lane == 0) a[0] = e;
}

}  // namespace

// GG [F, T+2k+2] out; C [nb+1, 2+2k+T], SD [nb+1, k+1], wnum [nb+1];
// feat_off int64 [F+1] over entry_b int32 / entry_x [E]; feat_id int32 [F]
// rows of P [n, k+1]; kp the padded width (16, 32, 64 or 128) holding k;
// nbatch (1 to 8) the entries a CTA stages at once, in two buffers of
// nbatch * stats_slot(k) floats of dynamic shared memory.
extern "C" int rel_stats_launch(const float* C, const float* SD, const float* wnum,
                                const long long* feat_off, const int* entry_b,
                                const float* entry_x, const int* feat_id, const float* P,
                                float* GG, int F, int k, int kp, int use_linear, int nbatch,
                                cudaStream_t stream) {
  constexpr size_t kMaxDynamic = 200 * 1024;
  if (!libfm::valid_padded_width(kp, k) || F < 0 || nbatch < 1 || nbatch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * nbatch * stats_slot(k) * sizeof(float);
  if (smem > kMaxDynamic) return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
#define REL_STATS_LAUNCH(KP)                                                                 \
  do {                                                                                       \
    constexpr int kDevices = 64;                                                             \
    static size_t opted[kDevices];                                                           \
    if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;                      \
    if (smem > opted[dev]) { /* the largest area asked for so far, once a size */            \
      err = cudaFuncSetAttribute(rel_stats_kernel<KP>,                                       \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);   \
      if (err != cudaSuccess) return (int)err;                                              \
      opted[dev] = smem;                                                                     \
    }                                                                                        \
    rel_stats_kernel<KP><<<(unsigned)F, stats_threads(KP), smem, stream>>>(                  \
        C, SD, wnum, feat_off, entry_b, entry_x, feat_id, P, GG, k, use_linear, nbatch);    \
  } while (0)
  switch (kp) {
    case 16: REL_STATS_LAUNCH(16); break;
    case 32: REL_STATS_LAUNCH(32); break;
    case 64: REL_STATS_LAUNCH(64); break;
    default: REL_STATS_LAUNCH(128); break;
  }
#undef REL_STATS_LAUNCH
  return (int)cudaGetLastError();
}

// A [nc, k+1] updated in place (out == NULL), or left as it is with
// out [nc] = e + s + dQB . Q (read-only); row_map int32 [nc] rows of SD.
extern "C" int rel_resync_launch(const float* SD, const int* row_map, float* A, float* out,
                                 long long nc, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || nc < 0) return (int)cudaErrorInvalidValue;
  if (nc == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((nc + kWarps - 1) / kWarps);
  rel_resync_kernel<<<grid, kThreads, 0, stream>>>(SD, row_map, A, out, nc, k);
  return (int)cudaGetLastError();
}
