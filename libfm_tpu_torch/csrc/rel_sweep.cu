// rel_stats, rel_resync and rel_deferred: the relational (BS) engine's
// sweep over one relation (K10).
//
// Replace, in libfm_tpu/learners/mcmc_rel_vector.py `sweep_relation`, the
// per-block `block_step`: its `corrected` caches, `mom_chunk` moments and
// the reconstruction of GG (rel_stats); `resync_chunk`, `resync_te` and
// the deferred `_te_chunk` (rel_resync); and the deferred path's
// `_deferred_sums` (rel_deferred). Its `upd_chunk`, the draw's shift into
// SD, runs inside schur_draw's relational form (schur_draw.cu).
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
// rel_deferred, over every row b of C (the pad row too), in float64:
//   sum e   = sum_b we0 + wnum s + dQB . SQ0,
//   sum e^2 = sum_b we2_0 + 2 s we0 + 2 dQB . SQe0 + wnum s^2
//             + 2 s (dQB . SQ0) + dQB^T SQQ0 dQB,
// the last over the packed triangle, its off-diagonal terms twice.
//
// Bounds on the H100. rel_stats: bytes, writing GG (T + 2k + 2 floats a
// feature: 45 MB an iteration at bench_bs's 19,147 features, k = 32) and
// reading each entry's cache row (2.4 KB, L2-resident: C is 9.5 MB);
// ~0.014 ms an iteration at 3.35 TB/s. rel_resync: bytes, the map and A's
// row read (and written back) a case, and the SD rows (L2): 268 MB in
// write mode at bench_bs's 1M cases, 0.080 ms. rel_deferred: bytes, C, SD
// and wnum read once (9.5 MB at bench_bs, 0.003 ms).
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
// its batches, with no CTA waiting on another.
// rel_resync (redesigned for the H100; the first version gave each case a
// warp with one 132-byte row in flight behind the map and SD loads, ~8 KB
// in flight an SM): a one-wave grid of 256-thread CTAs takes runs of
// `run` consecutive cases (kernels/rel_sweep.py `resync_plan`: a multiple
// of 4, as many as 8.5 KB of rows hold, 64 at k = 32), whose rows are one
// contiguous span of A. A CTA stages a run's span and its map entries in
// shared memory by cp.async (16-byte pieces: a run of 4n cases keeps the
// span's offset within 16 bytes; 4-byte pieces at its ends), the next run into
// the second buffer while this one is computed. A case takes 8 lanes, a
// warp 4 cases at once, and each warp loads the SD rows (L2-resident) of
// its next 4 / LF rounds together. A lane group computes the first
// version's arithmetic on the staged row: lane v8 forms virtual lanes v8,
// v8 + 8, v8 + 16, v8 + 24's fmaf chains over f = v + 32 i, adds them as
// the first version's xor-16 and xor-8 butterfly steps did, then xor 4, 2,
// 1 across the group; e = (a0 + s) + p, Q + dQB: the same bits as the first
// version. Write mode writes the span back whole in 16-byte stores;
// read-only mode stores the run's e.
// rel_deferred: one warp a block row, lanes over the factors and over each
// row of the packed triangle (its index by tri_index), float64 partials a
// lane, a butterfly a warp, the warps' sums in order a CTA; each CTA writes
// its partial, and the last to arrive (a ticket) adds them in CTA order,
// writes the two float32 sums and sets the ticket back to 0. One launch a
// call, no atomics on the sums, the same bits every run.

#include "common.cuh"

namespace {

using libfm::kMaxK;
using libfm::kWarp;
using libfm::round4;
using libfm::tri_index;
using libfm::warp_sum;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxRun = kThreads;  // rel_resync's cases a run: one map entry a thread
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

// rel_resync's shared memory, one of its two buffers: the span of a run's
// rows with room for A's offset within 16 bytes, then the run's map
// entries and (read-only) its e.
__host__ __device__ inline int span_floats(int run, int d) { return round4(run * d + 3); }
__host__ __device__ inline int resync_buffer(int run, int d) {
  return span_floats(run, d) + 2 * run;
}

// LF: the first version's factors a lane, ceil(k / 32) rounded up to 1, 2 or
// 4; a lane here takes 4 LF of a case's factors
template <int LF>
__global__ void __launch_bounds__(kThreads)
    rel_resync_kernel(const float* __restrict__ SD, const int* __restrict__ row_map,
                      float* __restrict__ A, float* __restrict__ out, long long nc, int k,
                      int run) {
  constexpr int kRound = 4 * kWarps;  // cases a CTA takes at once: 4 a warp
  constexpr int kAhead = 4 / LF;       // rounds whose SD rows a warp loads together
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int grp = lane / 8, v8 = lane % 8;  // the lane's group of 8 and its place in it
  const int d = k + 1;
  const int SF = span_floats(run, d), BF = resync_buffer(run, d);
  const long long nruns = (nc + run - 1) / run;
  // A's offset within 16 bytes: every run's span keeps it (run * d * 4 is
  // a multiple of 16)
  const int mis = (int)((reinterpret_cast<uintptr_t>(A) >> 2) & 3);

  // stage run r's rows and map entries into buffer `buf` (one commit group)
  auto issue = [&](long long r, int buf) {
    float* base = smem + buf * BF;
    const long long c0 = r * run;
    const int n = (int)min((long long)run, nc - c0);
    const float* src = A + c0 * d;
    float* dst = base + mis;
    const int nf = n * d;
    const int head = min((4 - mis) & 3, nf);
    const int nbody = (nf - head) >> 2;
    const int tail = head + 4 * nbody;
    if (tid < head) libfm::cp_async4(dst + tid, src + tid);
    for (int c = tid; c < nbody; c += kThreads)
      libfm::cp_async16(dst + head + 4 * c, src + head + 4 * c);
    if (tid < nf - tail) libfm::cp_async4(dst + tail + tid, src + tail + tid);
    if (tid < n)
      libfm::cp_async4(base + SF + tid, reinterpret_cast<const float*>(row_map + c0 + tid));
    libfm::cp_async_commit();
  };

  long long r = blockIdx.x;
  if (r < nruns) issue(r, 0);
  for (int it = 0; r < nruns; ++it, r += gridDim.x) {
    const int buf = it & 1;
    if (r + gridDim.x < nruns) {
      issue(r + gridDim.x, buf ^ 1);  // its buffer was freed by the barrier ending run it - 1
      libfm::cp_async_wait<1>();
    } else {
      libfm::cp_async_wait<0>();
    }
    __syncthreads();  // run r staged and visible
    float* span = smem + buf * BF + mis;
    const int* map = reinterpret_cast<const int*>(smem + buf * BF + SF);
    float* es = smem + buf * BF + SF + run;
    const long long c0 = r * run;
    const int n = (int)min((long long)run, nc - c0);
    // the run's cases in rounds of 32: case 32 t + 8 g + w goes to lane group
    // g (lanes 8 g .. 8 g + 7) of warp w, 4 cases a warp at once (at k = 32
    // the four staged rows start 8 banks apart: no bank conflict); each warp
    // loads the SD rows of kAhead rounds together
    const int rounds = (n + kRound - 1) / kRound;
    for (int t0 = 0; t0 < rounds; t0 += kAhead) {
      float s[kAhead], dq[kAhead][4 * LF];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int c = (t0 + u) * kRound + grp * 8 + warp;
        s[u] = 0.0f;
#pragma unroll
        for (int m = 0; m < 4 * LF; ++m) dq[u][m] = 0.0f;
        if (t0 + u < rounds && c < n) {
          const float* sd = SD + (long long)map[c] * d;
          s[u] = sd[0];
#pragma unroll
          for (int m = 0; m < 4 * LF; ++m) {
            const int f = v8 + 8 * (m & 3) + kWarp * (m >> 2);
            if (f < k) dq[u][m] = sd[1 + f];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (t0 + u >= rounds) break;  // the same for the whole warp
        const int c = (t0 + u) * kRound + grp * 8 + warp;
        const bool live = c < n;
        float* a = span + (live ? c : 0) * d;
        // virtual lane v8 + 8 m' of the first version (m' = m & 3): its fmaf
        // chain over f = v8 + 8 m' + 32 i, i = m >> 2
        float q[4 * LF], pv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) pv[m] = 0.0f;
#pragma unroll
        for (int m = 0; m < 4 * LF; ++m) {
          const int f = v8 + 8 * (m & 3) + kWarp * (m >> 2);
          q[m] = 0.0f;
          if (live && f < k) {
            q[m] = a[1 + f];
            pv[m & 3] = fmaf(dq[u][m], q[m], pv[m & 3]);
          }
        }
        // the first version's butterfly: its xor 16 and 8 steps here, then
        // xor 4, 2, 1 in the lane group
        float p = __fadd_rn(__fadd_rn(pv[0], pv[2]), __fadd_rn(pv[1], pv[3]));
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) p += __shfl_xor_sync(libfm::kFullMask, p, o);
        if (!live) continue;
        if (out == nullptr) {
#pragma unroll
          for (int m = 0; m < 4 * LF; ++m) {
            const int f = v8 + 8 * (m & 3) + kWarp * (m >> 2);
            if (f < k) a[1 + f] = __fadd_rn(q[m], dq[u][m]);
          }
        }
        if (v8 == 0) {  // e: the group's first lane reads and writes a[0]
          const float e = __fadd_rn(__fadd_rn(a[0], s[u]), p);
          if (out != nullptr) es[c] = e;
          else a[0] = e;
        }
      }
    }
    __syncthreads();  // the run computed
    if (out != nullptr) {
      if (tid < n) out[c0 + tid] = es[tid];
    } else {
      float* dstg = A + c0 * d;
      const int nf = n * d;
      const int head = min((4 - mis) & 3, nf);
      const int nbody = (nf - head) >> 2;
      const int tail = head + 4 * nbody;
      if (tid < head) dstg[tid] = span[tid];
      for (int c = tid; c < nbody; c += kThreads)
        *reinterpret_cast<float4*>(dstg + head + 4 * c) =
            *reinterpret_cast<const float4*>(span + head + 4 * c);
      if (tid < nf - tail) dstg[tail + tid] = span[tail + tid];
    }
    __syncthreads();  // the buffer read: run it + 2 may be staged into it
  }
}

__global__ void __launch_bounds__(kThreads)
    rel_deferred_kernel(const float* __restrict__ C, const float* __restrict__ SD,
                        const float* __restrict__ wnum, double* __restrict__ partial,
                        unsigned* __restrict__ ticket, float* __restrict__ out, int nb1, int k) {
  constexpr int kBatch = 16;  // triangle entries a lane loads at once
  __shared__ float s_dq[kWarps][kMaxK];
  __shared__ double s_sum[kWarps][2];
  __shared__ bool s_last;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int d = k + 1;
  const int T = tri_count(k);
  const int cw = 2 + 2 * k + T;
  float* dq = s_dq[warp];
  double acc_e = 0.0, acc_e2 = 0.0;  // this lane's share of its rows' sums
  for (int b = blockIdx.x * kWarps + warp; b < nb1; b += gridDim.x * kWarps) {
    const float* c = C + (long long)b * cw;
    const float* sd = SD + (long long)b * d;
    const double s = sd[0];
    double pe = 0.0, pe2 = 0.0;
    for (int i = lane; i < k; i += kWarp) {
      const float q = sd[1 + i];
      dq[i] = q;
      pe += (double)q * (double)c[2 + i];               // dQB . SQ0
      pe2 += 2.0 * ((double)q * (double)c[2 + k + i]);  // 2 dQB . SQe0
    }
    __syncwarp();  // dq staged
    // dQB^T SQQ0 dQB: lane l takes the packed triangle's entries t = l + 32 j,
    // kBatch loads in flight at once; (i, g) of t walked on by tri_index
    const float* sqq = c + 2 + 2 * k;
    int i = 0;
    for (int t0 = lane; t0 < T; t0 += kWarp * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + kWarp * u;
        v[u] = t < T ? sqq[t] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + kWarp * u;
        if (t < T) {
          while (t >= tri_index(i + 1, i + 1, k)) ++i;
          const int g = i + (t - tri_index(i, i, k));
          const double twice = g == i ? 1.0 : 2.0;
          pe2 += (double)v[u] * twice * (double)dq[i] * (double)dq[g];
        }
      }
    }
    pe2 += 2.0 * s * pe;  // 2 s (dQB . SQ0)
    if (lane == 0) {
      const double we0 = c[0], we2_0 = c[1], wn = wnum[b];
      pe += we0 + wn * s;
      pe2 += we2_0 + 2.0 * s * we0 + wn * s * s;
    }
    acc_e += pe;
    acc_e2 += pe2;
    __syncwarp();  // dq read before the next row overwrites it
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    acc_e += __shfl_xor_sync(libfm::kFullMask, acc_e, o);
    acc_e2 += __shfl_xor_sync(libfm::kFullMask, acc_e2, o);
  }
  if (lane == 0) {
    s_sum[warp][0] = acc_e;
    s_sum[warp][1] = acc_e2;
  }
  __syncthreads();
  if (tid == 0) {
    double e = 0.0, e2 = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      e += s_sum[w][0];
      e2 += s_sum[w][1];
    }
    partial[2 * blockIdx.x] = e;
    partial[2 * blockIdx.x + 1] = e2;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || warp != 0) return;
  // the last CTA: every partial, lane l taking CTAs l, l + 32, ... in order
  __threadfence();
  double e = 0.0, e2 = 0.0;
  for (int q = lane; q < (int)gridDim.x; q += kWarp) {
    e += __ldcg(partial + 2 * q);
    e2 += __ldcg(partial + 2 * q + 1);
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    e += __shfl_xor_sync(libfm::kFullMask, e, o);
    e2 += __shfl_xor_sync(libfm::kFullMask, e2, o);
  }
  if (lane == 0) {
    out[0] = __double2float_rn(e);
    out[1] = __double2float_rn(e2);
    *ticket = 0u;  // every CTA has arrived: ready for the next call
  }
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
// run (a multiple of 4, at most kMaxRun) and smem (two buffers of
// resync_buffer(run, k + 1) floats) the host's plan (kernels/rel_sweep.py
// resync_plan); a plan the card's shared memory cannot hold is refused.
extern "C" int rel_resync_launch(const float* SD, const int* row_map, float* A, float* out,
                                 long long nc, int k, int run, int smem,
                                 cudaStream_t stream) {
  if (k < 1 || k > kMaxK || nc < 0 || run < 4 || run > kMaxRun || run % 4 != 0 ||
      smem != 2 * resync_buffer(run, k + 1) * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (nc == 0) return (int)cudaSuccess;
  int dev, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > most) return (int)cudaErrorInvalidValue;
  const long long nruns = (nc + run - 1) / run;
  unsigned grid = 0;
#define REL_RESYNC_LAUNCH(LF)                                                              \
  do {                                                                                     \
    err = libfm::one_wave_grid<rel_resync_kernel<LF>>(kThreads, smem, nruns, &grid);       \
    if (err != cudaSuccess) return (int)err;                                               \
    rel_resync_kernel<LF><<<grid, kThreads, smem, stream>>>(SD, row_map, A, out, nc, k,   \
                                                             run);                         \
  } while (0)
  if (k <= 32) REL_RESYNC_LAUNCH(1);
  else if (k <= 64) REL_RESYNC_LAUNCH(2);
  else REL_RESYNC_LAUNCH(4);
#undef REL_RESYNC_LAUNCH
  return (int)cudaGetLastError();
}

// out [2] = (sum e, sum e^2) as float32, from C [nb1, 2+2k+T], SD [nb1, k+1]
// and wnum [nb1]; partial [2 * most] float64 scratch (most >= the CTAs
// that nb1 rows take, ceil(nb1 / 8)), ticket one unsigned, 0 between
// calls (the kernel leaves it 0).
extern "C" int rel_deferred_launch(const float* C, const float* SD, const float* wnum,
                                   double* partial, unsigned* ticket, float* out, int nb1,
                                   int k, int most, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || nb1 < 0 || most < 1) return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  cudaError_t err = libfm::one_wave_grid<rel_deferred_kernel>(
      kThreads, 0, ((long long)nb1 + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return (int)err;
  if ((int)grid > most) return (int)cudaErrorInvalidValue;
  rel_deferred_kernel<<<grid, kThreads, 0, stream>>>(C, SD, wnum, partial, ticket, out, nb1,
                                                     k);
  return (int)cudaGetLastError();
}
