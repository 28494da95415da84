// table_scatter: T[i] += upd[perm[j]] over the sorted positions j with
// sids[j] == i, in place on T, deterministic and without atomics.
//
// Replaces the Pallas scatter probes studies/probes/pallas_scatter.py:35
// (P4, a sequential per-row read-modify-write of a VMEM-resident table)
// and studies/pallas_gather.py:112 (P2, `T[idx] += 1` per id), and the
// scatter half of the SGD step in libfm_tpu/learners/sgd.py:157,212
// (`P.at[sids].add(upd[perm], indices_are_sorted=True)`).
//
// The caller presorts the ids once (host `sorted_scatter_order`, or a
// stable sort): sids [E] ascending, perm [E] the update row of each
// sorted position. Two passes, no atomics, and every sum in a fixed
// order, so the result is deterministic:
// - pass 1, one warp per window of 8 sorted positions: a run of equal ids
//   that lies inside the window is added to its table row, the row first
//   and then its updates one by one (as a sequential scatter adds them);
//   the pieces of longer runs are summed into scratch, one per window;
// - pass 2, one warp per run that spans windows (the warp of the window
//   where it starts): the table row, then the run's pieces in window
//   order, written back once.
// No two warps write one table row.
//
// Bound on the H100: bytes. The kernel reads sids and perm (8 B/entry),
// the update rows (4 W B/entry) and each touched table row once, and
// writes each touched row once (plus 8 W B of scratch a window for runs
// that span windows). Tables here (0.7-5.3 MB) stay in the 50 MB L2; a
// TPU kernel's "VMEM-resident" table has no counterpart in one SM's
// shared memory at these sizes, so rows are gathered from global memory.
// Design: a first version let one warp add a whole run; measured on the
// H100 that costs ~81 ns an entry (a few dependent round trips to memory
// per 32 entries), and Zipf ids give runs of ~1,500 a batch at config
// #4b, so hot rows serialised the batch. Cutting every run at the window
// bounds spreads a hot run over its windows' warps; only the pieces are
// chained. Lanes run over the row's columns, one a lane for W <= 32, else
// in tiles of 128, so any width W works; at W=9 or 17 most lanes idle.
// Offsets into T and upd are int64.

#include "common.cuh"

namespace {

using libfm::kWarp;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kWindow = 8;  // sorted positions a warp owns in pass 1
constexpr unsigned kFull = 0xffffffffu;

// acc += update rows perm[j0 .. j0+n), n <= kWindow, in that order, over
// the column tile [c0, c0 + 32 kCols): lanes over the columns; the n rows
// are loaded before any is added, so their loads overlap.
template <int kCols>
__device__ __forceinline__ void add_rows(float (&acc)[kCols],
                                         const int* __restrict__ perm,
                                         const float* __restrict__ upd, int W,
                                         int c0, long long j0, int n, int lane) {
  const int p_lane = lane < n ? perm[j0 + lane] : 0;
  float v[kWindow][kCols];
#pragma unroll
  for (int q = 0; q < kWindow; ++q) {
    const long long p = __shfl_sync(kFull, p_lane, q);
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = c0 + lane + kWarp * t;
      v[q][t] = (q < n && c < W) ? upd[p * W + c] : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < kWindow; ++q) {
    if (q < n) {
#pragma unroll
      for (int t = 0; t < kCols; ++t) acc[t] += v[q][t];
    }
  }
}

// Pass 1: one warp per window of kWindow sorted positions. The window is
// cut into segments of equal ids. A segment that is a whole run is added
// to its table row (row, then its updates one by one). Otherwise its sum
// goes to scratch: head[win] for the window's first segment when that
// continues a run from earlier windows (head_end[win] = 1 when the run
// ends in this window), tail[win] for the last segment when it starts a
// run that goes on (tail_flag[win] = 1).
template <int kCols>
__global__ void __launch_bounds__(kThreads)
scatter_windows(float* __restrict__ T, const int* __restrict__ sids,
                const int* __restrict__ perm, const float* __restrict__ upd,
                float* __restrict__ head, float* __restrict__ tail,
                int* __restrict__ head_end, int* __restrict__ tail_flag,
                long long E, long long nwin, int W) {
  const int lane = threadIdx.x % kWarp;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long win = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
       win < nwin; win += nwarps) {
    const long long w0 = win * kWindow;
    const int nvalid = (int)min((long long)kWindow, E - w0);
    const long long j = w0 + lane;
    const bool valid = lane < nvalid;
    const int s = valid ? sids[j] : 0;
    const bool run_start = valid && (j == 0 || sids[j - 1] != s);
    const bool run_end = valid && (j == E - 1 || sids[j + 1] != s);
    const unsigned rs = __ballot_sync(kFull, run_start);
    const unsigned re = __ballot_sync(kFull, run_end);
    unsigned starts = __ballot_sync(kFull, valid && (lane == 0 || run_start));
    int hend = 0, tflag = 0;
    while (starts) {
      const int q = __ffs(starts) - 1;
      starts &= starts - 1;
      const int qe = starts ? __ffs(starts) - 1 : nvalid;  // segment [q, qe)
      const long long id = __shfl_sync(kFull, s, q);
      const bool is_start = (rs >> q) & 1u;
      const bool is_end = (re >> (qe - 1)) & 1u;
      const bool whole = is_start && is_end;
      float* dst = whole ? T + id * W : (is_start ? tail : head) + win * W;
      for (int c0 = 0; c0 < W; c0 += kWarp * kCols) {
        float acc[kCols];
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int c = c0 + lane + kWarp * t;
          acc[t] = (whole && c < W) ? dst[c] : 0.0f;
        }
        add_rows<kCols>(acc, perm, upd, W, c0, w0 + q, qe - q, lane);
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int c = c0 + lane + kWarp * t;
          if (c < W) dst[c] = acc[t];
        }
      }
      if (!is_start) hend = is_end;
      else if (!is_end) tflag = 1;
    }
    if (lane == 0) {
      head_end[win] = hend;
      tail_flag[win] = tflag;
    }
  }
}

// Pass 2: one warp per window whose last segment starts a run that goes
// on. It finds the window where the run ends (32 head_end flags a
// step), then adds to the table row its own piece and the following
// windows' pieces, in window order.
template <int kCols>
__global__ void __launch_bounds__(kThreads)
scatter_chains(float* __restrict__ T, const int* __restrict__ sids,
               const float* __restrict__ head, const float* __restrict__ tail,
               const int* __restrict__ head_end, const int* __restrict__ tail_flag,
               long long E, long long nwin, int W) {
  const int lane = threadIdx.x % kWarp;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long win = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
       win < nwin; win += nwarps) {
    if (!tail_flag[win]) continue;
    const long long id = sids[min(win * kWindow + kWindow, E) - 1];
    long long last = win + 1;  // the window where the run ends
    for (;;) {
      const long long v = last + lane;
      const unsigned m = __ballot_sync(kFull, v < nwin && head_end[v] != 0);
      if (m) {
        last += __ffs(m) - 1;
        break;
      }
      last += kWarp;
    }
    for (int c0 = 0; c0 < W; c0 += kWarp * kCols) {
      float acc[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = c0 + lane + kWarp * t;
        acc[t] = c < W ? T[id * W + c] + tail[win * W + c] : 0.0f;
      }
#pragma unroll 8
      for (long long v = win + 1; v <= last; ++v) {
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int c = c0 + lane + kWarp * t;
          if (c < W) acc[t] += head[v * W + c];
        }
      }
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = c0 + lane + kWarp * t;
        if (c < W) T[id * W + c] = acc[t];
      }
    }
  }
}

template <int kCols>
int launch(float* T, const int* sids, const int* perm, const float* upd,
           float* head, float* tail, int* head_end, int* tail_flag, long long E,
           int W, int grid, cudaStream_t stream) {
  const long long nwin = (E + kWindow - 1) / kWindow;
  scatter_windows<kCols><<<grid, kThreads, 0, stream>>>(
      T, sids, perm, upd, head, tail, head_end, tail_flag, E, nwin, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_chains<kCols><<<grid, kThreads, 0, stream>>>(
      T, sids, head, tail, head_end, tail_flag, E, nwin, W);
  return (int)cudaGetLastError();
}

}  // namespace

// T [n, W] (in place), sids [E] ascending, perm [E] rows of upd [*, W];
// scratch: head, tail [ceil(E / 8), W], head_end, tail_flag [ceil(E / 8)].
extern "C" int table_scatter_launch(float* T, const int* sids, const int* perm,
                                    const float* upd, float* head, float* tail,
                                    int* head_end, int* tail_flag, long long E,
                                    int W, int grid, cudaStream_t stream) {
  if (W < 1 || E < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  if (W <= kWarp)
    return launch<1>(T, sids, perm, upd, head, tail, head_end, tail_flag, E, W,
                     grid, stream);
  return launch<4>(T, sids, perm, upd, head, tail, head_end, tail_flag, E, W,
                   grid, stream);
}
