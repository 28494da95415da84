// table_scatter: T[i] += upd[perm[j]] over the sorted positions j with
// sids[j] == i, in place on T, deterministic and without floating-point
// atomics. With perm == NULL the update rows are already in sorted order
// (row j is position j's).
//
// Replaces the Pallas scatter probes studies/probes/pallas_scatter.py:35
// (P4, a sequential per-row read-modify-write of a VMEM-resident table)
// and studies/pallas_gather.py:112 (P2, `T[idx] += 1` per id), and the
// scatter half of the SGD step in libfm_tpu/learners/sgd.py:157,212
// (`P.at[sids].add(upd[perm], indices_are_sorted=True)`).
//
// Bound on the H100: bytes. The kernel reads sids and perm (8 B/entry),
// the update rows (4 W B/entry) and each touched table row once, and
// writes each touched row once. Tables here (0.7-5.3 MB) and a batch's
// update rows (2.4-7.2 MB) stay in the 50 MB L2, so a call is bound by
// latency: a launch, the gathers of a window, and the chains of runs that
// span windows.
//
// Design: one launch of at most the CTAs that fit on the card at once.
// Warp g of G takes windows of sorted positions g, g + G, ... in
// increasing order.
// Within a window every run of equal ids that ends there is summed and
// added to its table row, written once. The sum of the window's last
// run, when that run goes on past the window, is published as the
// window's piece: a flag per window set to the call's generation (the
// wrapper counts its calls on a scratch, so flags are never reset and a
// flag left by an earlier call never reads as published). A window whose
// first run started in earlier windows (found on sids, 32 windows a
// step) waits for those windows' flags, adds their pieces in window
// order and then its own part. It waits only on lower windows, whose
// warps wait only on lower windows still, so every wait ends once every
// CTA is resident: the grid fits on the card, and no grid after it on
// the stream starts before it ends. No atomics: a first design handed
// windows out by an atomic ticket and reset the scratch from the warp
// that finished last, two atomic round trips a call (one entry took
// 12.2 us on the H100, against 8.4 us without).
// The launch overlaps the end of the grid before it (programmatic
// dependent launch; sgd_step's grid in the SGD epoch): every thread waits
// for that grid before it reads. This grid does not let the next one
// start early: when each grid did, grids queued up on the SMs waiting on
// each other and the scatter slowed (on the H100, 4.79 ms an epoch at
// config #1, against 3.02 ms as it is).
// - W <= 32 (the SGD tables, 9 and 17 wide, and P4's 16): lanes run over
//   sorted positions, kRounds rounds of 32 positions a window, and the
//   runs are summed by a segmented scan of warp shuffles, one column
//   after another, carried from round to round; every lane is busy at
//   any W. A lane loads its rounds' update rows and the table rows of its
//   run ends before the first add, so a warp has up to 2 x 48 loads a
//   lane in flight. Windows of one round at W <= 16 unless a run is very
//   long (the caller's longest run), else of as many rounds as 48 floats
//   a lane allow: two at W = 17..24 (see table_scatter_launch).
// - W > 32 (P2's 128): lanes run over the columns, 32 at a time, and the
//   warp walks its window of 8 positions one after the other, with the
//   tile's update and table values loaded before the first add. As in
//   the narrow path, a window publishes its piece before it waits: when
//   it waited first, waits chained through runs of closing windows (P2
//   took 6.16 ms on the H100, against 0.378 for the two-pass kernel before;
//   with windows of 32 positions it took 0.707, a warp's chain too long).
// The sum of every run is taken in an order fixed by the positions, so a
// call is bitwise repeatable; it differs from a sequential scatter's
// sums only by f32 rounding. Offsets into T and upd are int64.

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kWarp;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kWideWin = 8;  // positions in a window of the wide path
// the longest run (positions, 128 windows of one round) for which widths
// up to 16 take windows of one round
constexpr long long kLongRun = 4096;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// This warp's index among the grid's warps, and the grid's warps.
__device__ __forceinline__ long long warp_id() {
  return (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
}
__device__ __forceinline__ long long warps() { return (long long)gridDim.x * kWarps; }

// The window where the run of `id` that reaches into window w starts:
// the largest v < w that the run does not enter from window v - 1.
__device__ __forceinline__ long long run_start_window(const int* __restrict__ sids,
                                                      long long w, int win, int id,
                                                      int lane) {
  for (long long base = w - 1;; base -= kWarp) {
    const long long v = base - lane;
    const bool starts = v <= 0 || sids[v * win - 1] != id;
    const unsigned m = __ballot_sync(kFullMask, starts);
    if (m) return base - (__ffs(m) - 1);
  }
}

// Wait until windows [s, w) have published their pieces in call `gen`.
__device__ __forceinline__ void wait_pieces(const int* flags, long long s, long long w,
                                            int gen, int lane) {
  for (long long v = s + lane; v < w; v += kWarp)
    while (ld_acquire(flags + v) != gen) {
    }
  __syncwarp();
}

// Column c of the pieces of windows [s, w), added in window order.
__device__ __forceinline__ float sum_pieces(const float* pieces, long long s, long long w,
                                            int W, int c) {
  float acc = __ldcg(pieces + s * W + c);
#pragma unroll 8
  for (long long v = s + 1; v < w; ++v) acc += __ldcg(pieces + v * W + c);
  return acc;
}

// W <= kCols <= 32: windows of kRounds x 32 sorted positions, position
// w0 + 32 q + lane in round q.
template <int kCols, int kRounds>
__global__ void __launch_bounds__(kThreads, 4)  // one wave of 1,664 windows
scatter_narrow(float* __restrict__ T, const int* __restrict__ sids,
               const int* __restrict__ perm, const float* __restrict__ upd,
               int* __restrict__ flags, float* __restrict__ pieces, int gen, long long E,
               int W) {
  constexpr int kWin = kWarp * kRounds;
  const int lane = threadIdx.x % kWarp;
  const long long nwin = (E + kWin - 1) / kWin;
  libfm::grid_dep_wait();
  for (long long w = warp_id(); w < nwin; w += warps()) {
    const long long w0 = w * kWin;
    int sid[kRounds];
    bool end[kRounds], valid[kRounds];
    unsigned head_mask[kRounds];
    long long prow[kRounds];
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const long long j = w0 + kWarp * q + lane;
      valid[q] = j < E;
      sid[q] = valid[q] ? sids[j] : -1;
      const bool head = valid[q] && (j == 0 || sids[j - 1] != sid[q]);
      end[q] = valid[q] && (j == E - 1 || sids[j + 1] != sid[q]);
      head_mask[q] = __ballot_sync(kFullMask, head);
      prow[q] = valid[q] ? (perm ? (long long)perm[j] : j) : 0;
    }
    // every load of the window before the first add
    float x[kRounds][kCols], t[kRounds][kCols];
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const float* u = upd + prow[q] * W;
      const float* r = T + (long long)(end[q] ? sid[q] : 0) * W;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        x[q][c] = (valid[q] && c < W) ? u[c] : 0.0f;
        t[q][c] = (end[q] && c < W) ? r[c] : 0.0f;
      }
    }
    // segmented inclusive scan over the window's positions, column by
    // column: level o adds lane - o's partial when no run starts in
    // (lane - o, lane]; a round's lanes with no run start at or before
    // them continue the previous round's last run
    unsigned add_bits[kRounds];
    bool no_head_upto[kRounds];
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      unsigned bits = 0;
#pragma unroll
      for (int lev = 0; lev < 5; ++lev) {
        const int o = 1 << lev;
        const bool add =
            lane >= o && ((head_mask[q] >> (lane - o + 1)) & ((1u << o) - 1u)) == 0;
        bits |= (unsigned)add << lev;
      }
      add_bits[q] = bits;
      no_head_upto[q] = (head_mask[q] & ((2u << lane) - 1u)) == 0;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float carry = 0.0f;
#pragma unroll
      for (int q = 0; q < kRounds; ++q) {
        float v = x[q][c];
#pragma unroll
        for (int lev = 0; lev < 5; ++lev) {
          const float y = __shfl_up_sync(kFullMask, v, 1 << lev);
          if ((add_bits[q] >> lev) & 1u) v += y;
        }
        if (q > 0 && no_head_upto[q]) v = carry + v;
        carry = __shfl_sync(kFullMask, v, kWarp - 1);
        x[q][c] = v;
      }
    }
    // the window's last run goes on past it: publish its sum
    const bool full = w0 + kWin <= E;
    const bool last_open = full && !__shfl_sync(kFullMask, end[kRounds - 1], kWarp - 1);
    if (last_open && lane == kWarp - 1) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < W) pieces[w * W + c] = x[kRounds - 1][c];
      __threadfence();
      st_release(flags + w, gen);
    }
    // the run end of the window's first run, when that run started in an
    // earlier window (position w0 starts no run)
    bool closing[kRounds];
    bool no_head_before = true;
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      closing[q] = end[q] && no_head_before && no_head_upto[q];
      no_head_before = no_head_before && head_mask[q] == 0;
    }
    // every other run that ends here: its table row plus its sum
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      if (end[q] && !closing[q]) {
        float* r = T + (long long)sid[q] * W;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (c < W) r[c] = t[q][c] + x[q][c];
      }
    }
    bool any_closing = false;
#pragma unroll
    for (int q = 0; q < kRounds; ++q) any_closing = any_closing || closing[q];
    if (__ballot_sync(kFullMask, any_closing)) {
      const int id = __shfl_sync(kFullMask, sid[0], 0);
      const long long s = run_start_window(sids, w, kWin, id, lane);
      wait_pieces(flags, s, w, gen, lane);
      const float acc = lane < W ? sum_pieces(pieces, s, w, W, lane) : 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float carry = __shfl_sync(kFullMask, acc, c);
#pragma unroll
        for (int q = 0; q < kRounds; ++q)
          if (closing[q] && c < W)
            T[(long long)sid[q] * W + c] = t[q][c] + (carry + x[q][c]);
      }
    }
  }
}

// W > 32: windows of 32 positions walked in order, lanes over columns.
__global__ void __launch_bounds__(kThreads)
scatter_wide(float* __restrict__ T, const int* __restrict__ sids,
             const int* __restrict__ perm, const float* __restrict__ upd,
             int* __restrict__ flags, float* __restrict__ pieces, int gen, long long E,
             int W) {
  const int lane = threadIdx.x % kWarp;
  const long long nwin = (E + kWideWin - 1) / kWideWin;
  libfm::grid_dep_wait();
  for (long long w = warp_id(); w < nwin; w += warps()) {
    const long long w0 = w * kWideWin;
    const int n = (int)min((long long)kWideWin, E - w0);
    const long long j = w0 + lane;
    const bool valid = lane < n;
    const int s = valid ? sids[j] : -1;
    const unsigned heads =
        __ballot_sync(kFullMask, valid && (j == 0 || sids[j - 1] != s));
    const unsigned ends =
        __ballot_sync(kFullMask, valid && (j == E - 1 || sids[j + 1] != s));
    const long long p = valid ? (perm ? (long long)perm[j] : j) : 0;
    // position 0 continues a run of earlier windows, which ends here
    const bool closing = !(heads & 1u) && ends != 0;
    const int first_end = __ffs(ends) - 1;
    const bool last_open = !((ends >> (n - 1)) & 1u);
    // every run but the closing one, and the piece: tiles of 32 columns,
    // each tile's update and table values loaded before the first add (a
    // table load after the previous position's store waits for it)
    for (int c0 = 0; c0 < W; c0 += kWarp) {
      const int c = c0 + lane;
      const bool col = c < W;
      float u[kWideWin], t[kWideWin];
#pragma unroll
      for (int i = 0; i < kWideWin; ++i) {
        const long long pi = __shfl_sync(kFullMask, p, i);
        const long long si = __shfl_sync(kFullMask, s, i);
        const bool own_end = ((ends >> i) & 1u) && !(closing && i == first_end);
        u[i] = col && i < n ? upd[pi * W + c] : 0.0f;
        t[i] = col && own_end ? T[si * W + c] : 0.0f;
      }
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kWideWin; ++i) {
        acc = ((heads >> i) & 1u) ? u[i] : acc + u[i];
        const long long si = __shfl_sync(kFullMask, s, i);
        if (((ends >> i) & 1u) && !(closing && i == first_end) && col)
          T[si * W + c] = t[i] + acc;
      }
      if (last_open && col) pieces[w * W + c] = acc;
    }
    if (last_open) {
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(flags + w, gen);
    }
    // then the closing run: the earlier windows' pieces in window order,
    // then this window's part of the run, positions 0 .. first_end
    if (closing) {
      const int id = __shfl_sync(kFullMask, s, 0);
      const long long start = run_start_window(sids, w, kWideWin, id, lane);
      wait_pieces(flags, start, w, gen, lane);
      for (int c0 = 0; c0 < W; c0 += kWarp) {
        const int c = c0 + lane;
        const bool col = c < W;
        const float carry = col ? sum_pieces(pieces, start, w, W, c) : 0.0f;
        float u[kWideWin];
#pragma unroll
        for (int i = 0; i < kWideWin; ++i) {
          const long long pi = __shfl_sync(kFullMask, p, i);
          u[i] = col && i <= first_end ? upd[pi * W + c] : 0.0f;
        }
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kWideWin; ++i)
          if (i <= first_end) acc += u[i];
        if (col) T[(long long)id * W + c] = T[(long long)id * W + c] + (carry + acc);
      }
    }
  }
}

// One launch for nwin windows: a warp a window, at most one wave of CTAs
// (the look-back waits on lower windows).
template <auto kKernel>
int launch(long long nwin, float* T, const int* sids, const int* perm, const float* upd,
           int* flags, float* pieces, int gen, long long E, int W, cudaStream_t stream) {
  unsigned grid;
  const cudaError_t err =
      libfm::one_wave_grid<kKernel>(kThreads, 0, (nwin + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return (int)err;
  return (int)libfm::launch_pdl(kKernel, grid, kThreads, stream, T, sids, perm, upd,
                                 flags, pieces, gen, E, W);
}

// Widths up to kCols, whose long form takes kLong rounds a window: two
// rounds always, one when that is the only form; else one round unless
// the longest run is longer than kLongRun or unknown (< 1).
template <int kCols, int kLong>
int launch_narrow(long long max_run, float* T, const int* sids, const int* perm,
                  const float* upd, int* flags, float* pieces, int gen, long long E, int W,
                  cudaStream_t stream) {
  constexpr long long kLongWin = kWarp * kLong;
  if constexpr (kLong > 2) {
    if (max_run >= 1 && max_run <= kLongRun)
      return launch<scatter_narrow<kCols, 1>>((E + kWarp - 1) / kWarp, T, sids, perm, upd,
                                              flags, pieces, gen, E, W, stream);
  }
  return launch<scatter_narrow<kCols, kLong>>((E + kLongWin - 1) / kLongWin, T, sids, perm,
                                              upd, flags, pieces, gen, E, W, stream);
}

}  // namespace

// T [n, W] (in place), sids [E] ascending, perm [E] rows of upd [*, W]
// (NULL: row j of upd is position j's); scratch: flags [nflags] int32 and
// pieces [npieces] floats, nflags >= ceil(E / 8) and npieces >= W times
// that; gen > 0 differs from every earlier call's on these flags;
// max_run, the longest run of equal ids in sids (any value gives the same
// sums up to f32 rounding: it only sizes the windows; < 1 when unknown).
extern "C" int table_scatter_launch(float* T, const int* sids, const int* perm,
                                    const float* upd, int* flags, float* pieces,
                                    long long nflags, long long npieces, int gen,
                                    long long E, int W, long long max_run,
                                    cudaStream_t stream) {
  const long long nwin_max = (E + kWideWin - 1) / kWideWin;  // the most any path cuts E into
  if (W < 1 || E < 1 || gen < 1 || nflags < nwin_max || npieces < nwin_max * W)
    return (int)cudaErrorInvalidValue;
  // The form by what the H100 showed (pallas_scatter --run-lengths, 32
  // batches back to back): two rounds beat one at W=17 and 24 on config
  // #1's ids (longest runs ~12) and #4b's (Zipf, ~1,500), and are no
  // slower at any run length of the sweep; three or more rounds lose to one at every
  // W <= 16 on both (W=9, 32 batches: 0.420 and 0.484 ms against 0.332
  // and 0.399),
  // but win on runs of 8,192 (0.0154 against 0.0217 ms a call), where the
  // window that closes a run adds a piece from each of 256 windows.
#define NARROW(C, R) \
  launch_narrow<C, R>(max_run, T, sids, perm, upd, flags, pieces, gen, E, W, stream)
  if (W <= 4) return NARROW(4, 12);
  if (W <= 8) return NARROW(8, 6);
  if (W == 9) return NARROW(9, 4);  // config #1's width, no spare columns
  if (W <= 12) return NARROW(12, 4);
  if (W <= 16) return NARROW(16, 3);
  if (W == 17) return NARROW(17, 2);  // config #4b's width
  if (W <= 24) return NARROW(24, 2);
  if (W <= 32) return NARROW(32, 1);
#undef NARROW
  return launch<scatter_wide>(nwin_max, T, sids, perm, upd, flags, pieces, gen, E, W,
                              stream);
}
