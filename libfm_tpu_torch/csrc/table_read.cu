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
// The TPU kernel keeps the whole table resident in VMEM. No SM's 227 KB
// holds the studies' [10256, 128] f32 table (5.25 MB), but 32 SMs each
// hold every row of a 4-column slice (10256 x 16 B = 164 KB). The launch
// plan (kernels/table_read.py `read_plan`) takes one of two forms:
//
// - shared: CTA (s, g) holds column slice s (C = 4, 2 or 1 columns;
//   columns past W read as zeros) in shared memory beside the ids of
//   group g (mod nsub). At W = 128, 32 slices x 4 id groups fill 128 SMs.
//   The plan keeps the grid within the SMs, one CTA each, so the card
//   holds it at once (a cooperative launch).
//   - The fill: every CTA writes its share of T's rows slice by slice
//     into a scratch Ts, reading whole sectors and writing whole lines;
//     after a grid barrier each CTA pulls its slice, one contiguous run,
//     with bulk copies (TMA) on an mbarrier. Copying a slice's 16-byte
//     pieces of T's 512-byte rows straight would take a 32-byte sector
//     request each, held by the requests an SM keeps in flight.
//   - The ids, while the slice's copies run, go in bank order: rounds of
//     one id of each residue mod 32 / C, so that the 8 lanes of a quarter
//     warp read 8 distinct 16-byte bank groups.
//   - The lookups: a thread takes one id at a time and reads its rows for
//     kRepsInFlight reps (row = id + r mod nsub, one add and one
//     conditional subtraction a row), each rep into its own accumulators;
//     a warp's sums leave by 6 shuffles, and a block of kRepBlock reps'
//     warp sums are added in warp order after one barrier into the CTA's
//     partials of (rep, group, slice).
// - l2: where not even a one-column slice with its ids fits, CTA (t, g,
//   z) takes 128 columns, id group g and reps z, z + Z, ...; its warps
//   take the ids, the lanes the columns, and the rows come from global
//   memory (L2).
//
// One launch a call in either form: the last CTA of a column slice to
// finish (the slice's integer ticket after a fence) adds each rep's
// partials in group order, runs the slice's carry and sets the ticket
// back to zero. No floating-point atomics: two calls on the same inputs
// give the same bits.
//
// Bound on the H100: bytes, HBM: the table and the ids once (0.0016 ms at
// the studies' shape, 16384 ids, 20 reps). The lookups are on-chip work
// that bound does not count: 20 x 16384 rows x 512 B = 168 MB from shared
// memory, which serves 128 B a clock on each SM (~33 TB/s on 132 SMs at
// 1.98 GHz): ~5 us. Built with -DTABLE_READ_TIMING, the shared form
// stamps each CTA's phases (studies/table_read_phases.py reads them: the
// phase times of PERF.md).

#include "common.cuh"

namespace {

using libfm::kWarp;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kFlagBytes = 16;       // the last-CTA flag and the fill's mbarrier
constexpr int kRepBlock = 16;        // reps whose warp sums the shared form adds at once
constexpr int kRepsInFlight = 4;     // reps an id's rows are read for together (divides kRepBlock)
constexpr int kHeadFloats = 2 * kRepBlock * kWarps * 4;  // the shared form's sums, counters
constexpr int kTile = kWarp * 4;     // the l2 form's columns a CTA
constexpr int kShared = 0, kL2 = 1;
constexpr unsigned kBulkBytes = 32768;  // bytes a bulk copy of the fill

__device__ __forceinline__ int wrap(int row, int nsub) { return row >= nsub ? row - nsub : row; }

// id mod nsub for a non-negative id, dividing only where id >= nsub.
__device__ __forceinline__ int mod(int id, int nsub) { return id < nsub ? id : id % nsub; }

// ---- the grid-wide steps of the shared form's fill (a cooperative launch:
// every CTA of the grid is resident)

// Every CTA waits until all have arrived (CUTLASS's generic barrier): a
// release add of the CTA's arrival to bar[0] after its threads' writes,
// then an acquire spin until all n have arrived. grid_leave, called once
// a CTA after it, counts departures in bar[1], and the last CTA to leave
// sets both back to zero for the next call.
__device__ __forceinline__ void grid_barrier(int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n = gridDim.x * gridDim.y * gridDim.z;
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(bar) : "memory");
    int seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(seen) : "l"(bar) : "memory");
    } while (seen < n);
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_leave(int* bar) {
  if (atomicAdd(bar + 1, 1) == (int)(gridDim.x * gridDim.y * gridDim.z) - 1)
    bar[0] = bar[1] = 0;
}

// Generic-proxy writes to global memory before it, bulk copies after it.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The phase stamps: with -DTABLE_READ_TIMING, thread 0 of each CTA of the
// shared form writes the global timer (ns) at its phase k into
// g_stamps[cta * kStamps + k] (table_read_stamps sets the buffer).
#ifdef TABLE_READ_TIMING
constexpr int kStamps = 8;
__device__ long long* g_stamps;
#define STAMP(k)                                                                   \
  if (threadIdx.x == 0 && g_stamps) {                                              \
    long long t;                                                                   \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                          \
    g_stamps[((long long)blockIdx.y * gridDim.x + blockIdx.x) * kStamps + (k)] = t; \
  }
#else
#define STAMP(k)
#endif

// ---- the shared form

// The sum over the warp's lanes of each of a lane's C floats, in a fixed
// order: the lanes trade halves of their floats (xor 16, then xor 8 for
// C = 4), then add within groups of 32 / C lanes. Lane l gets column
// lane_col<C>(l); 6 shuffles at C = 4 where one sum a column takes 20.
template <int C>
__device__ __forceinline__ int lane_col(int lane) {
  return C == 4 ? ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1) : C == 2 ? (lane >> 4) & 1 : 0;
}

template <int C>
__device__ __forceinline__ float warp_cols(const float (&v)[C], int lane) {
  using libfm::kFullMask;
  float k;
  if constexpr (C == 4) {
    const bool hi = lane & 16, mid = lane & 8;
    const float r0 = __shfl_xor_sync(kFullMask, hi ? v[0] : v[2], 16);
    const float r1 = __shfl_xor_sync(kFullMask, hi ? v[1] : v[3], 16);
    const float k0 = (hi ? v[2] : v[0]) + r0, k1 = (hi ? v[3] : v[1]) + r1;
    k = (mid ? k1 : k0) + __shfl_xor_sync(kFullMask, mid ? k0 : k1, 8);
  } else if constexpr (C == 2) {
    const bool hi = lane & 16;
    k = (hi ? v[1] : v[0]) + __shfl_xor_sync(kFullMask, hi ? v[0] : v[1], 16);
    k += __shfl_xor_sync(kFullMask, k, 8);
  } else {
    k = v[0] + __shfl_xor_sync(kFullMask, v[0], 16);
    k += __shfl_xor_sync(kFullMask, k, 8);
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) k += __shfl_xor_sync(kFullMask, k, o);
  return k;
}

// acc += the C floats of slice row `row`, in one shared-memory read.
template <int C>
__device__ __forceinline__ void add_row(float (&acc)[C], const float* slice, int row) {
  if constexpr (C == 4) {
    const float4 v = reinterpret_cast<const float4*>(slice)[row];
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  } else if constexpr (C == 2) {
    const float2 v = reinterpret_cast<const float2*>(slice)[row];
    acc[0] += v.x;
    acc[1] += v.y;
  } else {
    acc[0] += slice[row];
  }
}

// acc[q] = the sum of the slice rows of this thread's ids shifted by
// rr + q (mod nsub), q < R: an id's R rows are read together, one add and
// one conditional subtraction a row.
template <int C, int R>
__device__ __forceinline__ void lookups(float (&acc)[R][C], const float* slice, const int* sids,
                                        int n, int nsub, int rr) {
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[q][c] = 0.0f;
#pragma unroll 2
  for (int i = threadIdx.x; i < n; i += kThreads) {
    int row = wrap(sids[i] + rr, nsub);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      add_row<C>(acc[q], slice, row);
      row = row + 1 == nsub ? 0 : row + 1;
    }
  }
}

// Columns c0 .. c0 + C - 1 of a row of T (zeros past W); `vec`: the
// row's C floats are one aligned vector.
template <int C>
__device__ __forceinline__ void load_cols(float (&v)[C], const float* row, int c0, int W,
                                          bool vec) {
  if (C == 4 && vec) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(row + c0));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if (C == 2 && vec) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(row + c0));
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = c0 + j < W ? __ldg(row + c0 + j) : 0.0f;
  }
}

// The fill's first step: the grid's CTAs split T's rows (a
// multiple of 8 rows each) and write them slice by slice into Ts
// [slices][stride floats], slice s's rows of C floats one after another.
// A warp's lanes take tiles of 8 rows x 4 slices: the loads read whole
// sectors of 8 rows, and each slice's 8 rows are one 128-byte store at
// C = 4. A thread moves kBatch tiles at a time (loads, then stores).
template <int C>
struct Transpose {
  static constexpr int kBatch = 8;
  const float* __restrict__ T;
  float* __restrict__ Ts;
  int W, slices, r0, r1, ptiles, tiles, j, q;
  long long stride;
  bool vec;

  __device__ Transpose(const float* T_, float* Ts_, int nsub, int W_, int slices_,
                       long long stride_, bool vec_)
      : T(T_), Ts(Ts_), W(W_), slices(slices_), stride(stride_), vec(vec_) {
    const int ncta = gridDim.x * gridDim.y;
    const int per = ((nsub + ncta - 1) / ncta + 7) / 8 * 8;
    r0 = (blockIdx.y * gridDim.x + blockIdx.x) * per;
    r1 = min(nsub, r0 + per);
    ptiles = (slices + 3) / 4;
    tiles = max(0, (r1 - r0 + 7) / 8) * ptiles;
    j = threadIdx.x % 8;
    q = (threadIdx.x % kWarp) / 8;
  }
  // tile t's row i and slice p for this lane; false where it has none
  __device__ bool at(int t, int& i, int& p) const {
    i = r0 + (t / ptiles) * 8 + j;
    p = (t % ptiles) * 4 + q;
    return t < tiles && i < r1 && p < slices;
  }
  __device__ void load(float (&v)[kBatch][C], int t0) const {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      int i, p;
      if (at(t0 + b * kWarps, i, p)) load_cols<C>(v[b], T + (long long)i * W, p * C, W, vec);
    }
  }
  __device__ void store(const float (&v)[kBatch][C], int t0) const {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      int i, p;
      if (!at(t0 + b * kWarps, i, p)) continue;
      float* dst = Ts + p * stride + (long long)i * C;
      if constexpr (C == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(v[b][0], v[b][1], v[b][2], v[b][3]);
      else if constexpr (C == 2)
        *reinterpret_cast<float2*>(dst) = make_float2(v[b][0], v[b][1]);
      else
        *dst = v[b][0];
    }
  }
};

// Copies the ids of group blockIdx.y into sids by 4-byte cp.async (the
// caller commits the group and waits for it); returns their count.
__device__ __forceinline__ int copy_ids(const int* __restrict__ ids, int* sids,
                                        long long n_used, int per) {
  const long long lo = (long long)blockIdx.y * per;
  const int n = (int)max(0LL, min((long long)per, n_used - lo));
  for (int i = threadIdx.x; i < n; i += kThreads)
    libfm::cp_async4(reinterpret_cast<float*>(sids + i),
                     reinterpret_cast<const float*>(ids + lo + i));
  return n;
}

// Of a warp whose lanes hold residues b (valid where `valid`), the lanes
// of residue `lane` (for lane < 2^kBits), and in *peers those of the
// calling lane's own residue: kBits ballots of the residues' bits.
template <int kBits>
__device__ __forceinline__ unsigned residue_lanes(int b, bool valid, int lane,
                                                  unsigned* peers = nullptr) {
  const unsigned in = __ballot_sync(libfm::kFullMask, valid);
  unsigned mine = in, own = in;
#pragma unroll
  for (int k = 0; k < kBits; ++k) {
    const unsigned m = __ballot_sync(libfm::kFullMask, (b >> k) & 1);
    mine &= (lane >> k) & 1 ? m : ~m;
    own &= (b >> k) & 1 ? m : ~m;
  }
  if (peers) *peers = own;
  return mine;
}

// The ids copied to raw (copy_ids), mod nsub, go in bank order into sids
// (count_ids, then place_ids): with K = 32 / C rows to a sweep of the 32
// banks, the ids of residue b (mod K) are ranked (in copied order: a warp
// a contiguous range) and id j of residue b goes to round j, the rounds
// one after another, each holding one id of every residue that has a
// j-th. So K consecutive positions (the lanes of one phase of a C-float
// read) hit K distinct banks wherever the rounds are full. A warp's lanes
// find their residue's peers from log2 K ballots, and lane b < K counts
// residue b. cnt: kWarps * K + K ints of shared memory.
//
// count_ids: each warp counts its ids of each residue (reducing raw mod
// nsub in place), then cnt[w][b] becomes warp w's first rank of residue b
// and tot[b] the residue's total.
template <int C>
__device__ __forceinline__ void count_ids(int* raw, int* cnt, int n, int nsub) {
  constexpr int K = kWarp / C, kBits = C == 4 ? 3 : C == 2 ? 4 : 5;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int span = ((n + kWarps - 1) / kWarps + kWarp - 1) / kWarp * kWarp;
  int count = 0;
#pragma unroll 2
  for (int p0 = warp * span; p0 < (warp + 1) * span; p0 += kWarp) {
    const int p = p0 + lane, v = p < n ? mod(raw[p], nsub) : 0;
    if (p < n) raw[p] = v;  // read again by this lane in place_ids
    count += __popc(residue_lanes<kBits>(v & (K - 1), p < n, lane));
  }
  if (lane < K) cnt[warp * K + lane] = count;
  __syncthreads();
  int* tot = cnt + kWarps * K;
  if (threadIdx.x < K) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = cnt[w * K + threadIdx.x];
      cnt[w * K + threadIdx.x] = run;
      run += t;
    }
    tot[threadIdx.x] = run;
  }
  __syncthreads();
}

// place_ids: each id to its place in the rounds.
template <int C>
__device__ __forceinline__ void place_ids(const int* raw, int* sids, const int* cnt, int n) {
  constexpr int K = kWarp / C, kBits = C == 4 ? 3 : C == 2 ? 4 : 5;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned lt = (1u << lane) - 1;
  const int span = ((n + kWarps - 1) / kWarps + kWarp - 1) / kWarp * kWarp;
  const int* tot = cnt + kWarps * K;
  int t[K], full = n;  // full: the rounds below it hold every residue
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = tot[k], full = min(full, t[k]);
  int next = lane < K ? cnt[warp * K + lane] : 0;  // lane b: the next rank of residue b
#pragma unroll 2
  for (int p0 = warp * span; p0 < (warp + 1) * span; p0 += kWarp) {
    const int p = p0 + lane, v = p < n ? raw[p] : 0, b = v & (K - 1);
    unsigned peers;
    const unsigned mine = residue_lanes<kBits>(b, p < n, lane, &peers);
    const int j = __shfl_sync(libfm::kFullMask, next, b) + __popc(peers & lt);
    if (p < n) {
      int pos = j * K + b;
      if (j >= full) {
        pos = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) pos += min(t[k], j) + (k < b && t[k] > j);
      }
      sids[pos] = v;
    }
    next += __popc(mine);
  }
}

// After the CTAs of column slice blockIdx.x (cols columns from c0) have
// written their partials part[rep][group][W]: the last of them to arrive
// (the slice's ticket after a fence) sums each rep's groups in group
// order into buf (cap floats of its shared memory, at least kThreads,
// free by now), runs acc = scale * acc + S_r for the slice's columns
// (rounded as the plain version: the product, then the sum) and zeroes
// the ticket.
__device__ __forceinline__ void finish(const float* part, int* ticket, int* flag, float* buf,
                                       int cap, float* out, int W, int c0, int cols, int reps,
                                       float scale, int writers) {
  const int groups = gridDim.y;
  if (threadIdx.x < writers) __threadfence();  // the threads that wrote partials
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(ticket + blockIdx.x, 1) == (int)(gridDim.y * gridDim.z) - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  cols = min(cols, W - c0);
  const int rc = cap / cols;
  float acc = 0.0f;
  for (int r0 = 0; r0 < reps; r0 += rc) {
    const int nr = min(rc, reps - r0);
    for (int e = threadIdx.x; e < nr * cols; e += kThreads) {
      const float* p = part + (long long)(r0 + e / cols) * groups * W + c0 + e % cols;
      float s = 0.0f;
#pragma unroll 8
      for (int g = 0; g < groups; ++g) s += __ldcg(p + (long long)g * W);
      buf[e] = s;
    }
    __syncthreads();
    if (threadIdx.x < cols)
      for (int i = 0; i < nr; ++i)
        acc = __fadd_rn(__fmul_rn(scale, acc), buf[i * cols + threadIdx.x]);
    __syncthreads();
  }
  if (threadIdx.x < cols) out[c0 + threadIdx.x] = acc;
  if (threadIdx.x == 0) ticket[blockIdx.x] = 0;
}

// Shared memory: [flag, mbarrier | head kHeadFloats | slice nsub x C (to
// 16 B) | ids per (in bank order) | ids per (as copied)]. ticket: the
// slices' tickets, then the grid barrier's two counters; Ts: the
// fill's scratch [slices][round4(nsub C)].
template <int C>
__global__ void __launch_bounds__(kThreads)
read_shared(const float* __restrict__ T, const int* __restrict__ ids, float* __restrict__ part,
            int* __restrict__ ticket, float* __restrict__ out, float* __restrict__ Ts,
            long long n_used, int nsub, int W, int reps, float scale, int per, int cap, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* flag = reinterpret_cast<int*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 8);
  float* head = reinterpret_cast<float*>(smem + kFlagBytes);
  float* slice = head + kHeadFloats;
  const int slice_floats = libfm::round4(nsub * C);
  int* sids = reinterpret_cast<int*>(slice + slice_floats);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int c0 = blockIdx.x * C;
  STAMP(0)
  // the ids first, as their own group of copies, so that they come in
  // ahead of the slice's
  int* raw = sids + per;
  int* cnt = reinterpret_cast<int*>(head);
  const int n = copy_ids(ids, raw, n_used, per);
  libfm::cp_async_commit();
  {  // all CTAs transpose T into Ts, then each copies its slice
    const Transpose<C> tp(T, Ts, nsub, W, gridDim.x, slice_floats, vec);
    float v[Transpose<C>::kBatch][C];
    for (int t0 = warp; t0 < tp.tiles; t0 += Transpose<C>::kBatch * kWarps) {
      tp.load(v, t0);
      tp.store(v, t0);
    }
  }
  fence_proxy_async_global();
  STAMP(1)
  grid_barrier(ticket + gridDim.x);
  if (tid == 0) {
    libfm::mbar_init(bar, 1);
    libfm::fence_mbar_init();
    fence_proxy_async_global();
    const uint64_t pol = libfm::policy_evict_first();
    const unsigned bytes = 4u * slice_floats;
    const float* src = Ts + (long long)blockIdx.x * slice_floats;
    libfm::mbar_arrive_tx(bar, bytes);
    for (unsigned off = 0; off < bytes; off += kBulkBytes)
      libfm::bulk_load(reinterpret_cast<char*>(slice) + off,
                       reinterpret_cast<const char*>(src) + off, min(kBulkBytes, bytes - off),
                       bar, pol);
    grid_leave(ticket + gridDim.x);
  }
  libfm::cp_async_wait<0>();
  __syncthreads();  // the ids (and the mbarrier's init) seen by every thread
  STAMP(2)
  // the ids in bank order while the slice's copies run
  count_ids<C>(raw, cnt, n, nsub);
  place_ids<C>(raw, sids, cnt, n);
  STAMP(3)
  libfm::mbar_wait(bar, 0);
  __syncthreads();
  STAMP(4)

  // A block of kRepBlock reps keeps its warps' sums in one of two buffers
  // and adds them after one barrier: a block's readers are done before the
  // block after next writes.
  auto keep = [&](const float (&acc)[C], int r) {
    const int rb = r % kRepBlock;
    float* ws = head + ((r / kRepBlock) & 1) * kRepBlock * kWarps * C;
    const float v = warp_cols<C>(acc, lane);
    if (!(lane & (kWarp / C - 1))) ws[(rb * kWarps + warp) * C + lane_col<C>(lane)] = v;
    if (rb == kRepBlock - 1 || r == reps - 1) {
      __syncthreads();
      if (tid < (rb + 1) * C && c0 + tid % C < W) {
        const float* w0 = ws + (tid / C) * kWarps * C + tid % C;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += w0[w * C];
        part[((long long)(r - rb + tid / C) * gridDim.y + blockIdx.y) * W + c0 + tid % C] = s;
      }
    }
  };
  int r = 0;
  for (; r + kRepsInFlight <= reps; r += kRepsInFlight) {
    float acc[kRepsInFlight][C];
    lookups<C, kRepsInFlight>(acc, slice, sids, n, nsub, r % nsub);
#pragma unroll
    for (int q = 0; q < kRepsInFlight; ++q) keep(acc[q], r + q);
  }
  for (; r < reps; ++r) {
    float acc[1][C];
    lookups<C, 1>(acc, slice, sids, n, nsub, r % nsub);
    keep(acc[0], r);
  }
  STAMP(5)
  finish(part, ticket, flag, head, cap, out, W, c0, C, reps, scale, kRepBlock * C);
  STAMP(6)
}

// Shared memory: [flag | wsum 2 x kWarps x kTile | ids per].
__global__ void __launch_bounds__(kThreads)
read_l2(const float* __restrict__ T, const int* __restrict__ ids, float* __restrict__ part,
        int* __restrict__ ticket, float* __restrict__ out, long long n_used, int nsub, int W,
        int reps, float scale, int per, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* flag = reinterpret_cast<int*>(smem);
  float* wsum = reinterpret_cast<float*>(smem + kFlagBytes);
  int* sids = reinterpret_cast<int*>(wsum + 2 * kWarps * kTile);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int c0 = blockIdx.x * kTile;
  const int n = copy_ids(ids, sids, n_used, per);
  libfm::cp_async_commit();
  libfm::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) sids[i] = mod(sids[i], nsub);
  __syncthreads();

  for (int r = blockIdx.z, k = 0; r < reps; r += gridDim.z, ++k) {
    const int rr = r % nsub;
    float acc[4] = {};
#pragma unroll 4
    for (int i = warp; i < n; i += kWarps) {
      const float* p = T + (long long)wrap(sids[i] + rr, nsub) * W;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = c0 + lane + kWarp * t;
        if (c < W) acc[t] += __ldg(p + c);
      }
    }
    float* ws = wsum + (k & 1) * kWarps * kTile;
#pragma unroll
    for (int t = 0; t < 4; ++t) ws[warp * kTile + lane + kWarp * t] = acc[t];
    __syncthreads();
    if (tid < kTile && c0 + tid < W) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += ws[w * kTile + tid];
      part[((long long)r * gridDim.y + blockIdx.y) * W + c0 + tid] = s;
    }
  }
  finish(part, ticket, flag, wsum, cap, out, W, c0, kTile, reps, scale, kTile);
}

// The shared form's launch: a cooperative launch, every CTA of the grid
// resident at once (the plan keeps the grid within one CTA an SM); a grid
// the card cannot hold so is refused.
template <int C>
cudaError_t launch_shared(dim3 grid, long long smem, cudaStream_t stream, const float* T,
                          const int* ids, float* part, int* ticket, float* out, float* Ts,
                          long long n_used, int nsub, int W, int reps, float scale, int per) {
  constexpr auto kernel = read_shared<C>;
  const long long ctas = (long long)grid.x * grid.y;
  unsigned wave;  // the CTAs resident at once (allows the kernel its shared memory)
  const cudaError_t err = libfm::one_wave_grid<kernel>(kThreads, (int)smem, ctas, &wave);
  if (err != cudaSuccess) return err;
  if (wave < ctas) return cudaErrorCooperativeLaunchTooLarge;
  const int vec = C > 1 && W % C == 0 && reinterpret_cast<uintptr_t>(T) % (4 * C) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int cap = (int)((smem - kFlagBytes) / 4);
  return cudaLaunchKernelEx(&cfg, kernel, T, ids, part, ticket, out, Ts, n_used, nsub, W, reps,
                            scale, per, cap, vec);
}

}  // namespace

#ifdef TABLE_READ_TIMING
// The buffer of the phase stamps ([grid CTAs x kStamps] int64), or NULL.
extern "C" int table_read_stamps(long long* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
#endif

// Bytes of dynamic shared memory a CTA of `form` (0 shared, 1 l2) takes
// with a slice of `cols` columns (shared) and `per` ids: the host's plan
// (kernels/table_read.py smem_bytes) mirrors it.
extern "C" long long table_read_smem_bytes(int form, long long nsub, int cols, int per) {
  if (form == kL2) return kFlagBytes + 4LL * (2 * kWarps * kTile) + 4LL * per;
  return kFlagBytes + 4LL * kHeadFloats + 4LL * ((nsub * cols + 3) / 4 * 4) + 8LL * per;
}

// T [nsub, W]; ids [>= n_used], each in [0, 2^31); part scratch
// [reps, groups, W]; ticket [slices + 2] ints, zero before the call and
// left zero; Ts [slices, round4(nsub cols)] scratch of the shared form;
// out [W]. The plan: form, cols (the shared form's slice width: 4, 2 or
// 1), groups (id groups of `per` ids, per a multiple of 4, covering
// n_used), rep_split (the l2 form's CTAs over the reps) and smem
// (table_read_smem_bytes of them).
extern "C" int table_read_launch(const float* T, const int* ids, float* part, int* ticket,
                                 float* out, float* Ts, long long n_used, int nsub, int W, int reps,
                                 float scale, int form, int cols, int groups, int per,
                                 int rep_split, long long smem, cudaStream_t stream) {
  if (W < 1 || nsub < 1 || reps < 1 || n_used < 0 || groups < 1 || groups > 65535 ||
      per < 0 || per % 4 || (long long)groups * per < n_used ||
      (form != kShared && form != kL2) ||
      (form == kShared && ((cols != 1 && cols != 2 && cols != 4) || rep_split != 1)) ||
      rep_split < 1 || rep_split > 65535 || rep_split > reps ||
      (form == kShared && !Ts) || smem != table_read_smem_bytes(form, nsub, cols, per))
    return (int)cudaErrorInvalidValue;
  if (form == kL2) {  // at most 20,496 bytes of shared memory: no attribute to set
    const dim3 grid((W + kTile - 1) / kTile, groups, rep_split);
    read_l2<<<grid, kThreads, smem, stream>>>(T, ids, part, ticket, out, n_used, nsub, W, reps,
                                              scale, per, (int)((smem - kFlagBytes) / 4));
    return (int)cudaGetLastError();
  }
  const dim3 grid((W + cols - 1) / cols, groups);
  auto launch = cols == 4 ? launch_shared<4> : cols == 2 ? launch_shared<2> : launch_shared<1>;
  const cudaError_t err = launch(grid, smem, stream, T, ids, part, ticket, out, Ts, n_used,
                                 nsub, W, reps, scale, per);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
