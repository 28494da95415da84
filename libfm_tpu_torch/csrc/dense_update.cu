// dense_update: case-major update of the per-case cache A = [e | Q] after
// one conflict-free block's draws. Works IN PLACE on A.
//
// Replaces, in libfm_tpu/learners/mcmc_vector.py, sweep_block.upd_dense.
// Per case c with block-local feature col[c] (F = the block has no
// feature in this case) and value x (val[c], or 1 for one-hot blocks):
//   t = tab[col[c]] = [dw | dv | s = v_old . dv]   (row F is zero)
//   A[c, 0]  += x (t0 + A[c, 1:] . dv) - x^2 s
//   A[c, 1:] += x dv
// which is e += x (dw + qp . dv), qp = Q - x v_old, and Q += x dv.
// A conflict-free block holds at most one feature per case, so no two
// cases share a row of A: the in-place update has no race.
//
// Bound on the H100 at ML-10M (k=64): bytes, the A read and write
// (2 x 2.34 GB per block) plus col (36 MB) and the table [F+1, k+2]
// (18.9 MB for the user block), gathered at random. Measured on the H100
// (chip_smoke.py's gather-against-streaming line): with every case on
// the table's first 1,024 rows (hot in L2) both launches take ~0.3 ms
// less than with the real ids, so a share of the gathered rows misses L2.
// Design: a streaming pass over A in tiles of kTile = 32 cases (a
// multiple of 4, so a tile of [kTile, k+1] floats is whole 16-byte pieces
// for every k), over a persistent grid of one wave of resident CTAs (two
// an SM at k=64). In each CTA one producer warp, a lane a case, reads a
// tile's col/val (a tile ahead, into registers) into a ring of
// shared-memory stages (as many as 105 KB holds, 2 to 8; 6 at k=64). If
// any case of the tile lies in the block, it starts a 1-D bulk copy (TMA)
// of the tile's A rows into the stage, and one bulk copy of each distinct
// table row of the tile's cases (the first lane of those that share a row
// copies it; the table's rows are padded to whole 16-byte pieces,
// `update_table`), all completing on the stage's mbarrier. Bulk copies
// of one and the same row serialise: when every case of a tile copied
// its own row, a block whose cases all lay on one row took 33 ms, and
// skewed ids (CTR fields) put many cases of a tile on one row. Eight
// consumer warps then update the stage from shared memory alone: lanes
// over k, a warp's cases side by side, so their loads and shuffle sums
// interleave. One consumer thread stores the tile back with a bulk store
// and frees its stage once the next tile's store is under way and this
// one has read it. A tile with no case of the block moves no bytes of A
// or of the table. The rows past the last whole tile are updated in
// global memory by one CTA. L2 policies: evict-first on A, which each
// pass touches once, and evict-last on the table rows (4% faster than
// without at config #3).
// What was measured on the way (config #3, both launches, H100; PERF.md):
// the first design gathered the table rows in the consumers, 4.00 ms
// against 3.37 with every case on table row 0; copying them by 4- and
// 8-byte cp.async from the producer warp bounded the kernel at 8.2 ms;
// one CTA an SM with 6 stages of 64 cases and 16 consumer warps took
// 5.40 ms, its tiles passing one after another through one set of
// consumers; tiles of 64 cases took 3.83 ms where 32 take 3.80. Offsets
// into A are int64; A must be 16-byte aligned. The pure linear model
// (k = 0: A = [e], table rows [dw | 0]) takes a kernel of its own, one
// thread a case (dense_update_k0): the tiled kernel's k <= 32 instance,
// whose tiles of A are then 128 B, ran it at 2.119 ms for config #3's 2
// blocks against 0.065 of bytes.

#include "common.cuh"

namespace {

using libfm::kMaxK;
using libfm::kWarp;
constexpr int kTile = 32;
constexpr int kMaxStages = 8;
constexpr size_t kStageBudget = 105 * 1024;  // shared memory for the stages
constexpr int kConsumerWarps = 8;
constexpr int kCases = kTile / kConsumerWarps;  // a consumer warp's cases a tile
constexpr int kConsumers = kConsumerWarps * kWarp;
constexpr int kThreads = kConsumers + kWarp;  // + the producer warp
static_assert(kTile == kWarp, "a producer lane a case");
static_assert(kTile % kConsumerWarps == 0, "a consumer warp's cases");

// Floats between table rows: k + 2, rounded up to whole 16-byte pieces.
__host__ __device__ inline int table_stride(int d) { return libfm::round4(d + 1); }

// Shared memory: ns tiles of A [kTile, d], ns tiles of table rows
// [kTile, table_stride(d)], the slot of each case's row, val and a flag
// per stage, then the full and empty mbarriers.
__host__ __device__ inline size_t barrier_offset(int d, int ns) {
  const size_t floats =
      (size_t)ns * kTile * (d + table_stride(d)) + 2 * (size_t)ns * kTile + ns;
  return (floats * 4 + 7) & ~size_t(7);
}

__host__ __device__ inline size_t smem_bytes(int d, int ns) {
  return barrier_offset(d, ns) + 2 * ns * sizeof(uint64_t);
}

// The most shared memory any width takes: the budget, or two stages at
// k = kMaxK, and the flags and barriers.
constexpr size_t kMaxSmem =
    (kStageBudget > 2 * (size_t)kTile * (2 * kMaxK + 6) * 4
         ? kStageBudget
         : 2 * (size_t)kTile * (2 * kMaxK + 6) * 4) +
    1024;

// Stages for width d: as many as kStageBudget holds, 2 to kMaxStages.
inline int stages(int d) {
  const size_t per = (size_t)kTile * (d + table_stride(d) + 2) * 4;
  const int ns = (int)(kStageBudget / per);
  return ns < 2 ? 2 : ns > kMaxStages ? kMaxStages : ns;
}

// One case of the update in place on row a (global or shared memory)
// from its table row t, in two steps so that a warp can run several side
// by side: load() reads Q and dv and forms this lane's part of Q . dv;
// after the warp sum of `dot`, store() writes e and Q back. A lane holds
// factors lane + 32 i, i < NPL.
template <int NPL>
struct Case {
  float q[NPL], tv[NPL], dot;

  __device__ __forceinline__ void load(const float* a, const float* t, int lane, int k) {
    dot = 0.0f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int f = lane + kWarp * i;
      q[i] = f < k ? a[1 + f] : 0.0f;
      tv[i] = f < k ? t[1 + f] : 0.0f;
      dot += q[i] * tv[i];
    }
  }

  __device__ __forceinline__ void store(float* a, const float* t, float x, int lane,
                                        int k) const {
    if (lane == 0) a[0] += x * (t[0] + dot) - (x * x) * t[1 + k];
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int f = lane + kWarp * i;
      if (f < k) a[1 + f] = q[i] + x * tv[i];
    }
  }
};

template <int NPL>
__global__ void __launch_bounds__(kThreads)
dense_update_kernel(float* __restrict__ A, const int* __restrict__ col,
                    const float* __restrict__ val, const float* __restrict__ tab,
                    long long nc, int F, int k, int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = k + 1;
  const int dt = table_stride(d);
  const long long ntiles = nc / kTile;
  float* tiles = reinterpret_cast<float*>(smem);
  float* stab = tiles + ns * kTile * d;
  // per case: the slot of its table row in the stage, -1 outside the block
  int* sslot = reinterpret_cast<int*>(stab + ns * kTile * dt);
  float* sval = reinterpret_cast<float*>(sslot + ns * kTile);
  int* sany = reinterpret_cast<int*>(sval + ns * kTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + barrier_offset(d, ns));
  uint64_t* empty = full + ns;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const unsigned tile_bytes = kTile * d * 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      libfm::mbar_init(&full[s], kWarp);  // the producer warp's lanes
      libfm::mbar_init(&empty[s], 1);     // the consumer that stored the tile
    }
    libfm::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: lane j takes case j of each tile
    const uint64_t pol = libfm::policy_evict_first();
    const uint64_t pol_t = libfm::policy_evict_last();
    const unsigned row_bytes = dt * 4;
    int cn = F;  // the next tile's col and val of the lane's case
    float vn = 1.0f;
    auto fetch = [&](long long t) {
      const long long c = t * kTile + lane;
      cn = __ldcs(col + c);
      vn = val != nullptr ? __ldcs(val + c) : 1.0f;
    };
    if (blockIdx.x < ntiles) fetch(blockIdx.x);
    long long it = 0;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
      const int s = (int)(it % ns);
      const unsigned use = (unsigned)(it / ns);
      const int cc = cn;
      const float vv = vn;
      if (t + gridDim.x < ntiles) fetch(t + gridDim.x);  // the next tile's, early
      // the lanes whose cases share a table row; the first of them copies it
      const int first = __ffs(__match_any_sync(libfm::kFullMask, cc)) - 1;
      const bool copies = cc != F && first == lane;
      const int rows = __popc(__ballot_sync(libfm::kFullMask, copies));
      const bool any = rows > 0;
      libfm::mbar_wait(&empty[s], (use & 1) ^ 1);
      sslot[s * kTile + lane] = cc != F ? first : -1;
      sval[s * kTile + lane] = vv;
      if (lane == 0) sany[s] = any;
      if (any) {
        if (lane == 0) {
          libfm::mbar_arrive_tx(&full[s], tile_bytes + rows * row_bytes);
          libfm::bulk_load(tiles + (size_t)s * kTile * d, A + t * kTile * d, tile_bytes,
                           &full[s], pol);
        }
        __syncwarp();
        if (copies)
          libfm::bulk_load(stab + ((size_t)s * kTile + lane) * dt,
                           tab + (long long)cc * dt, row_bytes, &full[s], pol_t);
      }
      if (!(any && lane == 0)) libfm::mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers
  const uint64_t pol_a = libfm::policy_evict_first();
  int pending = -1;  // the stage of the last stored tile, freed once read
  long long it = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int s = (int)(it % ns);
    libfm::mbar_wait(&full[s], (unsigned)(it / ns) & 1);
    const bool any = sany[s] != 0;
    float* a_tile = tiles + (size_t)s * kTile * d;
    if (any) {
      const float* st = stab + (size_t)s * kTile * dt;
      // the warp's kCases cases side by side: their loads and shuffle
      // sums interleave instead of running as kCases chains in a row
      Case<NPL> cs[kCases];
      int slot[kCases];
#pragma unroll
      for (int u = 0; u < kCases; ++u) {
        const int c = warp + kConsumerWarps * u;
        slot[u] = sslot[s * kTile + c];
        // outside the block (slot -1): any staged row, the result unused
        cs[u].load(a_tile + c * d, st + max(slot[u], 0) * dt, lane, k);
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kCases; ++u)
          cs[u].dot += __shfl_xor_sync(libfm::kFullMask, cs[u].dot, o);
      }
#pragma unroll
      for (int u = 0; u < kCases; ++u) {
        const int c = warp + kConsumerWarps * u;
        if (slot[u] < 0) continue;  // outside the block: stays as read
        cs[u].store(a_tile + c * d, st + slot[u] * dt, sval[s * kTile + c], lane, k);
      }
      libfm::fence_proxy_async();
    }
    libfm::named_sync(1, kConsumers);
    if (threadIdx.x == 0) {
      if (any) {
        libfm::bulk_store(A + t * kTile * d, a_tile, tile_bytes, pol_a);
        libfm::bulk_commit();
        libfm::bulk_wait_read<1>();  // the store before this one has read its stage
        if (pending >= 0) libfm::mbar_arrive(&empty[pending]);
        pending = s;
      } else {
        // nothing to store; free the stage of the last store as well, so a
        // run of such tiles cannot hold the ring
        libfm::bulk_wait_read<0>();
        if (pending >= 0) libfm::mbar_arrive(&empty[pending]);
        pending = -1;
        libfm::mbar_arrive(&empty[s]);
      }
    }
  }
  if (threadIdx.x == 0) libfm::bulk_wait<0>();

  // the rows past the last whole tile, in global memory, one warp a case
  if (blockIdx.x == gridDim.x - 1) {
    for (long long c = ntiles * kTile + warp; c < nc; c += kConsumerWarps) {
      const int cb = col[c];
      if (cb == F) continue;
      const float* row = tab + (long long)cb * dt;
      Case<NPL> one;
      one.load(A + c * d, row, lane, k);
      one.dot = libfm::warp_sum(one.dot);
      one.store(A + c * d, row, val != nullptr ? val[c] : 1.0f, lane, k);
    }
  }
}

// k = 0: per case in the block, e += x dw - x^2 s (s = 0: no factor), in
// the tiled kernel's order of operations; cases outside it are not
// written. Bound: bytes, col (and val) read, e read and written.
constexpr int kK0Threads = 256;

__global__ void __launch_bounds__(kK0Threads)
    dense_update_k0(float* __restrict__ A, const int* __restrict__ col,
                    const float* __restrict__ val, const float* __restrict__ tab, long long nc,
                    int F) {
  for (long long c = blockIdx.x * (long long)kK0Threads + threadIdx.x; c < nc;
       c += (long long)gridDim.x * kK0Threads) {
    const int cb = col[c];
    if (cb == F) continue;
    const float x = val != nullptr ? val[c] : 1.0f;
    const float* t = tab + (long long)cb * table_stride(1);
    A[c] += x * (t[0] + 0.0f) - (x * x) * t[1];
  }
}

template <int NPL>
int launch(float* A, const int* col, const float* val, const float* tab, long long nc,
           int F, int k, cudaStream_t stream) {
  const int d = k + 1;
  const int ns = stages(d);
  const size_t smem = smem_bytes(d, ns);
  auto kernel = dense_update_kernel<NPL>;
  // per width d: resident CTAs an SM (0 = not yet asked)
  static int sms = 0;
  static int resident[kMaxK + 2] = {0};
  cudaError_t err;
  if (resident[d] == 0) {
    int dev;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kMaxSmem)) != cudaSuccess)
      return (int)err;
    int occ = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                             smem)) != cudaSuccess)
      return (int)err;
    resident[d] = occ > 0 ? occ : 1;
  }
  const long long ntiles = nc / kTile;
  long long grid = (long long)sms * resident[d];
  if (grid > ntiles) grid = ntiles > 0 ? ntiles : 1;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(A, col, val, tab, nc, F, k, ns);
  return (int)cudaGetLastError();
}

}  // namespace

// A [nc, k+1] (updated in place; 16-byte aligned); col [nc]; val [nc] or
// NULL (one-hot); tab [F+1, k+2] with a zero row F, 16-byte aligned, rows
// round4(k+2) floats apart (update_table's layout). The grid is one wave of resident CTAs (at most one a tile).
extern "C" int dense_update_launch(float* A, const int* col, const float* val,
                                   const float* tab, long long nc, int F, int k,
                                   cudaStream_t stream) {
  if (k < 0 || k > kMaxK || (reinterpret_cast<uintptr_t>(A) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(tab) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (nc == 0) return (int)cudaSuccess;
  if (k == 0) {
    long long grid = (nc + kK0Threads - 1) / kK0Threads;
    if (grid > 4096) grid = 4096;
    dense_update_k0<<<(unsigned)grid, kK0Threads, 0, stream>>>(A, col, val, tab, nc, F);
    return (int)cudaGetLastError();
  }
  if (k <= 32) return launch<1>(A, col, val, tab, nc, F, k, stream);
  if (k <= 64) return launch<2>(A, col, val, tab, nc, F, k, stream);
  return launch<4>(A, col, val, tab, nc, F, k, stream);
}
