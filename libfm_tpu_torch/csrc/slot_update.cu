// slot_update: the slot-scatter update of the per-case cache A = [e | Q]
// after one conflict-free block's draws. Works IN PLACE on A.
//
// Replaces, in libfm_tpu/learners/mcmc_vector.py, sweep_block.upd_chunk
// (K4b): the update the JAX engine takes for a block whose entries cover
// fewer than num_rows // 4 cases, and for every block with
// dense_update=False. Per slot s of the block, with case c = slot_case[s],
// value x = slot_val[s] and block-local feature f = slot_feat[s],
//   t = tab[f] = [dw | dv | s_f = v_old . dv]
//   A[c, 0]  += x (dw + A[c, 1:] . dv) - x^2 s_f
//   A[c, 1:] += x dv
// which is e += x (dw + qp . dv), qp = Q - x v_old, and Q += x dv: the same
// update as dense_update, over the block's slots instead of every case.
// A conflict-free block holds at most one slot per case, so each row of A
// has one writer: a plain read-modify-write, no atomics, the same bits on
// every run.
//
// Bound on the H100: bytes. Each slot reads and writes its row of A (k+1
// floats each way) and reads its case, value and feature (12 bytes); the
// table [F+1, k+2] is read once, its rows gathered again from L2 (19.5 MB
// for config #3's user block at k=64, under the 50 MB of L2). At config #3
// with dense_update=False: 2 blocks x 9M slots x (2 x 260 + 12) bytes =
// 9.6 GB an iteration, ~2.9 ms at 3.35 TB/s.
// Design: the learners pass the slots in case order (kernels/slot_update.py
// case_order), so that A's rows are read in address order. Each warp
// updates a chunk of kChunk consecutive slots, kSlots at a time, through a
// ring of kStages shared-memory stages: while one stage is updated, the
// next two are in flight. A stage is filled by bulk copies (TMA without a
// tensor map, as dense_update.cu's tiles) that complete on the stage's
// mbarrier: a stage whose kSlots cases are consecutive (a block that
// covers every case, such as config #3's) is one run of rows, copied as
// one span of 16-byte pieces; else each slot's row is copied on its own
// (the 16-byte span around it); and each slot's table row (update_table's
// rows are whole 16-byte pieces). The neighbouring floats a span takes in
// are read, never written. The slots' (case, value, feature) are read a
// stage ahead of their copies, into lanes. A warp updates its stage's
// slots kSide side by side (lanes over k, the dot products by warp
// shuffles), in the first version's order of operations for each row,
// and stores each row straight back to A.
// The pure linear model (k = 0: A = [e]) takes a kernel of its own, one
// thread a slot (slot_update_k0): the staged kernel's k <= 32 instance
// ran it at 1.876 ms for config #3's 2 blocks against 0.108 of bytes.
// The first version (PERF.md: 5.776 ms at config #3's 2 blocks) took one
// slot a warp in feature order: three dependent index loads, then a row
// at a random place, one slot in flight per warp.

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kMaxK;
using libfm::kWarp;
using libfm::warp_sum;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kSlots = 8;   // slots of a stage
constexpr int kStages = 3;  // two stages in flight while one is updated
constexpr int kChunk = 128;  // slots a warp updates
constexpr int kSide = 4;  // slots a warp updates side by side
static_assert(kChunk % kSlots == 0 && kSlots % kSide == 0, "whole stages");

// Floats of a staged A row (the 16-byte span around its d floats), of a
// staged table row (update_table's row: k + 2 floats in 16-byte pieces)
// and of one stage.
__host__ __device__ inline int a_stride(int d) { return libfm::round4(d + 3); }
__host__ __device__ inline int t_stride(int k) { return libfm::round4(k + 2); }
__host__ __device__ inline int stage_floats(int k) {
  return kSlots * (a_stride(k + 1) + t_stride(k));
}

__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

template <int NPL>  // factors a lane: ceil(k / 32)
__global__ void __launch_bounds__(kThreads)
    slot_update_kernel(float* __restrict__ A, const int* __restrict__ slot_case,
                       const float* __restrict__ slot_val, const int* __restrict__ slot_feat,
                       const float* __restrict__ tab, long long E, int tab_stride, int k,
                       long long num_rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bars[kWarps][kStages];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long lo = ((long long)blockIdx.x * kWarps + warp) * kChunk;
  if (lo >= E) return;
  const long long hi = min(lo + kChunk, E);
  const int nst = (int)((hi - lo + kSlots - 1) / kSlots);
  const int d = k + 1, AS = a_stride(d), TS = t_stride(k), SF = stage_floats(k);
  float* ring = smem + warp * kStages * SF;
  uint64_t* bar = bars[warp];
  const float* a_end = A + num_rows * d;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) libfm::mbar_init(&bar[s], 1);
    libfm::fence_mbar_init();
  }
  __syncwarp();
  const uint64_t pol_a = libfm::policy_evict_first();
  const uint64_t pol_t = libfm::policy_evict_last();

  // lane i < kSlots holds slot i of stage s: its case (-1: none), value
  // and feature
  struct Slot {
    int c, f;
    float x;
  };
  auto load_index = [&](int s) {
    Slot r{-1, 0, 0.0f};
    const long long pos = lo + (long long)s * kSlots + lane;
    if (s < nst && lane < kSlots && pos < hi) {
      r.c = slot_case[pos];
      r.x = slot_val[pos];
      r.f = slot_feat[pos];
    }
    return r;
  };
  // whether the stage's cases are one run of kSlots consecutive rows
  auto is_run = [&](const Slot& sl) {
    const int c0 = __shfl_sync(kFullMask, sl.c, 0);
    return __all_sync(kFullMask, lane >= kSlots || (c0 >= 0 && sl.c == c0 + lane));
  };
  // the 16-byte span around floats [p, p + n) of A, cut at A's last whole
  // piece; the floats past the cut are copied by the lane itself
  auto span = [&](const float* p, int n, const float*& from, unsigned& bytes,
                  const float*& rest) {
    from = reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
    const float* to = reinterpret_cast<const float*>(
        (reinterpret_cast<uintptr_t>(p + n) + 15) & ~uintptr_t(15));
    rest = to;
    if (to > a_end) {
      rest = reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(a_end) &
                                            ~uintptr_t(15));
      to = rest;
    }
    bytes = (unsigned)(reinterpret_cast<uintptr_t>(to) - reinterpret_cast<uintptr_t>(from));
  };
  auto fetch = [&](int s, const Slot& sl) {
    if (s >= nst) return;
    float* st = ring + (s % kStages) * SF;
    float* stab = st + kSlots * AS;
    uint64_t* b = &bar[s % kStages];
    const bool run = is_run(sl);
    const float* from = A;
    const float* rest = A;
    unsigned a_bytes = 0;
    float* dst = st + lane * AS;
    if (run) {
      if (lane == 0) {
        span(A + (long long)sl.c * d, kSlots * d, from, a_bytes, rest);
        dst = st;
      }
    } else if (lane < kSlots && sl.c >= 0) {
      span(A + (long long)sl.c * d, d, from, a_bytes, rest);
    }
    const unsigned t_bytes = lane < kSlots && sl.c >= 0 ? 4u * TS : 0u;
    const unsigned total = __reduce_add_sync(kFullMask, a_bytes + t_bytes);
    libfm::fence_proxy_async();  // the stage's last reads come before these copies
    if (lane == 0) libfm::mbar_arrive_tx(b, total);
    __syncwarp();
    if (a_bytes) libfm::bulk_load(dst, from, a_bytes, b, pol_a);
    if (run ? lane == 0 : lane < kSlots && sl.c >= 0) {
      // the last floats of A, past its last whole 16-byte piece: a row
      // that starts there (k <= 2) has no bulk copy at all
      const float* end = (run ? A + (long long)(sl.c + kSlots) * d : A + (long long)sl.c * d + d);
      for (const float* q = rest; q < end; ++q) dst[q - from] = *q;
    }
    if (t_bytes) libfm::bulk_load(stab + lane * TS, tab + (long long)sl.f * tab_stride, t_bytes,
                                  b, pol_t);
  };
  // the stage's slots, kSide side by side: each row's update in the first
  // version's order of operations (its bits), stored straight back to A
  auto update = [&](int s, const Slot& sl) {
    const float* st = ring + (s % kStages) * SF;
    const float* stab = st + kSlots * AS;
    libfm::mbar_wait(&bar[s % kStages], (unsigned)(s / kStages) & 1);
    const bool run = is_run(sl);
    const int c0 = __shfl_sync(kFullMask, sl.c, 0);
    const float* a0 = run ? st + misalign(A + (long long)c0 * d) : st;
#pragma unroll
    for (int i0 = 0; i0 < kSlots; i0 += kSide) {
      int c[kSide];
      float x[kSide], e[kSide], p[kSide], dv[kSide][NPL], q[kSide][NPL];
      const float* t[kSide];
#pragma unroll
      for (int u = 0; u < kSide; ++u) {
        c[u] = __shfl_sync(kFullMask, sl.c, i0 + u);
        x[u] = __shfl_sync(kFullMask, sl.x, i0 + u);
        t[u] = stab + (i0 + u) * TS;
        const float* as = run ? a0 + (i0 + u) * d
                              : st + (i0 + u) * AS + misalign(A + (long long)max(c[u], 0) * d);
        p[u] = 0.0f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int col = lane + kWarp * j;
          dv[u][j] = q[u][j] = 0.0f;
          if (c[u] >= 0 && col < k) {
            dv[u][j] = t[u][1 + col];
            q[u][j] = as[1 + col];
            p[u] = fmaf(q[u][j], dv[u][j], p[u]);
          }
        }
        e[u] = c[u] >= 0 ? as[0] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kSide; ++u) p[u] = warp_sum(p[u]);
#pragma unroll
      for (int u = 0; u < kSide; ++u) {
        if (c[u] < 0) continue;
        float* a = A + (long long)c[u] * d;
        const float dpred = __fsub_rn(__fmul_rn(x[u], __fadd_rn(t[u][0], p[u])),
                                      __fmul_rn(__fmul_rn(x[u], x[u]), t[u][1 + k]));
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int col = lane + kWarp * j;
          if (col < k) a[1 + col] = __fadd_rn(q[u][j], __fmul_rn(x[u], dv[u][j]));
        }
        if (lane == 0) a[0] = __fadd_rn(e[u], dpred);
      }
    }
    __syncwarp();  // every lane has read the stage before it is refilled
  };

  static_assert(kStages == 3, "the index pipeline below holds two stages ahead");
  Slot cur = load_index(0);
  Slot next = load_index(1);
  fetch(0, cur);
  fetch(1, next);
  Slot after = load_index(2);
  for (int s = 0; s < nst; ++s) {
    fetch(s + 2, after);
    const Slot later = load_index(s + 3);
    update(s, cur);
    cur = next;
    next = after;
    after = later;
  }
}

// The pure linear model (k = 0: A = [e], tab rows [dw | 0]): one thread
// a slot, e += x dw - x^2 s in the staged kernel's order of operations
// (its dot product over no factor is 0). Bound: bytes, e read and
// written and the slot's case, value and feature read, 20 B a slot.
constexpr int kK0Threads = 256;

__global__ void __launch_bounds__(kK0Threads)
    slot_update_k0(float* __restrict__ A, const int* __restrict__ slot_case,
                   const float* __restrict__ slot_val, const int* __restrict__ slot_feat,
                   const float* __restrict__ tab, long long E, int tab_stride) {
  for (long long s = blockIdx.x * (long long)kK0Threads + threadIdx.x; s < E;
       s += (long long)gridDim.x * kK0Threads) {
    const float x = slot_val[s];
    const float* t = tab + (long long)slot_feat[s] * tab_stride;
    const float dpred = __fsub_rn(__fmul_rn(x, __fadd_rn(t[0], 0.0f)),
                                  __fmul_rn(__fmul_rn(x, x), t[1]));
    float* a = A + slot_case[s];
    *a = __fadd_rn(*a, dpred);
  }
}

template <int NPL>
int launch(float* A, const int* slot_case, const float* slot_val, const int* slot_feat,
           const float* tab, long long E, int tab_stride, int k, long long num_rows,
           cudaStream_t stream) {
  const long long grid = (E + (long long)kWarps * kChunk - 1) / ((long long)kWarps * kChunk);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kWarps * kStages * stage_floats(k);
  auto kern = slot_update_kernel<NPL>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(A, slot_case, slot_val, slot_feat, tab, E,
                                                   tab_stride, k, num_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// A [num_rows, k+1] updated in place (16-byte aligned); slot_case /
// slot_val / slot_feat [E] (the block's slots, in case order for speed;
// slot_feat rows of tab); tab [F+1, k+2] from update_table: 16-byte
// aligned, its rows tab_stride floats apart, a multiple of 4.
extern "C" int slot_update_launch(float* A, const int* slot_case, const float* slot_val,
                                  const int* slot_feat, const float* tab, long long E,
                                  int tab_stride, int k, long long num_rows,
                                  cudaStream_t stream) {
  if (k < 0 || k > kMaxK || E < 0 || tab_stride < t_stride(k) || tab_stride % 4 != 0 ||
      ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(tab)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  if (k == 0) {
    long long grid = (E + kK0Threads - 1) / kK0Threads;
    if (grid > 4096) grid = 4096;
    slot_update_k0<<<(unsigned)grid, kK0Threads, 0, stream>>>(A, slot_case, slot_val, slot_feat,
                                                              tab, E, tab_stride);
    return (int)cudaGetLastError();
  }
  if (k <= 32)
    return launch<1>(A, slot_case, slot_val, slot_feat, tab, E, tab_stride, k, num_rows, stream);
  if (k <= 64)
    return launch<2>(A, slot_case, slot_val, slot_feat, tab, E, tab_stride, k, num_rows, stream);
  if (k <= 96)
    return launch<3>(A, slot_case, slot_val, slot_feat, tab, E, tab_stride, k, num_rows, stream);
  return launch<4>(A, slot_case, slot_val, slot_feat, tab, E, tab_stride, k, num_rows, stream);
}
