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
// Design (a first version, simple and right): one warp a slot, lanes over
// the k factors (up to 4 a lane), the dot product by warp shuffles; CTAs
// of 8 warps over consecutive slots, so the slots of one feature (adjacent
// in its list) read their table row from L1 or L2. The A rows lie at
// random: each costs its 32-byte sectors, a little more than its bytes.

#include "common.cuh"

namespace {

using libfm::kMaxK;
using libfm::kWarp;
using libfm::warp_sum;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kLaneFactors = kMaxK / kWarp;  // 4

__global__ void __launch_bounds__(kThreads)
    slot_update_kernel(float* __restrict__ A, const int* __restrict__ slot_case,
                       const float* __restrict__ slot_val, const int* __restrict__ slot_feat,
                       const float* __restrict__ tab, long long E, int tab_stride, int k) {
  const long long s = (blockIdx.x * (long long)kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  if (s >= E) return;
  const int d = k + 1;
  const float x = slot_val[s];
  const float* t = tab + (long long)slot_feat[s] * tab_stride;
  float* a = A + (long long)slot_case[s] * d;
  float dv[kLaneFactors];
  float p = 0.0f;
#pragma unroll
  for (int i = 0; i < kLaneFactors; ++i) {
    const int f = lane + kWarp * i;
    dv[i] = 0.0f;
    if (f < k) {
      dv[i] = t[1 + f];
      p = fmaf(a[1 + f], dv[i], p);
    }
  }
  p = warp_sum(p);  // every lane has read its part of the row
  const float dpred =
      __fsub_rn(__fmul_rn(x, __fadd_rn(t[0], p)), __fmul_rn(__fmul_rn(x, x), t[1 + k]));
#pragma unroll
  for (int i = 0; i < kLaneFactors; ++i) {
    const int f = lane + kWarp * i;
    if (f < k) a[1 + f] = __fadd_rn(a[1 + f], __fmul_rn(x, dv[i]));
  }
  if (lane == 0) a[0] = __fadd_rn(a[0], dpred);
}

}  // namespace

// A [nc, k+1] updated in place; slot_case / slot_val / slot_feat [E] (the
// block's slots; slot_feat rows of tab, whose rows lie tab_stride floats
// apart, [F+1, k+2] from update_table).
extern "C" int slot_update_launch(float* A, const int* slot_case, const float* slot_val,
                                  const int* slot_feat, const float* tab, long long E,
                                  int tab_stride, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || E < 0 || tab_stride < k + 2) return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  const long long grid = (E + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  slot_update_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(A, slot_case, slot_val,
                                                              slot_feat, tab, E, tab_stride, k);
  return (int)cudaGetLastError();
}
