// coord_draw: the exact engines' per-coordinate conjugate draws of one
// conflict-free block (K11), in four modes.
//
// Replaces, in libfm_tpu/learners/mcmc.py, `_posterior_gaussian`,
// `draw_w_block` and `draw_v_block` (the flat exact engine, modes 0 and 1),
// and in libfm_tpu/learners/mcmc_relational.py `draw_w_rel_block` and
// `draw_v_rel_block` (the exact BS engine, modes 2 and 3). One launch draws
// every feature j of one block: over the feature's slots (x, row r), its
// accumulators
//   0 (w):     num = sum x e[r],  den = sum x^2
//   1 (v):     h = x (q[r] - x theta),  num = sum h e[r],  den = sum h^2
//   2 (w_rel): num = sum x we[b],  den = sum x^2 wnum[b]
//   3 (v_rel): h = x (qB[b] - x theta),  num = sum h we[b] + x weq[b],
//              den = sum h^2 wnum[b] + 2 wc[b] x h + x^2 wc_sqr[b]
// (rows r are train cases, rows b block rows), then the posterior of
// `_posterior_gaussian` and `finite_or`:
//   s2 = 1 / (lambda + alpha den),  mean = -s2 (alpha (num - theta den) - mu lambda),
//   proposal = mean + sqrt(s2) z (sampling) or mean (ALS), 0 where s2 is
//   not finite; theta kept (and the rejection counted) where the proposal
//   is not finite or |proposal| > bound;
// and, with delta = new - old, the cache updates
//   0: e += x delta
//   1: q += x delta, e += h delta
//   2: we += x delta wnum, yb += x delta
//   3: we += delta (h wnum + x wc), weq += delta (h wc + x wc_sqr),
//      qB += delta x, yb += delta h.
// theta lives in a column of P = [w | V] (a stride), e and q in columns of
// A = [e | Q] (a stride: no copies), we / weq / wc / wc_sqr in columns of
// rel_cache's table. The normals z come from the caller; the kernel draws
// no random numbers. lambda and mu are read through the feature's group
// (a stride: V's hyperparameters are [G, k], a factor is a column).
// `rejected[j]` is feature j's counter, one writer a launch: the caller
// sums the counters once an iteration.
//
// Bound on the H100: bytes. A slot reads its row (4 B), value (4 B) and
// the rows' cache values and writes them back: at config #3's item block
// (9M slots, k = 64) a v launch moves ~8 + 8 + 8 B a slot, ~216 MB, 0.0645
// ms at 3.35 TB/s; a w launch ~144 MB, 0.043 ms. The cache rows lie at
// random, so each costs a 32-byte sector, read once and written back once
// at the least: in A's columns (rows 260 B apart) e and q are two sectors
// a slot, so the exact engines pass them side by side instead
// (learners/mcmc.py `draw_caches`), one sector a slot.
//
// Design: a launch plan made once a block on the host (kernels/
// coord_draw.py `DrawPlan`) sorts the features by slot count into three
// classes, so that no CTA walks a long list alone and no short feature
// holds a whole CTA:
//   short  (up to 32 x kLaneSlots slots): a warp a feature, 8 a CTA. The
//          warp's sum is a shuffle tree, lane 0 draws and the delta goes
//          out by shuffle: no barrier;
//   medium (up to the piece length): a CTA a feature, its warps' sums
//          added in warp order through shared memory, thread 0 draws;
//   long   (more slots than a piece): cut into pieces (kernels/pieces.py),
//          first in the grid. Each piece writes its partial (num, den) to
//          a scratch row; the last piece of the feature to arrive (an
//          integer ticket after a fence, as slot_stats) adds the partials
//          in piece order, draws, and leaves delta and the old theta in
//          the feature's first scratch row. A second launch (phase 1) then
//          updates the pieces' rows from them. No CTA waits on another.
// Every thread holds its slots (at most kLaneSlots: row, value and the
// cache values the mode reads) in registers from the sum to the update,
// so each cache sector is gathered once: the update reuses what the sum
// read. All gathers of a thread are issued before the first sum. Every
// row of a conflict-free block belongs to one slot of one feature, so
// each cache element has one writer: no atomics. The sums run in a fixed
// order (a thread's slots in order, the shuffle tree, warps and pieces in
// order), so a second launch gives the same bits.
// The first version (one CTA of 128 threads a feature, the slots gathered
// again for the update) took 4.48 ms for a v factor on config #3's blocks
// and 5.14 ms on config #4's block with the longest feature; this one
// 3.56 and 0.37 ms on A's columns, 1.71 and 0.094 ms on e and q side by
// side, where torch's gathers and scatters of the same slots' e and q
// take 3.27 ms at #3 (H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md).

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kWarp;
using libfm::warp_sum;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
// slots a thread holds from the sum to the update
constexpr int kLaneSlots = 8;
// the longest piece (and medium feature): a CTA's slots
constexpr int kPieceMax = kThreads * kLaneSlots;
// floats a scratch row: a piece's (num, den); the feature's first row
// also holds (delta, old theta) for the second launch
constexpr int kScratch = 4;

enum Mode { kW = 0, kV = 1, kWRel = 2, kVRel = 3 };

struct Args {
  const long long* feat_off;  // [F+1]
  const int* slot_row;        // [E] rows of the caches
  const float* slot_val;      // [E]
  const int* feat_id;         // [F] rows of theta
  const int* group;           // [F] rows of lam / mu
  float* theta;
  long long theta_stride;
  const float* lam;
  const float* mu;
  long long hp_stride;
  const float* alpha;  // 0-dim
  const float* z;      // [F] or null (ALS)
  float bound;
  int* rejected;  // [F]
  float* e;       // modes 0, 1: e; modes 2, 3: we
  long long e_stride;
  float* q;  // mode 1: q; mode 3: qB
  long long q_stride;
  float* weq;  // mode 3
  const float* wc;
  const float* wc_sqr;
  long long c_stride;
  const float* wnum;  // modes 2, 3
  float* yb;          // modes 2, 3
  // the plan
  const int4* order;  // [>= n_long] long pieces: (feature, rank, first scratch row, pieces)
  const int* feats;   // [n_medium + n_short] medium features, then short ones
  int n_long, n_medium, n_short, piece_len;
  float* scratch;  // [pieces of long features, kScratch]
  int* ticket;     // [F], zero between launches
};

// One slot's row, value and the cache values its mode reads.
struct Slot {
  int r;
  float x, e, q, weq, wc, wcs, wn;
};

// Slots s0 + t, s0 + t + step, ... below s1 that a thread holds (at most
// kLaneSlots: the plan keeps every list within 32 or kThreads times that).
__device__ __forceinline__ int held(long long s0, long long s1, int t, int step) {
  const long long left = s1 - s0 - t;
  if (left <= 0) return 0;
  const long long n = (left + step - 1) / step;
  return n < kLaneSlots ? (int)n : kLaneSlots;
}

template <int MODE>
__device__ __forceinline__ void gather(const Args& a, long long s0, int t, int step, int n,
                                       Slot (&v)[kLaneSlots]) {
#pragma unroll
  for (int i = 0; i < kLaneSlots; ++i) {
    const long long s = s0 + t + (long long)i * step;
    v[i].r = i < n ? a.slot_row[s] : 0;
    v[i].x = i < n ? a.slot_val[s] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kLaneSlots; ++i) {
    if (i >= n) continue;
    const long long r = v[i].r;
    v[i].e = a.e[r * a.e_stride];
    if (MODE == kV || MODE == kVRel) v[i].q = a.q[r * a.q_stride];
    if (MODE >= kWRel) v[i].wn = a.wnum[r];
    if (MODE == kVRel) {
      const long long c = r * a.c_stride;
      v[i].weq = a.weq[c];
      v[i].wc = a.wc[c];
      v[i].wcs = a.wc_sqr[c];
    }
  }
}

__device__ __forceinline__ float h_of(const Slot& v, float th) {
  return __fmul_rn(v.x, __fsub_rn(v.q, __fmul_rn(v.x, th)));
}

template <int MODE>
__device__ __forceinline__ void add_terms(const Slot& v, float th, float& num, float& den) {
  const float x = v.x;
  if (MODE == kW) {
    num = __fadd_rn(num, __fmul_rn(x, v.e));
    den = __fadd_rn(den, __fmul_rn(x, x));
  } else if (MODE == kV) {
    const float h = h_of(v, th);
    num = __fadd_rn(num, __fmul_rn(h, v.e));
    den = __fadd_rn(den, __fmul_rn(h, h));
  } else if (MODE == kWRel) {
    num = __fadd_rn(num, __fmul_rn(x, v.e));
    den = __fadd_rn(den, __fmul_rn(__fmul_rn(x, x), v.wn));
  } else {
    const float h = h_of(v, th);
    num = __fadd_rn(num, __fadd_rn(__fmul_rn(h, v.e), __fmul_rn(x, v.weq)));
    const float t1 = __fmul_rn(__fmul_rn(h, h), v.wn);
    const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, v.wc), x), h);
    const float t3 = __fmul_rn(__fmul_rn(x, x), v.wcs);
    den = __fadd_rn(den, __fadd_rn(__fadd_rn(t1, t2), t3));
  }
}

template <int MODE>
__device__ __forceinline__ void update(const Args& a, const Slot& v, float th, float delta) {
  const long long r = v.r;
  const float x = v.x;
  float* ep = a.e + r * a.e_stride;
  if (MODE == kW) {
    *ep = __fadd_rn(v.e, __fmul_rn(x, delta));
  } else if (MODE == kV) {
    const float h = h_of(v, th);
    a.q[r * a.q_stride] = __fadd_rn(v.q, __fmul_rn(x, delta));
    *ep = __fadd_rn(v.e, __fmul_rn(h, delta));
  } else if (MODE == kWRel) {
    const float xd = __fmul_rn(x, delta);
    *ep = __fadd_rn(v.e, __fmul_rn(xd, v.wn));
    a.yb[r] = __fadd_rn(a.yb[r], xd);
  } else {
    const float h = h_of(v, th);
    *ep = __fadd_rn(v.e, __fmul_rn(delta, __fadd_rn(__fmul_rn(h, v.wn), __fmul_rn(x, v.wc))));
    a.weq[r * a.c_stride] =
        __fadd_rn(v.weq, __fmul_rn(delta, __fadd_rn(__fmul_rn(h, v.wc), __fmul_rn(x, v.wcs))));
    a.q[r * a.q_stride] = __fadd_rn(v.q, __fmul_rn(delta, x));
    a.yb[r] = __fadd_rn(a.yb[r], __fmul_rn(delta, h));
  }
}

// The posterior (`_posterior_gaussian`, `finite_or`) of feature j from its
// sums: writes theta and the counter, returns the new theta.
__device__ __forceinline__ float draw(const Args& a, int j, float N, float D, float th) {
  const long long g = (long long)a.group[j] * a.hp_stride;
  const float lam = a.lam[g], mu = a.mu[g], alpha = *a.alpha;
  const float s2 = __fdiv_rn(1.0f, __fadd_rn(lam, __fmul_rn(alpha, D)));
  const float inner =
      __fsub_rn(__fmul_rn(alpha, __fsub_rn(N, __fmul_rn(th, D))), __fmul_rn(mu, lam));
  const float mean = __fmul_rn(-s2, inner);
  float prop = a.z != nullptr ? __fadd_rn(mean, __fmul_rn(__fsqrt_rn(s2), a.z[j])) : mean;
  if (!isfinite(s2)) prop = 0.0f;
  const bool ok = isfinite(prop) && fabsf(prop) <= a.bound;
  const float nv = ok ? prop : th;
  a.theta[(long long)a.feat_id[j] * a.theta_stride] = nv;
  a.rejected[j] += ok ? 0 : 1;
  return nv;
}

// Phase 0: every feature's sums and draw; the short and medium features'
// updates. CTAs [0, n_long) take the long pieces, then one a medium
// feature, then one a kWarps short features.
template <int MODE>
__global__ void __launch_bounds__(kThreads) coord_draw_kernel(Args a) {
  __shared__ float red[2][kWarps];
  __shared__ float s_delta;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int b = blockIdx.x;
  Slot v[kLaneSlots];
  if (b >= a.n_long + a.n_medium) {  // short: a warp a feature
    const int i = (b - a.n_long - a.n_medium) * kWarps + warp;
    if (i >= a.n_short) return;
    const int j = a.feats[a.n_medium + i];
    const long long s0 = a.feat_off[j], s1 = a.feat_off[j + 1];
    const float th = a.theta[(long long)a.feat_id[j] * a.theta_stride];
    const int n = held(s0, s1, lane, kWarp);
    gather<MODE>(a, s0, lane, kWarp, n, v);
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int t = 0; t < kLaneSlots; ++t)
      if (t < n) add_terms<MODE>(v[t], th, num, den);
    num = warp_sum(num);
    den = warp_sum(den);
    float delta = 0.0f;
    if (lane == 0) delta = __fsub_rn(draw(a, j, num, den, th), th);
    delta = __shfl_sync(kFullMask, delta, 0);
#pragma unroll
    for (int t = 0; t < kLaneSlots; ++t)
      if (t < n) update<MODE>(a, v[t], th, delta);
    return;
  }
  // a CTA: a long feature's piece or a medium feature
  const bool piece = b < a.n_long;
  int4 pc = make_int4(0, 0, 0, 1);
  int j;
  long long s0, s1;
  if (piece) {
    pc = a.order[b];
    j = pc.x;
    s0 = a.feat_off[j] + (long long)pc.y * a.piece_len;
    s1 = min(a.feat_off[j + 1], s0 + a.piece_len);
  } else {
    j = a.feats[b - a.n_long];
    s0 = a.feat_off[j];
    s1 = a.feat_off[j + 1];
  }
  const float th = a.theta[(long long)a.feat_id[j] * a.theta_stride];
  const int n = held(s0, s1, threadIdx.x, kThreads);
  gather<MODE>(a, s0, threadIdx.x, kThreads, n, v);
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int t = 0; t < kLaneSlots; ++t)
    if (t < n) add_terms<MODE>(v[t], th, num, den);
  num = warp_sum(num);
  den = warp_sum(den);
  if (lane == 0) {
    red[0][warp] = num;
    red[1][warp] = den;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float N = red[0][0], D = red[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      N = __fadd_rn(N, red[0][w]);
      D = __fadd_rn(D, red[1][w]);
    }
    if (!piece) {
      s_delta = __fsub_rn(draw(a, j, N, D, th), th);
    } else {
      // publish this piece's partial; the last piece to arrive draws
      float* first = a.scratch + (long long)pc.z * kScratch;
      first[pc.y * kScratch] = N;
      first[pc.y * kScratch + 1] = D;
      __threadfence();
      if (atomicAdd(a.ticket + j, 1) == pc.w - 1) {
        __threadfence();
        float SN = 0.0f, SD = 0.0f;
        for (int p = 0; p < pc.w; ++p) {
          SN = __fadd_rn(SN, __ldcg(first + p * kScratch));
          SD = __fadd_rn(SD, __ldcg(first + p * kScratch + 1));
        }
        first[2] = __fsub_rn(draw(a, j, SN, SD, th), th);
        first[3] = th;
        a.ticket[j] = 0;  // every piece has arrived: ready for the next call
      }
    }
  }
  if (piece) return;  // its rows wait for phase 1
  __syncthreads();
  const float delta = s_delta;
#pragma unroll
  for (int t = 0; t < kLaneSlots; ++t)
    if (t < n) update<MODE>(a, v[t], th, delta);
}

// Phase 1: the long pieces' updates, from the delta and the old theta
// that phase 0 left in their feature's first scratch row.
template <int MODE>
__global__ void __launch_bounds__(kThreads) coord_update_kernel(Args a) {
  const int4 pc = a.order[blockIdx.x];
  const int j = pc.x;
  const long long s0 = a.feat_off[j] + (long long)pc.y * a.piece_len;
  const long long s1 = min(a.feat_off[j + 1], s0 + a.piece_len);
  const float* first = a.scratch + (long long)pc.z * kScratch;
  const float delta = first[2], th = first[3];
  Slot v[kLaneSlots];
  const int n = held(s0, s1, threadIdx.x, kThreads);
  gather<MODE>(a, s0, threadIdx.x, kThreads, n, v);
#pragma unroll
  for (int t = 0; t < kLaneSlots; ++t)
    if (t < n) update<MODE>(a, v[t], th, delta);
}

template <int MODE>
void launch_mode(const Args& a, int phase, unsigned grid, cudaStream_t stream) {
  if (phase == 0)
    coord_draw_kernel<MODE><<<grid, kThreads, 0, stream>>>(a);
  else
    coord_update_kernel<MODE><<<grid, kThreads, 0, stream>>>(a);
}

}  // namespace

// One block's draws in `mode` (0 w, 1 v, 2 w_rel, 3 v_rel) for its F
// features: see the top of this file. Phase 0 draws every feature and
// updates the rows of the short and medium ones; phase 1, launched after
// it only where the plan has long pieces (n_long > 0), updates theirs.
// The plan: `order` int4 [>= n_long] (Pieces.order: its long pieces first),
// `feats` [n_medium + n_short], `scratch` [n_long * 4] floats, `ticket`
// [F] zero. Pointers a mode does not read may be null; strides are in
// floats.
extern "C" int coord_draw_launch(int mode, int phase, int F, const long long* feat_off,
                                 const int* slot_row, const float* slot_val,
                                 const int* feat_id, const int* group, float* theta,
                                 long long theta_stride, const float* lam, const float* mu,
                                 long long hp_stride, const float* alpha, const float* z,
                                 float bound, int* rejected, float* e, long long e_stride,
                                 float* q, long long q_stride, float* weq, const float* wc,
                                 const float* wc_sqr, long long c_stride, const float* wnum,
                                 float* yb, const int* order, const int* feats, int n_long,
                                 int n_medium, int n_short, int piece_len, float* scratch,
                                 int* ticket, cudaStream_t stream) {
  if (mode < kW || mode > kVRel || F < 0 || (phase != 0 && phase != 1) || n_long < 0 ||
      n_medium < 0 || n_short < 0 || n_medium + n_short > F || piece_len < 1 ||
      piece_len > kPieceMax || (phase == 1 && n_long == 0))
    return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  const bool need_q = mode == kV || mode == kVRel;
  const bool rel = mode >= kWRel;
  if (!feat_off || !slot_row || !slot_val || !feat_id || !group || !theta || !lam || !mu ||
      !alpha || !rejected || !e || (need_q && !q) || (rel && (!wnum || !yb)) ||
      (mode == kVRel && (!weq || !wc || !wc_sqr)) || (n_medium + n_short > 0 && !feats) ||
      (n_long > 0 && (!order || !scratch || !ticket)))
    return (int)cudaErrorInvalidValue;
  const Args a{feat_off, slot_row, slot_val, feat_id,  group,   theta,    theta_stride,
               lam,      mu,       hp_stride, alpha,   z,       bound,    rejected,
               e,        e_stride, q,         q_stride, weq,    wc,       wc_sqr,
               c_stride, wnum,     yb,        reinterpret_cast<const int4*>(order),
               feats,    n_long,   n_medium,  n_short, piece_len, scratch, ticket};
  const long long ctas =
      phase == 1 ? n_long : (long long)n_long + n_medium + (n_short + kWarps - 1) / kWarps;
  if (ctas == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)ctas;
  switch (mode) {
    case kW: launch_mode<kW>(a, phase, grid, stream); break;
    case kV: launch_mode<kV>(a, phase, grid, stream); break;
    case kWRel: launch_mode<kWRel>(a, phase, grid, stream); break;
    default: launch_mode<kVRel>(a, phase, grid, stream); break;
  }
  return (int)cudaGetLastError();
}
