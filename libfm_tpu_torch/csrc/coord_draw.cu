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
// random (A's rows are 260 B apart), so each costs a 32-byte sector.
// Design (a first version, simple and right): one CTA of 128 threads a
// feature. Its threads walk the feature's slots with a stride of 128 and
// sum their products in registers; the warps' sums go through shuffles
// and then shared memory in warp order (a fixed order: every run gives
// the same bits); thread 0 draws, writes theta and the counter, and
// shares delta; then the threads walk the slots again and update the
// rows. Every row of a conflict-free block belongs to one slot of one
// feature, so each cache element has one writer: no atomics. A long
// feature (config #4's Zipf head) is walked by its one CTA; cutting it
// into pieces is later work.

#include "common.cuh"

namespace {

using libfm::kWarp;
using libfm::warp_sum;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;

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
};

template <int MODE>
__global__ void __launch_bounds__(kThreads) coord_draw_kernel(Args a) {
  __shared__ float red[2][kWarps];
  __shared__ float s_delta;
  const int j = blockIdx.x;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const long long s0 = a.feat_off[j], s1 = a.feat_off[j + 1];
  float* th_ptr = a.theta + (long long)a.feat_id[j] * a.theta_stride;
  const float th = *th_ptr;
  float num = 0.0f, den = 0.0f;
  for (long long s = s0 + threadIdx.x; s < s1; s += kThreads) {
    const float x = a.slot_val[s];
    const long long r = a.slot_row[s];
    const float ev = a.e[r * a.e_stride];
    if (MODE == kW) {
      num = __fadd_rn(num, __fmul_rn(x, ev));
      den = __fadd_rn(den, __fmul_rn(x, x));
    } else if (MODE == kV) {
      const float h = __fmul_rn(x, __fsub_rn(a.q[r * a.q_stride], __fmul_rn(x, th)));
      num = __fadd_rn(num, __fmul_rn(h, ev));
      den = __fadd_rn(den, __fmul_rn(h, h));
    } else if (MODE == kWRel) {
      num = __fadd_rn(num, __fmul_rn(x, ev));
      den = __fadd_rn(den, __fmul_rn(__fmul_rn(x, x), a.wnum[r]));
    } else {
      const long long c = r * a.c_stride;
      const float h = __fmul_rn(x, __fsub_rn(a.q[r * a.q_stride], __fmul_rn(x, th)));
      num = __fadd_rn(num, __fadd_rn(__fmul_rn(h, ev), __fmul_rn(x, a.weq[c])));
      const float t1 = __fmul_rn(__fmul_rn(h, h), a.wnum[r]);
      const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, a.wc[c]), x), h);
      const float t3 = __fmul_rn(__fmul_rn(x, x), a.wc_sqr[c]);
      den = __fadd_rn(den, __fadd_rn(__fadd_rn(t1, t2), t3));
    }
  }
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
    *th_ptr = nv;
    a.rejected[j] += ok ? 0 : 1;
    s_delta = __fsub_rn(nv, th);
  }
  __syncthreads();
  const float delta = s_delta;
  for (long long s = s0 + threadIdx.x; s < s1; s += kThreads) {
    const float x = a.slot_val[s];
    const long long r = a.slot_row[s];
    float* ep = a.e + r * a.e_stride;
    if (MODE == kW) {
      *ep = __fadd_rn(*ep, __fmul_rn(x, delta));
    } else if (MODE == kV) {
      float* qp = a.q + r * a.q_stride;
      const float qv = *qp;
      const float h = __fmul_rn(x, __fsub_rn(qv, __fmul_rn(x, th)));
      *qp = __fadd_rn(qv, __fmul_rn(x, delta));
      *ep = __fadd_rn(*ep, __fmul_rn(h, delta));
    } else if (MODE == kWRel) {
      const float xd = __fmul_rn(x, delta);
      *ep = __fadd_rn(*ep, __fmul_rn(xd, a.wnum[r]));
      a.yb[r] = __fadd_rn(a.yb[r], xd);
    } else {
      const long long c = r * a.c_stride;
      float* qp = a.q + r * a.q_stride;
      const float qv = *qp, wn = a.wnum[r], wcv = a.wc[c];
      const float h = __fmul_rn(x, __fsub_rn(qv, __fmul_rn(x, th)));
      *ep = __fadd_rn(*ep, __fmul_rn(delta, __fadd_rn(__fmul_rn(h, wn), __fmul_rn(x, wcv))));
      a.weq[c] = __fadd_rn(
          a.weq[c], __fmul_rn(delta, __fadd_rn(__fmul_rn(h, wcv), __fmul_rn(x, a.wc_sqr[c]))));
      *qp = __fadd_rn(qv, __fmul_rn(delta, x));
      a.yb[r] = __fadd_rn(a.yb[r], __fmul_rn(delta, h));
    }
  }
}

}  // namespace

// One block's draws in `mode` (0 w, 1 v, 2 w_rel, 3 v_rel) for its F
// features: see the top of this file. Pointers a mode does not read may be
// null; strides are in floats.
extern "C" int coord_draw_launch(int mode, int F, const long long* feat_off,
                                 const int* slot_row, const float* slot_val,
                                 const int* feat_id, const int* group, float* theta,
                                 long long theta_stride, const float* lam, const float* mu,
                                 long long hp_stride, const float* alpha, const float* z,
                                 float bound, int* rejected, float* e, long long e_stride,
                                 float* q, long long q_stride, float* weq, const float* wc,
                                 const float* wc_sqr, long long c_stride, const float* wnum,
                                 float* yb, cudaStream_t stream) {
  if (mode < kW || mode > kVRel || F < 0) return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  const bool need_q = mode == kV || mode == kVRel;
  const bool rel = mode >= kWRel;
  if (!feat_off || !slot_row || !slot_val || !feat_id || !group || !theta || !lam || !mu ||
      !alpha || !rejected || !e || (need_q && !q) || (rel && (!wnum || !yb)) ||
      (mode == kVRel && (!weq || !wc || !wc_sqr)))
    return (int)cudaErrorInvalidValue;
  const Args a{feat_off, slot_row, slot_val, feat_id, group,    theta,    theta_stride,
               lam,      mu,       hp_stride, alpha,  z,        bound,    rejected,
               e,        e_stride, q,         q_stride, weq,    wc,       wc_sqr,
               c_stride, wnum,     yb};
  switch (mode) {
    case kW: coord_draw_kernel<kW><<<(unsigned)F, kThreads, 0, stream>>>(a); break;
    case kV: coord_draw_kernel<kV><<<(unsigned)F, kThreads, 0, stream>>>(a); break;
    case kWRel: coord_draw_kernel<kWRel><<<(unsigned)F, kThreads, 0, stream>>>(a); break;
    default: coord_draw_kernel<kVRel><<<(unsigned)F, kThreads, 0, stream>>>(a); break;
  }
  return (int)cudaGetLastError();
}
