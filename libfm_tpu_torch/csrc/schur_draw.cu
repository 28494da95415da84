// schur_draw: blocked joint draw of theta_j = (w_j, v_j) per feature, with
// the Cholesky factorisation and both triangular solves fused in.
//
// Replaces, in libfm_tpu/learners/mcmc_vector.py, sweep_block.draw_chunk,
// together with libfm_tpu/ops/lane_chol.py cholesky_lanes,
// solve_lower_lanes and solve_upper_lanes. Per feature, from its GG row
// [Qq (packed upper triangle) | qa | qe | aa | ae]:
//   b0 = alpha (aa th0 + qa.thv) - alpha ae + lam0 mu0
//   bv = alpha (qa th0 + Qq thv) - alpha qe + lamv mu_v
//   s0 = sqrt(alpha aa + lam0),  col = alpha qa / s0
//   S  = alpha Qq + diag(lamv) - col col^T = L L^T
//   y0 = b0 / s0,  y = L^-1 (bv - col y0);  (+ z when sampling)
//   xv = L^-T y,   x0 = (y0 - col.xv) / s0
// A non-finite theta, or one with |theta| > bound, keeps the old theta and
// sets the feature's reject flag. The noise z comes from the caller's
// generator, so the kernel is deterministic.
//
// Bound on the H100 at ML-10M (k=64, 82,248 systems an iteration): bytes,
// 0.83 GB (the GG rows, theta/lam/mu/z in, theta out) = 0.25 ms, against
// ~1.1e5 fp32 FLOP per system (k^3/3 for the factorisation), 9.2 GFLOP =
// 0.14 ms at 67 TFLOP/s; chip_smoke.py counts both.
//
// Design (Hopper, fp32 FMA on the CUDA cores):
// - The width is a template parameter KP in {16, 32, 64, 128}, k <= KP.
//   Each system is padded to S' = [[S, 0], [0, I]] with zero rhs and noise
//   in the pad: the same leading factor and x, and the pad is never
//   written out. S is indexed with KP alone (constants and shifts); only
//   the reads of the staged row use k.
// - One warp per system; a CTA holds several warps, each with its own
//   shared memory, and the warps never wait for each other: inside a
//   system there are only __syncwarp and shuffles.
// - S is kept as a column-major packed lower triangle (KP(KP+1)/2
//   floats). A column read is contiguous; a row read steps by the
//   triangular numbers, which fall in 32 distinct banks.
// - Cholesky by panels of 8 columns: the warp factors a panel in
//   registers (each lane holds its rows of the 8 columns; the pivot and
//   the L[c][j] it needs come by shuffle), writes it back, then updates
//   the trailing lower triangle in 4x4 register tiles (one tile a lane,
//   32 FMAs per 16 floats read), touching only tiles on or below the
//   diagonal. Pivots are inverted once and multiplied.
// - Both solves go by the same panels: every lane solves the panel's 8x8
//   diagonal block from the pivots' rhs (fetched by shuffle), and each
//   lane updates the rhs of the rows it owns (row lane + 32q, held in
//   registers) with 8 FMAs a panel.
// - Persistent grid, about one wave of CTAs; each warp walks systems
//   f, f + stride, ... While it factors system f, cp.async brings system
//   f + stride's GG row, theta, lam, mu and z into the warp's staging
//   area (16-byte pieces where the source is aligned: a GG row is 8,840 B
//   at k=64, so odd rows start 8 B off; 4-byte pieces at the ends). The
//   packed triangle is read in row order, coalesced, and S is formed from
//   it in shared memory.
//
// The relational form (kUpd; schur_draw_rel_launch) also does K10's
// `upd_chunk` (libfm_tpu/learners/mcmc_rel_vector.py:1284-1309), which the
// BS engine ran as a launch of its own after each block's draw: for each
// entry (b, x) of feature f, feat_off[f] .. feat_off[f+1] of the block's
// entry_b / entry_x, with (dw, dv) = theta_new[f] - theta_old[f] and
// v_old = theta_old[f, 1:], s_b += x (dw + dv . (dQB_b - x v_old)) and
// dQB_b += x dv in SD [nb+1, k+1] = [s | dQB]. The warp that drew f holds
// its old theta and the one it writes (a rejected draw's dv is 0) on the
// lanes that own the factors (lane + 32q), and a conflict-free block's
// entries hold distinct block rows, so no other warp touches f's SD rows.
// The same operations as the standalone kernel, in the same order
// (__fsub_rn, fmaf over q, warp_sum's butterfly, then __fmul_rn(x,
// __fadd_rn(dw, p))): SD keeps its bits. Its loads are issued early and
// land while the systems are solved: f's entry range while the system
// before it is solved, its first entries_ahead() entries when its staging
// area is ready, their SD rows before its Cholesky. The standalone kernel
// took 0.0680 ms an iteration at bench_bs (23 launches; bound 0.0068:
// H100 80GB HBM3, 700 W, chip_smoke.py --bench-bs), a launch each of
// ~1 MB behind two dependent round trips.

#include <math.h>

#include "common.cuh"

namespace {

using libfm::kFullMask;
using libfm::kWarp;
using libfm::round4;
constexpr int kPanel = 8;  // columns per Cholesky / solve panel
constexpr int kTile = 4;   // edge of a lane's trailing-update register tile

// Offset of column j in the column-major packed lower triangle of a
// KP x KP matrix: element (i, j), i >= j, is at col_base<KP>(j) + i.
template <int KP>
__device__ __forceinline__ int col_base(int j) {
  return j * KP - ((j * (j - 1)) >> 1) - j;
}

// Floats of one warp's staging area: the GG row, then theta, lam, mu and
// z, each with 3 floats of room to keep its source's 16-byte offset.
__host__ __device__ __forceinline__ int stage_floats(int k) {
  return round4(libfm::gg_width(k) + 3) + 4 * round4(k + 1 + 3);
}

// Floats of one warp's working area: S, then col, thv and 1 / diag(L).
template <int KP>
__host__ __device__ constexpr int work_floats() {
  return ((KP * (KP + 1) / 2 + 3) & ~3) + 3 * KP;
}

// Entries of a feature whose SD rows the relational form loads ahead.
template <int KP>
__host__ __device__ constexpr int entries_ahead() {
  return KP >= 128 ? 4 : 8;
}

template <int KP>
constexpr int warps_per_cta() {
  return KP >= 128 ? 2 : 4;  // KP=128 takes 70 KB of shared memory a warp
}

// r[q] (or r[q][c]) for a q known only at run time, without local memory.
template <int R>
__device__ __forceinline__ float pick(const float (&r)[R], int q) {
  float v = r[0];
#pragma unroll
  for (int p = 1; p < R; ++p)
    if (q == p) v = r[p];
  return v;
}

template <int R, int C>
__device__ __forceinline__ float pick(const float (&r)[R][C], int q, int c) {
  float v = r[0][c];
#pragma unroll
  for (int p = 1; p < R; ++p)
    if (q == p) v = r[p][c];
  return v;
}

struct Staged {
  const float *g, *th, *la, *mu, *z;
};

// Start the copies of system f's inputs into the staging area (one
// cp.async group per lane).
__device__ __forceinline__ Staged stage_system(float* stage, int f, const float* GG,
                                               const float* theta, const float* lam,
                                               const float* mu, const float* z, int k,
                                               bool sample, int lane) {
  const int d = k + 1, GW = libfm::gg_width(k), ds = round4(d + 3);
  const long long fd = (long long)f * d;
  Staged s;
  s.g = libfm::warp_copy_row(stage, GG + (long long)f * GW, GW, lane);
  float* p = stage + round4(GW + 3);
  s.th = libfm::warp_copy_row(p, theta + fd, d, lane);
  s.la = libfm::warp_copy_row(p + ds, lam + fd, d, lane);
  s.mu = libfm::warp_copy_row(p + 2 * ds, mu + fd, d, lane);
  s.z = sample ? libfm::warp_copy_row(p + 3 * ds, z + fd, d, lane) : nullptr;
  libfm::cp_async_commit();
  return s;
}

// The relational form's block: SD updated in place, the entry lists.
struct RelUpdate {
  float* SD;
  const long long* feat_off;
  const int* entry_b;
  const float* entry_x;
};

template <int KP, int kWarps, bool kUpd>
__global__ void __launch_bounds__(kWarps* kWarp)
    schur_draw_kernel(const float* __restrict__ GG, const float* __restrict__ theta,
                      const float* __restrict__ lam, const float* __restrict__ mu,
                      const float* __restrict__ z, const float* __restrict__ alphap,
                      float* __restrict__ theta_out, int* __restrict__ rej,
                      int num_feats, int k, int do_sample, float bound, RelUpdate upd) {
  constexpr int R = (KP + kWarp - 1) / kWarp;  // rows a lane owns: lane + 32q
  constexpr int kAhead = entries_ahead<KP>();
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int d = k + 1, T = k * (k + 1) / 2;
  const int sf = stage_floats(k);
  float* stage = smem + (size_t)warp * (sf + work_floats<KP>());
  float* S = stage + sf;
  float* colS = S + (work_floats<KP>() - 3 * KP);
  float* thvS = colS + KP;
  float* invD = thvS + KP;  // 1 / L[j][j]
  const bool sample = do_sample != 0;
  const float alpha = *alphap;
  const int stride = gridDim.x * kWarps;

  int f = blockIdx.x * kWarps + warp;
  Staged cur{};
  long long e_lo = 0, e_hi = 0;  // kUpd: f's entries
  if (f < num_feats) {
    cur = stage_system(stage, f, GG, theta, lam, mu, z, k, sample, lane);
    if constexpr (kUpd) {
      e_lo = upd.feat_off[f];
      e_hi = upd.feat_off[f + 1];
    }
  }
  for (; f < num_feats; f += stride) {
    long long next_lo = 0, next_hi = 0;
    // kUpd: a batch of up to kAhead of f's entries (b, x) and their SD rows
    // (s, and dQB on the lanes of its factors); lane m loads entry m first
    int eb = 0, bm[kAhead];
    float ex = 0.0f, xm[kAhead], sdq[kAhead][R], sd0[kAhead];
    const int ne = (int)(e_hi - e_lo);
    auto load_rows = [&](int n) {
#pragma unroll
      for (int m = 0; m < kAhead; ++m) {
        if (m >= n) break;
        bm[m] = __shfl_sync(kFullMask, eb, m);
        xm[m] = __shfl_sync(kFullMask, ex, m);
        const float* row = upd.SD + (long long)bm[m] * d;
        sd0[m] = row[0];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = lane + kWarp * q;
          sdq[m][q] = i < k ? row[1 + i] : 0.0f;
        }
      }
    };
    if constexpr (kUpd) {
      if (lane < min(ne, kAhead)) {
        eb = upd.entry_b[e_lo + lane];
        ex = upd.entry_x[e_lo + lane];
      }
    }
    libfm::cp_async_wait<0>();
    __syncwarp();

    // ---- 1. take this system out of the staging area
    const float th0 = cur.th[0], lam0 = cur.la[0], mu0 = cur.mu[0];
    const float aa = cur.g[T + 2 * k], ae = cur.g[T + 2 * k + 1];
    const float z0 = sample ? cur.z[0] : 0.0f;
    float thv[R], qa[R], qe[R], lm[R], zv[R], col[R];
    float qath = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      const bool real = i < k;
      thv[q] = real ? cur.th[1 + i] : 0.0f;
      qa[q] = real ? cur.g[T + i] : 0.0f;
      qe[q] = real ? cur.g[T + k + i] : 0.0f;
      lm[q] = real ? cur.la[1 + i] * cur.mu[1 + i] : 0.0f;
      zv[q] = real && sample ? cur.z[1 + i] : 0.0f;
      qath += qa[q] * thv[q];
    }
    const float s0 = sqrtf(alpha * aa + lam0);
    qath = libfm::warp_sum(qath);
    const float b0 = alpha * (aa * th0 + qath) - alpha * ae + lam0 * mu0;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      col[q] = alpha * qa[q] / s0;
      if (i < KP) {
        thvS[i] = thv[q];
        colS[i] = col[q];
      }
    }
    __syncwarp();

    // ---- 2. S = alpha Qq + diag(lamv) - col col^T from the staged row:
    // Qq's packed upper row j (Qq[j][j..k-1]) is column j of the lower
    // triangle, contiguous on both sides
#pragma unroll 4
    for (int j = 0; j < KP; ++j) {
      float* colj = S + col_base<KP>(j);
      const float* src = cur.g + (j < k ? libfm::tri_index(j, j, k) - j : 0);
      const float cj = colS[j], dj = j < k ? cur.la[1 + j] : 1.0f;
      for (int i = j + lane; i < KP; i += kWarp)
        colj[i] = (i < k ? alpha * src[i] : 0.0f) + (i == j ? dj : 0.0f) - colS[i] * cj;
    }
    // bv = alpha (qa th0 + Qq thv) - alpha qe + lamv mu_v, Qq read from the
    // staged row; this lane's rows
    float r[R];  // rhs of the rows this lane owns: bv, then y, then x
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      float acc = 0.0f;
      if (i < k) {
        const int ci = libfm::tri_index(i, i, k) - i;  // Qq[i][j] = g[ci + j], j >= i
        int cj = 0;                                    // Qq[j][i] = g[cj + i], j <= i
        if constexpr (KP >= 128) {
          // eight partial sums (j mod 8), added pairwise: one chain of
          // more than 64 terms put most of the draws' float32 error into
          // bv (their distance from float64 2.7 times schur_draw_plain's
          // on the card at k = 128); eight chains bring it below the plain
          // version's, at the same time. KP <= 64 keep one chain and
          // their bits
          float part[8] = {};
          const int k8 = k & ~7;
          for (int j0 = 0; j0 < k8; j0 += 8) {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int j = j0 + u;
              part[u] += cur.g[j <= i ? cj + i : ci + j] * thvS[j];
              cj += k - j - 1;
            }
          }
#pragma unroll
          for (int u = 0; u < 7; ++u) {
            const int j = k8 + u;
            if (j < k) {
              part[u] += cur.g[j <= i ? cj + i : ci + j] * thvS[j];
              cj += k - j - 1;
            }
          }
          acc = ((part[0] + part[1]) + (part[2] + part[3])) +
                ((part[4] + part[5]) + (part[6] + part[7]));
        } else {
#pragma unroll 4
          for (int j = 0; j < k; ++j) {
            acc += cur.g[j <= i ? cj + i : ci + j] * thvS[j];
            cj += k - j - 1;
          }
        }
      }
      r[q] = alpha * (qa[q] * th0 + acc) - alpha * qe[q] + lm[q];
    }
    __syncwarp();

    // ---- 3. the next system's inputs come in while this one is solved
    if (f + stride < num_feats) {
      cur = stage_system(stage, f + stride, GG, theta, lam, mu, z, k, sample, lane);
      if constexpr (kUpd) {
        next_lo = upd.feat_off[f + stride];
        next_hi = upd.feat_off[f + stride + 1];
      }
    }
    // kUpd: the SD rows of f's first entries come in while it is solved
    if constexpr (kUpd) load_rows(min(ne, kAhead));

    // ---- 4. Cholesky S = L L^T by panels of kPanel columns
    for (int j0 = 0; j0 < KP; j0 += kPanel) {
      // the panel's columns in registers: pn[q][c] = L[i][j0 + c] for the
      // rows i = lane + 32q on or below the diagonal (0 elsewhere); the
      // panel's own rows are held at q = j0 / 32
      const int qj = j0 / kWarp;
      float pn[R][kPanel], inv[kPanel];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + kWarp * q;
#pragma unroll
        for (int c = 0; c < kPanel; ++c)
          pn[q][c] = i >= j0 + c && i < KP ? S[col_base<KP>(j0 + c) + i] : 0.0f;
      }
#pragma unroll
      for (int jj = 0; jj < kPanel; ++jj) {
        const int j = j0 + jj;
        // NaN when S is not positive definite
        const float djj = sqrtf(__shfl_sync(kFullMask, pick(pn, qj, jj), j % kWarp));
        inv[jj] = 1.0f / djj;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = lane + kWarp * q;
          if (i == j) pn[q][jj] = djj;
          else if (i > j) pn[q][jj] *= inv[jj];
        }
        // the panel's later columns: S[i][c] -= L[i][j] L[c][j], c <= i
#pragma unroll
        for (int c = jj + 1; c < kPanel; ++c) {
          const float lcj = __shfl_sync(kFullMask, pick(pn, qj, jj), (j0 + c) % kWarp);
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (lane + kWarp * q >= j0 + c) pn[q][c] -= pn[q][jj] * lcj;
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + kWarp * q;
#pragma unroll
        for (int c = 0; c < kPanel; ++c)
          if (i >= j0 + c && i < KP) S[col_base<KP>(j0 + c) + i] = pn[q][c];
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kPanel; ++c) invD[j0 + c] = inv[c];
      }
      __syncwarp();
      // trailing update of rows/columns >= t0, lower 4x4 tiles, one a lane
      const int t0 = j0 + kPanel;
      const int nb = (KP - t0) / kTile, ntile = nb * (nb + 1) / 2;
      for (int t = lane; t < ntile; t += kWarp) {
        int bi = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
        while (bi * (bi + 1) / 2 > t) --bi;
        while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
        const int bj = t - bi * (bi + 1) / 2;
        const int i0 = t0 + kTile * bi, c0 = t0 + kTile * bj;
        float acc[kTile][kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a)
#pragma unroll
          for (int b = 0; b < kTile; ++b) acc[a][b] = 0.0f;
#pragma unroll
        for (int p = 0; p < kPanel; ++p) {
          const float* colp = S + col_base<KP>(j0 + p);
          float u[kTile], w[kTile];
#pragma unroll
          for (int a = 0; a < kTile; ++a) {
            u[a] = colp[i0 + a];
            w[a] = colp[c0 + a];
          }
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int b = 0; b < kTile; ++b) acc[a][b] += u[a] * w[b];
        }
#pragma unroll
        for (int b = 0; b < kTile; ++b) {
          float* colc = S + col_base<KP>(c0 + b);
#pragma unroll
          for (int a = 0; a < kTile; ++a)
            if (bi != bj || b <= a) colc[i0 + a] -= acc[a][b];
        }
      }
      __syncwarp();
    }

    // ---- 5. forward solve L y = bv - col y0, by the same panels
    float y0 = b0 / s0;
#pragma unroll
    for (int q = 0; q < R; ++q) r[q] -= col[q] * y0;
    for (int j0 = 0; j0 < KP; j0 += kPanel) {
      const float rq = pick(r, j0 / kWarp);
      float y[kPanel];
#pragma unroll
      for (int p = 0; p < kPanel; ++p) y[p] = __shfl_sync(kFullMask, rq, (j0 % kWarp) + p);
#pragma unroll
      for (int p = 0; p < kPanel; ++p) {
#pragma unroll
        for (int s = 0; s < p; ++s) y[p] -= S[col_base<KP>(j0 + s) + j0 + p] * y[s];
        y[p] *= invD[j0 + p];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + kWarp * q;
        if (i >= j0 + kPanel && i < KP) {
#pragma unroll
          for (int p = 0; p < kPanel; ++p) r[q] -= S[col_base<KP>(j0 + p) + i] * y[p];
        } else {
#pragma unroll
          for (int p = 0; p < kPanel; ++p)
            if (i == j0 + p) r[q] = y[p];
        }
      }
    }
    if (sample) {
      y0 += z0;
#pragma unroll
      for (int q = 0; q < R; ++q) r[q] += zv[q];
    }

    // ---- 6. back solve L^T x = y, panels from the last
    for (int j0 = KP - kPanel; j0 >= 0; j0 -= kPanel) {
      const float rq = pick(r, j0 / kWarp);
      float xp[kPanel];
#pragma unroll
      for (int p = 0; p < kPanel; ++p) xp[p] = __shfl_sync(kFullMask, rq, (j0 % kWarp) + p);
#pragma unroll
      for (int p = kPanel - 1; p >= 0; --p) {
#pragma unroll
        for (int s = kPanel - 1; s > p; --s) xp[p] -= S[col_base<KP>(j0 + p) + j0 + s] * xp[s];
        xp[p] *= invD[j0 + p];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + kWarp * q;
        if (i < j0) {
#pragma unroll
          for (int p = kPanel - 1; p >= 0; --p) r[q] -= S[col_base<KP>(i) + j0 + p] * xp[p];
        } else {
#pragma unroll
          for (int p = 0; p < kPanel; ++p)
            if (i == j0 + p) r[q] = xp[p];
        }
      }
    }

    // ---- 7. x0, the guard and the output
    float cx = 0.0f;
    bool bad = false;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      if (i < k) {
        cx += col[q] * r[q];
        bad |= !(fabsf(r[q]) <= bound);
      }
    }
    cx = libfm::warp_sum(cx);
    const float x0 = (y0 - cx) / s0;
    bad = __any_sync(kFullMask, bad) || !(fabsf(x0) <= bound);
    float* out = theta_out + (long long)f * d;
    if (lane == 0) {
      out[0] = bad ? th0 : x0;
      rej[f] = bad;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + kWarp * q;
      if (i < k) out[1 + i] = bad ? thv[q] : r[q];
    }

    // ---- 8. kUpd: the draw's shift into the SD rows of f's entries
    if constexpr (kUpd) {
      const float dw = __fsub_rn(bad ? th0 : x0, th0);
      float dv[R];
#pragma unroll
      for (int q = 0; q < R; ++q) dv[q] = __fsub_rn(bad ? thv[q] : r[q], thv[q]);
      // the loaded batch's n entries: each shift's dot product over the
      // factors, the n butterflies interleaved, then the rows written
      auto shift_rows = [&](int n) {
        float p[kAhead];
#pragma unroll
        for (int m = 0; m < kAhead; ++m) {
          p[m] = 0.0f;
          if (m >= n) continue;
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (lane + kWarp * q < k)
              p[m] = fmaf(dv[q], __fsub_rn(sdq[m][q], __fmul_rn(xm[m], thv[q])), p[m]);
        }
#pragma unroll
        for (int o = kWarp / 2; o > 0; o >>= 1)  // warp_sum's order
#pragma unroll
          for (int m = 0; m < kAhead; ++m) p[m] += __shfl_xor_sync(kFullMask, p[m], o);
#pragma unroll
        for (int m = 0; m < kAhead; ++m) {
          if (m >= n) break;
          float* row = upd.SD + (long long)bm[m] * d;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int i = lane + kWarp * q;
            if (i < k) row[1 + i] = __fadd_rn(sdq[m][q], __fmul_rn(xm[m], dv[q]));
          }
          if (lane == 0) row[0] = __fadd_rn(sd0[m], __fmul_rn(xm[m], __fadd_rn(dw, p[m])));
        }
      };
      shift_rows(min(ne, kAhead));
      // a feature of more entries: the rest, kAhead at a time
      for (long long e0 = e_lo + kAhead; e0 < e_hi; e0 += kAhead) {
        const int n = (int)min((long long)kAhead, e_hi - e0);
        if (lane < n) {
          eb = upd.entry_b[e0 + lane];
          ex = upd.entry_x[e0 + lane];
        }
        load_rows(n);
        shift_rows(n);
      }
      e_lo = next_lo;
      e_hi = next_hi;
    }
  }
}

template <int KP, bool kUpd>
int launch(const float* GG, const float* theta, const float* lam, const float* mu,
           const float* z, const float* alphap, float* theta_out, int* rej, int num_feats,
           int k, int do_sample, float bound, RelUpdate upd, cudaStream_t stream) {
  constexpr int kWarps = warps_per_cta<KP>();
  constexpr int kThreads = kWarps * kWarp;
  const size_t smem = sizeof(float) * kWarps * (size_t)(stage_floats(k) + work_floats<KP>());
  auto kern = schur_draw_kernel<KP, kWarps, kUpd>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (num_feats + kWarps - 1) / kWarps;
  const int grid = need < sms * per_sm ? need : sms * per_sm;
  kern<<<grid, kThreads, smem, stream>>>(GG, theta, lam, mu, z, alphap, theta_out, rej,
                                         num_feats, k, do_sample, bound, upd);
  return (int)cudaGetLastError();
}

// The pure linear model (k = 0): theta = (w), GG = [aa | ae], and the
// draw is the JAX engine's scalar conjugate one (draw_chunk's k == 0
// branch), the l00 part of the rank-1 Schur step with an empty k x k
// part: prec = alpha aa + lam, mean = (alpha aa w - alpha ae + lam mu) /
// prec, w' = mean + z / sqrt(prec) (mean under ALS), kept only when
// |w'| <= bound. One feature a thread, each operation rounded on its own
// in the plain version's order (schur_draw_plain's k = 0 branch). Bound:
// bytes, 6 floats in and 1 float and 1 int out a feature.
constexpr int kScalarThreads = 256;

__global__ void __launch_bounds__(kScalarThreads)
    scalar_draw_kernel(const float* __restrict__ GG, const float* __restrict__ theta,
                       const float* __restrict__ lam, const float* __restrict__ mu,
                       const float* __restrict__ z, const float* __restrict__ alphap,
                       float* __restrict__ theta_out, int* __restrict__ rej, int num_feats,
                       int do_sample, float bound) {
  const int f = blockIdx.x * kScalarThreads + threadIdx.x;
  if (f >= num_feats) return;
  const float alpha = *alphap;
  const float aa = GG[2 * f], ae = GG[2 * f + 1];
  const float w = theta[f], l = lam[f], m = mu[f];
  const float alpha_aa = __fmul_rn(alpha, aa);
  const float prec = __fadd_rn(alpha_aa, l);
  const float num = __fadd_rn(__fsub_rn(__fmul_rn(alpha_aa, w), __fmul_rn(alpha, ae)),
                              __fmul_rn(l, m));
  float x = __fdiv_rn(num, prec);
  if (do_sample) x = __fadd_rn(x, __fdiv_rn(z[f], __fsqrt_rn(prec)));
  const bool bad = !(fabsf(x) <= bound);  // also a NaN
  theta_out[f] = bad ? w : x;
  rej[f] = bad;
}

template <bool kUpd>
int launch_kp(const float* GG, const float* theta, const float* lam, const float* mu,
              const float* z, const float* alphap, float* theta_out, int* rej, int num_feats,
              int k, int kp, int do_sample, float bound, RelUpdate upd, cudaStream_t stream) {
  // the relational form keeps k >= 1 (ROADMAP §1 item 2)
  if (!libfm::valid_padded_width(kp, k, kUpd ? 1 : 0)) return (int)cudaErrorInvalidValue;
  if (num_feats == 0) return (int)cudaSuccess;
  if (k == 0) {
    scalar_draw_kernel<<<(num_feats + kScalarThreads - 1) / kScalarThreads, kScalarThreads, 0,
                         stream>>>(GG, theta, lam, mu, z, alphap, theta_out, rej, num_feats,
                                   do_sample, bound);
    return (int)cudaGetLastError();
  }
  switch (kp) {
    case 16:
      return launch<16, kUpd>(GG, theta, lam, mu, z, alphap, theta_out, rej, num_feats, k,
                              do_sample, bound, upd, stream);
    case 32:
      return launch<32, kUpd>(GG, theta, lam, mu, z, alphap, theta_out, rej, num_feats, k,
                              do_sample, bound, upd, stream);
    case 64:
      return launch<64, kUpd>(GG, theta, lam, mu, z, alphap, theta_out, rej, num_feats, k,
                              do_sample, bound, upd, stream);
    default:
      return launch<128, kUpd>(GG, theta, lam, mu, z, alphap, theta_out, rej, num_feats, k,
                               do_sample, bound, upd, stream);
  }
}

}  // namespace

// Persistent grid of warps, one system at a time each (at k = 0 one
// feature a thread, the scalar draw). GG [num_feats, T+2k+2];
// theta/lam/mu/z/theta_out [num_feats, k+1]; rej [num_feats] (1 = draw
// rejected); alphap points at the device scalar alpha. z is read only
// when do_sample != 0. kp is the padded width (kernels.padded_width).
extern "C" int schur_draw_launch(const float* GG, const float* theta, const float* lam,
                                 const float* mu, const float* z, const float* alphap,
                                 float* theta_out, int* rej, int num_feats, int k, int kp,
                                 int do_sample, float bound, cudaStream_t stream) {
  return launch_kp<false>(GG, theta, lam, mu, z, alphap, theta_out, rej, num_feats, k, kp,
                          do_sample, bound, RelUpdate{}, stream);
}

// The relational form: schur_draw_launch, then each feature's shift into
// SD [nb+1, k+1] (in place) over its entries feat_off int64 [num_feats+1]
// of entry_b int32 (block rows of SD, distinct within the block) and
// entry_x.
extern "C" int schur_draw_rel_launch(const float* GG, const float* theta, const float* lam,
                                     const float* mu, const float* z, const float* alphap,
                                     float* theta_out, int* rej, float* SD,
                                     const long long* feat_off, const int* entry_b,
                                     const float* entry_x, int num_feats, int k, int kp,
                                     int do_sample, float bound, cudaStream_t stream) {
  if (!SD || !feat_off) return (int)cudaErrorInvalidValue;
  return launch_kp<true>(GG, theta, lam, mu, z, alphap, theta_out, rej, num_feats, k, kp,
                         do_sample, bound, RelUpdate{SD, feat_off, entry_b, entry_x}, stream);
}
