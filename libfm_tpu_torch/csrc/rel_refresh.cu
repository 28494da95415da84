// rel_scores and rel_refresh: the relational (BS) engine's block scores and
// the FM forward of cases joined to block rows.
//
// Replace, in libfm_tpu/learners/mcmc_rel_vector.py, `_rel_scores` (one
// relation's per-block-row scores) and `_chunk_pred` with both branches of
// `refresh_A_and_train_metric`, its test-tail `te_chunk` and
// `predict_test` (K12). A case's forward sums its main-table entries and
// its joined rows' scores:
//   rel_scores: per block row b, SC[b] = [qB | sqB | linB] with
//     qB = sum x V[col], sqB = sum x^2 |V[col]|^2, linB = sum x w[col]
//     over b's design entries; the sentinel row nb is 0. The relations'
//     designs stack in one CSR (each relation's sentinel an empty row),
//     so one launch writes every relation's table at once.
//   rel_refresh: per case c, over its main entries (ids, vals) [L] first
//     and then its rows maps[r, c] of SC (the relations' tables stacked in
//     one), Q = sum_l x_l V[id_l] + sum_r qB_r,
//     pred = 1/2 (|Q|^2 - sum_l x_l^2 |V[id_l]|^2 - sum_r sqB_r)
//            + sum_l x_l w[id_l] + sum_r linB_r + w0.
//     Train mode writes A[c] = [pred - y | Q] and a per-CTA partial of the
//     clipped squared error; its probit mode (classification) instead
//     takes a latent from N(pred, 1) truncated to y's side of 0, drawn
//     from the uniform U[c] or as its expectation (ALS), writes latent[c]
//     and A[c] = [pred - latent | Q], and counts the correct cases
//     (Phi(pred) against y's sign), with common.cuh's device functions
//     (fm_refresh's). Tail mode writes [pred | Q]; test mode the pred.
//
// Bound on the H100: bytes. Train mode writes A ((k+1) * 4 B a case) and
// reads the maps (4 R B), y (4 B), the main entries (8 L B) and in probit
// mode U and the latents (8 B); the score tables (bench_bs: 4,001 x 34
// floats, 0.5 MB) and the main features' rows of P stay in L2. At
// bench_bs's 1M train cases, k = 32: ~140 MB, 0.042 ms at 3.35 TB/s (with
// bench_bs_ctx's two main entries ~156 MB, 0.047 ms). rel_scores is
// latency-bound and small (64,000 entries, once a refresh; bound 0.0011
// ms): each entry's P row waits for its column, which waits for the row's
// range.
// Design. rel_scores: one warp a block row. Its lanes load the row's
// (col, val) pairs in one coalesced load, lanes over the entries (up to
// 32 at a time), and the linear term's w[col] x on the entry's own lane,
// and stage them in shared memory. Then, 8 entries at a time, every
// entry's column reaches every lane as a broadcast read (four a read) and
// every entry's P row is loaded (lanes over the factors, NPL a lane,
// k <= 128) before any is added: a few dependent round trips a row, not
// two an entry; the 8 entries' s are summed by one butterfly (`warp_sums`,
// 9 shuffles where 8 warp_sums take 40). The adds keep the first
// version's order (q per factor in entry order; each entry's s through
// warp_sum's pairs, added to sq in entry order; lin in entry order), so
// SC is the same bits as the one-entry-at-a-time walk's. What is left is
// mostly the launch: a launch on no entries takes more than half of the
// time at bench_bs (PERF.md, studies/scores_latent_ab.py, whose variant
// sweep chose 8 entries in flight and 4 CTAs of 8 warps an SM).
// rel_refresh: a warp takes a tile of 32 consecutive cases at a time, a
// persistent grid of one wave of CTAs striding over the tiles. Its lanes
// stage the tile's maps (R), main ids and values (L each, the tile's span
// of them), y and U by coalesced cp.async into one of two stages, so the
// next tile's indices land while this one is summed. The warp then takes
// CB cases at once (4), lanes over the factors (factor f on lane f mod
// 32), and walks their items
// (main entries, then relations) in steps, the next step's P or SC rows
// of CB cases (the next batch's first item after a batch's last) loaded
// while this step's are added: 2 CB rows in flight, in registers (at
// k <= 32 held to 80 a thread, three CTAs an SM). The indices come from
// the stage as broadcast shared loads. Each case's sums run in one order
// (main entries, relations in order, fmaf over a lane's factors, the
// warp's butterfly sum) whatever the tiling, so A, pred and latent are
// the same bits at any grid. The scalar tail runs one case
// a lane: the case's pred is kept on its lane, and all 32 lanes compute
// A[c, 0], the clipped error or the probit latent and correct count at
// once. The tile's A rows [32 x (k+1)] are built in shared memory (kept at
// A's offset within 16 bytes) and written out as one contiguous span in
// 16-byte stores; the ragged last tile is masked. Each lane sums its
// cases' errors (or correct counts) over its tiles in order, the warp by
// its butterfly, the CTA its warps in order: no atomics, the same bits on
// every run. The host's plan (kernels/rel_refresh.py `refresh_plan`) sizes
// a CTA's warps by shared memory (a tile 16.5 KB a warp at k = 128, 4.2 KB
// at k = 32, beside the stages).

#include "common.cuh"

namespace {

using libfm::kMaxK;
using libfm::kWarp;
using libfm::warp_sum;
constexpr int kTile = 32;                     // cases a warp's tile
constexpr int kMaxWarps = 8;                  // rel_refresh's warps a CTA at most
constexpr int kStageL = 16;                   // main entries a case the stage holds at most
constexpr int kSmemDynamic = 232448 - 1024;   // a CTA's dynamic shared memory at most

// Floats of one stage: maps [R][32], ids and values [32 L] each (staged
// main entries only), y [32], U [32].
__host__ __device__ inline int stage_floats(int R, int L, bool staged) {
  return libfm::round4(kTile * (R + 2 + (staged ? 2 * L : 0)));
}

// Floats of the A tile [32 (k+1)], 4 more for A's offset within 16 bytes.
__host__ __device__ inline int tile_floats(int k, bool has_A) {
  return has_A ? kTile * (k + 1) + 4 : 0;
}

// Bytes of dynamic shared memory a warp of rel_refresh takes: two stages
// and, with A, the tile.
__host__ __device__ inline int warp_bytes(int k, int R, int L, bool has_A) {
  return 4 * (2 * stage_floats(R, L, L > 0 && L <= kStageL) + tile_floats(k, has_A));
}

// The butterfly sums of N values s[0..N-1] over the warp (N a power of 2,
// at most 32), each the same bits as warp_sum(s[j]): at each xor step a
// lane keeps half of its values and trades the other half with its
// partner, so the pairs added are warp_sum's, in N - 1 + 5 - log2(N)
// shuffles (16 at N = 16) instead of 5N. Returns on each lane the total of
// value lane / (32 / N).
template <int N>
__device__ __forceinline__ float warp_sums(float (&s)[N], int lane) {
#pragma unroll
  for (int level = 0; level < 5; ++level) {
    const int o = 16 >> level;
    const int m = N >> (level + 1);  // values a lane keeps after this step
    if (m >= 1) {
      const bool hi = lane & o;
#pragma unroll
      for (int i = 0; i < m; ++i) {
        const float send = hi ? s[i] : s[i + m];
        const float keep = hi ? s[i + m] : s[i];
        s[i] = keep + __shfl_xor_sync(libfm::kFullMask, send, o);
      }
    } else {
      s[0] += __shfl_xor_sync(libfm::kFullMask, s[0], o);
    }
  }
  return s[0];
}

// rel_scores' entries whose P rows a warp loads at once, its CTAs an SM at
// least at k <= 32 (NPL = 1; 2 above) and a CTA's warps: a one-wave grid
// at bench_bs's 4,001 rows wants 31 warps an SM, so 4 CTAs of 8 warps, 64
// registers a thread.
constexpr int kScoresInFlight = 8;
constexpr int kScoresMinCtas = 4;
constexpr int kScoresWarps = 8;
constexpr int kScoresThreads = kScoresWarps * kWarp;
static_assert(kScoresInFlight >= 4 && kScoresInFlight <= kWarp &&
                  (kScoresInFlight & (kScoresInFlight - 1)) == 0,
              "entries in flight: a power of 2 from 4 to 32");

template <int NPL>
__global__ void __launch_bounds__(kScoresThreads, NPL == 1 ? kScoresMinCtas : 2)
    rel_scores_kernel(const float* __restrict__ P, const long long* __restrict__ indptr,
                      const int* __restrict__ cols, const float* __restrict__ vals,
                      float* __restrict__ SC, int nb, int k, int use_linear) {
  constexpr int kLanesPerSum = kWarp / kScoresInFlight;  // lanes that end with one entry's s
  // a warp's staged batch: columns, values, w[col] x and the entries' s
  // totals, read back as broadcasts four at a time
  __shared__ __align__(16) int st_col[kScoresWarps][kWarp];
  __shared__ __align__(16) float st_x[kScoresWarps][kWarp];
  __shared__ __align__(16) float st_wx[kScoresWarps][kWarp];
  __shared__ __align__(16) float st_s[kScoresWarps][kScoresInFlight];
  const int wid = threadIdx.x / kWarp;
  const int row = (int)((blockIdx.x * (long long)kScoresThreads + threadIdx.x) / kWarp);
  const int lane = threadIdx.x & (kWarp - 1);
  if (row > nb) return;  // whole warps: a warp's lanes share its row
  const int d = k + 1;
  float q[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) q[i] = 0.0f;
  float sq = 0.0f, lin = 0.0f;
  const long long e1 = row < nb ? indptr[row + 1] : 0;
  for (long long e0 = row < nb ? indptr[row] : 0; e0 < e1; e0 += kWarp) {
    const int n = (int)(e1 - e0 < kWarp ? e1 - e0 : kWarp);
    int col = 0;
    float x = 0.0f, wx = 0.0f;
    if (lane < n) {
      col = cols[e0 + lane];
      x = vals[e0 + lane];
      if (use_linear) wx = __fmul_rn(P[(long long)col * d], x);
    }
    st_col[wid][lane] = col;
    st_x[wid][lane] = x;
    st_wx[wid][lane] = wx;
    __syncwarp();
    for (int j0 = 0; j0 < n; j0 += kScoresInFlight) {
      float v[kScoresInFlight][NPL], xs[kScoresInFlight], s[kScoresInFlight];
#pragma unroll
      for (int j = 0; j < kScoresInFlight; j += 4) {
        const int4 c4 = *reinterpret_cast<const int4*>(&st_col[wid][j0 + j]);
        const int cj[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* p = P + (long long)cj[u] * d + 1;
#pragma unroll
          for (int i = 0; i < NPL; ++i) {
            const int f = lane + kWarp * i;
            v[j + u][i] = j0 + j + u < n && f < k ? p[f] : 0.0f;
          }
        }
        const float4 x4 = *reinterpret_cast<const float4*>(&st_x[wid][j0 + j]);
        xs[j] = x4.x;
        xs[j + 1] = x4.y;
        xs[j + 2] = x4.z;
        xs[j + 3] = x4.w;
      }
      // each entry's q and s in entry order, a lane's factors in order
#pragma unroll
      for (int j = 0; j < kScoresInFlight; ++j) {
        s[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          if (lane + kWarp * i < k && j0 + j < n) {
            const float vx = __fmul_rn(v[j][i], xs[j]);
            q[i] += vx;
            s[j] = fmaf(vx, vx, s[j]);
          }
        }
      }
      const float total = warp_sums<kScoresInFlight>(s, lane);
      if (lane % kLanesPerSum == 0) st_s[wid][lane / kLanesPerSum] = total;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kScoresInFlight; j += 4) {  // sq and lin in entry order
        const float4 t4 = *reinterpret_cast<const float4*>(&st_s[wid][j]);
        const float4 w4 = *reinterpret_cast<const float4*>(&st_wx[wid][j0 + j]);
        const float t[4] = {t4.x, t4.y, t4.z, t4.w}, w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + j + u < n) {
            sq += t[u];
            lin += w[u];
          }
        }
      }
      __syncwarp();  // the stage is read before the next group or batch lands
    }
  }
  float* out = SC + (long long)row * (k + 2);
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int f = lane + kWarp * i;
    if (f < k) out[f] = q[i];
  }
  if (lane == 0) {
    out[k] = sq;
    out[k + 1] = use_linear ? lin : 0.0f;
  }
}

// The rows of item j of CB cases from case cb of the tile on: main entry
// j (j < L; its row of P, a = w, b = x) or relation j - L (its row of SC,
// a = sqB, b = linB); each lane its factors lane + 32 i.
template <int NPL, int CB>
__device__ __forceinline__ void load_item(int j, int cb, const float* st, int o_ids,
                                          int o_vals, bool staged, const int* ids,
                                          const float* vals, const float* P,
                                          const float* SC, long long c0, long long nc, int L,
                                          int k, int lane, float (&v)[CB][NPL],
                                          float (&a)[CB], float (&b)[CB]) {
  if (j < L) {
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      int id;
      float x;
      if (staged) {
        id = __float_as_int(st[o_ids + (cb + u) * L + j]);
        x = st[o_vals + (cb + u) * L + j];
      } else {
        const long long c = c0 + cb + u;
        const bool in = c < nc;
        id = in ? ids[c * L + j] : 0;
        x = in ? vals[c * L + j] : 0.0f;
      }
      const float* p = P + (long long)id * (k + 1);
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int f = lane + kWarp * i;
        v[u][i] = f < k ? p[1 + f] : 0.0f;
      }
      a[u] = p[0];
      b[u] = x;
    }
  } else {
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      const float* s = SC + (long long)__float_as_int(st[(j - L) * kTile + cb + u]) * (k + 2);
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int f = lane + kWarp * i;
        v[u][i] = f < k ? s[f] : 0.0f;
      }
      a[u] = s[k];
      b[u] = s[k + 1];
    }
  }
}

// n floats from shared memory at src to global memory at dst, which lie
// at the same offset within 16 bytes: 16-byte stores, 4-byte ones at
// either end. Every lane of the warp calls it.
__device__ __forceinline__ void warp_store_span(float* dst, const float* src, int n,
                                                int lane) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const int head = min((4 - mis) & 3, n);
  const int nbody = (n - head) >> 2;
  const int tail = head + 4 * nbody;
  if (lane < head) dst[lane] = src[lane];
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int c = lane; c < nbody; c += kWarp) d4[c] = s4[c];
  if (lane < n - tail) dst[tail + lane] = src[tail + lane];
}

// At k <= 32 registers are held to three CTAs an SM (80 a thread).
template <int NPL, int CB>
__global__ void __launch_bounds__(kMaxWarps * kWarp, NPL == 1 ? 3 : 1)
    rel_refresh_kernel(const float* __restrict__ SC, const int* __restrict__ maps,
                       const float* __restrict__ w0p, const float* __restrict__ y,
                       float* __restrict__ A, float* __restrict__ pred_out,
                       float* __restrict__ part, const float* __restrict__ P,
                       const int* __restrict__ ids, const float* __restrict__ vals,
                       const float* __restrict__ U, float* __restrict__ latent,
                       long long nc, int R, int L, int k, int use_linear, int use_bias,
                       float min_t, float max_t, int npart, int probit) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_err[kMaxWarps];
  const int lane = threadIdx.x & (kWarp - 1);
  const int wid = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  const int d = k + 1;
  const bool staged = L > 0 && L <= kStageL;
  const int SF = stage_floats(R, L, staged);
  float* const base = smem + (long long)wid * (2 * SF + tile_floats(k, A != nullptr));
  // the A tile at A's offset within 16 bytes (A + c0 d lies there too)
  float* const tile = base + 2 * SF + (int)((reinterpret_cast<uintptr_t>(A) >> 2) & 3);
  // a stage: maps [R][32], ids [32 L], values [32 L], y [32], U [32]
  const int o_ids = kTile * R;
  const int o_vals = o_ids + (staged ? kTile * L : 0);
  const int o_y = o_vals + (staged ? kTile * L : 0);
  const int o_u = o_y + kTile;
  const long long ntiles = (nc + kTile - 1) / kTile;
  const long long stride = (long long)gridDim.x * nw;
  const float w0 = use_bias ? *w0p : 0.0f;

  // tile t's indices into a stage (past the last tile an empty group);
  // the ragged tile's missing cases land as zeros
  auto fetch = [&](float* st, long long t) {
    if (t < ntiles) {
      const long long c0 = t * kTile;
      const int nv = (int)min((long long)kTile, nc - c0);
      const bool ok = lane < nv;
      const long long c = c0 + (ok ? lane : 0);
      for (int r = 0; r < R; ++r)
        libfm::cp_async4(st + r * kTile + lane,
                         reinterpret_cast<const float*>(maps + r * nc + c), ok ? 4 : 0);
      if (staged) {
        const long long e0 = c0 * L;
        const int ne = nv * L;
        for (int j = lane; j < kTile * L; j += kWarp) {
          const bool in = j < ne;
          const long long e = in ? e0 + j : 0;
          libfm::cp_async4(st + o_ids + j, reinterpret_cast<const float*>(ids + e),
                           in ? 4 : 0);
          libfm::cp_async4(st + o_vals + j, vals + e, in ? 4 : 0);
        }
      }
      if (y != nullptr) libfm::cp_async4(st + o_y + lane, y + c, ok ? 4 : 0);
      if (U != nullptr) libfm::cp_async4(st + o_u + lane, U + c, ok ? 4 : 0);
    }
    libfm::cp_async_commit();
  };

  float err = 0.0f;
  long long t = (long long)blockIdx.x * nw + wid;
  fetch(base, t);
  fetch(base + SF, t + stride);
  int s = 0;
  for (; t < ntiles; t += stride, s ^= 1) {
    libfm::cp_async_wait<1>();  // this tile's stage has landed
    __syncwarp();
    float* const st = base + s * SF;
    const long long c0 = t * kTile;
    const int nv = (int)min((long long)kTile, nc - c0);
    const int items = L + R;
    const int nsteps = (kTile / CB) * items;
    float mine = 0.0f;  // the prediction of case c0 + lane
    // step (cb, j): item j of the CB cases from cb on; the next step's
    // rows are loaded while this step's are added, across the batches
    float q[CB][NPL], s2[CB], sq[CB], lin[CB];
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      s2[u] = sq[u] = lin[u] = 0.0f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) q[u][i] = 0.0f;
    }
    // this step's rows (cv, ca, cx) and the next one's (nvv, na, nx)
    float cv[CB][NPL], ca[CB], cx[CB], nvv[CB][NPL], na[CB], nx[CB];
    load_item<NPL, CB>(0, 0, st, o_ids, o_vals, staged, ids, vals, P, SC, c0, nc, L, k, lane,
                       cv, ca, cx);
    int j = 0, cb = 0;
#pragma unroll 1
    for (int step = 0; step < nsteps; ++step) {
      const int jn = j + 1 == items ? 0 : j + 1;
      const int cbn = j + 1 == items ? cb + CB : cb;
      if (step + 1 < nsteps)
        load_item<NPL, CB>(jn, cbn, st, o_ids, o_vals, staged, ids, vals, P, SC, c0, nc, L,
                           k, lane, nvv, na, nx);
      if (j < L) {  // a main entry: x V and its square, x w
#pragma unroll
        for (int u = 0; u < CB; ++u) {
          const float x = cx[u];
#pragma unroll
          for (int i = 0; i < NPL; ++i) {
            const int f = lane + kWarp * i;
            if (f < k) {
              const float vx = __fmul_rn(cv[u][i], x);
              q[u][i] += vx;
              s2[u] = fmaf(vx, vx, s2[u]);
            }
          }
          if (use_linear) lin[u] += __fmul_rn(ca[u], x);
        }
      } else {  // a joined row's scores, the main entries' squares summed first
        if (j == L && L > 0) {
#pragma unroll
          for (int u = 0; u < CB; ++u) sq[u] = warp_sum(s2[u]);
        }
#pragma unroll
        for (int u = 0; u < CB; ++u) {
#pragma unroll
          for (int i = 0; i < NPL; ++i) {
            const int f = lane + kWarp * i;
            if (f < k) q[u][i] += cv[u][i];
          }
          sq[u] += ca[u];
          lin[u] += cx[u];
        }
      }
      if (j + 1 == items) {  // the batch's cases are summed: their predictions
#pragma unroll
        for (int u = 0; u < CB; ++u) {
          float qq = 0.0f;
#pragma unroll
          for (int i = 0; i < NPL; ++i) qq = fmaf(q[u][i], q[u][i], qq);
          qq = warp_sum(qq);
          float pred = __fmul_rn(0.5f, __fsub_rn(qq, sq[u]));
          if (use_linear) pred = __fadd_rn(pred, lin[u]);
          if (use_bias) pred = __fadd_rn(pred, w0);
          if (lane == cb + u) mine = pred;
          if (A != nullptr) {
#pragma unroll
            for (int i = 0; i < NPL; ++i) {
              const int f = lane + kWarp * i;
              if (f < k) tile[(cb + u) * d + 1 + f] = q[u][i];
            }
          }
          s2[u] = sq[u] = lin[u] = 0.0f;
#pragma unroll
          for (int i = 0; i < NPL; ++i) q[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < CB; ++u) {
#pragma unroll
        for (int i = 0; i < NPL; ++i) cv[u][i] = nvv[u][i];
        ca[u] = na[u];
        cx[u] = nx[u];
      }
      j = jn;
      cb = cbn;
    }

    // the scalar tail, one case a lane
    const bool ok = lane < nv;
    const long long c = c0 + lane;
    if (A == nullptr) {  // test mode
      if (ok) pred_out[c] = mine;
    } else {
      float a0 = mine;  // tail mode: [pred | Q]
      if (y != nullptr) {
        const float yc = st[o_y + lane];
        if (probit) {
          const float lat =
              libfm::probit_latent(mine, yc, probit == 1 ? st[o_u + lane] : 0.0f, probit == 1);
          a0 = __fsub_rn(mine, lat);
          if (ok) {
            latent[c] = lat;
            err += libfm::probit_correct(mine, yc);
          }
        } else {
          a0 = __fsub_rn(mine, yc);
          const float ec = __fsub_rn(fminf(fmaxf(mine, min_t), max_t), yc);
          if (ok) err = fmaf(ec, ec, err);
        }
      }
      tile[lane * d] = a0;
    }
    __syncwarp();  // the stage is read and the tile whole
    fetch(st, t + 2 * stride);
    if (A != nullptr) {
      warp_store_span(A + c0 * d, tile, nv * d, lane);
      __syncwarp();  // the tile is read before the next one is built
    }
  }
  libfm::cp_async_wait<0>();  // the fetches past the last tile
  if (part == nullptr) return;
  err = warp_sum(err);
  if (lane == 0) warp_err[wid] = err;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < nw; ++i) total += warp_err[i];
    part[blockIdx.x] = total;
    for (int i = gridDim.x + blockIdx.x; i < npart; i += gridDim.x) part[i] = 0.0f;
  }
}

template <int NPL, int CB>
int launch_refresh(const float* SC, const int* maps, const float* w0p, const float* y,
                   float* A, float* pred_out, float* part, const float* P, const int* ids,
                   const float* vals, const float* U, float* latent, long long nc, int R,
                   int L, int k, int use_linear, int use_bias, float min_t, float max_t,
                   int npart, int probit, int warps, cudaStream_t stream) {
  constexpr auto kernel = rel_refresh_kernel<NPL, CB>;
  const long long smem = (long long)warps * warp_bytes(k, R, L, A != nullptr);
  if (smem > kSmemDynamic) return (int)cudaErrorInvalidValue;
  const long long ntiles = (nc + kTile - 1) / kTile;
  unsigned grid;
  const cudaError_t err = libfm::one_wave_grid<kernel>(
      warps * kWarp, (int)smem, (ntiles + warps - 1) / warps, &grid);
  if (err != cudaSuccess) return (int)err;
  if (part != nullptr && grid > (unsigned)npart) grid = npart;
  kernel<<<grid, warps * kWarp, (size_t)smem, stream>>>(SC, maps, w0p, y, A, pred_out, part,
                                                        P, ids, vals, U, latent, nc, R, L, k,
                                                        use_linear, use_bias, min_t, max_t,
                                                        npart, probit);
  return (int)cudaGetLastError();
}

}  // namespace

// SC [nb+1, k+2] out; indptr int64 [nb+1], cols int32 (global feature ids
// into P [n, k+1]), vals. Rows with an empty range (the stacked
// relations' sentinels) and row nb are 0.
extern "C" int rel_scores_launch(const float* P, const long long* indptr, const int* cols,
                                 const float* vals, float* SC, int nb, int k,
                                 int use_linear, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || nb < 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)nb + 1;
  const unsigned grid = (unsigned)((warps + kScoresWarps - 1) / kScoresWarps);
  auto kernel = k <= 32   ? &rel_scores_kernel<1>
                : k <= 64 ? &rel_scores_kernel<2>
                : k <= 96 ? &rel_scores_kernel<3>
                          : &rel_scores_kernel<4>;
  kernel<<<grid, kScoresThreads, 0, stream>>>(P, indptr, cols, vals, SC, nb, k, use_linear);
  return (int)cudaGetLastError();
}

// A warp's bytes of dynamic shared memory, for kernels/rel_refresh.py's
// `warp_bytes` to be held to.
extern "C" int rel_refresh_warp_bytes(int k, int R, int L, int has_A) {
  return warp_bytes(k, R, L, has_A != 0);
}

// SC [rows, k+2] (the relations' score tables stacked), maps int32 [R, nc]
// (rows of SC), w0p the device scalar w0. Main rows (L > 0): ids int32 and
// vals [nc, L] (padding: value 0) into P [n, k+1]. Train mode: A [nc, k+1],
// y [nc] and part [npart] given; every entry of part is written (past the
// grid with 0). probit (train mode only): 0 regression, 1 latents drawn
// from U [nc], 2 latents as expectations; latent [nc] required. Tail mode:
// A given, y == part == NULL. Test mode: A == NULL, pred_out [nc] given.
// warps: a CTA's warps (1-8, kernels/rel_refresh.py `refresh_plan`); its
// shared memory must fit a CTA.
extern "C" int rel_refresh_launch(const float* SC, const int* maps, const float* w0p,
                                  const float* y, float* A, float* pred_out, float* part,
                                  const float* P, const int* ids, const float* vals,
                                  const float* U, float* latent, long long nc, int R, int L,
                                  int k, int use_linear, int use_bias, float min_t,
                                  float max_t, int npart, int probit, int warps,
                                  cudaStream_t stream) {
  const bool train = y != nullptr;
  if (k < 1 || k > kMaxK || R < 1 || L < 0 || nc < 1 || warps < 1 || warps > kMaxWarps ||
      train != (part != nullptr) || (train && (A == nullptr || npart < 1)) ||
      (A == nullptr && (pred_out == nullptr || train)) ||
      (L > 0 && (P == nullptr || ids == nullptr || vals == nullptr)) || probit < 0 ||
      probit > 2 || (probit && (!train || latent == nullptr || (probit == 1 && U == nullptr))))
    return (int)cudaErrorInvalidValue;
#define REL_REFRESH_LAUNCH(NPL, CB)                                                        \
  launch_refresh<NPL, CB>(SC, maps, w0p, y, A, pred_out, part, P, ids, vals, U, latent, nc, \
                          R, L, k, use_linear, use_bias, min_t, max_t, npart, probit,      \
                          warps, stream)
  if (k <= 32) return REL_REFRESH_LAUNCH(1, 4);
  if (k <= 64) return REL_REFRESH_LAUNCH(2, 4);
  return REL_REFRESH_LAUNCH(4, 4);
#undef REL_REFRESH_LAUNCH
}
