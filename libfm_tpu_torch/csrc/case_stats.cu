// case_stats: case-major moment statistics of one conflict-free block,
// reconstructed into the GG rows that schur_draw reads.
//
// Replaces, in libfm_tpu/learners/mcmc_vector.py, sweep_block's
// case-major branch: stats_case_chunk (the per-case moment rows summed per
// dense feature with a one-hot MXU matmul) and the v-free reconstruction
// after it. Per feature j, over its cases (value x, A row [e | Q]):
//   one-hot (x == 1):  M = sum [ Q_i Q_j (i <= j) | Q | e Q | 1 | e ]
//   valued:            M = sum [ x^2 Q_i Q_j | x^2 Q | x^3 Q | x e Q |
//                                x^2 | x^3 | x^4 | x e | x^2 e ]
// then, with v the feature's PRE-draw factor row,
//   Qq = M2 - v S3 - S3 v + m4 v v,  qa = S2 - m3 v,  qe = SQe - m2e v,
//   aa = m2, ae = m x e  (qa, aa, ae zero without the linear term),
// the GG row [Qq (upper triangle) | qa | qe | aa | ae]. The reconstruction
// runs op by op in the plain version's order (no FMA contraction): M2 and
// m4 v v nearly cancel for a heavy feature, as they do in the JAX engine.
//
// The TPU reads A in case order and sums onto features with one one-hot
// matmul; here the same sums are a segmented reduction over the block's
// per-feature slot lists (sorted by case), which cover each case of the
// block once, so A is read once. Bound on the H100 at config #4 (CTR,
// 1.8M cases, k=16, 5,000 features a block): the A rows, 68 B a case
// (122 MB), against ~340 FMA a case: bytes, ~0.04 ms a block. One-hot
// blocks do not read slot_val.
//
// Design (fp32 FMA on the CUDA cores, no atomics on floats):
// - A staged row is u = [x Q (zero past k) | x, x^2, e, 0 | 1, x, x^2, e]
//   (KP + 8 floats, KP = k rounded up to 4, 8, 16, 32, 64 or 128), and
//   every moment is a sum of 4 x 4 outer products of two 16-byte pieces
//   of it: (x Q)_a (x Q)_b for the column blocks a <= b (the triangle),
//   [x, x^2, e, 0] (x Q)_b (x^2 Q, x^3 Q, x e Q) and [x, x^2, e, 0]
//   [1, x, x^2, e] (the scalars). An item is one such product: 16 FMA for
//   two 16-byte shared loads a slot, (nb + 1)(nb + 2) / 2 items at
//   nb = ceil(k / 4) (15 at k = 16).
// - A team (a warp at k <= 32; the CTA's 256 threads above, where a
//   thread's items would not fit a warp's registers) sums a run of one
//   feature's slots: its threads hold the items, split into G groups that
//   take every G-th staged row. Rows are gathered by 4-byte cp.async into
//   a ring of 32-row stages (3 at KP <= 16, else 2), the slots' (case, x)
//   read a stage ahead into registers; the team's first 32 threads then
//   write each row's weights (and scale a valued row's Q by x).
// - The launch plan (kernels/case_stats.py CaseStatsPlan, made once a
//   block) gives each CTA either up to 256 / team short features (a team
//   each, the longest first), or one piece of a long feature, whose
//   teams take consecutive parts of the piece. Long pieces come first,
//   features of many pieces first.
// - Sums: each stage's rows are summed plainly into a partial, and the
//   partials into the running sums with compensation (Kahan), in fp32:
//   the reconstruction cancels, so the moments must be summed about as
//   well as the JAX engine's one-hot products sum them (blocked, in chunks
//   of 8,192 cases). A piece adds its teams' sums, and a feature of
//   several pieces its pieces' (written to scratch; the last piece to
//   arrive, after an integer ticket and a fence, adds them with the whole
//   CTA), always in the same order and with compensation, so the result
//   does not depend on which CTA finishes last. The ticket is reset for
//   the next call.
// The pure linear model (k = 0) runs the KP = 4 instance: no column
// block, one item (the scalars), the moment row [m2 | m x e] (one-hot:
// the count and the sum of e) and the GG row [aa | ae].
// What the first version did (PERF.md, 3.229 ms for config #4's 13
// blocks): one CTA of 256 threads a piece of at most 2,048 slots, ~5,900
// CTAs a block, most of them for Zipf-tail features of a few slots; two
// 64-slot stages; 49 items of 4 products each at k = 16, one scalar and
// one 16-byte load for 4 FMA; the head feature's 158 pieces added by 64
// threads of its last CTA.

#include "common.cuh"

namespace {

using libfm::kWarp;
constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows a team stages at once
constexpr int kExtra = 8;  // floats after the KP factor columns of a staged row
// the extras of a staged row, at KP + these offsets: W = [x, x^2, e, 0],
// V = [1, x, x^2, e]
enum { kWx = 0, kWx2 = 1, kWe = 2, kWzero = 3, kVone = 4, kVx = 5, kVx2 = 6, kVe = 7 };

// Per padded width: the team's threads, its slot groups, the items a
// thread holds and the stages of its ring.
template <int KP>
struct Cfg;
// kCtas: the CTAs an SM is built to hold (registers).
template <>
struct Cfg<4> {
  static constexpr int kTeam = 32, kG = 8, kIPT = 1, kStages = 3, kCtas = 2;
};
template <>
struct Cfg<8> {
  static constexpr int kTeam = 32, kG = 4, kIPT = 1, kStages = 3, kCtas = 2;
};
template <>
struct Cfg<16> {
  static constexpr int kTeam = 32, kG = 2, kIPT = 1, kStages = 3, kCtas = 2;
};
template <>
struct Cfg<32> {
  static constexpr int kTeam = 32, kG = 1, kIPT = 2, kStages = 2, kCtas = 1;
};
template <>
struct Cfg<64> {
  static constexpr int kTeam = 256, kG = 1, kIPT = 1, kStages = 2, kCtas = 1;
};
template <>
struct Cfg<128> {
  static constexpr int kTeam = 256, kG = 1, kIPT = 3, kStages = 2, kCtas = 1;
};

__host__ __device__ inline int num_blocks4(int k) { return (k + 3) / 4; }

__host__ __device__ inline int num_items(int k) {
  const int nb = num_blocks4(k);
  return (nb + 1) * (nb + 2) / 2;
}

// Floats of a team's (or a piece's) sums: a 4 x 4 block an item.
__host__ __device__ inline int flat_floats(int k) { return 16 * num_items(k); }

__host__ __device__ inline int moment_width(int k, int onehot) {
  const int T = k * (k + 1) / 2;
  return onehot ? T + 2 * k + 2 : T + 3 * k + 5;
}

// A team's region of shared memory: its ring, reused for its moment row
// and v (a short feature) or its sums (a piece).
template <int KP>
__host__ __device__ inline int team_floats(int k, int onehot) {
  const int ring = Cfg<KP>::kStages * kRows * (KP + kExtra);
  const int mrow = libfm::round4(moment_width(k, onehot)) + KP;
  const int nf = flat_floats(k);
  const int m = ring > mrow ? ring : mrow;
  return m > nf ? m : nf;
}

// The CTA's dynamic shared memory: the teams' regions, then a piece's
// moment row and v.
template <int KP>
__host__ __device__ inline int cta_floats(int k, int onehot) {
  return kThreads / Cfg<KP>::kTeam * team_floats<KP>(k, onehot) +
         libfm::round4(moment_width(k, onehot)) + KP;
}

// Item it's column blocks: a <= b of the triangle, then the vectors
// (a = nb) and the scalars (a = b = nb + 1).
__device__ inline void item_blocks(int it, int k, int& a, int& b) {
  const int nb = num_blocks4(k);
  const int ntri = nb * (nb + 1) / 2;
  if (it < ntri) {
    a = 0;
    int rem = it;
    while (rem >= nb - a) {
      rem -= nb - a;
      ++a;
    }
    b = a + rem;
  } else if (it < ntri + nb) {
    a = nb;
    b = it - ntri;
  } else {
    a = b = nb + 1;
  }
}

// Item it's two 16-byte pieces of a staged row: W at wo, V at vo.
template <int KP>
__device__ inline void item_offsets(int it, int k, int& wo, int& vo) {
  int a, b;
  item_blocks(it, k, a, b);
  const int nb = num_blocks4(k);
  wo = a < nb ? 4 * a : KP;
  vo = a <= nb ? 4 * b : KP + 4;
}

// The place in the moment row (the JAX engine's layout) of entry (r, c)
// of item it's 4 x 4 sum W_r V_c; -1 where it is no moment.
__device__ inline int moment_index(int it, int r, int c, int k, int onehot) {
  int a, b;
  item_blocks(it, k, a, b);
  const int nb = num_blocks4(k);
  const int T = k * (k + 1) / 2;
  if (a < nb) {  // (x Q_i)(x Q_j)
    const int i = 4 * a + r, j = 4 * b + c;
    return i <= j && j < k ? libfm::tri_index(i, j, k) : -1;
  }
  if (a == nb) {  // [x, x^2, e] x Q_j: x^2 Q, x^3 Q, x e Q (one-hot: Q, Q, e Q)
    const int j = 4 * b + c;
    if (j >= k) return -1;
    if (onehot) return r == 0 ? T + j : r == 2 ? T + k + j : -1;
    return r < 3 ? T + r * k + j : -1;
  }
  // [x, x^2, e, 0] x [1, x, x^2, e]
  const int sc = onehot ? T + 2 * k : T + 3 * k;
  if (r == 0 && c == 1) return sc;  // x^2 (one-hot: the count)
  if (onehot) return r == 0 && c == 3 ? sc + 1 : -1;  // e
  if (r == 0 && c == 2) return sc + 1;  // x^3
  if (r == 1 && c == 2) return sc + 2;  // x^4
  if (r == 0 && c == 3) return sc + 3;  // x e
  if (r == 1 && c == 3) return sc + 4;  // x^2 e
  return -1;
}

// s (less the remainder c) += v, compensated
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

template <int TEAM>
__device__ __forceinline__ void team_sync() {
  if constexpr (TEAM == kWarp)
    __syncwarp();
  else
    __syncthreads();
}

// One team's sums over slots [lo, hi) of the block's lists, into acc
// (compensation folded in; with G > 1 the groups' sums added into group
// 0's threads in group order). ttid: the thread's place in the team.
template <int KP>
__device__ __forceinline__ void team_sum(float* ring, const float* __restrict__ A,
                                         const int* __restrict__ slot_case,
                                         const float* __restrict__ slot_val, long long lo,
                                         long long hi, int k, int onehot, long long num_rows,
                                         int ttid, float (&acc)[Cfg<KP>::kIPT][16]) {
  using C = Cfg<KP>;
  constexpr int TEAM = C::kTeam, G = C::kG, IPT = C::kIPT, NS = C::kStages;
  constexpr int GT = TEAM / G;  // threads a group
  constexpr int W = TEAM / kWarp, RW = kRows / W;  // warps; rows a warp gathers a stage
  constexpr int ROW = KP + kExtra, STAGE = kRows * ROW;
  static_assert(GT * IPT >= (KP / 4 + 1) * (KP / 4 + 2) / 2, "a team holds every item");
  static_assert(G == 1 || TEAM == kWarp, "groups are added by warp shuffles");
  const int g = ttid / GT, tig = ttid % GT;
  const int w = ttid / kWarp, lane = ttid % kWarp;
  const int d = k + 1;
  const int NI = num_items(k);
  const int nst = hi > lo ? (int)((hi - lo + kRows - 1) / kRows) : 0;

  // columns k..KP-1 of every staged row stay zero (a warp team writes
  // them with each stage)
  if constexpr (TEAM > kWarp)
    for (int idx = ttid; idx < NS * kRows; idx += TEAM)
      for (int c = k; c < KP; ++c) ring[idx * ROW + c] = 0.0f;

  int wo[IPT], vo[IPT];
  bool on[IPT];
#pragma unroll
  for (int m = 0; m < IPT; ++m) {
    const int it = tig + GT * m;
    on[m] = it < NI;
    wo[m] = vo[m] = 0;
    if (on[m]) item_offsets<KP>(it, k, wo[m], vo[m]);
  }
  float cmp[IPT][16];
#pragma unroll
  for (int m = 0; m < IPT; ++m)
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[m][q] = cmp[m][q] = 0.0f;

  // Warp w gathers rows w, w + W, ... of a stage; their (case, x) are read
  // a stage ahead, lane i holding row w + W i, so that no gather waits on
  // the read of its case. Padding rows (past hi, or case == num_rows)
  // land as zeros. A warp team copies 32 / KP rows' factor columns an
  // instruction (KP lanes a row, zeros past k), then every row's e.
  auto load_index = [&](int s, long long& c, float& x) {
    const long long pos = lo + (long long)s * kRows + w + W * lane;
    c = num_rows;
    x = 0.0f;
    if (s < nst && lane < RW && pos < hi) {
      c = slot_case[pos];
      x = onehot ? 1.0f : slot_val[pos];
    }
  };
  auto fetch = [&](int s, long long c_reg, float x_reg) {
    float* st = ring + (s % NS) * STAGE;
    if constexpr (TEAM == kWarp) {
      if (s < nst) {
        constexpr int RPI = kWarp / (KP < kWarp ? KP : kWarp);  // rows an instruction
        const int sub = lane / KP, col = lane % KP;
#pragma unroll 4
        for (int i = 0; i < kRows; i += RPI) {
          const long long c = __shfl_sync(libfm::kFullMask, c_reg, i + sub);
          const bool real = c < num_rows && col < k;
          libfm::cp_async4(st + (i + sub) * ROW + col, A + (real ? c * d + 1 + col : 0),
                           real ? 4 : 0);
        }
        const bool real = c_reg < num_rows;
        float* row = st + lane * ROW;
        libfm::cp_async4(row + KP + kWe, A + (real ? c_reg * d : 0), real ? 4 : 0);
        row[KP + kWx] = real ? x_reg : 0.0f;
      }
    } else if (s < nst) {
      for (int i = 0; i < RW; ++i) {
        const long long c = __shfl_sync(libfm::kFullMask, c_reg, i);
        const float x = __shfl_sync(libfm::kFullMask, x_reg, i);
        const bool real = c < num_rows;
        const float* src = A + (real ? c : 0) * d;
        float* row = st + (w + W * i) * ROW;
        for (int e = lane; e < d; e += kWarp)
          libfm::cp_async4(e == 0 ? row + KP + kWe : row + e - 1, src + e, real ? 4 : 0);
        if (lane == 0) row[KP + kWx] = real ? x : 0.0f;
      }
    }
    libfm::cp_async_commit();
  };

  long long c_next;
  float x_next;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    load_index(s, c_next, x_next);
    fetch(s, c_next, x_next);
  }
  load_index(NS - 1, c_next, x_next);
  for (int s = 0; s < nst; ++s) {
    fetch(s + NS - 1, c_next, x_next);
    load_index(s + NS, c_next, x_next);
    libfm::cp_async_wait<NS - 1>();
    team_sync<TEAM>();
    float* st = ring + (s % NS) * STAGE;
    if (ttid < kRows) {  // row ttid's weights; a valued row's Q scaled by x
      float* row = st + ttid * ROW;
      const float x = row[KP + kWx], e = row[KP + kWe];
      const float x2 = x * x;
      if (!onehot)
        for (int c = 0; c < k; ++c) row[c] *= x;
      row[KP + kWx2] = x2;
      row[KP + kWzero] = 0.0f;
      row[KP + kVone] = 1.0f;
      row[KP + kVx] = x;
      row[KP + kVx2] = x2;
      row[KP + kVe] = e;
    }
    team_sync<TEAM>();
    const int n = (int)min((long long)kRows, hi - lo - (long long)s * kRows);
    float part[IPT][16];
#pragma unroll
    for (int m = 0; m < IPT; ++m)
#pragma unroll
      for (int q = 0; q < 16; ++q) part[m][q] = 0.0f;
    for (int r = g; r < n; r += G) {
      const float* row = st + r * ROW;
#pragma unroll
      for (int m = 0; m < IPT; ++m) {
        if (!on[m]) continue;
        const float4 a = *reinterpret_cast<const float4*>(row + wo[m]);
        const float4 b = *reinterpret_cast<const float4*>(row + vo[m]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[m][4 * i + j] = fmaf(av[i], bv[j], part[m][4 * i + j]);
      }
    }
#pragma unroll
    for (int m = 0; m < IPT; ++m)
#pragma unroll
      for (int q = 0; q < 16; ++q) kahan_add(acc[m][q], cmp[m][q], part[m][q]);
    team_sync<TEAM>();  // the stage is refilled by the next iteration's fetch
  }
  libfm::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < IPT; ++m)
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float own = __fsub_rn(acc[m][q], cmp[m][q]);
      float v = own;
      if constexpr (G > 1) {  // the groups of a warp, added in group order
        float r = 0.0f;
        for (int h = 1; h < G; ++h)
          kahan_add(v, r, __shfl_sync(libfm::kFullMask, own, (tig + GT * h) % kWarp));
        v = __fsub_rn(v, r);
      }
      acc[m][q] = v;
    }
}

// GG row `out` from the moment row M and v (shared memory), by threads
// t0, t0 + nt, ...
__device__ __forceinline__ void reconstruct(const float* M, const float* vs, float* out,
                                            int k, int onehot, int use_linear, int t0,
                                            int nt) {
  const int T = k * (k + 1) / 2;
  const float* S2 = M + T;
  const float* S3 = onehot ? S2 : M + T + k;
  const float* SQe = onehot ? M + T + k : M + T + 2 * k;
  const int sc = onehot ? T + 2 * k : T + 3 * k;
  const float m2 = M[sc];
  const float m3 = onehot ? m2 : M[sc + 1];
  const float m4 = onehot ? m2 : M[sc + 2];
  const float mxe = onehot ? M[sc + 1] : M[sc + 3];
  const float m2e = onehot ? mxe : M[sc + 4];
  const int GW = libfm::gg_width(k);
  for (int c = t0; c < GW; c += nt) {
    float r;
    if (c < T) {
      // (i, j) of packed position c
      int i = (int)((2.0f * k + 1.0f - sqrtf((2.0f * k + 1.0f) * (2.0f * k + 1.0f) - 8.0f * c)) *
                    0.5f);
      i = max(0, min(i, k - 1));
      while (i > 0 && libfm::tri_index(i, i, k) > c) --i;
      while (i + 1 < k && libfm::tri_index(i + 1, i + 1, k) <= c) ++i;
      const int j = i + (c - libfm::tri_index(i, i, k));
      const float vi = vs[i], vj = vs[j];
      r = __fadd_rn(__fsub_rn(__fsub_rn(M[c], __fmul_rn(vi, S3[j])), __fmul_rn(S3[i], vj)),
                    __fmul_rn(m4, __fmul_rn(vi, vj)));
    } else if (c < T + k) {
      const int i = c - T;
      r = use_linear ? __fsub_rn(S2[i], __fmul_rn(m3, vs[i])) : 0.0f;
    } else if (c < T + 2 * k) {
      const int i = c - T - k;
      r = __fsub_rn(SQe[i], __fmul_rn(m2e, vs[i]));
    } else if (c == T + 2 * k) {
      r = use_linear ? m2 : 0.0f;
    } else {
      r = use_linear ? mxe : 0.0f;
    }
    out[c] = r;
  }
}

template <int KP>
__global__ void __launch_bounds__(kThreads, Cfg<KP>::kCtas)
    case_stats_kernel(const float* __restrict__ A, const float* __restrict__ P,
                      const long long* __restrict__ feat_off,
                      const int* __restrict__ slot_case, const float* __restrict__ slot_val,
                      const int* __restrict__ feat_id, const int4* __restrict__ cta,
                      const int* __restrict__ short_feats, float* __restrict__ scratch,
                      int* __restrict__ ticket, float* __restrict__ GG, int piece_len, int k,
                      int onehot, int use_linear, long long num_rows) {
  using C = Cfg<KP>;
  constexpr int TEAM = C::kTeam, TEAMS = kThreads / TEAM, IPT = C::kIPT;
  constexpr int GT = TEAM / C::kG;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int tm = tid / TEAM, ttid = tid % TEAM;
  const int tig = ttid % GT;
  const bool lead = ttid < GT;  // group 0: holds the team's sums
  const int d = k + 1;
  const int NI = num_items(k), NF = flat_floats(k);
  const int MW = moment_width(k, onehot);
  const int TF = team_floats<KP>(k, onehot);
  float* region = smem + tm * TF;
  const int GW = libfm::gg_width(k);
  float acc[IPT][16];

  const int4 desc = cta[blockIdx.x];
  if (desc.x < 0) {
    // up to TEAMS short features, one a team: the team sums it and writes
    // its GG row
    if (tm >= desc.y) return;
    const int f = short_feats[-1 - desc.x + tm];
    team_sum<KP>(region, A, slot_case, slot_val, feat_off[f], feat_off[f + 1], k, onehot,
                 num_rows, ttid, acc);
    team_sync<TEAM>();
    float* M = region;
    float* vs = region + libfm::round4(MW);
    if (lead) {
#pragma unroll
      for (int m = 0; m < IPT; ++m) {
        const int it = tig + GT * m;
        if (it >= NI) continue;
        for (int q = 0; q < 16; ++q) {
          const int at = moment_index(it, q / 4, q % 4, k, onehot);
          if (at >= 0) M[at] = acc[m][q];
        }
      }
    }
    const long long fid = feat_id[f];
    for (int i = ttid; i < k; i += TEAM) vs[i] = P[fid * d + 1 + i];
    team_sync<TEAM>();
    reconstruct(M, vs, GG + (long long)f * GW, k, onehot, use_linear, ttid, TEAM);
    return;
  }

  // a piece of a long feature: the teams take consecutive parts of it
  const int f = desc.x, rank = desc.y, base = desc.z, npieces = desc.w;
  const long long flo = feat_off[f] + (long long)rank * piece_len;
  const long long fhi = min(flo + (long long)piece_len, feat_off[f + 1]);
  const long long part = (fhi - flo + TEAMS - 1) / TEAMS;
  const long long lo = min(flo + tm * part, fhi);
  team_sum<KP>(region, A, slot_case, slot_val, lo, min(lo + part, fhi), k, onehot, num_rows,
               ttid, acc);
  team_sync<TEAM>();
  if (lead) {
#pragma unroll
    for (int m = 0; m < IPT; ++m) {
      const int it = tig + GT * m;
      if (it >= NI) continue;
#pragma unroll
      for (int q = 0; q < 16; ++q) region[it * 16 + q] = acc[m][q];
    }
  }
  __syncthreads();

  // the piece's sums: its teams' in team order
  float* M = smem + TEAMS * TF;
  float* vs = M + libfm::round4(MW);
  auto piece_sum = [&](int i) {
    float v = 0.0f, r = 0.0f;
    for (int t = 0; t < TEAMS; ++t) kahan_add(v, r, smem[t * TF + i]);
    return __fsub_rn(v, r);
  };
  if (npieces > 1) {
    // publish them; the last piece to arrive adds every piece's, in piece order
    float* mine = scratch + (long long)(base + rank) * NF;
    for (int i = tid; i < NF; i += kThreads) mine[i] = piece_sum(i);
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(ticket + f, 1) == npieces - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int i = tid; i < NF; i += kThreads) {
      const int at = moment_index(i / 16, (i % 16) / 4, i % 4, k, onehot);
      if (at < 0) continue;
      const float* src = scratch + (long long)base * NF + i;
      float v = 0.0f, r = 0.0f;
#pragma unroll 8
      for (int q = 0; q < npieces; ++q) kahan_add(v, r, __ldcg(src + (long long)q * NF));
      M[at] = __fsub_rn(v, r);
    }
    if (tid == 0) ticket[f] = 0;  // every piece has arrived: ready for the next call
  } else {
    for (int i = tid; i < NF; i += kThreads) {
      const int at = moment_index(i / 16, (i % 16) / 4, i % 4, k, onehot);
      if (at >= 0) M[at] = piece_sum(i);
    }
  }
  const long long fid = feat_id[f];
  for (int i = tid; i < k; i += kThreads) vs[i] = P[fid * d + 1 + i];
  __syncthreads();
  reconstruct(M, vs, GG + (long long)f * GW, k, onehot, use_linear, tid, kThreads);
}

template <int KP>
int launch(const float* A, const float* P, const long long* feat_off, const int* slot_case,
           const float* slot_val, const int* feat_id, const int4* cta, const int* short_feats,
           float* scratch, int* ticket, float* GG, int ncta, int piece_len, int k, int onehot,
           int use_linear, long long num_rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)cta_floats<KP>(k, onehot);
  auto kern = case_stats_kernel<KP>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<ncta, kThreads, smem, stream>>>(A, P, feat_off, slot_case, slot_val, feat_id, cta,
                                         short_feats, scratch, ticket, GG, piece_len, k, onehot,
                                         use_linear, num_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// GG [Fd, T+2k+2] written row by row. feat_off [Fd+1] (int64) cuts
// slot_case/slot_val into per-feature slot lists; feat_id [Fd] is each
// feature's row in P = [w | V]. The launch plan (kernels/case_stats.py
// CaseStatsPlan) lists the CTAs, cta [ncta] (int4, 16-byte aligned):
// (-1 - s, n, 0, 0) takes the n short features short_feats[s .. s+n), a
// team each; (f, rank, base, npieces) takes slots [rank * piece_len,
// (rank + 1) * piece_len) of feature f's list, whose npieces pieces (if
// several) write their sums to scratch rows base .. base + npieces of
// 16 * num_items(k) floats. ticket [Fd] must be zero and is left zero.
// onehot: every slot value is 1 (the moment row drops x's powers, and
// slot_val is not read).
extern "C" int case_stats_launch(const float* A, const float* P, const long long* feat_off,
                                 const int* slot_case, const float* slot_val,
                                 const int* feat_id, const int* cta, const int* short_feats,
                                 float* scratch, int* ticket, float* GG, int ncta,
                                 int piece_len, int k, int onehot, int use_linear,
                                 long long num_rows, cudaStream_t stream) {
  if (k < 0 || k > libfm::kMaxK || piece_len < 1 || ncta < 0 ||
      (reinterpret_cast<uintptr_t>(cta) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (ncta == 0) return (int)cudaSuccess;
#define CASE_STATS_LAUNCH(KP)                                                                 \
  launch<KP>(A, P, feat_off, slot_case, slot_val, feat_id, reinterpret_cast<const int4*>(cta), \
             short_feats, scratch, ticket, GG, ncta, piece_len, k, onehot, use_linear,         \
             num_rows, stream)
  if (k <= 4) return CASE_STATS_LAUNCH(4);
  if (k <= 8) return CASE_STATS_LAUNCH(8);
  if (k <= 16) return CASE_STATS_LAUNCH(16);
  if (k <= 32) return CASE_STATS_LAUNCH(32);
  if (k <= 64) return CASE_STATS_LAUNCH(64);
  return CASE_STATS_LAUNCH(128);
#undef CASE_STATS_LAUNCH
}
