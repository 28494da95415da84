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
// (122 MB), against ~200 FMA a case: bytes, ~0.04 ms a block. One-hot
// blocks do not read slot_val.
//
// Design (fp32 FMA on the CUDA cores, no atomics on floats):
// - Pieces: a feature's slot list is cut into pieces of at most
//   `piece_len` slots, one CTA a piece, so the Zipf head of a field (a
//   fifth of the block's cases in one feature) spreads over many CTAs.
//   The host orders the pieces so that features of many pieces start
//   first (their last piece also adds the others: the longest chain).
//   A piece of a feature with several writes its partial row to its
//   scratch row (only such features have rows); the last of them to
//   arrive (an integer ticket after a fence) adds all the feature's
//   partials in piece order, so the result does not depend on which CTA
//   finishes last, and resets the ticket for the next call
//   (kernels/pieces.py makes the cut, the ticket and the scratch once a
//   block).
// - Staging: tiles of 64 slots (32 above k = 32), two stages, A rows
//   gathered by 4-byte cp.async into rows of KP + 8 floats [Q (zero past
//   k) | x^2, x e, x^3, x^4, x^2 e, e, x, 1]; padding slots (case ==
//   num_rows) land as zeros. The slots' (case, x) are read a tile ahead
//   of their gathers, into registers.
// - Work items: an item is 4 adjacent columns of the moment row, taken
//   with one 16-byte shared load a slot: Q_j0..j0+3 weighted by x^2 Q_i
//   (the triangle), by x^2, x^3 or x e (the vectors), or the scalar
//   extras. The tile's slots are split over G groups of threads (G = 8,
//   4, 2 or 1 by the count of items); group 0 adds the groups' partials
//   in group order.
// - Sums: each tile's slots are summed plainly into a partial, and the
//   partials into the running sums with compensation (Kahan), in fp32:
//   the reconstruction cancels, so the moments must be summed about as
//   well as the JAX engine's one-hot products sum them (blocked, in chunks
//   of 8,192 cases). A plain running sum over a feature's few thousand
//   cases, as the first plain version took it, erred by 2.3e-4 of a
//   column's largest value against float64 on a valued CTR block (the
//   chunked product: 5e-6).

#include "common.cuh"

namespace {

using libfm::kWarp;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kStages = 2;  // tile t+1 in flight while tile t is summed
constexpr int kExtra = 8;   // floats after the KP factor columns of a staged row
// the extras of a staged row, at KP + these offsets
enum { kX2 = 0, kXE = 1, kX3 = 2, kX4 = 3, kX2E = 4, kE = 5, kX = 6, kOne = 7 };

__host__ __device__ inline int num_blocks4(int k) { return (k + 3) / 4; }

// Items of the triangle: row i takes column groups j0 = 4 (i/4), ..., 4 (nb-1).
__host__ __device__ inline int num_tri_items(int k) {
  const int nb = num_blocks4(k);
  int n = 0;
  for (int i = 0; i < k; ++i) n += nb - i / 4;
  return n;
}

__host__ __device__ inline int num_vectors(int onehot) { return onehot ? 2 : 3; }

__host__ __device__ inline int num_items(int k, int onehot) {
  return num_tri_items(k) + num_vectors(onehot) * num_blocks4(k) + (onehot ? 1 : 2);
}

__host__ __device__ inline int moment_width(int k, int onehot) {
  const int T = k * (k + 1) / 2;
  return onehot ? T + 2 * k + 2 : T + 3 * k + 5;
}

struct Item {
  int kind;  // 0 triangle, 1 vector, 2 scalars, -1 none
  int a;     // kind 0: row i; kind 1: vector v; kind 2: window
  int wa, wb, base;  // weight row[wa] * row[wb], columns row[base .. base+3]
};

template <int KP>
__device__ Item decode(int it, int k, int onehot) {
  Item m{-1, 0, KP + kOne, KP + kOne, KP};
  const int nb = num_blocks4(k);
  const int ntri = num_tri_items(k);
  const int nvec = num_vectors(onehot) * nb;
  if (it < ntri) {
    int i = 0, rem = it;
    while (rem >= nb - i / 4) {
      rem -= nb - i / 4;
      ++i;
    }
    m.kind = 0;
    m.a = i;
    m.wa = KP + kX2;
    m.wb = i;
    m.base = 4 * (i / 4 + rem);
  } else if (it < ntri + nvec) {
    const int v = (it - ntri) / nb;
    m.kind = 1;
    m.a = v;
    m.base = 4 * ((it - ntri) % nb);
    // one-hot vectors: Q (x^2 == 1) and e Q (x e == e); valued: x^2 Q, x^3 Q, x e Q
    m.wa = KP + (v == 0 ? kX2 : (onehot || v == 2) ? kXE : kX3);
  } else if (it < ntri + nvec + (onehot ? 1 : 2)) {
    m.kind = 2;
    m.a = it - ntri - nvec;
    m.base = KP + 4 * m.a;  // [x^2, x e, x^3, x^4] or [x^2 e, ...]
  }
  return m;
}

// s (less the remainder c) += v, compensated
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

template <int KP>
struct Cfg {
  static constexpr int kTile = KP <= 32 ? 64 : 32;  // slots a stage
  static constexpr int kRowsPerWarp = kTile / kWarps;  // rows a warp gathers a tile
  static constexpr int kRow = KP + kExtra;
  static constexpr int kStage = kTile * kRow;
};

// Dynamic shared memory in floats: the stage ring, reused after the last
// tile for the groups' partials and then for the moment row and v.
template <int KP>
__host__ inline int smem_floats(int k, int onehot, int G) {
  const int ring = kStages * Cfg<KP>::kStage;  // room for the partials too
  const int red = G > 1 ? G * num_items(k, onehot) * 4 : 0;
  const int mom = libfm::round4(moment_width(k, onehot)) + KP;
  int m = ring > red ? ring : red;
  return m > mom ? m : mom;
}

template <int KP, int IPT, int G>
__global__ void __launch_bounds__(kThreads)
    case_stats_kernel(const float* __restrict__ A, const float* __restrict__ P,
                      const long long* __restrict__ feat_off,
                      const int* __restrict__ slot_case, const float* __restrict__ slot_val,
                      const int* __restrict__ feat_id, const int4* __restrict__ order,
                      float* __restrict__ scratch, int* __restrict__ ticket,
                      float* __restrict__ GG, int piece_len, int k, int onehot,
                      int use_linear, long long num_rows) {
  using C = Cfg<KP>;
  constexpr int GT = kThreads / G;  // threads a group
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int g = tid / GT, tig = tid % GT;
  const int d = k + 1;
  const int NI = num_items(k, onehot);

  // this CTA's piece: (feature, rank within the feature, the feature's
  // first scratch row, its pieces), launched in the host's order
  // (features of many pieces first: they finish last)
  const int4 fr = order[blockIdx.x];
  const int f = fr.x;
  const int p0 = fr.z;
  const int piece = p0 + fr.y;  // its row of scratch
  const int npieces = fr.w;
  const long long flo = feat_off[f], fhi = feat_off[f + 1];
  const long long lo = flo + (long long)fr.y * piece_len;
  const long long hi = min(lo + (long long)piece_len, fhi);
  constexpr int kTile = C::kTile;
  const int ntiles = hi > lo ? (int)((hi - lo + kTile - 1) / kTile) : 0;

  // every staged row: zero factor columns past k, zero extras, the 1
  for (int idx = tid; idx < kStages * kTile; idx += kThreads) {
    float* row = smem + idx * C::kRow;
    for (int c = k; c < KP; ++c) row[c] = 0.0f;
    for (int c = 0; c < kExtra; ++c) row[KP + c] = c == kOne ? 1.0f : 0.0f;
  }
  __syncthreads();

  // Warp w gathers slots w, w + 8, w + 16, ... of a tile: e, Q and x.
  // Their (case, x) are read a tile ahead, lane i holding row w + 8 i, so
  // that no gather waits on the read of its case.
  auto load_index = [&](int t, long long& c, float& x) {
    const long long pos = lo + (long long)t * kTile + warp + kWarps * lane;
    c = num_rows;
    x = 0.0f;
    if (t < ntiles && lane < C::kRowsPerWarp && pos < hi) {
      c = slot_case[pos];
      x = onehot ? 1.0f : slot_val[pos];
    }
  };
  auto fetch = [&](int t, long long c_reg, float x_reg) {
    float* st = smem + (t % kStages) * C::kStage;
#pragma unroll
    for (int r = 0; r < C::kRowsPerWarp; ++r) {
      const int s = warp + kWarps * r;
      const long long c = __shfl_sync(libfm::kFullMask, c_reg, r);
      const float x = __shfl_sync(libfm::kFullMask, x_reg, r);
      const bool real = c < num_rows;
      const float* src = A + (real ? c : 0) * d;
      float* row = st + s * C::kRow;
      for (int e = lane; e < d; e += kWarp)
        libfm::cp_async4(e == 0 ? row + KP + kE : row + e - 1, src + e, real ? 4 : 0);
      if (lane == 0) row[KP + kX] = real ? x : 0.0f;
    }
    libfm::cp_async_commit();
  };

  Item item[IPT];
#pragma unroll
  for (int m = 0; m < IPT; ++m) item[m] = decode<KP>(tig + GT * m, k, onehot);
  float acc[IPT][4], cmp[IPT][4];  // compensated sums: acc - cmp
#pragma unroll
  for (int m = 0; m < IPT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = cmp[m][c] = 0.0f;

  long long c_next;
  float x_next;
  load_index(0, c_next, x_next);
  if (ntiles > 0) fetch(0, c_next, x_next);
  load_index(1, c_next, x_next);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      fetch(t + 1, c_next, x_next);
      load_index(t + 2, c_next, x_next);
      libfm::cp_async_wait<1>();
    } else {
      libfm::cp_async_wait<0>();
    }
    __syncthreads();
    float* st = smem + (t % kStages) * C::kStage;
    const int n = (int)min((long long)kTile, hi - lo - (long long)t * kTile);
    if (tid < kTile) {  // the weights of slot tid
      float* row = st + tid * C::kRow;
      const float x = row[KP + kX], e = row[KP + kE];
      const float x2 = x * x;
      row[KP + kX2] = x2;
      row[KP + kXE] = x * e;
      row[KP + kX3] = x2 * x;
      row[KP + kX4] = x2 * x2;
      row[KP + kX2E] = x2 * e;
    }
    __syncthreads();
    // the tile's partial sums (at most kTile / G slots each), then added
    // into the running sums with compensation
    float part[IPT][4];
#pragma unroll
    for (int m = 0; m < IPT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[m][c] = 0.0f;
    for (int s = g; s < n; s += G) {
      const float* row = st + s * C::kRow;
#pragma unroll
      for (int m = 0; m < IPT; ++m) {
        if (item[m].kind < 0) continue;
        const float w = row[item[m].wa] * row[item[m].wb];
        const float4 q = *reinterpret_cast<const float4*>(row + item[m].base);
        part[m][0] += w * q.x;
        part[m][1] += w * q.y;
        part[m][2] += w * q.z;
        part[m][3] += w * q.w;
      }
    }
#pragma unroll
    for (int m = 0; m < IPT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) kahan_add(acc[m][c], cmp[m][c], part[m][c]);
    __syncthreads();  // the stage is refilled by the next iteration's fetch
  }

  // each sum with its remainder folded in; then the groups' partials,
  // added by group 0 in group order
#pragma unroll
  for (int m = 0; m < IPT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[m][c] = __fsub_rn(acc[m][c], cmp[m][c]);
      cmp[m][c] = 0.0f;
    }
  if (G > 1) {
#pragma unroll
    for (int m = 0; m < IPT; ++m) {
      const int it = tig + GT * m;
      if (it < NI)
        for (int c = 0; c < 4; ++c) smem[(g * NI + it) * 4 + c] = acc[m][c];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int m = 0; m < IPT; ++m) {
        const int it = tig + GT * m;
        if (it < NI)
          for (int c = 0; c < 4; ++c) {
            float v = smem[it * 4 + c], r = 0.0f;
            for (int h = 1; h < G; ++h) kahan_add(v, r, smem[(h * NI + it) * 4 + c]);
            acc[m][c] = __fsub_rn(v, r);
          }
      }
    }
    __syncthreads();
  }

  if (npieces > 1) {
    // publish this piece's row; the last piece to arrive adds them all
    if (g == 0) {
#pragma unroll
      for (int m = 0; m < IPT; ++m) {
        const int it = tig + GT * m;
        if (it < NI)
          *reinterpret_cast<float4*>(scratch + ((long long)piece * NI + it) * 4) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(ticket + f, 1) == npieces - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (g == 0) {
#pragma unroll
      for (int m = 0; m < IPT; ++m) {
        const int it = tig + GT * m;
        if (it < NI) {
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f}, r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int q = 0; q < npieces; ++q) {
            const float4 u = __ldcg(
                reinterpret_cast<const float4*>(scratch + ((long long)(p0 + q) * NI + it) * 4));
            kahan_add(v[0], r[0], u.x);
            kahan_add(v[1], r[1], u.y);
            kahan_add(v[2], r[2], u.z);
            kahan_add(v[3], r[3], u.w);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = __fsub_rn(v[c], r[c]);
        }
      }
    }
    if (tid == 0) ticket[f] = 0;  // every piece has arrived: ready for the next call
  }

  // the moment row in the JAX engine's layout, then v
  const int T = k * (k + 1) / 2;
  float* M = smem;
  float* vs = smem + libfm::round4(moment_width(k, onehot));
  if (g == 0) {
#pragma unroll
    for (int m = 0; m < IPT; ++m) {
      const Item& I = item[m];
      if (I.kind == 0) {
        for (int c = 0; c < 4; ++c) {
          const int j = I.base + c;
          if (j >= I.a && j < k) M[libfm::tri_index(I.a, j, k)] = acc[m][c];
        }
      } else if (I.kind == 1) {
        for (int c = 0; c < 4; ++c) {
          const int j = I.base + c;
          if (j < k) M[T + I.a * k + j] = acc[m][c];
        }
      } else if (I.kind == 2) {
        if (onehot) {  // [x^2, x e] = [1, e]
          M[T + 2 * k] = acc[m][0];
          M[T + 2 * k + 1] = acc[m][1];
        } else if (I.a == 0) {  // [x^2, x e, x^3, x^4] -> x^2, x^3, x^4, x e
          M[T + 3 * k] = acc[m][0];
          M[T + 3 * k + 1] = acc[m][2];
          M[T + 3 * k + 2] = acc[m][3];
          M[T + 3 * k + 3] = acc[m][1];
        } else {
          M[T + 3 * k + 4] = acc[m][0];
        }
      }
    }
  }
  const long long fid = feat_id[f];
  for (int i = tid; i < k; i += kThreads) vs[i] = P[fid * d + 1 + i];
  __syncthreads();

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
  float* out = GG + (long long)f * GW;
  for (int c = tid; c < GW; c += kThreads) {
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

template <int KP, int IPT, int G>
int launch(const float* A, const float* P, const long long* feat_off, const int* slot_case,
           const float* slot_val, const int* feat_id, const int4* order, float* scratch,
           int* ticket, float* GG, int npieces, int piece_len, int k, int onehot,
           int use_linear, long long num_rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats<KP>(k, onehot, G);
  auto kern = case_stats_kernel<KP, IPT, G>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<npieces, kThreads, smem, stream>>>(A, P, feat_off, slot_case, slot_val, feat_id,
                                            order, scratch, ticket, GG, piece_len, k, onehot,
                                            use_linear, num_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// GG [Fd, T+2k+2] written row by row, one CTA a piece. feat_off [Fd+1]
// (int64) cuts slot_case/slot_val into per-feature slot lists; feat_id
// [Fd] is each feature's row in P = [w | V]; order [npieces] (int4,
// kernels/pieces.py) lists every piece once as (feature, rank within the
// feature, the feature's first scratch row, the feature's pieces: feature
// f has ceil(count/piece_len), at least one), in the order the CTAs take
// them. ticket [Fd] must be zero and is left zero; scratch holds 4 *
// num_items(k, onehot) floats (kernels.case_stats.scratch_floats) for
// each piece of a feature of several, 16-byte aligned.
// onehot: every slot value is 1 (the moment row drops x's powers, and
// slot_val is not read).
extern "C" int case_stats_launch(const float* A, const float* P, const long long* feat_off,
                                 const int* slot_case, const float* slot_val,
                                 const int* feat_id, const int* order, float* scratch,
                                 int* ticket, float* GG,
                                 int Fd, int npieces, int piece_len,
                                 int k, int onehot, int use_linear, long long num_rows,
                                 cudaStream_t stream) {
  if (k < 1 || k > libfm::kMaxK || piece_len < 1 || npieces < Fd ||
      ((reinterpret_cast<uintptr_t>(scratch) | reinterpret_cast<uintptr_t>(order)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (Fd == 0) return (int)cudaSuccess;
  const int NI = num_items(k, onehot);
#define CASE_STATS_LAUNCH(KP, IPT, G)                                                     \
  launch<KP, IPT, G>(A, P, feat_off, slot_case, slot_val, feat_id,                        \
                     reinterpret_cast<const int4*>(order), scratch, ticket, GG, npieces,    \
                     piece_len, k, onehot, use_linear, num_rows, stream)
  if (k <= 8) return CASE_STATS_LAUNCH(8, 1, 8);
  if (k <= 16) return NI <= 32 ? CASE_STATS_LAUNCH(16, 1, 8) : CASE_STATS_LAUNCH(16, 1, 4);
  if (k <= 32) {
    if (NI <= 64) return CASE_STATS_LAUNCH(32, 1, 4);
    if (NI <= 128) return CASE_STATS_LAUNCH(32, 1, 2);
    return CASE_STATS_LAUNCH(32, 1, 1);
  }
  if (k <= 64) {
    if (NI <= 256) return CASE_STATS_LAUNCH(64, 1, 1);
    if (NI <= 512) return CASE_STATS_LAUNCH(64, 2, 1);
    return CASE_STATS_LAUNCH(64, 3, 1);
  }
  if (NI <= 768) return CASE_STATS_LAUNCH(128, 3, 1);
  if (NI <= 1280) return CASE_STATS_LAUNCH(128, 5, 1);
  return CASE_STATS_LAUNCH(128, 9, 1);
#undef CASE_STATS_LAUNCH
}
