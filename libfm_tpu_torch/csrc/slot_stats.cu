// slot_stats: per-feature moment statistics of one conflict-free block.
//
// Replaces, in libfm_tpu/learners/mcmc_vector.py, sweep_block._slot_hM and
// stats_chunk (the slot path): for every feature j of the block, over its
// slots (case c, value x),
//   a = x (0 when the linear term is off),  qp = A[c, 1:] - x v_j,
//   hq = x qp,  e = A[c, 0],
// and one GG row per feature
//   [ sum hq hq^T (upper triangle, np.triu_indices(k) order) |
//     sum hq a | sum hq e | sum a^2 | sum a e ].
// The JAX engine gathers [C, W, k+1] slot rows and runs batched MXU
// einsums per chunk; here one CTA owns one piece of a feature's ragged
// slot list (at most piece_len slots: kernels/pieces.py cuts the lists
// once a block), and a feature of one piece has its GG row written once,
// by one CTA. The pieces of a longer list each write a partial row to
// scratch; the last of them to arrive (an integer ticket after a fence)
// adds the partials in piece order and writes the row, so the result is
// deterministic, with no float atomics, and a skewed list (the Zipf head
// of a CTR field, 321K slots at config #4) no longer waits on one CTA.
// Slots with case == num_rows are padding and add nothing.
//
// Bound on the H100 at ML-10M (k=64, 18M slots an iteration): the A-row
// gathers, (k+1)*4 B a slot, plus the GG rows (0.73 GB): 5.6 GB = 1.66 ms,
// against ~2.2K FMA a slot, 83 GFLOP = 1.24 ms at 67 TFLOP/s. The two are
// close, so the gathers have to stream while the FMA pipes stay busy.
//
// Design (Hopper, fp32 FMA on the CUDA cores):
// - The width is a template parameter KP in {16, 32, 64, 128}, k <= KP;
//   hq rows are KP floats in shared memory, the pad columns zero. The
//   pure linear model (k = 0) runs at KP = 16: every column is padding,
//   each slot's row gather brings e alone, and the GG row is [aa | ae].
// - The row gathers are pipelined with cp.async: two stages of 32 slots,
//   tile t+1 in flight while tile t is consumed (a third stage measured
//   no faster). Each warp gathers whole slot rows (4-byte pieces: a row is
//   260 B at k=64, 4-byte aligned); a padding slot is zero-filled
//   (src-size 0). Once a tile has landed, each thread applies
//   hq = x (q - x v) in place to the elements it copied itself, so one
//   barrier publishes the tile. The slots' cases and values are read one
//   tile further ahead, into registers, so a gather never waits on the
//   read of its case.
// - 8x8 register blocks: a thread owns one 8x8 block of the Gram's upper
//   triangle and reads 16 floats (four 16-byte loads) for 64 FMAs a slot
//   (the 4x4 blocks before read 8 for 16). One more thread per 8-row
//   block owns qa and qe of those rows, and the first of them aa and ae;
//   these threads sit in warps of their own but for one warp at the seam.
// - The tile's slots are split over kGroups thread groups (slot s to group
//   s mod kGroups; 3 at k=64, 160 threads, so an SM keeps 3-4 CTAs); at
//   the end group 0 adds the other groups' partials in group order, and
//   the CTA writes the row from shared memory, coalesced.

#include "common.cuh"

namespace {

using libfm::kWarp;
using libfm::round4;
constexpr int kTile = 32;  // slots per pipeline stage
constexpr int kStages = 2;  // tile t+1 in flight while tile t is consumed
constexpr int kBlk = 8;  // Gram register block edge

template <int KP>
struct Cfg {
  static constexpr int kNb = KP / kBlk;              // 8-row blocks
  static constexpr int kGram = kNb * (kNb + 1) / 2;  // upper 8x8 blocks
  static constexpr int kGroups = KP <= 32 ? 8 : KP == 64 ? 3 : 2;
  // threads [0, kGroups kGram) own Gram blocks, the next kGroups kNb the
  // qa/qe of one row block each: the two roles sit in separate warps but
  // for one warp at the seam
  static constexpr int kGramThreads = kGroups * kGram;
  static constexpr int kRoles = kGramThreads + kGroups * kNb;
  static constexpr int kThreads = (kRoles + kWarp - 1) / kWarp * kWarp;
  static constexpr int kMinBlocks = KP <= 64 ? 4 : 1;  // CTAs an SM keeps resident
  static constexpr int kWarps = kThreads / kWarp;
  static constexpr int kPerWarp = (kTile + kWarps - 1) / kWarps;  // slots a warp gathers
  static constexpr int kRowSteps = (KP + kWarp) / kWarp;  // lane steps over a row of k+1
  // an hq row: KP floats and 16 B more, so that the rows of one stage
  // start in different banks
  static constexpr int kRow = KP + 4;
  static constexpr int kStageFloats = kTile * (kRow + 3);  // hq rows, then e, a, x
  static constexpr int kAcc = kBlk * kBlk;
  static constexpr int kScratch = (kGroups - 1) * (kGram + kNb) * (kAcc + 1);
};

// Dynamic shared memory of one CTA, in floats: v_j, then a region that
// holds the tile ring while the slots stream and afterwards the groups'
// partial sums and the finished GG row.
template <int KP>
__host__ __device__ inline int smem_floats(int k) {
  using C = Cfg<KP>;
  const int ring = kStages * C::kStageFloats;
  const int tail = C::kScratch + round4(libfm::gg_width(k));
  return KP + (ring > tail ? ring : tail);
}

// The 8 floats of block b of an hq row: two 16-byte loads.
__device__ __forceinline__ void load_block(const float* row, int b, float (&u)[kBlk]) {
  const float4* r4 = reinterpret_cast<const float4*>(row) + 2 * b;
  const float4 lo = r4[0], hi = r4[1];
  u[0] = lo.x, u[1] = lo.y, u[2] = lo.z, u[3] = lo.w;
  u[4] = hi.x, u[5] = hi.y, u[6] = hi.z, u[7] = hi.w;
}

// kSplit: some feature of the block has several pieces. Without one (no
// list longer than piece_len, as at config #3) CTA j is feature j whole
// and the order is not read: that form keeps the loop's registers as they
// were before the split (with it, KP = 64 spills 20 bytes in the loop and
// is 7% slower at config #3).
template <int KP, bool kSplit>
__global__ void __launch_bounds__(Cfg<KP>::kThreads, Cfg<KP>::kMinBlocks)
    slot_stats_kernel(const float* __restrict__ A, const float* __restrict__ P,
                      const long long* __restrict__ feat_off,
                      const int* __restrict__ slot_case, const float* __restrict__ slot_val,
                      const int* __restrict__ feat_id, const int4* __restrict__ order,
                      float* __restrict__ scratch, int* __restrict__ ticket,
                      float* __restrict__ GG, int piece_len, int k, int num_rows,
                      int use_linear) {
  using C = Cfg<KP>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int4 s_piece;
  __shared__ int s_last;
  float* vj = smem;
  float* ring = smem + KP;
  // this CTA's piece: (feature, rank within the feature, the feature's
  // first scratch row, its pieces), in the host's order (features of many
  // pieces first: their last piece adds the others). Kept in shared
  // memory for the end, so that no register holds it through the loop
  const int4 piece = kSplit ? order[blockIdx.x] : make_int4(blockIdx.x, 0, 0, 1);
  const int j = piece.x;
  const int d = k + 1;
  const int tid = threadIdx.x;
  if (kSplit && tid == 0) s_piece = piece;
  const int lane = tid % kWarp, warp = tid / kWarp;

  const long long fid = feat_id[j];
  for (int f = tid; f < KP; f += C::kThreads) vj[f] = f < k ? P[fid * d + 1 + f] : 0.0f;
  // the pad columns of every stage stay zero
  for (int idx = tid; idx < kStages * kTile * (KP - k); idx += C::kThreads) {
    const int row = idx / (KP - k), c = k + idx % (KP - k);
    ring[(row / kTile) * C::kStageFloats + (row % kTile) * C::kRow + c] = 0.0f;
  }

  const long long lo = feat_off[j] + (long long)piece.y * piece_len;
  const long long hi =
      kSplit ? min(lo + (long long)piece_len, feat_off[j + 1]) : feat_off[j + 1];
  const int ntiles = (int)((hi - lo + kTile - 1) / kTile);
  auto hq_of = [&](int t) { return ring + (t % kStages) * C::kStageFloats; };
  auto tile_n = [&](int t) { return (int)min((long long)kTile, hi - lo - (long long)t * kTile); };

  // Warp w gathers slots w, w + kWarps, ... of a tile. Their (case, x)
  // are read a tile ahead, lane i holding slot w + kWarps i, so that no
  // gather waits on the read of its case.
  auto load_index = [&](int t, int& c, float& x) {
    const int s = warp + C::kWarps * lane;
    c = num_rows;
    x = 0.0f;
    if (t < ntiles && lane < C::kPerWarp && s < tile_n(t)) {
      const long long pos = lo + (long long)t * kTile + s;
      c = slot_case[pos];
      x = slot_val[pos];
    }
  };
  // e into es[s], the q part of the row into hq[s][0..k), x into xs[s]
  auto gather = [&](int t, int c_reg, float x_reg) {
    if (t < ntiles) {
      float* hq = hq_of(t);
      float *es = hq + kTile * C::kRow, *xs = es + 2 * kTile;
      const int n = tile_n(t);
#pragma unroll
      for (int i = 0; i < C::kPerWarp; ++i) {
        const int s = warp + C::kWarps * i;
        const int c = __shfl_sync(libfm::kFullMask, c_reg, i);
        const float x = __shfl_sync(libfm::kFullMask, x_reg, i);
        if (s < n) {
          const bool real = c != num_rows;
          const float* row = A + (long long)(real ? c : 0) * d;
          const int bytes = real ? 4 : 0;
#pragma unroll
          for (int u = 0; u < C::kRowSteps; ++u) {
            const int f = lane + kWarp * u;
            if (f < d)
              libfm::cp_async4(f == 0 ? es + s : hq + s * C::kRow + f - 1, row + f, bytes);
          }
          if (lane == 0) xs[s] = real ? x : 0.0f;
        }
      }
    }
    libfm::cp_async_commit();
  };
  // in place, on the elements this thread copied: hq = x (q - x v); a = x
  float vreg[C::kRowSteps];  // v[f - 1] at this lane's row positions f
  auto transform = [&](int t) {
    float* hq = hq_of(t);
    float *as = hq + kTile * C::kRow + kTile, *xs = as + kTile;
    const int n = tile_n(t);
#pragma unroll
    for (int i = 0; i < C::kPerWarp; ++i) {
      const int s = warp + C::kWarps * i;
      if (s < n) {
        const float x = xs[s];
#pragma unroll
        for (int u = 0; u < C::kRowSteps; ++u) {
          const int f = lane + kWarp * u;
          if (f >= 1 && f < d) {
            float& h = hq[s * C::kRow + f - 1];
            h = x * (h - x * vreg[u]);
          }
        }
        if (lane == 0) as[s] = use_linear ? x : 0.0f;
      }
    }
  };

  // this thread's role: in group g, the Gram block (bi <= bj) or the
  // qa/qe of row block bi; `slot` indexes its partial sums
  const bool gram = tid < C::kGramThreads;
  const bool active = tid < C::kRoles;
  int g, bi = 0, bj = 0, slot;
  if (gram) {
    g = tid / C::kGram;
    int rem = tid % C::kGram;
    slot = rem;
    while (rem >= C::kNb - bi) {
      rem -= C::kNb - bi;
      ++bi;
    }
    bj = bi + rem;
  } else {
    const int u = tid - C::kGramThreads;
    g = u / C::kNb;
    bi = u % C::kNb;
    slot = C::kGram + bi;
  }
  float acc[kBlk][kBlk];
#pragma unroll
  for (int a = 0; a < kBlk; ++a)
#pragma unroll
    for (int b = 0; b < kBlk; ++b) acc[a][b] = 0.0f;

  constexpr int kAhead = kStages - 1;  // tiles in flight while one is consumed
  int c_reg;
  float x_reg;
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    load_index(t, c_reg, x_reg);
    gather(t, c_reg, x_reg);
  }
  load_index(kAhead, c_reg, x_reg);
  __syncthreads();  // vj and the zeroed pad columns
#pragma unroll
  for (int u = 0; u < C::kRowSteps; ++u) {
    const int f = lane + kWarp * u;
    vreg[u] = f >= 1 && f < d ? vj[f - 1] : 0.0f;
  }
  for (int t = 0; t < ntiles; ++t) {
    gather(t + kAhead, c_reg, x_reg);
    load_index(t + kAhead + 1, c_reg, x_reg);  // lands while tile t is consumed
    libfm::cp_async_wait<kAhead>();            // this thread's copies of tile t have landed
    transform(t);
    __syncthreads();
    if (active) {
      const float* hq = hq_of(t);
      const float *es = hq + kTile * C::kRow, *as = es + kTile;
      const int n = tile_n(t);
      if (gram) {
        for (int s = g; s < n; s += C::kGroups) {
          float u[kBlk], w[kBlk];
          load_block(hq + s * C::kRow, bi, u);
          load_block(hq + s * C::kRow, bj, w);
#pragma unroll
          for (int a = 0; a < kBlk; ++a)
#pragma unroll
            for (int b = 0; b < kBlk; ++b) acc[a][b] += u[a] * w[b];
        }
      } else {
        for (int s = g; s < n; s += C::kGroups) {
          float u[kBlk];
          load_block(hq + s * C::kRow, bi, u);
          const float av = as[s], ev = es[s];
#pragma unroll
          for (int a = 0; a < kBlk; ++a) {
            acc[a][0] += u[a] * av;
            acc[a][1] += u[a] * ev;
          }
          acc[0][2] += av * av;
          acc[0][3] += av * ev;
        }
      }
    }
    __syncthreads();  // tile t consumed: its stage takes tile t + kStages
  }

  // groups 1.. hand their partials to group 0, which adds them in order
  float* part = ring;
  float* rowbuf = ring + C::kScratch;
  constexpr int kSlots = C::kGram + C::kNb;
  if (active && g > 0) {
    float* p = part + ((g - 1) * kSlots + slot) * (C::kAcc + 1);
#pragma unroll
    for (int a = 0; a < kBlk; ++a)
#pragma unroll
      for (int b = 0; b < kBlk; ++b) p[a * kBlk + b] = acc[a][b];
  }
  __syncthreads();
  if (active && g == 0) {
    for (int h = 1; h < C::kGroups; ++h) {
      const float* p = part + ((h - 1) * kSlots + slot) * (C::kAcc + 1);
#pragma unroll
      for (int a = 0; a < kBlk; ++a)
#pragma unroll
        for (int b = 0; b < kBlk; ++b) acc[a][b] += p[a * kBlk + b];
    }
    const int T = k * (k + 1) / 2;
    if (gram) {
#pragma unroll
      for (int a = 0; a < kBlk; ++a)
#pragma unroll
        for (int b = 0; b < kBlk; ++b) {
          const int i = bi * kBlk + a, jj = bj * kBlk + b;
          if (i <= jj && jj < k) rowbuf[libfm::tri_index(i, jj, k)] = acc[a][b];
        }
    } else {
#pragma unroll
      for (int a = 0; a < kBlk; ++a) {
        const int i = bi * kBlk + a;
        if (i < k) {
          rowbuf[T + i] = acc[a][0];
          rowbuf[T + k + i] = acc[a][1];
        }
      }
      if (bi == 0) {
        rowbuf[T + 2 * k] = acc[0][2];
        rowbuf[T + 2 * k + 1] = acc[0][3];
      }
    }
  }
  __syncthreads();
  const int GW = libfm::gg_width(k);
  if (!kSplit) {
    float* out = GG + (long long)j * GW;
    for (int e = tid; e < GW; e += C::kThreads) out[e] = rowbuf[e];
    return;
  }
  const int4 pc = s_piece;
  float* out = GG + (long long)pc.x * GW;
  const int npieces = pc.w;
  if (npieces == 1) {
    for (int e = tid; e < GW; e += C::kThreads) out[e] = rowbuf[e];
    return;
  }
  // publish this piece's row; the last piece to arrive adds them all
  const int stride = round4(GW);
  float* first = scratch + (long long)pc.z * stride;
  for (int e = tid; e < GW; e += C::kThreads) first[(long long)pc.y * stride + e] = rowbuf[e];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket + pc.x, 1) == npieces - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < GW; e += C::kThreads) {
    float r = 0.0f;
    for (int q = 0; q < npieces; ++q) r += __ldcg(first + (long long)q * stride + e);
    out[e] = r;
  }
  if (tid == 0) ticket[pc.x] = 0;  // every piece has arrived: ready for the next call
}

template <int KP, bool kSplit>
int launch(const float* A, const float* P, const long long* feat_off, const int* slot_case,
           const float* slot_val, const int* feat_id, const int4* order, float* scratch,
           int* ticket, float* GG, int npieces, int piece_len, int k, int num_rows,
           int use_linear, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats<KP>(k);
  auto kern = slot_stats_kernel<KP, kSplit>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<npieces, Cfg<KP>::kThreads, smem, stream>>>(A, P, feat_off, slot_case, slot_val,
                                                      feat_id, order, scratch, ticket, GG,
                                                      piece_len, k, num_rows, use_linear);
  return (int)cudaGetLastError();
}

}  // namespace

// One CTA a piece: GG [num_feats, T+2k+2] is written row by row.
// feat_off [num_feats+1] (int64) cuts slot_case/slot_val into per-feature
// slot lists; feat_id [num_feats] is each feature's row in P = [w | V].
// order [npieces] (int4, kernels/pieces.py) lists every piece once as
// (feature, rank within the feature, the feature's first scratch row, the
// feature's pieces: ceil(count/piece_len), at least one), in the order the
// CTAs take them; ticket [num_feats] must be zero and is left zero;
// scratch holds round4(T+2k+2) floats for each piece of a feature of
// several. kp is the padded width (kernels.padded_width).
extern "C" int slot_stats_launch(const float* A, const float* P, const long long* feat_off,
                                 const int* slot_case, const float* slot_val,
                                 const int* feat_id, const int* order, float* scratch,
                                 int* ticket, float* GG, int num_feats, int npieces,
                                 int piece_len, int k, int kp, int num_rows, int use_linear,
                                 cudaStream_t stream) {
  if (!libfm::valid_padded_width(kp, k, 0) || piece_len < 1 || npieces < num_feats ||
      (reinterpret_cast<uintptr_t>(order) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (num_feats == 0) return (int)cudaSuccess;
  // npieces == num_feats: every feature is one piece, CTA j feature j
#define SLOT_STATS_LAUNCH(KP)                                                             \
  (npieces > num_feats                                                                    \
       ? launch<KP, true>(A, P, feat_off, slot_case, slot_val, feat_id,                   \
                          reinterpret_cast<const int4*>(order), scratch, ticket, GG,      \
                          npieces, piece_len, k, num_rows, use_linear, stream)            \
       : launch<KP, false>(A, P, feat_off, slot_case, slot_val, feat_id,                  \
                           reinterpret_cast<const int4*>(order), scratch, ticket, GG,     \
                           npieces, piece_len, k, num_rows, use_linear, stream))
  switch (kp) {
    case 16:
      return SLOT_STATS_LAUNCH(16);
    case 32:
      return SLOT_STATS_LAUNCH(32);
    case 64:
      return SLOT_STATS_LAUNCH(64);
    default:
      return SLOT_STATS_LAUNCH(128);
  }
#undef SLOT_STATS_LAUNCH
}
