// rel_cache: the relational (BS) engine's frozen per-block-row caches (K9).
//
// Replaces `build_rel_caches` and its `moments` in
// libfm_tpu/learners/mcmc_rel_vector.py: per block row b, over the train
// cases joined to it (case_ids[case_off[b] .. case_off[b+1]]), the sums of
// the per-case table A = [e | Q]:
//   C[b] = [we0 | we2_0 | SQ0 (k) | SQe0 (k) | SQQ0 (T)]
//   we0 = sum e, we2_0 = sum e^2, SQ0 = sum Q, SQe0 = sum Q e,
//   SQQ0 = sum Q Q^T, its T = k(k+1)/2 upper triangle in np.triu_indices
//   order; the sentinel row nb = 0.
// Every entry is one sum of products u_a u_b over the row's cases, with
// u = [1 | e | Q]: (0,1), (1,1), (0,2+i), (1,2+i), (2+i,2+j): the upper
// triangle of the (k+2) x (k+2) Gram of u, less (0,0).
//
// Bound on the H100: bytes. It reads A's train rows once ((k+1) * 4 B a
// case, 132 MB at bench_bs's 1M cases, k = 32) and writes (nb+1) *
// (2 + 2k + T) floats (9.5 MB there); about 2 * 594 FLOP a case (1.2 GFLOP).
// 0.042 ms at 3.35 TB/s.
// Design. The first version (one CTA of 256 threads a block row, each
// thread up to 3 of the row's sums: two shared-memory reads a
// multiply-add, ~37 warp-wide reads a case at k = 32, and no gathers in
// flight while a stage was summed) took 0.2533 ms at bench_bs beside a
// torch.bmm yardstick of 0.2569 (H100 80GB HBM3, 700 W, chip_smoke.py
// --bench-bs). Now:
// - Tiles. u's columns are cut into w4 = ceil((k+2)/4) groups of 4; a
//   thread owns one 4 x 4 tile (i, j), i <= j, of the row's Gram in
//   registers (from KP = 64 two neighbours of one tile row) and adds each
//   case's outer product of u's two 16-byte pieces: 2 shared reads a 16
//   multiply-adds (45 tiles a row at k = 32).
// - Parallelism. A CTA sums kRows block rows at once, a team of threads
//   a row. A row's cases are never split: each sum starts at 0 and adds
//   one fmaf(u_a, u_b, acc) a case, in case order, with u_0 = 1, as the
//   first version did. C keeps its bits, every run the same.
// - Staging. Each row's cases are staged kStage at a time in a two-stage
//   ring by cp.async in 4-byte copies: A's rows are (k+1) * 4 B and start
//   at any 4-byte offset, and so every row lands at u's column 1 and the
//   tiles' 16-byte reads stay aligned. A thread copies 4 floats of a row
//   at a time, the stage's groups of 4 one run over all threads, so that
//   a case's lookup is paid once a group (a warp a case: 0.1799 ms; a
//   float a thread: 0.1537; 2 floats: 0.1414; 4: 0.1302; 8: 0.1371;
//   H100 80GB HBM3, 700 W, chip_smoke.py --bench-bs). The next stage's
//   copies, and the case ids of the stage after it, are in flight while
//   this stage is summed; one barrier a stage.
// - Output. The tiles go to shared memory as the rows' Grams (in the
//   ring's place), and the CTA writes each row's 2 + 2k + T sums once,
//   in C's packed order, coalesced. No atomics.
//
// The narrow form, k <= 2 (rel_cache_cols_launch): the exact BS engine's
// per-row sums over [e | q'] (k = 1, 5 sums; libfm_tpu/learners/
// mcmc_relational.py:540-547), 1 + k launches an iteration. On the
// template above a CTA of 256 threads owned those 5 sums, staged the
// cases 32 at a time through shared memory with three barriers a stage,
// and the caller copied the two columns into an [nc, 2] table first: 0.0935
// ms at bench_bs_ctx against 0.0925 for its torch.bmm (H100 80GB HBM3,
// 700 W). Bound: bytes, the case id and two floats a case (12 MB at 1M
// cases, each float a random sector), 0.0036 ms counted as bytes read.
// Here one warp owns a block row, 8 rows a CTA: its lanes stride over the
// row's cases, a lane's loads for kNarrowUnroll cases issued before its
// first sum, its 2 + 2k + k(k+1)/2 sums in registers; a shuffle tree in
// fixed order adds the lanes' sums and lane 0 writes the row. No shared
// memory, no barrier; e and each q column are read where they lie (any
// stride), so the caller copies nothing. It takes 0.0214 ms there, the
// bmm 0.0930 (H100 80GB HBM3, 700 W; chip_smoke.py --exact).

#include "common.cuh"

namespace {

using libfm::kWarp;

__host__ __device__ constexpr int cache_width(int k) { return 2 + 2 * k + k * (k + 1) / 2; }

// The threads a row's Gram takes when each owns up to `per` neighbouring
// tiles of one tile row of the w4 x w4 upper triangle.
__host__ __device__ constexpr int tile_groups(int w4, int per) {
  int n = 0;
  for (int len = 1; len <= w4; ++len) n += (len + per - 1) / per;
  return n;
}

// The wide form's shape at the padded width KP: u = [1 | e | Q] in
// kWidth = KP + 4 columns (kTiles4 groups of 4); a thread owns up to kPer
// neighbouring tiles of one tile row, a team of kTeam threads a block
// row, kRows rows a CTA of kThreads, kStage cases a row a stage.
template <int KP>
struct Wide {
  static constexpr int kTiles4 = KP / 4 + 1;
  static constexpr int kWidth = 4 * kTiles4;
  static constexpr int kPer = KP <= 32 ? 1 : 2;
  static constexpr int kTeam = tile_groups(kTiles4, kPer);
  static constexpr int kRows = KP == 16 ? 16 : KP == 32 ? 5 : KP == 64 ? 3 : 1;
  static constexpr int kStage = KP == 16 ? 16 : 32;
  static constexpr int kThreads = (kRows * kTeam + kWarp - 1) / kWarp * kWarp;
  // dynamic shared memory: the ring [2][kRows][kStage][kWidth], then the
  // rows' Grams [kRows][kWidth][kWidth] in its place
  static constexpr int kRing = 2 * kRows * kStage * kWidth;
  static constexpr int kGram = kRows * kWidth * kWidth;
  static constexpr int kSmemBytes = 4 * (kRing > kGram ? kRing : kGram);
};

template <int KP>
__global__ void __launch_bounds__(Wide<KP>::kThreads)
    rel_cache_kernel(const float* __restrict__ A, const long long* __restrict__ case_off,
                     const int* __restrict__ case_ids, float* __restrict__ C, int nb, int k) {
  using W = Wide<KP>;
  constexpr int WP = W::kWidth, S = W::kStage, kRows = W::kRows, kPer = W::kPer;
  constexpr int kThreads = W::kThreads;
  extern __shared__ __align__(16) float smem[];
  __shared__ int ids[2][kRows][S];
  __shared__ long long s_lo[kRows];
  __shared__ int s_n[kRows];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  const int d = k + 1;
  if (tid < kRows) {
    const int b = b0 + tid;  // the sentinel row nb and rows past it: no cases
    s_lo[tid] = b < nb ? case_off[b] : 0;
    s_n[tid] = b < nb ? (int)(case_off[b + 1] - case_off[b]) : 0;
  }
  // u's column 0 and pad columns in every ring slot (the copies write
  // columns 1 .. k+1 only)
  for (int i = tid; i < 2 * kRows * S; i += kThreads) {
    float* row = smem + i * WP;
    row[0] = 1.0f;
    for (int c = k + 2; c < WP; ++c) row[c] = 0.0f;
  }
  // this thread's tiles: its group's, in tile row i, tiles (i, j0 .. j0 +
  // kPer - 1) that lie in the w4 x w4 upper triangle; a tile past the
  // row's end is summed as the group's first and never written
  const int w4 = (k + 5) / 4;
  const int team = tid / W::kTeam;
  const bool sums = team < kRows;
  int ti = 0, tj[kPer];
  bool own[kPer];
  {
    int g = tid % W::kTeam, i = 0;
    while (i < w4 && g >= (w4 - i + kPer - 1) / kPer) {
      g -= (w4 - i + kPer - 1) / kPer;
      ++i;
    }
    const bool group = i < w4;  // past the last group: none, tile (0, 0)
    ti = group ? 4 * i : 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int j = i + g * kPer + p;
      own[p] = sums && group && j < w4;
      tj[p] = own[p] ? 4 * j : group ? 4 * (i + g * kPer) : 0;
    }
  }
  float acc[kPer][4][4];
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[p][x][y] = 0.0f;
  __syncthreads();
  int stages = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) stages = max(stages, (s_n[j] + S - 1) / S);

  // stage t's case ids into ids[t & 1]
  auto issue_ids = [&](int t) {
    for (int i = tid; i < kRows * S; i += kThreads) {
      const int j = i / S, r = i % S;
      if (r < s_n[j] - t * S)
        libfm::cp_async4(reinterpret_cast<float*>(&ids[t & 1][j][r]),
                         reinterpret_cast<const float*>(case_ids + s_lo[j] + t * S + r));
    }
  };
  // stage t's rows of A into ring slot t & 1, in groups of 4 floats of a
  // row, a group a thread: the stage's groups one flat run (walked on, not
  // divided); a thread copies its group's floats in an order rotated by
  // its lane octet, so that a warp's copies land in distinct banks; a
  // slot past its row's cases reads nothing
  const int G = (d + 3) / 4;
  const int slot0 = tid / G, grp0 = tid % G;
  const int slot_step = kThreads / G, grp_step = kThreads % G;
  const int rot = (tid >> 3) & 3;
  auto issue_rows = [&](int t) {
    float* base = smem + (t & 1) * kRows * S * WP + 1;
    int slot = slot0, gi = grp0;
    for (int e = tid; e < kRows * S * G; e += kThreads) {
      const int j = slot / S, r = slot % S;
      const bool real = r < s_n[j] - t * S;
      const float* src = real ? A + (long long)ids[t & 1][j][r] * d : A;
      float* dst = base + slot * WP;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * gi + ((u + rot) & 3);
        if (c < d) libfm::cp_async4(dst + c, src + (real ? c : 0), real ? 4 : 0);
      }
      slot += slot_step;
      gi += grp_step;
      if (gi >= G) {
        gi -= G;
        ++slot;
      }
    }
  };

  if (stages > 0) {
    issue_ids(0);
    libfm::cp_async_commit();
    libfm::cp_async_wait<0>();
    __syncthreads();
    issue_rows(0);
    if (stages > 1) issue_ids(1);
    libfm::cp_async_commit();
  }
  for (int t = 0; t < stages; ++t) {
    libfm::cp_async_wait<0>();
    __syncthreads();  // stage t and ids[t + 1] landed; stage t - 1's slot is read
    if (t + 1 < stages) {
      issue_rows(t + 1);
      if (t + 2 < stages) issue_ids(t + 2);
      libfm::cp_async_commit();
    }
    if (sums) {
      const int n = min(S, s_n[team] - t * S);
      const float* u = smem + ((t & 1) * kRows + team) * S * WP;
#pragma unroll 4
      for (int r = 0; r < n; ++r, u += WP) {
        const float4 a4 = *reinterpret_cast<const float4*>(u + ti);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const float4 b4 = *reinterpret_cast<const float4*>(u + tj[p]);
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[p][x][y] = fmaf(a[x], b[y], acc[p][x][y]);
        }
      }
    }
  }
  __syncthreads();  // the ring is read: the Grams take its place
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (!own[p]) continue;
    float* g = smem + team * WP * WP + ti * WP + tj[p];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(g + x * WP) =
          make_float4(acc[p][x][0], acc[p][x][1], acc[p][x][2], acc[p][x][3]);
  }
  __syncthreads();
  // each row's sums in C's packed order: (0,1), (1,1), (0,2+i), (1,2+i),
  // then Q's triangle (2+i, 2+j), i <= j, row by row
  const int cw = cache_width(k);
  for (int j = 0; j < kRows && b0 + j <= nb; ++j) {
    const float* g = smem + j * WP * WP;
    float* out = C + (long long)(b0 + j) * cw;
    int row = 0, row_start = 0;  // the triangle's row of entry o, walked on as o grows
    for (int o = tid; o < cw; o += kThreads) {
      int a, b;
      if (o < 2) {
        a = o;
        b = 1;
      } else if (o < 2 + k) {
        a = 0;
        b = o;
      } else if (o < 2 + 2 * k) {
        a = 1;
        b = o - k;
      } else {
        const int t = o - 2 - 2 * k;
        while (t - row_start >= k - row) {
          row_start += k - row;
          ++row;
        }
        a = 2 + row;
        b = 2 + row + (t - row_start);
      }
      out[o] = g[a * WP + b];
    }
  }
}

constexpr int kNarrowWarps = 8;   // block rows a CTA
constexpr int kNarrowUnroll = 4;  // cases a lane has in flight

struct Cols {
  const float* e;
  long long se;
  const float* q[2];
  long long sq[2];
};

template <int K>
__global__ void __launch_bounds__(kNarrowWarps * 32)
    rel_cache_narrow_kernel(Cols c, const long long* __restrict__ case_off,
                            const int* __restrict__ case_ids, float* __restrict__ C, int nb) {
  constexpr int W = cache_width(K);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kNarrowWarps + threadIdx.x / 32;
  if (b > nb) return;
  float acc[W];
#pragma unroll
  for (int o = 0; o < W; ++o) acc[o] = 0.0f;
  const long long lo = b < nb ? case_off[b] : 0, hi = b < nb ? case_off[b + 1] : 0;
  for (long long c0 = lo + lane; c0 < hi; c0 += 32 * kNarrowUnroll) {
    int id[kNarrowUnroll];
#pragma unroll
    for (int u = 0; u < kNarrowUnroll; ++u) {
      const long long i = c0 + 32 * u;
      id[u] = i < hi ? case_ids[i] : -1;
    }
    float ev[kNarrowUnroll], qv[kNarrowUnroll][K];
#pragma unroll
    for (int u = 0; u < kNarrowUnroll; ++u) {
      const long long r = id[u] < 0 ? 0 : id[u];
      ev[u] = id[u] < 0 ? 0.0f : c.e[r * c.se];
#pragma unroll
      for (int i = 0; i < K; ++i) qv[u][i] = id[u] < 0 ? 0.0f : c.q[i][r * c.sq[i]];
    }
#pragma unroll
    for (int u = 0; u < kNarrowUnroll; ++u) {
      if (id[u] < 0) continue;
      const float e = ev[u];
      acc[0] = __fadd_rn(acc[0], e);
      acc[1] = fmaf(e, e, acc[1]);
      int o = 2 + 2 * K;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        acc[2 + i] = __fadd_rn(acc[2 + i], qv[u][i]);
        acc[2 + K + i] = fmaf(qv[u][i], e, acc[2 + K + i]);
#pragma unroll
        for (int j = i; j < K; ++j, ++o) acc[o] = fmaf(qv[u][i], qv[u][j], acc[o]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < W; ++o) acc[o] = libfm::warp_sum(acc[o]);
  if (lane == 0) {
    float* out = C + (long long)b * W;
#pragma unroll
    for (int o = 0; o < W; ++o) out[o] = acc[o];
  }
}

template <int KP>
int wide_launch(const float* A, const long long* case_off, const int* case_ids, float* C,
                int nb, int k, cudaStream_t stream) {
  using W = Wide<KP>;
  constexpr int kDevices = 64;
  static bool allowed[kDevices];  // the kernel's shared memory, asked for once a device
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(rel_cache_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  const unsigned grid = (unsigned)((nb + W::kRows) / W::kRows);  // nb + 1 rows
  rel_cache_kernel<KP><<<grid, W::kThreads, W::kSmemBytes, stream>>>(A, case_off, case_ids, C,
                                                                     nb, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The narrow form, k = 1 or 2: C [nb+1, 2 + 2k + k(k+1)/2] out, the sums
// of u = [1 | e | q0 (| q1)] over each row's cases, each column read at
// its own stride (floats); q1 null for k = 1.
extern "C" int rel_cache_cols_launch(const float* e, long long se, const float* q0,
                                     long long sq0, const float* q1, long long sq1, int k,
                                     const long long* case_off, const int* case_ids, float* C,
                                     int nb, cudaStream_t stream) {
  if (k < 1 || k > 2 || nb < 0 || !e || !q0 || (k == 2 && !q1) || !case_off || !C ||
      (nb > 0 && !case_ids))
    return (int)cudaErrorInvalidValue;
  const Cols c{e, se, {q0, q1}, {sq0, sq1}};
  const unsigned grid = (unsigned)((nb + kNarrowWarps) / kNarrowWarps);  // nb + 1 rows
  constexpr int threads = kNarrowWarps * 32;
  if (k == 1)
    rel_cache_narrow_kernel<1><<<grid, threads, 0, stream>>>(c, case_off, case_ids, C, nb);
  else
    rel_cache_narrow_kernel<2><<<grid, threads, 0, stream>>>(c, case_off, case_ids, C, nb);
  return (int)cudaGetLastError();
}

// C [nb+1, 2 + 2k + k(k+1)/2] out; A [nc, k+1]; case_off int64 [nb+1],
// case_ids int32; kp = the padded width (16, 32, 64 or 128) holding k.
extern "C" int rel_cache_launch(const float* A, const long long* case_off,
                                const int* case_ids, float* C, int nb, int k, int kp,
                                cudaStream_t stream) {
  if (!libfm::valid_padded_width(kp, k) || nb < 0) return (int)cudaErrorInvalidValue;
  switch (kp) {
    case 16: return wide_launch<16>(A, case_off, case_ids, C, nb, k, stream);
    case 32: return wide_launch<32>(A, case_off, case_ids, C, nb, k, stream);
    case 64: return wide_launch<64>(A, case_off, case_ids, C, nb, k, stream);
    default: return wide_launch<128>(A, case_off, case_ids, C, nb, k, stream);
  }
}
