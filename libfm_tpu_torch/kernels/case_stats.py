"""case_stats: per-feature statistics GG of one conflict-free block from
case-major moment sums, reconstructed without v. CUDA source:
csrc/case_stats.cu.

Replaces the JAX engine's case-major statistics: `stats_case_chunk` and
the reconstruction after it (libfm_tpu/learners/mcmc_vector.py,
sweep_block). The result is the GG row `slot_stats` computes
(`slot_stats.gg_width`), from moments that do not involve v:
  one-hot: M = sum over a feature's cases of [Q_i Q_j | Q | e Q | 1 | e],
  valued:  M = sum of [x^2 Q_i Q_j | x^2 Q | x^3 Q | x e Q | x^2 | x^3 |
                       x^4 | x e | x^2 e],
then Qq = M2 - v S3 - S3 v + m4 v v, qa = S2 - m3 v, qe = SQe - m2e v,
aa = m2, ae = m x e (qa, aa, ae zero without the linear term).

The plain version reads A in case order with a per-case stats id (the
JAX engine's `stats_map`: the case's feature, out of range where the
case holds none) and sums the moment rows per feature; the kernel runs
the same sums over the per-feature slot lists, under a launch plan made
once a block (`CaseStatsPlan`): short features a team each (a warp at
k <= 32), several to a CTA, long ones in pieces of a CTA each.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.kernels.slot_stats import gg_width

KERNEL = Kernel(
    "case_stats", "case_stats_launch",
    [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 5 + [ctypes.c_longlong],
)
#: threads of a CTA; rows a team stages at once (csrc/case_stats.cu)
CTA_THREADS = 256
STAGE_ROWS = 32
#: the most slots of a short feature at k <= 32: one warp sums it
SHORT_LEN = 512
#: slots of a long feature's piece, one CTA each: at k <= 32 its 8 warps
#: take 512 each, above it the CTA takes the piece as one team
PIECE_SLOTS = {True: 4096, False: 2048}
#: cases a one-hot product of the plain version sums (the JAX engine's
#: case-major chunk, `CUS`)
CASE_CHUNK = 8192


@lru_cache(maxsize=None)
def triu(k: int, device) -> tuple:
    """(iu0, iu1) long tensors of np.triu_indices(k) on `device`, made once
    (a copy to the card inside a timed plain version would wait for it)."""
    return tuple(torch.as_tensor(a, device=device) for a in np.triu_indices(k))


def moment_width(k: int, onehot: bool) -> int:
    T = k * (k + 1) // 2
    return T + 2 * k + 2 if onehot else T + 3 * k + 5


def padded_k(k: int) -> int:
    """The width the kernel stages a row's factors at: 4, 8, ..., 128 (4
    at k = 0, whose rows hold no factor)."""
    if not 0 <= k <= 128:
        raise ValueError(f"k={k}: the CUDA kernels take 0 <= k <= 128")
    return max(4, 1 << (k - 1).bit_length()) if k else 4


def team_threads(k: int) -> int:
    """The threads that sum one run of slots: a warp at k <= 32, the CTA
    above (a thread's share of the items would not fit a warp's registers)."""
    return 32 if k <= 32 else CTA_THREADS


def num_items(k: int) -> int:
    """The kernel's items: 4 x 4 outer products of two 16-byte pieces of a
    staged row, over nb = ceil(k / 4) column blocks: the triangle's
    nb (nb + 1) / 2, nb vector blocks and the scalars."""
    nb = -(-k // 4)
    return (nb + 1) * (nb + 2) // 2


def scratch_floats(k: int) -> int:
    """Floats of the kernel's scratch row of a piece: a 4 x 4 sum an item."""
    return 16 * num_items(k)


def smem_bytes(k: int, onehot: bool) -> int:
    """A CTA's dynamic shared memory (csrc/case_stats.cu `cta_floats`): a
    region a team (its ring of stages, reused for its moment row and v or
    its sums), then a piece's moment row and v."""
    kp = padded_k(k)
    stages = 3 if kp <= 16 else 2
    mrow = -(-moment_width(k, onehot) // 4) * 4 + kp
    team = max(stages * STAGE_ROWS * (kp + 8), mrow, scratch_floats(k))
    return 4 * (CTA_THREADS // team_threads(k) * team + mrow)


class CaseStatsPlan:
    """The kernel's launch plan for one block's lists (feat_off [Fd+1]) at
    k factors, made once a block.

    A feature of at most `short_len` slots (SHORT_LEN at k <= 32, else a
    piece) is short: one team sums it, `teams` (256 / team_threads) of
    them to a CTA, the longest first. A longer one is cut into pieces of
    `piece_len` slots (PIECE_SLOTS), one CTA each, whose teams take
    consecutive parts of it. `cta` int32 [count, 4] lists the CTAs in
    launch order, long pieces first (features of many pieces first): a
    piece as (feature, rank, first scratch row, the feature's pieces), a
    CTA of short features as (-1 - s, n, 0, 0), features `short[s:s+n]`.
    Only features of several pieces take scratch rows (`rows` of them);
    the ticket, one int a feature, is zero between calls; the scratch is
    allocated at its first use and kept."""

    def __init__(self, feat_off, k: int, device):
        off = feat_off.cpu().numpy() if torch.is_tensor(feat_off) else np.asarray(feat_off)
        counts = np.diff(off).astype(np.int64)
        self.k = k
        self.team = team_threads(k)
        self.teams = CTA_THREADS // self.team
        self.piece_len = PIECE_SLOTS[k <= 32]
        self.short_len = SHORT_LEN if k <= 32 else self.piece_len
        long_ = counts > self.short_len
        per = np.where(long_, -(-counts // self.piece_len), 0)
        feats = np.argsort(-per, kind="stable")[:int(long_.sum())]
        multi = np.where(per[feats] > 1, per[feats], 0)
        base = np.cumsum(multi) - multi
        f = np.repeat(feats, per[feats])
        rank = np.arange(len(f)) - np.repeat(np.cumsum(per[feats]) - per[feats], per[feats])
        pieces = np.stack([f, rank, np.repeat(base, per[feats]), per[f]], axis=1)
        short = np.flatnonzero(~long_)
        short = short[np.argsort(-counts[short], kind="stable")]
        starts = np.arange(0, len(short), self.teams)
        groups = np.stack([-1 - starts, np.minimum(self.teams, len(short) - starts),
                           0 * starts, 0 * starts], axis=1)
        cta = np.concatenate([pieces.reshape(-1, 4), groups.reshape(-1, 4)]).astype(np.int32)
        self.count = len(cta)
        self.rows = int(multi.sum())
        self.cta = torch.as_tensor(cta.reshape(-1), device=device).reshape(-1, 4)
        self.short = torch.as_tensor(np.append(short, 0).astype(np.int32), device=device)
        self.ticket = torch.zeros(len(counts), dtype=torch.int32, device=device)
        self._scratch = None

    def scratch(self) -> torch.Tensor:
        """The pieces' scratch: `rows` rows of scratch_floats(k) (at least
        one row, so that its pointer is real)."""
        if self._scratch is None:
            self._scratch = torch.empty(max(self.rows, 1) * scratch_floats(self.k),
                                        dtype=torch.float32, device=self.ticket.device)
        return self._scratch

    def team_runs(self, feat_off) -> np.ndarray:
        """[runs, 3] (feature, lo, hi): the runs of slots the kernel's
        teams sum, as csrc/case_stats.cu cuts them from this plan (a piece
        split into `teams` parts of equal length, the last ones shorter or
        empty)."""
        off = feat_off.cpu().numpy() if torch.is_tensor(feat_off) else np.asarray(feat_off)
        short = self.short.cpu().numpy()
        runs = []
        for f, rank, _, _ in self.cta.cpu().numpy():
            if f < 0:
                for g in short[-1 - f:-1 - f + rank]:
                    runs.append((g, off[g], off[g + 1]))
                continue
            flo = off[f] + rank * self.piece_len
            fhi = min(flo + self.piece_len, off[f + 1])
            part = -(-(fhi - flo) // self.teams)
            for t in range(self.teams):
                lo = min(flo + t * part, fhi)
                runs.append((f, lo, min(lo + part, fhi)))
        return np.asarray(runs, dtype=np.int64).reshape(-1, 3)


def case_stats_plain(A, P, feat_off, slot_case, slot_val, feat_id, *, onehot,
                     use_linear=True, GG=None, pieces=None):
    """The plain PyTorch version; same contract as `case_stats` (`pieces`,
    the kernel's plan, is not read)."""
    del pieces
    k = P.shape[1] - 1
    nc = A.shape[0]
    Fd = feat_id.shape[0]
    MW = moment_width(k, onehot)
    dev = A.device
    iu0, iu1 = (torch.as_tensor(a, device=dev) for a in np.triu_indices(k))
    # the per-case stats id (JAX's stats_map) and value; padding slots
    # (case == nc) and cases outside the block map to Fd: out of range
    cnt = feat_off[1:] - feat_off[:-1]
    real = slot_case.long() < nc
    sc = slot_case.long()[real]
    sid = torch.full((nc,), Fd, dtype=torch.long, device=dev)
    sid[sc] = torch.repeat_interleave(torch.arange(Fd, device=dev), cnt)[real]
    x = torch.zeros(nc, dtype=A.dtype, device=dev)
    x[sc] = slot_val[real].to(A.dtype)
    MOM = torch.zeros(Fd, MW, dtype=A.dtype, device=dev)
    feats = torch.arange(Fd, device=dev)
    for c0 in range(0, nc, CASE_CHUNK):
        A_c = A[c0:c0 + CASE_CHUNK]
        e, Q = A_c[:, 0], A_c[:, 1:]
        if onehot:
            rows = torch.cat([Q[:, iu0] * Q[:, iu1], Q, e[:, None] * Q,
                              torch.ones_like(e)[:, None], e[:, None]], dim=1)
        else:
            xv = x[c0:c0 + CASE_CHUNK]
            x2 = xv * xv
            x3 = x2 * xv
            x4 = x2 * x2
            Q2 = x2[:, None] * Q
            xe = xv * e
            rows = torch.cat([Q2[:, iu0] * Q[:, iu1], Q2, x3[:, None] * Q, xe[:, None] * Q,
                              x2[:, None], x3[:, None], x4[:, None], xe[:, None],
                              (x2 * e)[:, None]], dim=1)
        # one one-hot product a chunk of cases, as the JAX engine sums
        onehot_c = (sid[c0:c0 + CASE_CHUNK, None] == feats[None, :]).to(A.dtype)
        MOM += onehot_c.T @ rows
    return gg_from_moments(MOM[:Fd], P[feat_id.long(), 1:], onehot=onehot,
                           use_linear=use_linear, GG=GG)


def gg_from_moments(MOM, v, *, onehot, use_linear=True, GG=None):
    """GG [F, T+2k+2] from the moment rows MOM [F, moment_width(k, onehot)]
    and the features' (pre-draw) v [F, k], without v in the sums:
    Qq = M2 - v S3 - S3 v + m4 v v, qa = S2 - m3 v, qe = SQe - m2e v,
    aa = m2, ae = m x e (qa, aa, ae zero without the linear term). GG may
    be passed to write into (its first F rows)."""
    F, k = v.shape
    T = k * (k + 1) // 2
    iu0, iu1 = triu(k, v.device)
    M2 = MOM[:, :T]
    if onehot:
        S2 = S3 = MOM[:, T:T + k]
        SQe = MOM[:, T + k:T + 2 * k]
        m2 = m3 = m4 = MOM[:, -2]
        mxe = m2e = MOM[:, -1]
    else:
        S2 = MOM[:, T:T + k]
        S3 = MOM[:, T + k:T + 2 * k]
        SQe = MOM[:, T + 2 * k:T + 3 * k]
        m2, m3, m4, mxe, m2e = (MOM[:, c] for c in range(-5, 0))
    vS3 = v[:, iu0] * S3[:, iu1]
    S3v = S3[:, iu0] * v[:, iu1]
    vv = v[:, iu0] * v[:, iu1]
    if GG is None:
        GG = torch.empty(F, gg_width(k), dtype=MOM.dtype, device=MOM.device)
    G = GG[:F]
    G[:, :T] = M2 - vS3 - S3v + m4[:, None] * vv
    G[:, T + k:T + 2 * k] = SQe - m2e[:, None] * v
    if use_linear:
        G[:, T:T + k] = S2 - m3[:, None] * v
        G[:, T + 2 * k] = m2
        G[:, T + 2 * k + 1] = mxe
    else:
        G[:, T:T + k] = 0.0
        G[:, T + 2 * k:] = 0.0
    return G


def case_stats_reference(A, P, feat_off, slot_case, slot_val, feat_id, *, onehot,
                         use_linear=True):
    """The plain version in float64, and beside it every GG entry's sum
    of magnitudes: the same sums and reconstruction over |A|, |x| and
    -|v|, in which every term adds (Qq = M2 + |v| S3 + S3 |v| + m4 |v||v|,
    qa = S2 + m3 |v|, ...). A sum that cancels has no scale of its own;
    the sum of magnitudes is the scale of its f32 rounding, for a feature
    of 12 cases as for one of 321K. Returns (GG, scale), float64."""
    args = (feat_off, slot_case)
    kw = dict(onehot=onehot, use_linear=use_linear)
    ref = case_stats_plain(A.double(), P.double(), *args, slot_val, feat_id, **kw)
    P_mag = torch.cat([P[:, :1], -P[:, 1:].abs()], dim=1).double()
    scale = case_stats_plain(A.abs().double(), P_mag, *args, slot_val.abs(), feat_id, **kw)
    return ref, scale


def err_over_magnitudes(GG, ref, scale) -> float:
    """The largest |GG - ref| over that entry's sum of magnitudes (both
    from `case_stats_reference`); an entry whose scale is 0 must be 0."""
    err = (GG.double() - ref).abs()
    if bool((err[scale == 0] > 0).any()):
        return float("inf")
    return (err / scale.clamp_min(1e-300)).max().item()


def case_stats(A, P, feat_off, slot_case, slot_val, feat_id, *, onehot,
               use_linear=True, GG=None, pieces=None):
    """GG [Fd, T+2k+2]: one statistics row per feature of a block, the
    same function as `slot_stats`, from case-major moments.

    A [nc, k+1] = [e | Q]; P = [w | V] [n, k+1] (the PRE-draw V);
    feat_off int64 [Fd+1] cuts slot_case int32 / slot_val float32 [E]
    into per-feature slot lists (case == nc: padding); feat_id int32 [Fd]
    is each feature's global id; `onehot` says every slot value is 1 (the
    moment row drops x's powers; slot_val is not read). On the card
    `pieces` is the kernel's launch plan (`CaseStatsPlan(feat_off, k,
    device)`, made once a block), made here when not given. GG may be
    passed to write into (its first Fd rows).
    """
    tensors = [A, P, feat_off, slot_case, slot_val, feat_id]
    if not on_cuda(*tensors):
        return case_stats_plain(A, P, feat_off, slot_case, slot_val, feat_id,
                                onehot=onehot, use_linear=use_linear, GG=GG)
    k = P.shape[1] - 1
    Fd = feat_id.shape[0]
    E = slot_case.shape[0]
    check(A, "A", torch.float32, (A.shape[0], k + 1))
    check(P, "P", torch.float32)
    check(feat_off, "feat_off", torch.int64, (Fd + 1,))
    check(slot_case, "slot_case", torch.int32)
    check(slot_val, "slot_val", torch.float32, (E,))
    check(feat_id, "feat_id", torch.int32)
    if not 0 <= k <= 128:
        raise ValueError(f"k={k}: the CUDA kernels take 0 <= k <= 128")
    plan = CaseStatsPlan(feat_off, k, A.device) if pieces is None else pieces
    if plan.team != team_threads(k) or plan.k != k:
        raise ValueError(f"the plan was made for k={plan.k}, not {k}")
    check(plan.cta, "cta", torch.int32, (plan.count, 4))
    check(plan.ticket, "ticket", torch.int32, (Fd,))
    if GG is None:
        GG = torch.empty(Fd, gg_width(k), dtype=torch.float32, device=A.device)
    if GG.shape[0] < Fd or GG.shape[1] != gg_width(k) or not GG.is_contiguous():
        raise ValueError(f"GG: shape {tuple(GG.shape)} cannot hold {Fd} rows")
    KERNEL.launch(
        ptr(A), ptr(P), ptr(feat_off), ptr(slot_case), ptr(slot_val), ptr(feat_id),
        ptr(plan.cta), ptr(plan.short), ptr(plan.scratch()), ptr(plan.ticket), ptr(GG),
        plan.count, plan.piece_len, k, int(onehot), int(use_linear), A.shape[0],
    )
    return GG[:Fd]
