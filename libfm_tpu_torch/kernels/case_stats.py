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
the same sums over the per-feature slot lists.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.kernels.pieces import PIECE_LEN, Pieces
from libfm_tpu_torch.kernels.slot_stats import gg_width

KERNEL = Kernel(
    "case_stats", "case_stats_launch",
    [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 6 + [ctypes.c_longlong],
)
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


def scratch_floats(k: int, onehot: bool) -> int:
    """Floats of the kernel's scratch row of a piece: 4 a work item (four
    adjacent moment columns), as csrc/case_stats.cu numbers them."""
    nb = -(-k // 4)
    tri = sum(nb - i // 4 for i in range(k))
    return 4 * (tri + (2 if onehot else 3) * nb + (1 if onehot else 2))


def case_stats_plain(A, P, feat_off, slot_case, slot_val, feat_id, *, onehot,
                     use_linear=True, GG=None, pieces=None):
    """The plain PyTorch version; same contract as `case_stats`."""
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
    `pieces` (`Pieces(feat_off, device)`, made once a block) is made here
    when not given. GG may be passed to write into (its first Fd rows).
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
    if not 1 <= k <= 128:
        raise ValueError(f"k={k}: the CUDA kernels take 1 <= k <= 128")
    if pieces is None:
        pieces = Pieces(feat_off, A.device)
    check(pieces.order, "order", torch.int32, (pieces.count, 4))
    check(pieces.ticket, "ticket", torch.int32, (Fd,))
    if GG is None:
        GG = torch.empty(Fd, gg_width(k), dtype=torch.float32, device=A.device)
    if GG.shape[0] < Fd or GG.shape[1] != gg_width(k) or not GG.is_contiguous():
        raise ValueError(f"GG: shape {tuple(GG.shape)} cannot hold {Fd} rows")
    KERNEL.launch(
        ptr(A), ptr(P), ptr(feat_off), ptr(slot_case), ptr(slot_val), ptr(feat_id),
        ptr(pieces.order), ptr(pieces.scratch(scratch_floats(k, onehot))),
        ptr(pieces.ticket), ptr(GG), Fd, pieces.count, PIECE_LEN, k, int(onehot),
        int(use_linear), A.shape[0],
    )
    return GG[:Fd]
