"""slot_stats: per-feature moment statistics (one GG row per feature) of
one conflict-free block. CUDA source: csrc/slot_stats.cu.

Replaces the JAX engine's slot path `_slot_hM` + `stats_chunk`
(libfm_tpu/learners/mcmc_vector.py).

GG row layout, GW = T + 2k + 2 with T = k(k+1)/2:
[Qq (upper triangle in np.triu_indices(k) order) | qa | qe | aa | ae].
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, padded_width, ptr
from libfm_tpu_torch.kernels.pieces import PIECE_LEN, Pieces

KERNEL = Kernel(
    "slot_stats", "slot_stats_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7,
)
# bound on the [chunk, Wmax, k] temporaries of the plain version
_PLAIN_BUDGET = 1 << 26


def gg_width(k: int) -> int:
    return k * (k + 1) // 2 + 2 * k + 2


def gg_rel_err(GG, ref, k: int) -> float:
    """How far GG is from `ref`: per part of the row (Qq, qa, qe, aa, ae),
    the largest |GG - ref| over that part's largest |ref|; the largest of
    the five. A part that is 0 in `ref` (qa, aa, ae without the linear
    term) must be 0 in GG to within 1e-30. At k = 0 only aa and ae are
    there."""
    T = k * (k + 1) // 2
    cuts = [0, T, T + k, T + 2 * k, T + 2 * k + 1, T + 2 * k + 2]
    return max(
        ((GG[:, a:b] - ref[:, a:b]).abs().max()
         / ref[:, a:b].abs().max().clamp_min(1e-30)).item()
        for a, b in zip(cuts, cuts[1:]) if b > a
    )


def slot_stats_plain(A, P, feat_off, slot_case, slot_val, feat_id, *,
                     use_linear=True, GG=None, pieces=None):
    """The plain PyTorch version; same contract as `slot_stats`. Works on
    features in chunks, each padded to its widest feature."""
    del pieces
    k = P.shape[1] - 1
    num_rows = A.shape[0]
    Fd = feat_id.shape[0]
    T = k * (k + 1) // 2
    iu0, iu1 = np.triu_indices(k)
    tri = torch.as_tensor(iu0 * k + iu1, device=A.device)
    if GG is None:
        GG = torch.empty(Fd, gg_width(k), dtype=A.dtype, device=A.device)
    off = feat_off.cpu().numpy()
    counts = np.diff(off)
    f0 = 0
    while f0 < Fd:
        wmax = max(1, int(counts[f0]))
        f1 = f0 + 1
        while f1 < Fd and (f1 - f0 + 1) * max(wmax, int(counts[f1])) * k <= _PLAIN_BUDGET:
            wmax = max(wmax, int(counts[f1]))
            f1 += 1
        lo, hi = int(off[f0]), int(off[f1])
        n = f1 - f0
        # [n, wmax] padded views of this chunk's slots
        pos = torch.arange(hi - lo, device=A.device) - torch.repeat_interleave(
            torch.as_tensor(off[f0:f1] - lo, device=A.device),
            torch.as_tensor(counts[f0:f1], device=A.device),
        )
        row = torch.repeat_interleave(
            torch.arange(n, device=A.device),
            torch.as_tensor(counts[f0:f1], device=A.device),
        )
        sc = torch.full((n, wmax), num_rows, dtype=torch.long, device=A.device)
        sv = torch.zeros(n, wmax, dtype=A.dtype, device=A.device)
        sc[row, pos] = slot_case[lo:hi].long()
        sv[row, pos] = slot_val[lo:hi].to(A.dtype)
        real = sc != num_rows
        sv = torch.where(real, sv, torch.zeros_like(sv))
        A_slot = A[torch.where(real, sc, torch.zeros_like(sc))]  # [n, W, d]
        e = torch.where(real, A_slot[..., 0], torch.zeros_like(sv))
        v = P[feat_id[f0:f1].long(), 1:]  # [n, k]
        hq = sv[..., None] * (A_slot[..., 1:] - sv[..., None] * v[:, None, :])
        a = sv if use_linear else torch.zeros_like(sv)
        Qq = torch.bmm(hq.transpose(1, 2), hq).reshape(n, k * k)
        G = GG[f0:f1]
        G[:, :T] = Qq[:, tri]
        G[:, T:T + k] = torch.einsum("swi,sw->si", hq, a)
        G[:, T + k:T + 2 * k] = torch.einsum("swi,sw->si", hq, e)
        G[:, T + 2 * k] = (a * a).sum(dim=1)
        G[:, T + 2 * k + 1] = (a * e).sum(dim=1)
        f0 = f1
    return GG[:Fd]


def slot_stats(A, P, feat_off, slot_case, slot_val, feat_id, *,
               use_linear=True, GG=None, pieces=None):
    """GG [Fd, T+2k+2]: one statistics row per feature of a block.

    A [nc, k+1] = [e | Q]; P = [w | V] [n, k+1] (the PRE-draw V);
    feat_off int64 [Fd+1] cuts slot_case int32 / slot_val float32 [E]
    into per-feature slot lists (slots with case == nc are padding and
    contribute nothing); feat_id int32 [Fd] is each feature's global id.
    On the card `pieces` (`Pieces(feat_off, device)`, made once a block)
    is made here when not given. GG may be passed to write into (its
    first Fd rows).
    """
    tensors = [A, P, feat_off, slot_case, slot_val, feat_id]
    if not on_cuda(*tensors):
        return slot_stats_plain(A, P, feat_off, slot_case, slot_val, feat_id,
                                use_linear=use_linear, GG=GG)
    k = P.shape[1] - 1
    Fd = feat_id.shape[0]
    E = slot_case.shape[0]
    check(A, "A", torch.float32, (A.shape[0], k + 1))
    check(P, "P", torch.float32)
    check(feat_off, "feat_off", torch.int64, (Fd + 1,))
    check(slot_case, "slot_case", torch.int32)
    check(slot_val, "slot_val", torch.float32, (E,))
    check(feat_id, "feat_id", torch.int32)
    if GG is None:
        GG = torch.empty(Fd, gg_width(k), dtype=torch.float32, device=A.device)
    if GG.shape[0] < Fd or GG.shape[1] != gg_width(k) or not GG.is_contiguous():
        raise ValueError(f"GG: shape {tuple(GG.shape)} cannot hold {Fd} rows")
    if pieces is None:
        pieces = Pieces(feat_off, A.device)
    check(pieces.order, "order", torch.int32, (pieces.count, 4))
    check(pieces.ticket, "ticket", torch.int32, (Fd,))
    GW4 = -(-gg_width(k) // 4) * 4
    KERNEL.launch(
        ptr(A), ptr(P), ptr(feat_off), ptr(slot_case), ptr(slot_val), ptr(feat_id),
        ptr(pieces.order), ptr(pieces.scratch(GW4)), ptr(pieces.ticket), ptr(GG), Fd,
        pieces.count, PIECE_LEN, k, padded_width(k, min_k=0), A.shape[0], int(use_linear),
    )
    return GG[:Fd]
