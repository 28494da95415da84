"""rel_scores and rel_refresh: the relational (BS) engine's block scores
and the FM forward over joined block rows. CUDA source: csrc/rel_refresh.cu.

Replace, in libfm_tpu/learners/mcmc_rel_vector.py, `_rel_scores` (the
per-block-row scores of one relation), `_chunk_pred` with the regression
branch of `refresh_A_and_train_metric`, its test-tail `te_chunk` and
`predict_test` (K12, the relation half): with an empty main table every
case's FM forward is a sum of its joined block rows' scores.

A score table SC [nb+1, k+2] holds per block row b of a relation
[qB (k) | sqB | linB]: qB = sum x V[col], sqB = sum x^2 |V[col]|^2,
linB = sum x w[col] over b's design entries; row nb (the sentinel) is 0.
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.ops.segment import sorted_index_add_

SCORES = Kernel(
    "rel_scores", "rel_scores_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3,
)
REFRESH = Kernel(
    "rel_refresh", "rel_refresh_launch",
    [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_float, ctypes.c_int],
)
#: length of the train mode's per-CTA error partials (the kernel's grid is
#: at most this; it writes 0 past its grid, so the sum is over a fixed length)
_PARTS = 4096


def rel_scores_plain(P, indptr, cols, vals, *, use_linear=True):
    """The plain PyTorch version; same contract as `rel_scores`."""
    nb = indptr.shape[0] - 1
    k = P.shape[1] - 1
    rows = torch.repeat_interleave(torch.arange(nb, device=P.device),
                                   indptr[1:] - indptr[:-1], output_size=cols.shape[0])
    c = cols.long()
    vx = P[c, 1:] * vals[:, None]
    lin = P[c, :1] * vals[:, None] if use_linear else torch.zeros_like(vals)[:, None]
    SC = torch.zeros(nb + 1, k + 2, dtype=P.dtype, device=P.device)
    return sorted_index_add_(SC, rows, torch.cat([vx, (vx * vx).sum(dim=1, keepdim=True),
                                                  lin], dim=1))


def rel_scores(P, indptr, cols, vals, *, use_linear=True):
    """SC [nb+1, k+2]: one relation's block scores [qB | sqB | linB] from
    P = [w | V] [n, k+1] and its design matrix in CSR by block row
    (indptr int64 [nb+1], cols int32 global feature ids, vals float32);
    the sentinel row nb is 0 (linB is 0 without the linear term)."""
    if not on_cuda(P, indptr, cols, vals):
        return rel_scores_plain(P, indptr, cols, vals, use_linear=use_linear)
    nb = indptr.shape[0] - 1
    k = P.shape[1] - 1
    check(P, "P", torch.float32)
    check(indptr, "indptr", torch.int64, (nb + 1,))
    check(cols, "cols", torch.int32)
    check(vals, "vals", torch.float32, cols.shape)
    if not 1 <= k <= 128:
        raise ValueError(f"k={k}: the CUDA kernels take 1 <= k <= 128")
    SC = torch.empty(nb + 1, k + 2, dtype=torch.float32, device=P.device)
    SCORES.launch(ptr(P), ptr(indptr), ptr(cols), ptr(vals), ptr(SC), nb, k,
                  int(use_linear))
    return SC


def rel_refresh_plain(SC, maps, w0, A, y=None, *, use_linear=True, use_bias=True,
                      min_target=0.0, max_target=0.0):
    """The plain PyTorch version; same contract as `rel_refresh`."""
    k = SC.shape[1] - 2
    nc = maps.shape[1]
    Q = torch.zeros(nc, k, dtype=SC.dtype, device=SC.device)
    sq = torch.zeros(nc, dtype=SC.dtype, device=SC.device)
    lin = torch.zeros(nc, dtype=SC.dtype, device=SC.device)
    for m in maps.long():
        g = SC[m]
        Q = Q + g[:, :k]
        sq = sq + g[:, k]
        lin = lin + g[:, k + 1]
    pred = 0.5 * ((Q * Q).sum(dim=1) - sq)
    if use_linear:
        pred = pred + lin
    if use_bias:
        pred = pred + w0
    A[:, 1:] = Q
    if y is None:
        A[:, 0] = pred
        return None
    A[:, 0] = pred - y
    err = pred.clamp(min_target, max_target) - y
    return (err * err).sum()


def rel_refresh(SC, maps, w0, A, y=None, *, use_linear=True, use_bias=True,
                min_target=0.0, max_target=0.0):
    """The FM forward of cases joined to block rows, from the score tables
    of every relation stacked in SC [rows, k+2] (`rel_scores`' tables, one
    under the other) and maps int32 [R, nc]: case c's row in SC for each
    relation (its join map plus that relation's first row in SC). Per case
    Q = sum_r qB, pred = 1/2 (|Q|^2 - sum_r sqB) + sum_r linB + w0.

    Train mode (y [nc] given): writes A [nc, k+1] = [pred - y | Q] and
    returns the squared error of the predictions clipped to
    [min_target, max_target], summed (0-dim tensor).
    Tail mode (y None): writes A = [pred | Q] and returns None.
    """
    tensors = [SC, maps, w0, A] + ([y] if y is not None else [])
    if not on_cuda(*tensors):
        return rel_refresh_plain(SC, maps, w0, A, y, use_linear=use_linear,
                                 use_bias=use_bias, min_target=min_target,
                                 max_target=max_target)
    R, nc = maps.shape
    k = SC.shape[1] - 2
    check(SC, "SC", torch.float32)
    check(maps, "maps", torch.int32)
    check(w0, "w0", torch.float32, ())
    check(A, "A", torch.float32, (nc, k + 1))
    if y is not None:
        check(y, "y", torch.float32, (nc,))
    if not 1 <= k <= 128:
        raise ValueError(f"k={k}: the CUDA kernels take 1 <= k <= 128")
    part = torch.empty(_PARTS, dtype=torch.float32, device=SC.device) if y is not None else None
    if nc == 0:
        return None if y is None else torch.zeros((), dtype=torch.float32, device=SC.device)
    REFRESH.launch(ptr(SC), ptr(maps), ptr(w0), ptr(y), ptr(A), ptr(part), nc, R, k,
                   int(use_linear), int(use_bias), float(min_target), float(max_target),
                   _PARTS)
    return None if y is None else part.sum()
