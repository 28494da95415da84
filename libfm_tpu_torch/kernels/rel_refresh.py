"""rel_scores and rel_refresh: the relational (BS) engine's block scores
and the FM forward over joined block rows. CUDA source: csrc/rel_refresh.cu.

Replace, in libfm_tpu/learners/mcmc_rel_vector.py, `_rel_scores` (the
per-block-row scores of one relation), `_chunk_pred` with both branches
of `refresh_A_and_train_metric` (regression and probit), its test-tail
`te_chunk` and `predict_test` (K12): every case's FM forward is a sum of
its main-table entries' terms and its joined block rows' scores.

A score table SC [nb+1, k+2] holds per block row b of a relation
[qB (k) | sqB | linB]: qB = sum x V[col], sqB = sum x^2 |V[col]|^2,
linB = sum x w[col] over b's design entries; row nb (the sentinel) is 0.

rel_refresh's kernel takes the cases in tiles of TILE a warp, a CTA's
warps sized by shared memory (`refresh_plan`): each warp's two stages of
the tile's indices and, with A, the tile's rows of A.
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.kernels.fm_refresh import PROBIT_MODES, write_train_rows
from libfm_tpu_torch.ops.segment import sorted_index_add_

SCORES = Kernel(
    "rel_scores", "rel_scores_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3,
)
_REFRESH_ARGS = ([ctypes.c_void_p] * 12
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int])
REFRESH = Kernel("rel_refresh", "rel_refresh_launch", _REFRESH_ARGS)
#: the same entry point in its probit train mode, counted apart
PROBIT_REFRESH = Kernel("rel_refresh_probit", "rel_refresh_launch", _REFRESH_ARGS)
#: length of the train mode's per-CTA error partials (the kernel's grid is
#: at most this; it writes 0 past its grid, so the sum is over a fixed length)
_PARTS = 4096
TILE = 32  # cases a warp takes at once (csrc: kTile)
MAX_WARPS = 8  # a CTA's warps at most (csrc: kMaxWarps)
STAGE_L = 16  # main entries a case the stages hold at most (csrc: kStageL)
#: a CTA's dynamic shared memory at most (csrc: kSmemDynamic), below the
#: H100's 227 KB a CTA by a margin for the static part
SMEM_DYNAMIC = 232_448 - 1_024


def warp_bytes(k: int, R: int, L: int, has_A: bool) -> int:
    """A rel_refresh warp's dynamic shared memory (csrc:
    `rel_refresh_warp_bytes`): two stages of a tile's maps [R][TILE], main
    ids and values [TILE L] each (up to STAGE_L entries; longer rows are
    read from global memory), y and U, each a whole number of 16-byte
    pieces; with A, the tile's rows [TILE (k+1)] and 4 floats for A's
    offset within 16 bytes."""
    staged = 0 < L <= STAGE_L
    stage = -(-TILE * (R + 2 + (2 * L if staged else 0)) // 4) * 4
    tile = TILE * (k + 1) + 4 if has_A else 0
    return 4 * (2 * stage + tile)


def refresh_plan(k: int, R: int, L: int, has_A: bool) -> int:
    """A rel_refresh CTA's warps at k factors, R relations, L main entries
    a case: as many, up to MAX_WARPS, as SMEM_DYNAMIC holds."""
    warps = min(MAX_WARPS, SMEM_DYNAMIC // warp_bytes(k, R, L, has_A))
    if warps < 1:
        raise ValueError(f"rel_refresh: a warp's stages for R={R} relations do not fit "
                         f"a CTA's shared memory")
    return warps


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


def rel_refresh_plain(SC, maps, w0, A=None, y=None, *, P=None, ids=None, vals=None,
                      use_linear=True, use_bias=True, min_target=0.0, max_target=0.0,
                      probit=None, U=None, latent=None):
    """The plain PyTorch version; same contract as `rel_refresh`."""
    k = SC.shape[1] - 2
    nc = maps.shape[1] if ids is None else ids.shape[0]
    Q = torch.zeros(nc, k, dtype=SC.dtype, device=SC.device)
    sq = torch.zeros(nc, dtype=SC.dtype, device=SC.device)
    lin = torch.zeros(nc, dtype=SC.dtype, device=SC.device)
    if ids is not None:  # the main entries first, as the JAX engine's _chunk_pred
        rows = P[ids.long()]  # [nc, L, k+1]
        vx = rows[..., 1:] * vals[..., None]
        Q = vx.sum(dim=1)
        sq = (vx * vx).sum(dim=(1, 2))
        lin = (rows[..., 0] * vals).sum(dim=1)
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
    if A is None:
        return pred
    if y is None:
        A[:, 0] = pred
        A[:, 1:] = Q
        return None
    return write_train_rows(A, pred, Q, y, min_target, max_target, probit, U, latent)


def rel_refresh(SC, maps, w0, A=None, y=None, *, P=None, ids=None, vals=None,
                use_linear=True, use_bias=True, min_target=0.0, max_target=0.0,
                probit=None, U=None, latent=None):
    """The FM forward of cases joined to block rows, from the score tables
    of every relation stacked in SC [rows, k+2] (`rel_scores`' tables, one
    under the other) and maps int32 [R, nc]: case c's row in SC for each
    relation (its join map plus that relation's first row in SC); with a
    main table also the case's own entries, padded rows ids int32 and vals
    float32 [nc, L] (padding: value 0) into P = [w | V] [n, k+1]. Per case
    Q = sum_l x_l V[id_l] + sum_r qB_r,
    pred = 1/2 (|Q|^2 - sum_l x_l^2 |V[id_l]|^2 - sum_r sqB_r)
           + sum_l x_l w[id_l] + sum_r linB_r + w0.

    Train mode (A [nc, k+1] and y [nc] given): writes A = [pred - y | Q]
    and returns the squared error of the predictions clipped to
    [min_target, max_target], summed (0-dim tensor).
    Probit train mode (classification; `probit` "sample" with uniforms
    U [nc] in [0, 1), or "mean"): each case's latent is a draw of
    N(pred, 1) truncated to [0, inf) where y >= 0 and to (-inf, 0] where
    y < 0, or that truncated normal's expectation; writes latent [nc] and
    A = [pred - latent | Q] and returns the number of cases with
    Phi(pred) >= 0.5 and y > 0 or Phi(pred) < 0.5 and y < 0 (0-dim
    tensor). It counts its launches apart, as `rel_refresh_probit`.
    Tail mode (A given, y None): writes A = [pred | Q] and returns None.
    Test mode (A and y None): returns pred [nc].
    """
    if probit is not None and (probit not in PROBIT_MODES or y is None or A is None
                               or latent is None or (probit == "sample") != (U is not None)):
        raise ValueError(f"probit={probit!r} needs A, y, latent and (sampling) U")
    if y is not None and A is None:
        raise ValueError("train mode (y given) needs A")
    if (ids is None) != (vals is None) or (ids is not None and P is None):
        raise ValueError("main rows need P, ids and vals")
    tensors = [SC, maps, w0] + [t for t in (A, y, P, ids, vals, U, latent) if t is not None]
    if not on_cuda(*tensors):
        return rel_refresh_plain(SC, maps, w0, A, y, P=P, ids=ids, vals=vals,
                                 use_linear=use_linear, use_bias=use_bias,
                                 min_target=min_target, max_target=max_target,
                                 probit=probit, U=U, latent=latent)
    R = maps.shape[0]
    nc = maps.shape[1] if ids is None else ids.shape[0]
    L = 0 if ids is None else ids.shape[1]
    k = SC.shape[1] - 2
    check(SC, "SC", torch.float32)
    check(maps, "maps", torch.int32, (R, nc))
    check(w0, "w0", torch.float32, ())
    if A is not None:
        check(A, "A", torch.float32, (nc, k + 1))
    if y is not None:
        check(y, "y", torch.float32, (nc,))
    if ids is not None:
        check(P, "P", torch.float32, (P.shape[0], k + 1))
        check(ids, "ids", torch.int32)
        check(vals, "vals", torch.float32, (nc, L))
    if probit is not None:
        check(latent, "latent", torch.float32, (nc,))
        if U is not None:
            check(U, "U", torch.float32, (nc,))
    if not 1 <= k <= 128:
        raise ValueError(f"k={k}: the CUDA kernels take 1 <= k <= 128")
    pred = None if A is not None else torch.empty(nc, dtype=torch.float32,
                                                  device=SC.device)
    if nc == 0:
        return (pred if A is None else None if y is None
                else torch.zeros((), dtype=torch.float32, device=SC.device))
    part = torch.empty(_PARTS, dtype=torch.float32, device=SC.device) if y is not None else None
    (REFRESH if probit is None else PROBIT_REFRESH).launch(
        ptr(SC), ptr(maps), ptr(w0), ptr(y), ptr(A), ptr(pred), ptr(part), ptr(P),
        ptr(ids), ptr(vals), ptr(U), ptr(latent), nc, R, L, k, int(use_linear),
        int(use_bias), float(min_target), float(max_target), _PARTS,
        PROBIT_MODES.get(probit, 0), refresh_plan(k, R, L, A is not None))
    return pred if A is None else None if y is None else part.sum()
