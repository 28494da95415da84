"""table_scatter: sorted row scatter-add into a table, in place. CUDA
source: csrc/table_scatter.cu.

Replaces the Pallas probes studies/probes/pallas_scatter.py:35 (P4) and
studies/pallas_gather.py:112 (P2), and the SGD step's scatter
`P.at[sids].add(upd[perm], indices_are_sorted=True)`
(libfm_tpu/learners/sgd.py:157,212).
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr

KERNEL = Kernel(
    "table_scatter", "table_scatter_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
)
_WARPS_PER_BLOCK = 8
_WINDOW = 8  # sorted positions a warp owns in pass 1 (kWindow in the source)
_MAX_GRID = 132 * 16


def table_scatter_plain(T, sids, perm, upd):
    """The plain PyTorch version; same contract as `table_scatter`."""
    return T.index_add_(0, sids.long(), upd[perm.long()])


def table_scatter(T, sids, perm, upd):
    """T[sids[j]] += upd[perm[j]] for every sorted position j, in place;
    returns T.

    T [n, W] float32; sids [E] int32 ascending (equal ids adjacent); perm
    [E] int32, the row of upd [*, W] that position j adds. Every sum is
    taken in a fixed order (deterministic, no atomics): a short run is
    added to its row one update after the other, as a sequential scatter
    adds it; a long one in pieces of up to 8 sorted positions."""
    if not on_cuda(T, sids, perm, upd):
        return table_scatter_plain(T, sids, perm, upd)
    E = sids.shape[0]
    W = T.shape[1]
    check(T, "T", torch.float32)
    check(sids, "sids", torch.int32, (E,))
    check(perm, "perm", torch.int32, (E,))
    check(upd, "upd", torch.float32)
    if upd.dim() != 2 or upd.shape[1] != W:
        raise ValueError(f"upd: shape {tuple(upd.shape)}, expected [*, {W}]")
    if E == 0:
        return T
    nwin = -(-E // _WINDOW)
    grid = max(1, min(_MAX_GRID, -(-nwin // _WARPS_PER_BLOCK)))
    head = torch.empty(nwin, W, dtype=torch.float32, device=T.device)
    tail = torch.empty(nwin, W, dtype=torch.float32, device=T.device)
    flags = torch.empty(2, nwin, dtype=torch.int32, device=T.device)
    KERNEL.launch(ptr(T), ptr(sids), ptr(perm), ptr(upd), ptr(head), ptr(tail),
                  ptr(flags[0]), ptr(flags[1]), E, W, grid)
    return T
