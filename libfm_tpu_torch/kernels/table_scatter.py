"""table_scatter: sorted row scatter-add into a table, in place. CUDA
source: csrc/table_scatter.cu.

Replaces the Pallas probes studies/probes/pallas_scatter.py:35 (P4) and
studies/pallas_gather.py:112 (P2), and the SGD step's scatter
`P.at[sids].add(upd[perm], indices_are_sorted=True)`
(libfm_tpu/learners/sgd.py:157,212).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr

KERNEL = Kernel(
    "table_scatter", "table_scatter_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong],
)
_WINDOW = 8  # the fewest sorted positions of a window (csrc: kWideWin)
_NARROW = 16  # the widest table whose windows the longest run sizes (csrc)
#: the longest run for which tables up to 16 wide take windows of one
#: round, 32 sorted positions (csrc: kLongRun); longer runs take the long
#: form's windows, which tables 17 to 24 wide always take
LONG_RUN = 4096
_GENERATIONS = 2**31 - 1  # a flag holds the generation of the call that set it


class ScatterScratch:
    """The scratch of `table_scatter` for calls of up to E entries of width
    W on one stream: a flag and a W-float piece per window of 8 sorted
    positions, and the count of calls made on it (each call stamps its
    flags with its own count, so the flags are never reset). Allocate it
    once and pass it to every call."""

    def __init__(self, E: int, W: int, device):
        nwin = max(1, -(-E // _WINDOW))
        self.flags = torch.zeros(nwin, dtype=torch.int32, device=device)
        self.pieces = torch.empty(nwin * W, dtype=torch.float32, device=device)
        self.calls = 0

    def next_generation(self) -> int:
        self.calls += 1
        if self.calls == _GENERATIONS:  # no flag may keep a later call's count
            self.flags.zero_()
            self.calls = 1
        return self.calls


def longest_runs(sids) -> np.ndarray:
    """The longest run of equal ids in each row of sorted ids [..., E] (a
    numpy array or a tensor, copied to the host): `table_scatter`'s
    `max_run`. Returns an int64 array of shape sids.shape[:-1]."""
    s = sids.cpu().numpy() if isinstance(sids, torch.Tensor) else np.asarray(sids)
    rows = s.reshape(-1, s.shape[-1])
    out = np.zeros(rows.shape[0], np.int64)
    for i, row in enumerate(rows):
        if row.size:
            edges = np.concatenate(([0], np.flatnonzero(row[1:] != row[:-1]) + 1, [row.size]))
            out[i] = np.diff(edges).max()
    return out.reshape(s.shape[:-1])


def _run_sums(sids, rows):
    """(ids, sums): each run of equal ids in the sorted `sids` and the sum
    of its rows, added pairwise in entry order (neighbours first, then
    neighbouring pairs, ...): a fixed order, with no atomics."""
    ids = sids.long()
    while ids.shape[0] > 1:
        E = ids.shape[0]
        new = torch.ones(E, dtype=torch.bool, device=ids.device)
        new[1:] = ids[1:] != ids[:-1]
        starts = torch.nonzero(new).squeeze(1)
        if starts.shape[0] == E:
            break
        at = torch.arange(E, device=ids.device)
        rank = at - starts[torch.cumsum(new, 0) - 1]
        keep = torch.nonzero(rank % 2 == 0).squeeze(1)
        partner = (keep + 1).clamp(max=E - 1)
        paired = (partner != keep) & (ids[partner] == ids[keep])
        rows = rows[keep] + torch.where(paired[:, None], rows[partner],
                                        torch.zeros((), device=rows.device))
        ids = ids[keep]
    return ids, rows


def table_scatter_plain(T, sids, perm, upd, scratch=None, max_run=None):
    """The plain PyTorch version; same contract as `table_scatter`. Every
    sum is taken in a fixed order: on the CPU `index_add_` adds each row
    in entry order; on a CUDA device, whose `index_add_` adds with atomics
    in an order that changes from run to run, each run's rows are summed
    pairwise in entry order (`_run_sums`) and added to T once."""
    rows = upd if perm is None else upd[perm.long()]
    if T.device.type == "cpu":
        return T.index_add_(0, sids.long(), rows)
    ids, sums = _run_sums(sids, rows)
    return T.index_add_(0, ids, sums)


def table_scatter(T, sids, perm, upd, scratch=None, max_run=None):
    """T[sids[j]] += upd[perm[j]] for every sorted position j, in place;
    returns T.

    T [n, W] float32; sids [E] int32 ascending (equal ids adjacent); perm
    [E] int32, the row of upd [*, W] that position j adds, or None when
    upd [E, W] is already in sorted order (row j is position j's).
    `scratch` is a `ScatterScratch` for at least E entries of width W
    (allocated here when None). `max_run` is the longest run of equal ids
    in sids (`longest_runs`); at W <= 16 it sizes the kernel's windows
    (any value gives a right sum), and when None it is computed here,
    which copies sids to the host: a caller in a loop passes it. Every sum is taken in an order fixed by the
    positions and the windows (deterministic, no floating-point atomics);
    a run of equal ids is summed by a segmented scan and added to its row
    once."""
    tensors = [t for t in (T, sids, perm, upd) if t is not None]
    if scratch is not None:
        tensors += [scratch.flags, scratch.pieces]
    if not on_cuda(*tensors):
        return table_scatter_plain(T, sids, perm, upd)
    E = sids.shape[0]
    W = T.shape[1]
    check(T, "T", torch.float32)
    check(sids, "sids", torch.int32, (E,))
    if perm is not None:
        check(perm, "perm", torch.int32, (E,))
    check(upd, "upd", torch.float32)
    if upd.dim() != 2 or upd.shape[1] != W or (perm is None and upd.shape[0] != E):
        raise ValueError(f"upd: shape {tuple(upd.shape)}, expected "
                         f"[{'*' if perm is not None else E}, {W}]")
    if E == 0:
        return T
    if scratch is None:
        scratch = ScatterScratch(E, W, T.device)
    nwin = -(-E // _WINDOW)
    if scratch.flags.numel() < nwin or scratch.pieces.numel() < nwin * W:
        raise ValueError(f"scratch for {scratch.flags.numel()} windows of width "
                         f"{scratch.pieces.numel() // scratch.flags.numel()}: {E} "
                         f"entries of width {W} need {nwin} windows")
    if max_run is None:
        max_run = int(longest_runs(sids)) if W <= _NARROW else 0
    KERNEL.launch(ptr(T), ptr(sids), ptr(perm), ptr(upd), ptr(scratch.flags),
                  ptr(scratch.pieces), scratch.flags.numel(), scratch.pieces.numel(),
                  scratch.next_generation(), E, W, int(max_run))
    return T
