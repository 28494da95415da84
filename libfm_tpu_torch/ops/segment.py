"""Segment sums (PyTorch)."""

from __future__ import annotations

import numpy as np
import torch

#: rows a first-level chunk of `GroupSums` adds
GROUP_CHUNK = 256


def seg_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """out[s] = sum of data[i] over segment_ids[i] == s, along dim 0."""
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
        device=data.device,
    )
    return out.index_add_(0, segment_ids.long(), data)


class GroupSums:
    """Per-group sums of rows in a fixed order: the same order on every
    run and on every device, with no float atomics and no host
    synchronisation. Made once from the host's group ids `group_np` [n]
    (ids in [0, num_groups), in any order; a group may hold no row).

    The set-up sorts the rows by group (a stable argsort; `perm`, and the
    groups' `offsets` into it) and cuts each group's run into chunks of
    `chunk` rows, padded with slots that add nothing. A call gathers
    every chunk's rows and sums them (`.sum(dim=1)`), then gathers each
    group's chunk sums the same way and sums those. `ids` (long [n]) and
    `count` (float32 [G], the rows of each group) are the group ids and
    counts on the device."""

    def __init__(self, group_np, num_groups: int, device, chunk: int = GROUP_CHUNK):
        g = np.asarray(group_np, dtype=np.int64)
        n = len(g)
        self.num_groups = G = int(num_groups)
        counts = np.bincount(g, minlength=G)
        if len(counts) > G:
            raise ValueError(f"a group id >= num_groups = {G}")
        self.perm = np.argsort(g, kind="stable")
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        per = -(-counts // chunk)  # chunks of each group (0 for an empty group)
        nch = int(per.sum())
        # first level: chunk c of group h holds sorted rows
        # offsets[h] + chunk * (c - first[h]) + [0, chunk), to the group's end
        first = np.cumsum(per) - per
        grp = np.repeat(np.arange(G), per)
        start = self.offsets[grp] + chunk * (np.arange(nch) - first[grp])
        pos = start[:, None] + np.arange(chunk)[None, :]
        valid = pos < self.offsets[grp + 1][:, None]
        rows = np.where(valid, self.perm[np.minimum(pos, max(n - 1, 0))], 0)
        # second level: group h's chunk sums, padded with chunk nch (a zero row)
        width = max(int(per.max(initial=0)), 1)
        at = first[:, None] + np.arange(width)[None, :]
        idx2 = np.where(np.arange(width)[None, :] < per[:, None], at, nch)
        self.rows = torch.as_tensor(rows, dtype=torch.long, device=device)
        self.valid = torch.as_tensor(valid, device=device)
        self.idx2 = torch.as_tensor(idx2, dtype=torch.long, device=device)
        self.ids = torch.as_tensor(g, dtype=torch.long, device=device)
        self.count = torch.as_tensor(counts.astype(np.float32), device=device)
        self.n = n

    def __call__(self, x):
        """out[h] = the sum of x[i] over the rows i of group h, along dim
        0 of x [n, ...]; [G, ...]."""
        flat = x.reshape(self.n, -1)
        m = flat.shape[1]
        rows = flat[self.rows]  # [chunks, chunk, m]
        rows = torch.where(self.valid[:, :, None], rows, torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))
        part = torch.cat([rows.sum(dim=1), torch.zeros(1, m, dtype=x.dtype, device=x.device)])
        return part[self.idx2].sum(dim=1).reshape((self.num_groups,) + tuple(x.shape[1:]))


def run_sums(sids, rows):
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
        paired = paired.view(-1, *([1] * (rows.dim() - 1)))
        rows = rows[keep] + torch.where(paired, rows[partner],
                                        torch.zeros((), device=rows.device, dtype=rows.dtype))
        ids = ids[keep]
    return ids, rows


def sorted_index_add_(out, sids, rows):
    """out[sids[i]] += rows[i] along dim 0, in place, for ascending `sids`;
    returns out. Every sum is taken in a fixed order: on the CPU
    `index_add_` adds each row in entry order; on a CUDA device, whose
    `index_add_` adds with float atomics in an order that changes from run
    to run, each run's rows are summed pairwise in entry order (`run_sums`)
    and added to `out` once."""
    if out.device.type == "cpu":
        return out.index_add_(0, sids.long(), rows)
    ids, sums = run_sums(sids, rows)
    return out.index_add_(0, ids, sums)
