"""Segment sums (PyTorch)."""

from __future__ import annotations

import torch


def seg_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """out[s] = sum of data[i] over segment_ids[i] == s, along dim 0."""
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
        device=data.device,
    )
    return out.index_add_(0, segment_ids.long(), data)


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
