"""The cut of a block's per-feature slot lists into pieces, one CTA a
piece, that `slot_stats` (and `coord_draw`'s plan) takes.

A feature's slot list is cut into pieces of at most PIECE_LEN slots, so
that a long list (the Zipf head of a CTR field: a fifth of a block's
cases in one feature) spreads over many CTAs instead of one. A piece of
a feature of several pieces writes its partial row to a scratch row; the
last of the feature's pieces to arrive (an integer ticket after a fence)
adds the partials in piece order, so the sum does not depend on which CTA
finishes last, and sets the ticket back to zero for the next call.
"""

from __future__ import annotations

import numpy as np
import torch

#: slots a CTA sums at most
PIECE_LEN = 2048


class Pieces:
    """A block's cut, made once a block.

    order int32 [count, 4]: every piece as (feature, rank within the
    feature, the feature's first scratch row, the feature's pieces), in
    the order the kernels' CTAs take them: features of many pieces first
    (their last piece also adds the others: the longest chain). Only
    features of several pieces take scratch rows: `rows` of them, and
    their pieces are the first `rows` of `order`. The ticket, one int a
    feature, is zero between calls; the scratch is allocated at its first
    use and kept. `piece_len` (PIECE_LEN unless a kernel takes shorter
    pieces) is the most slots a piece holds."""

    def __init__(self, feat_off, device, piece_len: int = PIECE_LEN):
        off = feat_off.cpu().numpy() if torch.is_tensor(feat_off) else np.asarray(feat_off)
        self.piece_len = piece_len
        per = np.maximum(1, -(-np.diff(off) // piece_len))
        multi = np.where(per > 1, per, 0)
        base = np.cumsum(multi) - multi
        feats = np.argsort(-per, kind="stable")
        f = np.repeat(feats, per[feats])
        rank = np.arange(len(f)) - np.repeat(np.cumsum(per[feats]) - per[feats], per[feats])
        order = np.stack([f, rank, base[f], per[f]], axis=1).astype(np.int32)
        self.order = torch.as_tensor(order, device=device)
        self.count = len(order)
        self.rows = int(multi.sum())
        self.ticket = torch.zeros(len(per), dtype=torch.int32, device=device)
        self._scratch = {}

    def scratch(self, floats_a_row: int) -> torch.Tensor:
        """The kernel's scratch: `rows` rows of `floats_a_row` floats
        (at least one row, so that its pointer is real)."""
        if floats_a_row not in self._scratch:
            self._scratch[floats_a_row] = torch.empty(
                max(self.rows, 1) * floats_a_row, dtype=torch.float32,
                device=self.ticket.device)
        return self._scratch[floats_a_row]
