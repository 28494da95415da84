"""Bucketed slot layout for the vector-sweep (joint-draw) engine (numpy).

The port's copy of `libfm_tpu.data.vector_layout`. For one conflict-free
feature block, entries are sorted by feature and each feature's entry
list is cut into SEGMENTS of a width W from `widths` (large features
span several segments); when the block's feature counts are uniform
enough, every feature gets ONE segment of a common width instead
("whole-feature" mode). Per width bucket: `slot_case[nseg, W]` (train
row, sentinel `num_rows` at padding), `slot_val[nseg, W]` (0 at padding)
and `seg_feat[nseg]` (the block-local feature of each segment, sorted).
Real slots always fill a segment from the left.

The port's learner does not read this layout: its kernels take one
ragged slot list per feature (`batching.feature_slots`), which needs no
widths and no padding. What it needs of the layout is which features
the JAX engine draws through the dual (Woodbury) system: a feature whose
ONE segment holds it whole, of a width W < d and W <= 64.
`single_segment_widths` gives that width from the feature counts alone,
without building the padded slot arrays; `build_block_layout`, held
exactly against the JAX package's, is the reference it is tested
against. `slab_partition` (case-sorted slab gathers) is not ported
(ROADMAP M7).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class WidthBucket:
    width: int
    slot_case: np.ndarray  # int32 [nseg, W] (sentinel = num_rows)
    slot_val: np.ndarray  # float32 [nseg, W]
    seg_feat: np.ndarray  # int32 [nseg] — index into the block's features
    seg_whole: np.ndarray = None  # bool [nseg] — segment holds the WHOLE feature
    unique_feats: bool = False  # one segment PER feature, in feature order


@dataclass
class VectorBlockLayout:
    """One conflict-free block, bucketed for the vector sweep."""

    features: np.ndarray  # int32 [F] global feature ids
    groups: np.ndarray  # int32 [F]
    buckets: list  # list[WidthBucket]
    num_features: int  # F


def build_block_layout(
    features: np.ndarray,
    entry_rows: np.ndarray,
    entry_vals: np.ndarray,
    entry_feat: np.ndarray,  # position 0..F-1 within `features`
    groups: np.ndarray,
    num_rows: int,
    widths: tuple = (32, 256),
) -> VectorBlockLayout:
    F = len(features)
    order = np.argsort(entry_feat, kind="stable")
    ef = entry_feat[order]
    er = entry_rows[order]
    ev = entry_vals[order]
    counts = np.bincount(ef, minlength=F)
    starts = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    # whole-feature mode: one segment per feature of a common width, when
    # that costs at most 1.5x the real slots
    W_whole = max(8, int(-(-int(counts.max()) // 8)) * 8) if F else 8
    total = int(counts.sum())
    if F > 0 and total > 0 and W_whole <= 4096 and F * W_whole <= 1.5 * total:
        slot_case = np.full((F, W_whole), num_rows, dtype=np.int32)
        slot_val = np.zeros((F, W_whole), dtype=np.float32)
        within = np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], counts)
        rows_ix = np.repeat(np.arange(F, dtype=np.int64), counts)
        slot_case[rows_ix, within] = er
        slot_val[rows_ix, within] = ev
        return VectorBlockLayout(
            features=np.asarray(features, dtype=np.int32),
            groups=np.asarray(groups, dtype=np.int32),
            buckets=[
                WidthBucket(
                    W_whole, slot_case, slot_val,
                    np.arange(F, dtype=np.int32),
                    np.ones(F, dtype=bool),
                    unique_feats=True,
                )
            ],
            num_features=F,
        )

    # Chunk each feature's entry list, fewest padded slots first and
    # fewest segments second: full chunks take the largest width <= the
    # remaining count; a tail becomes ONE rounded-up segment whenever that
    # wastes no more slots than chopping it. Vectorised over features by
    # walking the width ladder from the largest width down.
    per_bucket: dict[int, list] = {w: [] for w in widths}
    desc = sorted(widths, reverse=True)
    rem = counts.astype(np.int64).copy()
    lo_now = starts[:-1].copy()
    feat_ids = np.arange(F, dtype=np.int64)
    for li, w in enumerate(desc):
        n_full = rem // w
        tail = rem - n_full * w
        smaller = desc[li + 1] if li + 1 < len(desc) else None
        absorb = tail > 0 if smaller is None else tail > (w - smaller)
        n_seg = n_full + absorb.astype(np.int64)
        has = n_seg > 0
        if has.any():
            js = feat_ids[has]
            reps = n_seg[has]
            seg_feat_w = np.repeat(js, reps)
            seg_idx = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(reps)[:-1]]), reps
            )
            seg_lo = np.repeat(lo_now[has], reps) + w * seg_idx
            last_of_feat = np.repeat((lo_now + n_full * w + tail)[has], reps)
            seg_hi = np.minimum(seg_lo + w, last_of_feat)
            per_bucket[w] = list(zip(seg_feat_w, seg_lo, seg_hi))
        consumed = n_full * w + np.where(absorb, tail, 0)
        lo_now = lo_now + consumed
        rem = rem - consumed

    buckets = []
    for w in widths:
        segs = per_bucket[w]
        if not segs:
            continue
        seg_feat_w, seg_lo, seg_hi = (
            np.asarray(x, dtype=np.int64) for x in zip(*segs)
        )
        order2 = np.argsort(seg_feat_w, kind="stable")
        seg_feat_w, seg_lo, seg_hi = (
            seg_feat_w[order2], seg_lo[order2], seg_hi[order2]
        )
        nseg = len(seg_feat_w)
        seg_len = seg_hi - seg_lo
        total = int(seg_len.sum())
        slot_case = np.full((nseg, w), num_rows, dtype=np.int32)
        slot_val = np.zeros((nseg, w), dtype=np.float32)
        prefix = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
        within = np.arange(total, dtype=np.int64) - np.repeat(prefix, seg_len)
        src = np.repeat(seg_lo, seg_len) + within
        dst_row = np.repeat(np.arange(nseg, dtype=np.int64), seg_len)
        slot_case[dst_row, within] = er[src]
        slot_val[dst_row, within] = ev[src]
        buckets.append(
            WidthBucket(
                w, slot_case, slot_val, seg_feat_w.astype(np.int32),
                seg_len == counts[seg_feat_w],
            )
        )

    return VectorBlockLayout(
        features=np.asarray(features, dtype=np.int32),
        groups=np.asarray(groups, dtype=np.int32),
        buckets=buckets,
        num_features=F,
    )


def single_segment_widths(counts: np.ndarray, widths: tuple = (32, 256)) -> np.ndarray:
    """Per feature of a block with entry counts `counts` [F] (each >= 1),
    the width of the one segment `build_block_layout` gives it when that
    segment holds the whole feature, else 0 (the feature spans several
    segments). Follows build_block_layout's two modes: whole-feature
    mode gives every feature one segment of the common width; the width
    ladder counts a feature's segments without cutting them."""
    counts = np.asarray(counts, dtype=np.int64)
    F = len(counts)
    out = np.zeros(F, dtype=np.int64)
    total = int(counts.sum())
    if F == 0 or total == 0:
        return out
    W_whole = max(8, int(-(-int(counts.max()) // 8)) * 8)
    if W_whole <= 4096 and F * W_whole <= 1.5 * total:
        out[:] = W_whole
        return out
    desc = sorted(widths, reverse=True)
    rem = counts.copy()
    nseg = np.zeros(F, dtype=np.int64)
    for li, w in enumerate(desc):
        n_full = rem // w
        tail = rem - n_full * w
        smaller = desc[li + 1] if li + 1 < len(desc) else None
        absorb = tail > 0 if smaller is None else tail > (w - smaller)
        n_seg = n_full + absorb.astype(np.int64)
        out = np.where(n_seg > 0, w, out)
        nseg += n_seg
        rem = rem - (n_full * w + np.where(absorb, tail, 0))
    return np.where(nseg == 1, out, 0)


def padded_rows_layout(indptr, cols, vals, align: int = 1):
    """Padded [num_rows, L] (ids, vals) arrays for dense per-case passes
    (prediction / e-refresh); padding uses id 0 with value 0."""
    lengths = np.diff(indptr).astype(np.int64)
    n = len(lengths)
    L = max(1, int(lengths.max()) if n else 1)
    L = ((L + align - 1) // align) * align
    ids = np.zeros((n, L), dtype=np.int32)
    vs = np.zeros((n, L), dtype=np.float32)
    row = np.repeat(np.arange(n, dtype=np.int64), lengths)
    offs = np.arange(int(indptr[-1]), dtype=np.int64) - np.repeat(
        indptr[:-1], lengths
    )
    ids[row, offs] = cols
    vs[row, offs] = vals
    return ids, vs
