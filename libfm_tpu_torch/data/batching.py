"""Batch layouts (numpy): padded mini-batches for SGD, conflict-free
feature blocks for the ALS/MCMC sweeps.

The port's copy of `libfm_tpu.data.batching`:

1. `BatchedCSR` / `batch_dataset` — padded row-major batches
   `(ids[B, L], vals[B, L], y[B])` for the SGD path. Padding entries use
   feature id 0 with value 0.0, so every contribution they make to the
   model vanishes; padded rows carry row_mask False.
2. `conflict_free_blocks` — a CSC ordering (entries sorted by feature)
   cut into blocks of features that no training row shares, so every
   feature of a block can be drawn in parallel from one cache snapshot
   with the result of a sequential scan. This restates libFM's transpose
   iteration (src/libfm/src/fm_learn_mcmc.h:176-305).

`feature_slots` and `case_columns` give a block the two forms the port's
kernels read: one slot list per feature, and one (feature, value) pair
per training case.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libfm_tpu_torch.data.dataset import Dataset


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class BatchedCSR:
    """Padded row-major batches. ids/vals have shape [num_batches, B, L]."""

    ids: np.ndarray  # int32
    vals: np.ndarray  # float32
    y: np.ndarray  # float32 [num_batches, B]
    row_mask: np.ndarray  # bool [num_batches, B] — False for padded rows
    num_rows: int  # true number of examples
    num_features: int

    @property
    def num_batches(self) -> int:
        return self.ids.shape[0]

    @property
    def batch_size(self) -> int:
        return self.ids.shape[1]

    @property
    def max_nnz(self) -> int:
        return self.ids.shape[2]


def pad_rows(ds: Dataset, max_nnz: int | None = None, align: int = 8):
    """Pad every row to a common length. Returns (ids[n, L], vals[n, L]).

    Rows longer than an explicit max_nnz are truncated to their first
    max_nnz entries (the cut is at the requested max_nnz, not at the
    align-rounded width)."""
    lengths = np.diff(ds.indptr).astype(np.int64)
    L = int(lengths.max()) if max_nnz is None and len(lengths) else (max_nnz or 1)
    L = max(1, _round_up(L, align))
    cut = L if max_nnz is None else max(1, min(max_nnz, L))
    n = ds.num_rows
    ids = np.zeros((n, L), dtype=np.int32)
    vals = np.zeros((n, L), dtype=np.float32)
    row = np.repeat(np.arange(n, dtype=np.int64), lengths)
    offs = np.arange(ds.nnz, dtype=np.int64) - np.repeat(ds.indptr[:-1], lengths)
    keep = offs < cut
    ids[row[keep], offs[keep]] = ds.cols[keep]
    vals[row[keep], offs[keep]] = ds.vals[keep]
    return ids, vals


def batch_dataset(
    ds: Dataset,
    batch_size: int,
    max_nnz: int | None = None,
    align: int = 1,
    drop_remainder: bool = False,
) -> BatchedCSR:
    """Batch a dataset into padded [num_batches, B, L] arrays.

    The final partial batch is padded with zero rows (row_mask False,
    target 0). align=1 (the default) pads L to the true max row nnz:
    padded entries are inert but still cost a gather and a scatter row
    each in the SGD epoch."""
    ids, vals = pad_rows(ds, max_nnz=max_nnz, align=align)
    n = ds.num_rows
    if drop_remainder:
        nb = n // batch_size
        n_used = nb * batch_size
        ids, vals = ids[:n_used], vals[:n_used]
        y = ds.target[:n_used]
        mask = np.ones(n_used, dtype=bool)
    else:
        nb = max(1, (n + batch_size - 1) // batch_size)
        n_pad = nb * batch_size
        pad = n_pad - n
        ids = np.pad(ids, ((0, pad), (0, 0)))
        vals = np.pad(vals, ((0, pad), (0, 0)))
        y = np.pad(ds.target, (0, pad))
        mask = np.zeros(n_pad, dtype=bool)
        mask[:n] = True
    L = ids.shape[1]
    return BatchedCSR(
        ids.reshape(nb, batch_size, L),
        vals.reshape(nb, batch_size, L),
        y.reshape(nb, batch_size).astype(np.float32),
        mask.reshape(nb, batch_size),
        num_rows=n,
        num_features=ds.num_features,
    )


@dataclass
class FeatureBlock:
    """A conflict-free set of features: no training row contains two
    features of the block."""

    features: np.ndarray  # int32 [F] global feature ids in this block
    entry_rows: np.ndarray  # int32 [E] training-row index of each entry
    entry_vals: np.ndarray  # float32 [E]
    entry_feat: np.ndarray  # int32 [E] position (0..F-1) within `features`
    exact: bool = True


def _groups_conflict_free(ds: Dataset, attr_group: np.ndarray) -> bool:
    """True iff no training row holds two features of the same group."""
    g_of_entry = attr_group[ds.cols].astype(np.int64)
    key = ds.row_of_entry.astype(np.int64) * (int(attr_group.max()) + 1) + g_of_entry
    return len(np.unique(key)) == len(key)


def conflict_free_blocks(
    ds: Dataset,
    attr_group: np.ndarray | None = None,
):
    """Partition the features that appear in `ds` into conflict-free
    blocks, in the JAX package's order:

    1. one block per attribute group, when no row holds two features of
       one group;
    2. else block := position of the entry within its row, when every
       feature always sits at the same position (one-hot
       recommender/CTR data with sorted columns);
    3. else greedy first-fit in Welsh-Powell order.

    Features with no entries are in no block (the learner draws them
    from their prior, libFM fm_learn_mcmc.h:467-476).
    """
    t_indptr, t_rows, t_vals = ds.transpose()
    n_feat = ds.num_features
    n_rows = ds.num_rows

    if attr_group is not None and ds.nnz:
        attr_group = np.asarray(attr_group)
        trivial = int(attr_group.max()) == 0 and bool(
            (np.diff(ds.indptr) > 1).any()
        )
        if not trivial and _groups_conflict_free(ds, attr_group):
            return _blocks_from_feature_sets(
                t_indptr,
                t_rows,
                t_vals,
                [
                    np.nonzero(
                        (attr_group == g) & (np.diff(t_indptr) > 0)
                    )[0].astype(np.int32)
                    for g in range(int(attr_group.max()) + 1)
                ],
            )

    if ds.nnz:
        lengths = np.diff(ds.indptr).astype(np.int64)
        pos = np.arange(ds.nnz, dtype=np.int64) - np.repeat(
            ds.indptr[:-1], lengths
        )
        first = np.full(n_feat, -1, dtype=np.int64)
        first[ds.cols[::-1]] = pos[::-1]  # reversed: earlier entries win
        if bool((first[ds.cols] == pos).all()):
            n_blocks = int(pos.max()) + 1
            return _blocks_from_feature_sets(
                t_indptr,
                t_rows,
                t_vals,
                [
                    np.nonzero((first == b) & (np.diff(t_indptr) > 0))[0]
                    .astype(np.int32)
                    for b in range(n_blocks)
                ],
            )

    blocks_used: list[np.ndarray] = []
    blocks_feats: list[list[int]] = []
    active = np.nonzero(np.diff(t_indptr) > 0)[0]
    deg = (t_indptr[active + 1] - t_indptr[active]).astype(np.int64)
    active = active[np.argsort(-deg, kind="stable")]
    for f in active:
        rows_f = t_rows[t_indptr[f] : t_indptr[f + 1]]
        if len(np.unique(rows_f)) != len(rows_f):
            raise ValueError(
                f"feature {int(f)} appears more than once in a single "
                "row; duplicate (row, feature) entries are not supported "
                "— coalesce the input first"
            )
        for b in range(len(blocks_used)):
            if not blocks_used[b][rows_f].any():
                blocks_used[b][rows_f] = True
                blocks_feats[b].append(int(f))
                break
        else:
            used = np.zeros(n_rows, dtype=bool)
            used[rows_f] = True
            blocks_used.append(used)
            blocks_feats.append([int(f)])
    # within-block feature order is ascending (the visit order must not
    # leak into the layout)
    return _blocks_from_feature_sets(
        t_indptr,
        t_rows,
        t_vals,
        [np.sort(np.asarray(f, dtype=np.int32)) for f in blocks_feats],
    )


def feature_slots(block: FeatureBlock):
    """One slot list per feature of a block, the form `slot_stats` reads.

    Returns (feat_off int64 [F+1], slot_case int32 [E], slot_val float32
    [E]): feature j's entries are [feat_off[j], feat_off[j+1]), in the
    block's entry order."""
    F = len(block.features)
    order = np.argsort(block.entry_feat, kind="stable")
    off = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(np.bincount(block.entry_feat, minlength=F), out=off[1:])
    return (
        off,
        block.entry_rows[order].astype(np.int32),
        block.entry_vals[order].astype(np.float32),
    )


def case_columns(block: FeatureBlock, num_rows: int):
    """Per training case, the block-local feature it holds (F where it
    holds none) and that entry's value (0 where none), the form
    `dense_update` reads. A conflict-free block gives each case at most
    one entry."""
    col = np.full(num_rows, len(block.features), dtype=np.int32)
    val = np.zeros(num_rows, dtype=np.float32)
    col[block.entry_rows] = block.entry_feat
    val[block.entry_rows] = block.entry_vals
    return col, val


def _blocks_from_feature_sets(t_indptr, t_rows, t_vals, feature_sets):
    out = []
    for feats_arr in feature_sets:
        if len(feats_arr) == 0:
            continue
        sizes = (t_indptr[feats_arr + 1] - t_indptr[feats_arr]).astype(np.int64)
        entry_feat = np.repeat(np.arange(len(feats_arr), dtype=np.int32), sizes)
        starts = np.repeat(t_indptr[feats_arr], sizes)
        offs = np.arange(int(sizes.sum()), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes
        )
        idx = starts + offs
        out.append(
            FeatureBlock(
                feats_arr,
                t_rows[idx].astype(np.int32),
                t_vals[idx].astype(np.float32),
                entry_feat,
                exact=True,
            )
        )
    return out
