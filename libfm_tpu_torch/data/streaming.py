"""Out-of-core data: libFM's binary files read in bounded windows.

The port's copy of `libfm_tpu.data.streaming`. libFM's counterpart is
LargeSparseMatrixHD, a sparse matrix on disk read through a bounded cache
of rows (src/util/fmatrix.h:165-281), with the transpose `.xt` (libFM's
data_t file, src/libfm/libfm.cpp:141-174) for the MCMC/ALS sweeps.

1. `stream_sparse_binary(path, entry_budget)` yields the rows of a binary
   `.x` (or `.xt`) as CSR windows of about `entry_budget` entries: the
   windows of the JAX reader, row for row. Each read of the file is
   parsed at once (the row starts by `binary._row_starts`, the entries by
   one mask over the words), not row by row.
2. `infer_position_groups`, `stream_greedy_partition`,
   `stream_feature_blocks` and `stream_feature_blocks_any` build the
   conflict-free blocks of `batching.conflict_free_blocks` from `.x` and
   `.xt` windows, without the whole matrix or its transpose in memory:
   the same blocks, features and entries in the same order.
3. `save_flat` / `load_flat`: one `.npy` a CSR array, memory-mappable.
4. `StreamingDataset`: a binary pair (`.x`, `.y`) whose targets are
   resident (4 bytes a row) and whose rows stream. The learners take it
   in place of a `Dataset`: `SGDLearner.learn_stream`,
   `SGDALearner.learn_stream` (train and validation), and the vector and
   exact MCMC/ALS engines (train, test or both; the train set's blocks
   come from `<x_path>t`).

Host code only, numpy.
"""

from __future__ import annotations

import numpy as np

from libfm_tpu_torch.data import binary as binio
from libfm_tpu_torch.data.batching import FeatureBlock
from libfm_tpu_torch.data.binary import _FMATRIX_HEADER, FMATRIX_FILE_ID, _row_starts
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.vector_layout import padded_rows_layout

_U32 = np.dtype("<u4")
#: the least bytes `stream_sparse_binary` reads of a file at a time
MIN_READ = 1 << 22


def read_header(path: str):
    """(num_values, num_rows, num_cols) of a binary sparse matrix."""
    with open(path, "rb") as f:
        head = f.read(_FMATRIX_HEADER.size)
    fid, float_size, num_values, num_rows, num_cols = _FMATRIX_HEADER.unpack(head)
    if fid != FMATRIX_FILE_ID:
        raise ValueError(f"{path}: bad sparse-matrix file id {fid}")
    if float_size != 4:
        raise ValueError(f"{path}: unsupported float size {float_size}")
    return num_values, num_rows, num_cols


def _buffer_rows(words: np.ndarray, max_rows: int) -> np.ndarray:
    """The word offsets of the rows that lie whole in `words` (at most
    max_rows): a prefix of rows of one length found by one strided
    compare, the rest by `_row_starts`."""
    if not len(words) or not max_rows:
        return np.empty(0, dtype=np.int64)
    width = 1 + 2 * int(words[0])
    m = min(max_rows, len(words) // width)
    lens = words[: m * width : width]
    bad = np.flatnonzero(lens != words[0])
    m = int(bad[0]) if len(bad) else m
    head = np.arange(m, dtype=np.int64) * width
    rest = _row_starts(words[m * width:], max_rows - m, partial=True)
    return np.concatenate([head, rest + m * width]) if len(rest) else head


def stream_sparse_binary(path: str, entry_budget: int = 10_000_000):
    """Yield (row_start, indptr, cols, vals, num_rows, num_cols) windows of
    a binary sparse matrix, each of at least one row: rows are added until
    they hold entry_budget entries or the current read of the file ends
    (reads of max(MIN_READ, 9 bytes an entry of the budget) bytes). indptr
    is window-local int64, cols int32, vals float32."""
    num_values, num_rows, num_cols = read_header(path)
    chunk = max(MIN_READ, min(entry_budget, 1 << 27) * 9)
    with open(path, "rb") as f:
        f.seek(_FMATRIX_HEADER.size)
        buf = b""
        row_start = 0
        while row_start < num_rows:
            more = f.read(chunk)
            buf = buf + more if buf else more
            words = np.frombuffer(buf, dtype=_U32, count=len(buf) >> 2)
            starts = _buffer_rows(words, num_rows - row_start)
            if not len(starts):
                if not more:
                    raise ValueError(f"{path}: truncated sparse-matrix file")
                continue
            sizes = words[starts].astype(np.int64)
            cum = np.zeros(len(starts) + 1, dtype=np.int64)
            np.cumsum(sizes, out=cum[1:])
            a, n = 0, len(starts)
            while a < n:
                # the rows up to the first whose entries reach the budget
                b = int(np.searchsorted(cum, cum[a] + entry_budget, side="left"))
                b = min(max(b, a + 1), n)
                first = int(starts[a])
                seg = words[first: int(starts[b - 1] + 1 + 2 * sizes[b - 1])]
                keep = np.ones(len(seg), dtype=bool)
                keep[starts[a:b] - first] = False
                ent = seg[keep]
                yield (row_start, cum[a:b + 1] - cum[a], ent[0::2].astype(np.int32),
                       ent[1::2].view("<f4").astype(np.float32), num_rows, num_cols)
                row_start += b - a
                a = b
            buf = buf[int(starts[-1] + 1 + 2 * sizes[-1]) * 4:]


def _positions(indptr: np.ndarray) -> np.ndarray:
    """Each entry's position within its row, for window-local indptr."""
    lengths = np.diff(indptr).astype(np.int64)
    return np.arange(int(indptr[-1]), dtype=np.int64) - np.repeat(indptr[:-1], lengths)


# ------------------------------------------------ the streamed block build


def infer_position_groups(x_path: str, num_features: int, entry_budget: int = 10_000_000):
    """The block of each feature by its position within the rows, from one
    bounded pass over `.x` (conflict_free_blocks' second rule): int32
    [num_features], or None where some feature sits at two positions.
    Features with no entry get block 0 (they are in no block)."""
    first = np.full(num_features, -1, dtype=np.int64)
    for _, indptr, cols, _, _, _ in stream_sparse_binary(x_path, entry_budget):
        pos = _positions(indptr)
        new = first[cols] == -1
        first[cols[new]] = pos[new]
        if not bool((first[cols] == pos).all()):
            return None
    first[first == -1] = 0
    return first.astype(np.int32)


def stream_greedy_partition(xt_path: str, num_rows: int, entry_budget: int = 10_000_000):
    """conflict_free_blocks' greedy first-fit (its third rule) from a
    streamed `.xt`: the same Welsh-Powell order (entry count descending,
    stable), the same first fit, so the same blocks. One pass counts each
    feature's entries; each active feature's rows are then read by its
    byte offset, and each block keeps a bitmap of its rows (num_rows / 8
    bytes). Returns (block_of_feature int32, entries_per_feature int64)."""
    counts_l = [np.diff(indptr).astype(np.int64)
                for _, indptr, _, _, _, _ in stream_sparse_binary(xt_path, entry_budget)]
    counts = np.concatenate(counts_l) if counts_l else np.empty(0, np.int64)
    nf = len(counts)
    offs = np.zeros(nf + 1, dtype=np.int64)
    np.cumsum(4 + 8 * counts, out=offs[1:])
    offs += _FMATRIX_HEADER.size
    active = np.nonzero(counts > 0)[0]
    order = active[np.argsort(-counts[active], kind="stable")]
    nbytes = (num_rows + 7) >> 3
    bit = np.left_shift(np.uint8(1), np.arange(8, dtype=np.uint8))
    blocks: list[np.ndarray] = []  # packed row bitmaps
    block_of = np.zeros(nf, dtype=np.int32)
    with open(xt_path, "rb") as fh:
        for fi in order:
            fh.seek(offs[fi] + 4)
            rf = np.frombuffer(fh.read(8 * int(counts[fi])), dtype=_U32)[0::2].astype(np.int64)
            if len(np.unique(rf)) != len(rf):
                raise ValueError(
                    f"feature {int(fi)} appears more than once in a single row; "
                    "duplicate (row, feature) entries are not supported — coalesce "
                    "the input first")
            by, bi = rf >> 3, bit[rf & 7]
            for b, used in enumerate(blocks):
                if not (used[by] & bi).any():
                    break
            else:
                blocks.append(np.zeros(nbytes, dtype=np.uint8))
                b = len(blocks) - 1
            np.bitwise_or.at(blocks[b], by, bi)
            block_of[fi] = b
    return block_of, counts


def stream_feature_blocks_any(xt_path: str, block_of_feature: np.ndarray, num_rows: int,
                              entry_budget: int = 10_000_000,
                              entries_per_feature: np.ndarray | None = None):
    """The FeatureBlocks of a partition whose blocks interleave over the
    feature ids (the greedy one), in block-id order: blocks are grouped
    into waves of at most entry_budget entries (a block over it is a wave
    of its own), and `.xt` is streamed once a wave, keeping only that
    wave's features."""
    block_of_feature = np.asarray(block_of_feature, dtype=np.int64)
    if entries_per_feature is None:
        entries_per_feature = np.zeros(len(block_of_feature), np.int64)
        for f0, indptr, _, _, _, _ in stream_sparse_binary(xt_path, entry_budget):
            entries_per_feature[f0:f0 + len(indptr) - 1] = np.diff(indptr)
    nb = int(block_of_feature.max()) + 1 if len(block_of_feature) else 0
    per_block = np.bincount(block_of_feature, weights=entries_per_feature,
                            minlength=nb).astype(np.int64)
    waves, wave, tot = [], [], 0
    for b in range(nb):
        if wave and tot + per_block[b] > entry_budget:
            waves.append(wave)
            wave, tot = [], 0
        wave.append(b)
        tot += int(per_block[b])
    if wave:
        waves.append(wave)
    for wv in waves:
        in_wave = np.zeros(nb, dtype=bool)
        in_wave[wv] = True
        # features outside the wave are skipped (-1); the partition is
        # conflict-free by construction
        bmap = np.where(in_wave[block_of_feature], block_of_feature, -1)
        got = list(stream_feature_blocks(xt_path, bmap, num_rows, entry_budget,
                                         check_conflicts=False))
        # the streamer closes blocks by their last feature: back to block ids
        got.sort(key=lambda blk: int(block_of_feature[blk.features[0]]))
        yield from got


def stream_feature_blocks(xt_path: str, block_of_feature: np.ndarray, num_rows: int,
                          entry_budget: int = 10_000_000, check_conflicts: bool = True):
    """Yield the FeatureBlocks of the partition `block_of_feature` (a block
    id a feature; -1 skips it) from a streamed `.xt`, each block once the
    stream has passed its last feature (blocks that close in one window
    in block-id order). A block's features ascend and its entries are
    feature-major, each feature's rows in `.xt`'s order, as
    conflict_free_blocks lays them out; features without entries are left
    out. Host memory: the entries of the blocks still open plus one
    window. With `check_conflicts` a block in which a row holds two
    features raises ValueError."""
    block_of_feature = np.asarray(block_of_feature)
    n_blocks = int(block_of_feature.max()) + 1 if len(block_of_feature) else 0
    sel = block_of_feature >= 0
    bmax = np.zeros(n_blocks, dtype=np.int64)
    bmax[block_of_feature[sel]] = np.nonzero(sel)[0]
    open_acc: dict[int, dict] = {}

    def finalize(b):
        acc = open_acc.pop(b)
        feats = np.concatenate(acc["feats"])
        counts = np.concatenate(acc["counts"])
        nz = counts > 0  # unobserved features: drawn from their prior
        feats, counts = feats[nz], counts[nz]
        if not len(feats):
            return None
        return FeatureBlock(
            features=feats.astype(np.int32),
            entry_rows=np.concatenate(acc["rows"]).astype(np.int32),
            entry_vals=np.concatenate(acc["vals"]).astype(np.float32),
            entry_feat=np.repeat(np.arange(len(feats), dtype=np.int32), counts),
            exact=True,
        )

    for f0, indptr, rows, vals, _, _ in stream_sparse_binary(xt_path, entry_budget):
        nf = len(indptr) - 1
        b_win = block_of_feature[f0:f0 + nf]
        cuts = np.nonzero(np.diff(b_win))[0] + 1
        for s_, e_ in zip(np.concatenate([[0], cuts]), np.concatenate([cuts, [nf]])):
            b = int(b_win[s_])
            if b < 0:
                continue
            lo, hi = int(indptr[s_]), int(indptr[e_])
            acc = open_acc.setdefault(b, dict(
                feats=[], counts=[], rows=[], vals=[],
                used=np.zeros(num_rows, dtype=bool) if check_conflicts else None))
            acc["feats"].append(np.arange(f0 + s_, f0 + e_, dtype=np.int64))
            acc["counts"].append(np.diff(indptr[s_:e_ + 1]).astype(np.int64))
            acc["rows"].append(rows[lo:hi].copy())
            acc["vals"].append(vals[lo:hi].copy())
            if check_conflicts and hi > lo:
                r = rows[lo:hi]
                if acc["used"][r].any():
                    raise ValueError(
                        f"block {b} is not conflict-free: a training row holds two of "
                        "its features (fix the -meta groups or train in memory)")
                acc["used"][r] = True
        last_seen = f0 + nf - 1
        for b in sorted(b for b in open_acc if bmax[b] <= last_seen):
            blk = finalize(b)
            if blk is not None:
                yield blk
    for b in sorted(open_acc):
        blk = finalize(b)
        if blk is not None:
            yield blk


def stream_blocks(train, attr_group: np.ndarray):
    """Yield (block id, FeatureBlock) for the conflict-free blocks of the
    StreamingDataset `train`, read from its transpose `<x_path>t`, as the
    JAX engines stream them: the partition of the groups `attr_group` where
    there are several, else of the positions within the rows
    (`infer_position_groups`), else the greedy one
    (`stream_greedy_partition`). Sorted by their ids, the blocks are
    `conflict_free_blocks`' in its order; a block comes as soon as it is
    read whole, so that the caller can build and upload it before the next
    is read. Raises ValueError when the transpose is missing."""
    import os

    xt = train.x_path + "t"
    if not os.path.exists(xt):
        raise ValueError(f"streamed MCMC/ALS needs the transposed design matrix at {xt} "
                         "(build it with python -m libfm_tpu_torch.tools.transpose)")
    budget, nr = train.entry_budget, train.num_rows
    part = (np.asarray(attr_group) if int(np.max(attr_group)) > 0
            else infer_position_groups(train.x_path, len(attr_group), budget))
    if part is not None:
        blocks = stream_feature_blocks(xt, part, nr, budget)
    else:
        part, counts = stream_greedy_partition(xt, nr, budget)
        blocks = stream_feature_blocks_any(xt, part, nr, budget, entries_per_feature=counts)
    for blk in blocks:
        yield int(part[blk.features[0]]), blk
        del blk  # the caller's copy is the last


def is_stream(ds) -> bool:
    """Whether `ds` is read in windows (a StreamingDataset) rather than
    held whole (a Dataset)."""
    return isinstance(ds, StreamingDataset)


# ------------------------------------------------------------- flat format


def save_flat(ds: Dataset, prefix: str) -> None:
    """Write `<prefix>.<name>.npy` for indptr, cols, vals, target and meta
    (the feature count): plain .npy files, which np.load memory-maps."""
    np.save(prefix + ".indptr.npy", np.asarray(ds.indptr, dtype=np.int64))
    np.save(prefix + ".cols.npy", np.asarray(ds.cols, dtype=np.int32))
    np.save(prefix + ".vals.npy", np.asarray(ds.vals, dtype=np.float32))
    np.save(prefix + ".target.npy", np.asarray(ds.target, dtype=np.float32))
    np.save(prefix + ".meta.npy", np.asarray([ds.num_features], dtype=np.int64))


def load_flat(prefix: str, mmap: bool = True) -> Dataset:
    """The Dataset of `save_flat`'s files, its CSR arrays memory-mapped
    with `mmap` (the targets are read)."""
    mm = "r" if mmap else None
    return Dataset(
        np.load(prefix + ".indptr.npy", mmap_mode=mm),
        np.load(prefix + ".cols.npy", mmap_mode=mm),
        np.load(prefix + ".vals.npy", mmap_mode=mm),
        np.asarray(np.load(prefix + ".target.npy")),
        int(np.load(prefix + ".meta.npy")[0]),
    )


class StreamingDataset:
    """A binary pair (`.x`, `.y`) read in windows of about `entry_budget`
    entries; the targets are resident (4 bytes a row)."""

    def __init__(self, x_path: str, y_path: str, entry_budget: int = 10_000_000):
        self.x_path = x_path
        self.target = binio.read_dvector_binary(y_path, dtype=np.float32)
        self.entry_budget = entry_budget
        self.nnz, self.num_rows, self.num_features = read_header(x_path)
        if self.num_rows != len(self.target):
            raise ValueError(f"{x_path}: {self.num_rows} rows != {len(self.target)} targets")
        self.min_target = float(self.target.min()) if len(self.target) else 0.0
        self.max_target = float(self.target.max()) if len(self.target) else 0.0
        self._rows = None
        #: rows truncated by the most recent iter_batches() pass
        self.truncated_rows = 0
        #: entries dropped by the most recent iter_batches() pass
        self.truncated_entries = 0

    def binarize_targets(self) -> None:
        """Map targets to +-1 for classification (libFM libfm.cpp:302-305)."""
        self.target = np.where(self.target > 0.0, 1.0, -1.0).astype(np.float32)
        self.min_target, self.max_target = -1.0, 1.0

    def row_lengths(self):
        """(shortest row, longest row, every value 1.0), from one pass over
        `.x`, kept for later calls."""
        if self._rows is None:
            lo, hi, ones = None, 0, True
            for _, indptr, _, vals, _, _ in stream_sparse_binary(self.x_path,
                                                                self.entry_budget):
                lengths = np.diff(indptr)
                if len(lengths):
                    lo = int(lengths.min()) if lo is None else min(lo, int(lengths.min()))
                    hi = max(hi, int(lengths.max()))
                ones = ones and bool((vals == 1.0).all())
            self._rows = (lo or 0, hi, ones)
        return self._rows

    def max_row_nnz(self) -> int:
        """The most entries of any row (one pass over `.x`, kept)."""
        return self.row_lengths()[1]

    def iter_batches(self, batch_size: int, max_nnz: int):
        """Yield (ids [B, L], vals [B, L], y [B], mask [B]) padded batches,
        L = max_nnz, in row order. Rows with more than max_nnz entries keep
        their first max_nnz; the pass's counts are in `truncated_rows` and
        `truncated_entries`. The last batch is zero-padded (mask False)."""
        self.truncated_rows = self.truncated_entries = 0
        for start, ids, vals, n in self._slabs(max_nnz, batch_size):
            y = np.zeros(batch_size, dtype=np.float32)
            y[:n] = self.target[start:start + n]
            yield ids, vals, y, np.arange(batch_size) < n

    def padded_rows(self, width: int, chunk_rows: int = 1 << 18):
        """Yield (row_start, ids [c, width], vals [c, width]) over the rows,
        chunks of chunk_rows rows (the last shorter), each row's entries
        from column 0 and zeros past them (id 0, value 0): the rows of
        `vector_layout.padded_rows_layout` at that width, a chunk at a
        time (width at least the longest row)."""
        for start, ids, vals, n in self._slabs(width, chunk_rows):
            yield start, ids[:n], vals[:n]

    def _slabs(self, width: int, size: int):
        """Yield (row_start, ids [size, width], vals [size, width], n): the
        next n rows (n = size but at the end) of `padded_rows_layout` at
        `width`, zeros in the rows past n. Adds the rows cut at `width`
        and the entries dropped to `truncated_rows` and
        `truncated_entries`."""
        ids = np.zeros((size, width), dtype=np.int32)
        vals = np.zeros((size, width), dtype=np.float32)
        fill = start = 0
        for _, indptr, cols, vs, _, _ in stream_sparse_binary(self.x_path, self.entry_budget):
            over = np.diff(indptr) - width
            over = over[over > 0]
            self.truncated_rows += len(over)
            self.truncated_entries += int(over.sum())
            w_ids, w_vals = padded_rows_layout(indptr, cols, vs, width=width)
            done = 0
            while done < len(w_ids):
                take = min(size - fill, len(w_ids) - done)
                ids[fill:fill + take] = w_ids[done:done + take]
                vals[fill:fill + take] = w_vals[done:done + take]
                fill += take
                done += take
                if fill == size:
                    yield start, ids, vals, fill
                    ids, vals = np.zeros_like(ids), np.zeros_like(vals)
                    start += fill
                    fill = 0
        if fill:
            yield start, ids, vals, fill
