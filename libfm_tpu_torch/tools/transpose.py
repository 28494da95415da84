"""Transpose a libFM binary sparse matrix (`.x` -> `.xt`).

The port's copy of `libfm_tpu.tools.transpose`, libFM's `transpose` tool
(src/libfm/tools/transpose.cpp:53-170) with its flags: --ifile, --ofile
and --cache_size in MiB (default 200, transpose.cpp:83). The streamed
MCMC/ALS engines read a train set's blocks from the `.xt` beside its
`.x` (libFM's data_t file, libfm.cpp:141-174):

    python -m libfm_tpu_torch.tools.transpose --ifile train.x \\
        --ofile train.xt --cache_size 200

A matrix whose entries fit the cache (8 bytes an entry) is transposed in
memory (`Dataset.transpose`'s stable counting sort). A larger one is
transposed out of core (`transpose_streaming`): one pass over the input
counts each column's entries, then each block of consecutive columns
whose entries fit the cache is filled by another pass and appended to
the output (transpose.cpp:125-161). Both write the same bytes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from libfm_tpu_torch.data import binary as binio
from libfm_tpu_torch.data.binary import _FMATRIX_HEADER, FMATRIX_FILE_ID
from libfm_tpu_torch.data.streaming import read_header, stream_sparse_binary


def transpose_streaming(ifile: str, ofile: str, cache_entries: int,
                        entry_budget: int | None = None) -> int:
    """Write the transpose of `ifile` to `ofile` holding at most
    `cache_entries` entries of a column block (or one column, where a
    column holds more) besides one input window of `entry_budget` entries
    (default min(cache_entries, 10M)). Each column's rows ascend. Returns
    the number of passes over the input, the counting pass included."""
    if entry_budget is None:
        entry_budget = max(1, min(cache_entries, 10_000_000))
    num_values, num_rows, num_cols = read_header(ifile)
    # pass 1: each column's entries (transpose.cpp:89-97)
    counts = np.zeros(num_cols, dtype=np.int64)
    for _, _, cols, _, _, _ in stream_sparse_binary(ifile, entry_budget):
        counts += np.bincount(cols, minlength=num_cols)
    passes = 1
    with open(ofile, "wb") as out:
        out.write(_FMATRIX_HEADER.pack(FMATRIX_FILE_ID, 4, int(num_values), num_cols,
                                       num_rows))
        # passes 2..: consecutive column blocks that fit the cache
        ends = np.cumsum(counts)
        col_lo = 0
        while col_lo < num_cols:
            base = int(ends[col_lo] - counts[col_lo])
            col_hi = max(col_lo + 1, int(np.searchsorted(ends, base + cache_entries,
                                                         side="right")))
            blk_indptr = np.zeros(col_hi - col_lo + 1, dtype=np.int64)
            np.cumsum(counts[col_lo:col_hi], out=blk_indptr[1:])
            blk_rows = np.empty(int(blk_indptr[-1]), dtype=np.int64)
            blk_vals = np.empty(int(blk_indptr[-1]), dtype=np.float32)
            cursor = blk_indptr[:-1].copy()
            for row0, indptr, cols, vals, _, _ in stream_sparse_binary(ifile, entry_budget):
                sel = (cols >= col_lo) & (cols < col_hi)
                if not sel.any():
                    continue
                c = cols[sel].astype(np.int64) - col_lo
                rows = (row0 + np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                                         np.diff(indptr)))[sel]
                # the window's entries by column, in row order: each
                # column's rows go on from its cursor
                order = np.argsort(c, kind="stable")
                c = c[order]
                n_c = np.bincount(c, minlength=col_hi - col_lo)
                first = np.cumsum(n_c) - n_c
                pos = cursor[c] + np.arange(len(c), dtype=np.int64) - first[c]
                cursor += n_c
                blk_rows[pos] = rows[order]
                blk_vals[pos] = vals[sel][order]
            out.write(binio.row_words(blk_indptr, blk_rows, blk_vals).tobytes())
            passes += 1
            col_lo = col_hi
    return passes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="libfm-torch-transpose")
    p.add_argument("--ifile", required=True, help="input binary sparse matrix (.x)")
    p.add_argument("--ofile", required=True, help="output transpose (.xt)")
    p.add_argument("--cache_size", type=float, default=200.0,
                   help="column-block cache in MiB (libFM's default 200, "
                   "transpose.cpp:83); a matrix with more entries (8 B each) is "
                   "transposed out of core in several passes")
    args = p.parse_args(argv)
    num_values, num_rows, num_cols = read_header(args.ifile)
    print(f"num_rows={num_rows}\tnum_values={int(num_values)}\tnum_features={num_cols}")
    cache_entries = int(args.cache_size * (1 << 20)) // 8
    if num_values > cache_entries:
        passes = transpose_streaming(args.ifile, args.ofile, cache_entries)
        print(f"out of core: {passes} passes over {args.ifile}")
        return 0
    from libfm_tpu_torch.data.dataset import _csr_transpose

    indptr, cols, vals, num_rows, num_cols = binio.read_sparse_binary(args.ifile)
    t_indptr, t_rows, t_vals = _csr_transpose(indptr, cols, vals, num_rows, num_cols)
    binio.write_sparse_binary(args.ofile, t_indptr, t_rows, t_vals, num_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
