"""libFM's binary file formats, read and written with numpy.

The port's copy of `libfm_tpu.data.binary`: the same three formats, the
same bytes written and the same arrays read, so that files made by
libFM's `convert` / `transpose` tools, by the JAX package or by this one
load in any of them.

1. Sparse matrix (`.x` / `.xt` / `.data` / `.datat`): a 24-byte header
   `file_header{uint id; uint float_size; uint64 num_values; uint
   num_rows; uint num_cols}` with id == 2 (libFM src/util/fmatrix.h:32,
   44-50), then per row `uint size` and `size` packed `sparse_entry{uint
   id; float value}` records (fmatrix.h:124-143).
2. Dense vector (`.y` / `.target`): `uint id (== 1); uint type_size; uint
   num_rows`, then the raw values (src/util/matrix.h:32, 344-358).
3. Dense matrix: `dmatrix_file_header{uint id (== 1001); uint type_size;
   uint num_rows; uint num_cols}`, then the values row-major
   (matrix.h:33-40, 219-254).

Every word of a sparse matrix's body is four bytes, so the body is read
as one uint32 array. Where every row holds the same number of entries
(the header's counts say which length, and the size words confirm it)
the rows are one reshape; otherwise the row starts are found window by
window by pointer doubling over the words (`_row_starts`), with no Python
loop over the rows.
"""

from __future__ import annotations

import struct

import numpy as np

FMATRIX_FILE_ID = 2
DVECTOR_FILE_ID = 1
DMATRIX_FILE_ID = 1001

# uint id, uint float_size, uint64 num_values, uint num_rows, uint num_cols
_FMATRIX_HEADER = struct.Struct("<IIQII")
_DVECTOR_HEADER = struct.Struct("<III")
_DMATRIX_HEADER = struct.Struct("<IIII")

#: the words `_row_starts` takes in one window: its doubling tables hold
#: about 17 levels of this many int64 entries (~18 MB)
ROW_WINDOW = 1 << 17

_U32 = np.dtype("<u4")


def _row_starts(words: np.ndarray, num_rows: int, partial: bool = False) -> np.ndarray:
    """int64 [num_rows]: the offset in `words` of each row's size word.
    With `partial`, `words` may end before the num_rows-th row or inside a
    row (a buffer of a file read in pieces): the offsets of the rows that
    lie whole in `words`, at most num_rows of them.

    Row r + 1 starts at start_r + 1 + 2 * words[start_r], a chain that a
    loop would walk row by row. Here each window of ROW_WINDOW words is
    walked at once: next(p) = p + 1 + 2 * words[p] for every p in the
    window (a step past it parks on the window's end), its powers
    next^(2^j) by doubling until 2^j steps from the window's first row
    leave the window, and the chain's positions enumerated from the
    coarsest power down. The next window starts where the window's last
    row ends."""
    total = len(words)
    if partial:
        num_rows = min(num_rows, total)  # a row takes one word at least
    starts = np.empty(num_rows, dtype=np.int64)
    p = r = 0
    while r < num_rows:
        if p >= total:
            if partial:
                break
            raise ValueError(f"file ends after {r} of {num_rows} rows")
        seg = words[p : p + ROW_WINDOW].astype(np.int64)
        n = len(seg)
        nxt = np.empty(n + 1, dtype=np.int64)
        np.minimum(np.arange(1, n + 1, dtype=np.int64) + 2 * seg, n, out=nxt[:n])
        nxt[n] = n
        levels = [nxt]
        while levels[-1][0] < n:
            J = levels[-1]
            levels.append(J[J])
        chain = np.zeros(1, dtype=np.int64)
        for J in reversed(levels[:-1]):
            chain = np.stack([chain, J[chain]], axis=1).ravel()
        chain = chain[chain < n][: num_rows - r]
        starts[r : r + len(chain)] = p + chain
        r += len(chain)
        last = int(chain[-1])
        p += last + 1 + 2 * int(seg[last])
    if partial:
        starts = starts[:r]
        if r and p > total:  # the last row runs past the buffer
            starts = starts[:-1]
    return starts


def read_sparse_binary(path: str):
    """Read a libFM binary sparse matrix.

    Returns (indptr[int64], cols[int32], vals[float32], num_rows, num_cols).
    """
    with open(path, "rb") as f:
        buf = f.read()
    fid, float_size, num_values, num_rows, num_cols = _FMATRIX_HEADER.unpack_from(
        buf, 0
    )
    if fid != FMATRIX_FILE_ID:
        raise ValueError(f"{path}: bad sparse-matrix file id {fid}")
    if float_size != 4:
        raise ValueError(f"{path}: unsupported float size {float_size}")
    body = len(buf) - _FMATRIX_HEADER.size
    words = np.frombuffer(buf, dtype=_U32, count=body // 4, offset=_FMATRIX_HEADER.size)
    L = num_values // num_rows if num_rows else 0
    width = 1 + 2 * L
    if (num_rows and L * num_rows == num_values and len(words) >= num_rows * width
            and (words[: num_rows * width : width] == L).all()):
        rows = words[: num_rows * width].reshape(num_rows, width)
        sizes = np.full(num_rows, L, dtype=np.int64)
        cols = rows[:, 1::2].astype(np.int32).ravel()
        vals = np.ascontiguousarray(rows[:, 2::2]).view("<f4").astype(np.float32).ravel()
    else:
        try:
            starts = _row_starts(words, num_rows)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        sizes = words[starts].astype(np.int64)
        used = int(starts[-1] + 1 + 2 * sizes[-1]) if num_rows else 0
        if used > len(words):
            raise ValueError(f"{path}: file ends inside its last row")
        is_entry = np.ones(used, dtype=bool)
        is_entry[starts] = False
        entries = words[:used][is_entry].reshape(-1, 2)
        cols = entries[:, 0].astype(np.int32)
        vals = np.ascontiguousarray(entries[:, 1]).view("<f4").astype(np.float32)
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(sizes, out=indptr[1:])
    if indptr[-1] != num_values:
        raise ValueError(
            f"{path}: header says {num_values} values, read {int(indptr[-1])}")
    return indptr, cols, vals, num_rows, num_cols


def write_sparse_binary(path: str, indptr, cols, vals, num_cols: int) -> None:
    """Write CSR arrays in libFM's binary sparse-matrix format: each row's
    size word followed by its (id, value) pairs, built as one uint32 array
    and written at once."""
    indptr = np.asarray(indptr, dtype=np.int64)
    num_rows = len(indptr) - 1
    num_values = int(indptr[-1])
    with open(path, "wb") as f:
        f.write(
            _FMATRIX_HEADER.pack(FMATRIX_FILE_ID, 4, num_values, num_rows, int(num_cols))
        )
        f.write(row_words(indptr, cols, vals).tobytes())


def row_words(indptr, cols, vals) -> np.ndarray:
    """The body of the binary sparse-matrix format for CSR rows (indptr
    from 0): each row's size word followed by its (id, value) pairs, one
    uint32 array."""
    indptr = np.asarray(indptr, dtype=np.int64)
    num_rows = len(indptr) - 1
    num_values = int(indptr[-1])
    cols = np.ascontiguousarray(cols, dtype="<u4")[:num_values]
    vals = np.ascontiguousarray(vals, dtype="<f4")[:num_values]
    words = np.empty(num_rows + 2 * num_values, dtype=_U32)
    is_size = np.zeros(len(words), dtype=bool)
    is_size[np.arange(num_rows, dtype=np.int64) + 2 * indptr[:-1]] = True
    words[is_size] = np.diff(indptr)
    pairs = np.empty((num_values, 2), dtype=_U32)
    pairs[:, 0] = cols
    pairs[:, 1] = vals.view("<u4")
    words[~is_size] = pairs.ravel()
    return words


def read_dvector_binary(path: str, dtype=None):
    """Read a libFM binary dense vector.

    dtype defaults to float32 for 4-byte elements and float64 for 8-byte;
    pass an explicit dtype (e.g. np.uint32) to read the elements as it.
    """
    with open(path, "rb") as f:
        buf = f.read()
    fid, type_size, num_rows = _DVECTOR_HEADER.unpack_from(buf, 0)
    if fid != DVECTOR_FILE_ID:
        raise ValueError(f"{path}: bad dvector file id {fid}")
    if dtype is None:
        dtype = {4: np.float32, 8: np.float64}[type_size]
    dtype = np.dtype(dtype)
    if dtype.itemsize != type_size:
        raise ValueError(f"{path}: element size {type_size} != dtype {dtype} size")
    return np.frombuffer(
        buf, dtype=dtype.newbyteorder("<"), count=num_rows, offset=_DVECTOR_HEADER.size
    ).astype(dtype)


def write_dvector_binary(path: str, arr) -> None:
    arr = np.asarray(arr)
    with open(path, "wb") as f:
        f.write(_DVECTOR_HEADER.pack(DVECTOR_FILE_ID, arr.dtype.itemsize, len(arr)))
        f.write(np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<")).tobytes())


def is_dvector_binary(path: str, type_size: int) -> bool:
    """Whether a file is a binary DVector of the given element size
    (libFM's RelationJoin::load sniffs the same way, relation.h:127-140)."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError:
        return False
    if len(head) < 8:
        return False
    fid, tsize = struct.unpack("<II", head)
    return fid == DVECTOR_FILE_ID and tsize == type_size


def read_dmatrix_binary(path: str, dtype=None):
    with open(path, "rb") as f:
        buf = f.read()
    fid, type_size, num_rows, num_cols = _DMATRIX_HEADER.unpack_from(buf, 0)
    if fid != DMATRIX_FILE_ID:
        raise ValueError(f"{path}: bad dmatrix file id {fid}")
    if dtype is None:
        dtype = {4: np.float32, 8: np.float64}[type_size]
    dtype = np.dtype(dtype)
    out = np.frombuffer(
        buf,
        dtype=dtype.newbyteorder("<"),
        count=num_rows * num_cols,
        offset=_DMATRIX_HEADER.size,
    ).astype(dtype)
    return out.reshape(num_rows, num_cols)


def write_dmatrix_binary(path: str, arr) -> None:
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError(f"a dense matrix is 2-D, got shape {arr.shape}")
    with open(path, "wb") as f:
        f.write(
            _DMATRIX_HEADER.pack(
                DMATRIX_FILE_ID, arr.dtype.itemsize, arr.shape[0], arr.shape[1]
            )
        )
        f.write(np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<")).tobytes())
