"""Host-side dataset container (CSR, numpy).

The port's copy of `libfm_tpu.data.dataset.Dataset`: contiguous CSR
arrays (indptr/cols/vals) plus targets, and the CSC (transpose) view the
block partition uses, and `DataMetaInfo`, the features' groups. libFM's
counterparts are classes Data and DataMetaInfo (src/libfm/src/Data.h:
33-96). `Dataset.load` reads libFM's binary formats (`data/binary.py`)
and its text format; the native fast paths are not ported (ROADMAP M2b).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from libfm_tpu_torch.data import binary as binio
from libfm_tpu_torch.data import text as textio


class DataMetaInfo:
    """attribute -> group mapping (libFM Data.h:33-96). Every attribute is
    in group 0 until `load_groups` reads a `-meta` file: one group id per
    attribute, whitespace-separated."""

    def __init__(self, num_attributes: int):
        self.attr_group = np.zeros(num_attributes, dtype=np.int32)
        self.num_attr_groups = 1
        self._recount()

    def _recount(self):
        self.num_attr_per_group = np.bincount(
            self.attr_group, minlength=self.num_attr_groups
        ).astype(np.int32)

    def load_groups(self, path: str) -> None:
        vals = np.loadtxt(path, dtype=np.int64).reshape(-1)
        if len(vals) != len(self.attr_group):
            raise ValueError(
                f"groups file {path} has {len(vals)} entries, expected "
                f"{len(self.attr_group)}"
            )
        self.attr_group = vals.astype(np.int32)
        self.num_attr_groups = int(vals.max()) + 1 if len(vals) else 1
        self._recount()

    def set_groups(self, attr_group) -> None:
        self.attr_group = np.asarray(attr_group, dtype=np.int32)
        self.num_attr_groups = int(self.attr_group.max()) + 1 if len(self.attr_group) else 1
        self._recount()


@dataclass
class Dataset:
    """A sparse design matrix with targets, in CSR layout. min/max target
    feed the prediction clamp (libFM src/libfm/src/fm_learn.h:137-139)."""

    indptr: np.ndarray  # int64 [num_rows+1]
    cols: np.ndarray  # int32 [nnz]
    vals: np.ndarray  # float32 [nnz]
    target: np.ndarray  # float32 [num_rows]
    num_features: int
    min_target: float | None = None
    max_target: float | None = None
    relations: list = field(default_factory=list)

    def __post_init__(self):
        if self.min_target is None:
            self.min_target = (
                float(np.min(self.target)) if len(self.target) else 0.0
            )
        if self.max_target is None:
            self.max_target = (
                float(np.max(self.target)) if len(self.target) else 0.0
            )

    @property
    def num_rows(self) -> int:
        return len(self.target)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def row_of_entry(self) -> np.ndarray:
        """int32[nnz]: the row index of each CSR entry."""
        return np.repeat(
            np.arange(self.num_rows, dtype=np.int32),
            np.diff(self.indptr).astype(np.int64),
        )

    # ------------------------------------------------------------------ io
    @classmethod
    def from_libfm_text(cls, path: str) -> "Dataset":
        indptr, cols, vals, target, num_features = textio.parse_libfm_text(path)
        return cls(indptr, cols, vals, target, num_features)

    @classmethod
    def from_arrays(cls, indptr, cols, vals, target, num_features=None) -> "Dataset":
        indptr = np.asarray(indptr, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int32)
        vals = np.asarray(vals, dtype=np.float32)
        target = np.asarray(target, dtype=np.float32)
        if num_features is None:
            num_features = int(cols.max()) + 1 if len(cols) else 0
        return cls(indptr, cols, vals, target, int(num_features))

    @classmethod
    def load(cls, path: str) -> "Dataset":
        """Load with libFM's detection order (Data.h:113-127): binary
        `<p>.data` + `<p>.target`, then `<p>.x` + `<p>.y`, then a
        transpose-only `<p>.xt` beside `.y` or `.target` where `<p>` itself
        does not exist, then the text file `<p>`."""
        if os.path.exists(path + ".data") and os.path.exists(path + ".target"):
            return cls.from_binary(path, x_suffix=".data", y_suffix=".target")
        if os.path.exists(path + ".x") and os.path.exists(path + ".y"):
            return cls.from_binary(path, x_suffix=".x", y_suffix=".y")
        if (not os.path.exists(path)) and os.path.exists(path + ".xt") and (
            os.path.exists(path + ".y") or os.path.exists(path + ".target")
        ):
            ysuf = ".y" if os.path.exists(path + ".y") else ".target"
            return cls.from_binary_transpose(path + ".xt", path + ysuf)
        return cls.from_libfm_text(path)

    @classmethod
    def from_binary(cls, prefix: str, x_suffix=".x", y_suffix=".y") -> "Dataset":
        indptr, cols, vals, num_rows, num_cols = binio.read_sparse_binary(
            prefix + x_suffix
        )
        target = binio.read_dvector_binary(prefix + y_suffix, dtype=np.float32)
        if len(target) != num_rows:
            raise ValueError(
                f"{prefix}: target rows {len(target)} != matrix rows {num_rows}"
            )
        return cls(indptr, cols, vals, target, num_cols)

    @classmethod
    def from_binary_transpose(cls, xt_path: str, y_path: str) -> "Dataset":
        """A dataset from its transpose alone (`.xt`: one row a feature)."""
        tindptr, tcols, tvals, t_rows, t_cols = binio.read_sparse_binary(xt_path)
        indptr, cols, vals = _csr_transpose(tindptr, tcols, tvals, t_rows, t_cols)
        target = binio.read_dvector_binary(y_path, dtype=np.float32)
        if len(target) != t_cols:
            raise ValueError(
                f"{y_path}: target rows {len(target)} != matrix rows "
                f"{t_cols} (transposed {xt_path} has {t_cols} columns)"
            )
        return cls(indptr, cols, vals, target, t_rows)

    def to_libfm_text(self, path: str) -> None:
        textio.write_libfm_text(path, self.indptr, self.cols, self.vals, self.target)

    def to_binary(self, prefix: str, with_transpose: bool = True) -> None:
        """Write `<prefix>.x` and `<prefix>.y`, and with `with_transpose`
        the transpose `<prefix>.xt`, in libFM's binary formats."""
        binio.write_sparse_binary(
            prefix + ".x", self.indptr, self.cols, self.vals, self.num_features
        )
        binio.write_dvector_binary(prefix + ".y", self.target.astype(np.float32))
        if with_transpose:
            ti, tc, tv = self.transpose()
            binio.write_sparse_binary(prefix + ".xt", ti, tc, tv, self.num_rows)

    # ------------------------------------------------------------ transforms
    def transpose(self):
        """CSC view: (indptr[num_features+1], rows[nnz], vals[nnz]) by a
        stable counting sort, like libFM's create_data_t (Data.h:292-341)."""
        return _csr_transpose(self.indptr, self.cols, self.vals, self.num_rows,
                              self.num_features)

    def shuffled(self, seed: int = 0) -> "Dataset":
        """The rows in a random order drawn from `seed` (libFM's SGD
        expects shuffled input, fm_learn_sgd_element.h:51)."""
        rng = np.random.default_rng(seed)
        return self.permuted(rng.permutation(self.num_rows))

    def permuted(self, perm) -> "Dataset":
        """The rows in the order `perm`; the clamp range is kept. Relation
        blocks are permuted with the rows (the port carries none yet)."""
        lengths = np.diff(self.indptr)
        new_indptr = np.zeros(self.num_rows + 1, dtype=np.int64)
        np.cumsum(lengths[perm], out=new_indptr[1:])
        if self.nnz:
            lp = lengths[perm].astype(np.int64)
            starts = self.indptr[perm].astype(np.int64)
            order = np.repeat(starts, lp) + (
                np.arange(int(lp.sum()), dtype=np.int64)
                - np.repeat(new_indptr[:-1], lp)
            )
        else:
            order = np.empty(0, dtype=np.int64)
        ds = Dataset(
            new_indptr,
            self.cols[order],
            self.vals[order],
            self.target[perm],
            self.num_features,
        )
        ds.min_target = self.min_target
        ds.max_target = self.max_target
        ds.relations = [r.permuted(perm) for r in self.relations]
        return ds

    def holdout(self, seed: int) -> tuple["Dataset", "Dataset"]:
        """(train, validation): a random ninth of the rows, drawn from
        `seed`, as the validation set for SGDA and the rest as train, both
        in the order `permuted` gives them and with the whole set's clamp
        range. Relation blocks are not carried (SGDA takes none)."""
        sh = self.permuted(np.random.default_rng(seed).permutation(self.num_rows))
        nv = self.num_rows // 9

        def rows(a, b):
            lo, hi = sh.indptr[a], sh.indptr[b]
            return Dataset(sh.indptr[a:b + 1] - lo, sh.cols[lo:hi], sh.vals[lo:hi],
                           sh.target[a:b], self.num_features, self.min_target,
                           self.max_target)

        return rows(nv, self.num_rows), rows(0, nv)

    def binarize_targets(self) -> None:
        """Map targets to +-1 for classification (libFM libfm.cpp:302-305)."""
        self.target = np.where(self.target > 0.0, 1.0, -1.0).astype(np.float32)
        self.min_target = float(self.target.min()) if len(self.target) else 0.0
        self.max_target = float(self.target.max()) if len(self.target) else 0.0


def _csr_transpose(indptr, cols, vals, num_rows, num_cols):
    """(indptr [num_cols + 1], rows [nnz], vals [nnz]) of the CSR matrix's
    transpose, each column's entries in row order."""
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(num_rows, dtype=np.int32),
                     np.diff(indptr).astype(np.int64))
    order = stable_argsort(cols)
    counts = (np.bincount(cols, minlength=num_cols) if nnz
              else np.zeros(num_cols, np.int64))
    t_indptr = np.zeros(num_cols + 1, dtype=np.int64)
    np.cumsum(counts, out=t_indptr[1:])
    return (t_indptr, rows[order].astype(np.int32),
            np.asarray(vals)[order].astype(np.float32))


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """`np.argsort(keys, kind="stable")` for non-negative integer keys, as
    LSD radix passes over 16-bit digits: numpy sorts 16-bit keys by radix
    in linear time, but wider keys by comparison."""
    keys = np.asarray(keys)
    top = int(keys.max()) if len(keys) else 0
    order, shift = None, 0
    while True:
        k = keys if order is None else keys[order]
        o = np.argsort(((k >> shift) & 0xFFFF).astype(np.uint16), kind="stable")
        order = o if order is None else order[o]
        shift += 16
        if top >> shift == 0:
            return order
