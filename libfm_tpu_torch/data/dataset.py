"""Host-side dataset container (CSR, numpy).

The port's copy of `libfm_tpu.data.dataset.Dataset`: contiguous CSR
arrays (indptr/cols/vals) plus targets, and the CSC (transpose) view the
block partition uses. libFM's counterpart is class Data
(src/libfm/src/Data.h:49-73). Binary IO and the native fast paths are
not ported yet (ROADMAP M2b).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from libfm_tpu_torch.data import text as textio


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
        """Load a libFM text file. (The JAX package's auto-detection of
        the binary formats waits for ROADMAP M2b.)"""
        return cls.from_libfm_text(path)

    def to_libfm_text(self, path: str) -> None:
        textio.write_libfm_text(path, self.indptr, self.cols, self.vals, self.target)

    # ------------------------------------------------------------ transforms
    def transpose(self):
        """CSC view: (indptr[num_features+1], rows[nnz], vals[nnz]) by a
        stable counting sort, like libFM's create_data_t (Data.h:292-341)."""
        nnz = self.nnz
        rows = self.row_of_entry
        order = stable_argsort(self.cols)
        counts = (
            np.bincount(self.cols, minlength=self.num_features)
            if nnz
            else np.zeros(self.num_features, np.int64)
        )
        t_indptr = np.zeros(self.num_features + 1, dtype=np.int64)
        np.cumsum(counts, out=t_indptr[1:])
        return (
            t_indptr,
            rows[order].astype(np.int32),
            np.asarray(self.vals)[order].astype(np.float32),
        )

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
