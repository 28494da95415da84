"""Relational block structure (BS) data containers.

The port's copy of `libfm_tpu.data.relation` (libFM's relation.h, the
VLDB 2013 paper "Scaling Factorization Machines to Relational Data"). A
RelationData is a shared block of feature columns with its own design
matrix; each dataset holds, per relation, a join map from its rows to the
block's rows. The joined attribute space offsets each relation's
features by `attr_offset` (libFM libfm.cpp:213-216).

A block loads whole from its binary `<prefix>.x` (and `<prefix>.groups`),
under `-cache_size` too; a join map from a binary DVector of uint32 or a
text file of one row id a line.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from libfm_tpu_torch.data import binary as binio
from libfm_tpu_torch.data.dataset import DataMetaInfo, Dataset


class RelationData:
    """A shared feature block (libFM relation.h:32-113)."""

    def __init__(self, indptr, cols, vals, num_features: int):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int32)
        self.vals = np.asarray(vals, dtype=np.float32)
        self.num_features = int(num_features)
        self.attr_offset = 0
        self.meta = DataMetaInfo(self.num_features)

    @property
    def num_cases(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def row_of_entry(self) -> np.ndarray:
        return np.repeat(
            np.arange(self.num_cases, dtype=np.int32),
            np.diff(self.indptr).astype(np.int64),
        )

    @classmethod
    def load(cls, prefix: str, entry_budget: int | None = None) -> "RelationData":
        """The block of `<prefix>.x`, with the groups of `<prefix>.groups`
        where that file exists (libFM relation.h:71-113). The block is
        read whole: the BS engines hold it whole (their premise: block
        tables are small), so a read in windows would bound nothing.
        `entry_budget` (-cache_size) is taken for the JAX signature and
        changes nothing."""
        indptr, cols, vals, _, num_cols = binio.read_sparse_binary(prefix + ".x")
        rd = cls(indptr, cols, vals, num_cols)
        if os.path.exists(prefix + ".groups"):
            rd.meta.load_groups(prefix + ".groups")
        return rd

    @classmethod
    def from_dataset(cls, ds) -> "RelationData":
        return cls(ds.indptr, ds.cols, ds.vals, ds.num_features)

    def save(self, prefix: str) -> None:
        """Write the block as `<prefix>.x` (its groups are not written)."""
        binio.write_sparse_binary(
            prefix + ".x", self.indptr, self.cols, self.vals, self.num_features
        )


@dataclass
class RelationJoin:
    """Join map from a dataset's rows to relation-block rows (libFM
    relation.h:53-59, 127-150)."""

    data: RelationData
    row_map: np.ndarray  # int32 [num_rows]

    @classmethod
    def load(cls, data: RelationData, path: str, expected_rows: int) -> "RelationJoin":
        if binio.is_dvector_binary(path, type_size=4):
            row_map = binio.read_dvector_binary(path, dtype=np.uint32).astype(np.int32)
        else:
            row_map = np.loadtxt(path, dtype=np.int64).reshape(-1).astype(np.int32)
        if len(row_map) != expected_rows:
            raise ValueError(
                f"{path}: join map has {len(row_map)} rows, expected {expected_rows}"
            )
        return cls(data, row_map)

    def permuted(self, perm) -> "RelationJoin":
        return RelationJoin(self.data, self.row_map[perm])


def expand_join(ds) -> Dataset:
    """Materialise the relational join of `ds` into a flat Dataset: each
    case's row holds its main-table entries followed by, per relation,
    the entries of its joined block row shifted by `attr_offset` (libFM
    libfm.cpp:199-243). Targets are kept, so training on the expansion is
    statistically the same as the BS algorithm."""
    cases, cols, vals = [ds.row_of_entry], [ds.cols], [ds.vals]
    nf = ds.num_features
    nc = ds.num_rows
    for join in ds.relations:
        rd = join.data
        rmap = join.row_map.astype(np.int64)
        lens = np.diff(rd.indptr).astype(np.int64)[rmap]
        total = int(lens.sum())
        starts = rd.indptr[rmap].astype(np.int64)
        off = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        idx = np.repeat(starts, lens) + off
        cases.append(np.repeat(np.arange(nc, dtype=np.int32), lens))
        cols.append(rd.cols[idx].astype(np.int32) + rd.attr_offset)
        vals.append(rd.vals[idx])
        nf = max(nf, rd.attr_offset + rd.num_features)
    case = np.concatenate(cases)
    order = np.argsort(case, kind="stable")  # main first, then relations
    case = case[order]
    cols_f = np.concatenate(cols)[order]
    vals_f = np.concatenate(vals)[order].astype(np.float32)
    counts = np.bincount(case, minlength=nc).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return Dataset(indptr, cols_f, vals_f, ds.target, nf)


def expansion_cost(ds) -> tuple[int, int]:
    """(expanded_nnz, bs_nnz): the entry counts of the materialised join
    and of the BS form (main table, blocks and one join id per relation
    per case). The BS algorithm pays off when the ratio is large."""
    exp = int(ds.nnz)
    base = int(ds.nnz)
    for ri, join in enumerate(ds.relations):
        rd = join.data
        if len(join.row_map) and int(join.row_map.max()) >= rd.num_cases:
            raise ValueError(
                f"relation #{ri} join map references block row "
                f"{int(join.row_map.max())} but the relation has only "
                f"{rd.num_cases} rows — wrong relation file for this "
                "join map?"
            )
        lens = np.diff(rd.indptr).astype(np.int64)
        exp += int(lens[join.row_map].sum())
        base += int(rd.nnz) + ds.num_rows
    return exp, base
