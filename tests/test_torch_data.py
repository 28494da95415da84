"""The port's host-side data code against the JAX package's, on the
same inputs: libFM text IO, the synthetic generators, shuffling and
target binarization, the SGD mini-batches, the block partition, the slot
layouts and the padded row layout must agree exactly (all numpy, no
tolerance)."""

import numpy as np
import pytest

from libfm_tpu.data import batching as jbat
from libfm_tpu.data import vector_layout as jlay
from libfm_tpu.data.dataset import Dataset as JaxDataset
from libfm_tpu.data.synth import movielens_like as jax_movielens_like
from libfm_tpu_torch.data import batching as tbat
from libfm_tpu_torch.data import vector_layout as tlay
from libfm_tpu_torch.data.dataset import Dataset, stable_argsort
from libfm_tpu_torch.data.synth import movielens_like


def _skewed(seed=0, nc=400, n=60):
    """Rows of 1-3 features with Zipf-ish popularity (no field structure:
    the greedy partition)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 4, nc)
    cols, vals = [], []
    for L in lens:
        c = np.unique(np.minimum(rng.zipf(1.5, L) - 1, n - 1))
        cols.append(c)
        vals.append(rng.normal(1, 0.5, len(c)))
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    y = rng.uniform(1, 5, nc)
    return indptr, np.concatenate(cols), np.concatenate(vals), y, n


def test_text_roundtrip_matches_jax(tmp_path):
    indptr, cols, vals, y, n = _skewed(1, nc=50)
    ds = Dataset.from_arrays(indptr, cols, vals, y, n)
    p = str(tmp_path / "d.libfm")
    ds.to_libfm_text(p)
    a = Dataset.load(p)
    b = JaxDataset.from_libfm_text(p)
    for f in ("indptr", "cols", "vals", "target"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.num_features == b.num_features
    np.testing.assert_array_equal(a.row_of_entry, b.row_of_entry)


@pytest.mark.parametrize("which", ["movielens", "skewed"])
def test_blocks_and_layouts_match_jax(which):
    if which == "movielens":
        t, _ = movielens_like(200, 150, 6000, seed=2)
        j, _ = jax_movielens_like(200, 150, 6000, seed=2)
        widths = (32, 256)
    else:
        arrs = _skewed(2)
        t = Dataset.from_arrays(*arrs)
        j = JaxDataset.from_arrays(*arrs)
        widths = (4, 16)
    tb = tbat.conflict_free_blocks(t)
    jb = jbat.conflict_free_blocks(j)
    assert len(tb) == len(jb) >= 2
    for x, y in zip(tb, jb):
        for f in ("features", "entry_rows", "entry_vals", "entry_feat"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        g = np.zeros(len(x.features), np.int32)
        tl = tlay.build_block_layout(x.features, x.entry_rows, x.entry_vals,
                                     x.entry_feat, g, t.num_rows, widths)
        jl = jlay.build_block_layout(y.features, y.entry_rows, y.entry_vals,
                                     y.entry_feat, g, j.num_rows, widths)
        assert len(tl.buckets) == len(jl.buckets)
        for bt, bj in zip(tl.buckets, jl.buckets):
            assert bt.width == bj.width and bt.unique_feats == bj.unique_feats
            for f in ("slot_case", "slot_val", "seg_feat", "seg_whole"):
                np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f))
        # the kernels' forms: each feature's slots and each case's entry
        off, sc, sv = tbat.feature_slots(x)
        assert off[-1] == len(x.entry_rows)
        col, val = tbat.case_columns(x, t.num_rows)
        for fj in range(len(x.features)):
            mine = sc[off[fj]:off[fj + 1]]
            np.testing.assert_array_equal(mine, x.entry_rows[x.entry_feat == fj])
            np.testing.assert_array_equal(sv[off[fj]:off[fj + 1]],
                                          x.entry_vals[x.entry_feat == fj])
            assert (col[mine] == fj).all()
        assert (col == len(x.features)).sum() == t.num_rows - len(x.entry_rows)
        np.testing.assert_array_equal(val[x.entry_rows], x.entry_vals)


def test_group_blocks_match_jax():
    t, _ = movielens_like(50, 40, 2000, seed=4)
    j, _ = jax_movielens_like(50, 40, 2000, seed=4)
    groups = np.zeros(t.num_features, np.int32)
    groups[50:] = 1
    tb = tbat.conflict_free_blocks(t, attr_group=groups)
    jb = jbat.conflict_free_blocks(j, attr_group=groups)
    assert len(tb) == len(jb) == 2
    for x, y in zip(tb, jb):
        np.testing.assert_array_equal(x.features, y.features)
        np.testing.assert_array_equal(x.entry_rows, y.entry_rows)


@pytest.mark.parametrize("top", [1, 7, 70_000, 2**31 - 1])
def test_stable_argsort_matches_numpy(top):
    keys = np.random.default_rng(top).integers(0, top, 50_000).astype(np.int32)
    np.testing.assert_array_equal(stable_argsort(keys),
                                  np.argsort(keys, kind="stable"))
    assert len(stable_argsort(keys[:0])) == 0


def test_padded_rows_layout_matches_jax():
    indptr, cols, vals, _, _ = _skewed(3)
    a = tlay.padded_rows_layout(indptr, cols, vals)
    b = jlay.padded_rows_layout(indptr, cols, vals)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_ctr_like_matches_jax():
    from libfm_tpu.data.synth import ctr_like as jax_ctr_like
    from libfm_tpu_torch.data.synth import ctr_like

    a, b = ctr_like(5, 50, 3000, seed=4), jax_ctr_like(5, 50, 3000, seed=4)
    np.testing.assert_array_equal(a[2], b[2])
    for x, y in zip(a[:2], b[:2]):
        for f in ("indptr", "cols", "vals", "target"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        assert (x.num_features, x.min_target, x.max_target) == (
            y.num_features, y.min_target, y.max_target)


@pytest.mark.parametrize("which", ["movielens", "skewed"])
def test_shuffled_permuted_binarize_match_jax(which):
    if which == "movielens":
        t, _ = movielens_like(30, 20, 500, seed=6)
        j, _ = jax_movielens_like(30, 20, 500, seed=6)
    else:
        arrs = _skewed(4)
        t, j = Dataset.from_arrays(*arrs), JaxDataset.from_arrays(*arrs)
    perm = np.random.default_rng(1).permutation(t.num_rows)
    for a, b in ((t.shuffled(3), j.shuffled(3)), (t.permuted(perm), j.permuted(perm))):
        for f in ("indptr", "cols", "vals", "target"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.min_target, a.max_target, a.relations) == (
            b.min_target, b.max_target, b.relations)
    t.target = t.target - 3.0
    j.target = j.target - 3.0
    t.binarize_targets()
    j.binarize_targets()
    np.testing.assert_array_equal(t.target, j.target)
    assert t.target.dtype == j.target.dtype
    assert (t.min_target, t.max_target) == (j.min_target, j.max_target)


@pytest.mark.parametrize("kw", [
    dict(batch_size=64),
    dict(batch_size=50, align=8),
    dict(batch_size=64, max_nnz=2),
    dict(batch_size=64, max_nnz=2, align=8),
    dict(batch_size=37, drop_remainder=True),
])
def test_batch_dataset_matches_jax(kw):
    arrs = _skewed(5)
    a = tbat.batch_dataset(Dataset.from_arrays(*arrs), **kw)
    b = jbat.batch_dataset(JaxDataset.from_arrays(*arrs), **kw)
    for f in ("ids", "vals", "y", "row_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.num_rows, a.num_features, a.num_batches, a.batch_size, a.max_nnz) == (
        b.num_rows, b.num_features, b.num_batches, b.batch_size, b.max_nnz)
    assert tbat._round_up(13, 8) == jbat._round_up(13, 8) == 16
