"""The port's host-side data code against the JAX package's, on the
same inputs: libFM text IO, the synthetic generators, shuffling and
target binarization, the SGD mini-batches, the block partition, the slot
layouts and the padded row layout must agree exactly (all numpy, no
tolerance)."""

import struct

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


# ---- binary formats, Dataset.load's detection, -meta groups and relation
# files (data/binary.py, data/dataset.py, data/relation.py): the port's
# writers produce the JAX package's bytes and its readers its arrays


def _rows(seed, nc, lens=(0, 8), nf=300):
    """CSR rows of lens[0]..lens[1]-1 entries (an empty row where 0), with
    -0.0, a NaN and large ids among the values."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lens[0], lens[1], nc)
    indptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    cols = rng.integers(0, nf, int(indptr[-1])).astype(np.int32)
    vals = rng.normal(0, 2, int(indptr[-1])).astype(np.float32)
    if len(vals) > 2:
        vals[0], vals[1] = -0.0, np.nan
    return indptr, cols, vals, nf


SPARSE_CASES = {
    "mixed_1_to_7_with_empty_rows": dict(nc=500, lens=(0, 8)),
    "uniform_2": dict(nc=300, lens=(2, 3)),
    "uniform_13": dict(nc=50, lens=(13, 14)),
    "all_empty": dict(nc=40, lens=(0, 1)),
    "one_row": dict(nc=1, lens=(5, 6)),
    "no_rows": dict(nc=0, lens=(1, 2)),
}


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_binary_matches_jax(case, tmp_path):
    from libfm_tpu.data import binary as jbin
    from libfm_tpu_torch.data import binary as tbin

    indptr, cols, vals, nf = _rows(3, **SPARSE_CASES[case])
    tp, jp = str(tmp_path / "t.x"), str(tmp_path / "j.x")
    tbin.write_sparse_binary(tp, indptr, cols, vals, nf)
    jbin.write_sparse_binary(jp, indptr, cols, vals, nf)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    got, want = tbin.read_sparse_binary(jp), jbin.read_sparse_binary(jp)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint32) if g.dtype == np.float32 else g,
                                      w.view(np.uint32) if w.dtype == np.float32 else w)
    assert got[3:] == want[3:]


@pytest.mark.parametrize("window", [7, 64, None])
def test_vectorised_read_of_mixed_rows_matches_the_row_walk(window, monkeypatch, tmp_path):
    """About 200K rows of 0-7 entries (mixed lengths, so no reshape): the
    windowed pointer doubling finds every row the JAX reader's per-row
    walk finds, across window edges (a 7-word window cuts most rows)."""
    from libfm_tpu.data import binary as jbin
    from libfm_tpu_torch.data import binary as tbin

    nc = 200_000 if window is None else 3_000
    if window is not None:
        monkeypatch.setattr(tbin, "ROW_WINDOW", window)
    indptr, cols, vals, nf = _rows(11, nc)
    p = str(tmp_path / "m.x")
    jbin.write_sparse_binary(p, indptr, cols, vals, nf)
    got, want = tbin.read_sparse_binary(p), jbin.read_sparse_binary(p)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].view(np.uint32), want[2].view(np.uint32))


@pytest.mark.parametrize("fault", ["bad_id", "short_header_count", "truncated"])
def test_sparse_binary_faults_raise_as_jax(fault, tmp_path):
    from libfm_tpu.data import binary as jbin
    from libfm_tpu_torch.data import binary as tbin

    indptr, cols, vals, nf = _rows(5, 30, lens=(1, 6))
    p = str(tmp_path / "f.x")
    jbin.write_sparse_binary(p, indptr, cols, vals, nf)
    raw = bytearray(open(p, "rb").read())
    if fault == "bad_id":
        raw[0] = 9
    elif fault == "short_header_count":
        raw[8] += 1  # num_values one more than the rows hold
    else:
        raw = raw[:-12]
    open(p, "wb").write(bytes(raw))
    with pytest.raises((ValueError, struct.error)):
        jbin.read_sparse_binary(p)
    with pytest.raises(ValueError):
        tbin.read_sparse_binary(p)


@pytest.mark.parametrize("dtype", [np.float32, np.uint32, np.float64])
def test_dvector_binary_matches_jax(dtype, tmp_path):
    from libfm_tpu.data import binary as jbin
    from libfm_tpu_torch.data import binary as tbin

    arr = (np.random.default_rng(2).uniform(0, 1000, 257)).astype(dtype)
    tp, jp = str(tmp_path / "t.y"), str(tmp_path / "j.y")
    tbin.write_dvector_binary(tp, arr)
    jbin.write_dvector_binary(jp, arr)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    for want_dtype in (None, dtype):
        got, want = tbin.read_dvector_binary(jp, want_dtype), jbin.read_dvector_binary(jp, want_dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    size = np.dtype(dtype).itemsize
    text = tmp_path / "t.txt"
    text.write_text("1\n2\n")
    for p in (jp, str(text), str(tmp_path / "missing")):
        for ts in (4, 8):
            assert tbin.is_dvector_binary(p, ts) == jbin.is_dvector_binary(p, ts)
    assert tbin.is_dvector_binary(jp, size)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dmatrix_binary_matches_jax(dtype, tmp_path):
    from libfm_tpu.data import binary as jbin
    from libfm_tpu_torch.data import binary as tbin

    arr = np.random.default_rng(4).normal(size=(17, 5)).astype(dtype)
    tp, jp = str(tmp_path / "t.m"), str(tmp_path / "j.m")
    tbin.write_dmatrix_binary(tp, arr)
    jbin.write_dmatrix_binary(jp, arr)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    got, want = tbin.read_dmatrix_binary(jp), jbin.read_dmatrix_binary(jp)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _write_case(case, prefix, ds):
    """Files for one of Dataset.load's detection cases, from a JAX
    Dataset `ds`."""
    from libfm_tpu.data import binary as jbin

    if case == "data_target":
        jbin.write_sparse_binary(prefix + ".data", ds.indptr, ds.cols, ds.vals, ds.num_features)
        jbin.write_dvector_binary(prefix + ".target", ds.target)
    elif case == "x_y":
        ds.to_binary(prefix, with_transpose=False)
    elif case == "xt_only":
        ds.to_binary(prefix, with_transpose=True)
        import os

        os.remove(prefix + ".x")
    else:
        ds.to_libfm_text(prefix)


@pytest.mark.parametrize("case", ["data_target", "x_y", "xt_only", "text"])
def test_dataset_load_detection_matches_jax(case, tmp_path):
    indptr, cols, vals, y, n = _skewed(6, nc=120)
    jds = JaxDataset.from_arrays(indptr, cols, vals, y, n)
    prefix = str(tmp_path / "d")
    _write_case(case, prefix, jds)
    got, want = Dataset.load(prefix), JaxDataset.load(prefix)
    for f in ("indptr", "cols", "vals", "target"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.num_features, got.min_target, got.max_target) == (
        want.num_features, want.min_target, want.max_target)


def test_to_binary_matches_jax_bytes(tmp_path):
    indptr, cols, vals, y, n = _skewed(7, nc=90)
    Dataset.from_arrays(indptr, cols, vals, y, n).to_binary(str(tmp_path / "t"))
    JaxDataset.from_arrays(indptr, cols, vals, y, n).to_binary(str(tmp_path / "j"))
    for suf in (".x", ".y", ".xt"):
        assert (tmp_path / f"t{suf}").read_bytes() == (tmp_path / f"j{suf}").read_bytes()


def test_csr_transpose_matches_jax():
    from libfm_tpu.data.dataset import _csr_transpose as jtr
    from libfm_tpu_torch.data.dataset import _csr_transpose as ttr

    indptr, cols, vals, y, n = _skewed(8, nc=200)
    for g, w in zip(ttr(indptr, cols, vals, 200, n), jtr(indptr, cols, vals, 200, n)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("groups", [[0, 0, 1, 1, 1], [2, 0, 1, 2, 0], [0] * 5])
def test_meta_groups_match_jax(groups, tmp_path):
    from libfm_tpu.data.dataset import DataMetaInfo as JaxMeta
    from libfm_tpu_torch.data.dataset import DataMetaInfo

    p = tmp_path / "meta"
    p.write_text("\n".join(str(g) for g in groups) + "\n")
    got, want = DataMetaInfo(5), JaxMeta(5)
    got.load_groups(str(p))
    want.load_groups(str(p))
    np.testing.assert_array_equal(got.attr_group, want.attr_group)
    np.testing.assert_array_equal(got.num_attr_per_group, want.num_attr_per_group)
    assert got.num_attr_groups == want.num_attr_groups
    with pytest.raises(ValueError, match="expected 4"):
        DataMetaInfo(4).load_groups(str(p))


@pytest.mark.parametrize("with_groups", [False, True])
def test_relation_files_match_jax(with_groups, tmp_path):
    """RelationData.load (resident, with `.groups`), RelationData.save and
    the join maps, binary and text, against the JAX package's."""
    from libfm_tpu.data import binary as jbin
    from libfm_tpu.data.relation import RelationData as JaxRD
    from libfm_tpu.data.relation import RelationJoin as JaxRJ
    from libfm_tpu_torch.data.relation import RelationData, RelationJoin

    indptr, cols, vals, y, n = _skewed(9, nc=40)
    prefix = str(tmp_path / "rel")
    RelationData(indptr, cols, vals, n).save(prefix)
    JaxRD(indptr, cols, vals, n).save(prefix + "_j")
    assert open(prefix + ".x", "rb").read() == open(prefix + "_j.x", "rb").read()
    if with_groups:
        (tmp_path / "rel.groups").write_text(" ".join(str(i % 3) for i in range(n)))
    got, want = RelationData.load(prefix), JaxRD.load(prefix)
    for f in ("indptr", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.num_features == want.num_features
    np.testing.assert_array_equal(got.meta.attr_group, want.meta.attr_group)
    assert got.meta.num_attr_groups == want.meta.num_attr_groups == (3 if with_groups else 1)
    rows = np.random.default_rng(1).integers(0, 40, 25)
    jbin.write_dvector_binary(prefix + ".train", rows.astype(np.uint32))
    np.savetxt(prefix + ".test", rows, fmt="%d")
    for suf in (".train", ".test"):
        a, b = RelationJoin.load(got, prefix + suf, 25), JaxRJ.load(want, prefix + suf, 25)
        assert a.row_map.dtype == b.row_map.dtype
        np.testing.assert_array_equal(a.row_map, b.row_map)
        with pytest.raises(ValueError, match="expected 26"):
            RelationJoin.load(got, prefix + suf, 26)
