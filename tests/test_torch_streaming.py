"""Out-of-core data on the port (`libfm_tpu_torch.data.streaming`,
`libfm_tpu_torch.tools.transpose`) against the JAX package's, on the CPU.

The same numpy-seeded binary files go through both packages:

- the windows of `stream_sparse_binary` (a budget below one row's entries
  too), the partitions and blocks of the streamed block builders (and the
  port's resident `conflict_free_blocks`), `StreamingDataset.iter_batches`
  with its truncation counts, the flat format and the out-of-core
  transpose's bytes: equal;
- SGD's and SGDA's `learn_stream` (a resident and a streamed validation
  set) within 1e-6 / 1e-5 of JAX's, and the bits of the port's resident
  `learn`;
- the vector engine's ALS with the train set, the test set and both
  streamed within 1e-4 of JAX's streamed run at every iteration, and the
  bits of the port's resident run; MCMC, unstructured data (the greedy
  partition) and the exact engine streamed against resident, bit for bit;
- a missing transpose raises; `RelationData.load` with an `entry_budget`
  reads the resident block.

Four JAX learner runs in all (~40 s, their compiles most of it).
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.data import streaming as jstream
from libfm_tpu.data.dataset import Dataset as JaxDataset
from libfm_tpu.learners.mcmc_vector import ALSVectorLearner as JaxALS
from libfm_tpu.learners.sgd import SGDLearner as JaxSGD
from libfm_tpu.learners.sgda import SGDALearner as JaxSGDA
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.models.fm import FMParams as JaxFMParams
from libfm_tpu.tools import transpose as jtranspose
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data import streaming as tstream
from libfm_tpu_torch.data.batching import conflict_free_blocks
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.relation import RelationData
from libfm_tpu_torch.data.synth import movielens_like
from libfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner
from libfm_tpu_torch.learners.sgd import SGDLearner
from libfm_tpu_torch.learners.sgda import SGDALearner
from libfm_tpu_torch.models.fm import FMConfig, FMParams
from libfm_tpu_torch.tools import transpose as ttranspose

#: the final state two runs of one chain must share, bit for bit
STATE = ("w0", "alpha", "w_mu", "w_lambda", "v_mu", "v_lambda", "w", "V", "pred_sum_all")


def _unstructured(num_rows, num_features, seed):
    """Rows of 1-6 valued entries on random features: no position
    structure and no groups (tests/test_streaming.py `_unstructured`)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 7, num_rows)
    cols = np.concatenate([np.sort(rng.choice(num_features, n, replace=False))
                           for n in lens]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    vals = rng.standard_normal(len(cols)).astype(np.float32)
    beta = rng.standard_normal(num_features).astype(np.float32)
    y = np.add.reduceat(vals * beta[cols], indptr[:-1]).astype(np.float32)
    return Dataset(indptr, cols, vals, y, num_features)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Binary files of movielens-shaped data (train with its .xt, test, a
    validation set), of unstructured data (train with .xt, test) and of a
    set with some empty rows and rows of up to 9 entries (with .xt)."""
    d = tmp_path_factory.mktemp("stream")
    train, test = movielens_like(num_users=60, num_items=50, num_ratings=4000, seed=11)
    val, _ = movielens_like(num_users=60, num_items=50, num_ratings=900, seed=9)
    utr, ute = _unstructured(400, 80, 21), _unstructured(80, 80, 22)
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 10, 300)
    cols = np.concatenate([np.sort(rng.choice(45, n, replace=False)) for n in lens])
    ragged = Dataset(np.r_[0, np.cumsum(lens)].astype(np.int64), cols.astype(np.int32),
                     rng.standard_normal(int(lens.sum())).astype(np.float32),
                     rng.standard_normal(300).astype(np.float32), 48)
    p = {}
    for name, ds, xt in (("train", train, True), ("test", test, False),
                         ("val", val, False), ("utrain", utr, True), ("utest", ute, False),
                         ("ragged", ragged, True)):
        p[name] = str(d / name)
        ds.to_binary(p[name], with_transpose=xt)
    p.update(dir=d, data=dict(train=train, test=test, val=val, utrain=utr, utest=ute,
                              ragged=ragged))
    return p


def _stream(files, name, budget):
    return tstream.StreamingDataset(files[name] + ".x", files[name] + ".y", budget)


def _jstream(files, name, budget):
    return jstream.StreamingDataset(files[name] + ".x", files[name] + ".y", budget)


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y


def _same_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("features", "entry_rows", "entry_vals", "entry_feat"):
            _same_arrays([getattr(g, key)], [getattr(w, key)])
        assert g.exact == w.exact


# ---- the host-side readers and builders, against JAX's


@pytest.mark.parametrize("name,suffix", [("ragged", ".x"), ("ragged", ".xt"),
                                         ("train", ".x"), ("train", ".xt")])
@pytest.mark.parametrize("budget", [1, 4, 37, 1000, 10_000_000])
def test_windows_equal_jax(files, name, suffix, budget):
    """Row for row, the windows of JAX's reader, also at a budget below
    one row's entries (each window then one row)."""
    path = files[name] + suffix
    got = list(tstream.stream_sparse_binary(path, budget))
    want = list(jstream.stream_sparse_binary(path, budget))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        _same_arrays(g, w)


def test_windows_cross_the_reads(files, monkeypatch):
    """Reads of 64 bytes end inside rows (and inside size words): the
    windows still hold every row whole, in order."""
    monkeypatch.setattr(tstream, "MIN_READ", 64)
    for name in ("ragged", "train"):
        ds = files["data"][name]
        parts = list(tstream.stream_sparse_binary(files[name] + ".x", 5))
        assert len(parts) > 5
        assert [p[0] for p in parts] == list(np.cumsum([0] + [len(p[1]) - 1
                                                              for p in parts])[:-1])
        lens = np.concatenate([np.diff(p[1]) for p in parts])
        np.testing.assert_array_equal(lens, np.diff(ds.indptr))
        np.testing.assert_array_equal(np.concatenate([p[2] for p in parts]), ds.cols)
        np.testing.assert_array_equal(np.concatenate([p[3] for p in parts]), ds.vals)


def test_partitions_and_blocks_equal_jax_and_the_resident_build(files):
    tr = files["data"]["train"]
    part = tstream.infer_position_groups(files["train"] + ".x", tr.num_features, 300)
    _same_arrays([part], [jstream.infer_position_groups(files["train"] + ".x",
                                                        tr.num_features, 300)])
    assert (part[:60] == 0).all() and (part[60:] == 1).all()
    got = list(tstream.stream_feature_blocks(files["train"] + ".xt", part, tr.num_rows, 250))
    _same_blocks(got, list(jstream.stream_feature_blocks(files["train"] + ".xt", part,
                                                         tr.num_rows, 250)))
    _same_blocks(got, conflict_free_blocks(tr, attr_group=np.zeros(tr.num_features,
                                                                  np.int32)))
    # unstructured data: no position partition, the greedy one
    u = files["data"]["utrain"]
    assert tstream.infer_position_groups(files["utrain"] + ".x", 80, 300) is None
    gp, counts = tstream.stream_greedy_partition(files["utrain"] + ".xt", u.num_rows, 300)
    jgp, jcounts = jstream.stream_greedy_partition(files["utrain"] + ".xt", u.num_rows, 300)
    _same_arrays([gp, counts], [jgp, jcounts])
    for budget in (50, 300, 10_000):  # waves of several blocks and of one
        got = list(tstream.stream_feature_blocks_any(
            files["utrain"] + ".xt", gp, u.num_rows, budget, entries_per_feature=counts))
        _same_blocks(got, list(jstream.stream_feature_blocks_any(
            files["utrain"] + ".xt", jgp, u.num_rows, budget, entries_per_feature=jcounts)))
        _same_blocks(got, conflict_free_blocks(u, attr_group=np.zeros(80, np.int32)))
    # the learners' source: (block id, block) in the resident order once sorted
    for name, ds in (("train", tr), ("utrain", u)):
        keyed = sorted(tstream.stream_blocks(_stream(files, name, 200),
                                             np.zeros(ds.num_features, np.int32)),
                       key=lambda kb: kb[0])
        _same_blocks([b for _, b in keyed],
                     conflict_free_blocks(ds, attr_group=np.zeros(ds.num_features, np.int32)))


def test_iter_batches_and_truncation_equal_jax(files):
    for name in ("ragged", "train"):
        ts, js = _stream(files, name, 77), _jstream(files, name, 77)
        assert ts.max_row_nnz() == js.max_row_nnz() == int(np.diff(
            files["data"][name].indptr).max())
        for B, L in ((32, ts.max_row_nnz()), (64, 3), (1000, 1)):
            got, want = list(ts.iter_batches(B, L)), list(js.iter_batches(B, L))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _same_arrays(g, w)
            assert (ts.truncated_rows, ts.truncated_entries) == (
                js.truncated_rows, js.truncated_entries)
        assert ts.truncated_rows > 0


def test_padded_rows_equal_the_resident_layout(files):
    from libfm_tpu_torch.data.vector_layout import padded_rows_layout

    ds = files["data"]["ragged"]
    ids, vals = padded_rows_layout(ds.indptr, ds.cols, ds.vals)
    s = _stream(files, "ragged", 40)
    chunks = list(s.padded_rows(ids.shape[1], chunk_rows=7))
    assert [c[0] for c in chunks] == list(range(0, ds.num_rows, 7))
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]), ids)
    np.testing.assert_array_equal(np.concatenate([c[2] for c in chunks]), vals)


def test_flat_format_round_trip(files, tmp_path):
    ds = files["data"]["ragged"]
    tstream.save_flat(ds, str(tmp_path / "flat"))
    got = tstream.load_flat(str(tmp_path / "flat"))
    assert isinstance(got.cols, np.memmap)
    for key in ("indptr", "cols", "vals", "target"):
        _same_arrays([np.asarray(getattr(got, key))], [getattr(ds, key)])
    assert got.num_features == ds.num_features
    # the JAX package reads the same files
    j = jstream.load_flat(str(tmp_path / "flat"), mmap=False)
    np.testing.assert_array_equal(np.asarray(j.cols), ds.cols)


@pytest.mark.parametrize("cache", [1, 30, 700, 10_000_000])
def test_transpose_bytes_equal_jax_and_to_binary(files, tmp_path, cache):
    for name in ("ragged", "train"):
        src = files[name] + ".x"
        passes = ttranspose.transpose_streaming(src, str(tmp_path / "t.xt"), cache, 97)
        jtranspose.transpose_streaming(src, str(tmp_path / "j.xt"), cache, 97)
        assert filecmp.cmp(str(tmp_path / "t.xt"), str(tmp_path / "j.xt"), shallow=False)
        assert filecmp.cmp(str(tmp_path / "t.xt"), files[name] + ".xt", shallow=False)
        assert (passes > 2) == (cache <= 700)  # the counting pass and the blocks
    # the command line: out of core at a 0.001 MiB cache, in memory at 200
    for mib in ("0.001", "200"):
        assert ttranspose.main(["--ifile", files["train"] + ".x", "--ofile",
                                str(tmp_path / "m.xt"), "--cache_size", mib]) == 0
        assert filecmp.cmp(str(tmp_path / "m.xt"), files["train"] + ".xt", shallow=False)


# ---- the learners


def _init(n, k, seed=2):
    rng = np.random.default_rng(seed)
    return (np.float32(0.1), np.zeros(n, np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))


def _jdata(ds):
    out = JaxDataset(ds.indptr, ds.cols, ds.vals, ds.target, ds.num_features)
    out.min_target, out.max_target = ds.min_target, ds.max_target
    return out


def test_sgd_learn_stream_matches_jax_and_the_resident_learn(files):
    test = files["data"]["test"]
    n = files["data"]["train"].num_features
    kw = dict(num_iter=3, learn_rate=0.01, batch_size=128, seed=1, verbose=False)
    init = _init(n, 4)
    j = JaxSGD(JaxFMConfig(num_features=n, num_factors=4, regv=0.01), **kw)
    j.init_params(JaxFMParams(*(jnp.asarray(a) for a in init)))
    jh = j.learn_stream(_jstream(files, "train", 500), _jdata(test))
    runs = {}
    for how in ("stream", "resident"):
        t = SGDLearner(FMConfig(num_features=n, num_factors=4, regv=0.01), device="cpu", **kw)
        t.init_params(FMParams(*params_from_jax(*init, device="cpu")))
        if how == "stream":
            runs[how] = t.learn_stream(_stream(files, "train", 500), test), t
        else:
            runs[how] = t.learn(files["data"]["train"], test), t
    (th, t), (rh, r) = runs["stream"], runs["resident"]
    assert all(np.isnan(h[0]) for h in th)
    np.testing.assert_allclose([h[1] for h in th], [h[1] for h in jh], rtol=0, atol=1e-6)
    for got, want in ((t.params.w0, j.params.w0), (t.params.w, j.params.w),
                      (t.params.v, j.params.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert [h[1] for h in th] == [h[1] for h in rh]
    for key in ("w0", "w", "v"):
        assert torch.equal(getattr(t.params, key), getattr(r.params, key))


@pytest.mark.parametrize("val_streams", [False, True])
def test_sgda_learn_stream_matches_jax_and_the_resident_learn(files, val_streams):
    test, val = files["data"]["test"], files["data"]["val"]
    n = files["data"]["train"].num_features
    groups = (np.arange(n) >= 60).astype(np.int32)
    kw = dict(attr_group=groups, num_iter=3, learn_rate=0.005, batch_size=128, seed=1,
              verbose=False)
    init = _init(n, 4)
    j = JaxSGDA(JaxFMConfig(num_features=n, num_factors=4), **kw)
    j.init_params(JaxFMParams(*(jnp.asarray(a) for a in init)))
    jval = _jstream(files, "val", 300) if val_streams else _jdata(val)
    jh = j.learn_stream(_jstream(files, "train", 500), _jdata(test), jval)
    runs = {}
    for how in ("stream", "resident"):
        t = SGDALearner(FMConfig(num_features=n, num_factors=4), device="cpu", **kw)
        t.init_params(FMParams(*params_from_jax(*init, device="cpu")))
        if how == "stream":
            tval = _stream(files, "val", 300) if val_streams else val
            runs[how] = t.learn_stream(_stream(files, "train", 500), test, tval), t
        else:
            runs[how] = t.learn(files["data"]["train"], test, val), t
    (th, t), (rh, r) = runs["stream"], runs["resident"]
    np.testing.assert_allclose([h[1:3] for h in th], [h[1:3] for h in jh], rtol=0,
                               atol=1e-5)
    assert float(t.reg_v.max()) > 0  # the lambda steps ran
    for got, want in ((t.reg_w, j.reg_w), (t.reg_v, j.reg_v), (t.params.w0, j.params.w0),
                      (t.params.w, j.params.w), (t.params.v, j.params.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert [h[1:3] for h in th] == [h[1:3] for h in rh]
    for got, want in ((t.reg_w, r.reg_w), (t.reg_v, r.reg_v), *(
            (getattr(t.params, key), getattr(r.params, key)) for key in ("w0", "w", "v"))):
        assert torch.equal(got, want)


def _readings(lrn):
    return [{key: v for key, v in h.items() if key != "time"} for h in lrn.history]


def _same_run(got, want):
    assert _readings(got) == _readings(want)
    for key in STATE:
        assert torch.equal(got._final_state[key], want._final_state[key]), key


@pytest.fixture(scope="module")
def jax_als(files):
    """JAX's vector ALS with the train and the test set streamed, 5
    iterations, and its initial draw."""
    n, k = files["data"]["train"].num_features, 4
    j = JaxALS(JaxFMConfig(num_features=n, num_factors=k, regw=5, regv=5), num_iter=5,
               seed=1, verbose=False, dual_draws=False)
    j.case_major_stats = False
    j.learn(_jstream(files, "train", 300), _jstream(files, "test", 90))
    key = jax.random.PRNGKey(1)
    key, kw, kv = jax.random.split(key, 3)
    init = (np.float32(0.0), np.asarray(0.1 * jax.random.normal(kw, (n,), jnp.float32)),
            np.asarray(0.1 * jax.random.normal(kv, (n, k), jnp.float32)))
    return j, init


@pytest.mark.parametrize("streamed", ["train", "test", "both"])
def test_als_vector_streamed_matches_jax_and_the_resident_run(files, jax_als, streamed):
    j, init = jax_als
    tr, te = files["data"]["train"], files["data"]["test"]
    str_, ste = _stream(files, "train", 300), _stream(files, "test", 90)
    runs = []
    for data in ((tr, te), {"train": (str_, te), "test": (tr, ste), "both": (str_, ste)}[
            streamed]):
        t = ALSVectorLearner(FMConfig(num_features=tr.num_features, num_factors=4, regw=5,
                                      regv=5), num_iter=5, seed=1, verbose=False,
                             device="cpu", dual_draws=False, case_major_stats=False,
                             init_params=params_from_jax(*init, device="cpu"))
        t.flat_incr_test = False
        t.learn(*data)
        runs.append(t)
    resident, t = runs
    for hj, ht in zip(j.history, t.history, strict=True):
        for key in ("train", "test_this", "test_all"):
            assert abs(hj[key] - ht[key]) < 1e-4, (key, hj, ht)
    _same_run(t, resident)


def test_mcmc_vector_streamed_is_the_resident_run(files):
    """The learner's defaults (dual draws and case-major statistics on),
    the train and test sets streamed: the resident chain, bit for bit."""
    tr, te = files["data"]["train"], files["data"]["test"]
    runs = []
    for data in ((tr, te), (_stream(files, "train", 300), _stream(files, "test", 90))):
        t = MCMCVectorLearner(FMConfig(num_features=tr.num_features, num_factors=4),
                              num_iter=5, seed=2, verbose=False, device="cpu")
        t.learn(*data)
        runs.append(t)
    _same_run(runs[1], runs[0])
    assert not runs[1].incr_test


@pytest.mark.parametrize("cls", [MCMCVectorLearner, ALSVectorLearner, MCMCLearner,
                                 ALSLearner], ids=["vector", "als_vector", "exact",
                                                   "als_exact"])
def test_unstructured_data_streams_through_the_greedy_blocks(files, cls):
    tr, te = files["data"]["utrain"], files["data"]["utest"]
    runs = []
    for data in ((tr, te), (_stream(files, "utrain", 150), te)):
        t = cls(FMConfig(num_features=80, num_factors=4), num_iter=4, seed=3, verbose=False,
                device="cpu")
        t.learn(*data)
        runs.append(t)
    _same_run(runs[1], runs[0])


@pytest.mark.parametrize("streamed", ["train", "both"])
def test_exact_engine_streamed_is_the_resident_run(files, streamed):
    tr, te = files["data"]["train"], files["data"]["test"]
    runs = []
    for data in ((tr, te), (_stream(files, "train", 300),
                            te if streamed == "train" else _stream(files, "test", 90))):
        t = ALSLearner(FMConfig(num_features=tr.num_features, num_factors=4, regw=5, regv=5),
                       num_iter=4, seed=1, verbose=False, device="cpu", max_blocks=1)
        t.learn(*data)
        runs.append(t)
    _same_run(runs[1], runs[0])


def test_groups_partition_the_streamed_blocks(files):
    """With -meta groups the blocks are the groups' (users, items), as the
    resident build's; groups that share a row raise."""
    tr, te = files["data"]["train"], files["data"]["test"]
    groups = (np.arange(tr.num_features) >= 60).astype(np.int32)
    runs = []
    for data in ((tr, te), (_stream(files, "train", 300), te)):
        t = MCMCVectorLearner(FMConfig(num_features=tr.num_features, num_factors=4),
                              num_iter=3, seed=4, verbose=False, device="cpu",
                              attr_group=groups)
        t.learn(*data)
        runs.append(t)
    _same_run(runs[1], runs[0])
    bad = np.zeros(tr.num_features, np.int32)
    bad[-1] = 1  # group 0 holds a user and an item of one row
    t = MCMCVectorLearner(FMConfig(num_features=tr.num_features, num_factors=4),
                          num_iter=1, verbose=False, device="cpu", attr_group=bad)
    with pytest.raises(ValueError, match="conflict-free"):
        t.learn(_stream(files, "train", 300), te)


@pytest.mark.parametrize("cls", [MCMCVectorLearner, MCMCLearner], ids=["vector", "exact"])
def test_a_missing_transpose_raises(files, cls):
    s = _stream(files, "test", 100)  # no .xt beside it
    t = cls(FMConfig(num_features=files["data"]["train"].num_features, num_factors=2),
            num_iter=1, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="tools.transpose"):
        t.learn(s, files["data"]["test"])


def test_bounded_relation_reader_reads_the_resident_block(files, tmp_path):
    ds = files["data"]["ragged"]
    RelationData(ds.indptr, ds.cols, ds.vals, ds.num_features).save(str(tmp_path / "rel"))
    want = RelationData.load(str(tmp_path / "rel"))
    for budget in (1, 9, 10_000):
        got = RelationData.load(str(tmp_path / "rel"), entry_budget=budget)
        for key in ("indptr", "cols", "vals"):
            _same_arrays([getattr(got, key)], [getattr(want, key)])
        assert got.num_features == want.num_features == ds.num_features
