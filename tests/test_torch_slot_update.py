"""The flat engine's slot-scatter update and incremental test tail (K4b)
in the port, against float64 and the JAX engine, on the CPU.

- `slot_update_plain` against a float64 numpy version of the JAX
  engine's `upd_chunk` and against `dense_update_plain` on the same block
  (one-hot and valued, slots on a tenth and on nine tenths of the cases,
  two features with no slot): within 1e-6 of each column's largest
  magnitude; the same bits on a second call; no slot leaves A as it is.
- `ALSVectorLearner(dense_update=False)` against the JAX engine's, from
  the JAX engine's initial draw: test_this within 1e-4 at every one of 6
  iterations (refresh every 3).
- Default flags on ml_small with one seeded multi-hot field whose blocks
  cover fewer than a quarter of the cases: both packages take the slot
  scatter for exactly those blocks (read from the JAX engine's own
  layouts) and the ALS trajectories agree within 1e-4.
- `flat_incr_test` (set as an attribute; JAX reads it with getattr) on
  ml_small with a test set that holds a feature unseen in train: the ALS
  trajectory within 1e-4 of the JAX engine's, and within 1e-5 of the
  port's own run without the tail at every iteration after the first
  refresh; before it the tail has not seen the unseen feature's draw
  (ALS: its prior mean), as in JAX. The tail steps aside where JAX's
  does.
- The MCMC bands of both options are in test_torch_slot_update_mcmc.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libfm_tpu.learners.mcmc_vector as jmv
from libfm_tpu.data.dataset import Dataset as JaxDataset
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.batching import conflict_free_blocks
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.synth import movielens_like
from libfm_tpu_torch.kernels.dense_update import dense_update_plain, update_table
from libfm_tpu_torch.kernels.slot_update import slot_update, slot_update_plain
from libfm_tpu_torch.learners.mcmc_vector import (
    ALSVectorLearner,
    DevBlock,
    dense_coverage,
    tail_columns,
)
from libfm_tpu_torch.models.fm import FMConfig

K = 8
ITERS, REFRESH = 6, 3


def _jax_init(n, k, seed, init_stdev=0.1):
    """The JAX engine's initial draw (mcmc_vector.py learn: PRNGKey(seed),
    split 3, normals for w then V)."""
    key = jax.random.PRNGKey(seed)
    key, kw, kv = jax.random.split(key, 3)
    w = init_stdev * jax.random.normal(kw, (n,), dtype=jnp.float32)
    V = init_stdev * jax.random.normal(kv, (n, k), dtype=jnp.float32)
    return np.float32(0.0), np.asarray(w), np.asarray(V)


def _jax(ds):
    return JaxDataset(ds.indptr, ds.cols, ds.vals, ds.target, ds.num_features)


def _ml_small():
    return movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)


def _multi_hot(seed=11, tags=60, share=0.1, most=2):
    """ml_small with one more field: a seeded share of the rows (train and
    test) holds 1 to `most` of `tags` tag features (value 1), so the
    field's conflict-free blocks each cover fewer than a quarter of the
    cases. Returns (train, test, groups: users 0, items 1, tags 2)."""
    rng = np.random.default_rng(seed)
    tr, te = _ml_small()
    n = tr.num_features
    out = []
    for ds in (tr, te):
        indptr, cols = [0], []
        for r in range(ds.num_rows):
            row = list(ds.cols[ds.indptr[r]:ds.indptr[r + 1]])
            if rng.random() < share:
                row += sorted(n + rng.choice(tags, rng.integers(1, most + 1), replace=False))
            cols += row
            indptr.append(len(cols))
        cols = np.asarray(cols, np.int32)
        out.append(Dataset(np.asarray(indptr, np.int64), cols, np.ones(len(cols), np.float32),
                           ds.target, n + tags))
    users = int(tr.cols[tr.indptr[:-1]].max()) + 1
    groups = np.concatenate([np.zeros(users, np.int32), np.ones(n - users, np.int32),
                             np.full(tags, 2, np.int32)])
    return out[0], out[1], groups


def _unseen_test(extra_rows=300):
    """ml_small's train set over one more feature, which only the test set
    holds: `extra_rows` of its rows carry it (value 1)."""
    tr, te = _ml_small()
    n = tr.num_features
    indptr, cols = [0], []
    for r in range(te.num_rows):
        cols += list(te.cols[te.indptr[r]:te.indptr[r + 1]]) + ([n] if r < extra_rows else [])
        indptr.append(len(cols))
    cols = np.asarray(cols, np.int32)
    te2 = Dataset(np.asarray(indptr, np.int64), cols, np.ones(len(cols), np.float32),
                  te.target, n + 1)
    tr2 = Dataset(tr.indptr, tr.cols, tr.vals, tr.target, n + 1)
    return tr2, te2


def _als_pair(train, test, groups=None, port_kw=None, jax_kw=None, flags=None):
    n = train.num_features
    cfg = dict(num_features=n, num_factors=K, regw=5, regv=5)
    ja = jmv.ALSVectorLearner(JaxFMConfig(**cfg), num_iter=ITERS, seed=1, verbose=False,
                              refresh_every=REFRESH, attr_group=groups, **(jax_kw or {}))
    ta = ALSVectorLearner(FMConfig(**cfg), num_iter=ITERS, seed=1, verbose=False,
                          device="cpu", refresh_every=REFRESH, attr_group=groups,
                          init_params=params_from_jax(*_jax_init(n, K, 1), device="cpu"),
                          **(port_kw or {}))
    for key, v in (flags or {}).items():
        setattr(ja, key, v)
        setattr(ta, key, v)
    ja.learn(_jax(train), _jax(test))
    ta.learn(train, test)
    assert len(ja.history) == len(ta.history) == ITERS
    return ja, ta


def _assert_same_trajectory(ja, ta, tol=1e-4):
    for hj, ht in zip(ja.history, ta.history):
        assert abs(hj["test_this"] - ht["test_this"]) < tol, (hj, ht)
        assert abs(hj["train"] - ht["train"]) < tol, (hj, ht)
        assert ht["rejected"] == 0


# ------------------------------------------------------------ the kernel

def _upd_chunk_f64(A, case, val, feat, theta_old, theta_new):
    """The JAX engine's upd_chunk in float64 numpy: for each slot,
    dpred = x (dw + Q . dv) - x^2 (v_old . dv), dQ = x dv, added at its case."""
    A = A.astype(np.float64).copy()
    to, tn = theta_old.astype(np.float64), theta_new.astype(np.float64)
    delta = tn - to
    s = (to[:, 1:] * delta[:, 1:]).sum(1)
    x = val.astype(np.float64)
    Q = A[case, 1:]
    dpred = x * (delta[feat, 0] + (Q * delta[feat, 1:]).sum(1)) - x * x * s[feat]
    A[case, 0] += dpred
    A[case, 1:] += x[:, None] * delta[feat, 1:]
    return A


def _col_rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs(a - b).max(0) / np.maximum(np.abs(b).max(0), 1e-30)).max()


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("valued", [False, True])
@pytest.mark.parametrize("coverage", [0.1, 0.9])
def test_slot_update_plain_matches_float64_and_dense_update(k, valued, coverage):
    rng = np.random.default_rng(k * 10 + valued)
    nc, F = 500, 17
    case = rng.choice(nc, int(coverage * nc), replace=False).astype(np.int32)
    feat = np.sort(rng.integers(0, F - 2, case.size)).astype(np.int32)  # 2 features unused
    val = (rng.normal(1, 0.3, case.size) if valued else np.ones(case.size)).astype(np.float32)
    A = rng.normal(0, 1, (nc, k + 1)).astype(np.float32)
    th_old = rng.normal(0, 0.3, (F, k + 1)).astype(np.float32)
    th_new = th_old + rng.normal(0, 0.1, (F, k + 1)).astype(np.float32)
    tab = update_table(torch.tensor(th_old), torch.tensor(th_new))
    got = slot_update(torch.tensor(A), torch.tensor(case), torch.tensor(val),
                      torch.tensor(feat), tab)
    want = _upd_chunk_f64(A, case, val, feat, th_old, th_new)
    assert _col_rel_err(got.numpy(), want) < 1e-6
    col = np.full(nc, F, np.int32)
    col[case] = feat
    x = np.zeros(nc, np.float32)
    x[case] = val
    dense = dense_update_plain(torch.tensor(A), torch.tensor(col),
                               torch.tensor(x) if valued else None, tab)
    assert _col_rel_err(got.numpy(), dense.numpy()) < 1e-6
    # the rows of cases without a slot are untouched
    rest = np.setdiff1d(np.arange(nc), case)
    assert np.array_equal(got.numpy()[rest], A[rest])


def test_slot_update_plain_is_repeatable_and_takes_no_slot():
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.normal(0, 1, (40, 5)).astype(np.float32))
    case = torch.tensor(rng.permutation(40)[:25].astype(np.int32))
    feat = torch.tensor(rng.integers(0, 6, 25).astype(np.int32))
    val = torch.ones(25)
    th = torch.tensor(rng.normal(0, 0.2, (6, 5)).astype(np.float32))
    tab = update_table(th, th * 1.5)
    a = slot_update_plain(A.clone(), case, val, feat, tab)
    b = slot_update_plain(A.clone(), case, val, feat, tab)
    assert torch.equal(a, b)
    # an empty slot list leaves A as it is
    assert torch.equal(slot_update(A.clone(), case[:0], val[:0], feat[:0], tab), A)


# ------------------------------------------------------------ the gate

@pytest.mark.parametrize("entries,rows,dense", [(0, 10, False), (2, 10, True),
                                                (1, 10, False), (24, 100, False),
                                                (25, 100, True), (9_000_000, 9_000_000, True)])
def test_dense_coverage_is_the_jax_rule(entries, rows, dense):
    assert dense_coverage(entries, rows) is dense


def _jax_scatter_blocks(monkeypatch, learner, train, test):
    """The JAX engine's choice per block, in block order: True where its
    layout has no dense update arrays (the slot scatter). Its learn()
    builds every DevLayout, then stops at the first random key."""
    seen = []
    real = jmv.DevLayout

    def record(**kw):
        seen.append(kw["up_col"] is None)
        return real(**kw)

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    monkeypatch.setattr(jmv, "DevLayout", record)
    monkeypatch.setattr(jax.random, "PRNGKey", stop)
    with pytest.raises(Stop):
        learner.learn(train, test)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("dense_update", [True, False])
def test_scatter_blocks_match_jax(monkeypatch, dense_update):
    tr, te, g = _multi_hot()
    n = tr.num_features
    jl = jmv.ALSVectorLearner(JaxFMConfig(num_features=n, num_factors=K), num_iter=1,
                              verbose=False, attr_group=g, dense_update=dense_update)
    jax_sel = _jax_scatter_blocks(monkeypatch, jl, _jax(tr), _jax(te))
    blocks = [DevBlock(b, g[b.features], tr.num_rows, "cpu", K, True, True,
                       dense_update=dense_update)
              for b in conflict_free_blocks(tr, attr_group=g)]
    port_sel = [b.scatter_update for b in blocks]
    assert port_sel == jax_sel
    if dense_update:
        # the user and item blocks update case-major, the tag blocks by
        # the slot scatter
        assert port_sel[:2] == [False, False] and all(port_sel[2:]) and len(port_sel) > 2
    else:
        assert all(port_sel)
    for b in blocks:
        assert (b.up_col is None) is b.scatter_update
        if b.scatter_update:
            assert not b.case_major
            assert b.upd_case.shape == b.upd_val.shape == b.upd_feat.shape
            assert b.upd_feat.shape[0] == int(b.feat_off[-1] + b.dual_off[-1])


# ------------------------------------------------------------ trajectories

def test_als_slot_scatter_matches_jax():
    tr, te = _ml_small()
    ja, ta = _als_pair(tr, te, port_kw=dict(dense_update=False),
                       jax_kw=dict(dense_update=False))
    _assert_same_trajectory(ja, ta)


def test_als_default_flags_on_a_low_coverage_field_matches_jax():
    tr, te, g = _multi_hot()
    ja, ta = _als_pair(tr, te, groups=g)
    _assert_same_trajectory(ja, ta)


@pytest.fixture(scope="module")
def tail_runs():
    tr, te = _unseen_test()
    ja, ta = _als_pair(tr, te, flags=dict(flat_incr_test=True))
    n = tr.num_features
    plain = ALSVectorLearner(
        FMConfig(num_features=n, num_factors=K, regw=5, regv=5), num_iter=ITERS, seed=1,
        verbose=False, device="cpu", refresh_every=REFRESH,
        init_params=params_from_jax(*_jax_init(n, K, 1), device="cpu"))
    plain.learn(tr, te)
    return ja, ta, plain


def test_als_test_tail_matches_jax(tail_runs):
    ja, ta, _ = tail_runs
    assert ta.incr_test
    _assert_same_trajectory(ja, ta)


def test_test_tail_matches_the_refreshed_prediction(tail_runs):
    _, ta, plain = tail_runs
    got = [h["test_this"] for h in ta.history]
    want = [h["test_this"] for h in plain.history]
    # the refreshes end iterations 0, 2 and 5 (dispatch_chunks); the tail
    # reads its prediction before the refresh, so at iteration 0 it still
    # holds the unseen feature's initial draw, which ALS's unobserved draw
    # (its prior mean) replaced: JAX's tail sees only the blocks' updates
    # and w0 between refreshes
    assert abs(got[0] - want[0]) > 1e-4, (got, want)
    for it in range(1, ITERS):
        assert abs(got[it] - want[it]) < 1e-5, (it, got, want)
    assert np.allclose(ta.get_params().v.numpy(), plain.get_params().v.numpy(), atol=1e-5)


def test_test_tail_steps_aside_where_jax_does():
    tr, te = _ml_small()
    n = tr.num_features
    users = np.asarray(conflict_free_blocks(tr)[0].features)
    # a test case that holds two features of one block
    two = Dataset(np.array([0, 2]), np.sort(users[:2]).astype(np.int32),
                  np.ones(2, np.float32), te.target[:1], n)
    assert tail_columns(users, True, two, n) is None
    # a one-hot block meeting a test value other than 1
    valued = Dataset(te.indptr, te.cols, np.full(te.nnz, 2.0, np.float32), te.target, n)
    assert tail_columns(users, True, valued, n) is None
    col, val = tail_columns(users, False, valued, n)
    assert (val[col != len(users)] == 2.0).all() and (val[col == len(users)] == 0).all()
    col, val = tail_columns(users, True, te, n)
    assert val is None and (col != len(users)).all()  # every test case has a user
    # the learner runs without the tail, and raises nothing: on a block on
    # the slot scatter, and on the valued test set
    for test, kw in ((te, dict(dense_update=False)), (valued, {})):
        lrn = ALSVectorLearner(FMConfig(num_features=n, num_factors=K), num_iter=1,
                               verbose=False, device="cpu", **kw)
        lrn.flat_incr_test = True
        lrn.learn(tr, test)
        assert lrn.incr_test is False
