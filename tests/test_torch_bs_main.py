"""The port's relational (BS) vector engine with main-table features beside
the relations, against the JAX package, on the CPU.

The data is the JAX test's `_general_bs_problem` (two real-valued
relations of several blocks each beside a one-hot main field of 6 values;
225 train and 75 test cases), run on the BS engine (expand_max_ratio 0),
from the JAX engine's own initial draw:

- ALS regression (k=3, regw = regv = 0.3, 8 iterations): test_this and
  train within 1e-4 of JAX's at every iteration (2.2e-7 measured), the
  final w and V within 1e-4 of their largest magnitude.
- The port's BS ALS equals the port's flat ALS on the materialised join
  (`expand_join`) within 1e-5 at every iteration.
- MCMC regression (default priors, k=3, 15 iterations, seed 3): test_all
  within 0.03 of JAX's. The band is the spread measured on the CPU:
  test_all after 15 iterations over the port's seeds 0-7 lies in
  [0.1026, 0.1206], over JAX's seeds 0-3 in [0.1072, 0.1249]; the largest
  distance of a port run from a JAX run is 0.0223.
- Routing, the JAX engine's gates (libfm_tpu/learners/mcmc_rel_vector.py
  :524-528, 660-668): a main table, for regression or classification,
  takes the resync path with no test tail; classification without a
  main table keeps the tail and leaves the deferred path; regression on
  one relation with no main table keeps the deferred path.
- The plain rel_refresh with main rows, in train, tail and test modes and
  in both probit modes, against the JAX engine's `_chunk_pred` algebra
  (jnp) and JAX's samplers on seeded numpy inputs: predictions and Q
  within 1e-6 (f32 sums in another order), the probit expectations
  within 1e-5 of JAX's (the erf gap of ROADMAP §3: 6.2e-6), the drawn
  latents within 1e-6 of JAX's inverse-CDF transform on the same
  uniforms where the two erfs agree (|pred| <= 1, the half of the
  uniforms away from the untruncated tail), the correct count equal.
- The JAX test `test_bs_vector_randomized_matches_expansion`'s random
  problems (1-2 relations, with and without a main table, k 1-8,
  regression and probit) on the port alone: its BS ALS within 1e-5 of its
  flat ALS on the join.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.ops import samplers as jsamp
from libfm_tpu.tasks import TASK_CLASSIFICATION as JAX_TASK_CLASSIFICATION
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.relation import expand_join
from libfm_tpu_torch.data.vector_layout import padded_rows_layout
from libfm_tpu_torch.kernels.rel_refresh import rel_refresh, rel_refresh_plain
from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

from test_mcmc_rel_vector import _general_bs_problem, _single_rel_problem
from test_torch_bs_vector import _jax_init, _params
from test_torch_classification import _jax_transform
from test_torch_relation import to_port

ALS = dict(do_sample=False, do_multilevel=False)


def binarised(train, test):
    """Copies with targets +1 where y > 0 and -1 elsewhere, as the JAX test
    `test_bs_vector_classification_matches_expansion_band` binarises."""
    out = []
    for ds in (train, test):
        ds = copy.copy(ds)
        ds.target = np.where(ds.target > 0, 1.0, -1.0).astype(np.float32)
        ds.min_target, ds.max_target = -1.0, 1.0
        out.append(ds)
    return out


def learn_pair(train, test, nf, *, k, iters, seed, task=0, reg=None, **flags):
    """(JAX learner, port learner) on the BS engine over the same data,
    flags and initial parameters; `flags` may hold do_sample and
    do_multilevel."""
    regs = {} if reg is None else dict(regw=reg, regv=reg)
    kw = dict(num_iter=iters, seed=seed, verbose=False, **flags)
    j = JaxMCMC(JaxFMConfig(num_features=nf, num_factors=k, **regs),
                task=JAX_TASK_CLASSIFICATION if task else 0, **kw)
    t = MCMCVectorLearner(FMConfig(num_features=nf, num_factors=k, **regs),
                          task=TASK_CLASSIFICATION if task else 0, device="cpu",
                          init_params=params_from_jax(*_jax_init(nf, k, seed), device="cpu"),
                          **kw)
    for lr in (j, t):
        lr.expand_max_ratio = 0.0
    j.learn(train, test)
    t.learn(*to_port(train, test))
    assert j.relational_mode == t.relational_mode == "bs_vector"
    return j, t


@pytest.fixture(scope="module")
def general():
    return _general_bs_problem()


@pytest.fixture(scope="module")
def als_pair(general):
    return learn_pair(*general, k=3, reg=0.3, iters=8, seed=11, **ALS)


def test_als_with_main_table_matches_jax(als_pair):
    j, t = als_pair
    assert (t.incr_test, t.deferred) == (False, False)
    assert len(t.history) == len(j.history) == 8
    for a, b in zip(j.history, t.history):
        assert abs(a["test_this"] - b["test_this"]) < 1e-4, (a, b)
        assert abs(a["train"] - b["train"]) < 1e-4, (a, b)
    pj, pt = _params(j), _params(t)
    assert np.abs(pj - pt).max() <= 1e-4 * np.abs(pj).max()


def test_bs_als_with_main_table_equals_flat_on_join(general, als_pair):
    _, t = als_pair
    train, test, nf = general
    flat = MCMCVectorLearner(FMConfig(num_features=nf, num_factors=3, regw=0.3, regv=0.3),
                             num_iter=8, seed=11, verbose=False, device="cpu",
                             init_params=params_from_jax(*_jax_init(nf, 3, 11), device="cpu"),
                             **ALS)
    ttr, tte = to_port(train, test)
    flat.learn(expand_join(ttr), expand_join(tte))
    assert flat.relational_mode is None
    for ra, rb in zip(t.history, flat.history):
        assert abs(ra["test_this"] - rb["test_this"]) < 1e-5, (ra, rb)
        assert abs(ra["train"] - rb["train"]) < 1e-5, (ra, rb)


def test_mcmc_with_main_table_band_against_jax(general):
    j, t = learn_pair(*general, k=3, iters=15, seed=3)
    assert abs(j.history[-1]["test_all"] - t.history[-1]["test_all"]) < 0.03
    assert all(h["rejected"] == 0 for h in t.history)
    assert all(np.isfinite(h["test_all"]) and np.isfinite(h["train"]) for h in t.history)
    pred = t.predict()
    assert pred.shape == (general[1].num_rows,) and np.isfinite(pred).all()


@pytest.mark.parametrize("data,task,tail,deferred", [
    ("general", 0, False, False),
    ("general", 1, False, False),
    ("single", 1, True, False),
    ("single", 0, True, True),
])
def test_routing_follows_the_jax_gates(general, data, task, tail, deferred):
    """Which path the BS engine takes: the test tail needs an empty main
    table, the deferred path also regression and one relation."""
    train, test, nf = general if data == "general" else _single_rel_problem(seed=9)
    if task:
        train, test = binarised(train, test)
    lr = MCMCVectorLearner(FMConfig(num_features=nf, num_factors=2),
                           task=TASK_CLASSIFICATION if task else 0, num_iter=2, seed=1,
                           verbose=False, device="cpu")
    lr.expand_max_ratio = 0.0
    lr.learn(*to_port(train, test))
    assert lr.relational_mode == "bs_vector"
    assert (lr.incr_test, lr.deferred) == (tail, deferred)
    assert all(np.isfinite(h["test_all"]) for h in lr.history)


# ---- the plain rel_refresh with main rows against the JAX engine's algebra


def _jax_scores(w, V, rows, cols, vals, nb):
    """The JAX engine's `_rel_scores` for one relation: (qB, sqB, linB)."""
    vx = V[cols] * vals[:, None]
    seg = jax.ops.segment_sum
    return (seg(vx, rows, nb + 1), seg((vx * vx).sum(axis=1), rows, nb + 1),
            seg(w[cols] * vals, rows, nb + 1))


def _jax_chunk_pred(w0, w, V, cids, cpv, maps, scores):
    """The JAX engine's `_chunk_pred` (use_linear, use_bias)."""
    rows_v = V[cids] * cpv[..., None]
    Q = rows_v.sum(axis=1)
    sq = (rows_v * rows_v).sum(axis=(1, 2))
    lin = (w[cids] * cpv).sum(axis=1)
    for mb, (qB, sqB, linB) in zip(maps, scores):
        Q = Q + qB[mb]
        sq = sq + sqB[mb]
        lin = lin + linB[mb]
    return 0.5 * ((Q * Q).sum(axis=1) - sq) + lin + w0, Q


@pytest.fixture(scope="module")
def forward():
    """Seeded inputs: 600 cases of up to 3 main entries (rows padded with
    value 0) over 10 main features, joined to two relations (block rows of
    4 and 2 entries); k = 5; P scaled so that the predictions lie around
    [-2, 2]. Returns the port's inputs and JAX's predictions and Q."""
    rng = np.random.default_rng(12)
    nc, k, n_main = 600, 5, 10
    lens = rng.integers(0, 4, nc)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    cols = np.concatenate([np.sort(rng.choice(n_main, m, replace=False)) for m in lens])
    vals = rng.normal(1.0, 0.5, len(cols)).astype(np.float32)
    ids, pv = padded_rows_layout(indptr, cols.astype(np.int32), vals)
    rels, first, n = [], 0, n_main
    for nb, W, nf in ((20, 4, 30), (9, 2, 12)):
        rcols = np.stack([rng.choice(nf, W, replace=False) for _ in range(nb)]).ravel() + n
        rels.append((np.repeat(np.arange(nb), W), rcols, rng.normal(0, 1, nb * W)
                     .astype(np.float32), nb, rng.integers(0, nb, nc), first))
        first += nb + 1
        n += nf
    P = rng.normal(0, 0.35, (n, k + 1)).astype(np.float32)
    w0 = np.float32(0.1)
    w, V = jnp.asarray(P[:, 0]), jnp.asarray(P[:, 1:])
    scores = [_jax_scores(w, V, r, c, v, nb) for r, c, v, nb, _, _ in rels]
    pred, Q = _jax_chunk_pred(w0, w, V, jnp.asarray(ids), jnp.asarray(pv),
                              [m for *_, m, _ in rels], scores)
    SC = np.concatenate([np.concatenate([np.asarray(q), np.asarray(s)[:, None],
                                         np.asarray(li)[:, None]], axis=1)
                         for q, s, li in scores])
    maps = np.stack([m + f for *_, m, f in rels]).astype(np.int32)
    port = dict(SC=torch.as_tensor(SC), maps=torch.as_tensor(maps), w0=torch.tensor(w0),
                P=torch.as_tensor(P), ids=torch.as_tensor(ids), vals=torch.as_tensor(pv))
    return port, np.asarray(pred), np.asarray(Q), rng


def _main(port):
    return dict(P=port["P"], ids=port["ids"], vals=port["vals"])


def test_rel_refresh_plain_with_main_rows_matches_jax(forward):
    port, pred, Q, rng = forward
    nc, k = Q.shape
    args = (port["SC"], port["maps"], port["w0"])
    got = rel_refresh_plain(*args, **_main(port)).numpy()
    np.testing.assert_allclose(got, pred, rtol=1e-6, atol=1e-6)
    # the wrapper on CPU tensors runs the plain version
    np.testing.assert_array_equal(rel_refresh(*args, **_main(port)).numpy(), got)
    tail = torch.empty(nc, k + 1)
    rel_refresh_plain(*args, tail, **_main(port))
    np.testing.assert_allclose(tail[:, 0].numpy(), pred, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tail[:, 1:].numpy(), Q, rtol=1e-6, atol=1e-6)
    y = rng.normal(0, 1, nc).astype(np.float32)
    A = torch.empty(nc, k + 1)
    m = rel_refresh_plain(*args, A, torch.as_tensor(y), min_target=-1.5, max_target=1.5,
                          **_main(port))
    np.testing.assert_allclose(A[:, 0].numpy(), pred - y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(A[:, 1:].numpy(), Q, rtol=1e-6, atol=1e-6)
    want = ((np.clip(pred, -1.5, 1.5) - y) ** 2).sum()
    assert abs(m.item() - want) <= 1e-5 * want


@pytest.mark.parametrize("mode", ["sample", "mean"])
def test_rel_refresh_plain_probit_matches_jax_samplers(forward, mode):
    port, pred, Q, rng = forward
    nc, k = Q.shape
    y = np.where(rng.random(nc) < 0.5, 1.0, -1.0).astype(np.float32)
    # the half of the uniforms away from the untruncated tail of each side
    U = np.where(y >= 0, 0.5 * rng.random(nc), 0.5 + 0.5 * rng.random(nc)).astype(np.float32)
    A, lat = torch.empty(nc, k + 1), torch.empty(nc)
    c = rel_refresh_plain(port["SC"], port["maps"], port["w0"], A, torch.as_tensor(y),
                          probit=mode, U=torch.as_tensor(U) if mode == "sample" else None,
                          latent=lat, **_main(port))
    lat = lat.numpy()
    p_t = A[:, 0].numpy() + lat
    np.testing.assert_allclose(p_t, pred, rtol=1e-6, atol=2e-6)
    np.testing.assert_allclose(A[:, 1:].numpy(), Q, rtol=1e-6, atol=1e-6)
    cdf = np.asarray(jsamp.cdf_gaussian(jnp.asarray(pred)))
    correct = ((cdf >= 0.5) & (y > 0)) | ((cdf < 0.5) & (y < 0))
    assert c.item() == correct.sum()
    assert ((lat >= 0) == (y >= 0)).all()
    if mode == "mean":
        want = np.where(y >= 0, np.asarray(jsamp.left_tn_expectation(jnp.asarray(p_t))),
                        np.asarray(jsamp.right_tn_expectation(jnp.asarray(p_t))))
        np.testing.assert_allclose(lat, want, rtol=0, atol=1e-5)
        return
    inf = np.full(nc, np.inf, np.float32)
    want = p_t + np.where(y >= 0, _jax_transform(-p_t, inf, U), _jax_transform(-inf, -p_t, U))
    bulk = np.abs(p_t) <= 1.0
    assert bulk.sum() > nc // 4
    np.testing.assert_allclose(lat[bulk], want[bulk], rtol=0, atol=1e-6)


# ---- the port's BS engine against its own flat engine on the join


def _random_problem(trial):
    """The JAX test `test_bs_vector_randomized_matches_expansion`'s problem
    for `trial` (the same numpy stream), as the port's data: 1-2 relations
    of random widths and cardinalities, one-hot or gaussian values, a main
    table of 0, 4 or 7 one-hot features, k in {1, 2, 4, 8}, the linear
    term on or off, regression or classification. Returns (train, test,
    FMConfig, learner keywords)."""
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.data.relation import RelationData, RelationJoin

    rng = np.random.default_rng(1000 + trial)
    n_rel = rng.integers(1, 3)
    n_main = int(rng.choice([0, 4, 7]))
    n_cases = int(rng.integers(80, 400))
    rels, offs = [], n_main
    for _ in range(n_rel):
        nb = int(rng.integers(3, 20))
        W = int(rng.integers(1, 6))
        m = int(rng.integers(2, 7))
        c = rng.integers(0, m, (nb, W))
        cols = (np.arange(W)[None, :] * m + c).astype(np.int32)
        vals = rng.standard_normal((nb, W)).astype(np.float32)
        if rng.random() < 0.3:
            vals = np.ones_like(vals)
        rd = RelationData(np.arange(nb + 1, dtype=np.int64) * W, cols.ravel(), vals.ravel(),
                          W * m)
        rd.attr_offset = offs
        offs += W * m
        rels.append(rd)
    y = rng.standard_normal(n_cases).astype(np.float32)
    maps = [rng.integers(0, rd.num_cases, n_cases).astype(np.int32) for rd in rels]
    split = max(10, n_cases // 4)

    def build(sl):
        nc = len(y[sl])
        if n_main:
            main = rng.integers(0, n_main, n_cases).astype(np.int32)[sl]
            ds = Dataset(np.arange(nc + 1, dtype=np.int64), main, np.ones(nc, np.float32),
                         y[sl], n_main)
        else:
            ds = Dataset(np.zeros(nc + 1, np.int64), np.empty(0, np.int32),
                         np.empty(0, np.float32), y[sl], 0)
        ds.relations = [RelationJoin(rd, mp[sl]) for rd, mp in zip(rels, maps)]
        return ds

    train, test = build(slice(split, None)), build(slice(None, split))
    k = int(rng.choice([1, 2, 4, 8]))
    use_linear = bool(rng.random() < 0.8)
    task = TASK_CLASSIFICATION if rng.random() < 0.3 else 0
    rng.random()  # the JAX test's stream
    if task:
        train, test = binarised(train, test)
    cfg = FMConfig(num_features=offs, num_factors=k, regw=0.3, regv=0.3,
                   use_linear=use_linear)
    kw = dict(num_iter=6, seed=int(rng.integers(1, 99)), verbose=False, task=task,
              device="cpu", **ALS)
    return train, test, cfg, kw


@pytest.mark.parametrize("trial", [0, 3, 5, 13, 17, 1, 28])
def test_bs_als_equals_flat_on_join_randomized(trial):
    """The JAX test's five trials (tests/test_mcmc_rel_vector.py:190, which
    holds JAX's BS engine to JAX's flat engine within 5e-4) and two more
    with a main table and probit classification (28: without the linear
    term): the port's BS ALS against the port's flat ALS on the
    materialised join, the same seed, 6 iterations, test_this and train
    within 1e-5 (over trials 0-39 the largest distance is 5.1e-6)."""
    train, test, cfg, kw = _random_problem(trial)
    bs = MCMCVectorLearner(cfg, **kw)
    bs.expand_max_ratio = 0.0
    hb = bs.learn(train, test)
    assert bs.relational_mode == "bs_vector"
    flat = MCMCVectorLearner(cfg, **kw)
    hf = flat.learn(expand_join(train), expand_join(test))
    for ra, rb in zip(hb, hf):
        assert abs(ra["test_this"] - rb["test_this"]) < 1e-5, (ra, rb)
        assert abs(ra["train"] - rb["train"]) < 1e-5, (ra, rb)
