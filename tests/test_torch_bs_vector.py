"""The port's relational (BS) vector engine against the JAX engine, on the
CPU, from identical parameters (the JAX engine's own initial draw).

- ALS, resync path (make_relational_problem: two one-hot relations,
  k=4, 8 iterations): test_this and train within 1e-4 of JAX's at every
  iteration, the final w and V within 1e-4 of their largest magnitude.
- ALS, deferred path (_single_rel_problem(seed=9): one relation, k=3,
  8 iterations): test_this within 1e-4 of JAX's at every iteration, the
  train metric within 1e-4 at the refresh iterations, and each final
  prediction within 1e-3 (JAX's own deferred and resync paths end 7.4e-4
  apart). Between refreshes the deferred train metric is
  the closed-form sum of e^2, whose f32 terms cancel to ~1e-3 of their
  size here: JAX's value lies up to 2.4e-4 from its own resync path's
  exact metric of the same chain, and the port (its sums in float64 over
  f32 caches) up to 5e-5; the port's is held within 1e-4 of JAX's resync
  path. The final w and V are not compared on this problem: its
  parameters are not identified (JAX's own deferred and resync paths end
  0.70 of the largest magnitude apart, their test RMSE 2e-5 apart).
- The port's BS ALS equals the port's flat ALS on the materialised join
  within 1e-5; its deferred and resync paths agree within 2e-4; without
  the incremental test tail within 1e-5.
- MCMC (_single_rel_problem, k=4, 10 iterations): the port's test_all
  within 0.03 of JAX's, no rejected draw. Draws cannot match one for one:
  torch's generators are not JAX's threefry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.learners.mcmc import dispatch_chunks
from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig

from test_mcmc_rel_vector import _single_rel_problem
from test_mcmc_relational import make_relational_problem
from test_torch_relation import to_port

ALS = dict(do_sample=False, do_multilevel=False)


def _jax_init(n, k, seed):
    """The BS engine's initial draw (mcmc_rel_vector.py:705-708)."""
    key = jax.random.PRNGKey(seed)
    key, kw, kv = jax.random.split(key, 3)
    w = 0.1 * jax.random.normal(kw, (n,), dtype=jnp.float32)
    V = 0.1 * jax.random.normal(kv, (n, k), dtype=jnp.float32)
    return np.float32(0.0), np.asarray(w), np.asarray(V)


def _run(train, test, nf, k, reg, iters, seed, fat=True, **flags):
    """(JAX learner, port learner) over the same data, flags and initial
    parameters."""
    kw = dict(num_iter=iters, seed=seed, verbose=False,
              **{key: flags.pop(key) for key in ("do_sample", "do_multilevel")
                 if key in flags})
    regs = {} if reg is None else dict(regw=reg, regv=reg)
    j = JaxMCMC(JaxFMConfig(num_features=nf, num_factors=k, **regs), **kw)
    t = MCMCVectorLearner(FMConfig(num_features=nf, num_factors=k, **regs),
                          device="cpu", **kw,
                          init_params=params_from_jax(*_jax_init(nf, k, seed), device="cpu"))
    for lr in (j, t):
        if fat:
            lr.expand_max_ratio = 0.0
        for key, v in flags.items():
            setattr(lr, key, v)
    ttr, tte = to_port(train, test)
    j.learn(train, test)
    t.learn(ttr, tte)
    assert j.relational_mode == t.relational_mode
    return j, t


@pytest.fixture(scope="module")
def single():
    train, test, nf = _single_rel_problem(seed=9)
    return train, test, nf


@pytest.fixture(scope="module")
def single_als(single):
    out = {}
    for deferred in (True, False):
        out[deferred] = _run(*single, k=3, reg=0.2, iters=8, seed=5, bs_deferred=deferred,
                             **ALS)
    return out


@pytest.fixture(scope="module")
def two_als():
    train, test, jtrain, jtest, nf = make_relational_problem()
    return _run(train, test, nf, k=4, reg=0.5, iters=8, seed=7, **ALS), (jtrain, jtest, nf)


def _params(lr):
    st = lr._final_state
    if isinstance(st, dict):
        return np.concatenate([st["w"].numpy()[:, None], st["V"].numpy()], axis=1)
    p = lr.get_params()
    return np.concatenate([np.asarray(p.w)[:, None], np.asarray(p.v)], axis=1)


def test_als_resync_path_matches_jax(two_als):
    (j, t), _ = two_als
    assert t.relational_mode == "bs_vector"
    assert len(t.history) == len(j.history) == 8
    for a, b in zip(j.history, t.history):
        assert abs(a["test_this"] - b["test_this"]) < 1e-4, (a, b)
        assert abs(a["train"] - b["train"]) < 1e-4, (a, b)
    pj, pt = _params(j), _params(t)
    assert np.abs(pj - pt).max() <= 1e-4 * np.abs(pj).max()


def test_als_deferred_path_matches_jax(single, single_als):
    (j, t), (j_resync, _) = single_als[True], single_als[False]
    assert t.relational_mode == "bs_vector"
    refresh = {i0 + L - 1 for i0, L in dispatch_chunks(0, 8, t.refresh_every)}
    for a, b, r in zip(j.history, t.history, j_resync.history):
        assert abs(a["test_this"] - b["test_this"]) < 1e-4, (a, b)
        exact = a if a["iter"] in refresh else r
        assert abs(exact["train"] - b["train"]) < 1e-4, (exact, b)
        # between refreshes JAX's deferred path reports its closed-form
        # float32 sum, which cancels (2.4e-4 from the exact value here);
        # the port sums it in float64, so the two differ by that error
        assert abs(a["train"] - b["train"]) < 5e-4, (a, b)
    # per case, the final predictions drift as the unidentified parameters
    # do: JAX's own two paths end 7.4e-4 apart
    jp = j.predict(single[1])
    assert np.abs(j_resync.predict(single[1]) - jp).max() < 1e-3
    assert np.abs(t.predict() - jp).max() < 1e-3


def test_als_deferred_and_resync_paths_agree(single_als):
    a, b = single_als[True][1], single_als[False][1]
    for ra, rb in zip(a.history, b.history):
        assert abs(ra["test_this"] - rb["test_this"]) < 2e-4, (ra, rb)


def test_bs_als_equals_flat_on_join(two_als):
    (_, t), (jtrain, jtest, nf) = two_als
    flat = MCMCVectorLearner(FMConfig(num_features=nf, num_factors=4, regw=0.5, regv=0.5),
                             num_iter=8, seed=7, verbose=False, device="cpu",
                             init_params=params_from_jax(*_jax_init(nf, 4, 7), device="cpu"),
                             **ALS)
    flat.learn(*to_port(jtrain, jtest))
    assert flat.relational_mode is None
    for ra, rb in zip(t.history, flat.history):
        assert abs(ra["test_this"] - rb["test_this"]) < 1e-5, (ra, rb)
        assert abs(ra["train"] - rb["train"]) < 1e-5, (ra, rb)


def test_thin_join_runs_expanded_like_the_flat_engine(two_als):
    """By default make_relational_problem's join is thin: the learner
    expands it and runs the flat engine, as JAX routes it."""
    (_, t), (jtrain, jtest, nf) = two_als
    train, test, *_ = make_relational_problem()
    cfg = FMConfig(num_features=nf, num_factors=4, regw=0.5, regv=0.5)
    init = params_from_jax(*_jax_init(nf, 4, 7), device="cpu")
    runs = []
    for data in (to_port(train, test), to_port(jtrain, jtest)):
        lr = MCMCVectorLearner(cfg, num_iter=3, seed=7, verbose=False, device="cpu",
                               init_params=init, **ALS)
        lr.learn(*data)
        runs.append(lr)
    assert runs[0].relational_mode == "expanded"
    assert [h["test_this"] for h in runs[0].history] == [h["test_this"]
                                                         for h in runs[1].history]


@pytest.mark.parametrize("deferred", [True, False])
def test_without_the_incremental_tail_the_predictions_agree(single, deferred):
    """bs_incr_test=False predicts the test set from P every iteration (and
    takes the resync path); the incremental tail gives the same test_this."""
    runs = []
    for incr in (True, False):
        lr = MCMCVectorLearner(FMConfig(num_features=single[2], num_factors=3, regw=0.2,
                                        regv=0.2), num_iter=5, seed=5, verbose=False,
                               device="cpu", **ALS)
        lr.expand_max_ratio = 0.0
        lr.bs_deferred = deferred
        lr.bs_incr_test = incr
        lr.learn(*to_port(*single[:2]))
        runs.append(lr)
    for ra, rb in zip(*(r.history for r in runs)):
        assert abs(ra["test_this"] - rb["test_this"]) < (2e-4 if deferred else 1e-5)


def test_mcmc_band_against_jax():
    train, test, nf = _single_rel_problem()
    j, t = _run(train, test, nf, k=4, reg=None, iters=10, seed=3)
    assert t.relational_mode == "bs_vector"
    assert abs(j.history[-1]["test_all"] - t.history[-1]["test_all"]) < 0.03
    assert all(h["rejected"] == 0 for h in t.history)
    assert all(np.isfinite(h["test_all"]) and np.isfinite(h["train"]) for h in t.history)
