"""The port's vector engine against the JAX engine, on the CPU, at the
ml_small size (movielens_like(120, 90, 8000, seed=3), k=8).

- ALS trajectory parity: JAX ALSVectorLearner (slot path: dual draws and
  case-major statistics off, on both sides) and the port from the same
  initial draw.
  test_this agrees within 1e-4 at every iteration and the final w, V
  within 1e-3 — f32 sums taken in another order.
- MCMC band: both MCMC learners over 12 iterations land within 0.03 of
  each other's test_all with no rejected draw. Draws cannot match one
  for one: torch's generators are not JAX's threefry.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.data.synth import movielens_like as jax_movielens_like
from libfm_tpu.learners.mcmc import dispatch_chunks as jax_dispatch_chunks
from libfm_tpu.learners.mcmc_vector import ALSVectorLearner as JaxALS
from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.relation import RelationData, RelationJoin
from libfm_tpu_torch.data.synth import movielens_like
from libfm_tpu_torch.learners.mcmc import dispatch_chunks
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig

K = 8
ITERS = 12


@pytest.fixture(scope="module")
def ml_small():
    return movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)


@pytest.fixture(scope="module")
def jax_ml_small():
    return jax_movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)


def _jax_init(n, k, seed, init_stdev=0.1):
    """The JAX engine's initial draw (mcmc_vector.py learn: PRNGKey(seed),
    split 3, normals for w then V)."""
    key = jax.random.PRNGKey(seed)
    key, kw, kv = jax.random.split(key, 3)
    w = init_stdev * jax.random.normal(kw, (n,), dtype=jnp.float32)
    V = init_stdev * jax.random.normal(kv, (n, k), dtype=jnp.float32)
    return np.float32(0.0), np.asarray(w), np.asarray(V)


@pytest.fixture(scope="module")
def als_pair(ml_small, jax_ml_small):
    jtr, jte = jax_ml_small
    n = jtr.num_features
    ja = JaxALS(JaxFMConfig(num_features=n, num_factors=K, regw=5, regv=5),
                num_iter=ITERS, seed=1, verbose=False, dual_draws=False)
    ja.case_major_stats = False
    ja.learn(jtr, jte)
    tr, te = ml_small
    ta = ALSVectorLearner(
        FMConfig(num_features=n, num_factors=K, regw=5, regv=5),
        num_iter=ITERS, seed=1, verbose=False, device="cpu", case_major_stats=False,
        dual_draws=False, init_params=params_from_jax(*_jax_init(n, K, 1), device="cpu"),
    )
    ta.learn(tr, te)
    return ja, ta


def test_movielens_like_bit_identical(ml_small, jax_ml_small):
    for t, j in zip(ml_small, jax_ml_small):
        for f in ("indptr", "cols", "vals", "target"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert (t.min_target, t.max_target, t.num_features) == (
            j.min_target, j.max_target, j.num_features)


def test_als_trajectory_matches_jax(als_pair):
    ja, ta = als_pair
    assert len(ta.history) == len(ja.history) == ITERS
    for hj, ht in zip(ja.history, ta.history):
        assert abs(hj["test_this"] - ht["test_this"]) < 1e-4, (hj, ht)
        assert abs(hj["train"] - ht["train"]) < 1e-4, (hj, ht)
        assert ht["rejected"] == 0
    pj, pt = ja.get_params(), ta.get_params()
    np.testing.assert_allclose(pt.w.numpy(), np.asarray(pj.w), atol=1e-3)
    np.testing.assert_allclose(pt.v.numpy(), np.asarray(pj.v), atol=1e-3)
    assert abs(float(pt.w0) - float(pj.w0)) < 1e-3
    np.testing.assert_allclose(ta.predict(), np.asarray(ja.predict(None)), atol=1e-3)


def test_als_train_rmse_falls(als_pair):
    _, ta = als_pair
    tr = [h["train"] for h in ta.history]
    assert tr[-1] < tr[0] and all(np.isfinite(tr))


def test_mcmc_band_against_jax(ml_small, jax_ml_small):
    jtr, jte = jax_ml_small
    n = jtr.num_features
    jm = JaxMCMC(JaxFMConfig(num_features=n, num_factors=K), num_iter=ITERS,
                 seed=1, verbose=False, dual_draws=False)
    jm.case_major_stats = False
    jm.learn(jtr, jte)
    tr, te = ml_small
    tm = MCMCVectorLearner(FMConfig(num_features=n, num_factors=K),
                           num_iter=ITERS, seed=1, verbose=False, device="cpu",
                           case_major_stats=False, dual_draws=False)
    tm.learn(tr, te)
    assert abs(jm.history[-1]["test_all"] - tm.history[-1]["test_all"]) < 0.03
    assert all(h["rejected"] == 0 for h in tm.history)
    preds = tm.predict()
    assert preds.shape == (te.num_rows,)
    assert (preds >= tr.min_target).all() and (preds <= tr.max_target).all()


@pytest.mark.parametrize("start,num_iter,R", [(0, 12, 8), (0, 3, 8), (0, 20, 1), (3, 17, 4)])
def test_dispatch_chunks_matches_jax(start, num_iter, R):
    assert dispatch_chunks(start, num_iter, R) == jax_dispatch_chunks(start, num_iter, R)


@pytest.mark.parametrize("case", [
    # dual draws (the first case once) are in the slice since kernel K7,
    # case reordering since the learner options' slice, streaming data
    # since the out-of-core slice (tests/test_torch_streaming.py)
    # the incremental test tail (the second case once) is in the slice
    # since kernel K4b, the flat pure linear model (k=0) since the learner
    # options' slice: k = 0 on relational data takes the case's place
    pytest.param("k0_relational", id="kwargs1-flat_incr_test"),
])
def test_outside_the_slice_raises(ml_small, case):
    tr, te = ml_small
    learner = MCMCVectorLearner(FMConfig(num_features=tr.num_features, num_factors=0),
                                num_iter=1, verbose=False, device="cpu")
    tr = movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)[0]
    block = RelationData(np.arange(2), np.zeros(1), np.ones(1), 1)
    tr.relations = [RelationJoin(block, np.zeros(tr.num_rows, np.int32))]
    item = "§1 item 2"
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        learner.learn(tr, te)


def test_constructor_options_outside_the_slice_raise():
    cfg = FMConfig(num_features=10, num_factors=4)
    with pytest.raises(NotImplementedError, match="ROADMAP M13"):
        MCMCVectorLearner(cfg, mesh=object(), device="cpu")
    # checkpoints are in the slice since the learner options' slice
    # (tests/test_torch_checkpoint.py)
    learner = MCMCVectorLearner(cfg, checkpoint_path="x.npz", checkpoint_every=2,
                                device="cpu")
    assert (learner.checkpoint_path, learner.checkpoint_every) == ("x.npz", 2)
    # rlog output is in the slice since the CLI's port
    rlog = object()
    assert MCMCVectorLearner(cfg, rlog=rlog, device="cpu").rlog is rlog


def test_own_init_is_seeded(ml_small):
    tr, te = ml_small
    runs = []
    for _ in range(2):
        m = MCMCVectorLearner(FMConfig(num_features=tr.num_features, num_factors=4),
                              num_iter=2, seed=5, verbose=False, device="cpu")
        m.learn(tr, te)
        runs.append((m.history[-1]["test_all"], m.get_params().v.clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
