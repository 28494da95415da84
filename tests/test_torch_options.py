"""The learner options of the port's MCMC/ALS engines against the JAX
package, on the CPU (the kernels' plain versions):

- the pure linear model (k = 0, P = [w], each draw the scalar conjugate
  one): ALS on the flat vector engine (case-major statistics and the
  dense update, and the slot path with the slot scatter) and on the
  flat exact engine from the JAX engines' own initial draws, test_this
  and train within 1e-4 of `ALSVectorLearner` / `ALSLearner` at every
  iteration; MCMC within the regression band 0.03 of JAX's;
- `predict_new` after ALS, from the same initial draws: flat regression
  and relational (BS) data within 1e-4 of JAX's `predict_new`, probit
  within 1e-5 (Phi's own tolerance, ROADMAP §3); the chunked relational
  path equal to the unchunked one bit for bit; on the exact BS engine
  within 5e-3 of `predict()` (tests/test_mcmc_relational.py:244-256) and
  on the flat engine equal to it; a dataset wider than the model raises;
- case reordering (`case_reorder`, forced at this size with
  case_reorder_min_bytes = 0 and case_major_stats off, as in
  tests/test_mcmc_vector.py:345-371): the reordered MCMC chain within 2e-4
  of the unordered one, `_case_reordered` set;
- what the port still refuses names its ROADMAP item: k = 0 on relational
  data, SGD and SGDA, and k > 128 on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.data.synth import ctr_like as jax_ctr_like
from libfm_tpu.data.synth import movielens_like as jax_movielens_like
from libfm_tpu.learners.mcmc import ALSLearner as JaxALS
from libfm_tpu.learners.mcmc_vector import ALSVectorLearner as JaxALSV
from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxMCMCV
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.tasks import TASK_CLASSIFICATION as JAX_TASK_CLASSIFICATION
from libfm_tpu_torch.convert import packed_from_jax, params_from_jax
from libfm_tpu_torch.data.synth import ctr_like, movielens_like
from libfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner
from libfm_tpu_torch.learners.sgd import SGDLearner
from libfm_tpu_torch.learners.sgda import SGDALearner
from libfm_tpu_torch.models.fm import FMConfig, init_fm
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

from test_mcmc_relational import make_relational_problem
from test_torch_bs_vector import _jax_init, _run
from test_torch_exact import jax_exact_init
from test_torch_relation import to_port

ITERS = 5
TRAJ_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain versions issue many small ops (as in
    tests/test_torch_exact.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ml():
    kw = dict(num_users=120, num_items=90, num_ratings=8000, seed=3)
    return movielens_like(**kw), jax_movielens_like(**kw)


def assert_close_trajectories(j, t, tol=TRAJ_TOL):
    assert len(j.history) == len(t.history) == ITERS
    for a, b in zip(j.history, t.history):
        for key in ("train", "test_this"):
            assert abs(a[key] - b[key]) < tol, (key, a, b)
        assert b["rejected"] == 0


@pytest.fixture(scope="module")
def jax_als_k0(ml):
    _, (jtr, jte) = ml
    j = JaxALSV(JaxFMConfig(num_features=jtr.num_features, num_factors=0, regw=5, regv=5),
                num_iter=ITERS, seed=1, verbose=False)
    j.learn(jtr, jte)
    return j


@pytest.mark.parametrize("route", ["case_major", "slot_scatter"])
def test_als_k0_vector_matches_jax(ml, jax_als_k0, route):
    (tr, te), _ = ml
    n = tr.num_features
    flags = (dict(case_major_stats=True, dense_update=True) if route == "case_major"
             else dict(case_major_stats=False, dense_update=False))
    t = ALSVectorLearner(FMConfig(num_features=n, num_factors=0, regw=5, regv=5),
                         num_iter=ITERS, seed=1, verbose=False, device="cpu",
                         init_params=params_from_jax(*_jax_init(n, 0, 1), device="cpu"),
                         **flags)
    t.learn(tr, te)
    assert_close_trajectories(jax_als_k0, t)
    assert t.get_params().v.shape == (n, 0)
    np.testing.assert_allclose(t.get_params().w.numpy(),
                               np.asarray(jax_als_k0.get_params().w), atol=1e-4)


def test_als_k0_exact_matches_jax(ml):
    (tr, te), (jtr, jte) = ml
    n = tr.num_features
    j = JaxALS(JaxFMConfig(num_features=n, num_factors=0, regw=1, regv=1), num_iter=ITERS,
               seed=1, verbose=False)
    j.learn(jtr, jte)
    t = ALSLearner(FMConfig(num_features=n, num_factors=0, regw=1, regv=1), num_iter=ITERS,
                   seed=1, verbose=False, device="cpu",
                   init_params=params_from_jax(*jax_exact_init(n, 0, 1), device="cpu"))
    t.learn(tr, te)
    assert_close_trajectories(j, t)


def test_mcmc_k0_within_the_band_of_jax(ml):
    (tr, te), (jtr, jte) = ml
    n = tr.num_features
    j = JaxMCMCV(JaxFMConfig(num_features=n, num_factors=0), num_iter=12, seed=1,
                 verbose=False)
    j.learn(jtr, jte)
    t = MCMCVectorLearner(FMConfig(num_features=n, num_factors=0), num_iter=12, seed=1,
                          verbose=False, device="cpu")
    t.learn(tr, te)
    assert abs(j.history[-1]["test_all"] - t.history[-1]["test_all"]) < 0.03
    assert all(h["rejected"] == 0 for h in t.history)


def test_k0_model_and_conversion():
    """Initialisation and the JAX package's parameters at k = 0: V [n, 0],
    P = [w]."""
    cfg = FMConfig(num_features=7, num_factors=0)
    g = torch.Generator()
    g.manual_seed(1)
    p = init_fm(cfg, g, mcmc_style_w=True)
    assert p.v.shape == (7, 0) and p.w.shape == (7,) and p.num_factors == 0
    w = np.arange(7, dtype=np.float32)
    w0, P = packed_from_jax(np.float32(0.5), w, np.zeros((7, 0), np.float32), device="cpu")
    assert P.shape == (7, 1) and torch.equal(P[:, 0], torch.as_tensor(w))
    assert float(w0) == 0.5


def test_predict_new_flat_matches_jax(ml):
    (tr, te), (jtr, jte) = ml
    n, k = tr.num_features, 4
    j = JaxALSV(JaxFMConfig(num_features=n, num_factors=k, regw=5, regv=5), num_iter=3,
                seed=1, verbose=False)
    j.learn(jtr, jte)
    t = ALSVectorLearner(FMConfig(num_features=n, num_factors=k, regw=5, regv=5),
                         num_iter=3, seed=1, verbose=False, device="cpu",
                         init_params=params_from_jax(*_jax_init(n, k, 1), device="cpu"))
    t.learn(tr, te)
    got = t.predict_new(te, batch_size=1000)
    np.testing.assert_allclose(got, np.asarray(j.predict_new(jte)), atol=1e-4)
    # after ALS the final parameters are what made the last test prediction
    np.testing.assert_array_equal(got, t.predict())
    np.testing.assert_array_equal(t.predict_new(te), got)  # one batch or eight
    wide = movielens_like(num_users=200, num_items=90, num_ratings=500, seed=4)[1]
    with pytest.raises(ValueError, match="covers"):
        t.predict_new(wide)


def test_predict_new_probit_matches_jax():
    kw = dict(num_fields=3, field_cardinality=40, num_examples=2500, seed=7)
    jtr, jte, groups = jax_ctr_like(**kw)
    tr, te, _ = ctr_like(**kw)
    n, k = tr.num_features, 3
    j = JaxALSV(JaxFMConfig(num_features=n, num_factors=k, regw=5, regv=5),
                task=JAX_TASK_CLASSIFICATION, num_iter=3, seed=1, verbose=False,
                attr_group=groups)
    j.learn(jtr, jte)
    t = ALSVectorLearner(FMConfig(num_features=n, num_factors=k, regw=5, regv=5),
                         task=TASK_CLASSIFICATION, num_iter=3, seed=1, verbose=False,
                         device="cpu", attr_group=groups,
                         init_params=params_from_jax(*_jax_init(n, k, 1), device="cpu"))
    t.learn(tr, te)
    got = t.predict_new(te)
    assert ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got, np.asarray(j.predict_new(jte)), atol=1e-5)


@pytest.fixture(scope="module")
def rel_problem():
    train, test, _, _, nf = make_relational_problem()
    return train, test, nf


def test_predict_new_relational_matches_jax(rel_problem):
    train, test, nf = rel_problem
    j, t = _run(train, test, nf, 4, 0.5, 3, 2, do_sample=False, do_multilevel=False)
    assert t.relational_mode == "bs_vector"
    _, tte = to_port(train, test)
    got = t.predict_new(tte)
    np.testing.assert_allclose(got, np.asarray(j.predict_new(test)), atol=1e-4)
    t.predict_expand_cap = 8  # case ranges of a batch each
    np.testing.assert_array_equal(t.predict_new(tte, batch_size=16), got)


def test_predict_new_on_the_exact_bs_engine(rel_problem):
    train, test, nf = rel_problem
    ttr, tte = to_port(train, test)
    t = ALSLearner(FMConfig(num_features=nf, num_factors=4, regw=0.5, regv=0.5),
                   num_iter=6, seed=2, verbose=False, device="cpu")
    t.learn(ttr, tte)
    full = t.predict_new(tte)
    assert np.abs(full - t.predict()).max() < 5e-3
    t.predict_expand_cap = 8
    np.testing.assert_array_equal(t.predict_new(tte, batch_size=7), t.predict_new(tte, 7))
    t.predict_expand_cap = 10 ** 9
    np.testing.assert_array_equal(t.predict_new(tte, batch_size=7), full)


def test_case_reorder_matches_the_unordered_chain(ml):
    (tr, te), _ = ml

    def run(reorder):
        m = MCMCVectorLearner(FMConfig(num_features=tr.num_features, num_factors=4),
                              num_iter=6, seed=9, verbose=False, device="cpu",
                              case_major_stats=False)
        m.case_reorder = reorder
        m.case_reorder_min_bytes = 0
        m.slab_cases = 1024  # accepted, no effect on the port
        m.learn(tr, te)
        return m

    a, b = run(False), run(True)
    assert b._case_reordered and not a._case_reordered
    for ha, hb in zip(a.history, b.history):
        assert abs(ha["test_all"] - hb["test_all"]) < 2e-4, (ha, hb)
        assert abs(ha["train"] - hb["train"]) < 2e-4


def test_refusals_name_the_roadmap_item(rel_problem):
    train, test, nf = rel_problem
    ttr, tte = to_port(train, test)
    cfg = FMConfig(num_features=nf, num_factors=0)
    for learner in (MCMCVectorLearner(cfg, num_iter=1, verbose=False, device="cpu"),
                    MCMCLearner(cfg, num_iter=1, verbose=False, device="cpu")):
        with pytest.raises(NotImplementedError, match="§1 item 2"):
            learner.learn(ttr, tte)
    tr, te = movielens_like(4, 6, 50, seed=1)
    cfg = FMConfig(num_features=tr.num_features, num_factors=0)
    with pytest.raises(NotImplementedError, match="§1 item 2"):
        SGDLearner(cfg, device="cpu").learn(tr, te)
    with pytest.raises(NotImplementedError, match="§1 item 2"):
        SGDALearner(cfg, device="cpu").learn(tr, te, te)
    # k > 128 on the card: refused before anything reaches the device
    wide = MCMCVectorLearner(FMConfig(num_features=tr.num_features, num_factors=129),
                             num_iter=1, verbose=False, device="cpu")
    wide.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="k > 128.*§1 item 2"):
        wide.learn(tr, te)
