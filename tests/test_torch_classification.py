"""Probit classification of the port against the JAX package, on the CPU.

- The samplers on a grid of mu in [-12, 12]: Phi, the hazard and the
  truncated-normal expectations; the inverse-CDF truncated draw from
  given uniforms against the same formula in JAX where XLA's f32 erf and
  torch's agree (see below), and deep in the tail, where both clip to
  the truncation point; 200,000 draws each way against
  scipy.stats.truncnorm's mean and variance.
- The masked accuracy / log10-likelihood and the AUC against JAX's.
- ALS classification trajectory (the latents are expectations, so
  deterministic): JAX ALSVectorLearner and the port from the same initial
  draw on ctr_like(5, 200, 15000, seed=4), k=8, 8 iterations, both with
  case-major statistics: test ll within 1e-4 at every iteration, train
  and test accuracy within 1/n, the final predict() within 1e-4.
- The fast path: probit_latent's plain version on e + latent equals the
  refresh's latents on the same predictions and uniforms.

Tolerances of the samplers against JAX, from the measured gaps between
torch's f32 erf/erfc/erfinv and XLA's: Phi within 2e-7 absolute (one f32
ulp at 1, where 1 + erf rounds), the hazard within 2e-6 relative (1.03e-6
measured at a = 5.83), the expectations within 1e-5 absolute (6.2e-6
measured: mu + hazard(-mu) cancels near mu = -5.8). XLA's erf saturates
at 0.9999998 (erf(inf) included), torch's at 1, so the two draws part in
the tails of the uniforms; pointwise they are held where |mu| <= 1 and
u in the half away from the untruncated tail (6e-7 measured) and where
the truncation point lies beyond 5.5 (equal), and everywhere by their
moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from jax import lax

from libfm_tpu.data.dataset import Dataset as JaxDataset
from libfm_tpu.learners import mcmc as jmcmc
from libfm_tpu.learners.mcmc_vector import ALSVectorLearner as JaxALS
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.ops import samplers as jsamp
from libfm_tpu.tasks import TASK_CLASSIFICATION as JAX_TASK_CLASSIFICATION
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.synth import ctr_like
from libfm_tpu_torch.data.vector_layout import padded_rows_layout
from libfm_tpu_torch.kernels import fm_refresh as fr
from libfm_tpu_torch.kernels import probit_latent as pl
from libfm_tpu_torch.learners import mcmc as tmcmc
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.ops import samplers as tsamp
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

K = 8
ITERS = 8
MU = np.linspace(-12.0, 12.0, 24001).astype(np.float32)


def _jax_init(n, k, seed, init_stdev=0.1):
    key = jax.random.PRNGKey(seed)
    key, kw, kv = jax.random.split(key, 3)
    w = init_stdev * jax.random.normal(kw, (n,), dtype=jnp.float32)
    V = init_stdev * jax.random.normal(kv, (n, k), dtype=jnp.float32)
    return np.float32(0.0), np.asarray(w), np.asarray(V)


@pytest.mark.parametrize("name,rtol,atol", [
    ("cdf_gaussian", 0.0, 2e-7),
    ("_normal_hazard", 2e-6, 0.0),
    ("left_tn_expectation", 0.0, 1e-5),
    ("right_tn_expectation", 0.0, 1e-5),
])
def test_probit_functions_match_jax(name, rtol, atol):
    j = np.asarray(getattr(jsamp, name)(jnp.asarray(MU)))
    t = getattr(tsamp, name)(torch.from_numpy(MU)).numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def _jax_transform(lo, hi, U):
    """jax.random.truncated_normal's transform on given uniforms."""
    sq = np.float32(np.sqrt(2.0))
    lo, hi = jnp.asarray(lo), jnp.asarray(hi)
    a, b = lax.erf(lo / sq), lax.erf(hi / sq)
    u = jnp.maximum(a, jnp.asarray(U) * (b - a) + a)
    z = sq * lax.erf_inv(u)
    return np.asarray(jnp.clip(z, lax.nextafter(lo, jnp.full_like(lo, jnp.inf)),
                               lax.nextafter(hi, jnp.full_like(hi, -jnp.inf))))


def _grid(mu, U):
    M, UU = np.meshgrid(mu, U, indexing="ij")
    return M.ravel(), UU.ravel()


def test_truncated_draw_from_uniforms_matches_jax():
    inf = np.float32(np.inf)
    # the bulk: |mu| <= 1, and the half of the uniforms away from the
    # untruncated tail (u near +1 for a left draw, near -1 for a right one)
    M, U = _grid(np.linspace(-1, 1, 201).astype(np.float32),
                 np.linspace(0, 0.5, 101).astype(np.float32))
    left = M + _jax_transform(-M, np.full_like(M, inf), U)
    right = M + _jax_transform(np.full_like(M, -inf), -M, 1 - U)
    tM, tU = torch.from_numpy(M), torch.from_numpy(U)
    np.testing.assert_allclose(tsamp.left_truncated_from_uniform(0.0, tM, 1.0, tU).numpy(),
                               left, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tsamp.right_truncated_from_uniform(0.0, tM, 1.0, 1 - tU).numpy(), right,
        rtol=0, atol=1e-6)
    # the tail up to |mu| = 12: the draw clips to the truncation point
    M, U = _grid(np.linspace(5.5, 12, 651).astype(np.float32),
                 np.linspace(0, 1, 100, endpoint=False).astype(np.float32))
    tM, tU = torch.from_numpy(M), torch.from_numpy(U)
    left = -M + _jax_transform(M, np.full_like(M, inf), U)
    t_left = tsamp.left_truncated_from_uniform(0.0, -tM, 1.0, tU).numpy()
    np.testing.assert_array_equal(t_left, left)
    assert (t_left >= 0).all() and (t_left < 1e-5).all()
    right = M + _jax_transform(np.full_like(M, -inf), -M, U)
    t_right = tsamp.right_truncated_from_uniform(0.0, tM, 1.0, tU).numpy()
    np.testing.assert_array_equal(t_right, right)
    assert (t_right <= 0).all() and (t_right > -1e-5).all()
    # everywhere on [-12, 12]: finite and on the right side of 0
    M, U = _grid(MU[::10], np.linspace(0, 1, 200, endpoint=False).astype(np.float32))
    tM, tU = torch.from_numpy(M), torch.from_numpy(U)
    assert (tsamp.left_truncated_from_uniform(0.0, tM, 1.0, tU) >= 0).all()
    assert (tsamp.right_truncated_from_uniform(0.0, tM, 1.0, tU) <= 0).all()


def test_the_draws_part_from_jax_where_logged():
    """The gaps ROADMAP §3 logs: XLA's f32 erf saturates at 0.9999998
    (erf(inf) included) where torch's reaches 1, so on |mu| <= 12 the
    draws from the same uniforms part by up to 0.26; and near a
    truncation point of 5.2-5.3, where XLA's erf overshoots 1, JAX's left
    draw returns 3.4e38 while the port's stays by 0."""
    inf = np.float32(np.inf)
    assert float(lax.erf(jnp.float32(inf))) == float(np.float32(0.9999998))
    assert float(torch.erf(torch.tensor(float("inf")))) == 1.0
    lo, U = np.array([5.234], np.float32), np.array([0.62886804], np.float32)
    assert -5.234 + _jax_transform(lo, np.full_like(lo, inf), U)[0] > 3e38
    t = tsamp.left_truncated_from_uniform(0.0, torch.tensor([-5.234]), 1.0,
                                          torch.from_numpy(U))
    assert 0.0 <= float(t) < 0.2
    M, U = _grid(MU[::20], np.linspace(0, 1, 200, endpoint=False).astype(np.float32))
    j = M + _jax_transform(-M, np.full_like(M, inf), U)
    t = tsamp.left_truncated_from_uniform(0.0, torch.from_numpy(M), 1.0,
                                          torch.from_numpy(U)).numpy()
    gap = np.abs(j - t)[j < 1e30].max()
    assert 0.1 < gap < 0.3, gap


@pytest.mark.parametrize("mean", [-2.0, 0.0, 1.5])
@pytest.mark.parametrize("side", ["left", "right"])
def test_truncated_draws_match_scipy_moments(mean, side):
    N = 200_000
    if side == "left":
        ref = scipy.stats.truncnorm(-mean, np.inf, loc=mean, scale=1.0)
        t = tsamp.left_truncated_gaussian(torch.Generator().manual_seed(3), 0.0,
                                          torch.full((N,), mean), 1.0)
        j = jsamp.left_truncated_gaussian(jax.random.PRNGKey(3), 0.0,
                                          jnp.full((N,), mean), 1.0)
    else:
        ref = scipy.stats.truncnorm(-np.inf, -mean, loc=mean, scale=1.0)
        t = tsamp.right_truncated_gaussian(torch.Generator().manual_seed(3), 0.0,
                                           torch.full((N,), mean), 1.0)
        j = jsamp.right_truncated_gaussian(jax.random.PRNGKey(3), 0.0,
                                           jnp.full((N,), mean), 1.0)
    for draws in (t.numpy().astype(np.float64), np.asarray(j, dtype=np.float64)):
        assert abs(draws.mean() - ref.mean()) < 0.01
        assert abs(draws.var() - ref.var()) < 0.01


def test_masked_metrics_match_jax():
    rng = np.random.default_rng(0)
    n = 5000
    p = rng.random(n).astype(np.float32)
    y = rng.choice([-1.0, 1.0], n).astype(np.float32)
    mask = (np.arange(n) < 4000).astype(np.float32)
    for norm in (1.0, 0.5):
        ja, jl = jmcmc._masked_acc_ll(jnp.asarray(p), jnp.asarray(y), jnp.asarray(mask), norm)
        ta, tl = tmcmc._masked_acc_ll(*(torch.from_numpy(x) for x in (p, y, mask)), norm)
        assert abs(float(ta) - float(ja)) < 1e-6 and abs(float(tl) - float(jl)) < 1e-5
    jauc = jmcmc._masked_auc(jnp.asarray(p), jnp.asarray(y), jnp.asarray(mask))
    tauc = tmcmc._masked_auc(*(torch.from_numpy(x) for x in (p, y, mask)))
    assert abs(float(tauc) - float(jauc)) < 1e-6


# ------------------------------------------------ ALS, probit, against JAX

@pytest.fixture(scope="module")
def ctr():
    return ctr_like(5, 200, 15000, seed=4)


@pytest.fixture(scope="module")
def als_cls_pair(ctr):
    tr, te, groups = ctr
    jtr, jte = (JaxDataset(d.indptr, d.cols, d.vals, d.target, d.num_features)
                for d in (tr, te))
    n = tr.num_features
    ja = JaxALS(JaxFMConfig(num_features=n, num_factors=K, regw=5, regv=5),
                task=JAX_TASK_CLASSIFICATION, num_iter=ITERS, seed=1, verbose=False,
                dual_draws=False, attr_group=groups)
    assert ja.case_major_stats
    ja.learn(jtr, jte)
    ta = ALSVectorLearner(FMConfig(num_features=n, num_factors=K, regw=5, regv=5),
                          task=TASK_CLASSIFICATION, num_iter=ITERS, seed=1, verbose=False,
                          device="cpu", attr_group=groups,
                          init_params=params_from_jax(*_jax_init(n, K, 1), device="cpu"))
    ta.learn(tr, te)
    return ja, ta


def test_als_classification_trajectory_matches_jax(als_cls_pair, ctr):
    ja, ta = als_cls_pair
    tr, te, _ = ctr
    assert len(ta.history) == len(ja.history) == ITERS
    for hj, ht in zip(ja.history, ta.history):
        assert abs(hj["test_this_m2"] - ht["test_this_m2"]) < 1e-4, (hj, ht)
        assert abs(hj["test_all_m2"] - ht["test_all_m2"]) < 1e-4, (hj, ht)
        assert abs(hj["test_this"] - ht["test_this"]) <= 1.0 / te.num_rows, (hj, ht)
        assert abs(hj["train"] - ht["train"]) <= 1.0 / tr.num_rows, (hj, ht)
        assert abs(hj["auc_all"] - ht["auc_all"]) < 1e-4, (hj, ht)
        assert ht["rejected"] == 0
    pj, pt = np.asarray(ja.predict(None)), ta.predict()
    assert pt.shape == (te.num_rows,)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    assert ((pt >= 0) & (pt <= 1)).all()


def test_fast_path_latents_equal_the_refresh(ctr):
    """probit_latent's plain version on e + latent gives the latents the
    refresh draws from the same predictions and uniforms."""
    tr, _, _ = ctr
    rng = np.random.default_rng(2)
    n, nc = tr.num_features, tr.num_rows
    P = torch.tensor(rng.normal(0, 0.3, (n, K + 1)).astype(np.float32))
    w0 = torch.tensor(-0.2)
    ids, vals = (torch.tensor(x) for x in padded_rows_layout(tr.indptr, tr.cols, tr.vals))
    y = torch.tensor(tr.target)
    pred = fr.fm_refresh_plain(P, ids, vals, w0)
    for U in (torch.tensor(rng.random(nc).astype(np.float32)), None):
        A = torch.empty(nc, K + 1)
        lat_r = torch.empty(nc)
        mode = "mean" if U is None else "sample"
        correct_r = fr.fm_refresh(P, ids, vals, w0, y, A, probit=mode, U=U, latent=lat_r)
        # the state before: latents 0, so that e + latent is pred exactly
        # (with latents at y, (pred - y) + y may round off pred by an ulp,
        # which the draw turns into up to 2.2e-4 where erf is flat)
        A_f = A.clone()
        A_f[:, 0] = pred
        lat_f = torch.zeros(nc)
        correct_f, _, _ = pl.probit_latent(A_f, lat_f, y, U)
        assert float(correct_f) == float(correct_r)
        np.testing.assert_allclose(lat_f.numpy(), lat_r.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(A_f.numpy(), A.numpy(), rtol=0, atol=1e-6)
        assert ((lat_r >= 0) == (y >= 0)).all()
