"""The port's dual (Woodbury) draws against the JAX package, on the CPU.

- `dual_draw_plain` against the JAX engine's formula (mcmc_vector.py
  `_slot_hM` and `dual_chunk`, with `lane_chol.cholesky_lanes` and
  `cho_solve_lanes`) on the same numpy-seeded A, slots, theta, lambda,
  mu, u and delta; JAX pads each feature's slots to the window W, with
  the padding slots on a real row of A, the port takes the real counts.
  c in {1, 2, 5, 32}, d in {9, 41, 129} with c < d, sampling and ALS,
  the linear term on and off. Tolerance: 2e-5 of max(1, |theta|), f32
  sums taken in another order through K = I + Phi D^-1 Phi^T, whose
  eigenvalues lie in [1, 1 + ||Phi D^-1 Phi^T||] (2.5e-6 measured).
- The draw's mean and covariance against the closed form N(Lam^-1 b,
  Lam^-1) (the mirror of tests/test_mcmc_vector.py
  test_dual_sampler_distribution), 4,000 draws of one system.
- `DualPlan`, the kernel's CTAs: every feature in one CTA, in order,
  with its area inside the CTA's shared memory.
- The learner's dual set (`dual_features`) equals the JAX layout's
  (`build_block_layout`, segments whole, W < d and W <= 64), and the
  width it reads from the counts equals the port's `build_block_layout`.
- ALS classification with dual draws on ctr_like(4, 100, 2000, seed=1)
  (the data of tests/test_mcmc_vector.py test_dual_c2_split_exact_als),
  k=40, the field groups, regw = regv = 5: the JAX engine
  (MCMCVectorLearner, do_sample=False, do_multilevel=False) and the port
  from the same initial draw, both with refresh_every=1 (one compiled
  step in JAX). test_this and its log10-loss within 1e-4 at every
  iteration, no draw rejected. The regularisation keeps every system
  positive definite: without it lambda = 0 and each dual draw of a
  feature of c < d entries is rejected (D^-1 = inf), in both engines.
- The port's ALS with dual draws on and off within 2e-3 (the band of
  tests/test_mcmc_vector.py test_dual_draw_matches_dense_als).

The sampled chain against one JAX MCMC run is in
test_torch_dual_draw_mcmc.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.data.batching import conflict_free_blocks as jax_blocks
from libfm_tpu.data.dataset import Dataset as JaxDataset
from libfm_tpu.data.vector_layout import build_block_layout as jax_layout
from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.ops.lane_chol import cho_solve_lanes as jax_cho_solve
from libfm_tpu.ops.lane_chol import cholesky_lanes as jax_cholesky
from libfm_tpu.tasks import TASK_CLASSIFICATION as JAX_TASK_CLASSIFICATION
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.batching import conflict_free_blocks, feature_slots
from libfm_tpu_torch.data.synth import ctr_like
from libfm_tpu_torch.data.vector_layout import build_block_layout, single_segment_widths
from libfm_tpu_torch.kernels.dual_draw import (
    CTA_WARPS,
    DualPlan,
    area_floats,
    dual_draw,
    dual_draw_plain,
)
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, DevBlock
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

K = 40
ITERS = 4
TOL = 2e-5
F = 8  # features a case of the formula test


@jax.jit
def _jax_dual(A, sc, sv, th, lam, mu, u, dl, alpha, sample, linear, bound):
    """The JAX engine's dual draw of padded [C, W] segments (mcmc_vector.py
    `_slot_hM` and `dual_chunk`); sample and linear are 0.0 or 1.0: u and
    dl times 0 are the ALS branch's zeros, h[..., 0] times 0 its frozen w."""
    A_slot = A[sc]
    e_slot, Q_slot = A_slot[..., 0], A_slot[..., 1:]
    qp = Q_slot - sv[..., None] * th[:, None, 1:]
    h = jnp.concatenate([sv[..., None], sv[..., None] * qp], axis=-1)
    h = h.at[..., 0].multiply(linear)
    Dinv = 1.0 / lam
    sqa = jnp.sqrt(alpha)
    Phi = sqa * h
    ytil = sqa * (jnp.einsum("cwd,cd->cw", h, th - mu) - e_slot)
    Kg = jnp.einsum("cwd,cd,cud->cwu", Phi, Dinv, Phi)
    cholK = jax_cholesky(Kg + jnp.eye(Kg.shape[-1], dtype=Kg.dtype))
    uu = jnp.sqrt(Dinv) * (sample * u)
    v = jnp.einsum("cwd,cd->cw", Phi, uu) + sample * dl
    wsol = jax_cho_solve(cholK, ytil - v)
    th_new = mu + (uu + Dinv * jnp.einsum("cwd,cw->cd", Phi, wsol))
    ok = (jnp.isfinite(th_new) & (jnp.abs(th_new) <= bound)).all(axis=1, keepdims=True)
    return jnp.where(ok, th_new, th), ~ok[:, 0]


def _formula_case(c, d, seed):
    """F features of 1..c slots (one of exactly c) in a window W = c, on an
    A of nc rows plus the sentinel row nc that the padding slots read."""
    rng = np.random.default_rng(seed)
    nc = 300
    A = rng.standard_normal((nc + 1, d)).astype(np.float32)
    counts = rng.integers(1, c + 1, F)
    counts[0] = c
    sc = np.full((F, c), nc, np.int32)
    sv = np.zeros((F, c), np.float32)
    for j, n in enumerate(counts):
        sc[j, :n] = rng.choice(nc, n, replace=False)
        sv[j, :n] = rng.normal(1.0, 0.5, n)
    th = (0.3 * rng.standard_normal((F, d))).astype(np.float32)
    lam = (0.5 + rng.random((F, d))).astype(np.float32)
    mu = (0.1 * rng.standard_normal((F, d))).astype(np.float32)
    u = rng.standard_normal((F, d)).astype(np.float32)
    dl = rng.standard_normal((F, c)).astype(np.float32)
    return A, counts, sc, sv, th, lam, mu, u, dl


@pytest.mark.parametrize("c,d", [(c, d) for d in (9, 41, 129) for c in (1, 2, 5, 32)
                                 if c < d])
def test_dual_draw_plain_matches_jax_formula(c, d):
    A, counts, sc, sv, th, lam, mu, u, dl = _formula_case(c, d, seed=100 * c + d)
    alpha, bound = np.float32(1.7), 1e6
    real = np.arange(c)[None, :] < counts[:, None]
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    t = torch.as_tensor
    for sample in (True, False):
        for linear in (True, False):
            want, wrej = _jax_dual(A, sc, sv, th, lam, mu, u, dl, alpha,
                                   float(sample), float(linear), bound)
            got, rej = dual_draw_plain(
                t(A[:-1]), t(off), t(sc[real]), t(sv[real]), t(th), t(lam), t(mu),
                t(u), t(dl[real]), t(alpha), do_sample=sample, bound=bound,
                use_linear=linear)
            want = np.asarray(want)
            err = np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))
            assert err.max() < TOL, (sample, linear, err.max())
            assert not rej.any() and not np.asarray(wrej).any()
            if not linear:  # the frozen w moves by the prior's draw alone
                np.testing.assert_allclose(
                    got[:, 0].numpy(), mu[:, 0] + sample * np.sqrt(1 / lam[:, 0]) * u[:, 0],
                    rtol=1e-6, atol=1e-7)


def test_dual_draw_wrapper_on_cpu_is_the_plain_version():
    A, counts, sc, sv, th, lam, mu, u, dl = _formula_case(5, 41, seed=7)
    real = np.arange(5)[None, :] < counts[:, None]
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    args = [torch.as_tensor(x) for x in (A[:-1], off, sc[real], sv[real], th, lam, mu, u,
                                         dl[real], np.float32(1.7))]
    kw = dict(do_sample=True, bound=1e6, use_linear=True)
    a, ra = dual_draw(*args, **kw)
    b, rb = dual_draw_plain(*args, **kw)
    assert torch.equal(a, b) and torch.equal(ra, rb)


def test_dual_plan_packs_features_in_order():
    """Every feature in one CTA, in order; at most CTA_WARPS a CTA; the
    areas (each of its feature's own count) side by side inside the CTA's
    shared memory, which holds 4 areas of the longest list."""
    rng = np.random.default_rng(3)
    for d, counts in ((129, np.minimum(rng.zipf(1.3, 5000), 32)), (41, rng.integers(1, 41, 700)),
                      (9, np.ones(40, np.int64)), (129, np.zeros(0, np.int64))):
        off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        plan = DualPlan(off, d, "cpu")
        first, area = plan.cta_first.numpy(), plan.area.numpy()
        need = area_floats(counts, d)
        assert first[0] == 0 and first[-1] == len(counts) and (np.diff(first) > 0).all()
        assert plan.ctas == len(first) - 1 and np.diff(first).max(initial=0) <= CTA_WARPS
        assert plan.floats == 4 * area_floats(max(int(counts.max(initial=1)), 1), d)
        for a, b in zip(first[:-1], first[1:]):
            np.testing.assert_array_equal(area[a:b], np.cumsum(need[a:b]) - need[a:b])
            assert area[b - 1] + need[b - 1] <= plan.floats
    with pytest.raises(ValueError, match="at most 64"):
        DualPlan(np.array([0, 65]), 129, "cpu")


def test_dual_draw_guard_rejects():
    """A negative prior precision makes D^-1 negative, K indefinite and the
    draw NaN or out of bound: the old theta stays and the flag is set."""
    A, counts, sc, sv, th, lam, mu, u, dl = _formula_case(5, 41, seed=8)
    lam[::2] = -lam[::2] * 1e-3
    real = np.arange(5)[None, :] < counts[:, None]
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    t = torch.as_tensor
    got, rej = dual_draw_plain(t(A[:-1]), t(off), t(sc[real]), t(sv[real]), t(th), t(lam),
                               t(mu), t(u), t(dl[real]), t(np.float32(1.7)),
                               do_sample=True, bound=1e3, use_linear=True)
    _, wrej = _jax_dual(A, sc, sv, th, lam, mu, u, dl, np.float32(1.7), 1.0, 1.0, 1e3)
    np.testing.assert_array_equal(rej.numpy().astype(bool), np.asarray(wrej))
    assert rej[::2].all()
    np.testing.assert_array_equal(got[rej.bool()].numpy(), th[rej.numpy().astype(bool)])


def test_dual_sampler_distribution():
    """N(mu, Lam^-1) exactly: the mean and covariance of 4,000 draws of one
    tiny system against the closed form."""
    rng = np.random.default_rng(0)
    c, d, n = 3, 5, 4000
    A = rng.standard_normal((c, d)).astype(np.float32)
    x = np.ones(c, np.float32)
    lam = (0.5 + rng.random(d)).astype(np.float32)
    alpha = np.float32(1.7)
    th_old = rng.standard_normal(d).astype(np.float32)
    m = (rng.standard_normal(d) * 0.1).astype(np.float32)
    H = np.concatenate([x[:, None], x[:, None] * (A[:, 1:] - x[:, None] * th_old[1:])], 1)
    e = A[:, 0]
    Lam = np.diag(lam) + alpha * H.T @ H
    b = alpha * H.T @ H @ th_old - alpha * H.T @ e + lam * m
    t = torch.as_tensor
    got, rej = dual_draw_plain(
        t(A), t(np.arange(0, c * n + 1, c, dtype=np.int64)),
        t(np.tile(np.arange(c, dtype=np.int32), n)), t(np.tile(x, n)),
        t(np.tile(th_old, (n, 1))), t(np.tile(lam, (n, 1))), t(np.tile(m, (n, 1))),
        t(rng.standard_normal((n, d)).astype(np.float32)),
        t(rng.standard_normal(c * n).astype(np.float32)), t(alpha),
        do_sample=True, bound=1e6, use_linear=True)
    assert not rej.any()
    s = got.numpy().astype(np.float64)
    assert np.allclose(s.mean(0), np.linalg.solve(Lam, b), atol=0.1)
    assert np.allclose(np.cov(s.T), np.linalg.inv(Lam), atol=0.12)


@pytest.fixture(scope="module")
def ctr():
    return ctr_like(num_fields=4, field_cardinality=100, num_examples=2000, seed=1)


def test_dual_set_matches_jax_layout(ctr):
    tr, te, groups = ctr
    jtr = JaxDataset(tr.indptr, tr.cols, tr.vals, tr.target, tr.num_features)
    want = []
    for b in jax_blocks(jtr, attr_group=groups):
        lay = jax_layout(b.features, b.entry_rows, b.entry_vals, b.entry_feat,
                         groups[b.features], tr.num_rows, widths=(32, 256))
        for bk in lay.buckets:
            elig = np.asarray(bk.seg_whole) & (bk.width < K + 1) & (bk.width <= 64)
            want.append(lay.features[bk.seg_feat[elig]])
    got = []
    for b in conflict_free_blocks(tr, attr_group=groups):
        blk = DevBlock(b, groups[b.features], tr.num_rows, "cpu", K, True, dual_draws=True)
        got.append(blk.features[blk.Fd:].numpy())
        assert blk.Fu and blk.Fd  # both draws run on every block
        off, _, _ = feature_slots(b)
        lay = build_block_layout(b.features, b.entry_rows, b.entry_vals, b.entry_feat,
                                 groups[b.features], tr.num_rows, widths=(32, 256))
        W = np.zeros(len(b.features), np.int64)
        for bk in lay.buckets:
            W[bk.seg_feat[bk.seg_whole]] = bk.width
        np.testing.assert_array_equal(single_segment_widths(np.diff(off)), W)
    assert sorted(np.concatenate(got)) == sorted(np.concatenate(want))


def _jax_init(n, k, seed, init_stdev=0.1):
    key = jax.random.PRNGKey(seed)
    key, kw, kv = jax.random.split(key, 3)
    w = init_stdev * jax.random.normal(kw, (n,), dtype=jnp.float32)
    V = init_stdev * jax.random.normal(kv, (n, k), dtype=jnp.float32)
    return np.float32(0.0), np.asarray(w), np.asarray(V)


def _port_als(ctr, dual_draws):
    tr, te, groups = ctr
    n = tr.num_features
    m = ALSVectorLearner(FMConfig(num_features=n, num_factors=K, regw=5, regv=5),
                         task=TASK_CLASSIFICATION, num_iter=ITERS, seed=1, verbose=False,
                         device="cpu", attr_group=groups, refresh_every=1,
                         dual_draws=dual_draws,
                         init_params=params_from_jax(*_jax_init(n, K, 1), device="cpu"))
    m.learn(tr, te)
    return m


def test_als_dual_trajectory_matches_jax(ctr):
    tr, te, groups = ctr
    jtr, jte = (JaxDataset(d.indptr, d.cols, d.vals, d.target, d.num_features)
                for d in (tr, te))
    jm = JaxMCMC(JaxFMConfig(num_features=tr.num_features, num_factors=K, regw=5, regv=5),
                 task=JAX_TASK_CLASSIFICATION, num_iter=ITERS, seed=1, verbose=False,
                 attr_group=groups, do_sample=False, do_multilevel=False, refresh_every=1)
    assert jm.dual_draws and jm.case_major_stats
    jm.learn(jtr, jte)
    tm = _port_als(ctr, dual_draws=True)
    assert tm.dual_draws
    for hj, ht in zip(jm.history, tm.history, strict=True):
        for key in ("test_this", "test_this_m2", "train"):
            assert abs(hj[key] - ht[key]) < 1e-4, (key, hj, ht)
        assert ht["rejected"] == hj["rejected"] == 0
    np.testing.assert_allclose(tm.predict(), np.asarray(jm.predict(None)), atol=1e-4)


def test_als_dual_on_and_off_agree(ctr):
    on, off = _port_als(ctr, True), _port_als(ctr, False)
    for a, b in zip(on.history, off.history, strict=True):
        for key in ("test_this", "test_this_m2", "train"):
            assert abs(a[key] - b[key]) < 2e-3, (key, a, b)
