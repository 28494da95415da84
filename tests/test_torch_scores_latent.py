"""rel_scores over stacked relations and probit_latent's residual sums, on
the CPU (the kernels' plain versions), against JAX and torch.

- Stacked scores: two relations' designs (numpy, seeded; one of them with
  an empty block row) in one CSR (`stacked_design`) give, through one
  plain rel_scores call, the JAX engine's `_rel_scores` (the replica in
  test_torch_bs_main.py) of each relation at `stacked_maps`' offsets,
  within 1e-6; every relation's sentinel row is exactly 0, and a case's
  stacked row is its relation's own row.
- Probit sums: the plain probit_latent's sum_e and sum_e2 equal torch's
  sum of the resampled A[:, 0] and draw_alpha's capped sum of its squares
  within 1e-6 of the sum of magnitudes (f32 sums in another order), also
  with a NaN and an overflowing residual; draw_alpha_from_sum on sum_e2
  draws draw_alpha's alpha from the same generator state.
- Learner wiring: probit MCMC and ALS at refresh_every = 2 on the flat and
  the BS vector engine record every alpha and w0 draw's input. The draws
  after a fast step take probit_latent's sums, the others read A, and
  every input equals torch's sum over A[:, 0] at that point within 1e-6
  of the sum of magnitudes: a stale or reused carried sum fails.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.relation import RelationData, RelationJoin
from libfm_tpu_torch.data.synth import ctr_like
from libfm_tpu_torch.kernels import probit_latent as pl
from libfm_tpu_torch.kernels.rel_refresh import rel_scores
from libfm_tpu_torch.learners import mcmc_rel_vector, mcmc_vector
from libfm_tpu_torch.learners.mcmc import dispatch_chunks, draw_alpha, draw_alpha_from_sum
from libfm_tpu_torch.learners.mcmc_rel_vector import (
    DevRel,
    RelLayout,
    stacked_design,
    stacked_maps,
)
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

from test_torch_bs_main import _jax_scores


def _join(rng, nb, W, nf, nc, offset, empty_row=None):
    """A relation of nb block rows of W entries over nf features (global
    ids from `offset`), joined by nc cases; `empty_row` has no entries."""
    lens = np.full(nb, W)
    if empty_row is not None:
        lens[empty_row] = 0
    cols = np.concatenate([np.sort(rng.choice(nf, m, replace=False)) for m in lens])
    rd = RelationData(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
                      cols.astype(np.int32), rng.normal(0, 1, len(cols)).astype(np.float32),
                      nf)
    rd.attr_offset = offset
    return RelationJoin(rd, rng.integers(0, nb, nc).astype(np.int32))


def _two_relations(seed, nc=300, k=4):
    """Two relations' layouts (20 rows of 5 entries over 40 features, row 7
    empty; 9 rows of 3 over 15) and P [55, k+1], seeded."""
    rng = np.random.default_rng(seed)
    joins = [_join(rng, 20, 5, 40, nc, 0, empty_row=7), _join(rng, 9, 3, 15, nc, 40)]
    n = 55
    lays = [RelLayout(j, j, np.zeros(n, np.int32), n) for j in joins]
    return lays, rng.normal(0, 0.5, (n, k + 1)).astype(np.float32)


@pytest.mark.parametrize("use_linear", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_stacked_scores_match_jax(seed, use_linear):
    lays, P = _two_relations(seed)
    k = P.shape[1] - 1
    SC = rel_scores(torch.as_tensor(P), *stacked_design([DevRel(lay, "cpu") for lay in lays]),
                    use_linear=use_linear).numpy()
    first = np.cumsum([0] + [lay.nb + 1 for lay in lays])
    assert SC.shape == (first[-1], k + 2)
    w, V = jnp.asarray(P[:, 0]), jnp.asarray(P[:, 1:])
    for lay, f in zip(lays, first):
        rows = np.repeat(np.arange(lay.nb), np.diff(lay.indptr))
        qB, sqB, linB = _jax_scores(w, V, rows, lay.cols, lay.vals, lay.nb)
        want = np.concatenate([np.asarray(qB), np.asarray(sqB)[:, None],
                               np.asarray(linB)[:, None] if use_linear
                               else np.zeros((lay.nb + 1, 1), np.float32)], axis=1)
        got = SC[f:f + lay.nb + 1]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert not got[lay.nb].any()  # the relation's sentinel row
    assert not SC[7].any()  # the empty block row
    # a case's stacked row (stacked_maps) is its relation's own row
    maps = stacked_maps(lays, "row_map_train", 300, "cpu").long().numpy()
    for r, (lay, f) in enumerate(zip(lays, first)):
        own = rel_scores(torch.as_tensor(P), *stacked_design([DevRel(lay, "cpu")]),
                         use_linear=use_linear).numpy()
        np.testing.assert_array_equal(SC[maps[r]], own[lay.row_map_train])


def _probit_inputs(seed, nc=5000, k=3, bad=False):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 3, (nc, k + 1)).astype(np.float32)
    lat = rng.normal(0, 1, nc).astype(np.float32)
    y = rng.choice([-1.0, 1.0], nc).astype(np.float32)
    U = rng.random(nc).astype(np.float32)
    if bad:
        A[3, 0] = np.nan  # e' is NaN
        # pred -1e20 on the wrong side of 0: the latent lands near 0, and
        # e'^2 overflows
        A[5, 0], lat[5], y[5] = -1e20, 0.0, 1.0
    return (torch.as_tensor(x) for x in (A, lat, y, U))


def _near(got, want, scale):
    return abs(float(got) - float(want)) <= 1e-6 * float(scale)


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("mode", ["sample", "mean"])
def test_probit_sums_match_torch(mode, bad):
    A, lat, y, U = _probit_inputs(3, bad=bad)
    U = U if mode == "sample" else None
    correct, sum_e, sum_e2 = pl.probit_latent_plain(A, lat, y, U)
    e = A[:, 0].double()
    if bad:
        assert torch.isnan(sum_e) and torch.isnan(A[3, 0])
        assert not torch.isfinite(A[5, 0] * A[5, 0])
    else:
        assert _near(sum_e, e.sum(), e.abs().sum())
    e2 = A[:, 0] * A[:, 0]
    capped = torch.where(torch.isfinite(e2), e2.clamp_max(1e30), torch.full_like(e2, 1e30))
    assert torch.isfinite(sum_e2)
    assert _near(sum_e2, capped.double().sum(), capped.double().sum())
    if bad:  # the NaN and the overflow count 1e30 each
        assert 2e30 <= float(sum_e2) < 3e30
    assert 0 <= float(correct) <= A.shape[0]
    # alpha from the carried sum is draw_alpha's alpha
    alphas = []
    for fn, arg in ((draw_alpha, A[:, 0]), (draw_alpha_from_sum, sum_e2)):
        g = torch.Generator().manual_seed(5)
        alphas.append(fn(g, arg, A.shape[0], torch.tensor(2.0), 1.0, 1.0, True, True)[0])
    assert torch.equal(*alphas)


def _flat_data():
    tr, te, groups = ctr_like(4, 30, 1500, seed=3)
    return tr, te, groups, tr.num_features


def _bs_data():
    """Two relations beside no main table, probit targets."""
    rng = np.random.default_rng(6)
    nc, nte = 1200, 300
    joins = [_join(rng, 30, 4, 60, nc + nte, 0), _join(rng, 12, 3, 20, nc + nte, 60)]
    y = np.where(rng.normal(0, 1, nc + nte) > 0, 1.0, -1.0).astype(np.float32)

    def ds(sl):
        m = len(y[sl])
        d = Dataset(np.zeros(m + 1, np.int64), np.empty(0, np.int32), np.empty(0, np.float32),
                    y[sl], 0)
        d.relations = [j.permuted(np.arange(nc + nte)[sl]) for j in joins]
        return d

    return ds(slice(0, nc)), ds(slice(nc, None)), None, 80


@pytest.mark.parametrize("cls", [MCMCVectorLearner, ALSVectorLearner])
@pytest.mark.parametrize("engine", ["flat", "bs"])
def test_alpha_and_w0_take_current_sums(monkeypatch, engine, cls):
    mod = mcmc_vector if engine == "flat" else mcmc_rel_vector
    train, test, groups, n = _flat_data() if engine == "flat" else _bs_data()
    seen = types.SimpleNamespace(A=None, calls=[])

    def col():
        e = seen.A[:, 0].double()
        return e, e.abs().sum()

    def wrap(name, fn, check):
        def inner(*a, **kw):
            check(*a)
            seen.calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, inner)

    def on_alpha(gen, e, *_):
        assert e.data_ptr() == seen.A[:, 0].data_ptr()  # A's own column

    def on_alpha_sum(gen, sum_e2, *_):
        e, _ = col()
        e2 = e * e
        want = torch.where(torch.isfinite(e2), e2.clamp_max(1e30), torch.full_like(e2, 1e30))
        assert _near(sum_e2, want.sum(), want.sum())

    def on_w0(lrn, sum_e, *_):
        e, scale = col()
        assert _near(sum_e, e.sum(), scale)

    wrap("draw_alpha", mod.draw_alpha, on_alpha)
    wrap("draw_alpha_from_sum", mod.draw_alpha_from_sum, on_alpha_sum)
    wrap("draw_w0", mod.draw_w0, on_w0)
    fwd = "fm_refresh" if engine == "flat" else "rel_refresh"
    refresh, at = getattr(mod, fwd), 5 if engine == "flat" else 3

    def keep_A(*a, **kw):  # the first refresh is the train refresh: its A
        if seen.A is None:
            seen.A = a[at]
        return refresh(*a, **kw)

    monkeypatch.setattr(mod, fwd, keep_A)
    lr = cls(FMConfig(num_features=n, num_factors=3), task=TASK_CLASSIFICATION, num_iter=6,
             seed=2, verbose=False, device="cpu", attr_group=groups)
    lr.refresh_every = 2
    lr.expand_max_ratio = 0.0
    hist = lr.learn(train, test)
    assert len(hist) == 6 and (engine == "flat" or lr.relational_mode == "bs_vector")
    # an iteration that follows a fast step takes its sums; the first one
    # and those after a refresh read A
    refreshes = {i0 + L - 1 for i0, L in dispatch_chunks(0, 6, 2)}
    want = ["draw_alpha" if it == 0 or it - 1 in refreshes else "draw_alpha_from_sum"
            for it in range(6)]
    assert [c for c in seen.calls if c.startswith("draw_alpha")] == want
    assert want.count("draw_alpha_from_sum") >= 2
    assert seen.calls.count("draw_w0") == 6


def _warp_sum(v):
    """common.cuh's warp_sum over 32 lanes in float32: every lane's total."""
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _warp_sums(S):
    """rel_refresh.cu's `warp_sums` over 32 lanes in float32: S [N, 32],
    each step keeping half of a lane's values and trading the other half
    with its xor partner; every lane's one total."""
    N, lane = S.shape[0], np.arange(32)
    s = list(S)
    for level in range(5):
        o, m = 16 >> level, N >> (level + 1)
        hi = (lane & o) != 0
        if m >= 1:
            s[:m] = [(np.where(hi, s[i + m], s[i]) + np.where(hi, s[i], s[i + m])[lane ^ o])
                     .astype(np.float32) for i in range(m)]
        else:
            s[0] = (s[0] + s[0][lane ^ o]).astype(np.float32)
    return s[0]


@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_rel_scores_butterfly_sums_are_warp_sums_bits(N):
    """rel_scores sums a group's N entries' s by one butterfly: each lane
    ends with entry lane // (32 / N)'s total, the same bits as warp_sum's
    (the kernel's SC is the first version's bits)."""
    rng = np.random.default_rng(N)
    for _ in range(50):
        S = (rng.standard_normal((N, 32)) * 10 ** rng.uniform(-4, 4, (N, 32))).astype(np.float32)
        tot = _warp_sums(S)
        want = np.array([_warp_sum(S[lane // (32 // N)])[lane] for lane in range(32)])
        np.testing.assert_array_equal(tot, want)
