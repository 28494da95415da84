"""The port's flat exact engine (`-engine exact`: MCMCLearner /
ALSLearner) and its block draws (K11, `coord_draw`) against the JAX
package, on the CPU.

- coord_draw's plain version against JAX `draw_w_block` /
  `draw_v_block` on seeded numpy inputs (a one-hot block of ml data and a
  valued block with features of 1 to ~60 slots): ALS (do_sample=False),
  and sampling with z = jax.random.normal(key, (F,)), the normals JAX's
  samplers.gaussian draws from the same key: theta, e and q within 1e-5
  of the largest magnitude, the rejection counts equal; a draw pushed past
  the bound is kept and counted, as JAX's.
- q of factor f, read from fm_refresh's A = [e | Q], against JAX's
  per-factor rebuild `seg_sum(v_f[cols] * vals, rows)` within 1e-6; and
  in a whole ALS run, at every v launch, the q handed to coord_draw
  against the same sum of the V column it draws (within 1e-6 of the
  largest |q|): nothing writes V[:, f] between the re-prediction and
  factor f's draws but the draws that keep q current.
- ALS trajectories against JAX ALSLearner from JAX's own initial draw,
  within 1e-4 at every iteration (train, test_this and its second
  metric), the final w and V within 1e-4 of their largest magnitude: on
  ml_small (tests/test_learners.py), plain and with the two groups
  (users, items); on ctr data with fields of different entry counts and
  max_blocks=2 (the JAX engine's size-sorted head and stacked tail; the
  order is checked to differ from conflict_free_blocks'); probit ALS on
  ctr_small (accuracy and log10-loss within 1e-4).
- MCMC bands: sampled chains cannot match draw for draw (torch's
  generators are not JAX's threefry). The port's final test_all, the
  mean of three chains (seeds 1-3), against one JAX chain (seed 1):
  regression on ml_small (k=4, 15 iterations) within 0.03, probit on
  ctr_like(5, 200, 15000, seed=4) with its field groups (k=8, 15
  iterations) within 0.02. The spreads measured on the CPU: ml_small
  JAX seeds 0-5 in [0.3954, 0.4187], the port's seeds 0-11 in [0.3925,
  0.4259]; ctr JAX seeds 0-5 in [0.5660, 0.5907], the port's 0-11 in
  [0.5760, 0.5900]. No rejected draw, predict() within the target range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.data.dataset import Dataset as JaxDataset
from libfm_tpu.learners import mcmc as jmcmc
from libfm_tpu.learners.mcmc import ALSLearner as JaxALS
from libfm_tpu.learners.mcmc import MCMCLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.ops.segment import seg_sum as jax_seg_sum
from libfm_tpu.tasks import TASK_CLASSIFICATION as JAX_TASK_CLASSIFICATION
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.batching import conflict_free_blocks, feature_slots
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.synth import ctr_like, movielens_like
from libfm_tpu_torch.data.vector_layout import padded_rows_layout
from libfm_tpu_torch.kernels import coord_draw as cd
from libfm_tpu_torch.kernels.fm_refresh import fm_refresh_plain
from libfm_tpu_torch.learners import mcmc as tmcmc
from libfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner, exact_layout
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

ITERS = 5
DRAW_TOL = 1e-5
TRAJ_TOL = 1e-4


def jax_exact_init(n, k, seed, stdev=0.1):
    """The exact engines' initial draw (JAX mcmc.py learn, :280-286):
    (w0, w [n], V [n, k]) as numpy."""
    key = jax.random.PRNGKey(seed)
    key, kw, kv = jax.random.split(key, 3)
    w = stdev * jax.random.normal(kw, (n,), dtype=jnp.float32)
    vt = stdev * jax.random.normal(kv, (k, n), dtype=jnp.float32)
    return np.float32(0.0), np.asarray(w), np.asarray(vt).T.copy()


def to_jax(*datasets):
    return [JaxDataset(d.indptr, d.cols, d.vals, d.target, d.num_features) for d in datasets]


def run_pair(train, test, *, k, seed, cls=(JaxALS, ALSLearner), task=0, reg=1.0, **kw):
    """(JAX learner, port learner) of the exact engine over the same data,
    options and initial parameters."""
    n = train.num_features
    regs = {} if reg is None else dict(regw=reg, regv=reg)
    common = dict(num_iter=ITERS, seed=seed, verbose=False, **kw)
    j = cls[0](JaxFMConfig(num_features=n, num_factors=k, **regs),
               task=JAX_TASK_CLASSIFICATION if task else 0, **common)
    t = cls[1](FMConfig(num_features=n, num_factors=k, **regs),
               task=TASK_CLASSIFICATION if task else 0, device="cpu",
               init_params=params_from_jax(*jax_exact_init(n, k, seed), device="cpu"),
               **common)
    j.learn(*to_jax(train, test))
    t.learn(train, test)
    return j, t


def assert_trajectories_match(j, t, tol=TRAJ_TOL):
    assert len(j.history) == len(t.history) == ITERS
    for a, b in zip(j.history, t.history):
        for key in ("train", "test_this", "test_this_m2", "test_all"):
            assert abs(a[key] - b[key]) < tol, (key, a, b)
    pj, pt = j.get_params(), t.get_params()
    for x, y in ((pj.w, pt.w), (pj.v, pt.v)):
        x, y = np.asarray(x), y.numpy()
        assert np.abs(x - y).max() <= tol * np.abs(x).max()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the plain versions
    issue many small ops, and beside the other test workers' processes
    torch's thread pool makes each of them wait (an exact MCMC run took
    24x as long with 8 threads as with 1 on a loaded 8-core machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ml_small():
    return movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)


@pytest.fixture(scope="module")
def ctr_small():
    return ctr_like(num_fields=5, field_cardinality=50, num_examples=6000, seed=4)


# ---------------------------------------------------------------- the draws

def _draw_inputs(which, seed=0):
    """(FeatureBlock, w [n], e [nc], q [nc], n, nc): a block of ml_small's
    users (one-hot), or a valued block (features of 1 to ~60 slots, values
    from N(0.2, 1)), with seeded parameters and caches."""
    rng = np.random.default_rng(seed)
    if which == "onehot":
        train, _ = movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)
        block = conflict_free_blocks(train)[0]
        n, nc = train.num_features, train.num_rows
    else:
        n, nc = 300, 5000
        counts = np.minimum(rng.zipf(1.6, n), 60)
        assert counts.sum() <= nc
        rows = rng.permutation(nc)[:counts.sum()]
        cols = np.repeat(np.arange(n), counts)
        vals = rng.normal(0.2, 1.0, len(rows)).astype(np.float32)
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(nc + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=nc), out=indptr[1:])
        ds = Dataset(indptr, cols[order].astype(np.int32), vals[order],
                     np.zeros(nc, np.float32), n)
        block = conflict_free_blocks(ds)[0]
    theta = rng.normal(0, 0.3, n).astype(np.float32)
    e = rng.normal(0, 1.0, nc).astype(np.float32)
    q = rng.normal(0, 0.5, nc).astype(np.float32)
    return block, theta, e, q, n, nc


def _jax_block(block, groups):
    return jmcmc.BlockArrays(jnp.asarray(block.features), jnp.asarray(groups[block.features]),
                             jnp.asarray(block.entry_rows), jnp.asarray(block.entry_vals),
                             jnp.asarray(block.entry_feat))


@pytest.mark.parametrize("which", ["onehot", "valued"])
@pytest.mark.parametrize("mode", ["w", "v"])
@pytest.mark.parametrize("sample", [False, True])
def test_coord_draw_plain_matches_jax_block_draws(which, mode, sample):
    block, theta, e, q, n, nc = _draw_inputs(which)
    G = 3
    groups = (np.arange(n) % G).astype(np.int32)
    rng = np.random.default_rng(1)
    lam = rng.uniform(0.5, 3.0, G).astype(np.float32)
    mu = rng.normal(0, 0.1, G).astype(np.float32)
    alpha = np.float32(1.7)
    F = len(block.features)
    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(key, (F,), dtype=jnp.float32))
    jb = _jax_block(block, groups)
    bound = 1e6
    if mode == "w":
        jt, je, jrej = jmcmc.draw_w_block(jnp.asarray(theta), jnp.asarray(e), jb,
                                          jnp.asarray(mu), jnp.asarray(lam), alpha, sample,
                                          key, bound=bound)
        jq = q
    else:
        jt, je, jq, jrej = jmcmc.draw_v_block(jnp.asarray(theta), jnp.asarray(e),
                                              jnp.asarray(q), jb, jnp.asarray(mu),
                                              jnp.asarray(lam), alpha, sample, key,
                                              bound=bound)
    off, rows, vals = feature_slots(block)
    th_t, e_t, q_t = (torch.tensor(x) for x in (theta, e, q))
    rej = torch.zeros(F, dtype=torch.int32)
    cd.coord_draw(th_t, torch.as_tensor(off), torch.as_tensor(rows), torch.as_tensor(vals),
                  torch.as_tensor(block.features.astype(np.int32)),
                  torch.as_tensor(groups[block.features]), torch.tensor(lam),
                  torch.tensor(mu), torch.tensor(alpha), torch.tensor(z) if sample else None,
                  rej, bound=bound, e=e_t, q=q_t if mode == "v" else None)
    for got, want in ((th_t, jt), (e_t, je), (q_t, jq)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= DRAW_TOL * max(1.0, np.abs(want).max())
    assert int(rej.sum()) == int(jrej)


@pytest.mark.parametrize("mode", ["w", "v"])
def test_coord_draw_plain_rejects_past_the_bound(mode):
    """A tiny lambda and alpha = 0 give a draw of sd 1e3 (a proposal past
    a bound of 1): the old theta stays, the count says so, as JAX's."""
    block, theta, e, q, n, nc = _draw_inputs("onehot")
    groups = np.zeros(n, np.int32)
    F = len(block.features)
    key = jax.random.PRNGKey(2)
    z = np.asarray(jax.random.normal(key, (F,), dtype=jnp.float32))
    lam, mu = np.float32([1e-6]), np.float32([0.0])
    jb = _jax_block(block, groups)
    args = (jnp.asarray(mu), jnp.asarray(lam), 0.0, True, key)
    if mode == "w":
        jt, _, jrej = jmcmc.draw_w_block(jnp.asarray(theta), jnp.asarray(e), jb, *args, bound=1.0)
    else:
        jt, _, _, jrej = jmcmc.draw_v_block(jnp.asarray(theta), jnp.asarray(e),
                                            jnp.asarray(q), jb, *args, bound=1.0)
    off, rows, vals = feature_slots(block)
    th_t = torch.tensor(theta)
    rej = torch.zeros(F, dtype=torch.int32)
    cd.coord_draw(th_t, torch.as_tensor(off), torch.as_tensor(rows), torch.as_tensor(vals),
                  torch.as_tensor(block.features.astype(np.int32)),
                  torch.as_tensor(groups[block.features]), torch.tensor(lam), torch.tensor(mu),
                  torch.tensor(0.0), torch.tensor(z), rej, bound=1.0, e=torch.tensor(e),
                  q=torch.tensor(q) if mode == "v" else None)
    assert int(rej.sum()) == int(jrej) > F // 2
    np.testing.assert_allclose(th_t.numpy(), np.asarray(jt), rtol=0, atol=DRAW_TOL)


# ------------------------------------------------------- q read from A

def test_q_from_refresh_matches_jax_per_factor_rebuild(ml_small):
    train, _ = ml_small
    n, k = train.num_features, 6
    _, w, V = jax_exact_init(n, k, 4)
    P = torch.tensor(np.concatenate([w[:, None], V], axis=1))
    ids, vals = padded_rows_layout(train.indptr, train.cols, train.vals)
    A = torch.empty(train.num_rows, k + 1)
    fm_refresh_plain(P, torch.as_tensor(ids), torch.as_tensor(vals), torch.tensor(0.0),
                     torch.as_tensor(train.target), A)
    rows, cols, v = (jnp.asarray(x) for x in (train.row_of_entry, train.cols, train.vals))
    for f in range(k):
        q = jax_seg_sum(jnp.asarray(V[:, f])[cols] * v, rows, train.num_rows)
        assert np.abs(A[:, 1 + f].numpy() - np.asarray(q)).max() <= 1e-6


def test_q_handed_to_each_v_draw_is_current(ml_small, monkeypatch):
    """At every v launch of an ALS and an MCMC run, the q given to
    coord_draw equals the rebuilt sum over the train entries of the V
    column being drawn."""
    train, test = ml_small
    rows, cols = (torch.as_tensor(x).long() for x in (train.row_of_entry, train.cols))
    vals = torch.as_tensor(train.vals)
    seen = []
    real = tmcmc.coord_draw

    def checked(theta, *args, e, q=None, **kw):
        if q is not None:
            want = torch.zeros(train.num_rows).index_add_(0, rows, theta[cols] * vals)
            seen.append(float((q - want).abs().max() / want.abs().max()))
        return real(theta, *args, e=e, q=q, **kw)

    monkeypatch.setattr(tmcmc, "coord_draw", checked)
    for cls in (ALSLearner, MCMCLearner):
        cls(FMConfig(num_features=train.num_features, num_factors=3, regw=1, regv=1),
            num_iter=2, seed=3, verbose=False, device="cpu").learn(train, test)
    assert len(seen) == 2 * 2 * 3 * 2  # learners x iterations x factors x blocks
    assert max(seen) <= 1e-6, max(seen)


# ---------------------------------------------------------- trajectories

@pytest.mark.parametrize("groups", [False, True])
def test_als_matches_jax(ml_small, groups):
    train, test = ml_small
    attr_group = (np.repeat([0, 1], [120, 90]).astype(np.int32) if groups else None)
    j, t = run_pair(train, test, k=4, seed=11, attr_group=attr_group)
    assert_trajectories_match(j, t)
    assert all(h["rejected"] == 0 for h in t.history)
    preds = t.predict()
    assert preds.shape == (test.num_rows,)
    assert (preds >= train.min_target).all() and (preds <= train.max_target).all()


def _uneven_fields(seed=6):
    """ctr_like(5, 50, 6000) with each field's entries kept with its own
    share (0.3, 1, 0.6, 0.9, 0.5): five blocks (the field groups) of
    different entry counts, regression on the +-1 targets."""
    train, test, groups = ctr_like(num_fields=5, field_cardinality=50, num_examples=6000,
                                   seed=4)
    keep_share = np.array([0.3, 1.0, 0.6, 0.9, 0.5])
    rng = np.random.default_rng(seed)
    out = []
    for ds in (train, test):
        keep = rng.uniform(size=ds.nnz) < keep_share[groups[ds.cols]]
        lengths = np.add.reduceat(keep.astype(np.int64), ds.indptr[:-1])
        indptr = np.zeros(ds.num_rows + 1, np.int64)
        np.cumsum(lengths, out=indptr[1:])
        out.append(Dataset(indptr, ds.cols[keep], ds.vals[keep], ds.target,
                           ds.num_features))
    return out[0], out[1], groups


def test_als_max_blocks_order_matches_jax():
    train, test, groups = _uneven_fields()
    blocks, _ = exact_layout(train, groups, 2, torch.device("cpu"))
    natural = [int(b.features[0]) for b in conflict_free_blocks(train, attr_group=groups)]
    drawn = [int(b.feat_id[0]) for b in blocks]
    assert len(drawn) == 5 and drawn != natural
    assert [b.slot_row.numel() for b in blocks] == sorted(
        (b.slot_row.numel() for b in blocks), reverse=True)
    j, t = run_pair(train, test, k=4, seed=5, attr_group=groups, max_blocks=2)
    assert_trajectories_match(j, t)


def test_probit_als_matches_jax(ctr_small):
    train, test, groups = ctr_small
    j, t = run_pair(train, test, k=4, seed=5, task=1, attr_group=groups)
    assert_trajectories_match(j, t)
    for a, b in zip(j.history, t.history):
        assert abs(a["test_all_m2"] - b["test_all_m2"]) < TRAJ_TOL
        assert abs(a["auc_all"] - b["auc_all"]) < TRAJ_TOL
    preds = t.predict()
    assert ((preds >= 0) & (preds <= 1)).all()


# ----------------------------------------------------------------- MCMC

def _band(train, test, k, task, groups, tol):
    n = train.num_features
    kw = dict(num_iter=15, verbose=False, attr_group=groups)
    j = JaxMCMC(JaxFMConfig(num_features=n, num_factors=k),
                task=JAX_TASK_CLASSIFICATION if task else 0, seed=1, **kw)
    j.learn(*to_jax(train, test))
    port = []
    for seed in (1, 2, 3):
        t = MCMCLearner(FMConfig(num_features=n, num_factors=k),
                        task=TASK_CLASSIFICATION if task else 0, seed=seed, device="cpu", **kw)
        t.learn(train, test)
        assert all(h["rejected"] == 0 for h in t.history)
        assert all(np.isfinite(h[key]) for h in t.history for key in ("train", "test_all"))
        port.append(t.history[-1]["test_all"])
    assert abs(np.mean(port) - j.history[-1]["test_all"]) < tol, (port, j.history[-1])
    return t


def test_mcmc_regression_band_against_jax(ml_small):
    train, test = ml_small
    t = _band(train, test, 4, 0, None, 0.03)
    preds = t.predict()
    assert (preds >= train.min_target).all() and (preds <= train.max_target).all()


def test_mcmc_probit_band_against_jax():
    train, test, groups = ctr_like(5, 200, 15000, seed=4)
    t = _band(train, test, 8, 1, groups, 0.02)
    preds = t.predict()
    assert ((preds >= 0) & (preds <= 1)).all()
