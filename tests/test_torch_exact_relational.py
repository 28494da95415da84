"""The port's exact relational (BS) engine (learners/mcmc_relational.py)
and its block draws (K11's relational half, `rel_coord_draw`) against the
JAX package, on the CPU.

- rel_coord_draw's plain version against JAX `draw_w_rel_block` /
  `draw_v_rel_block` on seeded numpy caches over a relation of 400 block
  rows of 5 gaussian entries (features at fixed positions, so 5 blocks):
  ALS, and sampling with z = jax.random.normal(key, (F,)); theta and
  every cache within 1e-5 of its largest magnitude, the rejection counts
  equal.
- rel_cache at k = 1 over [e | q'] against JAX's seg_sum of e, e q', q'
  and q'^2 over the join map (the per-row sums of the exact engine's
  factor body, mcmc_relational.py:544-547), on a join whose row 0 holds
  most cases: within 1e-6 of each column's sum of magnitudes.
- BS ALS (k=3, regw = regv = 0.3, 5 iterations) against JAX's exact BS
  engine (MCMCLearner on relational data) from JAX's initial draw:
  train, test_this and its second metric within 1e-4 at every iteration,
  w and V within 1e-4 of their largest magnitude; with a main table (the
  JAX test's `_general_bs_problem`: two relations of several blocks
  beside a one-hot field) and without (`_single_rel_problem`), regression
  and probit (targets binarised as tests/test_torch_bs_main.py does).
- The MCMC band (general problem, k=3, 15 iterations): the mean of the
  port's final test_all over seeds 1-3 within 0.03 of JAX's seed 1. The
  spread measured on the CPU: JAX seeds 0-3 in [0.1198, 0.1264], the
  port's seeds 0-7 in [0.1051, 0.1384].
- The routing: MCMCVectorLearner with bs_vector=False, and on a join of
  skew ~33 (above 16), reports relational_mode "bs" and its ALS equals
  ALSLearner's on the same data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.learners import mcmc as jmcmc
from libfm_tpu.learners import mcmc_relational as jrel
from libfm_tpu.learners.mcmc import ALSLearner as JaxALS
from libfm_tpu.learners.mcmc import MCMCLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.ops.segment import seg_sum as jax_seg_sum
from libfm_tpu.tasks import TASK_CLASSIFICATION as JAX_TASK_CLASSIFICATION
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.batching import conflict_free_blocks, feature_slots
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.kernels import coord_draw as cd
from libfm_tpu_torch.kernels.rel_cache import case_lists, rel_cache
from libfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

from test_mcmc_rel_vector import _general_bs_problem, _single_rel_problem
from test_torch_bs_main import binarised
from test_torch_exact import jax_exact_init
from test_torch_relation import _skewed_problem, to_port

ITERS = 5
DRAW_TOL = 1e-5
TRAJ_TOL = 1e-4


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


# ---------------------------------------------------------------- the draws

def _rel_inputs(seed=0, nb=400, width=5, card=40):
    """A relation's first conflict-free block (FeatureBlock over block
    rows), n, nb and seeded caches: theta [n], we, y_b, qB, weq [nb],
    wnum [nb] (cases a row, 1 to 30), wc and wc_sqr [nb] (wc_sqr >= wc^2 /
    wnum, as sums of q' and q'^2 over the row's cases are)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, card, (nb, width))
    cols = (np.arange(width)[None, :] * card + c).astype(np.int32).ravel()
    vals = rng.standard_normal(nb * width).astype(np.float32)
    n = width * card
    ds = Dataset(np.arange(nb + 1, dtype=np.int64) * width, cols, vals,
                 np.zeros(nb, np.float32), n)
    block = conflict_free_blocks(ds)[0]
    wnum = rng.integers(1, 31, nb).astype(np.float32)
    wc = (rng.normal(0, 0.5, nb) * wnum).astype(np.float32)
    caches = dict(
        we=rng.normal(0, 1.0, nb).astype(np.float32) * wnum,
        yb=rng.normal(0, 0.5, nb).astype(np.float32),
        qb=rng.normal(0, 0.5, nb).astype(np.float32),
        weq=rng.normal(0, 1.0, nb).astype(np.float32) * wnum,
        wc=wc,
        wc_sqr=(wc * wc / wnum + rng.uniform(0.1, 1.0, nb) * wnum).astype(np.float32),
        wnum=wnum,
    )
    theta = rng.normal(0, 0.3, n).astype(np.float32)
    return block, theta, caches, n


@pytest.mark.parametrize("mode", ["w", "v"])
@pytest.mark.parametrize("sample", [False, True])
def test_rel_coord_draw_plain_matches_jax_block_draws(mode, sample):
    block, theta, c, n = _rel_inputs()
    G = 2
    groups = (np.arange(n) % G).astype(np.int32)
    lam = np.float32([1.5, 0.7])
    mu = np.float32([0.05, -0.02])
    alpha = np.float32(2.3)
    F = len(block.features)
    key = jax.random.PRNGKey(9)
    z = np.asarray(jax.random.normal(key, (F,), dtype=jnp.float32))
    jb = jmcmc.BlockArrays(jnp.asarray(block.features), jnp.asarray(groups[block.features]),
                           jnp.asarray(block.entry_rows), jnp.asarray(block.entry_vals),
                           jnp.asarray(block.entry_feat))
    J = {key_: jnp.asarray(v) for key_, v in c.items()}
    hp = (jnp.asarray(mu), jnp.asarray(lam), alpha, sample, key)
    if mode == "w":
        jt, jwe, jyb, jrej = jrel.draw_w_rel_block(jnp.asarray(theta), J["we"], J["yb"],
                                                   J["wnum"], jb, *hp, bound=1e6)
        want = dict(we=jwe, yb=jyb)
    else:
        jt, jqb, jyb, jwe, jweq, jrej = jrel.draw_v_rel_block(
            jnp.asarray(theta), J["qb"], J["yb"], J["we"], J["weq"], J["wc"], J["wc_sqr"],
            J["wnum"], jb, *hp, bound=1e6)
        want = dict(qb=jqb, yb=jyb, we=jwe, weq=jweq)
    off, rows, vals = feature_slots(block)
    T = {key_: torch.tensor(v) for key_, v in c.items()}
    th = torch.tensor(theta)
    rej = torch.zeros(F, dtype=torch.int32)
    extra = ({} if mode == "w" else
             dict(qb=T["qb"], weq=T["weq"], wc=T["wc"], wc_sqr=T["wc_sqr"]))
    cd.rel_coord_draw(th, torch.as_tensor(off), torch.as_tensor(rows), torch.as_tensor(vals),
                      torch.as_tensor(block.features.astype(np.int32)),
                      torch.as_tensor(groups[block.features]), torch.tensor(lam),
                      torch.tensor(mu), torch.tensor(alpha),
                      torch.tensor(z) if sample else None, rej, bound=1e6, we=T["we"],
                      wnum=T["wnum"], yb=T["yb"], **extra)
    want["theta"], T["theta"] = jt, th
    for name, w in want.items():
        w = np.asarray(w)
        err = np.abs(T[name].numpy() - w).max()
        assert err <= DRAW_TOL * max(1.0, np.abs(w).max()), (name, err)
    assert int(rej.sum()) == int(jrej)


def test_rel_cache_at_k1_matches_jax_per_row_sums():
    rng = np.random.default_rng(4)
    nb, nc = 50, 3000
    row_map = rng.integers(0, nb, nc).astype(np.int32)
    row_map[: nc * 3 // 4] = 0  # a hot block row
    e = rng.normal(0, 1.0, nc).astype(np.float32)
    qd = rng.normal(0, 0.7, nc).astype(np.float32)
    off, ids = case_lists(row_map, nb)
    C = rel_cache(torch.tensor(np.stack([e, qd], axis=1)), torch.as_tensor(off),
                  torch.as_tensor(ids)).numpy()
    assert C.shape == (nb + 1, 5) and not C[nb].any()
    m = jnp.asarray(row_map)
    for col, terms in ((0, (e,)), (3, (e, qd)), (2, (qd,)), (4, (qd, qd))):
        x = np.prod(terms, axis=0)
        want = np.asarray(jax_seg_sum(jnp.asarray(x), m, nb))
        scale = np.asarray(jax_seg_sum(jnp.asarray(np.abs(x)), m, nb))
        assert (np.abs(C[:nb, col] - want) <= 1e-6 * np.maximum(scale, 1.0)).all(), col


# ---------------------------------------------------------- trajectories

PROBLEMS = {"main_table": _general_bs_problem, "no_main_table": lambda: _single_rel_problem(seed=9)}


@pytest.mark.parametrize("task", [0, 1])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_bs_als_matches_jax_exact_bs(name, task):
    train, test, nf = PROBLEMS[name]()
    if task:
        train, test = binarised(train, test)
    k, seed = 3, 11
    kw = dict(num_iter=ITERS, seed=seed, verbose=False)
    j = JaxALS(JaxFMConfig(num_features=nf, num_factors=k, regw=0.3, regv=0.3),
               task=JAX_TASK_CLASSIFICATION if task else 0, **kw)
    t = ALSLearner(FMConfig(num_features=nf, num_factors=k, regw=0.3, regv=0.3),
                   task=TASK_CLASSIFICATION if task else 0, device="cpu",
                   init_params=params_from_jax(*jax_exact_init(nf, k, seed), device="cpu"),
                   **kw)
    j.learn(train, test)
    t.learn(*to_port(train, test))
    for a, b in zip(j.history, t.history, strict=True):
        for key in ("train", "test_this", "test_this_m2"):
            assert abs(a[key] - b[key]) < TRAJ_TOL, (key, a, b)
    pj, pt = j.get_params(), t.get_params()
    for x, y in ((pj.w, pt.w), (pj.v, pt.v)):
        x = np.asarray(x)
        assert np.abs(x - y.numpy()).max() <= TRAJ_TOL * np.abs(x).max()
    assert all(h["rejected"] == 0 for h in t.history)


def test_bs_mcmc_band_against_jax():
    train, test, nf = _general_bs_problem()
    kw = dict(num_iter=15, verbose=False)
    j = JaxMCMC(JaxFMConfig(num_features=nf, num_factors=3), seed=1, **kw)
    j.learn(train, test)
    ptr, pte = to_port(train, test)
    port = []
    for seed in (1, 2, 3):
        t = MCMCLearner(FMConfig(num_features=nf, num_factors=3), seed=seed, device="cpu",
                        **kw)
        t.learn(ptr, pte)
        assert all(h["rejected"] == 0 for h in t.history)
        port.append(t.history[-1]["test_all"])
    assert abs(np.mean(port) - j.history[-1]["test_all"]) < 0.03, (port, j.history[-1])
    preds = t.predict()
    assert (preds >= ptr.min_target).all() and (preds <= ptr.max_target).all()


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("case", ["bs_vector_off", "skewed"])
def test_vector_learner_falls_back_to_the_exact_bs_engine(case):
    train, test, nf = _skewed_problem() if case == "skewed" else _single_rel_problem(seed=9)
    ptr, pte = to_port(train, test)
    k, seed = 2, 5
    init = params_from_jax(*jax_exact_init(nf, k, seed), device="cpu")
    kw = dict(num_iter=4, seed=seed, verbose=False, device="cpu", init_params=init)
    cfg = FMConfig(num_features=nf, num_factors=k, regw=0.3, regv=0.3)
    vec = ALSVectorLearner(cfg, **kw)
    vec.expand_max_ratio = 0.0
    vec.bs_vector = case != "bs_vector_off"
    vec.learn(ptr, pte)
    assert vec.relational_mode == "bs"
    assert (vec.incr_test, vec.deferred) == (False, False)
    exact = ALSLearner(cfg, **kw)
    exact.learn(ptr, pte)
    assert [h["test_this"] for h in vec.history] == [h["test_this"] for h in exact.history]
    assert [h["train"] for h in vec.history] == [h["train"] for h in exact.history]
