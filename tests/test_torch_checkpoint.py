"""Checkpoint and resume on the port's MCMC engines, on the CPU (the port
alone: a JAX checkpoint does not load here, ROADMAP "Parity").

- utils/checkpoint.py: the .npz round trip by name, with the generator's
  state, written atomically.
- Resume against the straight run, on every engine: the flat vector
  engine (regression, and probit with its latents), the BS vector engine
  (its deferred path's caches and SD rows), the flat exact engine and the
  exact BS engine (its y_B caches). 4 iterations saved, then resumed to
  8, against 8 straight: test_this within JAX's own tolerances
  (tests/test_checkpoint.py, tests/test_mcmc_relational.py): 1e-5
  relative on the flat exact engine, 1e-4 on the vector and exact BS
  engines, 5e-3 absolute under probit. Not bit-equal, in JAX either: the
  first iteration after a restart refreshes, which the straight run does
  not.
- What is bit-equal: two resumes from one checkpoint, and the state a
  4-iteration run saves against the state an 8-iteration run saves at its
  boundary 4.
- A file of another configuration, of another engine or of another
  layout warns "starting fresh" and starts at iteration 0, as a missing
  file does (silently: the first run of a checkpointed chain).
"""

import numpy as np
import pytest
import torch

from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.relation import RelationData, RelationJoin
from libfm_tpu_torch.data.synth import ctr_like, movielens_like
from libfm_tpu_torch.learners.mcmc import MCMCLearner
from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION
from libfm_tpu_torch.utils import checkpoint as ckpt

FULL, HALF = 8, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain versions issue many small ops (as in
    tests/test_torch_exact.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def single_rel_problem(seed=9, NB=60, W=5, NF=200, NTR=3000):
    """A one-relation BS regression problem with an empty main table (the
    port's copy of tests/test_mcmc_rel_vector.py `_single_rel_problem`)."""
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(NF, W, replace=False)) for _ in range(NB)])
    vals = rng.standard_normal((NB, W)).astype(np.float32)
    rd = RelationData(np.arange(NB + 1, dtype=np.int64) * W, cols.ravel(), vals.ravel(), NF)
    beta = rng.standard_normal(NF).astype(np.float32) * 0.1
    score = (vals * beta[cols]).sum(axis=1)

    def build(m):
        y = (score[m] + 0.2 * rng.standard_normal(len(m))).astype(np.float32)
        ds = Dataset(np.zeros(len(m) + 1, np.int64), np.empty(0, np.int32),
                     np.empty(0, np.float32), y, 0)
        ds.relations = [RelationJoin(rd, m)]
        return ds

    mtr = rng.integers(0, NB, NTR).astype(np.int32)
    mte = rng.integers(0, NB, NTR // 5).astype(np.int32)
    return build(mtr), build(mte), NF


@pytest.fixture(scope="module")
def data():
    ctr_tr, ctr_te, groups = ctr_like(num_fields=3, field_cardinality=40, num_examples=2500,
                                      seed=7)
    return dict(ml=movielens_like(num_users=60, num_items=40, num_ratings=2000, seed=2),
                ctr=(ctr_tr, ctr_te, groups), bs=single_rel_problem())


#: engine -> (learner class, data, task, options, tolerance of test_this:
#: ("rtol", x) or ("atol", x))
ENGINES = {
    "vector": (MCMCVectorLearner, "ml", 0, dict(refresh_every=3), ("rtol", 1e-4)),
    "vector_probit": (MCMCVectorLearner, "ctr", 1, dict(refresh_every=3), ("atol", 5e-3)),
    "bs_vector": (MCMCVectorLearner, "bs", 0, dict(refresh_every=3), ("rtol", 1e-4)),
    "exact": (MCMCLearner, "ml", 0, {}, ("rtol", 1e-5)),
    "exact_bs": (MCMCLearner, "bs", 0, {}, ("rtol", 1e-4)),
}


def make(data, engine, num_iter, path=None, every=0, k=3, seed=5, **kw):
    cls, which, task, opts, _ = ENGINES[engine]
    train, test, *rest = data[which]
    nf = rest[0] if which == "bs" else train.num_features
    groups = rest[0] if which == "ctr" else None
    learner = cls(FMConfig(num_features=nf, num_factors=k), task=task, num_iter=num_iter,
                  seed=seed, verbose=False, device="cpu", attr_group=groups,
                  checkpoint_path=path, checkpoint_every=every, **opts, **kw)
    if which == "bs" and cls is MCMCVectorLearner:
        learner.expand_max_ratio = 0.0  # the BS vector engine, not the expansion
    return learner, (train, test)


def run(data, engine, num_iter, path=None, every=0, **kw):
    learner, (train, test) = make(data, engine, num_iter, path, every, **kw)
    learner.learn(train, test)
    return learner


def test_save_restore_round_trip(tmp_path):
    g = torch.Generator()
    g.manual_seed(3)
    state = dict(P=torch.arange(12, dtype=torch.float32).reshape(4, 3),
                 rejected=torch.tensor(2, dtype=torch.int64),
                 latent=np.linspace(0, 1, 5, dtype=np.float32),
                 generator=g.get_state())
    path = tmp_path / "sub" / "chain.npz"
    ckpt.save_state(str(path), state, {"iter": 7, "engine": "vector"})
    assert [p.name for p in path.parent.iterdir()] == ["chain.npz"]  # no temporary left
    got, meta = ckpt.restore_state(str(path))
    assert meta == {"iter": 7, "engine": "vector"}
    assert set(got) == set(state)
    for name, x in state.items():
        want = x.numpy() if torch.is_tensor(x) else x
        assert got[name].dtype == want.dtype and np.array_equal(got[name], want)
    want_draws = torch.randn(4, generator=g)
    g2 = torch.Generator()
    g2.set_state(torch.from_numpy(got["generator"]))
    assert torch.equal(torch.randn(4, generator=g2), want_draws)
    with pytest.raises(ValueError, match="reserved"):
        ckpt.save_state(str(path), {ckpt.META_KEY: np.zeros(1)})


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_resume_tracks_the_straight_run(data, engine, tmp_path):
    path = str(tmp_path / f"{engine}.npz")
    straight = run(data, engine, FULL)
    first = run(data, engine, HALF, path, HALF)
    assert [h["iter"] for h in first.history] == list(range(HALF))
    resumed = run(data, engine, FULL, path, HALF)
    assert [h["iter"] for h in resumed.history] == list(range(HALF, FULL))
    got = np.array([h["test_this"] for h in resumed.history])
    want = np.array([h["test_this"] for h in straight.history[HALF:]])
    kind, tol = ENGINES[engine][-1]
    if kind == "rtol":
        np.testing.assert_allclose(got, want, rtol=tol)
    else:
        np.testing.assert_allclose(got, want, atol=tol)
    assert all(h["rejected"] == 0 for h in resumed.history)
    # the posterior mean covers every iteration of the chain, both runs'
    p_straight, p_resumed = straight.predict(), resumed.predict()
    assert np.abs(p_straight - p_resumed).max() < (5e-3 if kind == "atol" else 1e-3)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_two_resumes_are_the_same_bits(data, engine, tmp_path):
    path = str(tmp_path / f"{engine}.npz")
    run(data, engine, HALF, path, HALF)
    a = run(data, engine, FULL, path, 0)
    b = run(data, engine, FULL, path, 0)
    assert [h["test_this"] for h in a.history] == [h["test_this"] for h in b.history]
    for key in ("w0", "alpha", "w", "V", "v_lambda", "pred_sum_all"):
        assert torch.equal(a._final_state[key], b._final_state[key]), key


@pytest.mark.parametrize("engine", ["vector", "vector_probit", "exact_bs"])
def test_the_boundary_state_is_the_short_runs(data, engine, tmp_path):
    """The state an 8-iteration run saves at its boundary 4 is the bits of
    the state a 4-iteration run saves (the same chunks, fixed-order sums)."""
    path = str(tmp_path / "short.npz")
    run(data, engine, HALF, path, HALF)
    short, _ = ckpt.restore_state(path)
    learner, (train, test) = make(data, engine, FULL, str(tmp_path / "long.npz"), HALF)
    saved = {}

    def keep(engine_tag, st, bufs, it):
        saved[it] = {name: np.array(x) for name, x in learner._ckpt_state(st, bufs).items()}

    learner._save_checkpoint = keep
    learner.learn(train, test)
    assert sorted(saved) == [HALF, FULL]
    assert set(saved[HALF]) == set(short)
    for name, x in short.items():
        assert np.array_equal(saved[HALF][name], x), name


@pytest.mark.parametrize("case", ["meta", "engine", "structure", "missing"])
def test_a_checkpoint_that_does_not_fit_starts_fresh(data, case, tmp_path, capsys):
    path = str(tmp_path / "chain.npz")
    engine = "bs_vector" if case == "structure" else "vector"
    if case == "meta":  # another k
        run(data, engine, 2, path, 2, k=4)
    elif case == "engine":  # the exact engine's file, on the same data and config
        run(data, "exact", 2, path, 2)
    elif case == "structure":  # the BS vector engine's resync path: no C, no SD rows
        learner, (train, test) = make(data, engine, 2, path, 2)
        learner.bs_deferred = False
        learner.learn(train, test)
    capsys.readouterr()
    learner = run(data, engine, 3, path, 0)
    assert [h["iter"] for h in learner.history] == [0, 1, 2]
    out = capsys.readouterr().out
    assert ("starting fresh" in out) == (case != "missing"), out
    if case == "engine":
        assert "exact engine" in out
    # the fresh start is the chain without a checkpoint
    plain = run(data, engine, 3)
    assert [h["test_this"] for h in learner.history] == [h["test_this"]
                                                          for h in plain.history]
