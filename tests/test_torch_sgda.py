"""The port's SGDA learner against the JAX learner, on the CPU (the
kernels' plain versions).

- JAX on the CPU keeps the last write of `.at[].set` in entry order (the
  premise of the port's cache writers), and `sgda_scatter_plan` names
  those writers;
- `sgda_step_plain` against JAX's `theta_step` and `sgda_lambda_plain`
  against its `lambda_step` (`SGDALearner._make_steps`), on one batch
  with duplicate ids and padded rows, in the three modes, both tasks,
  the linear term on and off and G in {1, 2, 13}: the new table, w0 and
  the cache rows 0..n-1, and the regularizers (entries clamped at 0
  included), within 1e-6 relative (with a floor of 1e-6 of the array's
  largest value: f32 sums taken in another order);
- `SGDALearner.learn` over 3 epochs against JAX's from the same
  parameters, on ml_small (G = 2, users and items) and a small ctr_like
  (its field groups, classification), each with a seeded validation set
  carved from the train rows: every (train, test, validation) metric,
  the final regularizers and parameters within 1e-5;
- the port's plain path in float64 at batch_size=1 follows the numpy
  transcription of libFM's sequential SGDA steps (tests/test_oracle_b1.py)
  within rtol 1e-6;
- w0 after 32 of config #1's batches (B = 32768, k = 8, lr 0.003) in
  f32, the port's SGD and SGDA epochs against JAX's, each beside the
  float64 epoch: SGDA's w0 equals JAX's bit for bit, SGD's drifts no
  further than JAX's plus the one extra rounding a batch of its w0 line;
- `sgda_lambda_plain` against JAX's `lambda_step` at G (1+k) above
  7,168 (k = 16 with 500 groups, k = 128 with 64), in each mode;
- the options outside this slice raise.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.data.batching import batch_dataset as jax_batch_dataset
from libfm_tpu.data.synth import ctr_like as jax_ctr_like
from libfm_tpu.data.synth import movielens_like as jax_movielens_like
from libfm_tpu.learners import sgd as jsgd
from libfm_tpu.learners import sgda as jsgda
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.models.fm import FMParams as JaxFMParams
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.batching import batch_dataset
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.streaming import StreamingDataset
from libfm_tpu_torch.data.synth import ctr_like, movielens_like
from libfm_tpu_torch.kernels.sgda_lambda import sgda_lambda_plain
from libfm_tpu_torch.kernels import sgd_step as tsgd_step
from libfm_tpu_torch.kernels.sgda_step import fma_f32, sgda_step_plain, w0_update
from libfm_tpu_torch.kernels.table_scatter import table_scatter_plain
from libfm_tpu_torch.learners import sgd as tsgd
from libfm_tpu_torch.learners import sgda as tsgda
from libfm_tpu_torch.models.fm import FMConfig, FMParams
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION, TASK_REGRESSION
from libfm_tpu_torch.utils.rlog import RLog

K = 4
N = 40  # features of the one-batch cases: ids repeat within a batch
B = 64
PAD = 5  # padded rows at the end of the one-batch cases
LS = {"pair": 2, "onehot": 13, "general": 5}


def _close(got, want, rtol=1e-6):
    """Within rtol of each value, with a floor of rtol times the array's
    largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


def test_jax_set_keeps_the_last_write_in_entry_order():
    """XLA on the CPU: `.at[ids].set(v)` with duplicate ids equals numpy's
    `a[ids] = v`, which keeps the last write in entry order."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, 100_000).astype(np.int32)
    v = rng.standard_normal(100_000).astype(np.float32)
    want = np.zeros(50, np.float32)
    want[ids] = v
    got = np.asarray(jnp.zeros(50, jnp.float32).at[jnp.asarray(ids)].set(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    last = {int(i): j for j, i in enumerate(ids)}
    assert all(want[i] == v[j] for i, j in last.items())


def test_scatter_plan_names_the_last_real_writer():
    """gc_row: each id's last entry of value != 0 in entry order writes
    its row, no other entry writes, the padded slots never; order and
    n_real cut the sorted ids below n."""
    rng = np.random.default_rng(1)
    nb, Bq, L, n = 3, 50, 4, 20
    ids = rng.integers(0, n, (nb, Bq, L)).astype(np.int32)
    vals = (rng.random((nb, Bq, L)) < 0.8).astype(np.float32)
    ids[:, -6:] = 0
    vals[:, -6:] = 0.0
    sids, order, gc_row, n_real = tsgda.sgda_scatter_plan(ids, vals, n)
    for b in range(nb):
        keys = np.where(vals[b] != 0, ids[b], n).reshape(-1)
        writer = np.full(n + 1, -1)
        writer[keys] = np.arange(keys.size)  # numpy keeps the last write
        want = np.full(keys.size, n)
        real = writer[:n][writer[:n] >= 0]
        want[real] = keys[real]
        np.testing.assert_array_equal(gc_row[b].reshape(-1), want)
        np.testing.assert_array_equal(sids[b][order[b].reshape(-1)], keys)
        assert n_real[b] == (keys < n).sum() and (sids[b][: n_real[b]] < n).all()


def _groups(G, n=N):
    return (np.arange(n) % G).astype(np.int32)


def _batch(mode, seed):
    """One batch of B rows, L = LS[mode] entries, ids drawn from N features
    (many repeat), the last PAD rows padded (id 0, value 0, row mask
    False); values 1 in "pair" and "onehot" modes, N(1, 0.5) with one in
    five 0 in "general" mode; targets 1-5 or +-1 by task."""
    rng = np.random.default_rng(seed)
    L = LS[mode]
    ids = rng.integers(0, N, (B, L)).astype(np.int32)
    if mode == "general":
        vals = (rng.normal(1, 0.5, (B, L)) * (rng.random((B, L)) < 0.8)).astype(np.float32)
    else:
        vals = np.ones((B, L), np.float32)
    mask = np.ones(B, bool)
    mask[B - PAD:] = False
    ids[~mask] = 0
    vals[~mask] = 0.0
    y = rng.choice([-1.0, 1.0], B).astype(np.float32)
    return ids, vals, y, mask


def _state(G, seed):
    """(w0, w, V, grad_w [N+1], grad_v [N+1, K], reg_w [G], reg_v [G, K]):
    the regularizers half 0, half in [0, 0.05)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    reg_w = (rng.random(G) * 0.05 * (rng.random(G) < 0.5)).astype(f)
    reg_v = (rng.random((G, K)) * 0.05 * (rng.random((G, K)) < 0.5)).astype(f)
    return (f(0.3), rng.normal(0, 0.1, N).astype(f), rng.normal(0, 0.3, (N, K)).astype(f),
            rng.normal(0, 0.1, N + 1).astype(f), rng.normal(0, 0.1, (N + 1, K)).astype(f),
            reg_w, reg_v)


def _jax_steps(G, task, use_linear, lr, lims):
    cfg = JaxFMConfig(num_features=N, num_factors=K, use_linear=use_linear)
    learner = jsgda.SGDALearner(cfg, attr_group=_groups(G), task=task, verbose=False)
    return learner._make_steps(jnp.float32(lr), *lims)


def _targets(y, task):
    return y if task == TASK_CLASSIFICATION else (3.0 + y).astype(np.float32)


def test_w0_update_rounds_once_as_jax():
    """`w0_update` against JAX's w0 line on the CPU (XLA fuses it into a
    fused multiply-add), on products lr s = +-2^j (1 - a^2 2^-46) that put
    w0 - lr s within a float64 ulp of a float32 tie, where rounding twice
    would go wrong, and on plain random values; bit for bit."""
    rng = np.random.default_rng(0)
    m = 20000
    w0 = rng.uniform(1, 2, m).astype(np.float32) * rng.choice([-1, 1], m).astype(np.float32)
    a, sg = rng.integers(1, 2000, m), rng.choice([-1, 1], m)
    lr = (np.ldexp(1.0, -25 + rng.integers(-1, 2, m)) * (1 + a * 2.0**-23)).astype(np.float32)
    s = ((1 - sg * a * 2.0**-23) * sg).astype(np.float32)
    lr[: m // 4] = np.float32(0.003)
    s[: m // 4] = rng.normal(0, 3e4, m // 4).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda x, l, y: x - l * y))(w0, lr, s))
    got = [float(w0_update(torch.tensor(x), float(l), torch.tensor(y)))
           for x, l, y in zip(w0, lr, s)]
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    twice = (w0.astype(np.float64) - lr.astype(np.float64) * s).astype(np.float32)
    assert (twice != want).any()  # the cases reach the double rounding


STEP_CASES = [(mode, task, use_linear, G) for mode in ("pair", "onehot", "general")
              for task in (TASK_REGRESSION, TASK_CLASSIFICATION)
              for use_linear in (True, False) for G in (1, 2, 13)]


@pytest.mark.parametrize("mode,task,use_linear,G", STEP_CASES)
def test_theta_step_plain_matches_jax(mode, task, use_linear, G):
    ids, vals, y, mask = _batch(mode, seed=10 + G)
    y = _targets(y, task)
    w0, w, V, gw, gv, rw, rv = _state(G, seed=20 + G)
    lr, lims = 0.05, (1.0, 5.0)
    theta, _ = _jax_steps(G, task, use_linear, lr, lims)
    jp, (jgw, jgv) = theta(JaxFMParams(jnp.asarray(w0), jnp.asarray(w), jnp.asarray(V)),
                           (jnp.asarray(gw), jnp.asarray(gv)),
                           (jnp.asarray(rw), jnp.asarray(rv)),
                           tuple(jnp.asarray(a) for a in (ids, vals, y, mask)))

    sids, order, gc_row, n_real = tsgda.sgda_scatter_plan(ids[None], vals[None], N)
    P = torch.as_tensor(np.concatenate([w[:, None], V], axis=1))
    Gc = torch.as_tensor(np.concatenate([gw[:, None], gv], axis=1))
    w0_t = torch.tensor(w0)
    t = [torch.as_tensor(a) for a in (ids, vals, y, mask)]
    upd, red = sgda_step_plain(
        P, *t, w0_t, Gc, torch.as_tensor(gc_row[0]), torch.as_tensor(_groups(G)),
        torch.as_tensor(rw), torch.as_tensor(rv), mode=mode, task=task, lr=lr,
        min_target=lims[0], max_target=lims[1], use_linear=use_linear,
        order=torch.as_tensor(order[0]))
    m = int(n_real[0])
    table_scatter_plain(P, torch.as_tensor(sids[0][:m]), None, upd[:m])
    assert m < B * LS[mode]  # the padded slots add nothing
    _close(float(w0_t), float(jp.w0))
    assert float(w0_t) == float(w0_update(torch.tensor(w0), lr, red[0]))
    _close(P[:, 0].numpy(), np.asarray(jp.w))
    _close(P[:, 1:].numpy(), np.asarray(jp.v))
    _close(Gc[:N, 0].numpy(), np.asarray(jgw)[:N])
    _close(Gc[:N, 1:].numpy(), np.asarray(jgv)[:N])
    if not use_linear:
        np.testing.assert_array_equal(P[:, 0].numpy(), w)
        np.testing.assert_array_equal(Gc[:, 0].numpy(), gw)


@pytest.mark.parametrize("mode,task,use_linear,G", STEP_CASES)
def test_lambda_step_plain_matches_jax(mode, task, use_linear, G):
    ids, vals, y, mask = _batch(mode, seed=30 + G)
    y = _targets(y, task)
    w0, w, V, gw, gv, rw, rv = _state(G, seed=40 + G)
    lr, lims = 0.05, (1.0, 5.0)
    _, lam = _jax_steps(G, task, use_linear, lr, lims)
    jw, jv = lam(JaxFMParams(jnp.asarray(w0), jnp.asarray(w), jnp.asarray(V)),
                 (jnp.asarray(gw), jnp.asarray(gv)), (jnp.asarray(rw), jnp.asarray(rv)),
                 tuple(jnp.asarray(a) for a in (ids, vals, y, mask)))
    jw, jv = np.asarray(jw), np.asarray(jv)
    P = torch.as_tensor(np.concatenate([w[:, None], V], axis=1))
    Gc = torch.as_tensor(np.concatenate([gw[:, None], gv], axis=1))
    reg_w, reg_v = torch.as_tensor(rw.copy()), torch.as_tensor(rv.copy())
    got_w, got_v = sgda_lambda_plain(
        P, Gc, *(torch.as_tensor(a) for a in (ids, vals, y, mask)), torch.tensor(w0),
        torch.as_tensor(_groups(G)), reg_w, reg_v, mode=mode, task=task, lr=lr,
        min_target=lims[0], max_target=lims[1], use_linear=use_linear)
    assert got_w is reg_w and got_v is reg_v
    _close(reg_w.numpy(), jw)
    _close(reg_v.numpy(), jv)
    # the step itself, not only the regularizers it moved
    _close(reg_v.numpy() - rv, jv - rv, rtol=1e-5)
    if use_linear:
        _close(reg_w.numpy() - rw, jw - rw, rtol=1e-5)
    else:
        np.testing.assert_array_equal(reg_w.numpy(), rw)
    np.testing.assert_array_equal(reg_v.numpy() == 0, jv == 0)
    if G == 13:
        assert (jv == 0).any() and (jv > 0).any()
        assert ((jv == 0) & (rv > 0)).any() or ((jv == 0) & (rv == 0)).any()


# G (1+k) above 7,168, the most the lambda kernel took in one launch before
# it took S's columns in tiles: k = 16 with 500 groups, k = 128 with 64
WIDE = [(16, 500), (128, 64)]
WIDE_N = 1200  # features of the wide cases: every group holds some


@pytest.mark.parametrize("k,G", WIDE)
@pytest.mark.parametrize("mode", ["pair", "onehot", "general"])
def test_lambda_step_plain_matches_jax_at_many_groups(k, G, mode):
    """sgda_lambda_plain against JAX's lambda_step with G (1+k) > 7,168:
    the step on each regularizer within 1e-5 of its largest (f32 sums
    over k = 128 factors taken in another order; a step of ~0.1 leaves
    some values near 0, so a bound relative to each value would hold
    nothing), and the same entries clamped at 0."""
    assert G * (k + 1) > 7168
    rng = np.random.default_rng(60 + k)
    L = LS[mode]
    ids = rng.integers(0, WIDE_N, (B, L)).astype(np.int32)
    vals = (np.ones((B, L)) if mode != "general"
            else rng.normal(1, 0.5, (B, L)) * (rng.random((B, L)) < 0.8)).astype(np.float32)
    mask = np.ones(B, bool)
    mask[B - PAD:] = False
    ids[~mask] = 0
    vals[~mask] = 0.0
    y = (3.0 + rng.choice([-1.0, 1.0], B)).astype(np.float32)
    f = np.float32
    w0, w = f(0.3), rng.normal(0, 0.1, WIDE_N).astype(f)
    V = rng.normal(0, 0.3, (WIDE_N, k)).astype(f)
    gw, gv = rng.normal(0, 0.1, WIDE_N + 1).astype(f), rng.normal(0, 0.1, (WIDE_N + 1, k)).astype(f)
    rw = (rng.random(G) * 0.05 * (rng.random(G) < 0.5)).astype(f)
    rv = (rng.random((G, k)) * 0.05 * (rng.random((G, k)) < 0.5)).astype(f)
    groups = _groups(G, WIDE_N)
    lr, lims = 0.05, (1.0, 5.0)
    cfg = JaxFMConfig(num_features=WIDE_N, num_factors=k)
    jl = jsgda.SGDALearner(cfg, attr_group=groups, task=TASK_REGRESSION, verbose=False)
    _, lam = jl._make_steps(jnp.float32(lr), *lims)
    jw, jv = lam(JaxFMParams(jnp.asarray(w0), jnp.asarray(w), jnp.asarray(V)),
                 (jnp.asarray(gw), jnp.asarray(gv)), (jnp.asarray(rw), jnp.asarray(rv)),
                 tuple(jnp.asarray(a) for a in (ids, vals, y, mask)))
    jw, jv = np.asarray(jw), np.asarray(jv)
    P = torch.as_tensor(np.concatenate([w[:, None], V], axis=1))
    Gc = torch.as_tensor(np.concatenate([gw[:, None], gv], axis=1))
    reg_w, reg_v = torch.as_tensor(rw.copy()), torch.as_tensor(rv.copy())
    sgda_lambda_plain(P, Gc, *(torch.as_tensor(a) for a in (ids, vals, y, mask)),
                      torch.tensor(w0), torch.as_tensor(groups), reg_w, reg_v, mode=mode,
                      task=TASK_REGRESSION, lr=lr, min_target=lims[0], max_target=lims[1])
    _close(reg_v.numpy() - rv, jv - rv, rtol=1e-5)
    _close(reg_w.numpy() - rw, jw - rw, rtol=1e-5)
    np.testing.assert_array_equal(reg_v.numpy() == 0, jv == 0)
    assert (jv != rv).any() and (jv == 0).any()


# ---- the learner, 3 epochs against JAX


def _jax_holdout(ds, seed=5):
    """`Dataset.holdout` for the JAX package's Dataset: a seeded random
    ninth of the rows as the validation set, the rest as train, keeping
    the whole set's clamp range."""
    sh = ds.permuted(np.random.default_rng(seed).permutation(ds.num_rows))
    nv = ds.num_rows // 9

    def rows(a, b):
        lo, hi = sh.indptr[a], sh.indptr[b]
        out = type(ds)(sh.indptr[a:b + 1] - lo, sh.cols[lo:hi], sh.vals[lo:hi],
                       sh.target[a:b], sh.num_features)
        out.min_target, out.max_target = ds.min_target, ds.max_target
        return out

    return rows(nv, ds.num_rows), rows(0, nv)


@pytest.fixture(scope="module", params=["regression", "classification"])
def learner_pair(request):
    """JAX and port SGDALearner, 3 epochs from the same parameters."""
    if request.param == "regression":
        (jtr, jte), (ttr, tte) = (jax_movielens_like(120, 90, 8000, seed=3),
                                  movielens_like(120, 90, 8000, seed=3))
        groups = (np.arange(jtr.num_features) >= 120).astype(np.int32)  # users, items
        task, lr = TASK_REGRESSION, 0.02
    else:
        (jtr, jte, groups), (ttr, tte, _) = (jax_ctr_like(5, 50, 6000, seed=4),
                                             ctr_like(5, 50, 6000, seed=4))
        task, lr = TASK_CLASSIFICATION, 0.005
    (jtr, jval), (ttr, tval) = _jax_holdout(jtr), ttr.holdout(5)
    for j, t in ((jtr, ttr), (jval, tval)):  # the same split on both sides
        for a in ("indptr", "cols", "vals", "target", "min_target", "max_target"):
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
    n = jtr.num_features
    init = (np.float32(0.1), np.zeros(n, np.float32),
            np.random.default_rng(2).normal(0, 0.1, (n, 8)).astype(np.float32))
    kw = dict(attr_group=groups, task=task, num_iter=3, learn_rate=lr, batch_size=64,
              seed=1, verbose=False)
    jl = jsgda.SGDALearner(JaxFMConfig(num_features=n, num_factors=8), **kw)
    jl.init_params(JaxFMParams(*(jnp.asarray(a) for a in init)))
    jl.learn(jtr, jte, validation=jval)
    tl = tsgda.SGDALearner(FMConfig(num_features=n, num_factors=8), device="cpu", **kw)
    tl.init_params(FMParams(*params_from_jax(*init, device="cpu")))
    tl.learn(ttr, tte, validation=tval)
    return jl, tl


def test_learn_history_matches_jax(learner_pair):
    jl, tl = learner_pair
    assert len(jl.history) == len(tl.history) == 3
    for jh, th in zip(jl.history, tl.history):
        np.testing.assert_allclose(th[:3], jh[:3], rtol=0, atol=1e-5)
        assert th[3] > 0
    assert tl.history[-1][2] != tl.history[0][2]


def test_learned_regularizers_and_params_match_jax(learner_pair):
    jl, tl = learner_pair
    assert float(tl.reg_v.max()) > 0  # the lambda steps ran
    for got, want in ((tl.reg_w, jl.reg_w), (tl.reg_v, jl.reg_v),
                      (tl.params.w0, jl.params.w0), (tl.params.w, jl.params.w),
                      (tl.params.v, jl.params.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---- the B=1 float64 oracle (tests/test_oracle_b1.py:114)


def _oracle_rows(num_rows, num_features, seed, max_len=4):
    """tests/test_oracle_b1.py _rows: rows of 1-4 valued entries."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, num_rows)
    cols = [np.sort(rng.choice(num_features, ln, replace=False)) for ln in lens]
    vals = [rng.standard_normal(ln) for ln in lens]
    beta = rng.standard_normal(num_features) * 0.5
    y = np.array([float((v * beta[c]).sum()) + 2.0 for c, v in zip(cols, vals)])
    return cols, vals, y


def _oracle_dataset(cols, vals, y, n):
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])]).astype(np.int64)
    return Dataset(indptr, np.concatenate(cols).astype(np.int32),
                   np.concatenate(vals).astype(np.float32), np.asarray(y, np.float32), n)


def test_plain_path_f64_matches_b1_oracle():
    """SGDALearner at batch_size=1 in float64 == the reference's
    interleaved theta/lambda steps (adapt_reg.h:136-248, round-robin
    validation, no lambda step in iteration 0, :294-311), parameter for
    parameter and regularizer for regularizer."""
    n, k, rows, vrows, G, lr = 24, 3, 60, 20, 2, 0.01
    cols, vals, y = _oracle_rows(rows, n, seed=5)
    vc, vv, vy = _oracle_rows(vrows, n, seed=6)
    train = _oracle_dataset(cols, vals, y, n)
    val = _oracle_dataset(vc, vv, vy, n)
    y = np.asarray(train.target, np.float64)
    vy = np.asarray(val.target, np.float64)
    attr_group = (np.arange(n) % 2).astype(np.int32)
    cfg = FMConfig(num_features=n, num_factors=k, dtype=torch.float64)
    rng = np.random.default_rng(12)
    w0, V = 0.2, rng.normal(0, 0.1, (n, k))
    learner = tsgda.SGDALearner(cfg, attr_group=attr_group, num_iter=3, learn_rate=lr,
                                batch_size=1, verbose=False, device="cpu")
    learner.init_params(FMParams(torch.tensor(w0, dtype=torch.float64),
                                 torch.tensor(rng.normal(0, 0.1, n)), torch.tensor(V)))
    V = V.copy()
    w = np.zeros(n)  # the reference resets w at learn() start (:282-289)
    reg_w, reg_v = np.zeros(G), np.zeros((G, k))
    grad_w, grad_v = np.zeros(n), np.zeros((n, k))
    min_t, max_t = float(train.min_target), float(train.max_target)

    def predict(w0_, w_, V_, ci, xv):
        d = V_[ci] * xv[:, None]
        s = d.sum(axis=0)
        return w0_ + (w_[ci] * xv).sum() + 0.5 * ((s * s).sum() - (d * d).sum()), s

    def theta_step(ci, vi, yi):
        nonlocal w0
        vi = np.asarray(np.asarray(vi, np.float32), np.float64)
        p, s = predict(w0, w, V, ci, vi)
        mult = 2.0 * (min(max(p, min_t), max_t) - yi)
        g = attr_group[ci]
        w0 -= lr * mult  # reg_0 = 0
        grad_w[ci] = mult * vi
        w[ci] -= lr * (grad_w[ci] + 2.0 * reg_w[g] * w[ci])
        grad_v[ci] = mult * (vi[:, None] * (s[None, :] - V[ci] * vi[:, None]))
        V[ci] -= lr * (grad_v[ci] + 2.0 * reg_v[g] * V[ci])

    def lambda_step(ci, vi, yi):
        vi = np.asarray(np.asarray(vi, np.float32), np.float64)
        g = attr_group[ci]
        w_dash = w[ci] - lr * (grad_w[ci] + 2.0 * reg_w[g] * w[ci])
        v_dash = V[ci] - lr * (grad_v[ci] + 2.0 * reg_v[g] * V[ci])
        d = v_dash * vi[:, None]
        p = w0 + (w_dash * vi).sum() + 0.5 * ((d.sum(0) ** 2).sum() - (d * d).sum())
        grad_loss = 2.0 * (min(max(p, min_t), max_t) - yi)
        lam_w = np.zeros(G)
        np.add.at(lam_w, g, vi * w[ci])
        reg_w[:] = np.maximum(reg_w - lr * grad_loss * (-2.0 * lr * lam_w), 0.0)
        sum_f, sum_fdf = np.zeros((G, k)), np.zeros((G, k))
        xv = V[ci] * vi[:, None]
        np.add.at(sum_f, g, xv)
        np.add.at(sum_fdf, g, d * xv)
        lam_v = -2.0 * lr * (d.sum(axis=0)[None, :] * sum_f - sum_fdf)
        reg_v[:] = np.maximum(reg_v - lr * grad_loss * lam_v, 0.0)

    for it in range(3):
        for i in range(rows):
            theta_step(np.asarray(cols[i]), vals[i], y[i])
            if it > 0:
                j = i % vrows
                lambda_step(np.asarray(vc[j]), vv[j], vy[j])

    learner.learn(train, train, validation=val)
    got = learner.params
    assert got.v.dtype == torch.float64 and learner.reg_v.dtype == torch.float64
    assert reg_v.max() > 0
    np.testing.assert_allclose(float(got.w0), w0, rtol=1e-6)
    np.testing.assert_allclose(got.w.numpy(), w, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.v.numpy(), V, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(learner.reg_w.numpy(), reg_w, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(learner.reg_v.numpy(), reg_v, rtol=1e-6, atol=1e-9)


# ---- w0 after an epoch of config #1's batches in f32 (ROADMAP §3)

# config #1 (bench.py:90-109): k=8, lr 0.003, B=32768, regression, on
# movielens_like(71567, 10681, .) data with W0_RATINGS ratings: 1,026,000
# train rows, 32 batches (config #1's epoch has 275; its full data is not
# for a CPU test)
W0_RATINGS = 1_140_000
W0_K, W0_LR, W0_B = 8, 0.003, 32768


def w0_after_one_epoch(ratings=W0_RATINGS, seed=1):
    """w0 after one epoch of config #1's batches from the same parameters
    (w0 = 0, w = 0, V ~ N(0, 0.1) drawn from seed - 1) on
    movielens_like(71567, 10681, ratings, seed):
    SGD (JAX make_epoch_fn, the port's plain epoch in f32 and float64)
    and SGDA's theta steps (JAX theta_step in a scan, the port's plain
    epoch without lambda steps, f32 and float64). Returns a dict."""
    (jtr, _), (ttr, _) = (jax_movielens_like(71567, 10681, ratings, seed=seed),
                          movielens_like(71567, 10681, ratings, seed=seed))
    n = jtr.num_features
    rng = np.random.default_rng(seed - 1)
    w0, w, V = (np.float32(0.0), np.zeros(n, np.float32),
                rng.normal(0, 0.1, (n, W0_K)).astype(np.float32))
    jb, tb = jax_batch_dataset(jtr, W0_B), batch_dataset(ttr, W0_B)
    lims = (float(jtr.min_target), float(jtr.max_target))
    out = dict(batches=int(tb.num_batches), rows=int(ttr.num_rows))

    # SGD (regv 0.01, as config #1)
    jcfg = JaxFMConfig(num_features=n, num_factors=W0_K, regv=0.01)
    sids, perm = jsgd.sorted_scatter_order(jb.ids)
    jp = jsgd.make_epoch_fn(jcfg, TASK_REGRESSION, "pair")(
        JaxFMParams(*(jnp.asarray(a) for a in (w0, w, V))),
        *(jnp.asarray(x) for x in (jb.ids, jb.vals, jb.y, jb.row_mask, sids, perm)),
        jnp.asarray((W0_LR,) * 3, jnp.float32), *lims)
    out["sgd_jax_f32"] = float(jp.w0)
    for dt, name in ((torch.float32, "sgd_port_f32"), (torch.float64, "sgd_port_f64")):
        cfg = FMConfig(num_features=n, num_factors=W0_K, regv=0.01, dtype=dt)
        tp = tsgd.make_epoch_fn(cfg, TASK_REGRESSION, "pair")(
            FMParams(*(torch.as_tensor(a).to(dt) for a in (w0, w, V))),
            *(torch.as_tensor(x) for x in (tb.ids, tb.vals, tb.y, tb.row_mask, sids, perm)),
            (W0_LR,) * 3, *lims)
        out[name] = float(tp.w0)

    # SGDA's theta steps, users and items as the groups, the regularizers 0
    groups = (np.arange(n) >= 71567).astype(np.int32)
    jl = jsgda.SGDALearner(JaxFMConfig(num_features=n, num_factors=W0_K),
                           attr_group=groups, verbose=False)
    theta, _ = jl._make_steps(jnp.float32(W0_LR), *lims)
    arrs = tuple(jnp.asarray(x) for x in (jb.ids, jb.vals, jb.y, jb.row_mask))

    @jax.jit
    def jax_epoch(params, grads, regs):
        def body(carry, batch):
            params, grads = carry
            return theta(params, grads, regs, batch), None

        return jax.lax.scan(body, (params, grads), arrs)[0][0]

    jp = jax_epoch(JaxFMParams(*(jnp.asarray(a) for a in (w0, w, V))),
                   (jnp.zeros(n + 1), jnp.zeros((n + 1, W0_K))),
                   (jnp.zeros(2), jnp.zeros((2, W0_K))))
    out["sgda_jax_f32"] = float(jp.w0)
    batches = None
    for dt, name in ((torch.float32, "sgda_port_f32"), (torch.float64, "sgda_port_f64")):
        cfg = FMConfig(num_features=n, num_factors=W0_K, dtype=dt)
        batches = batches or tsgda.sgda_batches(tb, n, "cpu")
        P = torch.cat([torch.as_tensor(w)[:, None], torch.as_tensor(V)], 1).to(dt)
        w0_t = torch.tensor(w0, dtype=dt)
        tsgda.make_epoch_fn(cfg, TASK_REGRESSION, "pair")(
            P, w0_t, torch.zeros(n + 1, W0_K + 1, dtype=dt), torch.zeros(2, dtype=dt),
            torch.zeros(2, W0_K, dtype=dt), torch.as_tensor(groups), batches,
            batches.arrays, W0_LR, *lims, do_lambda=False)
        out[name] = float(w0_t)
    return out


def test_w0_drift_at_config1_batches_is_no_larger_than_jax():
    """ROADMAP §3 "w0 at config #1 in f32", over 32 of config #1's batches
    at two seeds. SGDA's w0 line rounds w0 - lr sum once and SGD's rounds
    its two fused multiply-adds once each (`sgd_w0_update`), as XLA rounds
    JAX's lines on the CPU: both land on JAX's f32 w0 bit for bit."""
    for seed in (1, 3):
        r = w0_after_one_epoch(seed=seed)
        assert r["sgda_port_f32"] == r["sgda_jax_f32"], r
        assert r["sgd_port_f32"] == r["sgd_jax_f32"], r


def test_sgd_w0_update_rounds_as_jax():
    """`sgd_w0_update` against JAX's SGD w0 line on the CPU
    (libfm_tpu/learners/sgd.py:147, `w0 - lr0 * (sum + n * reg0 * w0)`),
    bit for bit. XLA contracts both the inner n reg0 w0 + sum and the outer
    w0 - lr0 g into fused multiply-adds: the values are drawn so that each
    of the three other roundings (op by op, one fma outside only, one fma
    inside only) misses JAX's value somewhere."""
    rng = np.random.default_rng(0)
    m, B, reg0 = 4000, 8, 0.37
    w0 = rng.normal(0, 3, m).astype(np.float32)
    mult = rng.normal(0, 1, (m, B)).astype(np.float32)
    mask = rng.random((m, B)) < 0.8
    lr = rng.uniform(0.001, 0.5, m).astype(np.float32)

    def line(w0, mult, mask, lr):
        n_real = mask.sum().astype(jnp.float32)
        return w0 - lr * (mult.sum() + n_real * reg0 * w0)

    want = np.asarray(jax.jit(jax.vmap(line))(w0, mult, mask, lr))
    s = np.array(jax.jit(jax.vmap(lambda a: a.sum()))(mult))
    n = mask.sum(1).astype(np.float32)
    got = np.asarray([float(tsgd_step.sgd_w0_update(torch.tensor(a), float(b), torch.tensor(c),
                                                    torch.tensor(d), reg0))
                      for a, b, c, d in zip(w0, lr, s, n)], np.float32)
    np.testing.assert_array_equal(got, want)
    t = [torch.as_tensor(a) for a in (w0, lr, s, n)]
    g_fl = t[2] + t[3] * reg0 * t[0]
    g_fma = fma_f32(t[3] * reg0, t[0], t[2])
    others = [t[0] - t[1] * g_fl, fma_f32(-t[1], g_fl, t[0]), t[0] - t[1] * g_fma]
    for other in others:
        assert (other.numpy() != want).any()


# ---- what this slice does not take


def test_out_of_slice_options_raise(monkeypatch, tmp_path):
    cfg = FMConfig(num_features=10, num_factors=2)
    # rlog output is in the slice since the CLI's port (tests/test_torch_cli.py)
    assert tsgda.SGDALearner(cfg, rlog=RLog(io.StringIO()), device="cpu").rlog is not None
    learner = tsgda.SGDALearner(cfg, device="cpu")
    # streaming data is in the slice since the out-of-core slice
    # (tests/test_torch_streaming.py); it needs a validation set too
    tr, te = movielens_like(4, 6, 50, seed=1)
    tr.to_binary(str(tmp_path / "s"), with_transpose=False)
    stream = StreamingDataset(str(tmp_path / "s.x"), str(tmp_path / "s.y"), entry_budget=16)
    with pytest.raises(ValueError, match="validation"):
        learner.learn_stream(stream, te)
    hist = tsgda.SGDALearner(cfg, num_iter=2, device="cpu").learn_stream(stream, te, stream)
    assert len(hist) == 2 and np.isnan(hist[0][0]) and np.isfinite(hist[-1][1:]).all()
    with pytest.raises(ValueError, match="validation"):
        learner.learn(tr, te)
    tr.relations = [object()]
    with pytest.raises(ValueError, match="relations"):
        learner.learn(tr, te, te)
    with pytest.raises(ValueError, match="attr_group"):
        tsgda.SGDALearner(cfg, attr_group=np.zeros(9), device="cpu")
    tr, te = movielens_like(4, 6, 50, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    wide = tsgda.SGDALearner(FMConfig(num_features=10, num_factors=129), device="cuda")
    with pytest.raises(NotImplementedError, match="k <= 128"):
        wide.learn(tr, te, te)


def sgda_config1_epochs(ratings, seed=1, epochs=3):
    """SGDA at config #1's settings (k=8, lr 0.003, B=32768, regression,
    users and items as the groups, a seeded ninth of the train rows as the
    validation set) on movielens_like(71567, 10681, ratings, seed), from
    the same parameters (w0 = 0, w = 0, V ~ N(0, 0.1)): the history
    (train, test, validation) and the final w0 of JAX's SGDALearner in
    f32 and of the port's plain path in f32 and float64. Returns a dict."""
    (jtr, jte), (ttr, tte) = (jax_movielens_like(71567, 10681, ratings, seed=seed),
                              movielens_like(71567, 10681, ratings, seed=seed))
    (jtr, jval), (ttr, tval) = _jax_holdout(jtr, 7), ttr.holdout(7)
    n = jtr.num_features
    groups = (np.arange(n) >= 71567).astype(np.int32)
    rng = np.random.default_rng(seed - 1)
    init = (np.float32(0.0), np.zeros(n, np.float32),
            rng.normal(0, 0.1, (n, W0_K)).astype(np.float32))
    kw = dict(attr_group=groups, task=TASK_REGRESSION, num_iter=epochs,
              learn_rate=W0_LR, batch_size=W0_B, seed=1, verbose=False)
    out = dict(batches=int(batch_dataset(ttr, W0_B).num_batches), rows=int(ttr.num_rows))
    jl = jsgda.SGDALearner(JaxFMConfig(num_features=n, num_factors=W0_K), **kw)
    jl.init_params(JaxFMParams(*(jnp.asarray(a) for a in init)))
    jl.learn(jtr, jte, validation=jval)
    out["jax_f32"] = dict(history=[h[:3] for h in jl.history], w0=float(jl.params.w0))
    for dt, name in ((torch.float32, "port_f32"), (torch.float64, "port_f64")):
        tl = tsgda.SGDALearner(FMConfig(num_features=n, num_factors=W0_K, dtype=dt),
                               device="cpu", **kw)
        tl.init_params(FMParams(*(torch.as_tensor(a).to(dt) for a in init)))
        tl.learn(ttr, tte, validation=tval)
        out[name] = dict(history=[tuple(h[:3]) for h in tl.history],
                         w0=float(tl.params.w0))
    return out


if __name__ == "__main__":
    # the w0 values and SGDA trajectories of ROADMAP §3, one JSON line per run:
    #   PYTHONPATH=. python tests/test_torch_sgda.py w0 RATINGS SEED...
    #   PYTHONPATH=. python tests/test_torch_sgda.py epochs RATINGS SEED...
    import json
    import sys

    import conftest  # noqa: F401  (JAX on the CPU)

    study = {"w0": w0_after_one_epoch, "epochs": sgda_config1_epochs}[sys.argv[1]]
    for s in sys.argv[3:] or ["1"]:
        r = study(int(sys.argv[2]), int(s))
        print(json.dumps(dict(study=sys.argv[1], ratings=int(sys.argv[2]), seed=int(s), **r)),
              flush=True)
