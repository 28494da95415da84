"""The port's mini-batch SGD learner against the JAX learner, on the CPU
(the kernels' plain versions), at the ml_small / ctr_small sizes of
tests/test_learners.py.

- the host scatter order is equal;
- `sgd_batch_update` and one packed epoch (`make_epoch_fn`, modes
  "pair", "onehot" and "general") from the same parameters agree within
  atol 1e-5 on w0, w and V: f32 sums taken in another order;
- the step's w0 line in place (`lr0`) follows the JAX epoch's w0 over one
  batch within 1e-6, and the sorted-order update rows (`order`) with the
  scatter's `perm=None` give the perm form's table bitwise;
- `SGDLearner.learn` over 3 epochs: the train/test RMSE within 1e-5,
  the accuracy within one test row; `predict` within 1e-6;
- the port's plain path in float64 at batch_size=1 follows the numpy
  transcription of libFM's sequential fm_SGD (tests/test_oracle_b1.py)
  within rtol 1e-6;
- the shared metrics and the prediction link of `learners/base.py`
  within rtol 1e-6.
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
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.models.fm import FMParams as JaxFMParams
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.batching import batch_dataset
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.streaming import StreamingDataset
from libfm_tpu_torch.data.synth import ctr_like, movielens_like
from libfm_tpu_torch.learners import sgd as tsgd
from libfm_tpu_torch.models.fm import FMConfig, FMParams
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION, TASK_REGRESSION
from libfm_tpu_torch.utils.rlog import RLog

K = 4
ATOL = 1e-5


def _data(which):
    """(jax train, port train, jax test, port test, task): ml_small and
    ctr_small (tests/test_learners.py:20-27); "valued" variants draw the
    entries' values from N(1, 0.25) with one seed for both packages."""
    base = which.split("_")[0]
    if base == "ml":
        (jtr, jte), (ttr, tte) = (jax_movielens_like(120, 90, 8000, seed=3),
                                  movielens_like(120, 90, 8000, seed=3))
        task = TASK_REGRESSION
    else:
        (jtr, jte, _), (ttr, tte, _) = (jax_ctr_like(5, 50, 6000, seed=4),
                                        ctr_like(5, 50, 6000, seed=4))
        task = TASK_CLASSIFICATION
    if which.endswith("valued"):
        rng = np.random.default_rng(7)
        for j, t in ((jtr, ttr), (jte, tte)):
            v = rng.normal(1.0, 0.25, j.vals.shape).astype(np.float32)
            j.vals, t.vals = v.copy(), v.copy()
    return jtr, ttr, jte, tte, task


def _params(n, k, seed=0):
    """JAX-shaped (w0, w, V) with a nonzero w, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (np.float32(0.3), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))


def _jax_params(w0, w, V):
    return JaxFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w), v=jnp.asarray(V))


def _torch_params(w0, w, V):
    return FMParams(*params_from_jax(w0, w, V, device="cpu"))


def _close(jp, tp, atol=ATOL):
    np.testing.assert_allclose(float(tp.w0), float(jp.w0), rtol=0, atol=atol)
    np.testing.assert_allclose(tp.w.numpy(), np.asarray(jp.w), rtol=0, atol=atol)
    np.testing.assert_allclose(tp.v.numpy(), np.asarray(jp.v), rtol=0, atol=atol)


@pytest.mark.parametrize("which", ["ml", "ctr"])
def test_sorted_scatter_order_matches_jax(which):
    jtr, ttr, *_ = _data(which)
    jb, tb = jax_batch_dataset(jtr, 100), batch_dataset(ttr, 100)
    for a, b in zip(jsgd.sorted_scatter_order(jb.ids), tsgd.sorted_scatter_order(tb.ids)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["ml", "ctr", "ctr_valued"])
def test_sgd_batch_update_matches_jax(which):
    jtr, ttr, _, _, task = _data(which)
    n = jtr.num_features
    jb, tb = jax_batch_dataset(jtr, 256), batch_dataset(ttr, 256)
    kw = dict(num_features=n, num_factors=K, reg0=0.02, regw=0.05, regv=0.03)
    init = _params(n, K)
    jp, tp = _jax_params(*init), _torch_params(*init)
    lims = (float(jtr.min_target), float(jtr.max_target))
    for b in (0, 1, jb.num_batches - 1):  # the last batch is padded
        jp = jsgd.sgd_batch_update(
            jp, jnp.asarray(jb.ids[b]), jnp.asarray(jb.vals[b]), jnp.asarray(jb.y[b]),
            jnp.asarray(jb.row_mask[b]), JaxFMConfig(**kw), 0.01, 0.02, 0.03, task, *lims)
        tp = tsgd.sgd_batch_update(
            tp, *(torch.as_tensor(x[b]) for x in (tb.ids, tb.vals, tb.y, tb.row_mask)),
            FMConfig(**kw), 0.01, 0.02, 0.03, task, *lims)
    _close(jp, tp)


EPOCH_CASES = [  # (data, mode, use_linear, use_bias)
    ("ml", "pair", True, True),
    ("ctr", "onehot", True, True),
    ("ctr_valued", "general", True, True),
    ("ml_valued", "general", True, True),
    ("ml", "pair", False, False),
    ("ctr", "onehot", False, True),
    ("ctr_valued", "general", True, False),
]


@pytest.mark.parametrize("which,mode,use_linear,use_bias", EPOCH_CASES)
def test_epoch_matches_jax(which, mode, use_linear, use_bias):
    """One packed epoch of 128-row batches (the last one padded) from the
    same parameters, in the mode the learner would pick."""
    jtr, ttr, _, _, task = _data(which)
    n = jtr.num_features
    jb, tb = jax_batch_dataset(jtr, 128), batch_dataset(ttr, 128)
    assert jsgd._epoch_mode(jtr, jb) == tsgd._epoch_mode(ttr, tb.ids.shape[2]) == mode
    kw = dict(num_features=n, num_factors=K, reg0=0.02, regw=0.05, regv=0.03,
              use_linear=use_linear, use_bias=use_bias)
    init = _params(n, K, seed=1)
    lrs = (0.01, 0.02, 0.03)
    lims = (float(jtr.min_target), float(jtr.max_target))
    sids, perm = jsgd.sorted_scatter_order(jb.ids)
    jp = jsgd.make_epoch_fn(JaxFMConfig(**kw), task, mode)(
        _jax_params(*init), *(jnp.asarray(x) for x in (jb.ids, jb.vals, jb.y,
                                                      jb.row_mask, sids, perm)),
        jnp.asarray(lrs, jnp.float32), *lims)
    ts, tperm = tsgd.sorted_scatter_order(tb.ids)
    tp = tsgd.make_epoch_fn(FMConfig(**kw), task, mode)(
        _torch_params(*init), *(torch.as_tensor(x) for x in (tb.ids, tb.vals, tb.y,
                                                            tb.row_mask, ts, tperm)),
        lrs, *lims)
    _close(jp, tp)
    assert float(tp.w0) != init[0] or not use_bias


STEP_CASES = [("ml", "pair"), ("ctr", "onehot"), ("ctr_valued", "general")]


def _one_batch(which, B=128):
    """JAX and port batch stacks of `which` cut to their first batch, with
    its scatter order, and the FMConfig keywords of the epoch tests."""
    jtr, ttr, _, _, task = _data(which)
    jb, tb = jax_batch_dataset(jtr, B), batch_dataset(ttr, B)
    stack = [x[:1] for x in (tb.ids, tb.vals, tb.y, tb.row_mask)]
    sids, perm = tsgd.sorted_scatter_order(stack[0])
    kw = dict(num_features=jtr.num_features, num_factors=K, reg0=0.02, regw=0.05,
              regv=0.03)
    lims = (float(jtr.min_target), float(jtr.max_target))
    return stack, sids, perm, kw, task, lims


@pytest.mark.parametrize("which,mode", STEP_CASES)
def test_sgd_step_plain_w0_in_place_matches_jax(which, mode):
    """sgd_step_plain given lr0/reg0 updates w0 in place as the JAX
    epoch's w0 line does over one batch (atol 1e-6), through
    `sgd_w0_update` on its sums."""
    stack, sids, perm, kw, task, lims = _one_batch(which)
    init = _params(kw["num_features"], K, seed=4)
    lrs = (0.01, 0.02, 0.03)
    jp = jsgd.make_epoch_fn(JaxFMConfig(**kw), task, mode)(
        _jax_params(*init), *(jnp.asarray(x) for x in (*stack, sids, perm)),
        jnp.asarray(lrs, jnp.float32), *lims)
    tp = _torch_params(*init)
    P = tsgd._packed(tp)
    w0 = tp.w0.clone()
    ids, vals, y, mask = (torch.as_tensor(x[0]) for x in stack)
    upd, red = tsgd.sgd_step(P, ids, vals, y, mask, w0, mode=mode, task=task,
                             lr1=lrs[1], lr2=lrs[2], regw=kw["regw"], regv=kw["regv"],
                             min_target=lims[0], max_target=lims[1], lr0=lrs[0],
                             reg0=kw["reg0"])
    assert float(w0) != init[0]
    np.testing.assert_allclose(float(w0), float(jp.w0), rtol=0, atol=1e-6)
    assert torch.equal(w0, tsgd.sgd_w0_update(tp.w0, lrs[0], red[0], red[1], kw["reg0"]))


@pytest.mark.parametrize("which,mode", STEP_CASES)
def test_sorted_order_rows_match_the_perm_form(which, mode):
    """`order` puts each entry's update row at its sorted position (rows
    equal to upd[perm], bitwise), and table_scatter_plain with perm=None on
    those rows gives the perm form's table bitwise; buffers passed in are
    filled and returned."""
    from libfm_tpu_torch.kernels import table_scatter as ts

    stack, sids, perm, kw, task, lims = _one_batch(which)
    tp = _torch_params(*_params(kw["num_features"], K, seed=5))
    P = tsgd._packed(tp)
    ids, vals, y, mask = (torch.as_tensor(x[0]) for x in stack)
    sids_t, perm_t = torch.as_tensor(sids[0]), torch.as_tensor(perm[0])
    order = torch.empty_like(perm_t).scatter_(
        0, perm_t.long(), torch.arange(perm_t.numel(), dtype=perm_t.dtype))
    step = dict(mode=mode, task=task, lr1=0.02, lr2=0.03, regw=kw["regw"],
                regv=kw["regv"], min_target=lims[0], max_target=lims[1])
    upd, red = tsgd.sgd_step(P, ids, vals, y, mask, tp.w0, **step)
    buf, red_buf = torch.empty_like(upd), torch.empty(2)
    got, got_red = tsgd.sgd_step(P, ids, vals, y, mask, tp.w0, order=order.reshape(ids.shape),
                                 upd=buf, red=red_buf, **step)
    assert got is buf and got_red is red_buf
    assert torch.equal(got, upd[perm_t.long()]) and torch.equal(got_red, red)
    T1 = ts.table_scatter_plain(P.clone(), sids_t, perm_t, upd)
    T2 = ts.table_scatter(P.clone(), sids_t, None, got)
    assert torch.equal(T1, T2)


@pytest.fixture(scope="module", params=["regression", "classification"])
def learner_pair(request):
    """JAX and port SGDLearner, 3 epochs on the shuffled small data, from
    the same initial parameters."""
    which = "ml" if request.param == "regression" else "ctr"
    jtr, ttr, jte, tte, task = _data(which)
    n = jtr.num_features
    lr = 0.02 if which == "ml" else 0.005
    init = (np.float32(0.0), np.zeros(n, np.float32),
            np.random.default_rng(2).normal(0, 0.1, (n, 8)).astype(np.float32))
    jl = jsgd.SGDLearner(JaxFMConfig(num_features=n, num_factors=8, regv=0.01),
                         task=task, num_iter=3, learn_rate=lr, batch_size=64,
                         seed=1, verbose=False)
    jl.init_params(_jax_params(*init))
    jl.learn(jtr.shuffled(0), jte)
    tl = tsgd.SGDLearner(FMConfig(num_features=n, num_factors=8, regv=0.01),
                         task=task, num_iter=3, learn_rate=lr, batch_size=64,
                         seed=1, verbose=False, device="cpu")
    tl.init_params(_torch_params(*init))
    tl.learn(ttr.shuffled(0), tte)
    return jl, tl, jte, tte, task


def test_learn_history_matches_jax(learner_pair):
    jl, tl, jte, _, task = learner_pair
    assert len(jl.history) == len(tl.history) == 3
    for (jtr_m, jte_m, _), (ttr_m, tte_m, secs) in zip(jl.history, tl.history):
        tol = 1e-5 if task == TASK_REGRESSION else 1.0 / jte.num_rows + 1e-9
        assert abs(jtr_m - ttr_m) <= tol
        assert abs(jte_m - tte_m) <= tol
        assert secs > 0
    if task == TASK_REGRESSION:
        assert tl.history[-1][1] < tl.history[0][1]


def test_predict_and_evaluate_match_jax(learner_pair):
    jl, tl, jte, tte, task = learner_pair
    jp, tp = np.asarray(jl.predict(jte)), tl.predict(tte)
    assert tp.shape == (tte.num_rows,)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    if task == TASK_CLASSIFICATION:
        assert ((tp >= 0) & (tp <= 1)).all()
    assert abs(tl.evaluate(tte) - tl.history[-1][1]) < 1e-6
    assert abs(jl.evaluate(jte) - tl.evaluate(tte)) <= 1e-5 + (
        task == TASK_CLASSIFICATION) / jte.num_rows


def _oracle_rows(num_rows, num_features, seed, max_len=4):
    """tests/test_oracle_b1.py _rows: rows of 1-4 valued entries."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, num_rows)
    cols = [np.sort(rng.choice(num_features, ln, replace=False)) for ln in lens]
    vals = [rng.standard_normal(ln) for ln in lens]
    beta = rng.standard_normal(num_features) * 0.5
    y = np.array([float((v * beta[c]).sum()) + 2.0 for c, v in zip(cols, vals)])
    return cols, vals, y


def test_plain_path_f64_matches_b1_oracle():
    """SGDLearner at batch_size=1 in float64 == libFM's sequential per-row
    fm_SGD, parameter for parameter (tests/test_oracle_b1.py:63-111)."""
    n, k, rows, lr = 30, 4, 100, 0.01
    cols, vals, y = _oracle_rows(rows, n, seed=3)
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])]).astype(np.int64)
    train = Dataset(indptr, np.concatenate(cols).astype(np.int32),
                    np.concatenate(vals).astype(np.float32), np.asarray(y, np.float32), n)
    y = np.asarray(train.target, np.float64)
    cfg = FMConfig(num_features=n, num_factors=k, reg0=0.1, regw=0.05, regv=0.01,
                   dtype=torch.float64)
    rng = np.random.default_rng(11)
    w0, w, V = 0.2, rng.normal(0, 0.1, n), rng.normal(0, 0.1, (n, k))
    learner = tsgd.SGDLearner(cfg, num_iter=2, learn_rate=lr, batch_size=1,
                              verbose=False, device="cpu")
    learner.init_params(FMParams(torch.tensor(w0, dtype=torch.float64),
                                 torch.tensor(w), torch.tensor(V)))
    min_t, max_t = float(train.min_target), float(train.max_target)
    for _ in range(2):
        for ci, vi, yi in zip(cols, vals, y):
            vi = np.asarray(np.asarray(vi, np.float32), np.float64)
            d = V[ci] * vi[:, None]
            s = d.sum(axis=0)
            p = w0 + (w[ci] * vi).sum() + 0.5 * ((s * s).sum() - (d * d).sum())
            mult = min(max(p, min_t), max_t) - yi
            w0 -= lr * (mult + cfg.reg0 * w0)
            w[ci] -= lr * (mult * vi + cfg.regw * w[ci])
            grad = s[None, :] * vi[:, None] - V[ci] * (vi * vi)[:, None]
            V[ci] -= lr * (mult * grad + cfg.regv * V[ci])
    learner.learn(train, train)
    got = learner.params
    assert got.v.dtype == torch.float64
    np.testing.assert_allclose(float(got.w0), w0, rtol=1e-6)
    np.testing.assert_allclose(got.w.numpy(), w, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.v.numpy(), V, rtol=1e-6, atol=1e-9)


def test_out_of_slice_options_raise(tmp_path):
    cfg = FMConfig(num_features=10, num_factors=2)
    # rlog output is in the slice since the CLI's port (tests/test_torch_cli.py)
    assert tsgd.SGDLearner(cfg, rlog=RLog(io.StringIO()), device="cpu").rlog is not None
    learner = tsgd.SGDLearner(cfg, device="cpu")
    # streaming data is in the slice since the out-of-core slice
    # (tests/test_torch_streaming.py): rows cut at max_nnz are counted and
    # warned of, the lossless default cuts none
    tr, te = movielens_like(4, 6, 50, seed=1)
    tr.to_binary(str(tmp_path / "s"), with_transpose=False)
    stream = StreamingDataset(str(tmp_path / "s.x"), str(tmp_path / "s.y"), entry_budget=16)
    with pytest.warns(UserWarning, match=f"truncated {tr.num_rows} rows"):
        assert len(learner.learn_stream(stream, te, max_nnz=1)) == learner.num_iter
    assert (stream.truncated_rows, stream.truncated_entries) == (tr.num_rows, tr.nnz - tr.num_rows)
    tsgd.SGDLearner(cfg, num_iter=1, device="cpu").learn_stream(stream, te)
    assert stream.truncated_rows == 0
    tr.relations = [object()]
    with pytest.raises(ValueError, match="relations"):
        learner.learn(tr, te)


def test_learner_default_init_and_packed_table():
    """The learner's own draw (w = 0, V ~ N(0, 0.1)) and convert's packed
    table, which the SGD step takes."""
    from libfm_tpu_torch.convert import packed_from_jax

    cfg = FMConfig(num_features=500, num_factors=6)
    p = tsgd.SGDLearner(cfg, seed=3, device="cpu").init_params()
    assert float(p.w.abs().max()) == 0.0 and abs(float(p.v.std()) - 0.1) < 0.01
    w0, P = packed_from_jax(np.float32(1.0), np.arange(3.0), np.ones((3, 2)), device="cpu")
    assert P.shape == (3, 3) and P.is_contiguous()
    np.testing.assert_array_equal(P[:, 0].numpy(), [0.0, 1.0, 2.0])
    assert float(w0) == 1.0


@pytest.mark.parametrize("name", ["rmse_mae", "sign_accuracy", "prob_accuracy",
                                  "neg_log10_likelihood", "link_regression",
                                  "link_classification"])
@pytest.mark.parametrize("masked", [False, True])
def test_base_metrics_match_jax(name, masked):
    from libfm_tpu.learners import base as jbase
    from libfm_tpu_torch.learners import base as tbase

    rng = np.random.default_rng(3)
    score = rng.normal(0, 2, 500).astype(np.float32)
    target = rng.choice([-1.0, 1.0], 500).astype(np.float32)
    mask = (rng.random(500) < 0.7) if masked else None
    p = (1 / (1 + np.exp(-score))).astype(np.float32)
    args = {
        "rmse_mae": (score, 3 + target, 1.0, 5.0),
        "sign_accuracy": (score, target),
        "prob_accuracy": (p, target),
        "neg_log10_likelihood": (p, target),
        "link_regression": (score, 0, 1.0, 2.0),
        "link_classification": (score, 1, 1.0, 2.0),
    }[name]
    fn = "link_prediction" if name.startswith("link") else name
    kw = {} if name.startswith("link") else {"mask": mask}
    want = getattr(jbase, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                for a in args),
                              **{k: (None if v is None else jnp.asarray(v))
                                 for k, v in kw.items()})
    got = getattr(tbase, fn)(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                               for a in args),
                             **{k: (None if v is None else torch.as_tensor(v))
                                for k, v in kw.items()})
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_required_features_and_check_match_jax():
    from libfm_tpu.learners import base as jbase
    from libfm_tpu_torch.learners import base as tbase

    tr, te = movielens_like(5, 7, 40, seed=2)
    assert tbase.required_features(tr) == jbase.required_features(tr) == 12
    with pytest.raises(ValueError, match="num_features"):
        tbase.check_num_features(FMConfig(num_features=11), tr, te)
    tbase.check_num_features(FMConfig(num_features=12), tr, None)
