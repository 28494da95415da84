"""Port vs JAX: the FM forward (`models.fm.fm_batch_terms`) and the
refresh kernel's plain version (`kernels.fm_refresh`), on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance 1e-5 (rtol and atol): the same f32 sums over L <= 5 entries,
taken in a possibly different order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.models import fm as jfm
from libfm_tpu_torch.kernels import fm_refresh as kfr
from libfm_tpu_torch.models import fm as tfm


def _batch(seed, n=50, k=6, B=40, L=5):
    rng = np.random.default_rng(seed)
    w0 = np.float32(rng.normal())
    w = rng.normal(0, 0.3, n).astype(np.float32)
    V = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    ids = rng.integers(0, n, (B, L)).astype(np.int32)
    vals = rng.normal(1.0, 0.5, (B, L)).astype(np.float32)
    vals[:, L - 2:] *= rng.random((B, 2)) < 0.5  # padding entries (value 0)
    y = rng.uniform(1, 5, B).astype(np.float32)
    return w0, w, V, ids, vals, y


@pytest.mark.parametrize("use_linear,use_bias", [(True, True), (False, True), (True, False)])
def test_fm_batch_terms_matches_jax(use_linear, use_bias):
    w0, w, V, ids, vals, _ = _batch(1)
    n, k = V.shape
    jcfg = jfm.FMConfig(num_features=n, num_factors=k, use_linear=use_linear,
                        use_bias=use_bias)
    tcfg = tfm.FMConfig(num_features=n, num_factors=k, use_linear=use_linear,
                        use_bias=use_bias)
    jp, jq = jfm.fm_batch_terms(
        jfm.FMParams(jnp.asarray(w0), jnp.asarray(w), jnp.asarray(V)),
        jnp.asarray(ids), jnp.asarray(vals), jcfg,
    )
    tp, tq = tfm.fm_batch_terms(
        tfm.FMParams(torch.tensor(w0), torch.tensor(w), torch.tensor(V)),
        torch.tensor(ids), torch.tensor(vals), tcfg,
    )
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tfm.fm_batch_predict(
            tfm.FMParams(torch.tensor(w0), torch.tensor(w), torch.tensor(V)),
            torch.tensor(ids), torch.tensor(vals), tcfg,
        ).numpy(),
        np.asarray(jp), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("seed", [2, 3])
def test_refresh_plain_matches_jax_forward(seed):
    """Train mode writes A = [pred - y | Q] and returns the clipped SSE;
    test mode returns pred — both against JAX's fm_batch_terms."""
    w0, w, V, ids, vals, y = _batch(seed)
    n, k = V.shape
    jp, jq = jfm.fm_batch_terms(
        jfm.FMParams(jnp.asarray(w0), jnp.asarray(w), jnp.asarray(V)),
        jnp.asarray(ids), jnp.asarray(vals), jfm.FMConfig(num_features=n, num_factors=k),
    )
    jp, jq = np.asarray(jp), np.asarray(jq)
    P = torch.tensor(np.concatenate([w[:, None], V], axis=1))
    A = torch.full((len(y), k + 1), np.nan)
    sse = kfr.fm_refresh(P, torch.tensor(ids), torch.tensor(vals), torch.tensor(w0),
                         torch.tensor(y), A, min_target=1.5, max_target=4.5)
    np.testing.assert_allclose(A[:, 0].numpy(), jp - y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(A[:, 1:].numpy(), jq, rtol=1e-5, atol=1e-5)
    ref_sse = float(((np.clip(jp, 1.5, 4.5) - y) ** 2).sum())
    assert abs(float(sse) - ref_sse) <= 1e-5 * max(1.0, ref_sse)
    pred = kfr.fm_refresh(P, torch.tensor(ids), torch.tensor(vals), torch.tensor(w0))
    np.testing.assert_allclose(pred.numpy(), jp, rtol=1e-5, atol=1e-5)


def test_init_fm_shapes_and_scale():
    cfg = tfm.FMConfig(num_features=4000, num_factors=8, init_stdev=0.1)
    g = torch.Generator().manual_seed(0)
    p = tfm.init_fm(cfg, g, mcmc_style_w=True)
    assert p.v.shape == (4000, 8) and p.w.shape == (4000,) and p.w0.shape == ()
    assert abs(float(p.v.std()) - 0.1) < 0.005
    assert abs(float(p.w.std()) - 0.1) < 0.01
    q = tfm.init_fm(cfg, torch.Generator().manual_seed(0))
    assert float(q.w.abs().max()) == 0.0


# ---- libFM's text model format (-save_model / -load_model) and
# predict_dense, against the JAX package's


def _params(seed, n, k):
    rng = np.random.default_rng(seed)
    w0 = np.float32(rng.normal())
    w = rng.normal(0, 0.3, n).astype(np.float32)
    V = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    V[0, 0], w[1] = -0.0, 1e-30  # formatted as -0 and 1e-30
    return w0, w, V


def _both(w0, w, V):
    jp = jfm.FMParams(w0=jnp.asarray(w0), w=jnp.asarray(w), v=jnp.asarray(V))
    tp = tfm.FMParams(w0=torch.tensor(w0), w=torch.tensor(w), v=torch.tensor(V))
    return jp, tp


@pytest.mark.parametrize("use_bias,use_linear,k", [(True, True, 4), (True, False, 3),
                                                   (False, True, 1), (False, False, 5)])
def test_model_text_matches_jax(use_bias, use_linear, k, tmp_path):
    n = 23
    w0, w, V = _params(k, n, k)
    jp, tp = _both(w0, w, V)
    jcfg = jfm.FMConfig(num_features=n, num_factors=k, use_bias=use_bias, use_linear=use_linear)
    tcfg = tfm.FMConfig(num_features=n, num_factors=k, use_bias=use_bias, use_linear=use_linear)
    jfm.save_model_text(jp, jcfg, str(tmp_path / "j.txt"))
    tfm.save_model_text(tp, tcfg, str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    got = tfm.load_model_text(tcfg, str(tmp_path / "j.txt"))
    want = jfm.load_model_text(jcfg, str(tmp_path / "j.txt"))
    for key in ("w0", "w", "v"):
        g, wv = getattr(got, key), np.asarray(getattr(want, key))
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), wv)
    # the round trip: 6 significant digits
    np.testing.assert_allclose(got.v.numpy(), V, rtol=5e-6, atol=0)


MALFORMED = {
    "missing_file": None,
    "short_v_section": lambda t: t.rsplit("\n", 3)[0] + "\n",
    "one_factor_too_many": lambda t: t[: t.rindex("\n", 0, -1)] + "\n1 2 3 4 5\n",
    "double_space": lambda t: t[: t.rindex("\n", 0, -1)] + "\n1  2 3 4\n",
    "not_a_number": lambda t: t.replace("#unary interactions Wj\n", "#unary interactions Wj\nx\n", 1),
    "empty": lambda t: "",
}


@pytest.mark.parametrize("fault", MALFORMED)
def test_malformed_model_text_gives_none_as_jax(fault, tmp_path):
    n, k = 7, 4
    jp, tp = _both(*_params(1, n, k))
    jcfg = jfm.FMConfig(num_features=n, num_factors=k)
    tcfg = tfm.FMConfig(num_features=n, num_factors=k)
    p = tmp_path / "m.txt"
    if MALFORMED[fault] is not None:
        tfm.save_model_text(tp, tcfg, str(p))
        p.write_text(MALFORMED[fault](p.read_text()))
    assert jfm.load_model_text(jcfg, str(p)) is None
    assert tfm.load_model_text(tcfg, str(p)) is None


@pytest.mark.parametrize("use_linear,use_bias", [(True, True), (False, False)])
def test_predict_dense_matches_jax(use_linear, use_bias):
    n, k = 30, 5
    jp, tp = _both(*_params(2, n, k))
    X = np.random.default_rng(3).normal(size=(11, n)).astype(np.float32)
    X[X < 0.5] = 0.0
    jcfg = jfm.FMConfig(num_features=n, num_factors=k, use_bias=use_bias, use_linear=use_linear)
    tcfg = tfm.FMConfig(num_features=n, num_factors=k, use_bias=use_bias, use_linear=use_linear)
    want = np.asarray(jfm.predict_dense(jp, jnp.asarray(X), jcfg))
    got = tfm.predict_dense(tp, torch.tensor(X), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- the rlog (utils/rlog.py) and the learners' columns, against the JAX
# learners' (built, not run)


def test_rlog_rows_match_jax():
    import io
    import math

    from libfm_tpu.utils.rlog import RLog as JaxRLog
    from libfm_tpu_torch.utils.rlog import RLog

    outs = []
    for cls in (RLog, JaxRLog):
        buf = io.StringIO()
        r = cls(buf)
        r.add_field("a")
        r.add_field("b", 2.5)
        with pytest.raises(ValueError, match="already exists"):
            r.add_field("a")
        r.init()
        r.log("a", 1.0 / 3.0)
        r.new_line()
        r.log("b", math.nan)
        r.log("a", "text")
        r.new_line()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == "a\tb\n0.333333\t2.5\ntext\tnan\n"


def _headers(task, groups, k=3):
    """The rlog header of each learner, port and JAX, for one task."""
    import io

    from libfm_tpu.learners.mcmc import MCMCLearner as JaxExact
    from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxVector
    from libfm_tpu.learners.sgd import SGDLearner as JaxSGD
    from libfm_tpu.learners.sgda import SGDALearner as JaxSGDA
    from libfm_tpu.utils.rlog import RLog as JaxRLog
    from libfm_tpu_torch.learners.mcmc import MCMCLearner
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
    from libfm_tpu_torch.learners.sgd import SGDLearner
    from libfm_tpu_torch.learners.sgda import SGDALearner
    from libfm_tpu_torch.utils.rlog import RLog

    n = len(groups)
    out = {}
    for name, (tcls, jcls) in dict(mcmc=(MCMCVectorLearner, JaxVector),
                                   exact=(MCMCLearner, JaxExact),
                                   sgd=(SGDLearner, JaxSGD),
                                   sgda=(SGDALearner, JaxSGDA)).items():
        heads = []
        for cls, cfg, rlog, kw in (
            (tcls, tfm.FMConfig(num_features=n, num_factors=k), RLog(io.StringIO()),
             dict(device="cpu")),
            (jcls, jfm.FMConfig(num_features=n, num_factors=k), JaxRLog(io.StringIO()), {}),
        ):
            kw = dict(kw, task=task, rlog=rlog)
            if name != "sgd":
                kw["attr_group"] = groups
            learner = cls(cfg, **kw)
            if name in ("mcmc", "exact"):
                learner.register_log_fields()
            rlog.init()
            heads.append(rlog._out.getvalue())
        out[name] = heads
    return out


@pytest.mark.parametrize("task", [0, 1])
def test_rlog_headers_match_jax_learners(task):
    groups = np.array([0, 1, 1, 0, 1], np.int32)  # G = 2
    heads = _headers(task, groups)
    for name, (got, want) in heads.items():
        assert got == want, name
    assert "vmu[1,2]" in heads["mcmc"][0] and "rmse_val" in heads["sgda"][0]
