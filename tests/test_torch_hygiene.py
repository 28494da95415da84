"""Port hygiene, on the CPU:

- no file of libfm_tpu_torch/, nor chip_smoke.py, imports jax, jaxlib,
  any module of the JAX package or the JAX studies;
- entry points default to CUDA and raise when it is absent (never a
  silent CPU fall-back);
- a kernel wrapper given CPU tensors runs its plain version and leaves
  its launch counter unchanged; importing the kernels builds nothing;
- chip_smoke.py without a CUDA device fails and prints no result.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libfm_tpu_torch
from libfm_tpu_torch import kernels
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.device import resolve_device
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner
from libfm_tpu_torch.learners.sgd import SGDLearner
from libfm_tpu_torch.models.fm import FMConfig

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "libfm_tpu_torch"
PORT_FILES = sorted(
    p for p in PORT.rglob("*.py") if "build" not in p.relative_to(PORT).parts
) + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "libfm_tpu", "studies"), (
            f"{path}: imports {mod}")


def test_port_file_list_is_complete():
    names = {p.name for p in PORT_FILES}
    assert {"mcmc_vector.py", "fm_refresh.py", "slot_stats.py", "schur_draw.py",
            "dense_update.py", "sgd.py", "sgd_step.py", "table_scatter.py",
            "table_read.py", "pallas_gather.py", "pallas_scatter.py",
            "case_stats.py", "probit_latent.py", "dual_draw.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("args", [[], ["--config3-kernels"], ["--config5-kernels"]])
def test_chip_smoke_without_cuda_fails_and_prints_no_result(args):
    """Without a CUDA device chip_smoke.py exits non-zero before it
    builds or runs anything, and prints nothing on its standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *args],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert run.returncode != 0
    assert run.stdout == ""
    assert "no CUDA device" in run.stderr


def test_tf32_is_off_at_import():
    assert libfm_tpu_torch.__name__ == "libfm_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    cfg = FMConfig(num_features=10, num_factors=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        MCMCVectorLearner(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ALSVectorLearner(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        SGDLearner(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SGDLearner(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(0.0, np.zeros(3), np.zeros((3, 2)))
    assert resolve_device("cpu") == torch.device("cpu")


def test_importing_kernels_builds_nothing():
    assert kernels._lib is None
    reg = kernels.import_all()
    assert set(reg) == {"fm_refresh", "fm_refresh_probit", "slot_stats", "case_stats",
                        "schur_draw", "dual_draw", "dense_update", "probit_latent",
                        "sgd_step", "table_scatter", "table_read"}
    assert kernels._lib is None
    assert sorted(p.name for p in kernels.CSRC_DIR.glob("*.cu")) == [
        "case_stats.cu", "dense_update.cu", "dual_draw.cu", "fm_refresh.cu",
        "probit_latent.cu", "schur_draw.cu", "sgd_step.cu", "slot_stats.cu",
        "table_read.cu", "table_scatter.cu"]


def _cpu_calls():
    from libfm_tpu_torch.kernels import case_stats as cs
    from libfm_tpu_torch.kernels import dense_update as du
    from libfm_tpu_torch.kernels import dual_draw as dd
    from libfm_tpu_torch.kernels import fm_refresh as fr
    from libfm_tpu_torch.kernels import probit_latent as pl
    from libfm_tpu_torch.kernels import schur_draw as sd
    from libfm_tpu_torch.kernels import sgd_step as sg
    from libfm_tpu_torch.kernels import slot_stats as ss
    from libfm_tpu_torch.kernels import table_read as tr
    from libfm_tpu_torch.kernels import table_scatter as ts

    g = torch.Generator().manual_seed(0)
    n, k, nc = 12, 3, 20
    P = torch.randn(n, k + 1, generator=g)
    ids = torch.randint(0, n, (nc, 2), generator=g, dtype=torch.int32)
    vals = torch.ones(nc, 2)
    A = torch.zeros(nc, k + 1)
    w0 = torch.tensor(0.5)
    off = torch.tensor([0, 3, 6], dtype=torch.int64)
    sc = torch.arange(6, dtype=torch.int32)
    sv = torch.ones(6)
    fid = torch.tensor([1, 4], dtype=torch.int32)
    GG = torch.zeros(2, ss.gg_width(k))
    for j in range(2):
        GG[j, :k * (k + 1) // 2] = torch.tensor([1.0, 0, 0, 1, 0, 1])
    th = torch.zeros(2, k + 1)
    lam = torch.ones(2, k + 1)
    col = torch.full((nc,), 2, dtype=torch.int32)
    col[:4] = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    tab = du.update_table(th, th + 0.1)
    return {
        "fm_refresh": lambda: fr.fm_refresh(P, ids, vals, w0, torch.ones(nc), A),
        "fm_refresh_probit": lambda: fr.fm_refresh(
            P, ids, vals, w0, torch.ones(nc), A, probit="sample",
            U=torch.rand(nc, generator=g), latent=torch.zeros(nc)),
        "slot_stats": lambda: ss.slot_stats(A, P, off, sc, sv, fid),
        "case_stats": lambda: cs.case_stats(A, P, off, sc, sv, fid, onehot=True),
        "probit_latent": lambda: pl.probit_latent(A, torch.zeros(nc), torch.ones(nc)),
        "schur_draw": lambda: sd.schur_draw(GG, th, lam, th, None, torch.tensor(1.0),
                                            do_sample=False, bound=1e6),
        "dual_draw": lambda: dd.dual_draw(A, off, sc, sv, th, lam, th, th, torch.ones(6),
                                          torch.tensor(1.0), do_sample=True, bound=1e6,
                                          use_linear=True),
        "dense_update": lambda: du.dense_update(A, col, None, tab),
        "sgd_step": lambda: sg.sgd_step(
            P, ids, vals, torch.ones(nc), torch.ones(nc, dtype=torch.bool), w0,
            mode="pair", task=0, lr1=0.1, lr2=0.1, regw=0.0, regv=0.01,
            min_target=1.0, max_target=5.0),
        "table_scatter": lambda: ts.table_scatter(
            P, torch.tensor([1, 1, 3], dtype=torch.int32),
            torch.tensor([2, 0, 1], dtype=torch.int32), torch.ones(3, k + 1)),
        "table_read": lambda: tr.table_read(P, ids[:, 0].contiguous(), 3, 8.0),
    }


@pytest.mark.parametrize("name", ["fm_refresh", "fm_refresh_probit", "slot_stats",
                                  "case_stats", "schur_draw", "dual_draw", "dense_update",
                                  "probit_latent", "sgd_step", "table_scatter",
                                  "table_read"])
def test_wrapper_on_cpu_runs_plain_and_counts_nothing(name):
    kernels.import_all()
    before = kernels.launch_counts()
    out = _cpu_calls()[name]()
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first).all()
    assert kernels.launch_counts() == before
    assert kernels._lib is None


def test_wrapper_rejects_mixed_devices():
    from libfm_tpu_torch.kernels import dense_update as du

    class Meta:  # a tensor-like on another device type
        device = torch.device("meta")

    with pytest.raises(ValueError, match="devices"):
        du.dense_update(torch.zeros(2, 3), Meta(), None, torch.zeros(3, 4))


def test_mcmc_iterations_import_no_sympy():
    """torch.broadcast_shapes imports sympy at its first call, seconds of
    host time inside the first MCMC iteration; the samplers must broadcast
    without it. A fresh interpreter, since this one may hold sympy."""
    code = (
        "import sys\n"
        "from libfm_tpu_torch.data.synth import movielens_like\n"
        "from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner\n"
        "from libfm_tpu_torch.models.fm import FMConfig\n"
        "tr, te = movielens_like(30, 20, 400, seed=3)\n"
        "cfg = FMConfig(num_features=tr.num_features, num_factors=2)\n"
        "MCMCVectorLearner(cfg, num_iter=2, seed=1, verbose=False,\n"
        "                  device='cpu').learn(tr, te)\n"
        "print('sympy' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"


def test_params_from_jax_roundtrip():
    w0, w, V = params_from_jax(np.float32(1.5), np.arange(4.0), np.ones((4, 2)), device="cpu")
    assert w0.shape == () and float(w0) == 1.5
    assert w.dtype == torch.float32 and w.shape == (4,)
    assert V.shape == (4, 2)
    with pytest.raises(ValueError):
        params_from_jax(0.0, np.zeros(3), np.zeros((4, 2)), device="cpu")
