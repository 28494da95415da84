"""The factorization machine model core (PyTorch).

    y(x) = w0 + sum_i w_i x_i
              + 0.5 * sum_f [ (sum_i v_if x_i)^2 - sum_i v_if^2 x_i^2 ]

the O(k*nnz) pairwise trick of libFM (src/fm_core/fm_model.h:105-127),
evaluated over padded-CSR batches `ids[B, L]` / `vals[B, L]` whose
padding entries carry value 0. V is stored [n, k] (feature-major), as in
`libfm_tpu.models.fm`. `save_model_text` / `load_model_text` read and
write libFM's text model format (the CLI's -save_model / -load_model).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FMConfig:
    """Static model configuration (libFM fm_model.h:51-60; defaults
    dim=(1,1,8), init_stdev=0.1, libfm.cpp:118-120)."""

    num_features: int
    num_factors: int = 8
    use_bias: bool = True  # k0
    use_linear: bool = True  # k1
    init_stdev: float = 0.1
    init_mean: float = 0.0
    reg0: float = 0.0
    regw: float = 0.0
    regv: float = 0.0
    dtype: torch.dtype = torch.float32


@dataclass
class FMParams:
    """Model parameters: w0 scalar tensor, w [n], V [n, k]."""

    w0: torch.Tensor
    w: torch.Tensor
    v: torch.Tensor

    @property
    def num_features(self) -> int:
        return self.v.shape[0]

    @property
    def num_factors(self) -> int:
        return self.v.shape[1]


def init_fm(
    cfg: FMConfig,
    generator: torch.Generator,
    mcmc_style_w: bool = False,
) -> FMParams:
    """w = 0, V ~ N(init_mean, init_stdev) (libFM fm_model.h:91-99); the
    MCMC family also draws w ~ N(init_mean, init_stdev) (libfm.cpp:283).
    The parameters lie on the generator's device."""
    device = generator.device
    n, k = cfg.num_features, cfg.num_factors
    v = cfg.init_mean + cfg.init_stdev * torch.randn(
        n, k, generator=generator, device=device, dtype=cfg.dtype
    )
    if mcmc_style_w:
        w = cfg.init_mean + cfg.init_stdev * torch.randn(
            n, generator=generator, device=device, dtype=cfg.dtype
        )
    else:
        w = torch.zeros(n, device=device, dtype=cfg.dtype)
    return FMParams(w0=torch.zeros((), device=device, dtype=cfg.dtype), w=w, v=v)


def fm_batch_terms(params: FMParams, ids: torch.Tensor, vals: torch.Tensor,
                   cfg: FMConfig):
    """Forward pass returning (pred[B], vsum[B, k]), vsum_f = sum_i v_if x_i.

    ids: int [B, L]; vals: float [B, L] with 0.0 at padding positions.
    """
    ids = ids.long()
    vx = params.v[ids] * vals[..., None]  # [B, L, k]
    vsum = vx.sum(dim=1)
    vsq = (vx * vx).sum(dim=(1, 2))
    pred = 0.5 * ((vsum * vsum).sum(dim=1) - vsq)
    if cfg.use_linear:
        pred = pred + (params.w[ids] * vals).sum(dim=1)
    if cfg.use_bias:
        pred = pred + params.w0
    return pred, vsum


def fm_batch_predict(params: FMParams, ids: torch.Tensor, vals: torch.Tensor,
                     cfg: FMConfig) -> torch.Tensor:
    """Raw (un-clamped, un-linked) FM scores for a padded batch."""
    pred, _ = fm_batch_terms(params, ids, vals, cfg)
    return pred


def predict_dense(params: FMParams, X: torch.Tensor, cfg: FMConfig) -> torch.Tensor:
    """Raw FM scores of dense rows X [B, n] by two [B, n] x [n, k] matmuls
    in full float32 (TF32 is off in this package)."""
    xv = X @ params.v
    x2v2 = (X * X) @ (params.v * params.v)
    pred = 0.5 * ((xv * xv).sum(dim=1) - x2v2.sum(dim=1))
    if cfg.use_linear:
        pred = pred + X @ params.w
    if cfg.use_bias:
        pred = pred + params.w0
    return pred


# ----------------------------------------------------------------- io


def save_model_text(params: FMParams, cfg: FMConfig, path: str) -> None:
    """Write libFM's text model format: the sections `#global bias W0`,
    `#unary interactions Wj` and `#pairwise interactions Vj,f`, each
    value with 6 significant digits (fm_model.h:132-154). The parameters
    may lie on any device."""
    w0 = float(params.w0)
    w = params.w.detach().cpu().double().numpy()
    v = params.v.detach().cpu().double().numpy().reshape(cfg.num_features, -1)
    with open(path, "w") as f:
        if cfg.use_bias:
            f.write("#global bias W0\n")
            f.write(f"{_fmt(w0)}\n")
        if cfg.use_linear:
            f.write("#unary interactions Wj\n")
            f.write("".join(f"{_fmt(x)}\n" for x in w[: cfg.num_features].tolist()))
        f.write("#pairwise interactions Vj,f\n")
        if v.shape[1]:
            np.savetxt(f, v, fmt="%.6g", delimiter=" ")
        else:
            f.write("\n" * cfg.num_features)


def load_model_text(cfg: FMConfig, path: str) -> FMParams | None:
    """Read libFM's text model format into CPU tensors of cfg.dtype; None
    where the file is missing or malformed (libFM then keeps its own
    init with a warning, libfm.cpp:262-268). A section header line is
    skipped unread; a V row must hold exactly num_factors values split by
    single spaces."""
    try:
        with open(path, "r") as f:
            lines = f.read().split("\n")
    except OSError:
        return None
    if lines and lines[-1] == "":
        lines.pop()  # the text after the last newline
    n, k = cfg.num_features, cfg.num_factors
    pos = 0
    try:
        w0 = 0.0
        if cfg.use_bias:
            w0 = float(lines[pos + 1])
            pos += 2
        w = np.zeros(n, dtype=np.float64)
        if cfg.use_linear:
            if pos + 1 + n > len(lines):
                return None
            w = np.array([float(x) for x in lines[pos + 1 : pos + 1 + n]], dtype=np.float64)
            pos += 1 + n
        rows = lines[pos + 1 : pos + 1 + n]
        if pos + 1 + n > len(lines) or any(r.count(" ") != k - 1 for r in rows):
            return None
        v = np.array(" ".join(rows).split(" ") if n else [], dtype=np.float64)
        if v.size != n * k:
            return None
    except (IndexError, ValueError):
        return None
    dt = cfg.dtype
    return FMParams(w0=torch.tensor(w0, dtype=dt), w=torch.tensor(w, dtype=dt),
                    v=torch.tensor(v.reshape(n, k), dtype=dt))


def _fmt(x: float) -> str:
    # C++ ostream's default formatting: 6 significant digits
    return f"{x:.6g}"
