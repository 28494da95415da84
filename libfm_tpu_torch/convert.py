"""Carry the JAX package's parameters across to the port.

`params_from_jax` takes plain numpy arrays — such as the JAX learner's
`get_params()` fields or its initial draw, converted with `np.asarray`
— and returns the port's tensors; `packed_from_jax` returns them as the
SGD step's packed table. Neither imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from libfm_tpu_torch.device import resolve_device


def params_from_jax(w0, w, V, device=None):
    """(w0 0-dim, w [n], V [n, k]) tensors on `device` (default CUDA)."""
    dev = resolve_device(device)
    w = np.asarray(w)
    V = np.asarray(V)
    if w.ndim != 1 or V.ndim != 2 or V.shape[0] != w.shape[0]:
        raise ValueError(
            f"expected w [n] and V [n, k], got {w.shape} and {V.shape}"
        )
    return (
        torch.tensor(np.asarray(w0), dtype=torch.float32, device=dev).reshape(()),
        torch.tensor(w, dtype=torch.float32, device=dev),
        torch.tensor(V, dtype=torch.float32, device=dev),
    )


def packed_from_jax(w0, w, V, device=None):
    """(w0 0-dim, P = [w | V] [n, 1+k]) tensors on `device` (default CUDA)."""
    w0, w, V = params_from_jax(w0, w, V, device)
    return w0, torch.cat([w[:, None], V], dim=1).contiguous()
