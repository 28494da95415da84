"""Full-state checkpoints of the MCMC/ALS chains (numpy and torch).

The port of `libfm_tpu.utils.checkpoint`. libFM itself can save only
{w0, w, V} as text and refuses even that for MCMC, whose sampler state
(the caches, the hyperparameters, the prediction sums) it cannot write
(libfm.cpp:123-133). Here the learners hand over every tensor the next
iteration reads, by name, and the chain resumes from it:

- `save_state(path, state, meta)` writes an .npz atomically (a temporary
  file in the target's directory, then `os.replace`): one array a name of
  `state` (tensors on any device, or numpy arrays) and the JSON `meta`.
- `restore_state(path)` returns ({name: numpy array}, meta).

The keys are the state's own names, not the leaf positions of a JAX
pytree, so a checkpoint of the JAX package does not load here, nor one of
the port there: the two chains draw from different generators anyway.
`MCMCLearner(checkpoint_path=..., checkpoint_every=...)` saves and
resumes through these two functions.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

#: the .npz key of the JSON metadata (no state name may take it)
META_KEY = "__meta__"


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path: str, state: dict, meta: dict | None = None) -> None:
    """Atomically write `state` ({name: tensor or array}) and the JSON
    `meta` to `path` (.npz)."""
    if META_KEY in state:
        raise ValueError(f"{META_KEY!r} is reserved for the metadata")
    payload = {name: _host(x) for name, x in state.items()}
    payload[META_KEY] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_state(path: str) -> tuple[dict, dict]:
    """Read a checkpoint: ({name: numpy array}, meta)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[META_KEY]).decode()) if META_KEY in z.files else {}
        state = {name: z[name] for name in z.files if name != META_KEY}
    return state, meta
