"""table_read: repeated random row reads of a table, summed per lane,
with a carried accumulator. CUDA source: csrc/table_read.cu.

Replaces the Pallas probes studies/pallas_gather.py:79 (P1,
`make_read_kernel.run`, scale 8) and :147 (P3, `make_take_kernel.run`,
scale 1).
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr

KERNEL = Kernel(
    "table_read", "table_read_launch",
    [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int, ctypes.c_longlong],
)
_TARGET_CTAS = 2 * 132  # over all reps: two CTAs an SM
_MIN_IDS_PER_CTA = 256


def table_read_plain(T, ids, reps, scale, n_used=None):
    """The plain PyTorch version; same contract as `table_read`."""
    nsub = T.shape[0]
    n_used = ids.shape[0] if n_used is None else n_used
    base = ids[:n_used].long()
    acc = torch.zeros(T.shape[1], dtype=T.dtype, device=T.device)
    for r in range(reps):
        acc = scale * acc + T[(base + r) % nsub].sum(dim=0)
    return acc


def table_read(T, ids, reps, scale, n_used=None):
    """acc [W] after `reps` reps of acc = scale * acc + S_r, acc_0 = 0,
    where S_r = sum over the first n_used ids of T[(ids[i] + r) % nsub].

    T [nsub, W] float32; ids int32 (non-negative). The sum of each rep is
    taken in a fixed order, so the result is deterministic."""
    if not on_cuda(T, ids):
        return table_read_plain(T, ids, reps, scale, n_used)
    nsub, W = T.shape
    n_used = ids.shape[0] if n_used is None else n_used
    check(T, "T", torch.float32)
    check(ids, "ids", torch.int32)
    if not 0 <= n_used <= ids.shape[0] or reps < 1:
        raise ValueError(f"n_used={n_used} of {ids.shape[0]} ids, reps={reps}")
    nblk = max(1, min(-(-n_used // _MIN_IDS_PER_CTA), -(-_TARGET_CTAS // reps)))
    per_cta = max(1, -(-n_used // nblk))
    part = torch.empty(reps, nblk, W, dtype=torch.float32, device=T.device)
    out = torch.empty(W, dtype=torch.float32, device=T.device)
    KERNEL.launch(ptr(T), ptr(ids), ptr(part), ptr(out), n_used, nsub, W, reps,
                  float(scale), nblk, per_cta)
    return out
