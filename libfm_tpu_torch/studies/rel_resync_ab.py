"""rel_resync at bench_bs's shapes: both modes timed, their outputs'
digests printed, to compare two commits' kernels on one card.

Inputs from numpy's default_rng(0), the same in every tree: SD [4,001,
33] (the pad row zero), A [1M, 33] and the test tail [100K, 33] with
their block rows uniform over 4,000. Write mode runs on a copy of A,
read-only mode on the tail. Prints one JSON line: each mode's device
time (CUDA events, the median of `reps`), the digests of A after write
mode and of the read-only predictions (equal digests: the same bits),
and the card. The module uses only `rel_resync(SD, row_map, A,
read_only)`, so a copy of it runs in an earlier commit's tree too.
`--runs 32,64,...` also times both modes at each of those runs of
cases (through `launch_resync`, in trees that have it):

    python -m libfm_tpu_torch.studies.rel_resync_ab [--runs R,...]   # on a CUDA card
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import numpy as np
import torch

from libfm_tpu_torch.kernels import rel_sweep as rs
from libfm_tpu_torch.utils.timers import device_ms

#: bench_bs's block rows, train and test cases and k
NB, NTR, NTE, K = 4000, 1_000_000, 100_000, 32


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main(reps=20, runs=()):
    if not torch.cuda.is_available():
        raise RuntimeError("the A/B study measures a CUDA card; none is available")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    d = K + 1
    SD = rng.normal(0, 0.1, (NB + 1, d)).astype(np.float32)
    SD[NB] = 0.0
    SD = torch.as_tensor(SD, device=dev)
    map_tr = torch.as_tensor(rng.integers(0, NB, NTR).astype(np.int32), device=dev)
    map_te = torch.as_tensor(rng.integers(0, NB, NTE).astype(np.int32), device=dev)
    A = torch.as_tensor(rng.normal(0, 1, (NTR, d)).astype(np.float32), device=dev)
    tail = torch.as_tensor(rng.normal(0, 1, (NTE, d)).astype(np.float32), device=dev)
    A_w = A.clone()
    rs.rel_resync(SD, map_tr, A_w)
    e = rs.rel_resync(SD, map_te, tail, read_only=True)
    torch.cuda.synchronize()
    rec = dict(write_digest=digest(A_w), read_only_digest=digest(e))
    rec["write_ms"] = device_ms(lambda: rs.rel_resync(SD, map_tr, A_w), reps)
    rec["read_only_ms"] = device_ms(lambda: rs.rel_resync(SD, map_te, tail, read_only=True),
                                    reps)
    e_run = torch.empty_like(e)
    for run in runs:
        plan = rs.ResyncPlan(run, rs.resync_smem(run, K))
        rec[f"run_{run}"] = dict(
            write_ms=device_ms(lambda: rs.launch_resync(SD, map_tr, A_w, None, plan), reps),
            read_only_ms=device_ms(lambda: rs.launch_resync(SD, map_te, tail, e_run, plan),
                                   reps))
    rec["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader", "--id=0"],
                                 capture_output=True, text=True).stdout.strip()
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="", help="runs to time beside the plan's, e.g. 32,64")
    main(runs=[int(r) for r in ap.parse_args().runs.split(",") if r])
