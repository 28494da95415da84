"""rel_scores at bench_bs's shapes and probit_latent at config #4's, timed,
with their outputs' digests, to compare two commits' kernels on one card.

Inputs from numpy's default_rng(0), the same in every tree:
- rel_scores: 4,000 block rows of 16 entries over 20,000 features (each
  row's columns sorted, values normal) and P [20,000, 33];
- probit_latent: A [1.8M, 17], the latents, +-1 targets and the uniforms
  (sampling), one call on copies.
Prints one JSON line: each kernel's device time (CUDA events, the median
of `reps`; probit_latent's call includes its partials' sum), the digests
of SC, of A and the latents after the resample and of the correct count
(equal digests: the same bits), and the card. The module uses only
`rel_scores(P, indptr, cols, vals)` and `probit_latent(A, latent, y, U)`,
which earlier trees have too, so a copy of it runs in an earlier
commit's tree:

    python -m libfm_tpu_torch.studies.scores_latent_ab   # on a CUDA card
"""

from __future__ import annotations

import hashlib
import json
import subprocess

import numpy as np
import torch

from libfm_tpu_torch.kernels import probit_latent as pl
from libfm_tpu_torch.kernels import rel_refresh as rr
from libfm_tpu_torch.utils.timers import device_ms

#: bench_bs's block rows, entries a row, features and k
NB, W, NF, K = 4000, 16, 20_000, 32
#: config #4's train cases and k
NC4, K4 = 1_800_000, 16


def digest(*ts: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(reps=20):
    if not torch.cuda.is_available():
        raise RuntimeError("the A/B study measures a CUDA card; none is available")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cols = np.stack([np.sort(rng.choice(NF, W, replace=False)) for _ in range(NB)])
    indptr = torch.as_tensor(np.arange(NB + 1, dtype=np.int64) * W, device=dev)
    cols = torch.as_tensor(cols.ravel().astype(np.int32), device=dev)
    vals = torch.as_tensor(rng.normal(0, 1, NB * W).astype(np.float32), device=dev)
    P = torch.as_tensor(rng.normal(0, 0.1, (NF, K + 1)).astype(np.float32), device=dev)
    SC = rr.rel_scores(P, indptr, cols, vals)
    torch.cuda.synchronize()
    rec = dict(rel_scores_digest=digest(SC),
               rel_scores_ms=device_ms(lambda: rr.rel_scores(P, indptr, cols, vals), reps))
    # what the time is made of: a launch on no entries (the sentinel row
    # alone), an eighth of the rows, and every row on the same 16 features
    # (their P rows hot in L1)
    none = (indptr[:1], cols[:0], vals[:0])
    eighth = (indptr[:NB // 8 + 1], cols[:NB // 8 * W], vals[:NB // 8 * W])
    same = (indptr, torch.arange(NB * W, device=dev, dtype=torch.int32) % W, vals)
    for name, design in (("no_entries", none), ("eighth_of_rows", eighth),
                         ("same_features", same)):
        rec[f"rel_scores_{name}_ms"] = device_ms(lambda: rr.rel_scores(P, *design), reps)

    A = torch.as_tensor(rng.normal(0, 2, (NC4, K4 + 1)).astype(np.float32), device=dev)
    lat = torch.as_tensor(rng.normal(0, 1, NC4).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.choice([-1.0, 1.0], NC4).astype(np.float32), device=dev)
    U = torch.as_tensor(rng.random(NC4).astype(np.float32), device=dev)
    A_1, lat_1 = A.clone(), lat.clone()
    out = pl.probit_latent(A_1, lat_1, y, U)
    correct = out[0] if isinstance(out, tuple) else out
    torch.cuda.synchronize()
    rec.update(probit_latent_digest=digest(A_1, lat_1), probit_correct_digest=digest(correct),
               probit_latent_ms=device_ms(lambda: pl.probit_latent(A_1, lat_1, y, U), reps))
    rec["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader", "--id=0"],
                                 capture_output=True, text=True).stdout.strip()
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
