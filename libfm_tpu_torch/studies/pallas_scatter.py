"""Per-row scatter-add into a resident table: the port of
studies/probes/pallas_scatter.py (probe P4).

The TPU probe keeps P [N, 16] in VMEM and does a sequential per-row
read-modify-write `out[ids[r]] += upd[r]` for r in order. `run(ids, P,
upd)` returns the same `out`: a stable sort of the ids, then the
table_scatter kernel, which adds each row's updates in that order. On
the H100 the table (5.2 MB) stays in the 50 MB L2.

    python -m libfm_tpu_torch.studies.pallas_scatter                # on a CUDA card
    python -m libfm_tpu_torch.studies.pallas_scatter --run-lengths  # the sweep
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from libfm_tpu_torch.kernels.table_scatter import table_scatter, table_scatter_plain
from libfm_tpu_torch.utils.timers import device_ms

N, K = 81920, 8  # P table rows (ML-ish), packed width 1+k=9 -> pad 16
W = 16
E = 65536  # rows scattered per call
REPS = 8  # timed calls
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def sorted_order(ids):
    """(sids int32, perm int32): the stable sorted order of ids."""
    s, p = torch.sort(ids.long(), stable=True)
    return s.to(torch.int32), p.to(torch.int32)


def run(ids, P, upd):
    """out = P + the rows of upd added at ids, sequentially per row."""
    sids, perm = sorted_order(ids)
    return table_scatter(P.clone(), sids, perm, upd)


def run_lengths(width=17, lengths=(1, 8, 64, 512, 1500, 8192), entries=106_496):
    """table_scatter where every run of equal ids has one length, against
    index_add_ on the same rows (width 17 and 106,496 entries: a config
    #4b batch). For each length: one run alone (its serial chain) and
    runs tiling all the entries. Returns one record per case."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for length in lengths:
        for total in (length, entries):
            n_runs = max(1, total // length)
            sids = torch.arange(n_runs, device=dev, dtype=torch.int32).repeat_interleave(length)
            E = sids.numel()
            perm = torch.randperm(E, generator=g, device=dev).to(torch.int32)
            upd = torch.randn(E, width, generator=g, device=dev)
            ids = torch.empty_like(sids)
            ids[perm.long()] = sids  # the unsorted ids whose sorted order this is
            T = torch.zeros(n_runs, width, device=dev)
            rec = dict(run_length=length, runs=n_runs, entries=E,
                       ms=device_ms(lambda: table_scatter(T, sids, perm, upd), REPS),
                       library_ms=device_ms(lambda: T.index_add_(0, ids.long(), upd),
                                            REPS))
            rec["ns_per_entry"] = rec["ms"] * 1e6 / E
            print(f"  runs of {length:5d} x {n_runs:6d}: {rec['ms']:8.4f} ms "
                  f"({rec['ns_per_entry']:8.3f} ns/entry), index_add_ "
                  f"{rec['library_ms']:8.4f} ms", flush=True)
            out.append(rec)
    return out


def main(atol=1e-5):
    """Time the scatter (sort excluded and included) and its plain version
    on the card; check it against np.add.at. Returns a record."""
    if not torch.cuda.is_available():
        raise RuntimeError("the scatter probe measures a CUDA card; none is available")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ids_np = rng.integers(0, N, E).astype(np.int32)
    upd_np = rng.standard_normal((E, W)).astype(np.float32)
    ids = torch.as_tensor(ids_np, device=dev)
    P = torch.zeros(N, W, device=dev)
    upd = torch.as_tensor(upd_np, device=dev)
    out = run(ids, P, upd)
    want = np.zeros((N, W), np.float32)
    np.add.at(want, ids_np, upd_np)
    err = float(np.abs(out.cpu().numpy() - want).max())
    sids, perm = sorted_order(ids)
    T = P.clone()
    rec = dict(max_err=err, tol=atol,
               ms=device_ms(lambda: table_scatter(T, sids, perm, upd), REPS),
               plain_ms=device_ms(lambda: table_scatter_plain(T, sids, perm, upd), REPS),
               with_sort_ms=device_ms(lambda: run(ids, P, upd), REPS))
    rec["ns_per_row"] = rec["ms"] * 1e6 / E
    rec["plain_ns_per_row"] = rec["plain_ms"] * 1e6 / E
    # least bytes: the order and the update rows read once, each touched
    # table row read and written once
    touched = int(torch.unique_consecutive(sids).numel())
    rec["bound_ms"] = (E * 8 + E * W * 4 + touched * W * 8) / PEAK_BYTES_PER_S * 1e3
    print(f"  scatter    {rec['ms']:9.4f} ms  {rec['ns_per_row']:7.3f} ns/row"
          f"  (plain {rec['plain_ns_per_row']:.3f} ns/row; bound "
          f"{rec['bound_ms']:.4f} ms)  max_err {err:.2e}", flush=True)
    if not err <= atol:
        raise AssertionError(f"scatter probe disagrees with np.add.at: {err}")
    return rec


if __name__ == "__main__":
    json.dump(run_lengths() if "--run-lengths" in sys.argv[1:] else main(),
              sys.stdout, indent=1)
