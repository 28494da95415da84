"""Per-row scatter-add into a resident table: the port of
studies/probes/pallas_scatter.py (probe P4).

The TPU probe keeps P [N, 16] in VMEM and does a sequential per-row
read-modify-write `out[ids[r]] += upd[r]` for r in order. `run(ids, P,
upd)` returns the same `out`: a stable sort of the ids, then the
table_scatter kernel, which sums each row's updates in an order fixed by
the sorted positions. On the H100 the table (5.2 MB) stays in the 50 MB
L2.

    python -m libfm_tpu_torch.studies.pallas_scatter                # on a CUDA card
    python -m libfm_tpu_torch.studies.pallas_scatter --run-lengths  # the sweeps

`--run-lengths` times the scatter by run length, and over batches of each
SGD configuration's ids at the widths up to 32, with the windows of one
round and of the long form (widths 17 to 32 have one form only; up to 16,
each batch's longest run picks between them: kLongRun in the source).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from libfm_tpu_torch.kernels.table_scatter import (
    LONG_RUN, longest_runs, table_scatter, table_scatter_plain,
)
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


def _sweep_record(T, sids, perm, upd):
    """The times of one case, ms: the rows through perm and in sorted order
    with the windows that the longest run picks, in sorted order with
    windows of one round and of the long form, and index_add_ of the
    sorted rows."""
    upd_sorted = upd[perm.long()]
    sids_l = sids.long()
    run = int(longest_runs(sids))
    one, long_form = 1, LONG_RUN + 1  # max_run values that pick each form
    return dict(
        longest_run=run,
        ms=device_ms(lambda: table_scatter(T, sids, perm, upd, max_run=run), REPS),
        sorted_rows_ms=device_ms(
            lambda: table_scatter(T, sids, None, upd_sorted, max_run=run), REPS),
        one_round_ms=device_ms(
            lambda: table_scatter(T, sids, None, upd_sorted, max_run=one), REPS),
        long_form_ms=device_ms(
            lambda: table_scatter(T, sids, None, upd_sorted, max_run=long_form), REPS),
        library_ms=device_ms(lambda: T.index_add_(0, sids_l, upd_sorted), REPS))


def run_lengths(widths=(9, 17), lengths=(1, 8, 32, 64, 128, 256, 512, 1500, 8192),
                entries=106_496):
    """table_scatter where every run of equal ids has one length, against
    index_add_ on the same rows (106,496 entries: a config #4b batch), at
    the SGD tables' widths: for each length, one run alone and runs tiling
    all the entries (`_sweep_record`'s times). Returns one record per
    case."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for width in widths:
        for length in lengths:
            for total in (length, entries):
                n_runs = max(1, total // length)
                sids = torch.arange(n_runs, device=dev,
                                    dtype=torch.int32).repeat_interleave(length)
                E = sids.numel()
                perm = torch.randperm(E, generator=g, device=dev).to(torch.int32)
                upd = torch.randn(E, width, generator=g, device=dev)
                T = torch.zeros(n_runs, width, device=dev)
                rec = dict(width=width, run_length=length, runs=n_runs, entries=E,
                           **_sweep_record(T, sids, perm, upd))
                out.append(rec)
                print(f"  W={width} runs of {length:5d} x {n_runs:6d}: through perm "
                      f"{rec['ms']:8.4f} ms, sorted rows {rec['sorted_rows_ms']:8.4f} "
                      f"(one round {rec['one_round_ms']:8.4f}, long form "
                      f"{rec['long_form_ms']:8.4f}), index_add_ {rec['library_ms']:8.4f}",
                      flush=True)
    return out


def config_batches(widths=(4, 8, 9, 12, 16, 17, 24, 32), nb=32, seed=0):
    """table_scatter over nb batches of each SGD configuration's ids, back
    to back as an epoch runs them, in sorted order, at each width: with
    the windows that each batch's longest run picks, with windows of one
    round and of the long form, and index_add_ of the same rows (ms for
    the nb calls). Config #1's ids: 32,768 ratings a batch, user and item
    ids uniform over 71,567 and 10,681 (short runs); config #4b's: 8,192
    rows of 13 Zipf(1.2) fields of 5,000 ids (runs of ~1,500). Returns
    one record per case."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)

    def ml_ids():
        users = rng.integers(0, 71_567, 32_768)
        return np.stack([users, 71_567 + rng.integers(0, 10_681, 32_768)], 1).reshape(-1)

    def ctr_ids():
        return (np.minimum(rng.zipf(1.2, (8192, 13)) - 1, 4999)
                + np.arange(13) * 5000).reshape(-1)

    out = []
    for label, draw, n in (("config #1 ids", ml_ids, 71_567 + 10_681),
                           ("config #4b ids", ctr_ids, 13 * 5000)):
        orders = [sorted_order(torch.as_tensor(draw().astype(np.int32), device=dev))
                  for _ in range(nb)]
        sids = [s for s, _ in orders]
        sids_l = [s.long() for s in sids]
        runs = [int(r) for r in longest_runs(torch.stack(sids))]
        E = sids[0].numel()
        for width in widths:
            upds = [torch.randn(E, width, generator=g, device=dev) for _ in range(nb)]
            T = torch.zeros(n, width, device=dev)

            def scatters(forced=None):
                return lambda: [table_scatter(T, s, None, u, max_run=forced or r)
                                for s, u, r in zip(sids, upds, runs)]

            def library():
                for s, u in zip(sids_l, upds):
                    T.index_add_(0, s, u)

            rec = dict(batch=label, width=width, batches=nb, entries=E,
                       longest_run_median=float(np.median(runs)),
                       ms=device_ms(scatters(), REPS),
                       one_round_ms=device_ms(scatters(1), REPS),
                       long_form_ms=device_ms(scatters(LONG_RUN + 1), REPS),
                       library_ms=device_ms(library, REPS))
            out.append(rec)
            print(f"  {label} x {nb}, W={width}, longest runs ~{rec['longest_run_median']:g}: "
                  f"{rec['ms']:8.4f} ms (one round {rec['one_round_ms']:8.4f}, long form "
                  f"{rec['long_form_ms']:8.4f}), index_add_ {rec['library_ms']:8.4f}",
                  flush=True)
            del upds
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
    longest = int(longest_runs(sids))
    T = P.clone()
    rec = dict(max_err=err, tol=atol, longest_run=longest,
               ms=device_ms(lambda: table_scatter(T, sids, perm, upd, max_run=longest),
                            REPS),
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
    if "--run-lengths" in sys.argv[1:]:
        result = dict(run_lengths=run_lengths(), config_batches=config_batches())
    else:
        result = main()
    json.dump(result, sys.stdout, indent=1)
