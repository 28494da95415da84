"""Random row reads and read-modify-writes of a resident table: the port
of studies/pallas_gather.py (probes P1-P3).

The TPU probes keep a [NSUB, 128] f32 table in VMEM and stream random
row indices through three access patterns. Here each returns a
`run(ids, T)` with the TPU kernel's semantics, `out.sum()` included:

  read      (P1) acc_{r+1} = 8 acc_r + S_r, S_r = sum_i T[(ids[i] + r) % nsub]
            — the TPU kernel seeds each of its UNROLL=8 accumulators with
            the carried acc, so a rep adds 8 acc, not acc (table_read,
            scale 8);
  rmw       (P2) T[(ids[i] + r) % nsub] += 1 over the reps, then row 0
            (table_scatter with rows of ones, one stable sort per rep);
  vec_take  (P3) acc += sum of the rows of each 256-id chunk; only the
            first nids // 256 * 256 ids are read (table_read, scale 1).

On the H100 no SM's 227 KB of shared memory holds the 5.25 MB table, but
32 SMs each hold every row of a 4-column slice of it: table_read's
shared form (kernels/table_read.py `read_plan`), whose lookups read
shared memory. Each read record carries its plan and the shared-memory
floor of its lookups beside the HBM bound. `--forms` times P1 and P3
under each form of the plan (slices of 4, 2 and 1 columns, and the l2
form, which reads the rows from global memory through L2).

    python -m libfm_tpu_torch.studies.pallas_gather [--forms]  # on a CUDA card
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from libfm_tpu_torch.kernels import table_read as tr
from libfm_tpu_torch.kernels.table_read import read_plan, table_read, table_read_plain
from libfm_tpu_torch.kernels.table_scatter import table_scatter, table_scatter_plain
from libfm_tpu_torch.utils.timers import device_ms

UNROLL = 8
CHUNK = 256
# the studies' shape: 82K rows / 8 per sublane row -> 5.25 MB
NSUB, NIDS, REPS = 10_256, 16_384, 20
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SMEM_BYTES_PER_CLOCK = 128  # an SM's shared memory, without bank conflicts
#: the read probes' forms that `--forms` times: slices of 4, 2 and 1
#: columns, and the l2 form
FORMS = ("shared 4", "shared 2", "shared 1", "l2")


def smem_floor_ms(reps, n_used, W, device=0):
    """The least time the lookups of a read probe take from shared memory:
    reps x n_used rows of W floats at SMEM_BYTES_PER_CLOCK a clock on
    every SM at the card's clock (its `clock_rate`); None where torch
    does not give the clock."""
    props = torch.cuda.get_device_properties(device)
    khz = getattr(props, "clock_rate", 0)
    if not khz:
        return None
    per_s = props.multi_processor_count * SMEM_BYTES_PER_CLOCK * khz * 1e3
    return reps * n_used * W * 4 / per_s * 1e3


def make_read_kernel(nsub, nids, reps):
    n_used = nids // UNROLL * UNROLL

    def run(ids, T):
        return table_read(T, ids, reps, float(UNROLL), n_used).sum()

    return run


def rmw_orders(ids, nsub, reps):
    """Per rep, the stable sorted order of (ids + r) % nsub:
    [(sids int32, perm int32)]."""
    out = []
    for r in range(reps):
        s, p = torch.sort((ids.long() + r) % nsub, stable=True)
        out.append((s.to(torch.int32), p.to(torch.int32)))
    return out


def rmw_scatters(T, orders, scatter=table_scatter):
    """P2 after the sorts: a copy of T gets +1 at every id of every rep's
    order, by `scatter`; returns the sum of its row 0."""
    scratch = T.clone()
    ones = torch.ones(orders[0][0].shape[0], T.shape[1], dtype=T.dtype, device=T.device)
    for sids, perm in orders:
        scatter(scratch, sids, perm, ones)
    return scratch[0].sum()


def rmw_index_add(T, orders):
    """P2 after the sorts by one library call a rep: index_add_ of the
    rows of ones at every id of every rep's order (the yardstick of
    `rmw_scatters`); returns the sum of its row 0."""
    scratch = T.clone()
    ones = torch.ones(orders[0][0].shape[0], T.shape[1], dtype=T.dtype, device=T.device)
    for sids, _perm in orders:
        scratch.index_add_(0, sids.long(), ones)
    return scratch[0].sum()


def make_rmw_kernel(nsub, nids, reps):
    def run(ids, T):
        return rmw_scatters(T, rmw_orders(ids[:nids], nsub, reps))

    return run


def make_take_kernel(nsub, nids, reps, chunk=CHUNK):
    n_used = nids // chunk * chunk

    def run(ids, T):
        return table_read(T, ids, reps, 1.0, n_used).sum()

    return run


def main(nsub=NSUB, nids=NIDS, reps=REPS, rtol=1e-5):
    """Time each probe and its plain version on the card at the studies'
    shape (rmw: the scatters, and with its sorts); check the kernel against
    the plain version (relative `rtol` of the result, exact for rmw); give
    each its bound from HBM bytes. Returns one record per probe."""
    if not torch.cuda.is_available():
        raise RuntimeError("the table probes measure a CUDA card; none is available")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = torch.as_tensor(rng.standard_normal((nsub, 128)), dtype=torch.float32, device=dev)
    ids = torch.as_tensor(rng.integers(0, nsub, nids).astype(np.int32), device=dev)
    orders = rmw_orders(ids, nsub, reps)
    W = T.shape[1]
    n_read, n_take = nids // UNROLL * UNROLL, nids // CHUNK * CHUNK
    # least bytes, each input read once and each output written once: the
    # reads take the table and the ids they use and write one row; rmw
    # takes the table and the ids and writes the table
    nbytes = {
        "read": nsub * W * 4 + n_read * 4 + W * 4,
        "rmw": 2 * nsub * W * 4 + nids * 4,
        "vec_take": nsub * W * 4 + n_take * 4 + W * 4,
    }
    plain = {
        "read": lambda: table_read_plain(T, ids, reps, float(UNROLL), n_read).sum(),
        "rmw": lambda: rmw_scatters(T, orders, table_scatter_plain),
        "vec_take": lambda: table_read_plain(T, ids, reps, 1.0, n_take).sum(),
    }
    results = []
    for name, maker in (("read", make_read_kernel), ("rmw", make_rmw_kernel),
                        ("vec_take", make_take_kernel)):
        run = maker(nsub, nids, reps)
        got, want = run(ids, T).item(), plain[name]().item()
        err = abs(got - want) / max(1.0, abs(want))
        tol = 0.0 if name == "rmw" else rtol
        rec = dict(strategy=name, value=got, plain_value=want, rel_err=err, tol=tol)
        rec["bound_ms"] = nbytes[name] / PEAK_BYTES_PER_S * 1e3
        if name != "rmw":
            n_used = n_read if name == "read" else n_take
            rec["plan"] = dataclasses.asdict(read_plan(nsub, W, n_used, reps, _sms()))
            rec["smem_floor_ms"] = smem_floor_ms(reps, n_used, W)
        if name == "rmw":
            rec["ms"] = device_ms(lambda: rmw_scatters(T, orders))
            rec["with_sorts_ms"] = device_ms(lambda: run(ids, T))
            rec["library_ms"] = device_ms(lambda: rmw_index_add(T, orders))
        else:
            rec["ms"] = device_ms(lambda: run(ids, T))
        rec["plain_ms"] = device_ms(plain[name])
        rec["ns_per_row"] = rec["ms"] * 1e6 / (reps * nids)
        rec["plain_ns_per_row"] = rec["plain_ms"] * 1e6 / (reps * nids)
        lib = f"; index_add_ {rec['library_ms']:.4f} ms" if "library_ms" in rec else ""
        if "plan" in rec:
            lib += (f"; shared-memory floor {rec['smem_floor_ms']} ms; plan "
                    f"{plan_text(rec['plan'])}")
        print(f"  {name:10s} {rec['ms']:9.4f} ms  {rec['ns_per_row']:7.3f} ns/row"
              f"  (plain {rec['plain_ns_per_row']:.3f} ns/row; bound "
              f"{rec['bound_ms']:.4f} ms{lib})  rel_err {err:.2e}", flush=True)
        if err > tol:
            raise AssertionError(f"{name}: kernel {got} against plain {want}")
        results.append(rec)
    return results


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def plan_text(plan):
    """One line of a read plan (as `dataclasses.asdict` gives it)."""
    return (f"{plan['form']}, {plan['cols']} columns x {plan['slices']} slices, "
            f"{plan['groups']} id groups of {plan['per_group']}"
            f"{', reps over ' + str(plan['rep_split']) if plan['rep_split'] > 1 else ''}, "
            f"{plan['smem_bytes']} shared bytes")


def forms(nsub=NSUB, nids=NIDS, reps=REPS, rtol=1e-5):
    """P1 and P3 at the studies' shape under each form of FORMS, in turns
    (each form twice, the second pass in reverse order), each checked
    against the plain version and the same bits on a second launch, and
    timed as one launch of table_read on that plan (no `.sum()`); one
    record per probe and form."""
    if not torch.cuda.is_available():
        raise RuntimeError("the table probes measure a CUDA card; none is available")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = torch.as_tensor(rng.standard_normal((nsub, 128)), dtype=torch.float32, device=dev)
    ids = torch.as_tensor(rng.integers(0, nsub, nids).astype(np.int32), device=dev)
    W, out = T.shape[1], []
    for probe, scale, n_used in (("P1", float(UNROLL), nids // UNROLL * UNROLL),
                                 ("P3", 1.0, nids // CHUNK * CHUNK)):
        want = table_read_plain(T, ids, reps, scale, n_used)
        recs = {}
        for form in FORMS + FORMS[::-1]:
            plan = (tr.l2_plan(nsub, W, n_used, reps, _sms()) if form == "l2" else
                    tr.shared_plan(nsub, W, n_used, reps, int(form.split()[1]), _sms()))
            args, got, _scratch = tr.launch_args(T, ids, reps, scale, plan)
            tr.KERNEL.launch(*args)
            err = ((got - want).abs().max() / want.abs().max()).item()
            first = got.clone()
            tr.KERNEL.launch(*args)
            if err > rtol or not torch.equal(got, first):
                raise AssertionError(f"{probe} under {form}: error {err} > {rtol}, or two "
                                     f"calls differ")
            rec = recs.setdefault(form, dict(probe=probe, form=form, ms=[], rel_err=err,
                                             plan=dataclasses.asdict(plan)))
            rec["ms"].append(device_ms(lambda: tr.KERNEL.launch(*args)))
        for rec in recs.values():
            print(f"  {probe} {rec['form']:8s} ms {rec['ms']}  ({plan_text(rec['plan'])})",
                  flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    json.dump(forms() if "--forms" in sys.argv[1:] else main(), sys.stdout, indent=1)
