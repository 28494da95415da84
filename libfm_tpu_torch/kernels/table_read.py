"""table_read: repeated random row reads of a table, summed per lane,
with a carried accumulator. CUDA source: csrc/table_read.cu.

Replaces the Pallas probes studies/pallas_gather.py:79 (P1,
`make_read_kernel.run`, scale 8) and :147 (P3, `make_take_kernel.run`,
scale 1).

`read_plan` chooses the launch: the shared form holds a slice of the
table's columns (4, 2 or 1, the widest whose slice and a group's ids fit
a CTA's shared memory, and whose slices the SMs hold one a CTA) in each
CTA, its id groups chosen from the SM count; past that, the l2 form
reads the rows from global memory, 128 columns a CTA. Either form is one launch; the last CTA of each column
slice adds the slice's partials in a fixed order behind a ticket.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr

KERNEL = Kernel(
    "table_read", "table_read_launch",
    [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_longlong],
)
#: the shared memory a CTA may take on an H100 (227 KB)
SMEM_MAX = 232_448
H100_SMS = 132
#: the shared form's slice widths, widest first
SLICE_WIDTHS = (4, 2, 1)
#: the l2 form's columns a CTA (csrc: kTile)
L2_COLS = 128
#: the fewest ids a shared-form group takes, and the most an l2-form
#: group stages
MIN_IDS, L2_IDS = 256, 1024
_WARPS, _FLAG_BYTES, _HEAD_FLOATS = 16, 16, 2048  # csrc: kWarps, kFlagBytes, kHeadFloats
FORMS = {"shared": 0, "l2": 1}
_tickets: dict = {}


@dataclass(frozen=True)
class ReadPlan:
    """One launch of `table_read`: CTA (slice, group, z) of a grid of
    `slices` x `groups` x `rep_split`. A slice is `cols` columns (the last
    may hold fewer); group g takes ids [g per_group, (g + 1) per_group) of
    the first n_used; z the reps z, z + rep_split, ... (the l2 form; 1 in
    the shared form). `shape` is the (nsub, W, n_used, reps) it was made
    for."""

    form: str
    cols: int
    slices: int
    groups: int
    per_group: int
    rep_split: int
    smem_bytes: int
    shape: tuple


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def smem_bytes(form: str, nsub: int, cols: int, per: int) -> int:
    """A CTA's dynamic shared memory (csrc: table_read_smem_bytes): the
    flag, the warps' sums, the slice and the group's ids twice (as copied,
    in bank order) in the shared form; the l2 form's sums and ids."""
    if form == "l2":
        return _FLAG_BYTES + 4 * 2 * _WARPS * L2_COLS + 4 * per
    return _FLAG_BYTES + 4 * _HEAD_FLOATS + 4 * _round4(nsub * cols) + 8 * per


def _split(n_used: int, groups: int) -> tuple[int, int]:
    """(ids a group, a multiple of 4; the groups they take, none empty)."""
    if n_used == 0:
        return 0, 1
    per = _round4(-(-n_used // groups))
    return per, -(-n_used // per)


def shared_plan(nsub: int, W: int, n_used: int, reps: int, cols: int,
                sms: int = H100_SMS) -> ReadPlan | None:
    """The shared form at slices of `cols` columns, with sms // slices id
    groups of at least MIN_IDS ids; None where a slice plus a group's ids
    does not fit SMEM_MAX, or the slices are more than the SMs (the form's
    grid is one wave of one CTA an SM)."""
    slices = -(-W // cols)
    if slices > sms:
        return None
    most = max(1, -(-n_used // MIN_IDS))
    per, groups = _split(n_used, min(sms // slices, most))
    nbytes = smem_bytes("shared", nsub, cols, per)
    if nbytes > SMEM_MAX:
        return None
    return ReadPlan("shared", cols, slices, groups, per, 1, nbytes, (nsub, W, n_used, reps))


def l2_plan(nsub: int, W: int, n_used: int, reps: int, sms: int = H100_SMS) -> ReadPlan:
    """The l2 form: groups of at most L2_IDS ids, the reps split over CTAs
    up to four CTAs an SM."""
    tiles = -(-W // L2_COLS)
    per, groups = _split(n_used, max(1, -(-n_used // L2_IDS)))
    split = min(reps, 65_535, max(1, -(-4 * sms // (tiles * groups))))
    return ReadPlan("l2", L2_COLS, tiles, groups, per, split,
                    smem_bytes("l2", nsub, L2_COLS, per), (nsub, W, n_used, reps))


def read_plan(nsub: int, W: int, n_used: int, reps: int, sms: int = H100_SMS) -> ReadPlan:
    """The launch of `table_read` on a card of `sms` SMs: the shared form
    at the widest of SLICE_WIDTHS (no wider than W) that `shared_plan`
    takes, else the l2 form."""
    for cols in SLICE_WIDTHS:
        if cols > W and cols != 1:
            continue
        plan = shared_plan(nsub, W, n_used, reps, cols, sms)
        if plan is not None:
            return plan
    return l2_plan(nsub, W, n_used, reps, sms)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets_for(device, n: int) -> torch.Tensor:
    """The device's last-CTA tickets, one a slice, at least n: zero between
    calls (each call leaves them zero), so calls on one device go on one
    stream at a time."""
    t = _tickets.get(device.index)
    if t is None or t.numel() < n:
        t = _tickets[device.index] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return t


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

    T [nsub, W] float32; ids int32 (non-negative); launched on the card's
    `read_plan`. The sum of each rep is taken in a fixed order, so the
    result is deterministic."""
    if not on_cuda(T, ids):
        return table_read_plain(T, ids, reps, scale, n_used)
    nsub, W = T.shape
    n_used = ids.shape[0] if n_used is None else n_used
    check(T, "T", torch.float32)
    check(ids, "ids", torch.int32)
    if not 0 <= n_used <= ids.shape[0] or reps < 1:
        raise ValueError(f"n_used={n_used} of {ids.shape[0]} ids, reps={reps}")
    plan = read_plan(nsub, W, n_used, reps, _sms(T.device.index))
    args, out, _scratch = launch_args(T, ids, reps, scale, plan)
    KERNEL.launch(*args)
    return out


def launch_args(T, ids, reps, scale, plan):
    """The C entry point's arguments for `plan` (made for T's shape, these
    n_used and reps) on CUDA tensors T and ids (checked by the caller), the
    output, and the scratch, which the caller holds until the launch."""
    nsub, W = T.shape
    n_used = plan.shape[2]
    part = torch.empty(reps * plan.groups * W, dtype=torch.float32, device=T.device)
    out = torch.empty(W, dtype=torch.float32, device=T.device)
    Ts = (torch.empty(plan.slices * _round4(nsub * plan.cols), dtype=torch.float32,
                      device=T.device) if plan.form == "shared" else None)
    args = (ptr(T), ptr(ids), ptr(part), ptr(_tickets_for(T.device, plan.slices + 2)),
            ptr(out), ptr(Ts), n_used, nsub, W, reps, float(scale), FORMS[plan.form],
            plan.cols, plan.groups, plan.per_group, plan.rep_split, plan.smem_bytes)
    return args, out, (part, Ts)
