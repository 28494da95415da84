"""Where table_read's shared form spends its time, phase by phase, on the
card.

Builds csrc/table_read.cu alone with -DTABLE_READ_TIMING (thread 0 of
each CTA writes the global timer at each phase) into
libfm_tpu_torch/build/timing/, runs probe P1's shape (scale 8) on the
shared form of read_plan, and prints the call's device time and each
phase's median and largest duration over the CTAs, in µs, as one JSON
line.

    python -m libfm_tpu_torch.studies.table_read_phases   # on a CUDA card
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess

import numpy as np
import torch

from libfm_tpu_torch import kernels
from libfm_tpu_torch.kernels import table_read as tr
from libfm_tpu_torch.studies.pallas_gather import NIDS, NSUB, REPS, UNROLL
from libfm_tpu_torch.utils.timers import device_ms

#: the stamps' phases, in order (csrc: STAMP(0) .. STAMP(6))
PHASES = ("fill: transpose",
          "fill: grid barrier, slice copies issued; ids in",
          "ids in bank order",
          "fill: waiting for the slice",
          "lookups",
          "finish")
STAMPS = 8  # csrc: kStamps


def timing_library() -> ctypes.CDLL:
    out = kernels.BUILD_ROOT / "timing"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "table_read_timing.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DTABLE_READ_TIMING", "-shared",
                    "-o", str(so), str(kernels.CSRC_DIR / "table_read.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.table_read_launch.argtypes = tr.KERNEL.argtypes + [ctypes.c_void_p]
    lib.table_read_launch.restype = ctypes.c_int
    lib.table_read_stamps.argtypes = [ctypes.c_void_p]
    return lib


def main(nsub=NSUB, nids=NIDS, reps=REPS):
    if not torch.cuda.is_available():
        raise RuntimeError("the phase study measures a CUDA card; none is available")
    dev = torch.device("cuda")
    lib = timing_library()
    rng = np.random.default_rng(0)
    T = torch.as_tensor(rng.standard_normal((nsub, 128)), dtype=torch.float32, device=dev)
    ids = torch.as_tensor(rng.integers(0, nsub, nids).astype(np.int32), device=dev)
    n_used, scale = nids // UNROLL * UNROLL, float(UNROLL)
    want = tr.table_read_plain(T, ids, reps, scale, n_used)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = tr.read_plan(nsub, 128, n_used, reps, sms)
    args, out, _scratch = tr.launch_args(T, ids, reps, scale, plan)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.table_read_launch(*args, stream)
        if err:
            raise RuntimeError(f"table_read: cudaError {err}")

    lib.table_read_stamps(None)
    ms = device_ms(call)
    stamps = torch.zeros(plan.slices * plan.groups * STAMPS, dtype=torch.int64, device=dev)
    lib.table_read_stamps(ctypes.c_void_p(stamps.data_ptr()))
    call()
    torch.cuda.synchronize()
    lib.table_read_stamps(None)
    err = ((out - want).abs().max() / want.abs().max()).item()
    t = stamps.view(-1, STAMPS)[:, :len(PHASES) + 1].cpu().numpy() / 1e3
    d = np.diff(t, axis=1)
    rec = dict(plan=dataclasses.asdict(plan), ms=ms, rel_err=err,
               span_us=float(t[:, -1].max() - t[:, 0].min()),
               phases_us={name: [float(np.median(d[:, k])), float(d[:, k].max())]
                          for k, name in enumerate(PHASES)})
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
