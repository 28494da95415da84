"""Step timing helpers (libFM src/util/util.h:71-90) and the device
timer of the port's measurement scripts."""

from __future__ import annotations

import resource
import statistics
import time

import torch


def iter_clocks(device) -> tuple[float, float, float]:
    """Snapshot of (user-CPU s, process-CPU s, wall s) — libFM's
    getusertime / clock() / getusertime4 triple, which feeds the rlog
    time_learn / time_learn2 / time_learn4 fields. A CUDA `device` is
    synchronised first, so the wall clock covers the queued kernels.
    Subtract two snapshots."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return (
        resource.getrusage(resource.RUSAGE_SELF).ru_utime,
        time.process_time(),
        time.perf_counter(),
    )


def device_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of the device work `fn` enqueues, over `reps`
    runs timed with CUDA events after `warmup` untimed runs. A sleep
    kernel that outlasts the host's enqueueing of `fn` runs before each
    timed run, so the time covers the device alone: no host gaps between
    short launches, and no host overhead before the first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))  # cycles: ~2 GHz clock
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
