"""Tracing and memory reports (the CLI's -profile and -verbosity).

The port's counterpart of `libfm_tpu.utils.profiling`. libFM observes a
run through its timers (src/util/util.h:71-90) and a byte-counting
MemoryLog (src/util/memory.h:31-62); here:

- `trace(dir)`: a context manager that runs its body under
  torch.profiler (the CPU, and CUDA where the card is present) and
  writes a chrome trace into `dir` (CLI: `-profile DIR`);
- `device_memory_stats()`: the caching allocator's counters of each CUDA
  device (`torch.cuda.memory_stats`); none without CUDA;
- `peak_memory_report()` / `print_peak_memory_report()`: the host's peak
  RSS (`host_peak_rss_bytes`, the process's own VmHWM) and those
  counters, printed one line each.

Per-iteration timing lives in `utils.timers` (iter_clocks feeds the rlog
time_* fields).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; on exit write `log_dir/trace_<pid>_<ns>.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_stats() -> list[dict]:
    """bytes_in_use, peak_bytes_in_use and bytes_limit (the card's total
    memory) of each CUDA device; an empty list without CUDA."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append(dict(
            device=f"cuda:{i} ({torch.cuda.get_device_name(i)})",
            bytes_in_use=s.get("allocated_bytes.all.current", 0),
            peak_bytes_in_use=s.get("allocated_bytes.all.peak", 0),
            bytes_limit=torch.cuda.get_device_properties(i).total_memory,
        ))
    return out


def host_peak_rss_bytes() -> int:
    """This process's peak resident set in bytes: VmHWM of
    /proc/self/status where there is one (Linux), the high-water mark of
    the process's own memory since it started its program; else
    ru_maxrss. On Linux ru_maxrss also keeps the mark of the process it
    was forked from, so a small child of a large parent would read the
    parent's size."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KiB on Linux, bytes on macOS
    return int(ru) * (1 if ru > 1 << 34 else 1024)


def peak_memory_report() -> dict:
    """The host's peak RSS in bytes and the CUDA devices' counters."""
    return dict(host_peak_rss_bytes=host_peak_rss_bytes(), devices=device_memory_stats())


def print_peak_memory_report() -> dict:
    """Print the report one counter a line (`#mem ...`) and return it."""
    rep = peak_memory_report()
    print(f"#mem host_peak_rss_bytes={rep['host_peak_rss_bytes']}")
    for d in rep["devices"]:
        print(
            f"#mem device={d['device']} "
            f"peak_bytes_in_use={d['peak_bytes_in_use']} "
            f"bytes_in_use={d['bytes_in_use']}"
        )
    return rep
