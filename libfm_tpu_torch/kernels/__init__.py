"""Hand-written CUDA kernels of the port: build, loader, launch counters.

Every kernel's CUDA C++ source lives in `libfm_tpu_torch/csrc/*.cu`,
with a plain C entry point that launches on the caller's stream and
returns `cudaGetLastError()`. At first use the sources are compiled with
nvcc for sm_90a, one nvcc process per source started together, and
linked into one shared library under `libfm_tpu_torch/build/<hash>/`
(keyed by a hash of the sources and flags, listed in .gitignore). The
library is loaded with ctypes; nothing here includes PyTorch's headers,
so a build takes seconds.

Importing this package (or any kernel module) needs no nvcc, no CUDA
and no GPU: the build runs only when a wrapper is first asked to launch
a kernel on a CUDA tensor. On a CPU tensor each wrapper runs its plain
PyTorch version instead, and only then.

Each kernel module holds a `Kernel` whose `launches` counter its wrapper
adds one to per kernel launch; `reset_launch_counts()` and
`launch_counts()` let a caller show that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lib = None
#: name -> Kernel, in registration order
REGISTRY: dict = {}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
        "built from libfm_tpu_torch/csrc at first use"
    )


def build_dir() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu (one nvcc per source, all started together) and
    link them into one shared library; return its path. A finished build
    for the same sources is reused."""
    out_dir = build_dir()
    so = out_dir / "libfm_tpu_kernels.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for src, _obj, p in procs:
            log, _ = p.communicate()
            if verbose or p.returncode:
                print(f"--- nvcc {src.name} (rc {p.returncode})\n{log}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so),
             *[str(obj) for _s, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


class Kernel:
    """One CUDA kernel's C entry point and its launch counter. A second
    entry point of the same kernel (another form of it) passes
    `count_as`, the Kernel whose counter its launches add to; it is not
    registered apart. A form that also does another kernel's work passes
    `also_counts`, the Kernels whose counters each launch adds one to
    besides its own."""

    def __init__(self, name: str, symbol: str, argtypes: list, count_as=None,
                 also_counts=()):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._counters = (count_as or self, *also_counts)
        if count_as is None:
            REGISTRY[name] = self

    def launch(self, *args) -> None:
        """Call the C entry point on the current CUDA stream; raise if the
        launch was refused. Counts one launch."""
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {err}"
            )
        for counter in self._counters:
            counter.launches += 1


def reset_launch_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in REGISTRY.items()}


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises for a mix or another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs on devices {sorted(kinds)}")


def check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless `t` is contiguous, of `dtype` and (where given) of
    `shape` — what the CUDA kernels take."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise unless `t` starts on a 16-byte boundary: the bulk copies
    (TMA) of `dense_update` and `fm_refresh` move whole 16-byte pieces."""
    if t.data_ptr() % 16:
        raise ValueError(
            f"{name}: data starts {t.data_ptr() % 16} bytes past a 16-byte "
            f"boundary (a view at an offset); pass a fresh tensor"
        )


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


#: the widths `slot_stats` and `schur_draw` are compiled for
PADDED_WIDTHS = (16, 32, 64, 128)


def padded_width(k: int, min_k: int = 1) -> int:
    """The compile-time width a k-factor system runs at in `slot_stats`,
    `schur_draw` and the BS kernels: the smallest of PADDED_WIDTHS that
    holds k. The flat engine's kernels pass min_k = 0 (the pure linear
    model runs at the first width); the BS kernels keep k >= 1."""
    for kp in PADDED_WIDTHS:
        if min_k <= k <= kp:
            return kp
    raise ValueError(f"k={k}: these CUDA kernels take {min_k} <= k <= {PADDED_WIDTHS[-1]}")


def import_all() -> dict:
    """Import every kernel module so REGISTRY lists them all."""
    from libfm_tpu_torch.kernels import (  # noqa: F401
        case_stats, coord_draw, dense_update, dual_draw, fm_refresh, probit_latent, rel_cache,
        rel_refresh, rel_sweep, schur_draw, sgd_step, sgda_lambda, sgda_step, slot_stats,
        slot_update, table_read, table_scatter,
    )

    return REGISTRY
