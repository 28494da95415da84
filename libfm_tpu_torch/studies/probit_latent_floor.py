"""The floor that probit_latent's memory access sets on the card.

probit_latent (csrc/probit_latent.cu, config #4's fast path) reads and
writes e, column 0 of A = [e | Q] [nc, k+1], and reads latent, y and U
and writes latent [nc]. Its row's bound counts 4 bytes of e a case, but
e is strided: each read and write of it moves whole sectors of A's
68-byte rows. This study builds `probit_latent_floor.cu` (beside this
file) into libfm_tpu_torch/build/probit_floor/ and times, at config #4's
shape (1.8M cases, k = 16), CUDA events, the median of `reps`:

- `column`: a bare read-modify-write of A's column 0 plus the vectors'
  traffic, one case a thread, on probit_latent's grid (1,024 CTAs of
  256) and on a grid of one case a thread (`column_full_grid`): the
  kernel's traffic without its math;
- `vector`: the same with e as a contiguous [nc] vector: the 4-byte
  bound's traffic;
- `rows`: every float of A read and written (16 bytes a thread) beside
  the vectors: A streamed whole;
- `probit_latent`: the kernel itself (sampling), on the same tensors.

Prints one JSON line with each time, the 4-byte bound and the card.

    python -m libfm_tpu_torch.studies.probit_latent_floor   # on a CUDA card
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from libfm_tpu_torch import kernels
from libfm_tpu_torch.kernels import probit_latent as pl
from libfm_tpu_torch.utils.timers import device_ms

#: config #4's train cases and width (k = 16)
NC, D = 1_800_000, 17
#: probit_latent's grid (kernels/probit_latent.py _PARTS)
GRID = 1024
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def floor_library() -> ctypes.CDLL:
    out = kernels.BUILD_ROOT / "probit_floor"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "probit_floor.so"
    src = Path(__file__).with_name("probit_latent_floor.cu")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.probit_floor_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    lib.probit_floor_launch.restype = ctypes.c_int
    return lib


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
                          capture_output=True, text=True).stdout.strip()


def main(nc=NC, d=D, reps=20):
    if not torch.cuda.is_available():
        raise RuntimeError("the floor study measures a CUDA card; none is available")
    dev = torch.device("cuda")
    lib = floor_library()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    A = torch.randn(nc, d, generator=g, device=dev)
    e = A[:, 0].contiguous()
    latent = torch.randn(nc, generator=g, device=dev)
    y = torch.where(torch.rand(nc, generator=g, device=dev) < 0.5, -1.0, 1.0)
    U = torch.rand(nc, generator=g, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def floor(t, width, grid, rows=0):
        def call():
            err = lib.probit_floor_launch(t.data_ptr(), width, latent.data_ptr(), y.data_ptr(),
                                          U.data_ptr(), nc, grid, rows, stream)
            if err:
                raise RuntimeError(f"probit_floor: cudaError {err}")
        return call

    full_grid = -(-nc // 256)
    part = torch.empty(3, GRID, device=dev)  # the count's and the two sums' partials
    times = {
        "column": device_ms(floor(A, d, GRID), reps),
        "column_full_grid": device_ms(floor(A, d, full_grid), reps),
        "vector": device_ms(floor(e, 1, GRID), reps),
        "rows": device_ms(floor(A, d, GRID, rows=1), reps),
        "probit_latent": device_ms(
            lambda: pl.KERNEL.launch(A.data_ptr(), d, latent.data_ptr(), y.data_ptr(),
                                     U.data_ptr(), nc, 1, part.data_ptr(), GRID), reps),
    }
    torch.cuda.synchronize()
    bound_bytes = nc * (2 * 4 + 3 * 4 + 4)  # e read and written; latent, y, U; latent
    rec = dict(card=card(), kind=torch.cuda.get_device_name(0), nc=nc, d=d, grid=GRID,
               ms=times, bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
               rows_bytes_ms=(nc * d * 8 + nc * 16) / PEAK_BYTES_PER_S * 1e3)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
