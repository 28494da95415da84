"""Convert libFM text data to the binary .x / .y format.

The port's copy of `libfm_tpu.tools.convert`, libFM's `convert` tool
(src/libfm/tools/convert.cpp:55-205): the same flags and the same files,
which `python -m libfm_tpu_torch.cli` (and libFM) then read as `-train
<prefix>` / `-test <prefix>`:

    python -m libfm_tpu_torch.tools.convert --ifile data.libfm \\
        --ofilex data.x --ofiley data.y
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="libfm-torch-convert")
    p.add_argument("--ifile", required=True, help="input libFM text file")
    p.add_argument("--ofilex", required=True, help="output binary sparse matrix")
    p.add_argument("--ofiley", required=True, help="output binary targets")
    args = p.parse_args(argv)

    import numpy as np

    from libfm_tpu_torch.data import binary as binio
    from libfm_tpu_torch.data.text import parse_libfm_text

    indptr, cols, vals, target, num_features = parse_libfm_text(args.ifile)
    print(
        f"num_rows={len(target)}\tnum_values={int(indptr[-1])}\t"
        f"num_features={num_features}\t"
        f"min_target={target.min() if len(target) else 0}\t"
        f"max_target={target.max() if len(target) else 0}"
    )
    binio.write_sparse_binary(args.ofilex, indptr, cols, vals, num_features)
    binio.write_dvector_binary(args.ofiley, np.asarray(target, dtype=np.float32))
    return 0


if __name__ == "__main__":
    sys.exit(main())
