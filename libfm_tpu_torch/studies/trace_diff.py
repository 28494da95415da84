"""The device work one traced learner run does and another does not, from
the chrome traces that `chip_smoke.py --profile DIR` writes
(DIR/trace_<name>.json).

For each iteration asked for, the device activities (kernels, memsets,
copies) that start inside the run's "iteration N" range are lined up by
name in launch order (difflib); those only the first trace has are
"removed", those only the second has "added". Prints one JSON line: for
each iteration the launches and device ms of each side, the removed and
added activities (name, grid, µs) and their device-ms sums.

    python -m libfm_tpu_torch.studies.trace_diff OLD.json NEW.json [--iterations 1,2]
"""

from __future__ import annotations

import argparse
import difflib
import json

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def iteration_activities(path: str, iteration: int) -> list[dict]:
    """The device activities of `iteration` in launch order."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    name = f"iteration {iteration}"
    ranges = {e.get("cat"): e for e in evs if e.get("ph") == "X" and e.get("name") == name}
    rng = ranges.get("gpu_user_annotation") or ranges["user_annotation"]
    lo, hi = rng["ts"], rng["ts"] + rng["dur"]
    acts = [e for e in evs if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and lo <= e["ts"] < hi]
    return sorted(acts, key=lambda e: e["ts"])


def brief(e: dict) -> dict:
    return dict(name=e["name"][:90], grid=e.get("args", {}).get("grid"), us=e["dur"])


def diff(old: str, new: str, iteration: int) -> dict:
    a, b = iteration_activities(old, iteration), iteration_activities(new, iteration)
    sm = difflib.SequenceMatcher(None, [e["name"] for e in a], [e["name"] for e in b],
                                 autojunk=False)
    removed, added = [], []
    for tag, i0, i1, j0, j1 in sm.get_opcodes():
        if tag in ("delete", "replace"):
            removed += a[i0:i1]
        if tag in ("insert", "replace"):
            added += b[j0:j1]
    return dict(
        old=dict(activities=len(a), device_ms=sum(e["dur"] for e in a) / 1e3),
        new=dict(activities=len(b), device_ms=sum(e["dur"] for e in b) / 1e3),
        removed_ms=sum(e["dur"] for e in removed) / 1e3,
        added_ms=sum(e["dur"] for e in added) / 1e3,
        removed=[brief(e) for e in removed], added=[brief(e) for e in added])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--iterations", default="1,2")
    args = ap.parse_args(argv)
    rec = {f"iteration {it}": diff(args.old, args.new, int(it))
           for it in args.iterations.split(",")}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
