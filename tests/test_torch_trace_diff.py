"""studies/trace_diff.py on two small chrome traces written here: the
activities of an iteration are those starting in its device range (or
its host range where the trace has no device range), lined up by name in
launch order, and only the ones one side lacks are counted."""

import json

import pytest

from libfm_tpu_torch.studies import trace_diff


def trace(tmp_path, name, kernels, device_range=True):
    evs = [dict(ph="X", cat="user_annotation", name="iteration 1", ts=0, dur=1000)]
    if device_range:
        evs.append(dict(ph="X", cat="gpu_user_annotation", name="iteration 1", ts=100,
                        dur=1000))
    # one kernel of iteration 0 before the range and one of iteration 2 after it
    evs += [dict(ph="X", cat="kernel", name="early", ts=-50, dur=5),
            dict(ph="X", cat="kernel", name="late", ts=1200, dur=5)]
    for i, (nm, dur) in enumerate(kernels):
        evs.append(dict(ph="X", cat="kernel", name=nm, ts=150 + 100 * i, dur=dur,
                        args=dict(grid=[i + 1, 1, 1])))
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(dict(traceEvents=evs)))
    return str(path)


@pytest.mark.parametrize("device_range", [True, False])
def test_trace_diff_counts_only_the_launches_one_side_lacks(tmp_path, device_range):
    old = trace(tmp_path, "old", [("gemm", 40), ("reduce", 7), ("mul", 3), ("reduce", 6),
                                  ("draw", 20)], device_range)
    new = trace(tmp_path, "new", [("gemm", 41), ("draw", 19), ("sum_partials", 2)],
                device_range)
    rec = trace_diff.diff(old, new, 1)
    assert rec["old"]["activities"] == 5 and rec["new"]["activities"] == 3
    assert [e["name"] for e in rec["removed"]] == ["reduce", "mul", "reduce"]
    assert [e["grid"] for e in rec["removed"]] == [[2, 1, 1], [3, 1, 1], [4, 1, 1]]
    assert rec["removed_ms"] == pytest.approx(0.016)
    assert [e["name"] for e in rec["added"]] == ["sum_partials"]
    assert rec["added_ms"] == pytest.approx(0.002)
    assert rec["old"]["device_ms"] == pytest.approx(0.076)
