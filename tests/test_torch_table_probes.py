"""The port's table probes and their kernels' plain versions, on the CPU.

- P1-P3 (libfm_tpu_torch/studies/pallas_gather.py) against the studies'
  own Pallas kernels (studies/pallas_gather.py) run in interpret mode, at
  NSUB=64, NIDS=512, REPS=3: rtol 1e-5 for the sums (f32 sums taken in
  another order; P1's carry multiplies by 8 a rep), exact for P2 (the
  table_scatter adds each row's ones in the order of the TPU loop).
- P4 (studies/pallas_scatter.py port) against np.add.at, atol 1e-5.
- `longest_runs` (table_scatter's `max_run`) against a count by
  itertools.groupby.
  studies/probes/pallas_scatter.py runs its kernel at import, so it is
  not imported here; its own check is np.add.at (:68-72).
"""

import functools
import itertools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import studies.pallas_gather as jax_probes
from libfm_tpu_torch.kernels.table_read import table_read
from libfm_tpu_torch.kernels.table_scatter import longest_runs, table_scatter
from libfm_tpu_torch.studies import pallas_gather, pallas_scatter

NSUB, NIDS, REPS = 64, 512, 3


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("maker", ["make_read_kernel", "make_rmw_kernel",
                                   "make_take_kernel"])
@pytest.mark.parametrize("nids", [NIDS, NIDS - 3])
def test_probe_matches_pallas_interpret(interpret, maker, nids):
    import jax.numpy as jnp

    rng = np.random.default_rng(nids)
    T = rng.standard_normal((NSUB, 128)).astype(np.float32)
    ids = rng.integers(0, NSUB, nids).astype(np.int32)
    want = float(getattr(jax_probes, maker)(NSUB, nids, REPS)(jnp.asarray(ids),
                                                             jnp.asarray(T)))
    got = getattr(pallas_gather, maker)(NSUB, nids, REPS)(torch.as_tensor(ids),
                                                         torch.as_tensor(T))
    assert got.shape == ()
    if maker == "make_rmw_kernel":
        assert float(got) == want
    else:
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_read_probe_carries_eight_times_the_accumulator():
    """P1 computes acc_{r+1} = 8 acc_r + S_r, not a plain row sum."""
    rng = np.random.default_rng(1)
    T = torch.as_tensor(rng.standard_normal((NSUB, 128)), dtype=torch.float32)
    ids = torch.as_tensor(rng.integers(0, NSUB, NIDS).astype(np.int32))
    S = [T[(ids.long() + r) % NSUB].sum().item() for r in range(REPS)]
    want = (8 * 8 * S[0] + 8 * S[1] + S[2])
    got = pallas_gather.make_read_kernel(NSUB, NIDS, REPS)(ids, T).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(got - sum(S)) > 1.0


@pytest.mark.parametrize("W", [9, 16, 17, 128])
def test_table_scatter_is_a_sequential_scatter(W):
    """Heavy duplicates: every row gets its updates in sorted (= original,
    the sort being stable) order, as np.add.at adds them."""
    rng = np.random.default_rng(W)
    n, E = 40, 3000
    ids = np.minimum(rng.zipf(1.3, E) - 1, n - 1).astype(np.int32)
    upd = rng.standard_normal((E, W)).astype(np.float32)
    T0 = rng.standard_normal((n, W)).astype(np.float32)
    want = T0.copy()
    np.add.at(want, ids, upd)
    sids, perm = pallas_scatter.sorted_order(torch.as_tensor(ids))
    T = torch.as_tensor(T0.copy())
    out = table_scatter(T, sids, perm, torch.as_tensor(upd))
    assert out is T
    np.testing.assert_allclose(T.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["one_run", "uniform", "zipf", "one_entry"])
def test_longest_runs_counts_each_row(layout):
    """Each row's longest run of equal sorted ids, from a stack of rows
    (numpy) and from one row (a tensor)."""
    rng = np.random.default_rng(3)
    E = 1 if layout == "one_entry" else 5000
    rows = []
    for _ in range(4):
        if layout == "one_run":
            ids = np.full(E, 11)
        elif layout == "zipf":
            ids = np.minimum(rng.zipf(1.2, E) - 1, 999)
        else:
            ids = rng.integers(0, 4000, E)
        rows.append(np.sort(ids).astype(np.int32))
    stack = np.stack(rows)
    want = [max(len(list(g)) for _, g in itertools.groupby(r)) for r in rows]
    got = longest_runs(stack)
    assert got.shape == (4,) and got.tolist() == want
    assert int(longest_runs(torch.as_tensor(rows[0]))) == want[0]


def test_p4_run_matches_np_add_at():
    rng = np.random.default_rng(0)
    N, W, E = 2048, pallas_scatter.W, 4096
    ids = rng.integers(0, N, E).astype(np.int32)
    upd = rng.standard_normal((E, W)).astype(np.float32)
    P = rng.standard_normal((N, W)).astype(np.float32)
    want = P.copy()
    np.add.at(want, ids, upd)
    Pt = torch.as_tensor(P)
    out = pallas_scatter.run(torch.as_tensor(ids), Pt, torch.as_tensor(upd))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(Pt.numpy(), P)  # run leaves P as it was


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_table_read_recurrence(scale):
    rng = np.random.default_rng(2)
    T = rng.standard_normal((50, 7))
    ids = rng.integers(0, 50, 300).astype(np.int32)
    acc = np.zeros(7)
    for r in range(4):
        acc = scale * acc + T[(ids[:260].astype(np.int64) + r) % 50].sum(axis=0)
    got = table_read(torch.as_tensor(T), torch.as_tensor(ids), 4, scale, n_used=260)
    np.testing.assert_allclose(got.numpy(), acc, rtol=1e-12)


def test_probes_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (pallas_gather, pallas_scatter):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()
