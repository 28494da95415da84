"""How far `schur_draw`'s draws lie from float64 on the BS engine's
systems, beside `schur_draw_plain`'s, and what a launch costs at k = 128.

A relation of 64 block rows of 6 valued entries over 150 features,
joined by 3,000 cases (row 0 by most), with random theta, A and SD
(numpy, seed 2); each conflict-free block's statistics GG come from
`rel_stats_plain`, its draws (prior 4, alpha 1.5, noise from seed 3)
from the kernel, from `schur_draw_plain` on the card and on the CPU, and,
as the float32 floor, from the system S and right-hand side formed in
float32 and solved in float64. Each is held to the float64 draw from the
same GG, in standard deviations of the posterior those statistics give
(root mean square and largest over the features). Then `schur_draw`
on 20,000 systems tiled from the k = 128 blocks, sampling, timed by
CUDA events. Prints one JSON line.

    python -m libfm_tpu_torch.studies.schur_draw_accuracy   # on a CUDA card
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from libfm_tpu_torch.data.relation import RelationData, RelationJoin
from libfm_tpu_torch.kernels import rel_sweep as rs
from libfm_tpu_torch.kernels import schur_draw as sd
from libfm_tpu_torch.kernels.rel_cache import rel_cache_plain
from libfm_tpu_torch.learners.mcmc_rel_vector import DevRel, RelLayout
from libfm_tpu_torch.ops.lane_chol import cholesky_lanes, solve_lower_lanes, solve_upper_lanes
from libfm_tpu_torch.utils.timers import device_ms

KS = (32, 64, 128)
NB, W, NF, NC = 64, 6, 150, 3000
LAM, ALPHA = 4.0, 1.5
TIMED_SYSTEMS = 20_000


def relation_state(dev, k):
    """(layout, its device copy, P, C, SD) of the study's relation."""
    rng = np.random.default_rng(2)
    cols = np.stack([np.sort(rng.choice(NF - 1, W, replace=False)) for _ in range(NB)])
    cols[2, -1] = NF - 1
    rd = RelationData(np.arange(NB + 1) * W, cols.ravel(), rng.normal(0, 1, NB * W), NF)
    heavy = int(15.5 * NC / NB)
    m = np.concatenate([np.zeros(heavy, np.int64), rng.integers(2, NB, NC - heavy)])
    join = RelationJoin(rd, rng.permutation(m).astype(np.int32))
    lay = RelLayout(join, join, np.zeros(NF, np.int32), NF)
    rel = DevRel(lay, dev)
    P = torch.as_tensor(rng.normal(0, 0.5, (NF, k + 1)), dtype=torch.float32, device=dev)
    A = torch.as_tensor(rng.normal(0, 1, (NC, k + 1)), dtype=torch.float32, device=dev)
    C = rel_cache_plain(A, rel.case_off, rel.case_ids)
    SD = torch.as_tensor(rng.normal(0, 0.3, (NB + 1, k + 1)), dtype=torch.float32, device=dev)
    SD[NB] = 0.0
    return lay, rel, P, C, SD


def posterior_sd_units(diff, GG, lam, alpha):
    """sqrt(d^T Lam d) [F] for each row d of `diff` [F, k+1], Lam = alpha
    H^T H + diag(lam) from the statistics GG (float64)."""
    F, d1 = diff.shape
    k = d1 - 1
    T = k * (k + 1) // 2
    lam = lam.double()
    L = torch.zeros(F, d1, d1, dtype=torch.float64, device=diff.device)
    L[:, 0, 0] = alpha * GG[:, T + 2 * k] + lam[:, 0]
    L[:, 0, 1:] = alpha * GG[:, T:T + k]
    L[:, 1:, 0] = alpha * GG[:, T:T + k]
    L[:, 1:, 1:] = alpha * sd.unpack_sym(GG, k) + torch.diag_embed(lam[:, 1:])
    diff = diff.double()
    return torch.einsum("fi,fij,fj->f", diff, L, diff).clamp_min(0).sqrt()


def floor_draw(GG, theta, lam, mu, z, alpha):
    """The draw with S and b formed in float32 and solved in float64."""
    S, b0, bv, s0, col = sd.schur_system(GG, theta, lam, mu, alpha)
    S, b0, bv, s0, col, z = (x.double() for x in (S, b0, bv, s0, col, z))
    L = cholesky_lanes(S)
    y0 = b0 / s0 + z[:, 0]
    yv = solve_lower_lanes(L, bv - col * (b0 / s0)[:, None]) + z[:, 1:]
    xv = solve_upper_lanes(L, yv)
    return torch.cat([((y0 - (col * xv).sum(-1)) / s0)[:, None], xv], 1)


def study(dev):
    out = {"accuracy": []}
    G128 = None
    for k in KS:
        _, rel, P, C, SD = relation_state(dev, k)
        d = k + 1
        alpha = torch.tensor(ALPHA, device=dev)
        gen = np.random.default_rng(3)
        units = {n: [] for n in ("kernel", "plain_card", "plain_cpu", "float32_floor")}
        grams = []
        for blk in rel.blocks:
            GG = rs.rel_stats_plain(C, SD, rel.wnum, blk.feat_off, blk.entry_b, blk.entry_x,
                                    blk.feat_id, P)
            th = P[blk.features]
            lam = torch.full((blk.F, d), LAM, device=dev)
            mu = torch.zeros(blk.F, d, device=dev)
            z = torch.as_tensor(gen.normal(size=(blk.F, d)), dtype=torch.float32, device=dev)
            kw = dict(do_sample=True, bound=1e6)
            t64, _ = sd.schur_draw_plain(GG.double(), th.double(), lam.double(), mu.double(),
                                         z.double(), alpha.double(), **kw)
            cpu = [x.cpu() for x in (GG, th, lam, mu, z, alpha)]
            draws = {"kernel": sd.schur_draw(GG, th, lam, mu, z, alpha, **kw)[0],
                     "plain_card": sd.schur_draw_plain(GG, th, lam, mu, z, alpha, **kw)[0],
                     "plain_cpu": sd.schur_draw_plain(*cpu, **kw)[0].to(dev),
                     "float32_floor": floor_draw(GG, th, lam, mu, z, alpha)}
            for name, x in draws.items():
                units[name].append(posterior_sd_units(x - t64, GG.double(), lam, ALPHA))
            grams.append(GG)
            P[blk.features] = draws["kernel"]
        row = {"k": k, "features": int(sum(b.F for b in rel.blocks))}
        for name, u in units.items():
            u = torch.cat(u)
            row[name] = {"rms": u.square().mean().sqrt().item(), "max": u.max().item()}
        out["accuracy"].append(row)
        if k == 128:
            G128 = torch.cat(grams)
    g = torch.Generator(device=dev).manual_seed(4)
    idx = torch.arange(TIMED_SYSTEMS, device=dev) % G128.shape[0]
    GG = G128[idx].contiguous()
    d = 129
    th = 0.1 * torch.randn(TIMED_SYSTEMS, d, generator=g, device=dev)
    z = torch.randn(TIMED_SYSTEMS, d, generator=g, device=dev)
    lam = torch.full((TIMED_SYSTEMS, d), LAM, device=dev)
    mu = torch.zeros(TIMED_SYSTEMS, d, device=dev)
    alpha = torch.tensor(ALPHA, device=dev)
    out["timed"] = {"k": 128, "systems": TIMED_SYSTEMS, "ms": device_ms(
        lambda: sd.schur_draw(GG, th, lam, mu, z, alpha, do_sample=True, bound=1e6),
        reps=20)}
    return out


def main():
    if not torch.cuda.is_available():
        print("schur_draw_accuracy: no CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(dev), **study(dev)}))


if __name__ == "__main__":
    main()
