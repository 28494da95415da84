"""Batched Cholesky and triangular solves for many small SPD systems —
the plain PyTorch versions.

On the TPU, `libfm_tpu.ops.lane_chol` lays the batch out in the vector
lanes because XLA's batched factorization ran far above the VPU floor
for tiny systems. On the GPU the factorization and the solves are fused
into the `schur_draw` and `dual_draw` kernels (`csrc/schur_draw.cu`,
`csrc/dual_draw.cu`); these functions are the plain versions the CPU
tests and those kernels' plain paths use.

Semantics match `cholesky_lanes` / `solve_lower_lanes` /
`solve_upper_lanes` / `cho_solve_lanes` on SPD inputs. A system that is not positive
definite gives NaN rows (the lane Cholesky takes the square root of a
negative pivot), so the engine's finite guard rejects the draw instead
of the factorization raising.
"""

from __future__ import annotations

import torch


def cholesky_lanes(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of [C, W, W] SPD matrices; NaN systems where
    a matrix is not positive definite."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0).view(-1, 1, 1)
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def solve_lower_lanes(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b. L: [C, W, W] lower-triangular, b: [C, W]."""
    return torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)[..., 0]


def solve_upper_lanes(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y. L: [C, W, W] lower-triangular, y: [C, W]."""
    return torch.linalg.solve_triangular(
        L.transpose(-1, -2), y.unsqueeze(-1), upper=True
    )[..., 0]


def cho_solve_lanes(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given the lower Cholesky factor L [C, W, W]; b: [C, W]."""
    return solve_upper_lanes(L, solve_lower_lanes(L, b))
