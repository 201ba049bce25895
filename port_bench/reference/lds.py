"""The sampler the path-traced cells are defined with: the Roberts R_d
low-discrepancy sequence.

For D dimensions, phi_D is the positive root of x^(D+1) = x + 1 and
alpha_d = phi_D^-(d+1). The sample of offset n in dimension d is
frac(0.5 + alpha_d (n + 1)). The offsets are small whole numbers (below
2^24 at the cells' sizes), so the product is exact to about 1e-11 in
float64, well inside the 2^-24 that a float32 sample resolves.
"""

from __future__ import annotations

import torch

__all__ = ["alphas", "sample"]


def _phi(dimension: int) -> float:
    """Positive root of x^(D+1) = x + 1 by the fixed-point iteration
    x <- (1 + x)^(1/(D+1)) from 2, to its float64 fixpoint."""
    p = 1.0 / (dimension + 1.0)
    x = 2.0
    while True:
        nxt = (1.0 + x) ** p
        if nxt == x:
            return x
        x = nxt


def alphas(dimension: int) -> list[float]:
    """alpha_d = phi_D^-(d+1) for d in [0, D)."""
    p = _phi(dimension)
    return [p ** -(d + 1.0) for d in range(dimension)]


def sample(offset: torch.Tensor, alpha: float) -> torch.Tensor:
    """frac(0.5 + alpha (offset + 1)) in float64; offset: int64 tensor."""
    x = 0.5 + alpha * (offset.to(torch.float64) + 1.0)
    return x - torch.floor(x)
