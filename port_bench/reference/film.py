"""The film of the path-traced cells: every sample lands on its own pixel,
the per-pixel radiance sums are filtered by a 3x3 binomial stencil with
zero padding, and the image is sqrt(filtered / spp).

The stencil is the order-5 binomial [1, 4, 6, 4, 1] box-integrated onto
three pixels: each pixel takes the share of the five coefficients that
falls in its third of the width, (11, 26, 11) / 48, worked out exactly
with fractions.
"""

from __future__ import annotations

from fractions import Fraction
from math import comb

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["stencil_1d", "develop"]


def stencil_1d(order: int = 5, width: int = 3) -> np.ndarray:
    """The binomial(order) coefficients box-integrated onto `width` cells
    of equal size, normalised to sum 1."""
    coef = [Fraction(comb(order - 1, k)) for k in range(order)]
    cells = []
    for i in range(width):
        lo, hi = Fraction(i * order, width), Fraction((i + 1) * order, width)
        w = Fraction(0)
        for k in range(order):  # coefficient k covers [k, k + 1)
            overlap = min(hi, k + 1) - max(lo, k)
            if overlap > 0:
                w += overlap * coef[k]
        cells.append(w)
    total = sum(cells)
    return np.array([float(c / total) for c in cells])


def develop(sums: torch.Tensor, spp: int) -> torch.Tensor:
    """(H, W, 3) radiance sums -> the image, sqrt(stencil * sums / spp)."""
    k1 = torch.as_tensor(stencil_1d(), dtype=sums.dtype, device=sums.device)
    k2 = (k1[:, None] * k1[None, :]).expand(3, 1, 3, 3)
    x = sums.permute(2, 0, 1)[None]
    y = F.conv2d(x, k2.contiguous(), padding=1, groups=3)[0].permute(1, 2, 0)
    return torch.sqrt(torch.clamp(y / spp, min=0.0))
