"""Film reconstruction: binomial filter and gamma.

Port of pathtracer_tpu/film.py. Every sample lands on its own pixel (the
jitter is in [0, 1) and the film splat truncates), so the reconstruction is
one fixed 3x3 stencil over the per-pixel radiance sums: a depthwise
convolution with zero padding, then sqrt(x / spp).

binomial_kernel_1d/_2d are copies of the JAX package's (exact rational
resampling with fractions.Fraction).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["binomial_kernel_1d", "binomial_kernel_2d", "apply_filter",
           "finalize"]


def _binomial_coeffs(order: int):
    """[C(order-1, k) for k in 0..order-1]."""
    c, out = 1, []
    n = order - 1
    for k in range(order):
        out.append(c)
        c = c * (n - k) // (k + 1)
    return out


def binomial_kernel_1d(order: int, pixel_radius: int) -> np.ndarray:
    """Resample binomial(order) coefficients to width 2r+1 with exact rational
    box-integration, then normalize."""
    assert pixel_radius >= 0
    f_width = 1 + 2 * pixel_radius
    ratio = Fraction(order, f_width)
    coeffs = _binomial_coeffs(order)
    w = []
    for i in range(f_width):
        i_p = i * ratio
        j_p = i_p + ratio
        beg = i_p.numerator // i_p.denominator  # floor
        end = -((-j_p.numerator) // j_p.denominator)  # ceil
        length = end - beg
        total = Fraction(0)
        for k in range(length):
            if k == 0:
                weight = 1 - (i_p - beg)  # 1 - frac(i')
            elif k == length - 1:
                weight = 1 - (end - j_p)
            else:
                weight = Fraction(1)
            total += weight * coeffs[k + beg]
        w.append(total)
    s = sum(w)
    return np.array([float(x / s) for x in w], dtype=np.float64)


def binomial_kernel_2d(order: int, pixel_radius: int) -> np.ndarray:
    k = binomial_kernel_1d(order, pixel_radius)
    return np.outer(k, k)


def apply_filter(sums: torch.Tensor, kernel_2d) -> torch.Tensor:
    """Convolve per-pixel radiance sums (H, W, 3) with the (odd-sized)
    reconstruction kernel, zero padding. cuDNN would run a float32
    convolution in TF32 by default; the JAX package forces full float32
    (Precision.HIGHEST), so TF32 is off here."""
    k = torch.as_tensor(kernel_2d, dtype=sums.dtype, device=sums.device)
    kh, kw = k.shape
    x = sums.permute(2, 0, 1)[None]  # (1, 3, H, W)
    w = k.expand(3, 1, kh, kw).contiguous()  # one filter per channel
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        y = F.conv2d(x, w, padding=(kh // 2, kw // 2), groups=3)
    return y[0].permute(1, 2, 0)


def finalize(filtered_sums: torch.Tensor, samples_per_pixel: int):
    """sqrt(x / spp) gamma map."""
    return torch.sqrt(torch.clamp(filtered_sums / samples_per_pixel, min=0.0))
