"""Roberts R_d low-discrepancy sequence in 64-bit fixed point.

Port of pathtracer_tpu/ops/lds.py. The reference sampler is

    phi_D  = unique real root of x^(D+1) = x + 1   (fixed-point iteration)
    alpha_d = phi_D^-(d+1)                          for d in [0, D)
    sample(offset, d) = frac(0.5 + alpha_d * (offset + 1))

evaluated as (2^63 + alpha_fix * (offset+1)) mod 2^64 with alpha_fix =
round(alpha * 2^64) held as two uint32 limbs. The top 32 bits give the
sample. Randomness in this package is this sequence only — a pure function of
(offset, dimension) — so no `torch.Generator` is needed.

torch has no uint32 add or right shift on the CPU, so the limb math of the
JAX sample_fixed runs here in int64 with every intermediate masked to 32 bits;
the result is bit-identical (tests/test_torch_lds.py). Offsets are integer
tensors read as uint32 bit patterns (an int32 -1 is offset 2^32 - 1).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["phi", "alphas_f64", "alphas_fixed64", "sample_fixed", "Sampler",
           "as_u32", "hi_word"]

M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_HALF = 0x80000000
_SCALE = float(np.float32(2.0 ** -32))
# largest float32 strictly below 1.0, keeps samples in [0, 1)
ONE_MINUS_EPS = float(np.float32(1.0 - 2.0 ** -24))


def phi(dimension: int) -> float:
    """Unique positive root of x^(d+1) = x + 1, by the reference's fixed-point
    iteration x <- (1+x)^(1/(d+1)) from x0=2.0, iterated to float64 fixpoint."""
    assert dimension >= 1
    dinv = 1.0 / (float(dimension) + 1.0)
    x = 2.0
    while True:
        x2 = (1.0 + x) ** dinv
        if x2 == x:
            return x
        x = x2


def alphas_f64(dimension: int) -> np.ndarray:
    """alpha_d = phi_D^-(d+1) for d in [0, D), float64 (host)."""
    p = phi(dimension)
    return np.array([1.0 / (p ** float(i + 1)) for i in range(dimension)],
                    dtype=np.float64)


def alphas_fixed64(dimension: int) -> np.ndarray:
    """alpha_d scaled to 64-bit fixed point, returned as uint32 (D, 2) [hi, lo]."""
    a = alphas_f64(dimension)
    out = np.empty((dimension, 2), dtype=np.uint32)
    for i, x in enumerate(a):
        v = int(round(x * (1 << 64))) & ((1 << 64) - 1)
        out[i, 0] = (v >> 32) & 0xFFFFFFFF
        out[i, 1] = v & 0xFFFFFFFF
    return out


def as_u32(offset: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int64 holding its uint32 value."""
    return offset.to(torch.int64) & M32


def hi_word(alpha_hi: int, alpha_lo: int, m: torch.Tensor) -> torch.Tensor:
    """Top 32 bits of (alpha_hi * 2^32 + alpha_lo) * m mod 2^64, plus the
    fixed-point 0.5, as int64 in [0, 2^32). m: int64 in [0, 2^32).

    The 16-bit limb products and carries of the JAX sample_fixed, each
    intermediate masked to 32 bits (every product stays below 2^48)."""
    alpha_hi, alpha_lo = int(alpha_hi), int(alpha_lo)
    p0 = alpha_lo & _M16
    p1 = alpha_lo >> 16
    q0 = m & _M16
    q1 = m >> 16
    pp0 = p0 * q0
    pp1a = p0 * q1
    pp1b = p1 * q0
    t1 = (pp0 + ((pp1a << 16) & M32)) & M32
    c1 = (t1 < pp0).to(torch.int64)
    t2 = (t1 + ((pp1b << 16) & M32)) & M32
    c2 = (t2 < t1).to(torch.int64)
    # alpha_hi * m mod 2^32, split so no product reaches 2^63
    hi_m = (alpha_hi * q0 + (((alpha_hi * q1) & _M16) << 16)) & M32
    hi = (hi_m + p1 * q1 + (pp1a >> 16) + (pp1b >> 16) + c1 + c2) & M32
    return (hi + _HALF) & M32


def sample_fixed(alpha_hi: int, alpha_lo: int,
                 offset: torch.Tensor) -> torch.Tensor:
    """Fixed-point LDS evaluation, float32 samples in [0, 1).

    alpha_hi, alpha_lo: the two uint32 limbs of alpha*2^64 (host ints).
    offset: integer tensor of sample offsets (uint32 bit patterns).
    The float conversion is f32(v) * 2^-32 (lds.py:106 of the JAX package)."""
    m = (as_u32(offset) + 1) & M32
    v = hi_word(alpha_hi, alpha_lo, m)
    s = v.to(torch.float32) * _SCALE
    return torch.clamp(s, max=ONE_MINUS_EPS)


class Sampler:
    """Fixed-point sampler for a given total dimension count D (the path
    tracer uses D = 2 + 2*max_bounces). Limb tables stay host numpy."""

    def __init__(self, dimension: int):
        self.dimension = dimension
        self.alphas = alphas_f64(dimension)
        fixed = alphas_fixed64(dimension)
        self.hi = np.ascontiguousarray(fixed[:, 0])
        self.lo = np.ascontiguousarray(fixed[:, 1])

    def get(self, offset: torch.Tensor, dimension: int) -> torch.Tensor:
        return sample_fixed(self.hi[dimension], self.lo[dimension], offset)

    def limbs(self, du: int, dv: int) -> np.ndarray:
        """(2, 2) uint32 [[u_hi, u_lo], [v_hi, v_lo]] for one bounce's two
        draws — the kernels' `limbs` argument."""
        return np.asarray([[self.hi[du], self.lo[du]],
                           [self.hi[dv], self.lo[dv]]], np.uint32)
