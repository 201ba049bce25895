"""Shading helpers of the photon mapper: tangent frames and scatter
directions, as masked tensor math over the whole wavefront.

Port of pathtracer_tpu/ops/shading.py (shader_quat, world_ray, reflect_local,
refract_local, cosine_hemisphere, schlick, scatter). `x ** 5` is written as
x * (x^2 * x^2), the product order of JAX's integer_pow, `jnp.square(x)` as
x * x, every root goes through vec.sqrt, and every constant is the float32
value the JAX code uses. `specular` is the metal and dielectric part of
scatter, which the photon mapper's passes share.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quat, vec

__all__ = ["pow5", "shader_quat", "world_ray", "reflect_local",
           "refract_local", "cosine_hemisphere", "schlick", "specular",
           "scatter"]

_f32 = lambda x: float(np.float32(x))
_SHADOW = _f32(1e-3)
_TWO_PI = _f32(2.0 * np.pi)


def pow5(x: torch.Tensor) -> torch.Tensor:
    """x ** 5 in JAX's integer_pow order."""
    x2 = x * x
    return x * (x2 * x2)


def shader_quat(normal: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating world `normal` to local +Z. Near-polar normals
    (|z| within 1e-6 of 1 in float32) take the identity or the 180-degree
    flip about Y, as the JAX code's float32 branch does."""
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    if normal.dtype == torch.float64:
        top = 1.0 - 1e-9
    else:  # JAX compares with the weakly typed 1 - 1e-6, rounded to f32
        top = float(np.float32(1.0 - 1e-6))
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    qg = quat.normalize(quat.quat(1.0 + z, vec.v3(y, -x, zero)))
    q_id = quat.quat(one, vec.v3(zero, zero, zero))
    q_flip = quat.quat(zero, vec.v3(zero, one, zero))
    q = torch.where((z > top)[..., None], q_id, qg)
    return torch.where((z < -top)[..., None], q_flip, q)


def world_ray(origin_pt, dir_world) -> torch.Tensor:
    """Scattered-ray origin offset by the shadow epsilon: origin + 1e-3 d."""
    return origin_pt + _SHADOW * dir_world


def reflect_local(w) -> torch.Tensor:
    """Mirror about local +Z: negate x and y."""
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], dim=-1)


def refract_local(wi, ratio) -> torch.Tensor:
    """Local-frame refraction."""
    c = torch.clamp(wi[..., 2], max=1.0)
    zero = torch.zeros_like(c)
    perp = (vec.v3(zero, zero, c) - wi) * ratio[..., None]
    para_z = -vec.sqrt(torch.abs(1.0 - vec.quadrance(perp)))
    return perp + vec.v3(zero, zero, para_z)


def cosine_hemisphere(u, v) -> torch.Tensor:
    """Cosine-weighted hemisphere map."""
    r = vec.sqrt(u)
    theta = v * _TWO_PI
    return vec.v3(r * torch.cos(theta), r * torch.sin(theta),
                  vec.sqrt(1.0 - u))


def schlick(cos_theta, index) -> torch.Tensor:
    """Schlick reflectance."""
    r = (1.0 - index) / (1.0 + index)
    r0 = r * r
    return r0 + (1.0 - r0) * pow5(1.0 - cos_theta)


def specular(albedo, ior, ior_inv, omega_i, hit_front, u):
    """The metal and dielectric scatter in the local frame: (wo_met,
    met_ok, tint, wo_die). Metal mirrors, absorbs below the horizon and
    tints by albedo + (1 - albedo) (1 - wi_z)^5; a dielectric reflects on
    total internal reflection or when Schlick's reflectance exceeds u, else
    refracts."""
    wi_z = omega_i[:, 2]
    wo_met = reflect_local(omega_i)
    met_ok = wo_met[:, 2] > 0.0
    tint = albedo + (1.0 - albedo) * pow5(1.0 - wi_z)[:, None]
    ci = torch.clamp(wi_z, 0.0, 1.0)
    si = vec.sqrt(1.0 - ci * ci)
    ratio = torch.where(hit_front, ior_inv, ior)
    refl = (ratio * si > 1.0) | (schlick(ci, ratio) > u)
    wo_die = vec.where3(refl, wo_met, refract_local(omega_i, ratio))
    return wo_met, met_ok, tint, wo_die


def scatter(mat_kind, albedo, ior, ior_inv, omega_i, hit_front, u, v):
    """Masked material dispatch of the path tracer, all in the local frame:
    every branch for every lane, selected by mat_kind (0 lambertian, 1
    metal, 2 dielectric). Lambertian takes the cosine-hemisphere sample
    and its albedo (the pdf ratio is 1); metal and dielectric are
    `specular`'s, a dielectric with white attenuation. mat_kind, ior,
    ior_inv, u, v (N,) f32; albedo, omega_i (N, 3) f32; hit_front (N,)
    bool. Returns (wo (N, 3), attn_mult (N, 3), ok (N,) bool); ok is False
    where the path ends (metal below the horizon, a lambertian sample with
    pdf 0)."""
    wo_lam = cosine_hemisphere(u, v)
    lam_ok = wo_lam[:, 2] > 0.0
    wo_met, met_ok, tint, wo_die = specular(albedo, ior, ior_inv, omega_i,
                                            hit_front, u)
    is_met = (mat_kind == 1)[:, None]
    is_die = (mat_kind == 2)[:, None]
    wo = torch.where(is_die, wo_die, torch.where(is_met, wo_met, wo_lam))
    attn = torch.where(is_die, 1.0, torch.where(is_met, tint, albedo))
    ok = (mat_kind == 2) | torch.where(mat_kind == 1, met_ok, lam_ok)
    return wo, attn, ok
