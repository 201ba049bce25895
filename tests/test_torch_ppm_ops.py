"""Port parity of the photon mapper's vector math: ops/vec, ops/quat,
ops/shading, spheres.stable_t and triangles.mt_single of
pathtracer_tpu_torch against the JAX package, on the same seeded numpy
inputs.

Tolerance: rtol 1e-6, atol 1e-6. XLA contracts products and sums into FMAs
(and its rsqrt is within an ulp of the port's 1/sqrt rounded from float64),
so results may differ by a few ulp; the port itself rounds every operation
on its own."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.ops import quat as jquat
from pathtracer_tpu.ops import shading as jshading
from pathtracer_tpu.ops import spheres as jspheres
from pathtracer_tpu.ops import triangles as jtri
from pathtracer_tpu.ops import vec as jvec
from pathtracer_tpu_torch.ops import quat, shading, spheres, triangles, vec

TOL = dict(rtol=1e-6, atol=1e-6)
N = 4096


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _vecs(seed, n=N, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)) * scale).astype(np.float32)


def _units(seed, n=N):
    v = _vecs(seed, n)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _quats(seed, n=N):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


T = torch.from_numpy
J = jnp.asarray


def test_vec_ops():
    a, b = _vecs(0), _vecs(1, scale=3.0)
    t = np.random.default_rng(2).random(N).astype(np.float32)
    mask = t < 0.5
    _close(vec.dot(T(a), T(b)), jvec.dot(J(a), J(b)))
    _close(vec.quadrance(T(a)), jvec.quadrance(J(a)))
    _close(vec.norm(T(b)), jvec.norm(J(b)))
    _close(vec.normalize(T(b)), jvec.normalize(J(b)))
    _close(vec.cross(T(a), T(b)), jvec.cross(J(a), J(b)))
    _close(vec.scale(T(a), T(t)), jvec.scale(J(a), J(t)))
    _close(vec.lerp(T(t), T(a), T(b)), jvec.lerp(J(t), J(a), J(b)))
    _close(vec.where3(T(mask), T(a), T(b)), jvec.where3(J(mask), J(a), J(b)))
    v3 = vec.v3(T(a[:, 0]), T(a[:, 1]), T(a[:, 2]))
    assert torch.equal(v3, T(a))


def test_quat_ops():
    q, p = _quats(3), _quats(4)
    v = _vecs(5)
    axis = _vecs(6)
    ang = np.random.default_rng(7).uniform(-4, 4, N).astype(np.float32)
    _close(quat.normalize(T(q * 2.5)), jquat.normalize(J(q * 2.5)))
    _close(quat.mul(T(q), T(p)), jquat.mul(J(q), J(p)))
    _close(quat.conj(T(q)), jquat.conj(J(q)))
    _close(quat.rotate(T(q), T(v)), jquat.rotate(J(q), J(v)))
    _close(quat.rotate_inv(T(q), T(v)), jquat.rotate_inv(J(q), J(v)))
    _close(quat.from_axis_angle(T(axis), T(ang)),
           jquat.from_axis_angle(J(axis), J(ang)))
    _close(quat.quat(T(ang), T(v)), jquat.quat(J(ang), J(v)))


def test_shader_quat_including_poles():
    n = _units(8)
    # exact and near poles take the identity / flip branches
    n[:6] = [[0, 0, 1], [0, 0, -1], [1e-4, 0, 1 - 5e-9], [0, 1e-4, -1],
             [1, 0, 0], [0, -1, 0]]
    n = n.astype(np.float32)
    got = shading.shader_quat(T(n))
    _close(got, jshading.shader_quat(J(n)))
    assert torch.equal(got[0], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert torch.equal(got[1], torch.tensor([0.0, 0.0, 1.0, 0.0]))
    # the frame takes the normal to local +Z
    local = quat.rotate(got, T(n))
    _close(local[6:, 2], np.ones(N - 6, np.float32))


def test_world_ray_and_reflect():
    p, d = _vecs(9), _units(10)
    _close(shading.world_ray(T(p), T(d)), jshading.world_ray(J(p), J(d)))
    assert np.array_equal(shading.reflect_local(T(d)).numpy(),
                          np.asarray(jshading.reflect_local(J(d))))


@pytest.mark.parametrize("ratio", [1.0 / 1.5, 1.5])
def test_refract_local(ratio):
    wi = _units(11)
    wi[:, 2] = np.abs(wi[:, 2])
    r = np.full(N, ratio, np.float32)
    _close(shading.refract_local(T(wi), T(r)),
           jshading.refract_local(J(wi), J(r)))


def test_cosine_hemisphere_and_schlick():
    rng = np.random.default_rng(12)
    u, v = rng.random((2, N)).astype(np.float32)
    idx = rng.uniform(0.5, 2.5, N).astype(np.float32)
    _close(shading.cosine_hemisphere(T(u), T(v)),
           jshading.cosine_hemisphere(J(u), J(v)))
    _close(shading.schlick(T(u), T(idx)), jshading.schlick(J(u), J(idx)))
    x = rng.uniform(-2, 2, N).astype(np.float32)
    _close(shading.pow5(T(x)), J(x) ** 5)


def test_stable_t():
    """Rays from outside and inside spheres, towards and away from them."""
    rng = np.random.default_rng(13)
    c = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    r = rng.uniform(0.1, 1.0, N).astype(np.float32)
    o = (c + _units(14) * (r * rng.choice([0.5, 3.0], N))[:, None]).astype(
        np.float32)
    d = (_units(15) * rng.uniform(0.5, 2.0, (N, 1))).astype(np.float32)
    a = (d * d).sum(1).astype(np.float32)
    inv_a = (1.0 / a).astype(np.float32)
    got = spheres.stable_t(T(c), T(r * r), T(o), T(d), T(a), T(inv_a))
    want = jspheres.stable_t(J(c), J(r * r), J(o), J(d), J(a), J(inv_a))
    ok = np.isfinite(np.asarray(want))
    assert ok.mean() > 0.5
    np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], **TOL)
    assert np.array_equal(np.isfinite(got.numpy()), ok)


def test_mt_single():
    """Rays at well-conditioned angles (within ~45 degrees of the normal)
    to non-degenerate triangles, aimed at a point inside each."""
    rng = np.random.default_rng(16)
    a = _vecs(17)
    e1 = _vecs(18)
    e2 = _vecs(19)
    nrm = np.cross(e1, e2)
    area = np.linalg.norm(nrm, axis=1)
    keep = area > 0.5 * np.linalg.norm(e1, axis=1) * np.linalg.norm(e2,
                                                                    axis=1)
    a, e1, e2 = a[keep], e1[keep], e2[keep]
    nrm = nrm[keep] / area[keep, None]
    n = len(a)
    bary = rng.dirichlet((1, 1, 1), n).astype(np.float32)
    target = a + bary[:, 1:2] * e1 + bary[:, 2:3] * e2
    side = rng.choice([-1.0, 1.0], (n, 1))
    off = nrm * side + 0.5 * _units(20, n)
    o = (target + 2.0 * off).astype(np.float32)
    d = (target - o).astype(np.float32)
    got = triangles.mt_single(T(a), T(e1), T(e2), T(o), T(d))
    want = jtri.mt_single(J(a), J(e1), J(e2), J(o), J(d))
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(got[0].numpy(), 1.0, rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), bary[:, 1], atol=1e-4)
