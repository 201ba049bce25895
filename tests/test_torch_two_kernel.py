"""Port parity of the two-kernel bounce: intersect_state and shade_state of
pathtracer_tpu_torch (their plain versions, which the wrappers run for CPU
tensors) against the JAX package's intersect_state_pallas and shade_pallas
in interpret mode, on a 64x32 shirley wavefront in tile-major ray order (two
32x32 tiles), and the fuse_bounce=False trace against the fused one and
against the JAX two-kernel trace (PATHTRACER_FUSE_BOUNCE=0).

Tolerances, and why:
  - intersect_state: on live lanes idx and hit (at < BIG) equal, the a*t
    key within rtol 1e-6 plus atol 2e-3. XLA contracts FMAs in the key, and
    at bounce 0 the key of a ray grazing a far sphere is ill-conditioned:
    |c| ~ 20, so disc = A + bp^2 cancels ~4 digits (A = r^2 - |c|^2 ~ -400)
    and its square root magnifies the rest. Measured: 1.43e-3 (7.2e-5
    relative) on 4 of the 2,048 bounce-0 lanes, grazing the r=0.2 and r=1
    spheres; at most 4.0e-4 at bounce 1. Every dead lane is (BIG, 0) here,
    while the JAX kernel computes the dead lanes of a live block (nothing
    reads them), so only the live lanes are compared with JAX.
  - shade_state, fed the JAX kernel's own (at, idx): the bounds of
    tests/test_torch_fused_bounce.py (alive flags differ on at most 0.1% of
    lanes, state within 1e-2, radiance within 1e-6), for the same FMA
    reasons.
  - the two-kernel trace against the fused one, both on the CPU: equal,
    since both run the same plain functions.
  - against the JAX two-kernel trace at 64x64, 6 bounces: the bounds of
    tests/test_torch_render.py (segments within 0.1%, at most 1% of pixels
    off by more than 1e-3, mean radiance within 1e-3 relative)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu import integrator as jint
from pathtracer_tpu.models import shirley as jshirley
from pathtracer_tpu.ops.lds import Sampler as JSampler
from pathtracer_tpu.ops.pallas import fused_bounce_kernel as jfbk
from pathtracer_tpu.ops.pallas import shade_kernel as jshk
from pathtracer_tpu.ops.pallas import sphere_kernel as jsk
from pathtracer_tpu_torch import integrator
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import shade_kernel as shk
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
from pathtracer_tpu_torch.ops.lds import Sampler

CPU = torch.device("cpu")
W, H = 64, 32
T = lambda a: torch.from_numpy(np.array(a))


def _limbs(sampler, bounce):
    du, dv = 2 + 2 * bounce, 3 + 2 * bounce
    return np.asarray([[sampler.hi[du], sampler.lo[du]],
                       [sampler.hi[dv], sampler.lo[dv]]], np.uint32)


@pytest.fixture(scope="module")
def wavefront():
    """Bounce-0 state of one pass in tile-major order, the JAX tables and
    tile lists, and the state after one JAX bounce with its second block
    killed (a wholly dead block)."""
    scene, cam, bg = jshirley.build(W / H)
    sampler = JSampler(2 + 2 * 2)
    ty, tx, iy, ix = np.meshgrid(np.arange(1), np.arange(2), np.arange(32),
                                 np.arange(32), indexing="ij")
    y = (ty * 32 + iy).reshape(-1)
    x = (tx * 32 + ix).reshape(-1)
    offset = jnp.asarray((y * W + x).astype(np.uint32))
    cx = (jnp.asarray(x, jnp.float32) + sampler.get(offset, 0)) \
        * np.float32(1 / W)
    cy = 1.0 - (jnp.asarray(y, jnp.float32) + sampler.get(offset, 1)) \
        * np.float32(1 / H)
    d = np.asarray(cam.ray_dirs(cx, cy, jnp.float32)).reshape(-1, 3)
    n = d.shape[0]
    state0 = np.concatenate([np.zeros((3, n)), d.T, np.ones((4, n))]) \
        .astype(np.float32).reshape(10, n // 128, 128)
    w = dict(
        sampler=sampler,
        tables=np.asarray(jsk.pack_spheres_pallas(scene.center, scene.radius,
                                                  scene.valid)),
        pack=np.asarray(jshk.pack_material_tables(scene.shade_pack)),
        off=np.asarray(offset).reshape(n // 128, 128),
        lists=jint.tile_sphere_lists(cam, np.asarray(scene.center),
                                     np.asarray(scene.radius),
                                     np.asarray(scene.valid), W, H),
        bg=bg.pallas_params, state0=state0,
        rad0=np.zeros((3, n // 128, 128), np.float32))
    st1, _ = jfbk.fused_bounce_pallas(
        jnp.asarray(w["tables"]), jnp.asarray(state0), jnp.asarray(w["pack"]),
        jnp.asarray(w["off"]), jnp.asarray(_limbs(sampler, 0)),
        jnp.asarray(w["bg"][1], jnp.float32), rad_in=jnp.asarray(w["rad0"]),
        bg_mode=w["bg"][0], origin_zero=True,
        block_lists=tuple(jnp.asarray(a) for a in w["lists"]),
        interpret=True)
    st1 = np.array(st1)
    st1[9, 8:] = 0.0  # rows 8-15: the second 1024-ray block, all dead
    w["state1"] = st1
    return w


def _jax_intersect(w, state, origin_zero, listed):
    bl = tuple(jnp.asarray(a) for a in w["lists"]) if listed else None
    at, idx = jsk.intersect_state_pallas(
        jnp.asarray(w["tables"]), jnp.asarray(state), interpret=True,
        origin_zero=origin_zero, block_lists=bl)
    return np.asarray(at), np.asarray(idx)


# (state, origin_zero, listed)
INTERSECT_CASES = {
    "bounce0_listed_origin_zero": ("state0", True, True),
    "bounce0_full_origin_zero": ("state0", True, False),
    "bounce0_full": ("state0", False, False),
    "bounce1_full": ("state1", False, False),
    "bounce1_listed": ("state1", False, True),
}


@pytest.mark.parametrize("case", list(INTERSECT_CASES))
def test_intersect_state_plain_matches_pallas(wavefront, case):
    w = wavefront
    key, origin_zero, listed = INTERSECT_CASES[case]
    state = w[key]
    want_at, want_idx = _jax_intersect(w, state, origin_zero, listed)
    at, idx = sk.intersect_state(
        T(w["tables"]), T(state), origin_zero=origin_zero,
        block_lists=tuple(T(a) for a in w["lists"]) if listed else None)
    assert sk.intersect_state.launches == 0  # CPU tensors: plain version
    at, idx = at.numpy(), idx.numpy()
    assert at.shape == want_at.shape and idx.dtype == np.int32
    live = state[9] > 0
    assert live.sum() > 500
    np.testing.assert_array_equal(idx[live], want_idx[live])
    np.testing.assert_array_equal(at[live] < sk.BIG, want_at[live] < sk.BIG)
    np.testing.assert_allclose(at[live], want_at[live], rtol=1e-6, atol=2e-3)
    # the dead-lane fill, which the JAX kernel gives wholly dead blocks
    assert (at[~live] == sk.BIG).all() and (idx[~live] == 0).all()
    if key == "state1":
        assert (want_at[8:] == sk.BIG).all() and (want_idx[8:] == 0).all()
        assert (~live[:8]).any()  # dead lanes inside the live block too


SHADE_CASES = {
    "bounce0_listed": ("state0", True, True, None),
    "bounce1_full": ("state1", False, False, None),
    "bounce1_full_solid_background": ("state1", False, False,
                                      (0, ((0.3, 0.2, 0.1), (0., 0., 0.)))),
}


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_state_plain_matches_pallas(wavefront, case):
    """Both sides shade from the JAX kernel's own (at, idx)."""
    w = wavefront
    key, origin_zero, listed, bg = SHADE_CASES[case]
    bg = bg or w["bg"]
    state = w[key]
    bounce = 0 if key == "state0" else 1
    at, idx = _jax_intersect(w, state, origin_zero, listed)
    limbs = _limbs(w["sampler"], bounce)
    want_st, want_rad = (np.asarray(x) for x in jshk.shade_pallas(
        jnp.asarray(state), jnp.asarray(w["pack"]), jnp.asarray(idx),
        jnp.asarray(w["off"]), jnp.asarray(at), jnp.asarray(limbs),
        jnp.asarray(bg[1], jnp.float32), rad_in=jnp.asarray(w["rad0"]),
        bg_mode=bg[0], interpret=True))
    st, rad = shk.shade_state(T(state), T(w["pack"]), T(idx),
                              T(w["off"].view(np.int32)), T(at), limbs, bg[1],
                              T(w["rad0"]), bg_mode=bg[0])
    assert shk.shade_state.launches == 0
    st, rad = st.numpy(), rad.numpy()
    assert st.shape == want_st.shape and rad.shape == want_rad.shape
    alive_diff = (st[9] > 0) != (want_st[9] > 0)
    assert alive_diff.mean() <= 1e-3, alive_diff.sum()
    same = ~alive_diff
    assert (want_st[9] > 0).sum() > 100
    np.testing.assert_allclose(st[:, same], want_st[:, same], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(rad[:, same], want_rad[:, same], rtol=0,
                               atol=1e-6)
    dead = ~(state[9] > 0)  # passed through unchanged
    np.testing.assert_array_equal(st[:9, dead], state[:9, dead])
    np.testing.assert_array_equal(rad[:, dead], w["rad0"][:, dead])


def _shirley_rays(W_, H_, B):
    """A W_xH_ wavefront in raster order from the JAX camera: (JAX scene,
    background, sampler, d, offset)."""
    jscene, cam, background = jshirley.build(W_ / H_)
    jsampler = JSampler(2 + 2 * B)
    ys, xs = np.meshgrid(np.arange(H_), np.arange(W_), indexing="ij")
    offset = jnp.asarray((ys * W_ + xs).reshape(-1).astype(np.uint32))
    cx = (jnp.asarray(xs.reshape(-1), jnp.float32)
          + jsampler.get(offset, 0)) / W_
    cy = 1.0 - (jnp.asarray(ys.reshape(-1), jnp.float32)
                + jsampler.get(offset, 1)) / H_
    d = cam.ray_dirs(cx, cy, jnp.float32).reshape(-1, 3)
    return jscene, background, jsampler, d, offset


def _port_trace(W_, H_, B, d, offset, fuse_bounce):
    scene, _, bg = shirley.build(W_ / H_, CPU)
    state = integrator.initial_state(torch.from_numpy(np.array(d)),
                                     torch.ones(W_ * H_, dtype=torch.bool))
    off = torch.from_numpy(np.array(offset).view(np.int32)).reshape(-1, 128)
    return integrator.trace_wavefront(
        sk.pack_spheres(scene.center, scene.radius, scene.valid),
        shk.pack_material_tables(scene.shade_pack), state, off,
        Sampler(2 + 2 * B), B, bg, origin_zero=False,
        fuse_bounce=fuse_bounce)


def test_two_kernel_trace_equals_fused_on_cpu():
    """trace_wavefront and make_render_fn with fuse_bounce=False against
    True: the same radiance and segments, bit for bit."""
    _, _, _, d, offset = _shirley_rays(64, 32, 4)
    (rad0, segs0), (rad1, segs1) = (_port_trace(64, 32, 4, d, offset, f)
                                    for f in (False, True))
    assert int(segs0) == int(segs1) > 0
    assert torch.equal(rad0, rad1)
    scene, cam, bg = shirley.build(2.0, CPU)
    (img0, s0), (img1, s1) = (
        integrator.make_render_fn(cam, bg, 64, 32, 1, 4, CPU,
                                  fuse_bounce=f)(scene) for f in (False, True))
    assert s0 == s1 > 0 and torch.equal(img0, img1)


def test_two_kernel_trace_matches_jax_two_kernel():
    W_ = H_ = 64
    B = 6
    jscene, background, jsampler, d, offset = _shirley_rays(W_, H_, B)
    old = os.environ.get("PATHTRACER_FUSE_BOUNCE")
    os.environ["PATHTRACER_FUSE_BOUNCE"] = "0"
    try:
        want_rad, want_segs = jint._trace_pallas2(
            jscene, jsampler, jnp.zeros_like(d), d, offset, B, background,
            None, interpret=True)
    finally:
        if old is None:
            del os.environ["PATHTRACER_FUSE_BOUNCE"]
        else:
            os.environ["PATHTRACER_FUSE_BOUNCE"] = old
    want_rad = np.asarray(want_rad)
    rad, segs = _port_trace(W_, H_, B, d, offset, False)
    got = rad.reshape(3, -1).T.numpy()
    segs, want_segs = int(segs), int(want_segs)
    assert abs(segs - want_segs) <= 1e-3 * want_segs, (segs, want_segs)
    bad = (np.abs(got - want_rad) > 1e-3).any(axis=1)
    assert bad.mean() <= 0.01, (bad.sum(), np.abs(got - want_rad).max())
    assert abs(got.mean() / want_rad.mean() - 1) < 1e-3


def test_two_kernel_wrappers_refuse_other_devices(wavefront):
    w = wavefront
    meta = lambda a, dt=torch.float32: torch.empty(a.shape, dtype=dt,
                                                   device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sk.intersect_state(meta(w["tables"]), meta(w["state0"]),
                           origin_zero=True)
    rows = w["state0"].shape[1]
    with pytest.raises(ValueError, match="no kernel"):
        shk.shade_state(meta(w["state0"]), meta(w["pack"]),
                        torch.empty(rows, 128, dtype=torch.int32,
                                    device="meta"),
                        torch.empty(rows, 128, dtype=torch.int32,
                                    device="meta"),
                        torch.empty(rows, 128, device="meta"),
                        _limbs(w["sampler"], 0), w["bg"][1], meta(w["rad0"]),
                        bg_mode=1)
    assert sk.intersect_state.launches == shk.shade_state.launches == 0
