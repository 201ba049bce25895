"""Port parity: one fused bounce of pathtracer_tpu_torch (its plain version,
which the wrapper runs for CPU tensors) against fused_bounce_pallas in
interpret mode, on a 64x32 shirley wavefront in tile-major ray order (two
32x32 tiles): listed + origin_zero (bounce 0 as rendered), full +
origin_zero, and full from the bounce-0 state (bounce 1), with both
background modes.

Tolerance, and why. The sphere selection and the shading are the same
float32 operations in the same order, but XLA contracts products and sums
into FMAs where eager PyTorch rounds each one (measured: the a*t keys differ
by up to 1.4e-3 on the r=1000 ground sphere, whose A = r^2 - |c|^2 cancels
~6 digits). The stable-t recomputation and the Schlick/refraction terms
amplify those last-bit differences, so the measured worst case on this
wavefront is 6e-3 in a state component (lanes on the glass and r=0.2
spheres) and 6e-8 in radiance. The test holds:
  - lanes whose alive flag differs: at most 0.1% (measured: 0);
  - every other lane: |state - want| <= STATE_ATOL, |rad - want| <=
    RAD_ATOL.
These tolerances are for the port against XLA only: on the card,
chip_smoke.py and tests/test_torch_cuda.py require the CUDA kernel (built
without FMA contraction) to equal its plain version exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu import integrator as jint
from pathtracer_tpu.models import shirley as jshirley
from pathtracer_tpu.ops.lds import Sampler
from pathtracer_tpu.ops.pallas import fused_bounce_kernel as jfbk
from pathtracer_tpu.ops.pallas import shade_kernel as jshk
from pathtracer_tpu.ops.pallas import sphere_kernel as jsk
from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as tfbk

STATE_ATOL = 1e-2
RAD_ATOL = 1e-6
MAX_ALIVE_DIFF = 1e-3
W, H = 64, 32


@pytest.fixture(scope="module")
def wavefront():
    """Bounce-0 wavefront of one pass in tile-major order, plus the JAX
    tables and the bounce-0 state after one JAX bounce."""
    scene, cam, bg = jshirley.build(W / H)
    sampler = Sampler(2 + 2 * 2)
    ty, tx, iy, ix = np.meshgrid(np.arange(1), np.arange(2), np.arange(32),
                                 np.arange(32), indexing="ij")
    y = (ty * 32 + iy).reshape(-1)
    x = (tx * 32 + ix).reshape(-1)
    offset = jnp.asarray((y * W + x).astype(np.uint32))
    dx = sampler.get(offset, 0)
    dy = sampler.get(offset, 1)
    cx = (jnp.asarray(x, jnp.float32) + dx) * np.float32(1 / W)
    cy = 1.0 - (jnp.asarray(y, jnp.float32) + dy) * np.float32(1 / H)
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
        bg=bg.pallas_params,
        state0=state0,
        rad0=np.zeros((3, n // 128, 128), np.float32))
    w["state1"] = _jax_bounce(w, state0, 0, True, True, w["bg"])[0]
    return w


def _limbs(sampler, bounce):
    du, dv = 2 + 2 * bounce, 3 + 2 * bounce
    return np.asarray([[sampler.hi[du], sampler.lo[du]],
                       [sampler.hi[dv], sampler.lo[dv]]], np.uint32)


def _jax_bounce(w, state, bounce, origin_zero, listed, bg):
    bl = tuple(jnp.asarray(a) for a in w["lists"]) if listed else None
    st, rad = jfbk.fused_bounce_pallas(
        jnp.asarray(w["tables"]), jnp.asarray(state), jnp.asarray(w["pack"]),
        jnp.asarray(w["off"]), jnp.asarray(_limbs(w["sampler"], bounce)),
        jnp.asarray(bg[1], jnp.float32), rad_in=jnp.asarray(w["rad0"]),
        bg_mode=bg[0], origin_zero=origin_zero, block_lists=bl,
        interpret=True)
    return np.asarray(st), np.asarray(rad)


CASES = {
    "bounce0_listed_origin_zero": (0, True, True, None),
    "bounce0_full_origin_zero": (0, True, False, None),
    "bounce1_full": (1, False, False, None),
    "bounce1_full_solid_background": (1, False, False,
                                      (0, ((0.3, 0.2, 0.1), (0., 0., 0.)))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bounce_matches_pallas(wavefront, case):
    w = wavefront
    bounce, origin_zero, listed, bg = CASES[case]
    bg = bg or w["bg"]
    state = w["state0"] if bounce == 0 else w["state1"]
    want_st, want_rad = _jax_bounce(w, state, bounce, origin_zero, listed, bg)

    T = lambda a: torch.from_numpy(np.array(a))
    st, rad = tfbk.fused_bounce(
        T(w["tables"]), T(state), T(w["pack"]), T(w["off"].view(np.int32)),
        _limbs(w["sampler"], bounce), bg[1], T(w["rad0"]), bg_mode=bg[0],
        origin_zero=origin_zero,
        block_lists=tuple(T(a) for a in w["lists"]) if listed else None)
    st, rad = st.numpy(), rad.numpy()
    assert st.shape == want_st.shape and rad.shape == want_rad.shape
    assert tfbk.fused_bounce.launches == 0  # CPU tensors: plain version

    alive_diff = (st[9] > 0) != (want_st[9] > 0)
    assert alive_diff.mean() <= MAX_ALIVE_DIFF, alive_diff.sum()
    same = ~alive_diff
    assert (want_st[9] > 0).sum() > 100  # the bounce kept live lanes
    np.testing.assert_allclose(st[:, same], want_st[:, same], rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(rad[:, same], want_rad[:, same], rtol=0,
                               atol=RAD_ATOL)


def test_wrapper_checks_shapes(wavefront):
    """A CUDA-less device or a malformed wavefront never reaches a kernel."""
    w = wavefront
    meta = lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta")
    args = (meta(w["tables"]), meta(w["state0"]), meta(w["pack"]),
            torch.empty(w["off"].shape, dtype=torch.int32, device="meta"),
            _limbs(w["sampler"], 0), w["bg"][1], meta(w["rad0"]))
    with pytest.raises(ValueError, match="no kernel"):
        tfbk.fused_bounce(*args, bg_mode=1, origin_zero=True)
    assert tfbk.fused_bounce.launches == 0
