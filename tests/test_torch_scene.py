"""Port parity: camera, scene tables, tile order and per-tile sphere lists of
pathtracer_tpu_torch against the JAX package, on the shirley scene.

Tolerances: the host float64 code (camera, frustum planes, tile lists) and
the table packing must be EQUAL (bit-for-bit for float32 tables); ray
directions may differ by 2 ulp, since XLA may sum |d|^2 in another order
than the port's left-to-right sum."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu import integrator as jint
from pathtracer_tpu.models import shirley as jshirley
from pathtracer_tpu.ops import frustum as jfrustum
from pathtracer_tpu.ops.pallas import shade_kernel as jshk
from pathtracer_tpu.ops.pallas import sphere_kernel as jsk
from pathtracer_tpu_torch import integrator as tint
from pathtracer_tpu_torch.models import shirley as tshirley
from pathtracer_tpu_torch.ops import frustum as tfrustum
from pathtracer_tpu_torch.ops.cuda import shade_kernel as tshk
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as tsk
from pathtracer_tpu_torch.scene import Scene

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scenes():
    jscene, jcam, _ = jshirley.build(2.0)
    tscene, tcam, tbg = tshirley.build(2.0, CPU)
    return jscene, jcam, tscene, tcam, tbg


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_camera_and_background(scenes):
    _, jcam, _, tcam, tbg = scenes
    np.testing.assert_array_equal(tcam.look_at, jcam.look_at)
    for f in ("lower_left_x", "lower_left_y", "view_x", "view_y"):
        assert getattr(tcam, f) == getattr(jcam, f)
    assert tbg == jshirley.background.pallas_params


def test_scene_from_numpy_equals_builder(scenes):
    """The JAX Scene's arrays carried across equal the port's own build."""
    jscene, _, tscene, _, _ = scenes
    carried = Scene.from_numpy(
        {f.name: np.asarray(getattr(jscene, f.name))
         for f in dataclasses.fields(Scene)}, CPU)
    assert carried.count == tscene.count == 536
    assert int(tscene.valid.sum()) == 531
    for f in dataclasses.fields(Scene):
        a, b = getattr(carried, f.name), getattr(tscene, f.name)
        assert a.dtype == b.dtype, f.name
        assert torch.equal(a, b), f.name


def test_sphere_table_bit_equal(scenes):
    jscene, _, tscene, _, _ = scenes
    want = jsk.pack_spheres_pallas(jscene.center, jscene.radius, jscene.valid)
    got = tsk.pack_spheres(tscene.center, tscene.radius, tscene.valid)
    assert got.shape == (4, 536)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_material_table_bit_equal(scenes):
    """Planes 7-9 are u32 bit patterns (u15/u16 albedo, kind bits)."""
    jscene, _, tscene, _, _ = scenes
    want = jshk.pack_material_tables(jscene.shade_pack)
    got = tshk.pack_material_tables(tscene.shade_pack)
    assert got.shape == (10, 5, 128)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_ray_dirs_within_2ulp(scenes):
    _, jcam, _, tcam, _ = scenes
    rng = np.random.default_rng(3)
    cx = rng.random(4096).astype(np.float32)
    cy = rng.random(4096).astype(np.float32)
    want = np.asarray(jcam.ray_dirs(jnp.asarray(cx), jnp.asarray(cy)))
    got = tcam.ray_dirs(torch.from_numpy(cx), torch.from_numpy(cy)).numpy()
    assert got.shape == want.shape == (4096, 3)
    ulp = np.abs(_bits(got).astype(np.int64) - _bits(want).astype(np.int64))
    assert ulp.max() <= 2, ulp.max()


@pytest.mark.parametrize("width,height", [(600, 300), (160, 80), (64, 32)])
def test_tile_sphere_lists_equal(scenes, width, height):
    jscene, _, tscene, _, _ = scenes
    jcam = jshirley.make_camera(width / height)
    tcam = tshirley.make_camera(width / height)
    want = jint.tile_sphere_lists(jcam, np.asarray(jscene.center),
                                  np.asarray(jscene.radius),
                                  np.asarray(jscene.valid), width, height)
    got = tint.tile_sphere_lists(tcam, tscene.center.numpy(),
                                 tscene.radius.numpy(), tscene.valid.numpy(),
                                 width, height)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    planes = dict(camera=tcam, width=width, height=height,
                  tx_n=-(-width // 32), ty_n=-(-height // 32), flip_y=True)
    np.testing.assert_array_equal(
        tfrustum.tile_frustum_planes(**planes),
        jfrustum.tile_frustum_planes(**dict(planes, camera=jcam)))


def test_renderer_tile_order(scenes):
    """The Renderer's tile-major ray order and its buffers' placement."""
    _, _, tscene, tcam, tbg = scenes
    r = tint.Renderer(tscene, tcam, tbg, 70, 40, 1, 2, CPU)
    assert (r.tyn, r.txn) == (2, 3)
    assert r.pix.shape == (6 * 1024,)
    # tile (ty=1, tx=2), in-tile pixel (iy=3, ix=5) -> (y=35, x=69)
    i = (1 * 3 + 2) * 1024 + 3 * 32 + 5
    assert int(r.pix[i]) == 35 * 70 + 69 and bool(r.valid[i])
    # (y=35, x=70) lies past the right edge: clamped and masked
    assert int(r.pix[i + 1]) == 35 * 70 + 69 and not bool(r.valid[i + 1])
    names = {n for n, _ in r.named_buffers()}
    assert {"sph_table", "pack_table", "lists", "counts"} <= names
    planes = torch.arange(3 * 6 * 1024, dtype=torch.float32).reshape(
        3, -1, 128)
    img = r.untile(planes)
    assert img.shape == (40, 70, 3)
    assert float(img[35, 69, 1]) == float(planes.reshape(3, -1)[1, i])
