"""The path-traced ganesha slice of pathtracer_tpu_torch on the CPU (the
kernels' plain versions) against the JAX package: shading.scatter, build_pt
and the sky, the flip_y tile table, one pass of the composite mesh
wavefront against the JAX tiled pass with the tile kernel (Pallas in
interpret mode), the port's tile-path bounce 0 against its own walk, and a
whole render against the JAX make_render_fn.

The tiny ganesha is tests/test_tile_tri.py's: a 12x8 uv-sphere of 168
triangles where the ganesha camera looks, over the checkered floor, under
the shirley sky; 64x64.

Tolerances, each stated in its test: host tables and scene arrays equal;
scatter to 2e-7 absolute on unit-scale values (torch and XLA round sin
and cos differently in the last bit; measured 6e-8); the sky to 1 ulp
(rtol 2.4e-7: XLA may contract the lerp's products into FMAs); passes and renders with equal segment counts
and images to rtol 1e-3 / atol 1e-4, the bounds of the JAX package's own
tile-vs-walk test (test_tile_tri.py), since an ulp of a hit point can move
a path across a triangle's edge."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import make_pass_fn as jmake_pass_fn
from pathtracer_tpu.integrator import make_render_fn as jmake_render_fn
from pathtracer_tpu.io import ply as jply
from pathtracer_tpu.models import ganesha as jganesha
from pathtracer_tpu.ops import shading as jshading
from pathtracer_tpu.ops.pallas import tile_tri_kernel as jttk
from pathtracer_tpu_torch.integrator import (MeshRenderer, make_render_fn,
                                             trace)
from pathtracer_tpu_torch.models import ganesha, shirley
from pathtracer_tpu_torch.ops import shading
from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
from pathtracer_tpu_torch.scene import DIELECTRIC, LAMBERTIAN, METAL

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
W = H = 64
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402


@pytest.fixture(scope="module")
def tiny_ply(tmp_path_factory):
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    path = str(tmp_path_factory.mktemp("ganesha_pt") / "tiny_ganesha.ply")
    jply.write_mesh(path, verts, faces)
    return path


@pytest.fixture(scope="module")
def built(tiny_ply):
    """(JAX build_pt, the port's build_pt on the CPU)."""
    return (jganesha.build_pt(tiny_ply, 1.0),
            ganesha.build_pt(tiny_ply, 1.0, CPU))


def _scatter_inputs(kind, n=4096, seed=0):
    """Seeded numpy inputs of one material: local incoming directions over
    the whole sphere (so metal absorbs and glass meets its far side), both
    hit_front values, albedo, u and v in [0, 1)."""
    rng = np.random.default_rng(seed + kind)
    w = rng.normal(size=(n, 3))
    w = (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)
    ior = np.full(n, 1.5, np.float32)
    return dict(mat_kind=np.full(n, kind, np.float32),
                albedo=rng.random((n, 3), np.float32), ior=ior,
                ior_inv=(1.0 / ior).astype(np.float32), omega_i=w,
                hit_front=rng.random(n) < 0.5,
                u=rng.random(n, np.float32), v=rng.random(n, np.float32))


@pytest.mark.parametrize("kind", [LAMBERTIAN, METAL, DIELECTRIC])
def test_scatter_matches_jax(kind):
    """wo and attn_mult to 2e-7 absolute, ok equal; glass both reflects
    and refracts, metal both scatters and absorbs."""
    x = _scatter_inputs(kind)
    order = ("mat_kind", "albedo", "ior", "ior_inv", "omega_i", "hit_front",
             "u", "v")
    want = [np.asarray(a) for a in jshading.scatter(
        *(jnp.asarray(x[k]) for k in order))]
    got = [a.numpy() for a in shading.scatter(
        *(torch.from_numpy(x[k]) for k in order))]
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-7)
    if kind == METAL:
        assert 0 < got[2].sum() < len(got[2])
    if kind == DIELECTRIC:
        flipped = got[0][:, 2] * x["omega_i"][:, 2] > 0  # reflected
        assert 0 < flipped.sum() < len(flipped)


def test_build_pt_matches_jax(built):
    """The floor pool and the sphere pads equal, the mesh's host arrays
    and walk table equal, the background the JAX one's parameters, and the
    sky on seeded directions to 1 ulp."""
    (jscene, jcam, jbg, jmesh), (scene, cam, bg, mesh) = built
    np.testing.assert_array_equal(cam.look_at, jcam.look_at)
    for name in ("center", "radius", "valid", "shade_pack", "tri_pack",
                 "tri_valid"):
        np.testing.assert_array_equal(getattr(scene, name).numpy(),
                                      np.asarray(getattr(jscene, name)),
                                      err_msg=name)
    assert scene.tri_count == 128 and int(scene.tri_valid.sum()) == 2
    for name in ("nodes_lo", "nodes_hi", "meta_np", "tri_a", "tri_e1",
                 "tri_e2", "mat_row"):
        np.testing.assert_array_equal(getattr(mesh, name),
                                      np.asarray(getattr(jmesh, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(mesh.table_np.view(np.uint32),
                                  jmesh._table_np.view(np.uint32))
    assert mesh.watertight and jmesh.watertight
    assert bg == jbg.pallas_params == shirley.BACKGROUND
    rng = np.random.default_rng(1)
    d = rng.normal(size=(2048, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(shirley.sky(bg, torch.from_numpy(d)).numpy(),
                               np.asarray(jbg(jnp.asarray(d))),
                               rtol=2.4e-7, atol=0)
    with pytest.raises(ValueError):
        shirley.sky((0, bg[1]), torch.from_numpy(d))


@pytest.mark.parametrize("backface", [False, True])
def test_flip_y_tile_table_matches_jax(built, backface):
    """build_tile_tri_table(..., flip_y=True) against the JAX one: table,
    CSR and chunk sources equal; the flip moves the lists (the PPM film
    map gives another table)."""
    (_, jcam, _, jmesh), (_, cam, _, mesh) = built
    want = jttk.build_tile_tri_table(
        jcam, jmesh.tri_a, jmesh.tri_e1, jmesh.tri_e2, W, H, bvh=jmesh,
        backface_cull=backface, flip_y=True)
    got = ttk.build_tile_tri_table(
        cam, mesh.tri_a, mesh.tri_e1, mesh.tri_e2, W, H, bvh=mesh,
        backface_cull=backface, flip_y=True)
    assert (got.tx_n, got.ty_n, got.zero_chunk) == (want.tx_n, want.ty_n,
                                                    want.zero_chunk)
    for name in ("table", "tile_chunk_start", "tile_chunk_src"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    ppm_map = ttk.build_tile_tri_table(
        cam, mesh.tri_a, mesh.tri_e1, mesh.tri_e2, W, H, bvh=mesh,
        backface_cull=backface)
    assert not np.array_equal(ppm_map.table, got.table)
    np.testing.assert_array_equal(
        ttk._tile_corner_dirs(cam, W, H, 2, 2, flip_y=True),
        jttk._tile_corner_dirs(jcam, W, H, 2, 2, flip_y=True))


def test_tiny_pass_matches_jax_tile_pass(built, monkeypatch):
    """Pass 0 at spp 1, 4 bounces, against the JAX tiled pass with the
    tile kernel at bounce 0 (PATHTRACER_PT_TILE_TRI=1, interpret mode), as
    tests/test_tile_tri.py runs it: segments equal, the image to rtol 1e-3
    / atol 1e-4."""
    (jscene, jcam, jbg, jmesh), (scene, cam, bg, mesh) = built
    monkeypatch.setenv("PATHTRACER_PT_TILE_TRI", "1")
    pf = jmake_pass_fn(jcam, jbg, W, H, 1, 4, backend="pallas2_interpret",
                       tiled=True, mesh=jmesh)
    tt = tuple(jnp.asarray(x) for x in pf.tile_tri_arrays())
    want, want_segs = pf(jscene, 0, mesh_consts=jmesh.device_consts(),
                         tile_tri=tt)
    r = MeshRenderer(scene, cam, bg, W, H, 1, 4, CPU, mesh)
    rad, segs = r.trace_pass(0)
    got = r.image(rad).numpy()
    assert int(segs) == int(want_segs) > W * H
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)


def test_tile_bounce0_matches_walk_bounce0(built):
    """The port's pass with the tile kernel at bounce 0 and with the walk
    at every bounce: segments equal, the image to rtol 1e-3 / atol 1e-4
    (an exact tie in t goes to the lowest index in the tile kernel and to
    the first triangle met in the walk). The tile kernel meets the mesh on
    some primaries and misses on others."""
    _, (scene, cam, bg, mesh) = built
    r = MeshRenderer(scene, cam, bg, W, H, 1, 4, CPU, mesh)
    offset, org, d, alive = r.primary(0)
    hit0 = r.mesh_intersect0(org, d, alive)[4]
    assert 100 < int(hit0.sum()) < W * H - 100
    tiled = trace(r.sampler, org, d, offset, 4, r.sky_colors, alive,
                  r.hit_setup, r.hit_setup0)
    walked = trace(r.sampler, org, d, offset, 4, r.sky_colors, alive,
                   r.hit_setup)
    assert int(tiled[1]) == int(walked[1])
    np.testing.assert_allclose(tiled[0].numpy(), walked[0].numpy(),
                               rtol=1e-3, atol=1e-4)


def test_tiny_render_matches_jax_render(built, monkeypatch):
    """make_render_fn(..., mesh=mesh) at spp 2, 4 bounces against the JAX
    make_render_fn on the CPU (raster order, the walk at every bounce):
    segments equal, the image to rtol 1e-3 / atol 1e-4. A second render
    of the same scene reuses the renderer and gives the same image."""
    (jscene, jcam, jbg, jmesh), (scene, cam, bg, mesh) = built
    want, want_segs = jmake_render_fn(jcam, jbg, W, H, 2, 4,
                                      mesh=jmesh)(jscene)
    builds = []
    build = ttk.build_tile_tri_table
    monkeypatch.setattr(ttk, "build_tile_tri_table",
                        lambda *a, **k: builds.append(k) or build(*a, **k))
    render = make_render_fn(cam, bg, W, H, 2, 4, CPU, mesh=mesh)
    img, segs = render(scene)
    assert segs == int(want_segs) > 2 * W * H
    assert img.shape == (H, W, 3) and np.isfinite(img.numpy()).all()
    np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)
    again, segs_again = render(scene)
    assert segs_again == segs and torch.equal(again, img)
    assert len(builds) == 1 and builds[0]["flip_y"]
