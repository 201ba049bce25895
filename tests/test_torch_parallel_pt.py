"""The dp x sp sharded path tracer of pathtracer_tpu_torch (parallel/mesh.py)
on the CPU (the kernels' plain versions), and the pieces under it: the
band renderers, the band maps of the tile table and the tile rows of the
sphere lists, against the port's own whole-image render and the JAX
package.

Multi-rank runs go through parallel.group.spawn: gloo ranks of one thread
each, in new processes that import the port only, joined by a file://
rendezvous under tmp_path. Each module fixture spawns once and renders
every configuration of its world size there.

Tolerances, and why:
  - bands, stitched, and sp-only splits against the whole image: equal
    (torch.equal); each lane's result does not depend on its band, and the
    segments are integers;
  - a dp split adds its passes in other groups: atol 1e-5, the JAX
    package's own (tests/test_sharding.py), with equal segments;
  - the port at (dp, sp) = (2, 2) against the JAX sharded render on the 8
    virtual CPU devices: the bounds of test_torch_render.py's wavefront
    test (segments within 0.1%, at most 1% of the samples' pixels off by
    more than 1e-3, the mean within 1e-3 relative), with the pixel share
    taken after the film: its 3x3 filter spreads each sample that differs
    over 9 pixels, so at most 9% of the pixels. XLA contracts FMAs and
    rounds sin/cos otherwise, and a path an ulp turns changes its sample.
    Measured: 4,394 vs 4,393 segments, 24 of 512 pixels off, the mean
    -7.0e-4 relative; the port's one-device render reads the same.
  - host tables (band maps, sphere lists): equal."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu import integrator as jint
from pathtracer_tpu.io import ply as jply
from pathtracer_tpu.models import ganesha as jganesha
from pathtracer_tpu.models import shirley as jshirley
from pathtracer_tpu.ops.pallas import tile_tri_kernel as jttk
from pathtracer_tpu.parallel.mesh import make_mesh as jmake_mesh
from pathtracer_tpu.parallel.mesh import (
    make_sharded_render_fn as jmake_sharded_render_fn)
from pathtracer_tpu_torch import integrator
from pathtracer_tpu_torch.integrator import (TILE, MeshRenderer, Renderer,
                                             make_render_fn)
from pathtracer_tpu_torch.models import ganesha, shirley
from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
from pathtracer_tpu_torch.parallel import group

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402

PT = "pathtracer_tpu_torch.parallel.ranks:render_pt"
# the spawned shirley renders: W x H, spp, bounces (H = 40: the last
# 32-row band overhangs the image; spp = 5 leaves padded passes on dp > 1)
SHIRLEY = dict(scene="shirley", width=64, height=40, spp=5, bounces=4)
# the tiny ganesha under the sky: 64x64 (two tile rows)
MESH = dict(scene="ganesha_pt", width=64, height=64, spp=2, bounces=3)
# the cross-check against the JAX sharded render
JAX_CFG = dict(scene="shirley", width=32, height=16, spp=4, bounces=3,
               dp=2, sp=2)
WORLD4 = [(1, 4), (2, 2), (4, 1)]
WORLD2 = [(1, 2), (2, 1)]
MESH_SPLITS = [(2, 2), (1, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread in this process while the module runs, as in
    the spawned ranks: the test workers share the machine's cores, and
    small tensors split over many threads wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_ply(tmp_path_factory):
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    path = str(tmp_path_factory.mktemp("parallel_pt") / "tiny_ganesha.ply")
    jply.write_mesh(path, verts, faces)
    return path


@pytest.fixture(scope="module")
def world4(tiny_ply, tmp_path_factory):
    """{(scene, dp, sp): rank 0's result} of every world-4 render, and the
    JAX cross-check's under "jax"."""
    specs = ([dict(SHIRLEY, dp=dp, sp=sp) for dp, sp in WORLD4]
             + [dict(MESH, ply=tiny_ply, dp=dp, sp=sp)
                for dp, sp in MESH_SPLITS] + [JAX_CFG])
    out = group.spawn(PT, 4, "cpu", None,
                      str(tmp_path_factory.mktemp("rdv4")), specs)
    keys = ([("shirley",) + k for k in WORLD4]
            + [("ganesha_pt",) + k for k in MESH_SPLITS] + ["jax"])
    return dict(zip(keys, out))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    specs = [dict(SHIRLEY, dp=dp, sp=sp) for dp, sp in WORLD2]
    out = group.spawn(PT, 2, "cpu", None,
                      str(tmp_path_factory.mktemp("rdv2")), specs)
    return {("shirley",) + k: o for k, o in zip(WORLD2, out)}


@pytest.fixture(scope="module")
def one_device(tiny_ply):
    """make_render_fn's image and segments of the shirley and mesh
    configurations."""
    out = {}
    scene, cam, bg = shirley.build(SHIRLEY["width"] / SHIRLEY["height"], CPU)
    out["shirley"] = make_render_fn(cam, bg, SHIRLEY["width"],
                                    SHIRLEY["height"], SHIRLEY["spp"],
                                    SHIRLEY["bounces"], CPU)(scene)
    scene, cam, bg, mesh = ganesha.build_pt(tiny_ply, 1.0, CPU)
    out["ganesha_pt"] = make_render_fn(cam, bg, MESH["width"],
                                       MESH["height"], MESH["spp"],
                                       MESH["bounces"], CPU,
                                       mesh=mesh)(scene)
    return out


def _stitched(make, height, sp):
    """The sp bands of tile rows through make(tile_row0, band) -> renderer,
    their raw sums stitched and cut to the image, and the segments."""
    tyn = -(-height // TILE)
    band = -(-tyn // sp)
    parts, segments = [], 0
    for s in range(sp):
        r = make(s * band, band)
        sums, segs = r.band_sums(range(r.spp))
        parts.append(r.band_image(sums))
        segments += int(segs)
    return torch.cat(parts)[:height], segments


@pytest.mark.parametrize("height,sp", [(48, 2), (48, 4), (40, 2), (40, 4)])
def test_renderer_bands_equal_whole_image(height, sp):
    """Renderer over sp bands (H = 40: the last band overhangs the image;
    sp = 4 at H = 48 leaves a band past it) against the whole image: the
    raw sums equal bit for bit, the segments too."""
    W = 64
    scene, cam, bg = shirley.build(W / height, CPU)
    whole = Renderer(scene, cam, bg, W, height, 2, 4, CPU)
    sums, segs = whole.band_sums(range(2))
    got, got_segs = _stitched(
        lambda row0, band: Renderer(scene, cam, bg, W, height, 2, 4, CPU,
                                    tile_row0=row0, band_tile_rows=band),
        height, sp)
    assert torch.equal(got, whole.image(sums))
    assert got_segs == int(segs) > W * height


@pytest.mark.parametrize("sp", [2, 4])
def test_mesh_renderer_bands_equal_whole_image(tiny_ply, sp):
    """MeshRenderer over sp bands of the tiny ganesha at 64x64 (sp = 4:
    two bands past the image, with the zero chunk's tile maps) against the
    whole image: equal sums and segments."""
    scene, cam, bg, mesh = ganesha.build_pt(tiny_ply, 1.0, CPU)
    args = (scene, cam, bg, 64, 64, 1, 3, CPU, mesh)
    whole = MeshRenderer(*args)
    sums, segs = whole.band_sums(range(1))
    got, got_segs = _stitched(
        lambda row0, band: MeshRenderer(*args, tile_row0=row0,
                                        band_tile_rows=band), 64, sp)
    assert torch.equal(got, whole.image(sums))
    assert got_segs == int(segs) > 64 * 64


@pytest.mark.parametrize("band_rows", [32, 64])
def test_band_tile_maps_match_jax_band_chunk_maps(tiny_ply, band_rows):
    """band_tile_maps against JAX band_chunk_maps at 64x80 (three tile
    rows; 64-row bands overhang, and min_bands adds an all-dead band): the
    same chunk sources per tile, the tiles past the image on the zero
    chunk alone, no padding entries, and a CSR over exactly the band's
    tiles."""
    W, H = 64, 80
    (_, jcam, _, jmesh) = jganesha.build_pt(tiny_ply, W / H)
    _, cam, _, mesh = ganesha.build_pt(tiny_ply, W / H, CPU)
    want_tt = jttk.build_tile_tri_table(jcam, jmesh.tri_a, jmesh.tri_e1,
                                        jmesh.tri_e2, W, H, bvh=jmesh)
    tt = ttk.build_tile_tri_table(cam, mesh.tri_a, mesh.tri_e1, mesh.tri_e2,
                                  W, H, bvh=mesh)
    bands, n_tiles = jttk.band_chunk_maps(want_tt, band_rows, min_bands=4)
    assert len(bands) == 4 and n_tiles == band_rows // TILE * tt.tx_n
    for bi, (cs, ct, _) in enumerate(bands):
        start, src = ttk.band_tile_maps(tt, bi * band_rows // TILE,
                                        band_rows // TILE)
        assert start.dtype == src.dtype == np.int32
        assert start.shape == (n_tiles + 1,) and start[-1] == len(src)
        for t in range(n_tiles):
            got = src[start[t]:start[t + 1]]
            np.testing.assert_array_equal(got, cs[ct == t],
                                          err_msg=f"band {bi} tile {t}")
            if bi * band_rows + (t // tt.tx_n) * TILE >= H:
                np.testing.assert_array_equal(got, [tt.zero_chunk])
    start, src = ttk.band_tile_maps(tt, 0, tt.ty_n)
    np.testing.assert_array_equal(start, tt.tile_chunk_start)
    np.testing.assert_array_equal(src, tt.tile_chunk_src)


def test_tile_sphere_lists_tile_rows_match_jax():
    """tile_sphere_lists(tile_rows=) against the JAX function: shirley at
    64x40 over 4 tile rows (two past the image) and over the image's 2."""
    W, H = 64, 40
    jscene, jcam, _ = jshirley.build(W / H)
    scene, cam, _ = shirley.build(W / H, CPU)
    for rows in (4, None):
        want = jint.tile_sphere_lists(jcam, np.asarray(jscene.center),
                                      np.asarray(jscene.radius),
                                      np.asarray(jscene.valid), W, H,
                                      tile_rows=rows)
        got = integrator.tile_sphere_lists(cam, scene.center.numpy(),
                                           scene.radius.numpy(),
                                           scene.valid.numpy(), W, H,
                                           tile_rows=rows)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape[0] == (rows or 2) * 2


@pytest.mark.parametrize("dp,sp", WORLD4 + WORLD2)
def test_sharded_render_matches_one_device(world4, world2, one_device, dp,
                                           sp):
    """make_sharded_render_fn at (dp, sp) on 4 or 2 gloo ranks, shirley at
    64x40, spp 5: sp-only equal to make_render_fn bit for bit, dp > 1 at
    atol 1e-5; the segments equal; every rank returns the same image."""
    got = {**world4, **world2}[("shirley", dp, sp)]
    want, want_segs = one_device["shirley"]
    assert got["segments"] == want_segs
    assert got["img"].shape == (SHIRLEY["height"], SHIRLEY["width"], 3)
    if dp == 1:
        assert torch.equal(got["img"], want)
    else:
        np.testing.assert_allclose(got["img"].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5)
    assert got["same_on_every_rank"]


@pytest.mark.parametrize("dp,sp", MESH_SPLITS)
def test_sharded_mesh_render_matches_one_device(world4, one_device, dp, sp):
    """The tiny ganesha under the sky at (2, 2) and (1, 4) (two bands past
    the image) against make_render_fn(..., mesh=mesh): the same checks."""
    got = world4[("ganesha_pt", dp, sp)]
    want, want_segs = one_device["ganesha_pt"]
    assert got["segments"] == want_segs
    if dp == 1:
        assert torch.equal(got["img"], want)
    else:
        np.testing.assert_allclose(got["img"].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5)


def test_sharded_render_matches_jax_sharded_render(world4):
    """The port at (2, 2) against JAX make_sharded_render_fn(make_mesh(2,
    2)) on the virtual CPU devices, shirley at 32x16, spp 4, 3 bounces."""
    c = JAX_CFG
    jscene, jcam, jbg = jshirley.build(c["width"] / c["height"])
    render = jmake_sharded_render_fn(jcam, jbg, c["width"], c["height"],
                                     c["spp"], c["bounces"],
                                     jmake_mesh(2, 2, jax.devices()[:4]))
    want, want_segs = render(jscene)
    want, want_segs = np.asarray(want), int(want_segs)
    got = world4["jax"]
    img = got["img"].numpy()
    assert abs(got["segments"] - want_segs) <= 1e-3 * want_segs
    bad = (np.abs(img - want) > 1e-3).any(axis=-1)
    assert bad.mean() <= 9 * 0.01, (bad.sum(), np.abs(img - want).max())
    assert abs(img.mean() / want.mean() - 1) < 1e-3


def test_init_refuses_missing_cuda_and_wrong_backends(tmp_path):
    """No fallback: CUDA asked for without a card raises, the CPU takes
    gloo only, and a spawned rank whose entry point imports JAX (here
    the JAX package's renderer) raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            group.init("cuda", rank=0, world_size=1)
    with pytest.raises(ValueError, match="gloo"):
        group.init("cpu", backend="nccl", rank=0, world_size=1)
    with pytest.raises(ValueError, match="<module>:<function>"):
        group.spawn("render_pt", 1, "cpu", None, "unused", None)
    with pytest.raises(Exception, match="imports jax"):
        group.spawn("pathtracer_tpu.integrator:make_render_fn", 1, "cpu",
                    None, str(tmp_path), None)
