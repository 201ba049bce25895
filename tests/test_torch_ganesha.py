"""The ganesha slice of pathtracer_tpu_torch as a whole, on the CPU (the
kernels' plain versions): the tiny-ganesha PPM render against the JAX
renderer, the port's tile path against its own walk path, and the ganesha
and ply-describe CLIs against the JAX CLI.

The tiny ganesha is tests/test_tile_tri.py's: a 12x8 uv-sphere of 168
triangles where the ganesha camera looks, over the checkered floor, lit by
the two spot lights; 64x64, 1 iteration, 1,000 photons, 3 bounces.

Tolerances: photon map lengths equal; images to rtol 1e-3 / atol 1e-4
(test_tile_tri.py's bounds for the JAX tile-vs-walk renders) where both
sides gather the same deposits. The JAX renderer on the CPU gathers photons
through the XLA hash grid and the port through the chunk gather, which sum
in other orders, and the port's glue rounds sin/cos/acos like torch, not
like XLA (tests/test_torch_ppm.py); the two intersectors accept the same
triangles with the same rule. Each test states its own bound."""

import os
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu import cli as jcli
from pathtracer_tpu.io import ply as jply
from pathtracer_tpu.models import ganesha as jganesha
from pathtracer_tpu.ppm import PPMRenderer as JPPMRenderer
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.integrator import Intersector
from pathtracer_tpu_torch.models import ganesha
from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
from pathtracer_tpu_torch.ppm import (PPMRenderer, make_eye_pass,
                                      make_photon_pass, scene_all_diffuse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TEST_PLY = os.path.join(ROOT, "scenes", "test_ganesha.ply")
CPU = torch.device("cpu")
W = H = 64
KW = dict(iterations=1, photon_count=1000, max_bounces=3, verbose=False)
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402


@pytest.fixture(scope="module")
def tiny_ply(tmp_path_factory):
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    path = str(tmp_path_factory.mktemp("ganesha") / "tiny_ganesha.ply")
    jply.write_mesh(path, verts, faces)
    return path


def _port_render(path, tile_primary):
    scene, cam, lights, mesh = ganesha.build(path, 1.0, CPU)
    rend = PPMRenderer(scene, cam, lights, W, H, mesh=mesh,
                       tile_primary=tile_primary, **KW)
    img = rend.render().numpy()
    return img, [int(n) for n in rend.photon_map_lengths], rend


@pytest.fixture(scope="module")
def jax_render(tiny_ply):
    """The JAX renderer's tiny ganesha (tile kernel in interpret mode): its
    image and its iteration's photon deposits (pos, nrm, flux, valid)."""
    scene, cam, lights, mesh, bbox = jganesha.build(tiny_ply, 1.0)
    deps = []

    def phase_cb(name, value):
        if name == "photon_trace":
            deps.append([np.asarray(x) for x in value])

    img = np.asarray(JPPMRenderer(
        scene, cam, lights, W, H, mesh=mesh, bbox_override=bbox,
        tile_primary=True, phase_cb=phase_cb, **KW).render())
    return img, deps[0]


def test_tiny_ganesha_photon_pass_matches_jax(tiny_ply, jax_render):
    """Deposits through the mesh walk: the valid masks (so the photon map
    lengths) and the flux equal. Positions to 1e-4 of the deposit's largest
    coordinate: torch and XLA round the emission's sin/cos differently
    within an ulp, and the far floor, met at grazing angles, stretches that
    ulp along the ground (measured 2.8e-5 relative, 2.8e-3 absolute)."""
    scene, _, lights, mesh = ganesha.build(tiny_ply, 1.0, CPU)
    trace, _, _ = make_photon_pass(scene, lights, KW["photon_count"],
                                   KW["max_bounces"], mesh)
    pos, nrm, flux, ok, _ = (x.numpy() for x in trace(0))
    jpos, jnrm, jflux, jok = jax_render[1]
    np.testing.assert_array_equal(ok, jok)
    assert int(ok.sum()) > 500
    err = np.abs(pos[ok] - jpos[ok]).max(axis=1)
    assert (err <= 1e-4 * np.abs(jpos[ok]).max(axis=1)).all()
    np.testing.assert_array_equal(flux[ok], jflux[ok])
    np.testing.assert_allclose(nrm[ok], jnrm[ok], atol=1e-5)


def test_mesh_intersector_gives_dense_rays(tiny_ply):
    """The photon pass feeds a bounce's hit points and directions to the
    next bounce's kernels, which take only row-major (N, 3) rays: the mesh
    branch of Intersector must keep them dense, and a lane the mesh
    wins takes the walk's t."""
    scene, _, lights, mesh = ganesha.build(tiny_ply, 1.0, CPU)
    trace, _, _ = make_photon_pass(scene, lights, 1000, 2, mesh)
    _, org, d, _, alive = trace.emit(0)
    h = Intersector(scene, mesh)(org, d, alive)
    for name in ("point", "normal", "albedo"):
        assert h[name].is_contiguous(), name
    t_m = mesh.intersect(org, d, torch.full_like(org[:, 0], 3e38), alive)
    on_mesh = t_m[4] & (t_m[0] <= h["t"])
    assert int(on_mesh.sum()) > 10
    np.testing.assert_allclose(h["t"][on_mesh], t_m[0][on_mesh], rtol=0)


def test_tiny_ganesha_eye_pass_on_jax_photons_matches_jax(tiny_ply,
                                                          jax_render):
    """The port's eye pass (the tile path, the renderer's default) over the
    JAX iteration's own deposits. Pixels that see the mesh give the JAX
    image at rtol 1e-3 / atol 1e-4. Floor pixels are held to that bound on
    99% of them and to 5e-3 absolute on all: the floor is two triangles of
    edge 10,000, so an ulp of the barycentric u or v that XLA rounds
    otherwise (FMA contraction) moves the hit point by ~6e-4, and a photon's
    cone weight 1 - dist/r with it (measured 12 of 4,096 pixels off, at
    most 2.7e-3)."""
    want, deps = jax_render
    scene, cam, lights, mesh = ganesha.build(tiny_ply, 1.0, CPU)
    rend = PPMRenderer(scene, cam, lights, W, H, mesh=mesh, **KW)
    assert scene_all_diffuse(scene, mesh)
    tile = rend.tile_tensors(1)
    assert tile is not None  # the default is the tile path
    eye = make_eye_pass(cam, W, H, KW["max_bounces"], KW["photon_count"],
                        scene, 1, mesh, tile)
    grid = gk.build_photon_chunks(*(torch.from_numpy(x.copy()) for x in deps))
    img = eye(0, rend.radius(1), grid).flip(0).numpy()
    assert np.isfinite(img).all() and img.max() > 0
    d = eye.primary(0)[2][:W * H]
    on_mesh = (ttk.intersect_tile_tris(*tile, d, W)[0] < ttk.BIG).numpy()
    on_mesh = on_mesh.reshape(H, W)[::-1]
    assert 100 < on_mesh.sum() < W * H - 100
    np.testing.assert_allclose(img[on_mesh], want[on_mesh], rtol=1e-3,
                               atol=1e-4)
    floor, want_f = img[~on_mesh], want[~on_mesh]
    off = (np.abs(floor - want_f) > 1e-4 + 1e-3 * np.abs(want_f)).any(-1)
    assert off.mean() <= 0.01
    np.testing.assert_allclose(floor, want_f, rtol=0, atol=5e-3)


def test_tiny_ganesha_matches_jax_tile_render(tiny_ply, jax_render):
    """The whole render: photon map lengths equal; the image at rtol 1e-3
    / atol 1e-4 but for floor pixels whose photon weights move with the
    floor's position ulps (the two tests above; measured 14 of 4,096
    pixels, at most 3.0e-3), held to 1% of the pixels and 2e-4 RMS."""
    want = jax_render[0]
    img, n_ph, rend = _port_render(tiny_ply, True)
    assert rend.tile_table is not None
    assert n_ph == [int(jax_render[1][3].sum())]
    assert img.shape == want.shape == (H, W, 3)
    assert np.isfinite(img).all() and img.max() > 0
    off = (np.abs(img - want) > 1e-4 + 1e-3 * np.abs(want)).any(axis=-1)
    assert off.mean() <= 0.01
    assert np.sqrt(np.mean((img - want) ** 2)) <= 2e-4


def test_tiny_ganesha_tile_path_matches_walk_path(tiny_ply):
    """The tile kernel and the walk on the eye rays: the same winners, so
    the same image (measured equal at this size; held to the JAX test's
    bounds, since an exact tie in t goes to the lowest index in the tile
    kernel and to the first one met in the walk)."""
    tile_img, tile_n, tile_r = _port_render(tiny_ply, True)
    walk_img, walk_n, walk_r = _port_render(tiny_ply, False)
    assert tile_r.tile_table is not None and walk_r.tile_table is None
    assert tile_n == walk_n
    np.testing.assert_allclose(tile_img, walk_img, rtol=1e-3, atol=1e-4)


def test_ganesha_cli_stats_match_jax_cli(capsys):
    cli.main(["ganesha", "--device", "cpu", "-ganesha-ply", TEST_PLY,
              "-stop-after-bvh"])
    got = capsys.readouterr().out.splitlines()
    jcli.main(["ganesha", "-ganesha-ply", TEST_PLY, "-stop-after-bvh"])
    want = capsys.readouterr().out.splitlines()

    def stats(lines):
        keep = [ln for ln in lines if ln.startswith(("#triangles",
                                                     "tree depth"))]
        i = lines.index("leaf lengths =")
        return keep + lines[i:i + 2]

    assert stats(got) == stats(want)
    assert got[-1] == "Stop after bvh build"
    assert any(ln.startswith("bvh bytes = ") for ln in got)


def test_ganesha_cli_renders_on_cpu(tiny_ply, tmp_path, capsys):
    from pathtracer_tpu.io.png import read_png

    out = str(tmp_path / "g.png")
    cli.main(["ganesha", "-ganesha-ply", tiny_ply, "-width", "40", "-height",
              "24", "-iterations", "1", "-photon-count", "600",
              "-max-bounces", "2", "-device", "cpu", "-no-progress", "-o",
              out])
    text = capsys.readouterr().out
    assert "ganesha bbox = " in text and "elapsed ms: " in text
    assert read_png(out).shape == (24, 40, 3)


def test_ply_describe_matches_jax_cli(capsys):
    cli.main(["ply-describe", TEST_PLY])
    got = capsys.readouterr().out.splitlines()
    jcli.run_ply_describe([TEST_PLY])
    want = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1]  # all but the parse time
    assert got[0] == "format = binary_little_endian"
