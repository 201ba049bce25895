"""The CUDA kernels of pathtracer_tpu_torch against their plain PyTorch
versions, on the card. These tests need an NVIDIA GPU and nvcc, and skip
without them. This file imports no JAX (the machine with the card has none),
so it runs there without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: the kernels are built without FMA contraction and fast math,
so they round every operation as their plain versions do: the fused bounce
and compaction must equal their plain versions exactly (state, radiance,
alive flags, offsets). The small render is held to the budget of
tests/test_golden.py, and to the CPU render of the same image: the same
segments, and pixels within 1e-4. The CPU's vectorised sin/cos differ from
CUDA's in the last bit, and the film's convolution sums in another order;
measured on an H100: equal segments, 7 of 12,800 pixels apart, by at most
4.3e-6.

The photon mapper's three kernels (nearest sphere, nearest triangle, chunk
gather) must equal their plain versions exactly too. The cornell render on
the card is held to the same render on the CPU: photon map lengths within
0.5% and image RMSE <= 1e-3. Not bit-equal, because the glue's
sin/cos/acos may differ by an ulp between the devices and flip a few photon
paths."""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import ppm
from pathtracer_tpu_torch.integrator import Renderer, make_render_fn
from pathtracer_tpu_torch.models import cornell, shirley
from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk
from pathtracer_tpu_torch.scene import TRI_A, TRI_E1, TRI_E2

ROOT = os.path.join(os.path.dirname(__file__), "..")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_fused_bounce_kernel_matches_plain(dev):
    scene, cam, bg = shirley.build(2.0, dev)
    r = Renderer(scene, cam, bg, 128, 64, 1, 3, dev)
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128, device=dev)
    for b in range(3):
        args = (r.sph_table, state, r.pack_table, off,
                r.sampler.limbs(2 + 2 * b, 3 + 2 * b), bg[1], rad)
        kw = dict(bg_mode=bg[0], origin_zero=b == 0,
                  block_lists=(r.lists, r.counts) if b == 0 else None)
        before = fbk.fused_bounce.launches
        st_k, rad_k = fbk.fused_bounce(*args, **kw)
        assert fbk.fused_bounce.launches == before + 1
        st_p, rad_p = fbk.fused_bounce_plain(*args, **kw)
        assert torch.equal(st_k, st_p), (st_k - st_p).abs().max()
        assert torch.equal(rad_k, rad_p), (rad_k - rad_p).abs().max()
        state, rad = st_k, rad_k


@pytest.mark.parametrize("frac", [0.0, 0.03, 0.5, 1.0])
def test_compact_kernel_bit_identical(dev, frac):
    rng = np.random.default_rng(int(frac * 100))
    rows = 40
    state = rng.standard_normal((10, rows, 128)).astype(np.float32)
    state[9] = rng.random((rows, 128)) < frac
    off = rng.integers(-2 ** 31, 2 ** 31, size=(rows, 128), dtype=np.int64)
    state = torch.from_numpy(state).to(dev)
    off = torch.from_numpy(off.astype(np.int32)).to(dev)
    got = ck.compact_blocks(state, off)
    want = ck.compact_blocks_plain(state, off)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_wrappers_refuse_malformed_input(dev):
    state = torch.zeros(10, 8, 128, device=dev)
    with pytest.raises(ValueError):
        ck.compact_blocks(state, torch.zeros(8, 128, dtype=torch.int64,
                                             device=dev))
    with pytest.raises(ValueError):
        ck.compact_blocks(state[:, :7], torch.zeros(7, 128, dtype=torch.int32,
                                                    device=dev))
    sph = torch.zeros(4, 8, device=dev)
    pack = torch.zeros(10, 1, 128, device=dev)
    off = torch.zeros(8, 128, dtype=torch.int32, device=dev)
    rad = torch.zeros(3, 8, 128, device=dev)
    limbs = np.zeros((2, 2), np.uint32)
    bgc = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
    with pytest.raises(ValueError):  # radiance on the CPU
        fbk.fused_bounce(sph, state, pack, off, limbs, bgc, rad.cpu(),
                         bg_mode=1, origin_zero=False)
    with pytest.raises(ValueError):  # not contiguous
        fbk.fused_bounce(sph, state.transpose(1, 2).contiguous()
                         .transpose(1, 2), pack, off, limbs, bgc, rad,
                         bg_mode=1, origin_zero=False)


def test_card_render_equals_cpu_render(dev):
    """The same 160x80 spp=2 render through the kernels on the card and
    through their plain versions on the CPU."""
    scene, cam, bg = shirley.build(2.0, dev)
    fbk.fused_bounce.launches = ck.compact_blocks.launches = 0
    img_k, segs_k = make_render_fn(cam, bg, 160, 80, 2, 8, dev)(scene)
    assert fbk.fused_bounce.launches > 0 and ck.compact_blocks.launches > 0
    cpu = torch.device("cpu")
    scene_c, cam_c, bg_c = shirley.build(2.0, cpu)
    img_c, segs_c = make_render_fn(cam_c, bg_c, 160, 80, 2, 8, cpu)(scene_c)
    assert segs_k == segs_c
    assert (img_k.cpu() - img_c).abs().max() <= 1e-4


def test_small_render_on_card_matches_golden(dev):
    g = np.load(os.path.join(ROOT, "scenes", "golden_shirley_160x80_spp4.npz"))
    scene, cam, bg = shirley.build(2.0, dev)
    fbk.fused_bounce.launches = ck.compact_blocks.launches = 0
    img, segs = make_render_fn(cam, bg, 160, 80, 4, 8, dev)(scene)
    assert fbk.fused_bounce.launches > 0 and ck.compact_blocks.launches > 0
    img = img.cpu().numpy().astype(np.float64)
    rmse = float(np.sqrt(np.mean((img - g["img"]) ** 2)))
    assert rmse < 2.5e-3, rmse
    assert abs(segs - int(g["segments"])) < 100, segs


def _cornell_rays(dev, n=8192, seed=0):
    """Rays from around the cornell box in camera space, with one
    all-dead block and dead lanes elsewhere."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    org[:, 2] -= 1.5
    org[: n // 4] = 0.0  # primary rays from the camera
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[n // 2:] *= rng.uniform(0.2, 3.0, (n - n // 2, 1)).astype(np.float32)
    alive = rng.random(n) < 0.8
    alive[1024:2048] = False
    t = lambda x: torch.from_numpy(x).to(dev)
    return t(org), t(d), t(alive)


def test_intersect_spheres_kernel_matches_plain(dev):
    scene, _, _ = cornell.build(1.0, dev)
    table = sk.pack_spheres(scene.center, scene.radius, scene.valid)
    org, d, alive = _cornell_rays(dev)
    before = sk.intersect_spheres.launches
    got = sk.intersect_spheres(table, org, d, alive)
    assert sk.intersect_spheres.launches == before + 1
    want = sk.intersect_spheres_plain(table, org, d, alive)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].any()) and not bool(got[2][1024:2048].any())


def test_intersect_tris_kernel_matches_plain(dev):
    scene, _, _ = cornell.build(1.0, dev)
    tp = scene.tri_pack
    table = tk.pack_tris(tp[:, TRI_A], tp[:, TRI_E1], tp[:, TRI_E2],
                         scene.tri_valid)
    org, d, alive = _cornell_rays(dev, seed=1)
    before = tk.intersect_tris.launches
    got = tk.intersect_tris(table, org, d, alive)
    assert tk.intersect_tris.launches == before + 1
    want = tk.intersect_tris_plain(table, org, d, alive)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].any()) and not bool(got[2][1024:2048].any())


def test_gather_kernel_matches_plain(dev):
    """The gather of a real 96x96 cornell iteration, every block."""
    scene, cam, lights = cornell.build(1.0, dev)
    trace, _, _ = ppm.make_photon_pass(scene, lights, 5000, 4)
    pos, nrm, flux, ok, _ = trace(0)
    photons_t, sbox = gk.build_photon_chunks(pos, nrm, flux, ok)
    eye = ppm.make_eye_pass(cam, 96, 96, 4, 5000, scene)
    r = ppm.PPMRenderer(scene, cam, lights, 96, 96).radius(1)
    pt, nm, _, act = eye.walk(0)
    perm = torch.argsort(gk.hit_morton_keys(pt, act), stable=True)
    args = (pt[perm].contiguous(), nm[perm].contiguous(), act[perm], sbox,
            photons_t, r)
    before = gk.gather_flux_chunks.launches
    got = gk.gather_flux_chunks(*args)
    assert gk.gather_flux_chunks.launches == before + 1
    want = gk.gather_flux_chunks_plain(*args)
    assert torch.equal(got, want), (got - want).abs().max()
    assert float(got.abs().sum()) > 0


def test_cornell_card_render_matches_cpu(dev):
    """96x96, 2 iterations, 5,000 photons, 4 bounces on the card and on the
    CPU."""
    def render(device):
        scene, cam, lights = cornell.build(1.0, device)
        r = ppm.PPMRenderer(scene, cam, lights, 96, 96, iterations=2,
                            photon_count=5000, verbose=False)
        img = r.render().cpu().numpy()
        return img, [int(n) for n in r.photon_map_lengths]

    sk.intersect_spheres.launches = tk.intersect_tris.launches = 0
    gk.gather_flux_chunks.launches = 0
    img_k, n_k = render(dev)
    assert (sk.intersect_spheres.launches > 0 and tk.intersect_tris.launches
            > 0 and gk.gather_flux_chunks.launches > 0)
    img_c, n_c = render(torch.device("cpu"))
    rmse = float(np.sqrt(np.mean((img_k - img_c) ** 2)))
    print(f"cornell 96x96 card vs cpu: photon map lengths {n_k} vs {n_c}, "
          f"rmse {rmse:.3e}, max {np.abs(img_k - img_c).max():.3e}")
    assert np.isfinite(img_k).all()
    for a, b in zip(n_k, n_c):
        assert abs(a - b) <= 0.005 * b, (n_k, n_c)
    assert rmse <= 1e-3, rmse


def test_ppm_wrappers_refuse_malformed_input(dev):
    table = torch.zeros(4, 8, device=dev)
    org = torch.zeros(1024, 3, device=dev)
    alive = torch.ones(1024, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):  # not a multiple of 1024 rays
        sk.intersect_spheres(table, org[:1000], org[:1000], alive[:1000])
    with pytest.raises(ValueError):  # table on the CPU
        sk.intersect_spheres(table.cpu(), org, org, alive)
    with pytest.raises(ValueError):  # alive is not bool
        tk.intersect_tris(torch.zeros(9, 128, device=dev), org, org,
                          torch.ones(1024, device=dev))
    with pytest.raises(ValueError):  # photons_t of the wrong width
        gk.gather_flux_chunks(org, org, alive,
                              torch.zeros(6, 8, device=dev),
                              torch.zeros(16, 128, device=dev), 0.1)
