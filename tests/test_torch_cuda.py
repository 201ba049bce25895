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
paths.

The chunk gather and the tile-culled triangle kernel split long lists over
CTAs; their tests check that the input splits (a list longer than
gather_kernel.SEG, a tile of more than one chunk).

The mesh kernels (the BVH8 and BVH4 walks, the tile-culled triangle
kernel) must equal their plain versions exactly too, on a random triangle
soup with rays of exact-zero direction components and on a uv-sphere with
empty tiles, in the film maps of both the photon mapper and the path
tracer (flip_y), and the walks on photon bounces over test_ganesha.ply
and (BVH8) on the incoherent bounce rays of a path-traced pass. The
ganesha renders on the card, photon mapped and path traced (on either
walk), are held to the CPU renders by the cornell bounds.

The full-variant bounce kernels (fused and intersect_state) walk the
per-scene sphere hierarchy per warp; their tests check that the walk
skips leaves, and a copied sphere checks the lowest-index tie rule. The
BVH8 walk runs LANES_PER_RAY > 1 lanes per ray, the BVH4 walk
BVH4_LANES_PER_RAY > 1. The BVH4 walk reads node rows at phase > 0 from a
per-ray path cache and a leaf's pair rows two at a time, four triangles
against one best: its tests add a soup of duplicated triangles (exact
ties in t inside a leaf, leaves of 3-4 pair rows), axis-aligned rays and
lanes that end exactly at t_max0. It always counts (counts is required):
its outputs stay equal to the plain walk's, and its sums of the walked
rays and table loads equal the active lanes and the emulation's loads
(bvh4_walk_cached_plain); a render on a BVH4 mesh reads them once an
image, the same for an eager and a replayed first pass.

The two-kernel bounce (intersect_state, shade_state), the clustered sphere
kernel and the raster-grid gather must equal their plain versions exactly;
the two-kernel chain must equal the fused bounce kernel, and the
fuse_bounce=False render the fused render, exactly. The clustered kernel
finds the hits of intersect_spheres on every live lane; it walks only real
slots and skips clusters per warp, so its test also runs shuffled lanes,
lanes outside the skip's proof (whose NaN inv_a is compared as equal) and
784 full clusters, the wrapper's limit. The raster gather
sums the chunk gather's photons in another order (rtol 1e-4, atol 1e-6).

The renderers over bands of tile rows (the sharded path tracer's sp
split) must give the whole image's sums bit for bit on the card too.

The mesh renderer replays each pass as a CUDA graph on the card: its
renders must equal the eager passes of the same scene bit for bit, over
two mesh turns and a second scene object (a new capture), with the eager
launch counts, progress calls and pt.lanes, and no image may change under
a later replay.
The sphere renderer replays each pass as a CUDA graph on the card too,
its wavefront at the full width after the compaction: its renders must
equal eager renders of the same scene bit for bit (8 and 16 bounces, the
two-kernel bounce), with the eager launch counts and counters, and a
dropped renderer must free its graph's memory. The fused bounce must
equal its plain version on the full-width wavefront after the
compaction, whose dead blocks both pass through.
The photon mapper replays each iteration's photon pass, chunk build and
eye walk as a CUDA graph on the card: its renders (the small ganesha with
the tile eye pass, and cornell) must equal eager renders of the same
renderer bit for bit, before and after a new capture, with the eager
launch counts and counters, and no result may change under a later
replay.

The seeded shirley scenes (seeds 7 and 99999, their own lists) bring other
sphere counts and layouts: the fused bounce must equal its plain version
on them too, one render function switching between seed 42 and seed 7
must give each scene a fresh render function's image, and a 16-bounce
render (two compactions) is held to its CPU render by the small render's
bounds.

The triangle kernel skips pad columns and pre-rejects pairs: it must equal
its plain version on real columns scattered among pads (T = 45 and 1024),
on each case its header names (tests/test_torch_tri_pads.py) and on the
ganesha floor pool. The raster gather must equal its plain version on a
range of ~19,000 photons, which its batched walk takes, and its
branch-free square root must equal sqrtf on every finite float >= 0."""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import ppm
from pathtracer_tpu_torch.integrator import (MeshRenderer, Renderer,
                                             make_render_fn)
from pathtracer_tpu_torch.models import cornell, shirley
from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
from pathtracer_tpu_torch.ops.cuda import shade_kernel as shk
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


def _walk_skips(r, state):
    """Whether the full-variant walk on `state` skips a leaf in some warp
    with a live lane (its plain emulation's count)."""
    comps = [state[c].reshape(-1) for c in range(6)]
    alive = state[9].reshape(-1) > 0
    hier = r.sphere_hierarchy()
    *_, stats = sk.intersect_culled_plain(r.sph_table, hier, *comps, alive,
                                          origin_zero=False)
    n_leaves = hier.links.shape[0] - hier.n_groups
    live_warp = stats["live_lanes"] > 0
    return bool((stats["leaves_entered"][live_warp] < n_leaves).any())


def test_fused_bounce_kernel_matches_plain(dev):
    """Every bounce of a 256x128 shirley pass: bounce 0 listed, bounces 1-7
    through the walk of the sphere hierarchy, which skips leaves."""
    _fused_chain_matches_plain(dev, *shirley.build(2.0, dev))


@pytest.mark.parametrize("seed", [7, 99999])
def test_fused_bounce_kernel_matches_plain_on_seeded_scenes(dev, seed):
    """The same on the sphere lists of other seeds (use_manifest=False):
    another sphere count and layout, so other tile list widths, another
    hierarchy and other grown bounds for the walk's cull."""
    _fused_chain_matches_plain(dev, *shirley.build(2.0, dev, seed=seed,
                                                   use_manifest=False))


def _fused_chain_matches_plain(dev, scene, cam, bg):
    r = Renderer(scene, cam, bg, 256, 128, 1, 8, dev)
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128, device=dev)
    skipped = 0
    for b in range(8):
        args = (r.sph_table, state, r.pack_table, off,
                r.sampler.limbs(2 + 2 * b, 3 + 2 * b), bg[1], rad)
        kw = dict(bg_mode=bg[0], origin_zero=b == 0,
                  block_lists=(r.lists, r.counts) if b == 0 else None,
                  sphere_bvh=r.sphere_hierarchy())
        before = fbk.fused_bounce.launches
        st_k, rad_k = fbk.fused_bounce(*args, **kw)
        assert fbk.fused_bounce.launches == before + 1
        st_p, rad_p = fbk.fused_bounce_plain(*args, **kw)
        assert torch.equal(st_k, st_p), (b, (st_k - st_p).abs().max())
        assert torch.equal(rad_k, rad_p), (b, (rad_k - rad_p).abs().max())
        skipped += b > 0 and _walk_skips(r, state)
        state, rad = st_k, rad_k
    assert skipped >= 4


def test_fused_bounce_walk_ties_to_the_lowest_index(dev):
    """A sphere copied into a pad slot: the two have equal keys, sit in
    different places of the hierarchy, and the lower index must win, as in
    the plain version's first-index minimum."""
    scene, cam, bg = shirley.build(2.0, dev)
    r = Renderer(scene, cam, bg, 128, 64, 1, 3, dev)
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128, device=dev)
    state, rad = fbk.fused_bounce(
        r.sph_table, state, r.pack_table, off, r.sampler.limbs(2, 3), bg[1],
        rad, bg_mode=bg[0], origin_zero=True,
        block_lists=(r.lists, r.counts))
    sph = r.sph_table.clone()
    big = int(torch.argsort(scene.radius * scene.valid, descending=True)[1])
    sph[:, sph.shape[1] - 1] = sph[:, big]
    hier = sk.build_sphere_bvh(sph)
    assert int((hier.order == big).sum()) == 1
    assert int((hier.order == sph.shape[1] - 1).sum()) == 1
    args = (sph, state, r.pack_table, off, r.sampler.limbs(4, 5), bg[1], rad)
    kw = dict(bg_mode=bg[0], origin_zero=False, sphere_bvh=hier)
    st_k, rad_k = fbk.fused_bounce(*args, **kw)
    st_p, rad_p = fbk.fused_bounce_plain(*args, **kw)
    assert torch.equal(st_k, st_p) and torch.equal(rad_k, rad_p)
    at, idx = sk.intersect_state(sph, state, origin_zero=False,
                                 sphere_bvh=hier)
    want = sk.intersect_state_plain(sph, state, origin_zero=False)
    assert torch.equal(at, want[0]) and torch.equal(idx, want[1])
    assert int((idx == big).sum()) > 0


def test_fused_bounce_kernel_matches_plain_after_the_compaction(dev):
    """Bounces 3-7 of a 256x128 shirley pass as the render runs them: the
    compaction at bounce 3 packs the live lanes into the first rows, and
    the wavefront keeps its width, the blocks after them dead, which both
    versions pass through."""
    scene, cam, bg = shirley.build(2.0, dev)
    r = Renderer(scene, cam, bg, 256, 128, 1, 8, dev)
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128, device=dev)
    for b in range(8):
        if b == 3:
            state, off, n_used = ck.pack_rows(*ck.compact_blocks(state, off))
            rad = torch.zeros_like(rad)
            assert 0 < int(n_used) <= state.shape[1] - 16
        args = (r.sph_table, state, r.pack_table, off,
                r.sampler.limbs(2 + 2 * b, 3 + 2 * b), bg[1], rad)
        kw = dict(bg_mode=bg[0], origin_zero=b == 0,
                  block_lists=(r.lists, r.counts) if b == 0 else None,
                  sphere_bvh=r.sphere_hierarchy())
        st_k, rad_k = fbk.fused_bounce(*args, **kw)
        st_p, rad_p = fbk.fused_bounce_plain(*args, **kw)
        assert torch.equal(st_k, st_p) and torch.equal(rad_k, rad_p), b
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
    with pytest.raises(ValueError):  # the full variant without a hierarchy
        fbk.fused_bounce(sph, state, pack, off, limbs, bgc, rad, bg_mode=1,
                         origin_zero=False)


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


def test_render_fn_builds_the_sphere_hierarchy_once_per_scene(dev,
                                                              monkeypatch):
    """make_render_fn builds the hierarchy at the first render of a scene
    object and reuses it for later renders of that object."""
    from pathtracer_tpu_torch import integrator

    built = []
    build = integrator.build_sphere_bvh
    monkeypatch.setattr(integrator, "build_sphere_bvh",
                        lambda t: built.append(1) or build(t))
    scene, cam, bg = shirley.build(2.0, dev)
    render = make_render_fn(cam, bg, 64, 32, 1, 3, dev)
    first, _ = render(scene)
    again, _ = render(scene)
    assert len(built) == 1 and torch.equal(first, again)
    render(shirley.build(2.0, dev)[0])
    assert len(built) == 2


def test_render_fn_switches_seeded_scenes(dev):
    """One make_render_fn renders seed 42, seed 7 (its own list) and seed 42
    again: each image and segment count equals a fresh render function's,
    whose hierarchy is built for that scene alone."""
    s42 = shirley.build(2.0, dev)[0]
    s7, cam, bg = shirley.build(2.0, dev, seed=7, use_manifest=False)
    render = make_render_fn(cam, bg, 64, 32, 2, 8, dev)
    segments = []
    for scene in (s42, s7, s42):
        img, segs = render(scene)
        fresh, fresh_segs = make_render_fn(cam, bg, 64, 32, 2, 8, dev)(scene)
        assert segs == fresh_segs and torch.equal(img, fresh)
        segments.append(segs)
    assert segments[0] == segments[2] != segments[1]


def test_card_render_16_bounces_equals_cpu_render(dev):
    """A 64x32 spp=2 render at 16 bounces (compaction at bounces 2 and 4, a
    two-link chain back to the pixels) through the kernels on the card and
    through their plain versions on the CPU: the bounds of
    test_card_render_equals_cpu_render."""
    scene, cam, bg = shirley.build(2.0, dev)
    ck.compact_blocks.launches = 0
    img_k, segs_k = make_render_fn(cam, bg, 64, 32, 2, 16, dev)(scene)
    assert ck.compact_blocks.launches == 2 * 2
    cpu = torch.device("cpu")
    scene_c, cam_c, bg_c = shirley.build(2.0, cpu)
    img_c, segs_c = make_render_fn(cam_c, bg_c, 64, 32, 2, 16, cpu)(scene_c)
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


def _tris_equal(table, org, d, alive):
    before = tk.intersect_tris.launches
    got = tk.intersect_tris(table, org, d, alive)
    assert tk.intersect_tris.launches == before + 1
    want = tk.intersect_tris_plain(table, org, d, alive)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_tris_kernel_on_scattered_pads(dev, seed):
    """Real columns scattered among pads (T = 45), inf and NaN rays,
    origins on a triangle's plane, a tie, a block with one live lane
    (tests/test_torch_tri_pads.py); and the same real columns among 979
    more pads (T = 1024: 48 KB of staged triangles at most)."""
    from test_torch_tri_pads import REAL, scattered_case
    table, org, d, alive = (torch.from_numpy(x).to(dev)
                            for x in scattered_case(seed))
    t, idx, hit = _tris_equal(table, org, d, alive)
    assert bool(hit[:1024].any()) and bool(hit[1024:].any())
    wide = torch.zeros(9, 1024, device=dev)
    wide[0:3] = 0.5
    wide[:, torch.tensor(REAL, device=dev) * 20 + 7] = table[:, REAL]
    wt, widx, _ = _tris_equal(wide, org, d, alive)
    assert torch.equal(wt, t)
    assert torch.equal(widx, torch.where(hit, idx * 20 + 7, 0).int())


def test_intersect_tris_kernel_on_named_cases(dev):
    """Each case the kernel's header names, one 1024-ray block each."""
    from test_torch_tri_pads import NAMED, named_case
    alive = torch.ones(1024, dtype=torch.bool, device=dev)
    for name, case in NAMED.items():
        table, org, d = (x.to(dev) for x in named_case(name))
        _, _, hit = _tris_equal(table, org.expand(1024, 3).contiguous(),
                                d.expand(1024, 3).contiguous(), alive)
        assert bool(hit[0]) == case[5], name


def test_intersect_tris_kernel_on_the_ganesha_floor_pool(dev):
    """The 2-triangle floor among 126 pads, rays from above it."""
    from pathtracer_tpu_torch.models import ganesha
    scene, _, _, _ = ganesha.build(
        os.path.join(ROOT, "scenes", "test_ganesha.ply"), 1.0, dev)
    tp = scene.tri_pack
    table = tk.pack_tris(tp[:, TRI_A], tp[:, TRI_E1], tp[:, TRI_E2],
                         scene.tri_valid)
    assert table.shape[1] == 128 and int(scene.tri_valid.sum()) == 2
    org, d, alive = _cornell_rays(dev, seed=3)
    t, _, hit = _tris_equal(table, org * 100.0, d, alive)
    assert bool(hit.any()) and not bool(hit[1024:2048].any())


def test_gather_kernel_matches_plain(dev):
    """The gather of a real 96x96 cornell iteration, every block; lists of
    up to 65 chunks, so the kernel splits them into segments of SEG."""
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
    _, counts = gk.block_chunk_lists(args[0], args[2], sbox, r)
    assert int(counts.max()) > gk.SEG  # some block's list splits
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
    with pytest.raises(ValueError, match="aligned"):  # photons_t off by 4 B
        gk.gather_flux_chunks(org, org, alive, torch.zeros(6, 4, device=dev),
                              torch.zeros(16 * 128 + 1, device=dev)[1:]
                              .view(16, 128), 0.1)


def _counts(dev):
    """bvh4_walk's counters, zeroed."""
    return torch.zeros(2, dtype=torch.int64, device=dev)


def _soup(dev, n=150, seed=5, walk="bvh8"):
    """A random triangle soup as a MeshBVH on the card."""
    from pathtracer_tpu_torch.ops.bvh import MeshBVH

    rs = np.random.RandomState(seed)
    verts = rs.uniform(-5, 5, (n, 3))
    faces = rs.randint(0, n, (2 * n, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    return MeshBVH(verts, faces, np.zeros(12, np.float32), dev, walk=walk)


def _uv_sphere(radius=45.0, nu=12, nv=8):
    """A closed nu x nv uv-sphere of 2 nu (nv - 1) triangles (168 by
    default) where the ganesha camera looks: (vertices, faces)."""
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(1e-3, np.pi - 1e-3, nv)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    verts = np.stack([np.sin(vv) * np.cos(uu), np.cos(vv),
                      np.sin(vv) * np.sin(uu)], -1).reshape(-1, 3)
    verts = radius * verts + np.array([328.0, 60.0, 150.0])
    faces = [[i * nv + j, (i + 1) % nu * nv + j, i * nv + j + 1]
             for i in range(nu) for j in range(nv - 1)]
    faces += [[(i + 1) % nu * nv + j, (i + 1) % nu * nv + j + 1,
               i * nv + j + 1] for i in range(nu) for j in range(nv - 1)]
    return verts, np.array(faces)


def _soup_rays(dev, m):
    """4,096 random rays (t_max0 3 or 1e30, a quarter inactive), and 1,024
    with exact-zero direction components, half of them on the root box's
    low plane of a zeroed axis (0 * inf = NaN must miss): (org, d, t_max0,
    active) on the card, and the first zero-component lane."""
    rs = np.random.RandomState(7)
    n, nz = 4096, 1024
    org = rs.uniform(-8, 8, (n + nz, 3)).astype(np.float32)
    d = rs.randn(n + nz, 3).astype(np.float32)
    t_max = np.where(rs.rand(n + nz) < 0.5, 3.0, 1e30).astype(np.float32)
    active = rs.rand(n + nz) > 0.25
    for i in range(n, n + nz):
        axes = [i % 3] if i % 2 else [i % 3, (i + 1) % 3]
        d[i, axes] = 0.0
        active[i] = True
        if i >= n + nz // 2:
            org[i, axes[0]] = m.bbox_lo[axes[0]]
    return [torch.from_numpy(x).to(dev) for x in (org, d, t_max, active)], n


def test_bvh8_walk_kernel_matches_plain(dev):
    """4,096 random rays (t_max0 3 or 1e30, a quarter inactive), and 1,024
    with exact-zero direction components, half of them on the root box's
    low plane of a zeroed axis (0 * inf = NaN must miss)."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    m = _soup(dev)
    args, n = _soup_rays(dev, m)
    before = bw.bvh8_walk.launches
    got = bw.bvh8_walk(m.table, *args, m.node_end, m.stride)
    assert bw.bvh8_walk.launches == before + 1
    want = bw.bvh8_walk_plain(m.table, *args, m.node_end, m.stride)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()
    hit = got[4]
    assert 100 < int(hit.sum()) < hit.numel() - 100
    assert int(hit[n:].sum()) > 4 and not bool(hit[~args[3]].any())
    assert bw.LANES_PER_RAY > 1


def test_bvh8_walk_kernel_matches_plain_on_photon_bounces(dev):
    """The walk's inputs of every bounce of a 4,000-photon pass over
    scenes/test_ganesha.ply, as the photon pass makes them."""
    from pathtracer_tpu_torch.models import ganesha
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    scene, _, lights, mesh = ganesha.build(
        os.path.join(ROOT, "scenes", "test_ganesha.ply"), 1.0, dev)
    trace, _, _ = ppm.make_photon_pass(scene, lights, 4000, 4, mesh)
    walk_in = []
    walk = mesh.intersect

    def record(org, d, t_max0, active):
        walk_in.append(tuple(x.clone() for x in (org, d, t_max0, active)))
        return walk(org, d, t_max0, active)

    mesh.intersect = record
    trace(0)
    del mesh.intersect
    assert len(walk_in) == 4
    for org, d, t_max0, active in walk_in:
        args = (mesh.table, org, d, t_max0, active, mesh.node_end,
                mesh.stride)
        got = bw.bvh8_walk(*args)
        want = bw.bvh8_walk_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert int(got[4].sum()) > 0


def test_bvh4_walk_kernel_matches_plain(dev):
    """The BVH4 walk on the soup's rays of the BVH8 test (_soup_rays: the
    zero-component lanes included), the table's NaN pad boxes included."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    m = _soup(dev, walk="bvh4")
    assert m.walk == "bvh4"
    assert bool(m.table[:m.node_end, :24].isnan().any())  # pad boxes
    args, n = _soup_rays(dev, m)
    before = bw.bvh4_walk.launches
    got = bw.bvh4_walk(m.table, *args, m.node_end, m.stride, _counts(dev))
    assert bw.bvh4_walk.launches == before + 1
    want = bw.bvh4_walk_plain(m.table, *args, m.node_end, m.stride)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()
    hit = got[4]
    assert 100 < int(hit.sum()) < hit.numel() - 100
    assert int(hit[n:].sum()) > 4 and not bool(hit[~args[3]].any())
    assert bw.BVH4_LANES_PER_RAY > 1


def _tie_soup(dev, walk, copies=(5, 8), n=60, seed=9):
    """A soup of n random triangles, each repeated a number of times drawn
    from `copies` (so a leaf holds one triangle's copies: 5-8 triangles,
    3-4 pair rows, exact ties in t), as a MeshBVH on the card, and 3,072
    rays: 2,048 aimed at the triangles' centroids (t_max0 1e30, 3 or the
    plain walk's own hit t, an exact tie with the limit; a quarter
    inactive) and 1,024 with exact-zero direction components from inside
    the soup's box, half of them on its low plane of a zeroed axis.
    Returns (mesh, (org, d, t_max0, active) on the card)."""
    from pathtracer_tpu_torch.ops.bvh import MeshBVH
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    rs = np.random.RandomState(seed)
    verts = rs.uniform(-5, 5, (3 * n, 3))
    base = np.arange(3 * n).reshape(n, 3)
    faces = np.repeat(base, rs.randint(copies[0], copies[1] + 1, n), axis=0)
    faces = faces[rs.permutation(len(faces))]
    m = MeshBVH(verts, faces, np.zeros(12, np.float32), dev, walk=walk)
    nr, nz = 2048, 1024
    org = rs.uniform(-8, 8, (nr + nz, 3))
    cen = verts[base[rs.randint(0, n, nr)]].mean(axis=1)
    d = np.concatenate([cen - org[:nr], rs.randn(nz, 3)])
    org[nr:] = m.bbox_lo + rs.rand(nz, 3) * (m.bbox_hi - m.bbox_lo)
    for i in range(nr, nr + nz):
        axes = [i % 3] if i % 2 else [i % 3, (i + 1) % 3]
        d[i, axes] = 0.0
        if i >= nr + nz // 2:
            org[i, axes[0]] = m.bbox_lo[axes[0]]
    t_max = np.where(rs.rand(nr + nz) < 0.5, 3.0, 1e30)
    active = rs.rand(nr + nz) > 0.25
    active[nr:] = True
    rays = [torch.from_numpy(x).to(dev) for x in (
        org.astype(np.float32), d.astype(np.float32),
        t_max.astype(np.float32), active)]
    # a third of the aimed lanes end exactly at their own hit's t
    plain = bw.bvh4_walk_plain if walk == "bvh4" else bw.bvh8_walk_plain
    t, *_, hit = plain(m.table, rays[0], rays[1],
                       torch.full_like(rays[2], 1e30), rays[3], m.node_end,
                       m.stride)
    at = hit & (torch.arange(nr + nz, device=dev) % 3 == 0)
    at[nr:] = False
    rays[2] = torch.where(at, t, rays[2])
    return m, rays


@pytest.mark.parametrize("case", ["ties", "big_leaves", "axis_aligned"])
def test_bvh4_walk_kernel_matches_plain_on_ties_and_big_leaves(dev, case):
    """The BVH4 walk on _tie_soup: leaves of one triangle's 1-8 copies
    (ties: exact ties in t across the leaf step's four triangles, 1-row
    leaves among them), of 5-8 copies (big_leaves: leaves of 3-4 pair
    rows, the leaf step taken twice), and the axis-aligned lanes of the
    latter alone (0 * inf on a box plane); with lanes that end at t_max0
    exactly."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    copies = (1, 8) if case == "ties" else (5, 8)
    m, args = _tie_soup(dev, "bvh4", copies)
    lasts = m.table[m.node_end:-1, 10] > 0.5
    rows = torch.diff(torch.nonzero(lasts)[:, 0], prepend=torch.tensor(
        [-1], device=dev))  # pair rows of each leaf
    assert int(rows.min()) == (copies[0] + 1) // 2 and int(rows.max()) == 4
    if case == "axis_aligned":
        args = [x[2048:] for x in args]
    got = bw.bvh4_walk(m.table, *args, m.node_end, m.stride, _counts(dev))
    want = bw.bvh4_walk_plain(m.table, *args, m.node_end, m.stride)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()
    hit = got[4]
    assert int(hit.sum()) > 100 and not bool(hit[~args[3]].any())
    if case != "axis_aligned":
        at = (args[2] == got[0]) & args[3]  # ends exactly at its limit
        assert int(at.sum()) > 50 and not bool(hit[at].any())


@pytest.mark.parametrize("case", ["soup", "ties", "big_leaves"])
def test_bvh4_walk_counters_equal_the_emulation(dev, case):
    """The BVH4 walk with its counters on: the outputs equal
    bvh4_walk_plain's bit for bit, counts[0] adds the active lanes and
    counts[1] the table loads bvh4_walk_cached_plain counts, at each call
    (a second call doubles them)."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    if case == "soup":
        m = _soup(dev, walk="bvh4")
        args = _soup_rays(dev, m)[0]
    else:
        m, args = _tie_soup(dev, "bvh4", (1, 8) if case == "ties"
                            else (5, 8))
    walk = (m.table, *args, m.node_end, m.stride)
    counts = _counts(dev)
    got = bw.bvh4_walk(*walk, counts)
    want = bw.bvh4_walk_plain(*walk)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()
    emu = bw.bvh4_walk_cached_plain(*walk)
    for g, w in zip(got, emu[:5]):
        assert torch.equal(g, w)
    loads = int(emu[5][:, 0].sum())
    active = int(args[3].sum())
    assert counts.tolist() == [active, loads]
    assert loads > active  # each walked ray loads its root, and more
    bw.bvh4_walk(*walk, counts)
    assert counts.tolist() == [2 * active, 2 * loads]


def test_bvh4_render_counts_each_image_walk(dev, tmp_path, monkeypatch):
    """The tiny ganesha on BVH4 through make_render_fn, an eager first
    pass and replayed passes: each image's closing read gives pt.walk_rays
    (every live lane past bounce 0) and pt.walk_loads, the same for the
    first image (warm-up and capture) and a replayed one; the mesh's
    counters hold the last image's."""
    from pathtracer_tpu_torch.models import ganesha
    from pathtracer_tpu_torch.ops.bvh import MeshBVH
    from pathtracer_tpu_torch.utils import tracing

    monkeypatch.setattr(ganesha, "MeshBVH", lambda *a, **k: MeshBVH(
        *a, **dict(k, walk="bvh4")))
    scene, cam, bg, mesh = _tiny_ganesha_pt(dev, tmp_path)
    render = make_render_fn(cam, bg, 64, 64, 2, 8, dev, mesh=mesh)
    tracing.reset()
    try:
        shots = [render(scene)[1] for _ in range(3)]
        recs = tracing.images()
    finally:
        tracing.reset()
    assert shots[0] == shots[1] == shots[2]
    assert [r.counts["pt.graph_passes"] for r in recs] == [1, 2, 2]
    rays = shots[0] - 64 * 64 * 2
    assert [r.counts["pt.walk_rays"] for r in recs] == [rays] * 3
    loads = [r.counts["pt.walk_loads"] for r in recs]
    assert loads[0] == loads[1] == loads[2] > rays
    assert mesh.walk_counts.tolist() == [rays, loads[0]]


def test_bvh8_walk_kernel_matches_plain_on_ties(dev):
    """The BVH8 walk, whose triangle step shares bvh_walk.cuh with the
    BVH4 walk's, on the tie soup of 1-8 copies a triangle."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    m, args = _tie_soup(dev, "bvh8", (1, 8))
    assert m.walk == "bvh8"
    got = bw.bvh8_walk(m.table, *args, m.node_end, m.stride)
    want = bw.bvh8_walk_plain(m.table, *args, m.node_end, m.stride)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()
    assert int(got[4].sum()) > 100


def _ganesha_bvh4(dev, monkeypatch, path):
    """models.ganesha.build of `path` on `dev` with the mesh on the BVH4
    walk, as a mesh past the BVH8 range takes it."""
    from pathtracer_tpu_torch.models import ganesha
    from pathtracer_tpu_torch.ops.bvh import MeshBVH

    monkeypatch.setattr(ganesha, "MeshBVH", lambda *a, **k: MeshBVH(
        *a, **dict(k, walk="bvh4")))
    out = ganesha.build(path, 1.0, dev)
    assert out[3].walk == "bvh4"
    return out


def test_bvh4_walk_kernel_matches_plain_on_photon_bounces(dev, monkeypatch):
    """The BVH4 walk's inputs of every bounce of a 4,000-photon pass over
    scenes/test_ganesha.ply on the BVH4 table, as the photon pass makes
    them, and rays with exact-zero direction components from inside the
    mesh's box."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    scene, _, lights, mesh = _ganesha_bvh4(
        dev, monkeypatch, os.path.join(ROOT, "scenes", "test_ganesha.ply"))
    trace, _, _ = ppm.make_photon_pass(scene, lights, 4000, 4, mesh)
    walk_in = []
    walk = mesh.intersect

    def record(org, d, t_max0, active):
        walk_in.append(tuple(x.clone() for x in (org, d, t_max0, active)))
        return walk(org, d, t_max0, active)

    mesh.intersect = record
    before = (bw.bvh4_walk.launches, bw.bvh8_walk.launches)
    trace(0)
    del mesh.intersect
    assert (bw.bvh4_walk.launches, bw.bvh8_walk.launches) == (
        before[0] + 4, before[1])
    # 1,024 rays from inside the mesh's box with exact-zero direction
    # components, half of them on its low plane of a zeroed axis
    rs = np.random.RandomState(11)
    nz = 1024
    org = (mesh.bbox_lo + rs.rand(nz, 3) * (mesh.bbox_hi - mesh.bbox_lo))
    d = rs.randn(nz, 3)
    for i in range(nz):
        axes = [i % 3] if i % 2 else [i % 3, (i + 1) % 3]
        d[i, axes] = 0.0
        if i >= nz // 2:
            org[i, axes[0]] = mesh.bbox_lo[axes[0]]
    walk_in.append(tuple(torch.from_numpy(x).to(dev) for x in (
        org.astype(np.float32), d.astype(np.float32),
        np.full(nz, 1e30, np.float32), np.ones(nz, bool))))
    for org, d, t_max0, active in walk_in:
        args = (mesh.table, org, d, t_max0, active, mesh.node_end,
                mesh.stride)
        got = bw.bvh4_walk(*args, _counts(dev))
        want = bw.bvh4_walk_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert int(got[4].sum()) > 0


def test_bvh4_ganesha_pt_card_render_matches_cpu(dev, tmp_path, monkeypatch):
    """test_ganesha_pt_card_render_matches_cpu with the mesh on the BVH4
    walk: the card's render goes through bvh4_walk (14 launches, bvh8_walk
    none) and is held to the CPU render by the same bounds."""
    from pathtracer_tpu_torch.models import ganesha
    from pathtracer_tpu_torch.ops.bvh import MeshBVH
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    monkeypatch.setattr(ganesha, "MeshBVH", lambda *a, **k: MeshBVH(
        *a, **dict(k, walk="bvh4")))
    counters = (sk.intersect_spheres, tk.intersect_tris, bw.bvh4_walk,
                ttk.intersect_tile_tris, bw.bvh8_walk)
    out = {}
    for device in (dev, torch.device("cpu")):
        scene, cam, bg, mesh = _tiny_ganesha_pt(device, tmp_path)
        assert mesh.walk == "bvh4"
        for fn in counters:
            fn.launches = 0
        img, segs = make_render_fn(cam, bg, 64, 64, 2, 8, device,
                                   mesh=mesh)(scene)
        out[device.type] = (img.cpu().numpy(), segs,
                            [fn.launches for fn in counters])
    (img, segs, launches), (want, want_segs, cpu_launches) = (out["cuda"],
                                                              out["cpu"])
    assert launches == [16, 16, 14, 2, 0] and cpu_launches == [0] * 5
    assert abs(segs - want_segs) <= 0.005 * want_segs
    assert np.isfinite(img).all()
    assert float(np.sqrt(np.mean((img - want) ** 2))) <= 1e-3


def _tile_kernel_equals_plain(dev, flip_y):
    """The tile kernel against its plain version on a 48x32 uv-sphere
    (2,976 triangles) under the ganesha camera at 88x96, its table and
    its jittered raster primaries in the film map of flip_y."""
    from pathtracer_tpu_torch.models import ganesha
    from pathtracer_tpu_torch.ops.bvh import MeshBVH
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    w, h = 88, 96
    verts, faces = _uv_sphere(radius=15.0, nu=48, nv=32)
    cam = ganesha.make_camera(w / h)
    m = MeshBVH(cam.transform_points(verts), faces,
                np.zeros(12), dev, watertight=True)
    tt = ttk.build_tile_tri_table(cam, m.tri_a, m.tri_e1, m.tri_e2, w, h,
                                  bvh=m, backface_cull=True, flip_y=flip_y)
    empty = tt.tile_chunk_src == tt.zero_chunk
    assert empty.any() and not empty.all()
    assert np.diff(tt.tile_chunk_start).max() > 1  # a tile splits
    rng = np.random.default_rng(3)
    lane = torch.arange(w * h, device=dev)
    cx = ((lane % w).float() + torch.from_numpy(rng.random(w * h, np.float32))
          .to(dev)) * np.float32(1.0 / w)
    cy = ((lane // w).float() + torch.from_numpy(rng.random(w * h, np.float32))
          .to(dev)) * np.float32(1.0 / h)
    if flip_y:
        cy = 1.0 - cy
    d = cam.ray_dirs(cx, cy).contiguous()
    tabs = tt.tensors(dev)
    before = ttk.intersect_tile_tris.launches
    got = ttk.intersect_tile_tris(*tabs, d, w)
    assert ttk.intersect_tile_tris.launches == before + 1
    want = ttk.intersect_tile_tris_plain(*tabs, d, w)
    for g, x in zip(got, want):
        assert torch.equal(g, x), (g.float() - x.float()).abs().max()
    hit = got[0] < ttk.BIG
    assert 50 < int(hit.sum()) < w * h - 50
    assert not bool(got[1][~hit].any()) and not bool(got[3][~hit].any())
    return m, d, hit, tt, got


def test_intersect_tile_tris_kernel_matches_plain(dev):
    """A 48x32 uv-sphere (2,976 triangles) under the ganesha camera at
    88x96: tiles of up to 5 chunks, which the kernel splits one chunk per
    work item, empty tiles (the shared zero chunk) and a partial last tile
    column."""
    _tile_kernel_equals_plain(dev, flip_y=False)


def _equal_nan(a, b) -> bool:
    if not a.is_floating_point():
        return torch.equal(a, b)
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


@pytest.mark.parametrize("row0", [0, 2])
def test_intersect_tile_tris_kernel_matches_plain_on_band_maps(dev, row0):
    """The tile kernel over band_tile_maps (a multi-device band) of the
    88x96 table's 3 tile rows: two tile rows from row0, all inside the
    image (row0 = 0) or the last past it (row0 = 2: its tiles map the zero
    chunk), on the band's primaries (past the image: any directions).
    Equal to the plain version on the same maps, NaN counted as equal,
    and on the rows inside the image to the whole table's result."""
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    _, d, _, tt, whole = _tile_kernel_equals_plain(dev, flip_y=False)
    w, band = 88, 2
    start, src = ttk.band_tile_maps(tt, row0, band)
    maps = (tt.tensors(dev)[0], torch.from_numpy(start).to(dev),
            torch.from_numpy(src).to(dev))
    lo = row0 * ttk.TILE * w
    inside = min(d.shape[0], lo + band * ttk.TILE * w) - lo
    d_band = torch.cat([d[lo:lo + inside],
                        d[:band * ttk.TILE * w - inside]]).contiguous()
    assert (inside < d_band.shape[0]) == (row0 == 2)
    got = ttk.intersect_tile_tris(*maps, d_band, w)
    want = ttk.intersect_tile_tris_plain(*maps, d_band, w)
    assert all(_equal_nan(g, x) for g, x in zip(got, want))
    assert all(torch.equal(g[:inside], x[lo:lo + inside])
               for g, x in zip(got, whole))
    assert not bool((got[0][inside:] < ttk.BIG).any())


def test_intersect_tile_tris_kernel_matches_plain_on_a_flip_y_table(dev):
    """The same on the path tracer's film map (flip_y=True, cy = 1 - y/H):
    the kernel equals its plain version, and the flipped table's lists
    (back-face culled with flipped corners) find every hit of the walk."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    m, d, hit, _, _ = _tile_kernel_equals_plain(dev, flip_y=True)
    n = d.shape[0]
    walk = bw.bvh8_walk(m.table, torch.zeros_like(d), d,
                        torch.full((n,), 1e30, device=dev),
                        torch.ones(n, dtype=torch.bool, device=dev),
                        m.node_end, m.stride)
    assert torch.equal(hit, walk[4])


def _tiny_ganesha_pt(dev, tmp_path, yaw_seed=None):
    """The tiny ganesha (the 168-triangle uv-sphere over the floor, under
    the sky) of models.ganesha.build_pt on `dev`; yaw_seed, if given,
    turns the sphere about its vertical axis by an angle drawn from it."""
    from pathtracer_tpu_torch.io import ply
    from pathtracer_tpu_torch.models import ganesha

    verts, faces = _uv_sphere()
    name = "tiny_ganesha.ply"
    if yaw_seed is not None:
        a = np.random.default_rng(yaw_seed).uniform(0.0, 2.0 * np.pi)
        x, z = verts[:, 0] - 328.0, verts[:, 2] - 150.0
        verts = np.stack([328.0 + np.cos(a) * x - np.sin(a) * z, verts[:, 1],
                          150.0 + np.sin(a) * x + np.cos(a) * z], -1)
        name = f"tiny_ganesha_{yaw_seed}.ply"
    path = os.path.join(str(tmp_path), name)
    ply.write_mesh(path, verts, faces)
    return ganesha.build_pt(path, 1.0, dev)


def test_bvh8_walk_kernel_matches_plain_on_pt_bounce_rays(dev, tmp_path):
    """The walk's inputs of bounces 1-3 of a path-traced pass (64x64,
    spp 1, 4 bounces) over the tiny ganesha: incoherent rays leaving the
    floor and the mesh, capped at the floor's t."""
    from pathtracer_tpu_torch.integrator import MeshRenderer
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    scene, cam, bg, mesh = _tiny_ganesha_pt(dev, tmp_path)
    r = MeshRenderer(scene, cam, bg, 64, 64, 1, 4, dev, mesh)
    walk_in = []
    walk = mesh.intersect

    def record(org, d, t_max0, active):
        walk_in.append(tuple(x.clone() for x in (org, d, t_max0, active)))
        return walk(org, d, t_max0, active)

    mesh.intersect = record
    r.trace_pass(0)
    del mesh.intersect
    assert len(walk_in) == 3  # bounce 0 goes through the tile kernel
    for org, d, t_max0, active in walk_in:
        assert bool((org[active] != 0).any(dim=1).all())
        args = (mesh.table, org, d, t_max0, active, mesh.node_end,
                mesh.stride)
        got = bw.bvh8_walk(*args)
        want = bw.bvh8_walk_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(bw.bvh8_walk(*(mesh.table, *walk_in[0], mesh.node_end,
                              mesh.stride))[4].sum()) > 0


def test_ganesha_pt_card_render_matches_cpu(dev, tmp_path):
    """make_render_fn(..., mesh=mesh) at 64x64, spp 2, 8 bounces over the
    tiny ganesha on the card (four kernels) and on the CPU: segments
    within 0.5%, image RMSE <= 1e-3 (the cornell bounds: the glue's
    sin/cos may differ by an ulp between the devices and turn a path)."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    counters = (sk.intersect_spheres, tk.intersect_tris, bw.bvh8_walk,
                ttk.intersect_tile_tris)
    out = {}
    for device in (dev, torch.device("cpu")):
        scene, cam, bg, mesh = _tiny_ganesha_pt(device, tmp_path)
        for fn in counters:
            fn.launches = 0
        img, segs = make_render_fn(cam, bg, 64, 64, 2, 8, device,
                                   mesh=mesh)(scene)
        out[device.type] = (img.cpu().numpy(), segs,
                            [fn.launches for fn in counters])
    (img, segs, launches), (want, want_segs, cpu_launches) = (out["cuda"],
                                                              out["cpu"])
    assert launches == [16, 16, 14, 2] and cpu_launches == [0, 0, 0, 0]
    assert abs(segs - want_segs) <= 0.005 * want_segs
    assert np.isfinite(img).all()
    assert float(np.sqrt(np.mean((img - want) ** 2))) <= 1e-3


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_mesh_graph_replay_equals_the_eager_render(dev, tmp_path, seed):
    """make_render_fn(..., mesh=) at 64x64, spp 4, 8 bounces over the tiny
    ganesha turned by the seed renders scene A, A again, then a second
    scene object B (a new MeshRenderer: a new capture). Each render equals
    the eager passes of a renderer of the same scene bit for bit (image
    and segments), calls progress spp times, counts the eager passes'
    launches of the four kernels and pt.lanes, and replays every pass but
    a fresh renderer's first (the warm-up before the capture):
    pt.graph_passes spp - 1, then spp. No image, and no band_sums result,
    changes under a later replay."""
    from pathtracer_tpu_torch import film
    from pathtracer_tpu_torch.integrator import MeshRenderer
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
    from pathtracer_tpu_torch.utils import tracing

    size, spp, bounces = 64, 4, 8
    counters = (sk.intersect_spheres, tk.intersect_tris, bw.bvh8_walk,
                ttk.intersect_tile_tris)
    scene_a, cam, bg, mesh = _tiny_ganesha_pt(dev, tmp_path, seed)
    scene_b = _tiny_ganesha_pt(dev, tmp_path, seed)[0]

    def eager(scene):
        r = MeshRenderer(scene, cam, bg, size, size, spp, bounces, dev, mesh)
        for fn in counters:
            fn.launches = 0
        sums = torch.zeros(r.lane.shape[0], 3, device=dev)
        segs = torch.zeros((), dtype=torch.int64, device=dev)
        for p in range(spp):
            rad, s = r.trace_pass(p)
            sums += rad
            segs += s
        img = film.finalize(film.apply_filter(r.image(sums), r.kern2d), spp)
        return (img, int(segs), [fn.launches for fn in counters],
                r.lane.shape[0])

    render = make_render_fn(cam, bg, size, size, spp, bounces, dev,
                            mesh=mesh)
    kept = []
    tracing.reset()
    try:
        for scene, graphed in ((scene_a, spp - 1), (scene_a, spp),
                               (scene_b, spp - 1)):
            want, want_segs, want_launches, lanes = eager(scene)
            for fn in counters:
                fn.launches = 0
            calls = []
            img, segs = render(scene, calls.append)
            launches = [fn.launches for fn in counters]
            counts = tracing.images()[-1].counts
            assert torch.equal(img, want) and segs == want_segs > size * size
            assert calls == [size * size] * spp
            assert launches == want_launches == [spp * bounces,
                                                 spp * bounces,
                                                 spp * (bounces - 1), spp]
            assert counts["pt.lanes"] == spp * bounces * lanes
            assert counts["pt.live_lanes"] == segs
            assert counts["pt.passes"] == spp
            assert counts["pt.graph_passes"] == graphed
            kept.append((img, img.clone()))
    finally:
        tracing.reset()
    assert all(torch.equal(img, copy) for img, copy in kept)
    r = MeshRenderer(scene_a, cam, bg, size, size, spp, bounces, dev, mesh)
    first = r.band_sums(range(2))
    copies = [x.clone() for x in first]
    r.band_sums(range(2, 4))
    assert all(torch.equal(x, c) for x, c in zip(first, copies))


def _bands_stitched(make, height, sp):
    """(whole renderer's raw image, the sp bands' raw images stitched and
    cut to the image, and both segment counts) of make(tile_row0, band)."""
    from pathtracer_tpu_torch.integrator import TILE

    whole = make(0, None)
    sums, segs = whole.band_sums(range(whole.spp))
    want = whole.band_image(sums)[:height]
    tyn = -(-height // TILE)
    band = -(-tyn // sp)
    parts, got_segs = [], 0
    for s in range(sp):
        r = make(s * band, band)
        b_sums, b_segs = r.band_sums(range(r.spp))
        parts.append(r.band_image(b_sums))
        got_segs += int(b_segs)
    return want, torch.cat(parts)[:height], int(segs), got_segs


@pytest.mark.parametrize("sp", [2, 4])
def test_bands_on_card_equal_whole_image(dev, tmp_path, sp):
    """Renderer (shirley 128x72: the last band overhangs the image) and
    MeshRenderer (the tiny ganesha at 64x64; sp = 4 puts two bands past
    the image) over sp bands of tile rows on the card, each lane through
    the kernels: the bands' raw sums, stitched, equal the whole image's
    bit for bit, and the segments add up."""
    from pathtracer_tpu_torch.integrator import MeshRenderer

    scene, cam, bg = shirley.build(128 / 72, dev)
    want, got, segs, got_segs = _bands_stitched(
        lambda row0, band: Renderer(scene, cam, bg, 128, 72, 2, 8, dev,
                                    tile_row0=row0, band_tile_rows=band),
        72, sp)
    assert torch.equal(got, want) and got_segs == segs > 128 * 72
    scene, cam, bg, mesh = _tiny_ganesha_pt(dev, tmp_path)
    want, got, segs, got_segs = _bands_stitched(
        lambda row0, band: MeshRenderer(scene, cam, bg, 64, 64, 2, 4, dev,
                                        mesh, tile_row0=row0,
                                        band_tile_rows=band), 64, sp)
    assert torch.equal(got, want) and got_segs == segs > 64 * 64


def test_ganesha_card_render_matches_cpu(dev):
    """A 64x64, 1-iteration, 2,000-photon, 3-bounce render of the 168-
    triangle uv-sphere ganesha on the card (all five kernels) and on the
    CPU: photon map lengths within 0.5%, image RMSE <= 1e-3."""
    import tempfile

    from pathtracer_tpu_torch.io import ply
    from pathtracer_tpu_torch.models import ganesha
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    verts, faces = _uv_sphere()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiny_ganesha.ply")
        ply.write_mesh(path, verts, faces)

        def render(device):
            scene, cam, lights, mesh = ganesha.build(path, 1.0, device)
            r = ppm.PPMRenderer(scene, cam, lights, 64, 64, iterations=1,
                                photon_count=2000, max_bounces=3,
                                verbose=False, mesh=mesh)
            img = r.render().cpu().numpy()
            return img, [int(n) for n in r.photon_map_lengths]

        counters = (sk.intersect_spheres, tk.intersect_tris,
                    gk.gather_flux_chunks, bw.bvh8_walk,
                    ttk.intersect_tile_tris)
        for fn in counters:
            fn.launches = 0
        img_k, n_k = render(dev)
        assert all(fn.launches > 0 for fn in counters)
        img_c, n_c = render(torch.device("cpu"))
    rmse = float(np.sqrt(np.mean((img_k - img_c) ** 2)))
    print(f"ganesha 64x64 card vs cpu: photon map lengths {n_k} vs {n_c}, "
          f"rmse {rmse:.3e}, max {np.abs(img_k - img_c).max():.3e}")
    assert np.isfinite(img_k).all() and img_k.max() > 0
    for a, b in zip(n_k, n_c):
        assert abs(a - b) <= 0.005 * b, (n_k, n_c)
    assert rmse <= 1e-3, rmse


def _eager_iterations(self, eff_bounces):
    """A stand-in for PPMRenderer._iteration_graph that runs each
    iteration's prefix eagerly: the reference of the graph's renders on the
    card."""
    passes = self._passes(eff_bounces, None, 0)
    return passes, passes.prefix


def _ppm_renderer(kind, dev, tmp_path):
    """A small PPMRenderer on the card: the 168-triangle uv-sphere ganesha
    at 64x64 (the tile kernel's eye pass, 3 photon bounces) or cornell at
    96x96 (spheres and triangles, no mesh, the specular walk of all 4
    bounces), 3 iterations."""
    if kind == "cornell":
        scene, cam, lights = cornell.build(1.0, dev)
        return ppm.PPMRenderer(scene, cam, lights, 96, 96, iterations=3,
                               photon_count=5000, verbose=False)
    from pathtracer_tpu_torch.io import ply
    from pathtracer_tpu_torch.models import ganesha

    path = os.path.join(str(tmp_path), "tiny_ganesha.ply")
    ply.write_mesh(path, *_uv_sphere())
    scene, cam, lights, mesh = ganesha.build(path, 1.0, dev)
    return ppm.PPMRenderer(scene, cam, lights, 64, 64, iterations=3,
                           photon_count=2000, max_bounces=3, verbose=False,
                           mesh=mesh)


@pytest.mark.parametrize("kind", ["ganesha", "cornell"])
def test_ppm_graph_replay_equals_the_eager_render(dev, tmp_path, monkeypatch,
                                                  kind):
    """One PPMRenderer renders twice through its iteration graph, then once
    more after photon_count changes (a new capture). Each render equals an
    eager render of the same renderer bit for bit: img_sum,
    photon_map_lengths, iter_segments, the ppm.eye_hits, ppm.deposits and
    ppm.photon_segments counters, and the launches of every kernel wrapper
    (each launch of the captured iteration is counted again on replay),
    and the walk's ppm.walk_lanes and ppm.walk_live (a device sum on
    cornell's specular walk, a host count on ganesha's tile pass).
    Every iteration but a capture's first (the warm-up) is a replay:
    ppm.graph_iters 2, 3, then 2 of ppm.iters 3. No earlier result changes
    under a later replay."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import kernel_wrappers
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
    from pathtracer_tpu_torch.utils import tracing

    wrappers = sorted(kernel_wrappers(),
                      key=lambda f: (f.__module__, f.__qualname__))
    names = ("ppm.eye_hits", "ppm.deposits", "ppm.photon_segments",
             "ppm.iters", "ppm.walk_lanes", "ppm.walk_live")

    def render(r):
        for f in wrappers:
            f.launches = 0
        img = r.render()
        rec = tracing.images()[-1]
        return dict(img=img, kept=(img.clone(), list(r.photon_map_lengths)),
                    lengths=[int(x) for x in r.photon_map_lengths],
                    segments=[int(s) for s, _ in r.iter_segments],
                    launches={f: f.launches for f in wrappers},
                    counts={k: rec.counts[k] for k in names},
                    graphed=rec.counts.get("ppm.graph_iters", 0))

    def eager(r):
        with monkeypatch.context() as m:
            m.setattr(ppm.PPMRenderer, "_iteration_graph", _eager_iterations)
            return render(r)

    r = _ppm_renderer(kind, dev, tmp_path)
    its = r.iterations
    tracing.reset()
    try:
        want = eager(r)
        got = [render(r), render(r)]
        first_graph = r._graph
        r.photon_count = 3000
        want_new = eager(r)
        got.append(render(r))
    finally:
        tracing.reset()
    assert r._graph is not first_graph
    launched = {f for f, n in want["launches"].items() if n > 0}
    assert {sk.intersect_spheres, tk.intersect_tris,
            gk.gather_flux_chunks} <= launched
    if kind == "ganesha":
        assert {bw.bvh8_walk, ttk.intersect_tile_tris} <= launched
    for g, w, graphed in ((got[0], want, its - 1), (got[1], want, its),
                          (got[2], want_new, its - 1)):
        assert torch.equal(g["img"], w["img"]) and float(w["img"].max()) > 0
        for key in ("lengths", "segments", "launches", "counts"):
            assert g[key] == w[key], key
        assert w["counts"]["ppm.iters"] == its and w["graphed"] == 0
        assert g["graphed"] == graphed
    assert got[2]["lengths"] != want["lengths"]
    for g in got:
        img, lengths = g["kept"]
        assert torch.equal(g["img"], img)
        assert [int(x) for x in lengths] == g["lengths"]


def test_mesh_wrappers_refuse_malformed_input(dev):
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    m = _soup(dev)
    org = torch.zeros(8, 3, device=dev)
    on = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):  # rays on the CPU
        bw.bvh8_walk(m.table, org.cpu(), org, torch.zeros(8, device=dev), on,
                     m.node_end, m.stride)
    with pytest.raises(ValueError):  # not contiguous
        bw.bvh8_walk(m.table, org.t().contiguous().t(), org,
                     torch.zeros(8, device=dev), on, m.node_end, m.stride)
    shifted = torch.zeros(m.table.numel() + 1, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):  # table off by 4 B
        bw.bvh8_walk(shifted.view_as(m.table).copy_(m.table), org, org,
                     torch.zeros(8, device=dev), on, m.node_end, m.stride)
    m4 = _soup(dev, walk="bvh4")
    with pytest.raises(ValueError, match="bvh4_walk"):  # rays on the CPU
        bw.bvh4_walk(m4.table, org.cpu(), org, torch.zeros(8, device=dev),
                     on, m4.node_end, m4.stride, _counts(dev))
    shifted = torch.zeros(m4.table.numel() + 1, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):  # table off by 4 B
        bw.bvh4_walk(shifted.view_as(m4.table).copy_(m4.table), org, org,
                     torch.zeros(8, device=dev), on, m4.node_end, m4.stride,
                     _counts(dev))
    table = torch.zeros(16, 256, device=dev)
    start = torch.arange(2, dtype=torch.int32, device=dev)
    d = torch.zeros(32 * 32, 3, device=dev)
    with pytest.raises(ValueError):  # int64 chunk sources
        ttk.intersect_tile_tris(table, start, start[:1].long(), d, 32)
    with pytest.raises(ValueError):  # table on the CPU
        ttk.intersect_tile_tris(table.cpu(), start, start[:1], d, 32)


def test_two_kernel_bounce_matches_plain_and_fused(dev):
    """Three bounces of a 128x64 shirley wavefront: each kernel against its
    plain version, and the chain against the fused kernel; bounces 1 and 2
    walk the sphere hierarchy, which skips leaves."""
    scene, cam, bg = shirley.build(2.0, dev)
    r = Renderer(scene, cam, bg, 128, 64, 1, 3, dev)
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128, device=dev)
    for b in range(3):
        kw = dict(origin_zero=b == 0,
                  block_lists=(r.lists, r.counts) if b == 0 else None,
                  sphere_bvh=r.sphere_hierarchy())
        assert b == 0 or _walk_skips(r, state)
        before = sk.intersect_state.launches
        at, idx = sk.intersect_state(r.sph_table, state, **kw)
        assert sk.intersect_state.launches == before + 1
        want = sk.intersect_state_plain(r.sph_table, state, **kw)
        assert torch.equal(at, want[0]) and torch.equal(idx, want[1])
        limbs = r.sampler.limbs(2 + 2 * b, 3 + 2 * b)
        args = (state, r.pack_table, idx, off, at, limbs, bg[1], rad)
        st_k, rad_k = shk.shade_state(*args, bg_mode=bg[0])
        st_p, rad_p = shk.shade_state_plain(*args, bg_mode=bg[0])
        assert torch.equal(st_k, st_p) and torch.equal(rad_k, rad_p)
        st_f, rad_f = fbk.fused_bounce(r.sph_table, state, r.pack_table, off,
                                       limbs, bg[1], rad, bg_mode=bg[0], **kw)
        assert torch.equal(st_k, st_f) and torch.equal(rad_k, rad_f)
        state, rad = st_k, rad_k


def test_two_kernel_render_equals_fused_render(dev):
    scene, cam, bg = shirley.build(2.0, dev)
    sk.intersect_state.launches = shk.shade_state.launches = 0
    fbk.fused_bounce.launches = 0
    img0, segs0 = make_render_fn(cam, bg, 160, 80, 2, 8, dev,
                                 fuse_bounce=False)(scene)
    assert sk.intersect_state.launches > 0 and shk.shade_state.launches > 0
    assert fbk.fused_bounce.launches == 0
    img1, segs1 = make_render_fn(cam, bg, 160, 80, 2, 8, dev)(scene)
    assert segs0 == segs1 and torch.equal(img0, img1)


@pytest.mark.parametrize("bounces,fuse", [(8, True), (16, True),
                                          (8, False)])
def test_sphere_graph_replay_equals_the_eager_render(dev, bounces, fuse):
    """make_render_fn at 160x80, spp 3, renders scene A, A again, then a
    second scene object B (a new Renderer: a new capture), on the fused
    and on the two-kernel bounce. Each render equals an eager render of a
    renderer of the same scene bit for bit (image and segments), with its
    bounce kernels' launches and its pt.passes, pt.lanes and
    pt.live_lanes, and replays every pass but a fresh renderer's first
    (the warm-up before the capture): pt.graph_passes 2, then 3. No image
    changes under a later replay."""
    from pathtracer_tpu_torch.integrator import _default_compact_at
    from pathtracer_tpu_torch.utils import tracing

    w, h, spp = 160, 80, 3
    kernels = ((fbk.fused_bounce,) if fuse else
               (sk.intersect_state, shk.shade_state))
    scene_a, cam, bg = shirley.build(2.0, dev)
    scene_b = shirley.build(2.0, dev)[0]
    names = ("pt.passes", "pt.lanes", "pt.live_lanes")

    def launches():
        return [fn.launches for fn in kernels + (ck.compact_blocks,)]

    def eager(scene):
        r = Renderer(scene, cam, bg, w, h, spp, bounces, dev,
                     fuse_bounce=fuse)
        r._pass_adder = lambda: r._add_pass  # no graph
        before = launches()
        with tracing.span(tracing.ROOT):
            img, segs = r()
        counts = tracing.images()[-1].counts
        assert "pt.graph_passes" not in counts
        return (img, segs, [counts[n] for n in names],
                [a - b for a, b in zip(launches(), before)])

    render = make_render_fn(cam, bg, w, h, spp, bounces, dev,
                            fuse_bounce=fuse)
    kept = []
    tracing.reset()
    try:
        for scene, graphed in ((scene_a, spp - 1), (scene_a, spp),
                               (scene_b, spp - 1)):
            want, want_segs, want_counts, want_launches = eager(scene)
            before = launches()
            img, segs = render(scene)
            counts = tracing.images()[-1].counts
            assert torch.equal(img, want) and segs == want_segs > w * h
            assert [a - b for a, b in zip(launches(), before)] == \
                want_launches == [spp * bounces] * len(kernels) + [
                    spp * len(_default_compact_at(bounces))]
            assert [counts[n] for n in names] == want_counts
            assert counts["pt.graph_passes"] == graphed
            kept.append((img, img.clone()))
    finally:
        tracing.reset()
    assert all(torch.equal(img, copy) for img, copy in kept)


def test_sphere_graph_pool_is_freed_with_its_renderer(dev):
    """A Renderer that captured its pass, dropped when its render function
    moves to another scene object, frees its graph and the graph's pool:
    the device's allocated and reserved bytes come back to what they were
    before it, once a render function of a third scene has warmed the
    process up."""
    import gc
    import weakref

    from pathtracer_tpu_torch.integrator import renderer_per_scene
    from pathtracer_tpu_torch.utils import tracing

    scene_a, cam, bg = shirley.build(2.0, dev)
    scene_b, scene_c = (shirley.build(2.0, dev)[0] for _ in range(2))

    def settle():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return (torch.cuda.memory_allocated(dev),
                torch.cuda.memory_reserved(dev))

    def rendered(renderer, scene):
        r = renderer(scene)
        for _ in range(2):  # the capture, then a replay
            with tracing.span(tracing.ROOT):
                r()
        return r

    tracing.reset()
    try:
        rendered(renderer_per_scene(cam, bg, 160, 80, 3, 8, dev), scene_c)
        base = settle()
        renderer = renderer_per_scene(cam, bg, 160, 80, 3, 8, dev)
        r = rendered(renderer, scene_a)
        graph = weakref.ref(r._graph)
        held = r._graph.graph is not None
        r = weakref.ref(r)
        during = settle()
        renderer(scene_b)
        assert r() is None and graph() is None
        del renderer
        after = settle()
    finally:
        tracing.reset()
    assert held and during[1] > base[1]
    assert after[0] == base[0] and after[1] <= base[1]


def _clustered_rays(dev, scene, cam, n, seed):
    """n rays, half from the shirley camera at the origin, half from points
    near its spheres, 85% alive, block 1 all dead."""
    rng = np.random.default_rng(seed)
    cx, cy = (torch.from_numpy(rng.random(n, np.float32)).to(dev)
              for _ in range(2))
    d = cam.ray_dirs(cx, cy)
    c = scene.center[torch.from_numpy(rng.integers(0, 531, n)).to(dev)]
    first = torch.arange(n, device=dev)[:, None] < n // 2
    org = torch.where(first, 0.0,
                      c + torch.from_numpy(rng.uniform(-2, 2, (n, 3))
                                           .astype(np.float32)).to(dev))
    d = torch.where(first, d, torch.nn.functional.normalize(d + 0.3, dim=1))
    alive = torch.from_numpy(rng.random(n) < 0.85).to(dev)
    alive[1024:2048] = False
    return org.contiguous(), d.contiguous(), alive


def _full_cluster_tables(k, dev):
    """k clusters of CLUSTER real spheres each (r in [0.02, 0.08], jittered
    around a grid at z = -20), packed as pack_spheres_clustered packs them:
    A = r^2 - |c|^2 and the circumsphere of each cluster's box, in float32
    numpy; perm the identity."""
    rng = np.random.default_rng(5)
    side = int(np.ceil(np.sqrt(k)))
    j = np.arange(k)
    grid = np.stack([(j % side - side / 2) * 0.5, (j // side - side / 2) * 0.5,
                     np.full(k, -20.0)], 1)
    c = (grid[:, None, :] + rng.uniform(-0.15, 0.15, (k, sk.CLUSTER, 3))
         ).astype(np.float32)
    r = rng.uniform(0.02, 0.08, (k, sk.CLUSTER)).astype(np.float32)
    sph = np.zeros((4, k * sk.CLUSTER), np.float32)
    sph[:3] = c.reshape(-1, 3).T
    sph[3] = (r * r - (c * c).sum(2)).reshape(-1)
    blo = (c - r[..., None]).min(1)
    bhi = (c + r[..., None]).max(1)
    cc = 0.5 * (blo + bhi)
    cr = np.linalg.norm(bhi - cc, axis=1).astype(np.float32)
    clus = np.concatenate([cc.T, (cr * cr)[None, :]]).astype(np.float32)
    perm = np.arange(k * sk.CLUSTER, dtype=np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (sph, clus, perm))


@pytest.mark.parametrize("case", ["render_rays", "shuffled", "uncovered",
                                  "k_limit"])
def test_intersect_clustered_kernel_matches_plain(dev, case):
    """Shirley's 178 clusters against 8,192 rays from the shirley camera
    and from points near its spheres, with an all-dead block; the same
    rays shuffled (the warp skip's worst case); with lanes outside the
    warp skip's proof (NaN, inf, zero and non-unit directions, a far
    origin); and 784 full clusters, the wrapper's limit with CLUSTER real
    spheres each (785 are refused). Every output equal on every lane."""
    scene, cam, _ = shirley.build(2.0, dev)
    tables = sk.pack_spheres_clustered(scene.center, scene.radius,
                                       scene.valid)
    org, d, alive = _clustered_rays(dev, scene, cam, 8192, 11)
    if case == "shuffled":
        perm = torch.from_numpy(np.random.default_rng(2).permutation(8192))
        org, d, alive = (x[perm.to(dev)].contiguous()
                         for x in (org, d, alive))
    elif case == "uncovered":
        lanes = torch.arange(0, 8192, 97, device=dev)
        d[lanes[0::6], 1] = float("nan")
        d[lanes[1::6], 0] = float("inf")
        d[lanes[2::6]] = 0.0
        d[lanes[3::6]] *= 2.0
        d[lanes[4::6]] *= 1.0 + 2.0 ** -13
        org[lanes[5::6], 0] = 2.0 ** 51
    elif case == "k_limit":
        k = 784
        tables = _full_cluster_tables(k, dev)
        assert sk.cluster_walk(tables).n_real == k * sk.CLUSTER
        assert (sk.clustered_smem_bytes(k, k * sk.CLUSTER) <= sk.SMEM_MAX
                < sk.clustered_smem_bytes(k + 1, (k + 1) * sk.CLUSTER))
        with pytest.raises(ValueError, match="shared memory"):
            sk.intersect_clustered(_full_cluster_tables(k + 1, dev), org, d,
                                   alive)
        rng = np.random.default_rng(4)
        aim = torch.from_numpy(rng.uniform(-8, 8, (8192, 3))
                               .astype(np.float32)).to(dev)
        aim[:, 2] = -20.0
        d = torch.nn.functional.normalize(aim - org, dim=1).contiguous()
    args = (org, d, alive)
    before = sk.intersect_clustered.launches
    got = sk.intersect_clustered(tables, *args)
    assert sk.intersect_clustered.launches == before + 1
    want = sk.intersect_clustered_plain(tables, *args)
    for g, w in zip(got, want):  # inv_a is NaN on NaN lanes in both
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert bool(got[2].any())
    if case == "render_rays":
        assert not bool(got[2][1024:2048].any())
    if case in ("render_rays", "shuffled"):
        table = sk.pack_spheres(scene.center, scene.radius, scene.valid)
        brute = sk.intersect_spheres(table, *args)
        assert torch.equal(got[2][alive], brute[2][alive])
        assert torch.equal(got[0][alive], brute[0][alive])


def test_gather_flux_kernel_matches_plain(dev):
    """The raster gather over a 96x96 cornell iteration's photons and eye
    hits, on the port's device-built grid: the kernel against its plain
    version on every block, and against the chunk gather."""
    scene, cam, lights = cornell.build(1.0, dev)
    trace, _, _ = ppm.make_photon_pass(scene, lights, 5000, 4)
    pos, nrm, flux, ok, _ = trace(0)
    eye = ppm.make_eye_pass(cam, 96, 96, 4, 5000, scene)
    r = ppm.PPMRenderer(scene, cam, lights, 96, 96).radius(1)
    pt, nm, _, act = eye.walk(0)
    photons_t, start, count, glo, cell = ppm._build_grid_morton_device(
        pos, nrm, flux, ok, r)
    s, e, own = gk.query_tables(pt, act, glo, cell, start, count)
    perm = torch.argsort(own, stable=True)
    args = (pt[perm].contiguous(), nm[perm].contiguous(),
            s[:, perm].contiguous(), e[:, perm].contiguous(), photons_t, r)
    before = gk.gather_flux.launches
    got = gk.gather_flux(*args)
    assert gk.gather_flux.launches == before + 1
    want = gk.gather_flux_plain(*args)
    assert torch.equal(got, want), (got - want).abs().max()
    photons_c, sbox = gk.build_photon_chunks(pos, nrm, flux, ok)
    chunks = gk.gather_flux_chunks(args[0], args[1], act[perm], sbox,
                                   photons_c, r)
    assert float(got.abs().sum()) > 0
    assert torch.allclose(got, chunks, rtol=1e-4, atol=1e-6)


def _long_range_args(dev):
    """2,048 hits over 3,000 uniform photons and a cluster of 20,000 in one
    grid cell: the hits near the cluster walk ranges of ~20,000 photons,
    many tiles and a ragged last one, the others short ones."""
    rng = np.random.default_rng(11)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    r = 0.05
    pos = np.concatenate([rng.random((3000, 3)),
                          0.5 + 0.01 * rng.random((20000, 3))])
    nrm = rng.standard_normal(pos.shape)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    flux = rng.random(pos.shape)
    point = rng.random((2048, 3))
    point[:64] = 0.5 + 0.02 * rng.random((64, 3))
    normal = rng.standard_normal((2048, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    f32 = lambda x: t(x.astype(np.float32))
    tbl, start, count = gk.build_photon_grid_morton(
        f32(pos), f32(nrm), f32(flux), t(rng.random(len(pos)) < 0.97),
        f32(np.zeros(3)), r)
    s, e, _ = gk.query_tables(f32(point), t(np.ones(2048, bool)),
                              f32(np.zeros(3)), r, start, count)
    assert int((e - s).max()) > 15000
    return f32(point), f32(normal), s, e, tbl, r


def test_gather_flux_kernel_on_one_very_long_range(dev):
    """The raster gather on _long_range_args: the kernel against its plain
    version."""
    args = _long_range_args(dev)
    got = gk.gather_flux(*args)
    want = gk.gather_flux_plain(*args)
    assert torch.equal(got, want), (got - want).abs().max()
    assert float(got[:64].abs().sum()) > 0


@pytest.mark.parametrize("heavy", [0, 2 ** 31 - 1])
def test_gather_flux_kernel_batched_or_not(dev, heavy, monkeypatch):
    """Every warp walked in batches (HEAVY = 0), or none: the kernel still
    equals its plain version on _long_range_args."""
    monkeypatch.setattr(gk, "HEAVY", heavy)
    args = _long_range_args(dev)
    got = gk.gather_flux(*args)
    assert torch.equal(got, gk.gather_flux_plain(*args))


SQRT_CHECK = r"""
#include <cuda_runtime.h>
#include "sqrt_rn.cuh"

__global__ void check(unsigned long long* bad) {
  const unsigned long long k =
      (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 0x7f800000ull) return;  // every finite x >= +0
  const float x = __uint_as_float((unsigned)k);
  if (__float_as_uint(sqrtf(x)) !=
      __float_as_uint(pt_sqrt::sqrt_nonneg(x)))
    atomicAdd(bad, 1ull);
}

extern "C" int run(unsigned long long* bad) {
  check<<<0x7f800000u / 256, 256>>>(bad);
  return (int)cudaGetLastError();
}
"""


def test_sqrt_nonneg_equals_sqrtf_on_every_float(dev, tmp_path):
    """csrc/sqrt_rn.cuh's branch-free root (the raster gather's batches)
    against sqrtf on all 2,139,095,040 finite non-negative floats, built
    with the kernels' flags."""
    import ctypes
    import subprocess

    from pathtracer_tpu_torch import _build
    src, so = tmp_path / "sqrt_check.cu", tmp_path / "sqrt_check.so"
    src.write_text(SQRT_CHECK)
    subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-shared", "-I",
                    os.path.join(ROOT, "pathtracer_tpu_torch", "csrc"),
                    "-o", str(so), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_void_p]
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    assert lib.run(bad.data_ptr()) == 0
    torch.cuda.synchronize()
    assert int(bad) == 0


def test_new_wrappers_refuse_malformed_input(dev):
    state = torch.zeros(10, 8, 128, device=dev)
    sph = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError):  # state rows not a multiple of 8
        sk.intersect_state(sph, state[:, :7].contiguous(), origin_zero=False)
    with pytest.raises(ValueError):  # table on the CPU
        sk.intersect_state(sph.cpu(), state, origin_zero=False)
    with pytest.raises(ValueError):  # the full variant without a hierarchy
        sk.intersect_state(sph, state, origin_zero=False)
    hier = sk.build_sphere_bvh(torch.tensor(
        [[0.0, 2.0], [0.0, 0.0], [0.0, 0.0], [1.0, -3.0]], device=dev))
    with pytest.raises(ValueError):  # the hierarchy on the CPU
        sk.intersect_state(sph, state, origin_zero=False,
                           sphere_bvh=sk.SphereBVH(
                               *(x.cpu() for x in hier[:3]), *hier[3:]))
    nodes = torch.zeros(hier.nodes.numel() + 1, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):  # nodes off by 4 B
        sk.intersect_state(sph, state, origin_zero=False,
                           sphere_bvh=hier._replace(
                               nodes=nodes.view_as(hier.nodes)))
    i32 = torch.zeros(8, 128, dtype=torch.int32, device=dev)
    f32 = torch.zeros(8, 128, device=dev)
    pack = torch.zeros(10, 1, 128, device=dev)
    rad = torch.zeros(3, 8, 128, device=dev)
    limbs = np.zeros((2, 2), np.uint32)
    bgc = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
    with pytest.raises(ValueError):  # idx of the wrong dtype
        shk.shade_state(state, pack, f32, i32, f32, limbs, bgc, rad,
                        bg_mode=1)
    org = torch.zeros(1024, 3, device=dev)
    alive = torch.ones(1024, dtype=torch.bool, device=dev)
    tables = (torch.zeros(4, 16, device=dev), torch.zeros(4, 1, device=dev),
              torch.zeros(16, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):  # int64 perm
        sk.intersect_clustered(tables, org, org, alive)
    ranges = torch.zeros(9, 1024, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # photons_t of the wrong height
        gk.gather_flux(org, org, ranges, ranges,
                       torch.zeros(9, 128, device=dev), 0.1)


def _mesh_bounce_matches_plain(r, bounces):
    """Hold winner_t and mesh_bounce to the plain bounce at each of the
    first `bounces` bounces of pass 0 of MeshRenderer r
    (mesh_bounce_kernel.plain_bounces, bounce_equal): t_cur, org, d, attn,
    rad and alive equal, the segments the live lanes, one launch each.
    Returns, per bounce, the live lanes that end on the floor, on the mesh
    and in the sky, and the dead lanes."""
    from pathtracer_tpu_torch.ops.cuda import mesh_bounce_kernel as mbk

    seen = []
    for c in mbk.plain_bounces(r, bounces):
        launches = (mbk.winner_t.launches, mbk.mesh_bounce.launches)
        equal = mbk.bounce_equal(r, c)
        assert all(equal.values()), (c["b"], equal)
        assert (mbk.winner_t.launches, mbk.mesh_bounce.launches) == (
            launches[0] + 1, launches[1] + 1)
        seen.append(c["ends"])
    return seen


@pytest.mark.parametrize("yaw_seed", [None, 5])
def test_mesh_bounce_kernels_match_plain(dev, tmp_path, yaw_seed):
    """The two bounce kernels of the mesh path tracer against their plain
    version on every bounce of a 60x60 pass over the tiny ganesha
    (turned by the seed): bounce 0 after the tile kernel, bounces 1-3
    after the walk; torch.equal on t_cur, org, d, attn, rad and alive, the
    segments equal the live lanes. Every bounce has dead lanes (60x60
    pads 3,600 lanes to 4,096), and lanes that end on the floor, on the
    mesh and in the sky."""
    scene, cam, bg, mesh = _tiny_ganesha_pt(dev, tmp_path, yaw_seed)
    r = MeshRenderer(scene, cam, bg, 60, 60, 1, 4, dev, mesh)
    seen = _mesh_bounce_matches_plain(r, 4)
    assert all(min(s.values()) > 0 for s in seen), seen


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_mesh_pass_kernels_equal_the_plain_passes(dev, tmp_path, seed,
                                                  monkeypatch):
    """A MeshRenderer's band_sums at 60x60, spp 4, 8 bounces over the tiny
    ganesha turned by the seed (the kernels; each pass after the first a
    replayed graph) equal the sums and segments of the same passes traced
    by trace_plain, eagerly, bit for bit. The render counts pt.mesh_bounces
    and pt.fused_bounces spp * 8 each."""
    from pathtracer_tpu_torch import integrator as it
    from pathtracer_tpu_torch.integrator import MeshRenderer
    from pathtracer_tpu_torch.ops.cuda import mesh_bounce_kernel as mbk
    from pathtracer_tpu_torch.utils import tracing

    scene, cam, bg, mesh = _tiny_ganesha_pt(dev, tmp_path, seed)
    r = MeshRenderer(scene, cam, bg, 60, 60, 4, 8, dev, mesh)
    mbk.mesh_bounce.launches = mbk.winner_t.launches = 0
    tracing.reset()
    try:
        with tracing.span(tracing.ROOT):
            sums, segs = r.band_sums(range(4))
        counts = tracing.images()[-1].counts
    finally:
        tracing.reset()
    assert mbk.mesh_bounce.launches == mbk.winner_t.launches == 32
    assert counts["pt.mesh_bounces"] == counts["pt.fused_bounces"] == 32
    monkeypatch.setattr(it, "trace", it.trace_plain)
    want = torch.zeros_like(sums)
    want_segs = torch.zeros_like(segs)
    for p in range(4):
        rad, s = r.trace_pass(p)
        want += rad
        want_segs += s
    assert mbk.mesh_bounce.launches == 32
    assert torch.equal(sums, want) and int(segs) == int(want_segs) > 3600


def test_mesh_bounce_wrappers_refuse_malformed_input(dev, tmp_path):
    from pathtracer_tpu_torch.ops.cuda import mesh_bounce_kernel as mbk

    scene, cam, bg, mesh = _tiny_ganesha_pt(dev, tmp_path)
    r = MeshRenderer(scene, cam, bg, 32, 32, 1, 2, dev, mesh)
    offset, org, d, alive = r.primary(0)
    pools = r.hit_setup.pools(org, d, alive)
    with pytest.raises(ValueError, match="idx_s"):  # int64 sphere index
        mbk.winner_t(scene, (pools[0], pools[1].long(), *pools[2:]), org, d)
    t_cur = mbk.winner_t(scene, pools, org, d)
    hits = r.hit_setup.query(org, d, t_cur, alive)
    lanes = (org.clone(), d.clone(), torch.ones_like(org),
             torch.zeros_like(org))
    segs = torch.zeros((), dtype=torch.int64, device=dev)
    args = (scene, mesh, pools, hits, r.sampler.limbs(2, 3))
    with pytest.raises(ValueError, match="offset"):  # int32 offsets
        mbk.mesh_bounce(*args, offset.int(), r.sky_colors, *lanes,
                        alive.clone(), segs)
    with pytest.raises(ValueError, match="alive"):  # a float alive
        mbk.mesh_bounce(*args, offset, r.sky_colors, *lanes, alive.float(),
                        segs)
