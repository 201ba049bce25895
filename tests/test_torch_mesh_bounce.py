"""The mesh path tracer's bounce after its intersectors on the CPU: the
eager code that is the plain version of ops/cuda/mesh_bounce_kernel.py
(integrator.composite_hits, scatter_bounce, trace_plain), held bit for bit
to the single-function hit_setup and trace loop it was moved out of (kept
below as they were), the counters trace counts, the kernel's sampler
arithmetic against ops/lds.py's limbs, the wrappers' refusal of CPU
tensors, the modules a sphere render loads, and the fused-bounce reader.
The kernels themselves need the card (tests/test_torch_cuda.py).

The tiny ganesha is tests/test_torch_mesh_graph.py's: a 12x8 uv-sphere of
168 triangles over the checkered floor, under the shirley sky."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import integrator
from pathtracer_tpu_torch.integrator import Intersector, MeshRenderer, trace
from pathtracer_tpu_torch.io import ply
from pathtracer_tpu_torch.models import ganesha
from pathtracer_tpu_torch.ops import lds, quat as quat_ops, shading, vec
from pathtracer_tpu_torch.ops.cuda.sphere_kernel import (BIG,
                                                         intersect_spheres,
                                                         pack_spheres)
from pathtracer_tpu_torch.ops.cuda.tri_kernel import intersect_tris, pack_tris
from pathtracer_tpu_torch.ops.spheres import stable_t
from pathtracer_tpu_torch.ops.triangles import mt_single
from pathtracer_tpu_torch.scene import (TRI_A, TRI_E1, TRI_E2, TRI_MAT,
                                        TRI_TEX, eval_texture)
from pathtracer_tpu_torch.utils import tracing

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402

CPU = torch.device("cpu")
_PI = float(np.float32(np.pi))
_TWO_PI_INV = float(np.float32(0.5 / np.pi))
_PI_INV = float(np.float32(1.0 / np.pi))


def _old_make_intersector(scene, mesh=None, mesh_intersect=None):
    """make_intersector as one closure, before its combine moved into
    integrator.composite_hits (the reference of the move)."""
    sph_table = pack_spheres(scene.center, scene.radius, scene.valid)
    has_tris = scene.tri_count > 0
    if has_tris:
        tp = scene.tri_pack
        tri_table = pack_tris(tp[:, TRI_A], tp[:, TRI_E1], tp[:, TRI_E2],
                              scene.tri_valid)
    has_mesh = mesh is not None

    def hit_setup(org, d, alive):
        at, idx_s, hit_s, inv_a = intersect_spheres(sph_table, org, d, alive)
        pk_rows = scene.shade_pack[idx_s.long()]
        r_h = pk_rows[:, 3]
        t_s = stable_t(pk_rows[:, 0:3], r_h * r_h, org, d, vec.quadrance(d),
                       inv_a)
        if has_tris:
            t_t, idx_t, hit_t = intersect_tris(tri_table, org, d, alive)
            tri_rows = scene.tri_pack[idx_t.long()]
            use_tri = hit_t & (~hit_s | (t_t < t_s))
            hit = hit_s | hit_t
        else:
            use_tri = torch.zeros_like(hit_s)
            hit = hit_s
        if has_mesh:
            t_cur = torch.where(hit, torch.where(use_tri, t_t, t_s)
                                if has_tris else t_s, BIG)
            if mesh_intersect is not None:
                t_m, u_m, v_m, idx_m, hit_m = mesh_intersect(org, d, alive)
            else:
                t_m, u_m, v_m, idx_m, hit_m = mesh.intersect(org, d, t_cur,
                                                             alive)
            use_mesh = hit_m & (t_m < t_cur)
            use_tri = use_tri & ~use_mesh
            hit = hit | hit_m

        point_s = org + t_s[:, None] * d
        n_s = vec.normalize(point_s - pk_rows[:, 0:3])
        if has_tris:
            a, e1, e2 = tri_rows[:, TRI_A], tri_rows[:, TRI_E1], \
                tri_rows[:, TRI_E2]
            _, u_b, v_b = mt_single(a, e1, e2, org, d)
            point_t = a + u_b[:, None] * e1 + v_b[:, None] * e2
            n_t = vec.normalize(vec.cross(e1, e2))
            point = vec.where3(use_tri, point_t, point_s)
            g_normal = vec.where3(use_tri, n_t, n_s)
            t = torch.where(use_tri, t_t, t_s)
        else:
            point, g_normal, t = point_s, n_s, t_s
        if has_mesh:
            cols = mesh.tri_pack9[:, idx_m.long()].T.contiguous()
            ma, me1, me2 = cols[:, 0:3], cols[:, 3:6], cols[:, 6:9]
            point_m = ma + u_m[:, None] * me1 + v_m[:, None] * me2
            n_m = vec.normalize(vec.cross(me1, me2))
            point = vec.where3(use_mesh, point_m, point)
            g_normal = vec.where3(use_mesh, n_m, g_normal)
            t = torch.where(use_mesh, t_m, t)

        hit_front = vec.dot(d, g_normal) < 0.0
        normal = vec.where3(hit_front, g_normal, -g_normal)
        ny = torch.clamp(normal[:, 1], -1.0, 1.0)
        theta = torch.acos(-ny)
        phi = _PI + torch.atan2(-normal[:, 2], normal[:, 0])
        u_tex = phi * _TWO_PI_INV
        v_tex = theta * _PI_INV
        mat_rows = pk_rows[:, 4:16]
        if has_tris:
            tx = tri_rows[:, TRI_TEX]
            w_b = 1.0 - u_b - v_b
            tri_u = tx[:, 0] * w_b + tx[:, 2] * u_b + tx[:, 4] * v_b
            tri_v = tx[:, 1] * w_b + tx[:, 3] * u_b + tx[:, 5] * v_b
            u_tex = torch.where(use_tri, tri_u, u_tex)
            v_tex = torch.where(use_tri, tri_v, v_tex)
            mat_rows = torch.where(use_tri[:, None], tri_rows[:, TRI_MAT],
                                   mat_rows)
        if has_mesh:
            u_tex = torch.where(use_mesh, v_m, u_tex)
            v_tex = torch.where(use_mesh, u_m + v_m, v_tex)
            mat_rows = torch.where(use_mesh[:, None], mesh.mat_row_t[None, :],
                                   mat_rows)
        albedo = eval_texture(mat_rows[:, 1], mat_rows[:, 2:5],
                              mat_rows[:, 5:8], mat_rows[:, 8],
                              mat_rows[:, 9], u_tex, v_tex)
        return dict(hit=hit, t=t, point=point, normal=normal,
                    hit_front=hit_front, albedo=albedo,
                    mat_kind=mat_rows[:, 0], ior=mat_rows[:, 10],
                    ior_inv=mat_rows[:, 11])

    return hit_setup


def _old_trace(sampler, org, d, offset, max_bounces, sky_colors, alive0,
               hit_setup, hit_setup0=None):
    """trace as one loop, before its scatter moved into
    integrator.scatter_bounce. Also returns each bounce's rays."""
    hit_setup0 = hit_setup if hit_setup0 is None else hit_setup0
    sky_lo, sky_hi = (c.expand_as(org) for c in sky_colors)
    alive = alive0
    attn = torch.ones_like(org)
    rad = torch.zeros_like(org)
    segments = torch.zeros((), dtype=torch.int64, device=org.device)
    rays = []
    for bounce in range(max_bounces):
        rays.append((org, d, alive))
        segments += alive.sum()
        h = (hit_setup0 if bounce == 0 else hit_setup)(org, d, alive)
        hit = h["hit"] & alive
        miss = alive & ~hit
        sky_d = vec.lerp(0.5 * (d[:, 1] + 1.0), sky_lo, sky_hi)
        rad = rad + vec.where3(miss, attn * sky_d, torch.zeros_like(rad))
        q = shading.shader_quat(h["normal"])
        omega_i = quat_ops.rotate(q, -d)
        u = sampler.get(offset, 2 + 2 * bounce)
        v = sampler.get(offset, 3 + 2 * bounce)
        wo, attn_mult, ok = shading.scatter(
            h["mat_kind"], h["albedo"], h["ior"], h["ior_inv"], omega_i,
            h["hit_front"], u, v)
        dir_world = quat_ops.rotate_inv(q, wo)
        new_org = shading.world_ray(h["point"], dir_world)
        alive = hit & ok
        org = vec.where3(alive, new_org, org)
        d = vec.where3(alive, dir_world, d)
        attn = vec.where3(alive, attn * attn_mult, attn)
    return rad, segments, rays


def _bits(x: torch.Tensor) -> bytes:
    """A tensor's bytes: equal bits, NaNs and signed zeros included."""
    return x.contiguous().numpy().tobytes()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    path = str(tmp_path_factory.mktemp("mesh_bounce") / "tiny.ply")
    ply.write_mesh(path, verts, faces)
    scene, cam, bg, mesh = ganesha.build_pt(path, 1.0, CPU)
    return scene, cam, bg, mesh, MeshRenderer(scene, cam, bg, 48, 48, 2, 4,
                                              CPU, mesh)


@pytest.mark.parametrize("pass_idx", [0, 1])
def test_plain_trace_equals_the_single_loop_it_was_moved_from(tiny,
                                                              pass_idx):
    """trace on the CPU (trace_plain: composite_hits, scatter_bounce)
    gives the radiance and segments of the loop before the move, bit for
    bit, with the tile kernel at bounce 0 and with the walk throughout."""
    scene, cam, bg, mesh, r = tiny
    offset, org, d, alive = r.primary(pass_idx)
    old = _old_make_intersector(scene, mesh)
    old0 = _old_make_intersector(scene, mesh, r.mesh_intersect0)
    for new_setups, old_setups in (((r.hit_setup, r.hit_setup0),
                                    (old, old0)),
                                   ((r.hit_setup,), (old,))):
        rad, segs = trace(r.sampler, org, d, offset, 4, r.sky_colors, alive,
                          *new_setups)
        want, want_segs, _ = _old_trace(r.sampler, org, d, offset, 4,
                                        r.sky_colors, alive, *old_setups)
        assert _bits(rad) == _bits(want) and int(segs) == int(want_segs)
        assert float(rad.max()) > 0 and int(segs) > 48 * 48


def test_hit_setup_equals_the_single_closure_on_every_bounce(tiny):
    """The Intersector's hit_setup (pools, then composite_hits)
    gives the closure's dict on the rays of each bounce of a pass, key for
    key and bit for bit (the NaNs of lanes that hit nothing included); the
    rays hit the floor, the mesh and the sky, and some lanes are dead."""
    scene, cam, bg, mesh, r = tiny
    offset, org, d, alive = r.primary(0)
    old = _old_make_intersector(scene, mesh)
    _, _, rays = _old_trace(r.sampler, org, d, offset, 4, r.sky_colors,
                            alive, old)
    new = Intersector(scene, mesh)
    seen = dict(floor=0, mesh=0, sky=0, dead=0)
    for o, dd, a in rays:
        got, want = new(o, dd, a), old(o, dd, a)
        assert got.keys() == want.keys()
        for k in want:
            assert _bits(got[k]) == _bits(want[k]), k
        t_m, *_, hit_m = mesh.intersect(o, dd, torch.full_like(o[:, 0], BIG),
                                        a)
        on_mesh = a & hit_m & (want["t"] == t_m)
        seen["mesh"] += int(on_mesh.sum())
        seen["floor"] += int((a & want["hit"] & ~on_mesh).sum())
        seen["sky"] += int((a & ~want["hit"]).sum())
        seen["dead"] += int((~a).sum())
    assert min(seen.values()) > 0, seen


def test_trace_counts_mesh_bounces_and_no_fused_bounce_on_the_cpu(tiny):
    """pt.mesh_bounces counts every bounce of a pass; pt.fused_bounces,
    the card's kernels, none on the CPU: the reader then reads 0%."""
    scene, cam, bg, mesh, r = tiny
    tracing.reset()
    try:
        with tracing.span(tracing.ROOT):
            r.trace_pass(0)
        counts = tracing.images()[-1].counts
    finally:
        tracing.reset()
    assert counts["pt.mesh_bounces"] == 4
    assert "pt.fused_bounces" not in counts


def test_the_kernels_draw_is_the_limbs_draw():
    """mesh_bounce.cu's draw takes the top word of the 64-bit product
    (alpha_hi * 2^32 + alpha_lo) * (offset + 1) plus 2^31, the word that
    ops/lds.py:hi_word emulates in 16-bit limbs, then f32(v) * 2^-32
    clamped below 1: equal to Sampler.get on offsets across the uint32
    range, at every dimension of an 8-bounce sampler."""
    rng = np.random.default_rng(22)
    offs = np.concatenate([rng.integers(0, 2 ** 32, 4000, dtype=np.uint64),
                           np.array([0, 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                                    np.uint64)])
    sampler = lds.Sampler(18)
    for dim in range(18):
        alpha = (int(sampler.hi[dim]) << 32) | int(sampler.lo[dim])
        m = (offs + np.uint64(1)) & np.uint64(0xFFFFFFFF)
        top = [((alpha * int(x)) >> 32) & 0xFFFFFFFF for x in m]
        v = (np.array(top, np.uint64) + np.uint64(2 ** 31)) & np.uint64(
            0xFFFFFFFF)
        want = np.minimum(v.astype(np.float32) * np.float32(2.0 ** -32),
                          np.float32(lds.ONE_MINUS_EPS))
        got = sampler.get(torch.from_numpy(offs.astype(np.int64)), dim)
        np.testing.assert_array_equal(got.numpy(), want)


def test_the_kernel_wrappers_refuse_cpu_tensors(tiny):
    """winner_t and mesh_bounce launch only for CUDA tensors: the plain
    version of CPU lanes is trace_plain, which trace runs itself."""
    from pathtracer_tpu_torch.ops.cuda import mesh_bounce_kernel as mbk

    scene, cam, bg, mesh, r = tiny
    offset, org, d, alive = r.primary(0)
    pools = r.hit_setup.pools(org, d, alive)
    with pytest.raises(ValueError, match="winner_t"):
        mbk.winner_t(scene, pools, org, d)
    hits = r.hit_setup.query(org, d, torch.full_like(org[:, 0], BIG), alive)
    with pytest.raises(ValueError, match="mesh_bounce"):
        mbk.mesh_bounce(scene, mesh, pools, hits, r.sampler.limbs(2, 3),
                        offset, r.sky_colors, org, d, torch.ones_like(org),
                        torch.zeros_like(org), alive,
                        torch.zeros((), dtype=torch.int64))


@pytest.mark.parametrize("bounces", [1, 4])
def test_plain_bounces_step_through_the_plain_pass(tiny, bounces):
    """mesh_bounce_kernel.plain_bounces, the bounces the card holds the
    kernels to, steps through pass 0 as trace_plain traces it: its last
    bounce's outgoing radiance is trace_plain's bit for bit, its live
    lanes sum to the segments, each bounce's t_cur caps a query whose
    hits it gives, and each bounce's ends count every lane once."""
    from pathtracer_tpu_torch.ops.cuda import mesh_bounce_kernel as mbk

    scene, cam, bg, mesh, r = tiny
    cases = list(mbk.plain_bounces(r, bounces))
    assert [c["b"] for c in cases] == list(range(bounces))
    offset, org, d, alive = r.primary(0)
    rad, segs = integrator.trace_plain(r.sampler, org, d, offset, bounces,
                                       r.sky_colors, alive, r.hit_setup,
                                       r.hit_setup0)
    assert _bits(cases[-1]["want"][3]) == _bits(rad)
    assert sum(int(c["lanes"][4].sum()) for c in cases) == int(segs) > 0
    for c in cases:
        assert sum(c["ends"].values()) == org.shape[0], c["ends"]
        assert torch.equal(c["offset"], offset)
        if c["b"] > 0:
            o, dd, _, _, a = c["lanes"]
            want = mesh.intersect(o, dd, c["t_cur"], a)
            assert all(_bits(g) == _bits(w) for g, w in zip(c["hits"], want))


# the port's modules that importing its CLI and rendering shirley load
SPHERE_PATH_MODULES = {
    "pathtracer_tpu_torch", "pathtracer_tpu_torch._build",
    "pathtracer_tpu_torch.camera", "pathtracer_tpu_torch.cli",
    "pathtracer_tpu_torch.film", "pathtracer_tpu_torch.integrator",
    "pathtracer_tpu_torch.models", "pathtracer_tpu_torch.models.shirley",
    "pathtracer_tpu_torch.native", "pathtracer_tpu_torch.ops",
    "pathtracer_tpu_torch.ops.cuda",
    "pathtracer_tpu_torch.ops.cuda.compact_kernel",
    "pathtracer_tpu_torch.ops.cuda.fused_bounce_kernel",
    "pathtracer_tpu_torch.ops.cuda.shade_kernel",
    "pathtracer_tpu_torch.ops.cuda.sphere_kernel",
    "pathtracer_tpu_torch.ops.cuda.tile_tri_kernel",
    "pathtracer_tpu_torch.ops.cuda.tri_kernel",
    "pathtracer_tpu_torch.ops.frustum", "pathtracer_tpu_torch.ops.lds",
    "pathtracer_tpu_torch.ops.quat", "pathtracer_tpu_torch.ops.shading",
    "pathtracer_tpu_torch.ops.spheres", "pathtracer_tpu_torch.ops.triangles",
    "pathtracer_tpu_torch.ops.vec", "pathtracer_tpu_torch.scene",
    "pathtracer_tpu_torch.utils", "pathtracer_tpu_torch.utils.ocaml_random",
    "pathtracer_tpu_torch.utils.tracing"}


def test_a_shirley_render_loads_no_new_module(tmp_path):
    """In a process of its own, importing the port's CLI and rendering
    shirley loads exactly SPHERE_PATH_MODULES of the port (a module loaded
    on the sphere path costs every sphere render's set-up), and a mesh
    render on the CPU then leaves the bounce kernels' module unloaded."""
    code = f"""
import sys
import torch
sys.path.insert(0, {ROOT!r})
import pathtracer_tpu_torch.cli
from pathtracer_tpu_torch.integrator import make_render_fn
from pathtracer_tpu_torch.models import shirley
scene, cam, bg = shirley.build(2.0, torch.device("cpu"))
make_render_fn(cam, bg, 32, 32, 1, 3, torch.device("cpu"))(scene)
print(sorted(m for m in sys.modules if m.startswith("pathtracer_tpu_torch")))
from tests.test_torch_mesh_graph import _render
import pathlib
_render("mesh_cpu", pathlib.Path({str(tmp_path)!r}))
print("pathtracer_tpu_torch.ops.cuda.mesh_bounce_kernel" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, mesh_loaded = out.stdout.strip().splitlines()[-2:]
    assert set(eval(loaded)) == SPHERE_PATH_MODULES
    assert mesh_loaded == "False"


def test_the_fused_bounce_reader(monkeypatch):
    """pt_driver.fused_bounce_pct: 100 x fused over mesh bounces of the
    untraced images; 0 where the plain version ran them; None where no
    image counts a mesh bounce (the sphere path, an older program)."""
    sys.path.insert(0, ROOT)
    from port_bench import spans, spec

    reader = spec.load_metric("pt_driver.fused_bounce_pct")
    rec = lambda **c: SimpleNamespace(counts=c)
    cases = [([rec(**{"pt.mesh_bounces": 64, "pt.fused_bounces": 64})] * 3,
              100.0),
             ([rec(**{"pt.mesh_bounces": 64})], 0.0),
             ([rec(**{"pt.mesh_bounces": 64, "pt.fused_bounces": 32}),
               rec(**{"pt.mesh_bounces": 64})], 25.0),
             ([rec(**{"pt.lanes": 10})], None), (None, None)]
    for recs, want in cases:
        monkeypatch.setattr(spans, "untraced", lambda ctx, r=recs: r)
        assert reader.read(SimpleNamespace()) == want
    assert (reader.LAYER, reader.MOVES, reader.UNIT) == ("PT driver",
                                                         "image_s", "%")


def test_trace_on_the_cpu_is_trace_plain(tiny, monkeypatch):
    """trace hands CPU lanes to trace_plain, arguments and all."""
    scene, cam, bg, mesh, r = tiny
    seen = []
    monkeypatch.setattr(integrator, "trace_plain",
                        lambda *a: seen.append(a) or "plain")
    offset, org, d, alive = r.primary(0)
    args = (r.sampler, org, d, offset, 4, r.sky_colors, alive, r.hit_setup,
            r.hit_setup0)
    assert trace(*args) == "plain" and seen == [args]
