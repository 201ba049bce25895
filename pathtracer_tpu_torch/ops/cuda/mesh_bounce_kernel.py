"""The mesh path tracer's bounce after its intersectors, as two CUDA
kernels (csrc/mesh_bounce.cu) over the lanes of integrator.trace.

`winner_t` gives each lane the pools' winner t, the mesh query's cap;
`mesh_bounce`, after the query, selects the winner among sphere, triangle
and mesh, adds the sky to a missing lane's radiance, scatters a hit by its
material and updates org, d, attn, rad and alive in place, adding the live
lanes to the bounce's segments. Their plain version is the eager code of
integrator.trace_plain: composite_hits (whose t_cur is winner_t's) then
scatter_bounce. It lives there, beside Intersector, which the photon
mapper runs eagerly on every device, so this module holds the launches,
and plain_bounces and bounce_equal, which hold them to that plain version
on a renderer's pass: integrator.trace imports it on a CUDA device, and
nothing on the sphere path or the CPU loads it. CPU tensors raise in
the launches; trace runs trace_plain for them.

Contract: pools as integrator.Intersector.pools returns them (the
sphere's at, idx int32, hit, inv_a; the triangle's t, idx int32, hit, or
three Nones); org, d, attn, rad (N, 3) f32, alive (N,) bool, offset (N,)
int64 sample offsets; hits the mesh query's (t, u, v, idx int32, hit);
all contiguous on one CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from . import check_tensors

__all__ = ["winner_t", "mesh_bounce", "plain_bounces", "bounce_equal"]


def _pool_args(what, scene, pools, org):
    """The pools' pointers, checked: (at, idx_s, inv_a, tri_t, idx_t,
    shade_pack, tri_pack), the triangle's three None without a pool."""
    n = org.shape[0]
    at, idx_s, _hit_s, inv_a, t_t, idx_t, _hit_t = pools
    f32, i32 = torch.float32, torch.int32
    checks = [("org", org, f32, (n, 3)), ("at", at, f32, (n,)),
              ("idx_s", idx_s, i32, (n,)), ("inv_a", inv_a, f32, (n,)),
              ("shade_pack", scene.shade_pack, f32,
               (scene.shade_pack.shape[0], 16))]
    if t_t is not None:
        checks += [("t_t", t_t, f32, (n,)), ("idx_t", idx_t, i32, (n,)),
                   ("tri_pack", scene.tri_pack, f32,
                    (scene.tri_pack.shape[0], 27))]
    if org.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {org.device} (the plain "
                         "version is integrator.trace_plain)")
    check_tensors(what, org.device, checks)
    ptr = lambda t: None if t is None else t.data_ptr()
    return (at.data_ptr(), idx_s.data_ptr(), inv_a.data_ptr(), ptr(t_t),
            ptr(idx_t), scene.shade_pack.data_ptr(),
            ptr(scene.tri_pack if t_t is not None else None))


def winner_t(scene, pools, org, d):
    """The pools' winner t of each lane (N,) f32: the sphere winner's
    stable t or the nearer triangle's, BIG where neither pool hits
    (composite_hits' t_cur). Counted in `winner_t.launches`."""
    args = _pool_args("winner_t", scene, pools, org)
    n = org.shape[0]
    check_tensors("winner_t", org.device,
                  [("d", d, torch.float32, (n, 3))])
    t_cur = torch.empty(n, dtype=torch.float32, device=org.device)
    lib = _build.load()
    err = lib.pt_winner_t(*args, org.data_ptr(), d.data_ptr(),
                          t_cur.data_ptr(), n,
                          torch.cuda.current_stream(org.device).cuda_stream)
    _build.check(lib, err, "winner_t")
    winner_t.launches += 1
    return t_cur


winner_t.launches = 0


def mesh_bounce(scene, mesh, pools, hits, limbs, offset, sky_colors, org, d,
                attn, rad, alive, segments) -> None:
    """The rest of one bounce of trace, in place: the winner among the
    pools and the mesh's hits (t, u, v, idx, hit), then the sky on a miss
    or the scatter of a hit with the bounce's sampler limbs ((2, 2) uint32,
    Sampler.limbs); org, d, attn, rad and alive take the bounce's results
    and segments (0-dim int64) the live lanes' count. Counted in
    `mesh_bounce.launches`."""
    args = _pool_args("mesh_bounce", scene, pools, org)
    n = org.shape[0]
    t_m, u_m, v_m, idx_m, hit_m = hits
    f32 = torch.float32
    check_tensors("mesh_bounce", org.device, [
        ("t_m", t_m, f32, (n,)), ("u_m", u_m, f32, (n,)),
        ("v_m", v_m, f32, (n,)), ("idx_m", idx_m, torch.int32, (n,)),
        ("hit_m", hit_m, torch.bool, (n,)),
        ("tri_pack9", mesh.tri_pack9, f32, (9, mesh.tri_pack9.shape[1])),
        ("mat_row_t", mesh.mat_row_t, f32, (12,)),
        ("d", d, f32, (n, 3)), ("attn", attn, f32, (n, 3)),
        ("rad", rad, f32, (n, 3)), ("alive", alive, torch.bool, (n,)),
        ("offset", offset, torch.int64, (n,)),
        ("sky_colors", sky_colors, f32, (2, 3)),
        ("segments", segments, torch.int64, ())])
    limbs = np.asarray(limbs, np.uint32)
    lib = _build.load()
    err = lib.pt_mesh_bounce(
        *args, t_m.data_ptr(), u_m.data_ptr(), v_m.data_ptr(),
        idx_m.data_ptr(), hit_m.data_ptr(), mesh.tri_pack9.data_ptr(),
        mesh.tri_pack9.shape[1], mesh.mat_row_t.data_ptr(), org.data_ptr(),
        d.data_ptr(), attn.data_ptr(), rad.data_ptr(), alive.data_ptr(),
        offset.data_ptr(), sky_colors.data_ptr(), int(limbs[0, 0]),
        int(limbs[0, 1]), int(limbs[1, 0]), int(limbs[1, 1]),
        segments.data_ptr(), n,
        torch.cuda.current_stream(org.device).cuda_stream)
    _build.check(lib, err, "mesh_bounce")
    mesh_bounce.launches += 1


mesh_bounce.launches = 0


def plain_bounces(r, bounces):
    """The plain version's first `bounces` bounces of pass 0 of the
    MeshRenderer r, to hold the kernels to: the pass traced eagerly
    (Intersector.pools, integrator.composite_hits with the mesh query at
    its t_cur, integrator.scatter_bounce), yielding at each bounce a dict:
    b; pools, t_cur, hits (the query's), limbs and offset, the kernels'
    inputs beside lanes, the (org, d, attn, rad, alive) going in; want,
    scatter_bounce's lanes coming out; and ends, the live lanes that end
    on the floor, on the mesh and in the sky, and the dead lanes. Runs on
    any device; bounce_equal launches the kernels on one of its bounces."""
    from ...integrator import composite_hits, scatter_bounce

    offset, org, d, alive = r.primary(0)
    lanes = (org, d, torch.ones_like(org), torch.zeros_like(org), alive)
    sky = tuple(c.expand_as(org) for c in r.sky_colors)
    for b in range(bounces):
        hs = r.hit_setup0 if b == 0 else r.hit_setup
        org, d, _, _, alive = lanes
        pools = hs.pools(org, d, alive)
        asked = []

        def query(t_cur):
            asked.append((t_cur, hs.query(org, d, t_cur, alive)))
            return asked[-1][1]

        h = composite_hits(r.scene, r.mesh, pools, org, d, query)
        (t_cur, hits), = asked
        want = scatter_bounce(h, r.sampler, b, offset, sky, *lanes)
        on_mesh = alive & hits[4] & (hits[0] < t_cur)
        yield dict(b=b, pools=pools, t_cur=t_cur, hits=hits,
                   limbs=r.sampler.limbs(2 + 2 * b, 3 + 2 * b),
                   offset=offset, lanes=lanes, want=want, ends=dict(
                       floor=int((alive & h["hit"] & ~on_mesh).sum()),
                       mesh=int(on_mesh.sum()),
                       sky=int((alive & ~h["hit"]).sum()),
                       dead=int((~alive).sum())))
        lanes = want


def bounce_equal(r, c) -> dict:
    """winner_t and mesh_bounce (on copies of the lanes) launched on c, a
    bounce of plain_bounces(r, ...): for t_cur, org, d, attn, rad and
    alive, whether the kernel's equals the plain version's (torch.equal),
    and for segments whether the kernel counted the live lanes."""
    org, d, _, _, alive = c["lanes"]
    out = {"t_cur": torch.equal(winner_t(r.scene, c["pools"], org, d),
                                c["t_cur"])}
    got = [x.clone() for x in c["lanes"]]
    segs = torch.zeros((), dtype=torch.int64, device=org.device)
    mesh_bounce(r.scene, r.mesh, c["pools"], c["hits"], c["limbs"],
                c["offset"], r.sky_colors, *got, segs)
    for name, g, w in zip(("org", "d", "attn", "rad", "alive"), got,
                          c["want"]):
        out[name] = torch.equal(g, w)
    out["segments"] = int(segs) == int(alive.sum())
    return out
