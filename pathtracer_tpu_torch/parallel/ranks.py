"""Rank entry points for group.spawn: render_pt and render_ppm each take a
list of specs of plain values and, for each in turn, build its scene on
their own rank, render it once through the multi-device path and return
what the caller checks, one result per spec. Every rank returns; spawn
keeps rank 0's, and `same_on_every_rank` says whether every rank's image
is rank 0's bit for bit. sharded_pt and ppm_renderer build a spec's
renderer, for callers that time or count its renders.

The scenes: "shirley" (models.shirley.build), "ganesha_pt"
(models.ganesha.build_pt of spec["ply"]), "cornell" (models.cornell.build)
and "ganesha" (models.ganesha.build of spec["ply"]), at the aspect
width / height."""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["sharded_pt", "ppm_renderer", "render_pt", "render_ppm"]


def sharded_pt(device, spec):
    """render() -> (image, segments): make_sharded_render_fn over a
    (spec["dp"], spec["sp"]) mesh of the group's ranks, of the scene at
    width x height, spp, bounces."""
    from ..models import ganesha, shirley
    from .mesh import make_mesh, make_sharded_render_fn
    w, h = spec["width"], spec["height"]
    scene_mesh = None
    if spec["scene"] == "shirley":
        scene, cam, bg = shirley.build(w / h, device)
    else:
        scene, cam, bg, scene_mesh = ganesha.build_pt(spec["ply"], w / h,
                                                      device)
    render = make_sharded_render_fn(
        cam, bg, w, h, spec["spp"], spec["bounces"],
        make_mesh(spec["dp"], spec["sp"], device.type), device,
        scene_mesh=scene_mesh)
    return lambda: render(scene)


def ppm_renderer(device, spec):
    """PPMRenderer over a ("pp",) mesh of the group's ranks: the scene at
    width x height, spec["iterations"], spec["photons"] per iteration,
    spec["bounces"], shard_photon_map=spec["shard"]."""
    from ..models import cornell, ganesha
    from ..ppm import PPMRenderer
    from .ppm_ring import make_ppm_mesh
    w, h = spec["width"], spec["height"]
    mesh = None
    if spec["scene"] == "cornell":
        scene, cam, lights = cornell.build(w / h, device)
    else:
        scene, cam, lights, mesh = ganesha.build(spec["ply"], w / h, device)
    return PPMRenderer(scene, cam, lights, w, h,
                       iterations=spec["iterations"],
                       photon_count=spec["photons"],
                       max_bounces=spec["bounces"], verbose=False, mesh=mesh,
                       group=make_ppm_mesh(device.type).get_group("pp"),
                       shard_photon_map=spec["shard"])


def _same_on_every_rank(img) -> bool:
    imgs = [None] * dist.get_world_size()
    dist.all_gather_object(imgs, img)
    return all(torch.equal(x, imgs[0]) for x in imgs)


def render_pt(device, specs) -> list:
    """Each spec's image (on the CPU) and segments from sharded_pt."""
    out = []
    for spec in specs:
        img, segments = sharded_pt(device, spec)()
        img = img.cpu()
        out.append(dict(img=img, segments=segments,
                        same_on_every_rank=_same_on_every_rank(img)))
    return out


def render_ppm(device, specs) -> list:
    """Each spec's image sum (on the CPU) and photon map lengths from
    ppm_renderer, and every rank's deposit rows."""
    out = []
    for spec in specs:
        rend = ppm_renderer(device, spec)
        img = rend.render().cpu()
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, rend.deposit_rows)
        out.append(dict(img=img, photon_map_lengths=[
            int(n) for n in rend.photon_map_lengths], deposit_rows=rows,
            same_on_every_rank=_same_on_every_rank(img)))
    return out
