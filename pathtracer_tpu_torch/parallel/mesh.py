"""The dp x sp sharded path tracer over torch.distributed.

Port of pathtracer_tpu/parallel/mesh.py (its tiled branch). The ranks form
a (dp, sp) DeviceMesh, rank = dp_index * sp + sp_index (JAX make_mesh's
reshape(dp, sp)):
  - "dp" splits the passes: spp is padded to spp_pad = ceil(spp/dp) * dp
    and dp rank d traces the contiguous block [d * spp_pad/dp, (d+1) *
    spp_pad/dp) of pass ids, skipping the padded ids >= spp (the JAX code
    multiplies them by 0; a skip gives the same sum without 0 * inf);
  - "sp" splits the image: band = ceil(ceil(H/32)/sp) tile rows per rank,
    sp rank s traces tile rows [s * band, (s+1) * band) (a Renderer or
    MeshRenderer over that band; rows past the image are dead lanes);
  - the band sums are all-reduced over "dp", the segments over "dp" then
    "sp", and the bands all-gathered over "sp", stitched and cut to H; only
    then do film.apply_filter and film.finalize run, since the filter
    reads across band edges. Every rank returns the image.

Each lane's result does not depend on its band, so an sp-only split gives
make_render_fn's image bit for bit; a dp split regroups the sum over the
passes (atol 1e-5, the JAX package's test). Each rank keeps its band's
renderer per scene object (integrator.renderer_per_scene). The
mesh scene's bounce 0 goes through the tile kernel over the band's maps,
as the single-device MeshRenderer does (the JAX mesh path walks the BVH
there).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..integrator import TILE, renderer_per_scene
from . import group as G

__all__ = ["make_mesh", "make_sharded_render_fn"]


def make_mesh(dp: int, sp: int, device_type: str) -> DeviceMesh:
    """The (dp, sp) mesh over the initialised group's dp * sp ranks, dims
    named ("dp", "sp")."""
    return init_device_mesh(device_type, (dp, sp),
                            mesh_dim_names=("dp", "sp"))


def make_sharded_render_fn(camera, background, width: int, height: int,
                           spp: int, max_bounces: int, mesh: DeviceMesh,
                           device, scene_mesh=None):
    """render(scene, progress=None) -> (image (H, W, 3) f32 on `device`,
    the same on every rank; segments of the whole image, int), with passes
    over "dp" and bands of tile rows over "sp" of `mesh`. scene_mesh: an
    ops.bvh.MeshBVH on `device` (models.ganesha.build_pt's), rendered by
    MeshRenderer bands. progress, if given, is called with the band's pixel
    count after each of this rank's passes."""
    dp, sp = mesh.size(0), mesh.size(1)
    d, s = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    g_dp, g_sp = mesh.get_group("dp"), mesh.get_group("sp")
    tyn = -(-height // TILE)
    band = -(-tyn // sp)
    per = -(-spp // dp)
    passes = range(d * per, min((d + 1) * per, spp))
    renderer = renderer_per_scene(camera, background, width, height, spp,
                                  max_bounces, device, mesh=scene_mesh,
                                  tile_row0=s * band, band_tile_rows=band)

    def render(scene, progress=None):
        r = renderer(scene)
        sums, segments = r.band_sums(passes, progress)
        G.all_reduce_sum(sums, g_dp)
        G.all_reduce_sum(G.all_reduce_sum(segments, g_dp), g_sp)
        # every band has band * 32 rows: one all_gather, no row counts
        mine = r.band_image(sums)
        bands = [torch.empty_like(mine) for _ in range(sp)]
        dist.all_gather(bands, mine, group=g_sp)
        img = torch.cat(bands)[:height]
        return r.finish(img), int(segments)

    return render
