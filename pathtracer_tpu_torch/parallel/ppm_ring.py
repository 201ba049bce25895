"""The ring photon map's eye pass over torch.distributed.

Port of pathtracer_tpu/parallel/ppm_ring.py. Rank k of the ("pp",) group
owns band k of the image (ceil(H/n) rows, rounded up to 32 with the tile
kernel; bands past the image are all dead) and the sub-grid that
build_photon_chunks makes of its own photon deposits. Its eye pass walks
its band once, gathers the flux against its own sub-grid, then passes the
sub-grids one hop round the ring n - 1 times (rank k sends to k + 1 and
receives from k - 1, group.ring_shift), adding each arriving sub-grid's
gather in arrival order. The order per lane is fixed, so the image is
reproducible; it differs from the replicated map's by the flux sum's
association only. The photon map's memory per rank stays 1/n.

The sub-grids' shapes agree on every rank without a size exchange: every
rank traces the same lane count (ppm.rank_lane_range; a rank past the
photons traces only dead lanes), so its deposits have the same rows, and
build_photon_chunks' shapes depend on the rows alone. That is the JAX
package's pad_deposits, made by construction.

PPMRenderer(shard_photon_map="ring") drives it; the photon trace and the
sub-grid build are the renderer's, per rank.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import group as G

__all__ = ["make_ppm_mesh", "ring_eye_pass"]


def make_ppm_mesh(device_type: str) -> DeviceMesh:
    """The 1-D photon-parallel mesh over every rank of the initialised
    group, dim named "pp"."""
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("pp",))


def ring_eye_pass(eye_pass, offset_base: int, radius: float, grid, group):
    """This rank's band through eye_pass (ppm.make_eye_pass over the band)
    with the flux of every rank's sub-grid: grid = (photons_t, sbox) of
    this rank's deposits; the others arrive round the ring. Returns the
    band's image rows, as eye_pass does."""
    n = dist.get_world_size(group)
    fd_pt, fd_nrm, fd_beta, fd_ok = eye_pass.walk(offset_base)
    flux = eye_pass.gather(fd_pt, fd_nrm, fd_ok, radius, grid)
    for _ in range(n - 1):
        grid = tuple(G.ring_shift(grid, group))
        flux = flux + eye_pass.gather(fd_pt, fd_nrm, fd_ok, radius, grid)
    return eye_pass.finish(fd_beta, fd_ok, flux, radius)
