"""pt_driver.glue_ms_per_image: device ms per traced image of the
operations that are none of the port's hand-written kernels (KERNELS):
the eager PyTorch glue of the driver, its copies and fills."""

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "ms"

# every __global__ function of pathtracer_tpu_torch/csrc, as the profiler
# names them (a substring of the name)
KERNELS = ("fused_bounce_kernel", "intersect_state_kernel", "shade_kernel",
           "compact_kernel", "intersect_spheres_kernel",
           "intersect_tris_kernel", "gather_chunks_items_kernel",
           "gather_chunks_combine_kernel", "gather_flux_kernel",
           "intersect_tile_tris_items_kernel",
           "intersect_tile_tris_combine_kernel", "bvh8_walk_kernel",
           "bvh4_walk_kernel", "intersect_clustered_kernel")


def read(ctx):
    if ctx.profile is None or not ctx.traced_images:
        return None
    seconds, n = ctx.profile.outside(KERNELS)
    return seconds * 1e3 / ctx.traced_images if n else None
