"""ppm_driver.ops_per_image: device operations (kernels, copies, fills)
per traced image of the photon mapper, from the profiler's trace: the
host's dispatch load of the PPM driver. The count is pt_driver.
ops_per_image's, read by that reader."""

from port_bench import spec

LAYER = "PPM driver"
MOVES = "image_s"
UNIT = "ops/image"


def read(ctx):
    return spec.load_metric("pt_driver.ops_per_image").read(ctx)
