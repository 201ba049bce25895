"""ppm_driver.glue_ms_per_image: device ms per traced image of the photon
mapper's operations that are none of the port's hand-written kernels: the
eager PyTorch glue of the PPM driver, its copies and fills. The reading is
pt_driver.glue_ms_per_image's (its KERNELS, every __global__ function of
the port), read by that reader."""

from port_bench import spec

LAYER = "PPM driver"
MOVES = "image_s"
UNIT = "ms"


def read(ctx):
    return spec.load_metric("pt_driver.glue_ms_per_image").read(ctx)
