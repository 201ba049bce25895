"""Command-line harness: `python -m pathtracer_tpu_torch <command> [args]`.

Port of pathtracer_tpu/cli.py for the path-traced scene. shirley-spheres
takes the JAX CLI's render flags (add_render_args) plus --device, default
cuda. Without a CUDA device it raises unless `--device cpu` is given.
--interpreter (the A/B oracle) renders with the kernels' plain PyTorch
versions, which run on CPU tensors only, so it means `--device cpu` and is
refused with any other device. The progress-bar run and the --no-progress
run go through the same make_render_fn. The photon-mapped scenes and the
PLY tool are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def _parse_dimension(s: str):
    try:
        w, h = s.split(",")
        return int(w), int(h)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected WIDTH,HEIGHT, got {s!r}")


def add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-d", "--dimension", type=_parse_dimension, required=True,
                   metavar="WIDTH,HEIGHT", help="image dimensions")
    p.add_argument("--samples-per-pixel", type=int, default=1, metavar="INT",
                   help="trace INT camera rays per pixel")
    p.add_argument("-o", "--output", default="output.png", metavar="PATH",
                   help="write image to PATH")
    p.add_argument("--no-progress", action="store_true",
                   help="suppress progress bar")
    p.add_argument("--max-ray-bounces", type=int, default=8, metavar="INT",
                   help="max ray bounces")
    p.add_argument("--interpreter", action="store_true",
                   help="render on the CPU with the kernels' plain PyTorch "
                        "versions (the A/B oracle; implies --device cpu)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the render to DIR")
    p.add_argument("--device", default=None,
                   help="torch device to render on (default cuda, or cpu "
                        "with --interpreter)")


def run_shirley(argv=None) -> None:
    parser = argparse.ArgumentParser("shirley_spheres",
                                     description="Render Shirley spheres.")
    add_render_args(parser)
    args = parser.parse_args(argv)
    width, height = args.dimension
    device = torch.device(args.device
                          or ("cpu" if args.interpreter else "cuda"))
    if args.interpreter and device.type != "cpu":
        parser.error("--interpreter runs the kernels' plain versions, which "
                     f"take CPU tensors; it cannot render on {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to render on "
                           "the CPU with the kernels' plain versions")

    from .models import shirley
    from .integrator import make_render_fn
    from .io.png import write_png
    from .utils.progress import ProgressBar

    t0 = time.monotonic()
    scene, cam, background = shirley.build(width / height, device)
    build_ms = (time.monotonic() - t0) * 1e3
    print(f"dim = {width} x {height};")
    print(f"#spheres = {int(scene.valid.sum())}")
    print(f"build time = {build_ms:.3f} ms")

    render = make_render_fn(cam, background, width, height,
                            args.samples_per_pixel, args.max_ray_bounces,
                            device)
    bar = None if args.no_progress else ProgressBar(
        width * height * args.samples_per_pixel)
    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                args.profile))
        prof.start()
    t0 = time.monotonic()
    img, _segs = render(scene, progress=None if bar is None else bar.update)
    img = img.cpu().numpy()
    elapsed_ms = (time.monotonic() - t0) * 1e3
    if prof is not None:
        prof.stop()
    if bar is not None:
        bar.close()
    write_png(args.output, img)
    print(f"rendered in: {elapsed_ms:.3f} ms")


def _not_ported(name: str):
    def run(argv=None) -> None:
        print(f"{name}: not ported to pathtracer_tpu_torch yet; use "
              f"`python -m pathtracer_tpu {name}`", file=sys.stderr)
        sys.exit(2)
    return run


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {
        "shirley-spheres": run_shirley,
        "shirley_spheres": run_shirley,
        "cornell-box": _not_ported("cornell-box"),
        "cornell_box": _not_ported("cornell-box"),
        "ganesha": _not_ported("ganesha"),
        "ply-describe": _not_ported("ply-describe"),
        "ply_describe": _not_ported("ply-describe"),
    }
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m pathtracer_tpu_torch <command> [args]\n"
              f"commands: {', '.join(sorted(set(commands)))}")
        return
    cmd = argv[0]
    if cmd not in commands:
        print(f"unknown command {cmd!r}; available: {sorted(set(commands))}",
              file=sys.stderr)
        sys.exit(2)
    commands[cmd](argv[1:])


if __name__ == "__main__":
    main()
