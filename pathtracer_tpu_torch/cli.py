"""Command-line harness: `python -m pathtracer_tpu_torch <command> [args]`.

Port of pathtracer_tpu/cli.py for shirley-spheres, cornell-box, ganesha
and ply-describe.
shirley-spheres takes the JAX CLI's render flags (add_render_args) plus
--device, default cuda. Without a CUDA device it raises unless `--device
cpu` is given. --interpreter (the A/B oracle) renders with the kernels'
plain PyTorch versions, which run on CPU tensors only, so it means `--device
cpu` and is refused with any other device. The progress-bar run and the
--no-progress run go through the same make_render_fn.

cornell-box and ganesha take the JAX CLI's PPM flags (add_ppm_args, both
-flag and --flag spellings) plus --device, with the same CUDA rule; the CPU
renders with the plain versions. ganesha adds -ganesha-ply and
-stop-after-bvh and prints the mesh's build statistics as the JAX CLI does;
the BVH is built on the host (native/, g++). ply-describe prints a PLY
file's header and columns.

Under torchrun (WORLD_SIZE set) cornell-box and ganesha render on the
group of its processes (parallel.group.init: NCCL on cuda:LOCAL_RANK, or
gloo with -device cpu), with PPMRenderer's photon map as
-shard-photon-map picks it: absent, the replicated map; bare or 'host',
per-rank sub-grids (shard_photon_map=True); 'ring', the ring
(parallel/ppm_ring.py). Rank 0 alone prints and writes. Without torchrun
there is one process and no group, and the flag changes nothing.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def _parse_dimension(s: str):
    try:
        w, h = s.split(",")
        return int(w), int(h)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected WIDTH,HEIGHT, got {s!r}")


def _require_cuda_if_asked(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to render on "
                           "the CPU with the kernels' plain versions")


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
    _require_cuda_if_asked(device)

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


def add_ppm_args(p: argparse.ArgumentParser) -> None:
    """The PPM scenes' flags; both -flag and --flag spellings."""
    p.add_argument("-width", "--width", type=int, default=600, metavar="INT",
                   help="image width")
    p.add_argument("-height", "--height", type=int, default=600, metavar="INT",
                   help="image height")
    p.add_argument("-iterations", "--iterations", type=int, default=10,
                   metavar="INT", help="# photon-map iterations")
    p.add_argument("-photon-count", "--photon-count", type=int, default=75000,
                   metavar="INT", help="#photons per iteration")
    p.add_argument("-alpha", "--alpha", type=float, default=2.0 / 3.0,
                   metavar="FLOAT", help="photon-map alpha in (0,1)")
    p.add_argument("-o", "--output", default="output.png", metavar="FILE",
                   help="output file")
    p.add_argument("-no-progress", "--no-progress", action="store_true",
                   help="suppress progress monitor")
    p.add_argument("-max-bounces", "--max-bounces", type=int, default=4,
                   metavar="INT", help="max ray bounces")
    p.add_argument("-checkpoint", "--checkpoint", metavar="FILE", default=None,
                   help="save/resume iteration state (img_sum + counter) "
                        "to FILE every iteration")
    p.add_argument("-device", "--device", default="cuda",
                   help="torch device to render on (default cuda; cpu "
                        "renders with the kernels' plain versions)")
    p.add_argument("-shard-photon-map", "--shard-photon-map", nargs="?",
                   const="host", default=None, choices=("host", "ring"),
                   help="multi-process (torchrun): keep each rank's photons "
                        "in its own sub-grid (photon-map memory per device "
                        "scales 1/n). 'host' (the default when given bare) "
                        "gathers every band's partial flux on every rank; "
                        "'ring' passes the sub-grids round the ranks")


def _shard_mode(args):
    """The flag as PPMRenderer.shard_photon_map: absent -> False (the
    replicated map), bare or 'host' -> True, 'ring' -> 'ring'."""
    if args.shard_photon_map is None:
        return False
    return "ring" if args.shard_photon_map == "ring" else True


def _ppm_group(device: torch.device):
    """(device, the "pp" group, lead) of this process: under torchrun the
    group of its processes on cuda:LOCAL_RANK (NCCL) or the CPU (gloo),
    else (device, None, True)."""
    if "WORLD_SIZE" not in os.environ:
        return device, None, True
    import torch.distributed as dist

    from .parallel import group
    from .parallel.ppm_ring import make_ppm_mesh
    device = group.init(device.type)
    if dist.get_rank() == 0:
        print(f"backend = {dist.get_backend()}, world = "
              f"{dist.get_world_size()}", flush=True)
    return (device, make_ppm_mesh(device.type).get_group("pp"),
            dist.get_rank() == 0)


def _leave(group) -> None:
    if group is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


def run_cornell(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "cornell-box", description="Render the Cornell box by progressive "
        "photon mapping.")
    add_ppm_args(parser)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _require_cuda_if_asked(device)
    device, group, lead = _ppm_group(device)

    from .models import cornell
    from .ppm import PPMRenderer

    t0 = time.monotonic()
    scene, cam, lights = cornell.build(args.width / args.height, device)
    renderer = PPMRenderer(scene, cam, lights, args.width, args.height,
                           iterations=args.iterations,
                           photon_count=args.photon_count, alpha=args.alpha,
                           max_bounces=args.max_bounces,
                           verbose=not args.no_progress, group=group,
                           shard_photon_map=_shard_mode(args))
    renderer.render(output=args.output, checkpoint_path=args.checkpoint)
    if lead:
        print(f"render time = {(time.monotonic() - t0) * 1e3:.3f} ms")
    _leave(group)


def run_ganesha(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "ganesha", description="Render a PLY mesh (ganesha) by progressive "
        "photon mapping.")
    add_ppm_args(parser)
    parser.add_argument("-ganesha-ply", "--ganesha-ply", default="ganesha.ply",
                        metavar="FILE", help="path to ganesha.ply")
    parser.add_argument("-stop-after-bvh", "--stop-after-bvh",
                        action="store_true", help="stop after BVH build")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _require_cuda_if_asked(device)
    device, group, lead = _ppm_group(device)
    out = print if lead else (lambda *a, **k: None)

    from .models import ganesha
    from .ppm import PPMRenderer

    out(f"dim = {args.width} x {args.height};")
    t_total = time.monotonic()
    t0 = time.monotonic()
    scene, cam, lights, mesh = ganesha.build(
        args.ganesha_ply, args.width / args.height, device)
    build_ms = (time.monotonic() - t0) * 1e3
    out(f"#triangles = {mesh.n_tris}")
    out(f"tree depth = {mesh.depth}")
    out(f"build time = {build_ms:.3f} ms")
    bvh_bytes = (mesh.meta_np.nbytes + 2 * mesh.meta_np.shape[0] * 12
                 + 3 * mesh.n_tris * 12)
    out(f"bvh bytes = {bvh_bytes}  "
        f"(the reference prints Obj.reachable_words here)")
    hist = mesh.leaf_histogram()
    out("leaf lengths =")
    out(" ".join(f"((size {s})(count {c}))" for s, c in hist.items()))
    if args.stop_after_bvh:
        out("Stop after bvh build")
        _leave(group)
        return
    lo, hi = mesh.bbox_lo, mesh.bbox_hi
    out(f"ganesha bbox = ((min({lo[0]:.6g} {lo[1]:.6g} {lo[2]:.6g}))"
        f"(max({hi[0]:.6g} {hi[1]:.6g} {hi[2]:.6g})))")
    renderer = PPMRenderer(scene, cam, lights, args.width, args.height,
                           iterations=args.iterations,
                           photon_count=args.photon_count, alpha=args.alpha,
                           max_bounces=args.max_bounces,
                           verbose=not args.no_progress, mesh=mesh,
                           group=group, shard_photon_map=_shard_mode(args))
    renderer.render(output=args.output, checkpoint_path=args.checkpoint)
    out(f"elapsed ms: {(time.monotonic() - t_total) * 1e3:.3f}")
    _leave(group)


def run_ply_describe(argv=None) -> None:
    """PLY inspection tool: the format, each element's properties, and per
    column its range (or the face-size histogram of a list column)."""
    parser = argparse.ArgumentParser("ply_describe",
                                     description="Describe a PLY file.")
    parser.add_argument("file", help="PLY file path")
    args = parser.parse_args(argv)

    import numpy as np

    from .io import ply

    t0 = time.monotonic()
    p = ply.load(args.file)
    parse_ms = (time.monotonic() - t0) * 1e3
    print(f"format = {p.fmt}")
    for el in p.elements:
        print(f"element {el.name} (count {el.count})")
        for pr in el.properties:
            if pr.is_list:
                print(f"  property list {pr.length_dtype} {pr.elt_dtype} "
                      f"{pr.name}")
            else:
                print(f"  property {pr.dtype} {pr.name}")
    for el, cols in p.data.items():
        for name, col in cols.items():
            if isinstance(col, list):
                lens = {}
                for row in col:
                    lens[len(row)] = lens.get(len(row), 0) + 1
                print(f"{el}.{name}: rows, face-size histogram = {lens}")
            elif col.ndim == 2:
                lens = {col.shape[1]: col.shape[0]}
                print(f"{el}.{name}: rows, face-size histogram = {lens}")
            elif np.issubdtype(col.dtype, np.floating):
                finite = np.isfinite(col).all()
                print(f"{el}.{name}: float min={col.min():.6g} "
                      f"max={col.max():.6g} all-finite={finite}")
            else:
                print(f"{el}.{name}: int min={col.min()} max={col.max()}")
    print(f"parse time = {parse_ms:.3f} ms")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {
        "shirley-spheres": run_shirley,
        "shirley_spheres": run_shirley,
        "cornell-box": run_cornell,
        "cornell_box": run_cornell,
        "ganesha": run_ganesha,
        "ply-describe": run_ply_describe,
        "ply_describe": run_ply_describe,
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
