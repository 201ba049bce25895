"""Port parity for the slice as a whole: the kernel wavefront, the render
driver, the film and the CLI of pathtracer_tpu_torch (its plain versions, on
the CPU) against the JAX package, and the port's freedom from JAX.

Tolerances, and why:
  - trace_wavefront vs _trace_pallas2 (interpret mode), 64x64, 6 bounces,
    with lane compaction at bounce 3: the per-bounce FMA differences of
    test_torch_fused_bounce.py compound over bounces, and a lane whose path
    flips (another sphere or another alive flag) changes its pixel
    outright. Held: segment counts within 0.1%, at most 1% of pixels off by
    more than 1e-3, and the mean radiance within 1e-3 relative. Measured
    on this wavefront: 10,734 vs 10,729 segments, 9 of 4,096 pixels off,
    mean radiance -6.0e-4 relative.
  - the 160x80 spp=4 b=8 render against the committed float64 golden: the
    budget of tests/test_golden.py (RMSE < 2.5e-3, segments within 100;
    measured 1.67e-3 and 128,041 vs 127,980).
  - apply_filter / finalize: float32 convolution sums in another order,
    1e-6 relative."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu import film as jfilm
from pathtracer_tpu.integrator import _trace_pallas2
from pathtracer_tpu.io.png import read_png
from pathtracer_tpu.models import shirley as jshirley
from pathtracer_tpu.ops.lds import Sampler as JSampler
from pathtracer_tpu_torch import cli, film, integrator
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import shade_kernel as tshk
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as tsk
from pathtracer_tpu_torch.ops.lds import Sampler

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")


def test_trace_wavefront_matches_pallas():
    W = H = 64
    B = 6
    jscene, cam, background = jshirley.build(W / H)
    jsampler = JSampler(2 + 2 * B)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    offset = jnp.asarray((ys * W + xs).reshape(-1).astype(np.uint32))
    cx = (jnp.asarray(xs.reshape(-1), jnp.float32)
          + jsampler.get(offset, 0)) / W
    cy = 1.0 - (jnp.asarray(ys.reshape(-1), jnp.float32)
                + jsampler.get(offset, 1)) / H
    d = cam.ray_dirs(cx, cy, jnp.float32).reshape(-1, 3)
    want_rad, want_segs = _trace_pallas2(jscene, jsampler, jnp.zeros_like(d),
                                         d, offset, B, background, None,
                                         interpret=True)
    want_rad = np.asarray(want_rad)

    scene, _, bg = shirley.build(W / H, CPU)
    d_t = torch.from_numpy(np.array(d))
    state = integrator.initial_state(d_t, torch.ones(W * H, dtype=torch.bool))
    off = torch.from_numpy(np.array(offset).view(np.int32)).reshape(-1, 128)
    rad, segs = integrator.trace_wavefront(
        tsk.pack_spheres(scene.center, scene.radius, scene.valid),
        tshk.pack_material_tables(scene.shade_pack), state, off,
        Sampler(2 + 2 * B), B, bg, origin_zero=False)
    got = rad.reshape(3, -1).T.numpy()

    segs, want_segs = int(segs), int(want_segs)
    assert abs(segs - want_segs) <= 1e-3 * want_segs, (segs, want_segs)
    bad = (np.abs(got - want_rad) > 1e-3).any(axis=1)
    assert bad.mean() <= 0.01, (bad.sum(), np.abs(got - want_rad).max())
    assert abs(got.mean() / want_rad.mean() - 1) < 1e-3, (got.mean(),
                                                           want_rad.mean())


def test_render_matches_f64_golden():
    """The whole port (tile lists, listed bounce 0, compaction at bounce 3,
    pass loop, film) on the CPU against the committed float64 render."""
    g = np.load(os.path.join(ROOT, "scenes", "golden_shirley_160x80_spp4.npz"))
    scene, cam, bg = shirley.build(2.0, CPU)
    render = integrator.make_render_fn(cam, bg, 160, 80, 4, 8, CPU)
    calls = []
    img, segs = render(scene, progress=calls.append)
    assert calls == [160 * 80] * 4
    img = img.numpy()
    assert img.shape == (80, 160, 3) and np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((img.astype(np.float64) - g["img"]) ** 2)))
    assert rmse < 2.5e-3, rmse
    assert abs(segs - int(g["segments"])) < 100, (segs, int(g["segments"]))


@pytest.mark.parametrize("order,radius", [(5, 1), (3, 1), (7, 2)])
def test_film_matches_jax(order, radius):
    np.testing.assert_array_equal(film.binomial_kernel_2d(order, radius),
                                  jfilm.binomial_kernel_2d(order, radius))
    rng = np.random.default_rng(order)
    sums = (rng.random((37, 53, 3)) * 8).astype(np.float32)
    k = jfilm.binomial_kernel_2d(order, radius)
    want = np.asarray(jfilm.finalize(jfilm.apply_filter(jnp.asarray(sums), k),
                                     8))
    got = film.finalize(film.apply_filter(torch.from_numpy(sums),
                                          torch.from_numpy(k.astype(
                                              np.float32))), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_cli_writes_png_on_cpu(tmp_path, capsys):
    out = tmp_path / "shirley.png"
    prof = tmp_path / "trace"
    cli.main(["shirley-spheres", "--dimension=64,32", "--samples-per-pixel=2",
              "--max-ray-bounces=3", "--device", "cpu", "-o", str(out),
              "--profile", str(prof)])
    img = read_png(str(out))
    assert img.shape == (32, 64, 3)
    assert img.std() > 0
    text = capsys.readouterr().out
    assert "#spheres = 531" in text and "rendered in:" in text
    assert any(p.name.endswith(".json") for p in prof.iterdir())


def test_cli_interpreter_renders_on_cpu_only(tmp_path):
    """--interpreter means the plain versions, which take CPU tensors: it
    renders on the CPU by default and refuses any other device."""
    out = tmp_path / "shirley.png"
    cli.main(["shirley-spheres", "--dimension=32,32", "--samples-per-pixel=1",
              "--max-ray-bounces=2", "--no-progress", "--interpreter",
              "-o", str(out)])
    assert read_png(str(out)).shape == (32, 32, 3)
    with pytest.raises(SystemExit) as e:
        cli.main(["shirley-spheres", "--dimension=32,32", "--interpreter",
                  "--device", "cuda", "-o", str(out)])
    assert e.value.code != 0


def test_cli_refuses_missing_cuda_and_unported_scenes():
    """Without a card every render command asks for --device cpu; every
    scene of the JAX CLI is ported now, and ply-describe refuses a missing
    file argument."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["shirley-spheres", "--dimension=64,32"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["cornell-box", "-width", "32", "-height", "32"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["ganesha", "-ganesha-ply", "scenes/test_ganesha.ply"])
    with pytest.raises(SystemExit) as e:
        cli.main(["ply-describe"])
    assert e.value.code != 0


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor the JAX package.
    Checked in a fresh interpreter, since this process has jax loaded, by
    importing every module of the port."""
    code = ("import importlib, pkgutil, sys\n"
            "import pathtracer_tpu_torch as pkg\n"
            "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "'pathtracer_tpu_torch.')]\n"
            "assert 'pathtracer_tpu_torch.ops.cuda.gather_kernel' in mods\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'pathtracer_tpu.')) or m == 'pathtracer_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.abspath(ROOT), timeout=120)
    src = []
    pkg = os.path.join(ROOT, "pathtracer_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        src += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    src.append(os.path.join(ROOT, "chip_smoke.py"))
    for path in src:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    mod = words[1].split(".")[0]
                    assert mod not in ("jax", "jaxlib", "pathtracer_tpu"), (
                        path, line)
