"""The seeded shirley scene of pathtracer_tpu_torch (utils/ocaml_random.py,
models/shirley.generate_sphere_list, sphere_list and build(seed=,
use_manifest=)) on the CPU against the JAX package.

Tolerances, each stated in its test:
  - the OCaml 5 stream under every SEED_VARIANT and the OCaml 4 stream,
    64 draws (raw 64-bit words and floats), the generated sphere lists and
    the manifest rule: EQUAL, since both packages compute them in Python
    integers and doubles;
  - the copy of ocaml_random.py: the same code as its original (equal
    syntax trees, the module docstring aside, which names the original);
  - the seed-7 scene: its Scene arrays, sphere table and material table
    bit for bit, and its tile sphere lists equal, as
    tests/test_torch_scene.py holds seed 42;
  - the seed-7 sphere hierarchy (build_sphere_bvh, which the kernels walk
    at bounces >= 1): every valid sphere in it once, the ground alone
    unconditional, and the plain emulation of the kernels' per-warp walk
    (intersect_culled_plain) equal to intersect_regs on every live lane of
    bounces 1-7 of a 64x64 render: no tolerance, since the card's kernels
    must equal their plain versions, which run intersect_regs;
  - a 96x48 spp=2 8-bounce render of seed 7 through the port's make_render_fn
    (its plain versions) against the JAX make_render_fn (XLA): the bounds
    of tests/test_torch_render.py, segments within 0.1% and image RMSE
    below 2.5e-3 (the golden render's budget), and the mean within 1e-3
    relative (the wavefront test's). A path that an FMA's last bit turns
    onto another sphere changes its pixel's sample outright. Measured:
    22,830 vs 22,832 segments, RMSE 2.03e-3, mean +1.2e-4 relative (seed
    42 at the same size: 23,335 vs 23,325, 1.96e-3)."""

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import integrator as jint
from pathtracer_tpu.integrator import make_render_fn as jmake_render_fn
from pathtracer_tpu.models import shirley as jshirley
from pathtracer_tpu.ops.pallas import shade_kernel as jshk
from pathtracer_tpu.ops.pallas import sphere_kernel as jsk
from pathtracer_tpu.utils import ocaml_random as jrandom
from pathtracer_tpu_torch import integrator
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
from pathtracer_tpu_torch.ops.cuda import shade_kernel as shk
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
from pathtracer_tpu_torch.scene import Scene
from pathtracer_tpu_torch.utils import ocaml_random

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
DRAWS = 64
STREAM_SEEDS = (0, 1, 7, 42, 123)
LIST_SEEDS = (0, 1, 7, 123, 2024, 99999)


def _ocaml5_draws(mod, seed, variant):
    rng = mod.OCaml5Random(seed, variant)
    words = [rng.next_bits64() for _ in range(DRAWS)]
    rng = mod.OCaml5Random(seed, variant)
    return words, [rng.float(1.0) for _ in range(DRAWS)]


def _ocaml4_draws(mod, seed):
    rng = mod.OCaml4Random(seed)
    words = [rng.bits() for _ in range(DRAWS)]
    rng = mod.OCaml4Random(seed)
    return words, [rng.float(1.0) for _ in range(DRAWS)]


@pytest.mark.parametrize("seed", STREAM_SEEDS)
@pytest.mark.parametrize("variant", jrandom._SEED_VARIANTS + ("ocaml4",))
def test_random_streams_equal_jax(seed, variant):
    """The first 64 draws of OCaml5Random under each SEED_VARIANT, and of
    OCaml4Random, equal the JAX module's, word for word and float for
    float; the default variant is the JAX default."""
    if variant == "ocaml4":
        got, want = _ocaml4_draws(ocaml_random, seed), _ocaml4_draws(
            jrandom, seed)
    else:
        got = _ocaml5_draws(ocaml_random, seed, variant)
        want = _ocaml5_draws(jrandom, seed, variant)
        assert (ocaml_random._seed_state([seed], variant)
                == jrandom._seed_state([seed], variant))
    assert got == want
    assert len(set(got[0])) == DRAWS
    assert all(0.0 <= x < 1.0 for x in got[1])
    assert ocaml_random.SEED_VARIANT == jrandom.SEED_VARIANT
    assert ocaml_random._SEED_VARIANTS == jrandom._SEED_VARIANTS


def test_ocaml_random_is_a_copy_of_the_jax_module():
    """The port's ocaml_random.py is the JAX module's code: the two syntax
    trees are equal once the module docstrings are taken out."""
    def body(path):
        tree = ast.parse(open(path).read())
        assert isinstance(tree.body[0].value, ast.Constant)
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert body(ocaml_random.__file__) == body(jrandom.__file__)


@pytest.mark.parametrize("seed", LIST_SEEDS)
def test_generate_sphere_list_equals_jax(seed):
    got = shirley.generate_sphere_list(seed)
    assert got == jshirley.generate_sphere_list(seed)
    assert got[:4] == shirley.generate_sphere_list(42)[:4]
    assert 500 < len(got) <= 4 + 23 * 23


def test_generate_sphere_list_seed42_is_the_manifest():
    with open(os.path.join(ROOT, "scenes", "shirley_seed42.json")) as f:
        manifest = json.load(f)
    assert manifest["seed"] == 42
    assert shirley.generate_sphere_list(42) == manifest["spheres"]
    assert shirley.generate_sphere_list() == manifest["spheres"]


def test_build_follows_the_jax_manifest_rule():
    """The manifest exists, so build(seed=7) renders the seed-42 list in
    both packages (531 spheres); use_manifest=False renders seed 7's own
    (530)."""
    manifest = shirley.sphere_list(42)
    assert shirley.sphere_list(7) == manifest == jshirley.sphere_list(7)
    assert (shirley.sphere_list(7, use_manifest=False)
            == jshirley.sphere_list(7, use_manifest=False)
            == shirley.generate_sphere_list(7) != manifest)
    for kw, n in (({}, 531), ({"use_manifest": False}, 530)):
        scene, _, _ = shirley.build(2.0, CPU, seed=7, **kw)
        jscene, _, _ = jshirley.build(2.0, seed=7, **kw)
        assert int(scene.valid.sum()) == int(np.asarray(jscene.valid).sum()) \
            == n
        assert torch.equal(scene.center, torch.from_numpy(
            np.array(jscene.center)))


def test_sphere_list_writes_a_missing_manifest_as_jax_does(tmp_path,
                                                           monkeypatch):
    """With the manifest missing, sphere_list(seed) generates the seed's
    list and writes it as the manifest, which later calls read, in both
    packages alike; use_manifest=False writes nothing."""
    ours, theirs = tmp_path / "ours" / "m.json", tmp_path / "jax" / "m.json"
    monkeypatch.setattr(shirley, "MANIFEST", str(ours))
    monkeypatch.setattr(jshirley, "_MANIFEST", str(theirs))
    assert shirley.sphere_list(7, use_manifest=False) \
        == shirley.generate_sphere_list(7)
    assert not ours.exists()
    assert shirley.sphere_list(7) == jshirley.sphere_list(7) \
        == shirley.generate_sphere_list(7)
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text()) \
        == {"seed": 7, "spheres": shirley.generate_sphere_list(7)}
    assert shirley.sphere_list(123) == shirley.generate_sphere_list(7)


@pytest.fixture(scope="module")
def seed7():
    """(JAX build, the port's build on the CPU) of seed 7's own list."""
    return (jshirley.build(2.0, seed=7, use_manifest=False),
            shirley.build(2.0, CPU, seed=7, use_manifest=False))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_seed7_tables_bit_equal(seed7):
    """The Scene arrays, the sphere table and the material table of seed 7
    equal the JAX package's bit for bit (530 spheres in S = 536)."""
    (jscene, _, _), (scene, _, _) = seed7
    carried = Scene.from_numpy(
        {f: np.asarray(getattr(jscene, f)) for f in Scene.__dataclass_fields__},
        CPU)
    assert scene.count == 536 and int(scene.valid.sum()) == 530
    for f in Scene.__dataclass_fields__:
        a, b = getattr(carried, f), getattr(scene, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    want = jsk.pack_spheres_pallas(jscene.center, jscene.radius, jscene.valid)
    got = sk.pack_spheres(scene.center, scene.radius, scene.valid)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want = jshk.pack_material_tables(jscene.shade_pack)
    got = shk.pack_material_tables(scene.shade_pack)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("width,height", [(600, 300), (160, 80), (96, 48)])
def test_seed7_tile_sphere_lists_equal(seed7, width, height):
    (jscene, _, _), (scene, _, _) = seed7
    want = jint.tile_sphere_lists(
        jshirley.make_camera(width / height), np.asarray(jscene.center),
        np.asarray(jscene.radius), np.asarray(jscene.valid), width, height)
    got = integrator.tile_sphere_lists(
        shirley.make_camera(width / height), scene.center.numpy(),
        scene.radius.numpy(), scene.valid.numpy(), width, height)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_seed7_sphere_hierarchy_walk_equals_brute_force(seed7):
    """build_sphere_bvh of the seed-7 table holds each valid sphere once
    (the ground alone unconditional, groups of <= GROUP_LEAVES leaves of
    <= SPHERE_LEAF spheres), and its per-warp walk finds intersect_regs'
    hit on every live lane of bounces 1-7 of pass 0 of a 64x64 render."""
    _, (scene, cam, bg) = seed7
    r = integrator.Renderer(scene, shirley.make_camera(1.0), bg, 64, 64, 1,
                            8, CPU)
    hier = sk.build_sphere_bvh(r.sph_table)
    order = hier.order.numpy()
    valid = np.nonzero(scene.valid.numpy())[0]
    assert sorted(order.tolist()) == valid.tolist()
    assert hier.n_uncond == 1 and order[0] == int(np.argmax(
        scene.radius.numpy() * scene.valid.numpy()))
    links = hier.links.numpy()
    assert all(0 < n <= sk.GROUP_LEAVES for _, n, _, _ in
               links[:hier.n_groups])
    assert all(0 < n <= sk.SPHERE_LEAF for _, n, _, _ in
               links[hier.n_groups:])
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], 128)
    for b in range(8):
        if b > 0:
            comps = [state[c].reshape(-1) for c in range(6)]
            alive = state[9].reshape(-1) > 0.0
            assert int(alive.sum()) > 0
            at, idx, _ = sk.intersect_culled_plain(
                r.sph_table, hier, *comps, alive, origin_zero=False)
            want_at, want_idx = sk.intersect_regs(r.sph_table, *comps,
                                                  origin_zero=False)
            assert torch.equal(at[alive], want_at[alive]), b
            assert torch.equal(idx[alive], want_idx[alive]), b
        state, rad = fbk.fused_bounce_plain(
            r.sph_table, state, r.pack_table, off,
            r.sampler.limbs(2 + 2 * b, 3 + 2 * b), bg[1], rad,
            bg_mode=bg[0], origin_zero=b == 0,
            block_lists=(r.lists, r.counts) if b == 0 else None)


def test_seed7_render_matches_jax_render(seed7):
    """96x48, spp 2, 8 bounces: the port's make_render_fn on the CPU (tile
    lists, listed bounce 0, compaction at bounce 3, film) against the JAX
    make_render_fn; a second render of the same scene object gives the
    same image."""
    (jscene, jcam, jbg), (scene, cam, bg) = seed7
    w, h = 96, 48  # the fixture's aspect, 2.0
    want, want_segs = jmake_render_fn(jcam, jbg, w, h, 2, 8,
                                      dtype=jnp.float32)(jscene)
    want, want_segs = np.asarray(want, np.float64), int(want_segs)
    render = integrator.make_render_fn(cam, bg, w, h, 2, 8, CPU)
    img, segs = render(scene)
    img = img.numpy().astype(np.float64)
    assert img.shape == want.shape == (h, w, 3) and np.isfinite(img).all()
    assert abs(segs - want_segs) <= 1e-3 * want_segs, (segs, want_segs)
    rmse = float(np.sqrt(np.mean((img - want) ** 2)))
    assert rmse < 2.5e-3, rmse
    assert abs(img.mean() / want.mean() - 1) < 1e-3, (img.mean(),
                                                        want.mean())
    again, segs_again = render(scene)
    assert segs_again == segs and np.array_equal(again.numpy(), img)
