"""The run itself at a tiny size on the CPU, through the port's plain
versions (a test-only traffic override, not a cell file): the result
line, the comparison, the control and the faults it has to catch, the
import isolation, and the command's refusal without a card."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench import compare, harness, isolation, spec

SEED = 2_718_281_829
TINY = dict(width=48, height=24, spp=4, max_bounces=3, warmup_images=1,
            trace_images=1, gap_images=1)


def tiny(name: str, **kw) -> dict:
    c = spec.cell(name)
    c["traffic_spec"] = dict(c["traffic_spec"], **dict(TINY, **kw))
    return c


def run(c, trace=False, seconds=0.3):
    return harness.run_cell(c, SEED, seconds, trace, "cpu",
                            time.perf_counter())


def test_sound_run_is_correct_and_its_line_has_the_contract_keys():
    c = tiny("shirley-readme")
    out = run(c)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in c["end_to_end"]}
    for m in c["end_to_end"]:
        assert out["metrics"][m["name"]]["unit"] == m["unit"]
        assert out["metrics"][m["name"]]["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(compare.NUMBERS)
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]
    json.loads(json.dumps(out))


def test_traced_run_reports_per_layer_metrics_only():
    c = tiny("shirley-readme")
    out = run(c, trace=True, seconds=2.0)
    assert out["correct"] is True and out["attempted"] >= 3
    names = {m["name"] for m in c["per_layer"]}
    assert set(out["metrics"]) <= names
    # a CPU run reads host clocks only: no device metric is reported
    assert set(out["metrics"]) == {"build.scene_s"}
    assert "breakdown" in out and out["device"]["busy_s"] == 0.0
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("name", ["shirley-readme", "ganesha-pt"])
def test_control_in_bfloat16_is_not_correct(name):
    c = tiny(name, width=24, height=24, spp=2) if name == "ganesha-pt" \
        else tiny(name)
    from port_bench import readings
    from port_bench.entries import pt
    inputs = pt.Inputs(c["config_spec"], c["traffic_spec"], SEED)
    dtype = readings.CONTROL[c["config_spec"]["precision"]]
    assert dtype == torch.bfloat16
    ref = inputs.reference("cpu")
    ctl = inputs.reference("cpu", dtype, max_walk_steps=5000)
    _, failed = compare.judge([compare.image_numbers(*ctl, *ref)],
                              c["limits"])
    assert failed == 1


def _patch_render(monkeypatch, wrap):
    import pathtracer_tpu_torch.integrator as integ
    real = integ.make_render_fn
    monkeypatch.setattr(integ, "make_render_fn",
                        lambda *a, **k: wrap(real(*a, **k)))


def _unchanged(render):
    """The film is never written: the state it starts from comes back."""
    return lambda scene: (torch.zeros_like(render(scene)[0]),
                          render(scene)[1])


def _altered(render):
    """Each image has its red and blue swapped where it is made."""
    def f(scene):
        img, segs = render(scene)
        return img[..., [2, 1, 0]], segs
    return f


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_are_not_correct(monkeypatch, fault):
    if fault == "half":
        import pathtracer_tpu_torch.integrator as integ
        from pathtracer_tpu_torch import film

        def forward(self, progress=None):
            # half of the passes left out, the mean taken over the rest
            half = self.spp // 2
            sums, segments = self.band_sums(range(half))
            img = film.finalize(film.apply_filter(self.untile(sums),
                                                  self.kern2d), half)
            return img, int(segments)
        monkeypatch.setattr(integ.Renderer, "forward", forward)
    else:
        _patch_render(monkeypatch, {"unchanged": _unchanged,
                                    "altered": _altered}[fault])
    out = run(tiny("shirley-readme"))
    assert out["correct"] is False and out["failed"] >= 1


def test_mesh_cell_runs_on_a_tiny_image():
    c = tiny("ganesha-pt", width=16, height=16, spp=1, max_bounces=2)
    out = run(c, seconds=0.1)
    assert out["correct"] is True
    assert out["checks"]["segments_gap"]["value"] <= \
        c["limits"]["segments_gap"]


def test_forbidden_names_are_compared_whole():
    mods = ["pathtracer_tpu_torch", "pathtracer_tpu_torch.ops", "numpy",
            "jaxtyping", "flaxen"]
    assert isolation.forbidden_loaded(mods) == []
    assert isolation.forbidden_loaded(mods + ["pathtracer_tpu.ops",
                                              "jax"]) == [
        "jax", "pathtracer_tpu.ops"]


def _modules_after(code: str) -> list:
    res = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_reference_loads_neither_jax_nor_the_program():
    mods = _modules_after("import port_bench.reference.pt\n"
                          "import port_bench.reference.scenes\n"
                          "import port_bench.compare")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & (isolation.FORBIDDEN | {"pathtracer_tpu_torch"})


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "import time\nfrom port_bench import spec, harness\n"
        "c = spec.cell('shirley-readme')\n"
        f"c['traffic_spec'] = dict(c['traffic_spec'], **{TINY!r})\n"
        "harness.run_cell(c, 5, 0.1, False, 'cpu', time.perf_counter())")
    assert isolation.forbidden_loaded(mods) == []
    assert "pathtracer_tpu_torch" in mods


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "shirley-readme", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout


def test_yaw_and_mesh_file_round_trip(tmp_path):
    from port_bench import meshes
    assert meshes.yaw_angle(0) == 0.0
    verts = np.array([[0, 0, 0], [2, 1, 0], [0, 1, 4]], np.float32)
    faces = np.array([[0, 1, 2]])
    assert np.array_equal(meshes.yawed(verts, 0), verts)
    turned = meshes.yawed(verts, 12345)
    assert np.allclose(turned[:, 1], verts[:, 1])
    assert not np.allclose(turned, verts)
    path = str(tmp_path / "m.ply")
    meshes.write_ply(path, turned, faces)
    v2, f2 = meshes.read_ply(path)
    assert np.array_equal(v2, turned) and np.array_equal(f2, faces)
    from pathtracer_tpu_torch.io import ply  # the program reads it alike
    p = ply.load(path)
    assert np.array_equal(np.stack([p.data["vertex"][k] for k in "xyz"], 1),
                          turned)
