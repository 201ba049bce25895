"""BENCHMARK.json and the files it names: the contract's shape, and that a
new cell or metric is found by its files alone."""

import json
import os
import re
import shutil

import pytest

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("port_bench/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            config = json.load(f)
        assert (config["source"], config["reduced"]) == (c["source"],
                                                         c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25
               for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_and_reports_enough(cell):
    c = spec.cell(cell)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
    assert set(c["limits"]) == {"image_rmse", "segments_gap", "nonfinite_px"}
    assert c["limits"]["nonfinite_px"] == 0


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_files_agree_with_benchmark(metric):
    mod = spec.load_metric(metric)
    row = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert (mod.LAYER, mod.MOVES, mod.UNIT) == (row["layer"], row["moves"],
                                                row["unit"])
    assert callable(mod.read)


def test_new_cell_and_metric_found_by_their_files(tmp_path):
    """A later cell, traffic mix and metric are new files and new entries;
    no existing file changes."""
    here = tmp_path / "port_bench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    (here / "traffic" / "tiny.json").write_text(json.dumps(
        {"entry": "pt", "width": 32, "height": 16, "spp": 1,
         "max_bounces": 2}))
    (here / "limits" / "shirley-tiny.json").write_text(json.dumps(
        {"image_rmse": 0.5, "segments_gap": 0.5, "nonfinite_px": 0}))
    (here / "metrics" / "device.busy_ms.py").write_text(
        'LAYER = "device"\nMOVES = "image_s"\nUNIT = "ms"\n\n\n'
        "def read(ctx):\n    return 1e3 * ctx.profile.busy_s\n")
    bench["workloads"].append({"name": "shirley-tiny", "config": "shirley",
                               "traffic": "tiny", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "device.busy_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "image_s",
                               "workloads": ["shirley-tiny"]})
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()
              and p.name not in ("tiny.json", "shirley-tiny.json",
                                 "device.busy_ms.py")}
    c = spec.cell("shirley-tiny", bench, str(here))
    assert c["traffic_spec"]["width"] == 32
    assert "device.busy_ms" in [m["name"] for m in c["per_layer"]]
    assert "device.busy_ms" not in [
        m["name"] for m in spec.cell("shirley-readme", bench,
                                     str(here))["per_layer"]]
    mod = spec.load_metric("device.busy_ms", str(here))
    assert mod.MOVES == "image_s"
    assert all(p.read_bytes() == b for p, b in before.items())


class _Reads(dict):
    """A configuration that records the path of every field read."""

    def __init__(self, data, seen, path=""):
        super().__init__(data)
        self._seen, self._path = seen, path

    def _wrap(self, key, value):
        path = f"{self._path}{key}"
        self._seen.add(path)
        if isinstance(value, dict):
            return _Reads(value, self._seen, path + ".")
        if isinstance(value, list) and value and isinstance(value[0], dict):
            return [_Reads(v, self._seen, path + "[].") for v in value]
        return value

    def __getitem__(self, key):
        return self._wrap(key, super().__getitem__(key))

    def get(self, key, default=None):
        return self._wrap(key, super().get(key, default))

    def __contains__(self, key):
        self._seen.add(f"{self._path}{key}")
        return super().__contains__(key)


def _fields(data, path=""):
    for k, v in data.items():
        if isinstance(v, dict):
            yield from _fields(v, f"{path}{k}.")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            for item in v:
                yield from _fields(item, f"{path}{k}[].")
        else:
            yield f"{path}{k}"


# fields that document the configuration and are read by no code of a run:
# its source (checked against BENCHMARK.json above), the command it comes
# from, what was cut and what was assumed
DOCUMENTS = {"source", "command", "reduced", "assumed"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_configuration_field_is_read(cell, monkeypatch):
    """The reference works the scene out from the configuration file: each
    field that is not documentation is read by a run's inputs, the
    reference's scene or the control's precision."""
    from port_bench import readings
    from port_bench.entries import pt
    from port_bench.reference import pt as ref_pt
    c = spec.cell(cell)
    seen = set()
    config = _Reads(c["config_spec"], seen)
    monkeypatch.setattr(ref_pt, "render", lambda *a, **k: None)
    traffic = dict(c["traffic_spec"], width=8, height=8)
    pt.Inputs(config, traffic, 12345).reference("cpu")
    readings.CONTROL[config["precision"]]
    unread = {f for f in _fields(c["config_spec"])
              if f.split(".")[0].split("[")[0] not in DOCUMENTS} - seen
    assert not unread
