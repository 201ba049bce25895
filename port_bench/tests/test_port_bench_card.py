"""The command on the card (marker `cuda`; skipped without one):

    python -m pytest port_bench/tests/test_port_bench_card.py

A short run of a cell is correct and prints the contract's last line, and
a directory holding only BENCHMARK.json and port_bench/ fails."""

import json
import shutil
import subprocess
import sys

import pytest

from port_bench import spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _run(cwd, *args):
    return subprocess.run([sys.executable, "port_bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_short_run_is_correct(card):
    res = _run(spec.ROOT, "--workload", "shirley-readme", "--seed",
               "3000000019", "--seconds", "2", "--trace", "0")
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert res.stderr.strip().splitlines()[-1].startswith("nonfinite_px")


def test_fails_without_the_program(card, tmp_path):
    shutil.copy(f"{spec.ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path, "--workload", "shirley-readme", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert res.returncode != 0
    assert not res.stdout.strip()
