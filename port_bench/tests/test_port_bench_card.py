"""Each cell run once, short, through the command the driver runs: on the
card only (`pytest -m cuda port_bench/tests`), skipped without one."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          "3000000999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the run prints no result and exits with another code
    than 0 (here, where the tests run on the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
