"""Fixtures of the benchmark's tests: a cell run small on the CPU."""

import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# a cell small enough for the CPU: every width as published, few points, rows and frames
TINY = {"model": {"num_pcl": 32, "num_kps": 32},
        "traffic": {"rows": 6, "pool": 3, "frames_per_call": 2, "height": 48, "width": 64,
                    "size_px": [8, 20], "warmup_calls": 1, "sample_calls": 1, "sample_from": 1}}


@pytest.fixture
def tiny_run():
    """run(cell, seed) -> the result line's object of a small run on the CPU."""
    from port_bench.harness import run_cell

    def run(cell, seed=3000000123, seconds=0.3, trace=False):
        return run_cell(cell, seed, seconds, trace, time.perf_counter(), require_card=False,
                        device="cpu", overrides=TINY)
    return run


@pytest.fixture
def tiny_cell():
    """cell(name) -> the cell with TINY's sizes, for building a driver's run directly."""
    from port_bench.harness import load_cell

    def cell(name):
        c = load_cell(name)
        c.workload = {**c.workload, "traffic": {**c.traffic, **TINY["traffic"]}}
        c.config = {**c.config, "model": {**c.config["model"], **TINY["model"]}}
        return c
    return cell
