"""One run of one cell: find the cell, its configuration and its traffic by
name, set the program up, measure a window, judge what the window produced,
and print the result line.

Everything that belongs to one cell lives in files found by name:
`BENCHMARK.json` names the cell, its configuration and its metrics;
`port_bench/configs/<config>.json` holds the configuration's sizes and the
port's config file that runs them; `port_bench/workloads/<cell>.json` holds
the traffic, the driver that serves it (`port_bench/drivers/<driver>.py`,
which also computes the end-to-end values of its window, by metric name)
and the limits of the numbers compared; `port_bench/metrics/<metric>.py`
reads one per-layer metric from the trace.

An end-to-end metric whose `source` is `device_trace` is read from the
device's own record of the window: a run without `--trace` that reports one
holds the window under a profiler of device activity alone (no host events),
and the window's busy seconds (the union of its kernels and copies) go to
the driver with its host seconds.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "catre_tpu")


@dataclasses.dataclass
class Cell:
    """A cell as its files describe it."""

    name: str
    entry: dict           # its line in BENCHMARK.json
    config: dict          # port_bench/configs/<config>.json
    workload: dict        # port_bench/workloads/<cell>.json
    benchmark: dict       # BENCHMARK.json

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    def metrics(self, section: str) -> list:
        """The metrics of `section` this cell reports."""
        return [m for m in self.benchmark[section]
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    benchmark = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in benchmark["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in benchmark["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    workload = json.loads((root / "port_bench" / "workloads" / f"{name}.json").read_text())
    return Cell(name, entry, config, workload, benchmark)


@dataclasses.dataclass
class Window:
    """What a measured window did."""

    seconds: float
    calls: int
    objects: int
    latencies: list
    busy_s: float | None = None   # device seconds busy, where an end-to-end metric reads it


def measure(run, seconds: float, trace: bool, busy: bool = False):
    """Calls of `run` for `seconds`, the device drained at the end; under
    the profiler when `trace`, or with `busy` under a profiler of device
    activity alone. -> (Window, profiler or None)."""
    run.sync()
    prof = None
    if trace or busy:
        activities = [ProfilerActivity.CPU] if trace else []
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    try:
        calls = 0
        t0 = time.perf_counter()
        with record_function("bench.window"):
            while time.perf_counter() - t0 < seconds:
                run.call()
                calls += 1
            run.sync()
        elapsed = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return Window(elapsed, calls, run.objects_done, list(run.latencies)), prof


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def end_to_end(cell: Cell, values: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics from what its driver measured (`values`,
    by metric name) and the set-up time."""
    values = {**values, "setup_s": setup_s}
    out = {}
    for m in cell.metrics("end_to_end"):
        if m["name"] not in values:
            raise RuntimeError(f"{cell.name}: the run measures no {m['name']}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(cell: Cell, ctx) -> dict:
    out = {}
    for m in cell.metrics("per_layer"):
        value = _reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _reader(name: str):
    """The module of `port_bench/metrics/<name>.py` (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '__')}", BENCH_DIR / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card() -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    return {"platform": "gpu", "kind": name, "power_limit": limit}


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader gets."""

    trace: object         # port_bench.trace.Trace
    cell: Cell
    calls: int
    host_s: float         # the window on the host's clock
    latencies: list       # each call's, host seconds
    objects: int          # real objects refined (test) or rows trained (train)
    slots_per_call: int   # objects the kernels compute a call, padded slots included
    iterations: int
    forward_flops: float  # one object through one iteration


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             require_card: bool = True, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """One run; returns the result line's object. `require_card=False`,
    `device` and `overrides` (which replace traffic and size entries) are
    for the tests, which run a cell small on the CPU."""
    cell = load_cell(name)
    if overrides:
        cell.workload = {**cell.workload, "traffic": {**cell.traffic, **overrides.get(
            "traffic", {})}}
        cell.config = {**cell.config, "model": {**cell.config["model"], **overrides.get(
            "model", {})}}
    chips = int(cell.entry["chips"])
    if require_card and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise SystemExit(f"{name} needs {chips} CUDA card(s); torch.cuda.is_available() = "
                         f"{torch.cuda.is_available()}, device_count = "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    driver = importlib.import_module(f"port_bench.drivers.{cell.workload['driver']}")
    run = driver.build(cell, seed, torch.device(device))
    setup_s = time.perf_counter() - t_start
    on_card = torch.device(device).type == "cuda"
    busy = not trace and any(m["source"] == "device_trace" for m in cell.metrics("end_to_end"))
    win, prof = measure(run, seconds, trace, busy and on_card)
    if busy:
        # on the CPU, where the tests run small, the host is the device and busy throughout
        from .trace import device_busy_s
        win.busy_s = device_busy_s(prof) if on_card else win.seconds
        del prof
    dev = card() if on_card else {"platform": "cpu", "kind": "cpu"}
    dev["count"] = chips
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0
    result = {"correct": False, "attempted": win.calls, "failed": run.failed()}
    if trace:
        from .trace import Trace
        tr = Trace(prof, training=run.training)
        del prof
        ctx = TraceContext(tr, cell, win.calls, win.seconds, win.latencies, win.objects,
                           run.slots_per_call, run.iterations, run.forward_flops)
        result["metrics"] = per_layer(cell, ctx)
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        breakdown = tr.breakdown()
    else:
        result["metrics"] = end_to_end(cell, run.end_to_end(win), setup_s)
        breakdown = None
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    run.release()
    checks = run.check()
    result["correct"] = result["failed"] == 0 and all(v <= lim for v, lim in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
