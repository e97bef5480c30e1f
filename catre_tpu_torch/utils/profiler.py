"""Profiling helpers.

Counterpart of `catre_tpu/utils/profiler.py` (`trace` :19). The reference has
wall-clock timing only (`catre_evaluator.py:256-362`). `trace` records with
`torch.profiler` and writes a Chrome trace; `span` names a stretch of the
program in such a trace.

The program's spans, each a `torch.profiler` range while a profiler records:
  - `catre.refine` a refine call, `catre.iter` each of its iterations
    (`engine/refiner.py`);
  - `catre.inputs`, `catre.encoder`, `catre.ts_head`, `catre.rot_head` and
    `catre.compose`, the parts of one iteration's forward, in training and in
    inference (`models/catre.py`);
  - `catre.op.K1` ... `catre.op.K9` (`.K5.fwd`, `.K5.bwd`, `.K6.fwd`,
    `.K6.bwd`), each op wrapper on its kernel path, and inside it
    `catre.op.pack`, the casts and packing of its weights (`ops/`); a
    backward's spans open on autograd's device thread;
  - `catre.sampler` a group sampler's call, with `catre.sampler.candidates`
    (the window gathers or the full-frame backprojection, and the in-ball
    mask) and `catre.sampler.select` (the draw among them and the gathers)
    (`data/loader.py`, `ops/sampling.py`);
  - `train.step` a `TrainStep` call, `train.prepare` its augmentation and
    iteration-0 draws, per inner iteration `train.forward` (with
    `train.loss`), `train.backward`, `train.optimizer` and `train.metrics`,
    and `train.metrics` again for the step's stacked metrics
    (`engine/train.py`); `train.loader` a train loader's batch (`entry.py`).
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str, on: bool = True):
    """A `torch.profiler` range named `name` while a profiler records and
    `on`; otherwise one shared context that does nothing. A span records
    host time alone: no tensor, no kernel, no sync."""
    if on and _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str, cuda: bool | None = None):
    """Record the CPU activity, and the card's when `cuda` (default: a card is
    there), while the block runs; then write `logdir/trace_<pid>_<ns>.json`
    (chrome://tracing or Perfetto). Yields the profiler."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
