"""The port's profiler spans (`utils/profiler.span`) on the CPU: under a CPU
`torch.profiler`, one tiny refine call, one group-sampler call in each form
(the fused windowed one, the materialized full-frame one, the device-cache
one and the presampled one) and one train step. Each span appears the
expected number of times and lies inside its parent; the outputs are
bit-equal with the profiler on and off; with no profiler `span()` returns
one shared object that does nothing; nothing launches a kernel. The op
wrappers' spans (`catre.op.*`, `catre.op.pack`) open on the kernel path
alone; `tests/test_torch_spans_cuda.py` checks them on the card.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from catre_tpu_torch import ops
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.entry import entry, example_frames, flagship_trainer
from catre_tpu_torch.utils import profiler

PROGRAM = ("catre.", "train.")
PARTS = ("catre.inputs", "catre.encoder", "catre.ts_head", "catre.rot_head", "catre.compose")
NPTS = 64


def _spans(prof) -> list:
    """(name, start us, end us, thread) of the program's spans, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                   for e in prof.events() if e.name.startswith(PROGRAM)), key=lambda s: s[1])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _inside(spans, child: str, parent: str) -> None:
    """Every `child` span lies within a `parent` span of its thread."""
    outer = [s for s in spans if s[0] == parent]
    for name, start, end, thread in spans:
        if name == child:
            assert any(p[1] <= start and end <= p[2] and p[3] == thread for p in outer), \
                (child, parent)


def _equal(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture
def no_launches():
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values()), ops.launch_counts()


def test_span_without_a_profiler_is_one_shared_no_op():
    off = profiler.span("catre.refine")
    assert off is profiler.span("catre.iter") is profiler.span("train.step", on=False)
    with off as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiler.span("catre.refine")
        assert on is not off and isinstance(on, torch.profiler.record_function)
        assert profiler.span("catre.op.K1", on=False) is off
    assert profiler.span("catre.refine") is off


def test_refine_spans(no_launches):
    fn, args = entry("cpu", batch_size=2, seed=0, num_pcl=NPTS, num_kps=NPTS)
    plain = fn(*args)
    traced, spans = _profiled(lambda: fn(*args))
    _equal(plain, traced)
    counts = Counter(s[0] for s in spans)
    assert counts == Counter({"catre.refine": 1, "catre.iter": 4, **{p: 4 for p in PARTS}})
    _inside(spans, "catre.iter", "catre.refine")
    for part in PARTS:
        _inside(spans, part, "catre.iter")


SAMPLER_FORMS = {
    # form: (window, candidates spans a call: the materialized form's frame
    # and its crop are one each)
    "fused_window": (32, 1),
    "full_frame": (0, 2),
    "cached_window": (32, 1),
    "presampled": (32, 1),
}


def _sampler(form: str, window: int):
    """The form's sampler over 3 frames of 48 x 64 with 4 slots, -> a call."""
    m, h, w = 4, 48, 64
    cfg = tl.LoaderConfig(num_pcl=NPTS, sample_window=window, max_objs_per_image=m)
    f = example_frames(3, h, w, m=m, seed=1, objs=(1, m), size_px=(8, 30))
    table = (f["depth"], f["packed"], f["K"], f["poses"], f["scales"], f["mask_bbox"])
    idx = np.array([2, 0], np.int32)
    if form in ("fused_window", "full_frame"):
        args = (f["depth"], f["K"], f["packed"], f["poses"], f["scales"], f["mask_bbox"])
        sample = tl.make_group_sampler(cfg, False, device="cpu")
        return lambda gen: sample(*args, generator=gen)
    if form == "cached_window":
        sample = tl.make_cached_group_sampler(cfg, False, device="cpu")
        return lambda gen: sample(*table, idx, generator=gen)
    cand = tl.make_candidates_builder(cfg, device="cpu")(*table, np.arange(3, dtype=np.int32))
    sample = tl.make_presampled_group_sampler(cfg, w, window, device="cpu")
    return lambda gen: sample(*cand, idx, generator=gen)


@pytest.mark.parametrize("form", sorted(SAMPLER_FORMS))
def test_sampler_spans(form, no_launches):
    window, n_candidates = SAMPLER_FORMS[form]
    call = _sampler(form, window)
    plain = call(torch.Generator().manual_seed(7))
    traced, spans = _profiled(lambda: call(torch.Generator().manual_seed(7)))
    _equal(plain, traced)
    assert Counter(s[0] for s in spans) == Counter({
        "catre.sampler": 1, "catre.sampler.candidates": n_candidates,
        "catre.sampler.select": 1})
    _inside(spans, "catre.sampler.candidates", "catre.sampler")
    _inside(spans, "catre.sampler.select", "catre.sampler")
    select = next(s for s in spans if s[0] == "catre.sampler.select")
    assert all(s[2] <= select[1] for s in spans if s[0] == "catre.sampler.candidates")


def _train_step(traced: bool):
    t = flagship_trainer("cpu", batch_size=2, seed=0, num_pcl=NPTS, num_kps=NPTS)

    def step():
        return t.step(t.state, t.batch, t.generator, t.lr)

    (_, metrics), spans = _profiled(step) if traced else (step(), [])
    params = {n: p.detach().clone() for n, p in t.step.model.named_parameters()}
    return metrics, params, spans


def test_train_step_spans(no_launches):
    metrics, params, _ = _train_step(traced=False)
    metrics_t, params_t, spans = _train_step(traced=True)
    _equal(metrics, metrics_t)
    _equal(params, params_t)
    per_iter = ("train.forward", "train.loss", "train.backward", "train.optimizer") + PARTS
    assert Counter(s[0] for s in spans) == Counter({
        "train.step": 1, "train.prepare": 1, "train.metrics": 5, **{n: 4 for n in per_iter}})
    for child in ("train.prepare", "train.forward", "train.backward", "train.optimizer",
                  "train.metrics"):
        _inside(spans, child, "train.step")
    _inside(spans, "train.loss", "train.forward")
    for part in PARTS:
        _inside(spans, part, "train.forward")
