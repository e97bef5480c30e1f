"""The op wrappers' profiler spans on the card: under a CPU + CUDA
`torch.profiler`, the shipped bf16 refine (K1, K2, K3) and a shipped bf16 train
step (K3, K4, K5, K6) open one `catre.op.<kernel>` span a kernel call, each
inside its model part (the backwards' inside `train.backward`, on autograd's
device thread), and `catre.op.pack` spans only inside op spans of their own
thread; the kernels launched and the outputs are the same bits with the
profiler on and off.

Every test here is marked `cuda` and skips without a card. The file imports
no JAX; run it with
    python -m pytest --noconftest -m cuda tests/test_torch_spans_cuda.py
"""

from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from catre_tpu_torch import ops
from catre_tpu_torch.entry import entry, flagship_trainer

pytestmark = pytest.mark.cuda

# catre.op.pack spans a call: K1 its casts and two panel repacks, K2 and K5 /
# K6 backwards their casts, K3 the pack and gterm (training: and the Function's
# casts), K4 its casts, K6 forward its casts and two repacks
REFINE_OPS = {"catre.op.K1": 4, "catre.op.K2": 8, "catre.op.K3": 4}
REFINE_PACKS = 4 * (3 + 2 * 1 + 1)
TRAIN_OPS = {"catre.op.K3": 4, "catre.op.K4": 4, "catre.op.K5.fwd": 8, "catre.op.K5.bwd": 8,
             "catre.op.K6.fwd": 4, "catre.op.K6.bwd": 4}
TRAIN_PACKS = 4 * (2 + 1 + 2 * 1 + 3 + 2 * 1 + 1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(fn, traced: bool):
    """fn() with the launch counts it adds, and the program's host spans
    (name, start us, end us, thread) when traced."""
    ops.reset_launch_counts()
    if not traced:
        out = fn()
        torch.cuda.synchronize()
        return out, ops.launch_counts(), []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                    for e in prof.events() if e.device_type == DeviceType.CPU
                    and e.name.startswith(("catre.", "train."))), key=lambda s: s[1])
    return out, ops.launch_counts(), spans


def _inside(spans, child: str, parents, same_thread: bool = True) -> None:
    outer = [s for s in spans if s[0] in parents]
    for name, start, end, thread in spans:
        if name == child:
            assert any(p[1] <= start and end <= p[2] and (p[3] == thread or not same_thread)
                       for p in outer), (child, parents)


def _equal(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b, strict=True):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_refine_op_spans(dev):
    fn, args = entry(dev, batch_size=8, seed=0)
    fn(*args)                                   # loads the kernels
    plain, launches, _ = _run(lambda: fn(*args), traced=False)
    traced, launches_t, spans = _run(lambda: fn(*args), traced=True)
    _equal(plain, traced)
    assert launches == launches_t
    counts = Counter(s[0] for s in spans)
    assert {k: counts[k] for k in REFINE_OPS} == REFINE_OPS
    assert counts["catre.op.pack"] == REFINE_PACKS
    _inside(spans, "catre.op.K1", ("catre.encoder",))
    _inside(spans, "catre.op.K2", ("catre.encoder",))
    _inside(spans, "catre.op.K3", ("catre.rot_head",))
    _inside(spans, "catre.op.pack", tuple(REFINE_OPS))


def test_train_step_op_spans(dev):
    def step():
        t = flagship_trainer(dev, batch_size=4, seed=0, num_pcl=256, num_kps=256)
        t.state, metrics = t.step(t.state, t.batch, t.generator, t.lr)
        return metrics, {n: p.detach().clone() for n, p in t.step.model.named_parameters()}

    step()                                      # loads the kernels
    plain, launches, _ = _run(step, traced=False)
    traced, launches_t, spans = _run(step, traced=True)
    _equal(plain, traced)
    assert launches == launches_t
    counts = Counter(s[0] for s in spans)
    assert {k: counts[k] for k in TRAIN_OPS} == TRAIN_OPS
    assert counts["catre.op.pack"] == TRAIN_PACKS
    for fwd in ("catre.op.K5.fwd", "catre.op.K6.fwd"):
        _inside(spans, fwd, ("catre.encoder",))
    _inside(spans, "catre.op.K3", ("catre.rot_head",))
    for bwd in ("catre.op.K4", "catre.op.K5.bwd", "catre.op.K6.bwd"):
        _inside(spans, bwd, ("train.backward",), same_thread=False)
    _inside(spans, "catre.op.pack", tuple(TRAIN_OPS))
