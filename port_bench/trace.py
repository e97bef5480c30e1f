"""What a `torch.profiler` trace of the measured window says, for the
per-layer metrics: the device's kernels and copies with the host time of
their launches, the host ranges (the benchmark's `bench.*` and the port's
`train.*`), the device's busy time, and the breakdown of the window.

Kernels of the port are told apart by their function names (the `__global__`
functions of `catre_tpu_torch/csrc/`); a helper that two kernels share
(`sum_rows`, `route_clouds`, `gemm_tn`, `sum_splits`) is given to its
neighbour in launch order: `route_clouds` to the next distinctive kernel,
the others to the one before.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from torch.autograd import DeviceType

# kernel id -> its own function names; K1/K2 in inference are K6/K5's forwards in training
OWN = {
    "K1": ("dense_relu_dense_max_wgmma", "dense_relu_dense_max_kernel"),
    "K2": ("dense_relu_max_wgmma", "dense_relu_max_kernel"),
    "K3": ("rot_head_wgmma_kernel", "rot_head_f32_kernel"),
    "K4": ("rot_head_bwd_wgmma", "rot_head_bwd_f32"),
    "K5": ("gate_pass", "dx_pass", "relu_max_bwd_cloud", "relu_max_bwd_weight"),
    "K6": ("cloud_pass", "dw3_pass", "dw4_pass", "relu_dense_max_bwd_cloud",
           "relu_dense_max_bwd_w4"),
    "K9": ("chain3_main_wgmma", "chain3_stn_wgmma", "chain3_max_kernel"),
}
SHARED_BEFORE = ("sum_rows", "gemm_tn", "sum_splits")    # take the kernel before them
SHARED_AFTER = ("route_clouds",)                         # take the kernel after them
PROBES = ("wgmma_chain_kernel", "wgmma_tn_kernel")
RANGES = ("bench.", "train.")                            # host ranges of the benchmark and the port
TRAIN_FORWARDS = {"K1": "K6", "K2": "K5"}
_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def function_name(kernel: str) -> str:
    """The bare function name of a demangled kernel name: the last
    identifier before its template or argument list."""
    head = re.split(r"[<(]", kernel.replace("(anonymous namespace)", ""), maxsplit=1)[0]
    words = _WORD.findall(head)
    return words[-1] if words else kernel


def _port_kernel(name: str):
    fn = function_name(name)
    for kid, names in OWN.items():
        if fn in names:
            return kid
    if fn in SHARED_BEFORE or fn in SHARED_AFTER or fn in PROBES:
        return "shared"
    return None


def union_s(spans) -> float:
    """Seconds covered by the union of (start, end) ns spans."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9


def device_busy_s(prof) -> float:
    """Seconds in which a kernel or a copy ran, over all that a profiler of
    device activity alone recorded (the device drained before it started)."""
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.name().startswith(RANGES) or getattr(
                e, "is_user_annotation", lambda: False)():
            continue
        start = _ns(e, "start")
        spans.append((start, start + int(e.duration_ns() if hasattr(e, "duration_ns")
                                          else e.duration_us() * 1000)))
    return union_s(spans)


def _ns(e, which):
    if hasattr(e, f"{which}_ns"):
        return int(getattr(e, f"{which}_ns")())
    return int(getattr(e, f"{which}_us")() * 1000)


class Trace:
    """The trace of one window. `training` says whether the dense tails are
    K5/K6 (training) or K1/K2 (inference)."""

    def __init__(self, prof, training: bool, window: str = "bench.window"):
        self.ranges = defaultdict(list)          # host range name -> [(start, end)] ns
        launches = {}                            # correlation id -> host launch ns
        device = []                              # (name, start, end, correlation)
        for e in prof.profiler.kineto_results.events():
            name, start = e.name(), _ns(e, "start")
            end = start + int(e.duration_ns() if hasattr(e, "duration_ns")
                              else e.duration_us() * 1000)
            if e.device_type() == DeviceType.CUDA:
                if name.startswith(RANGES) or getattr(
                        e, "is_user_annotation", lambda: False)():
                    continue
                device.append((name, start, end, e.correlation_id()))
            elif name.startswith(RANGES):
                self.ranges[name].append((start, end))
            elif name.startswith(("cuda", "cu")):
                launches[e.correlation_id()] = start
        for spans in self.ranges.values():
            spans.sort()
        if not self.ranges.get(window):
            raise RuntimeError(f"the trace holds no {window} range")
        self.start, self.end = self.ranges[window][0]
        device.sort(key=lambda d: d[1])
        self.kernels, self.copies = [], []
        for name, s, e, corr in device:
            if s < self.start or s > self.end:
                continue
            row = {"name": name, "start": s, "end": e, "launch": launches.get(corr, s)}
            low = name.lower()
            (self.copies if ("memcpy" in low or "memset" in low) else self.kernels).append(row)
        self._attribute(training)

    def _attribute(self, training: bool) -> None:
        labels = [_port_kernel(k["name"]) for k in self.kernels]
        for i, k in enumerate(self.kernels):
            label = labels[i]
            if label == "shared":
                fn = function_name(k["name"])
                step = 1 if fn in SHARED_AFTER else -1
                j, label = i + step, None
                while 0 <= j < len(labels):
                    if labels[j] not in (None, "shared"):
                        label = labels[j]
                        break
                    j += step
                label = label or "shared"
            if training and label in TRAIN_FORWARDS:
                label = TRAIN_FORWARDS[label]
            k["kernel"] = label

    # ---- queries

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_s(self) -> float:
        """Seconds in the window in which a kernel or a copy ran."""
        return union_s((max(d["start"], self.start), min(d["end"], self.end))
                       for d in self.kernels + self.copies)

    def of_kernel(self, kid: str) -> list:
        return [k for k in self.kernels if k.get("kernel") == kid]

    def plain(self) -> list:
        """Kernels not built from the port's sources."""
        return [k for k in self.kernels if k.get("kernel") is None]

    def launched_under(self, rows: list, *range_names: str) -> list:
        """The rows whose launch lies inside a host range of these names."""
        spans = sorted(s for n in range_names for s in self.ranges.get(n, []))
        starts = [s for s, _ in spans]
        out = []
        for r in rows:
            i = bisect.bisect_right(starts, r["launch"]) - 1
            if i >= 0 and spans[i][0] <= r["launch"] <= spans[i][1]:
                out.append(r)
        return out

    @staticmethod
    def seconds(rows: list) -> float:
        return sum(r["end"] - r["start"] for r in rows) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the host range that was open when each began."""
        by_name = defaultdict(int)
        for d in self.kernels + self.copies:
            by_name[d["name"][:160]] += d["end"] - d["start"]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        spans = sorted((d["start"], d["end"]) for d in self.kernels + self.copies)
        gaps, last = [], self.start
        for s, e in spans:
            if s > last:
                gaps.append((s - last, last))
            last = max(last, e)
        if self.end > last:
            gaps.append((self.end - last, last))
        gaps.sort(reverse=True)
        named = []
        for length, at in gaps[:top]:
            open_ranges = [n for n, spans_ in self.ranges.items() if n != "bench.window"
                           and any(s <= at <= e for s, e in spans_)]
            named.append(["host in " + ("/".join(sorted(open_ranges)) or "bench.window"),
                          length / 1e9])
        return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": named}
