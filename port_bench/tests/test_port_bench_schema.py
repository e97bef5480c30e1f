"""The result line of a run, with and without the trace, small on the CPU."""

import json

import pytest

TRAIN, TEST = "recipe_f32.train_b120", "recipe_f32.test_g32"
BUSY_TRAIN, BUSY_TEST = "shipped_bf16.train_b512", "shipped_bf16.test_g32"


@pytest.mark.parametrize("cell", [TRAIN, TEST])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_run, cell, trace):
    r = tiny_run(cell, trace=trace)
    for key in ("correct", "attempted", "failed", "metrics", "device", "checks"):
        assert key in r
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {"count", "memory_peak_bytes", "platform", "kind"} <= set(r["device"])
    for name, m in r["metrics"].items():
        assert isinstance(m["value"], float) and m["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "setup_s" not in r["metrics"]
    else:
        assert "setup_s" in r["metrics"]
        expected = "train_obj_per_s" if cell == TRAIN else "refine_obj_per_s"
        assert r["metrics"][expected]["value"] > 0
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r)


def test_p95_only_where_listed(tiny_run):
    assert "host_call_p95_ms.test" not in tiny_run(TEST, trace=True)["metrics"]
    assert tiny_run(BUSY_TEST, trace=True)["metrics"]["host_call_p95_ms.test"]["value"] > 0


@pytest.mark.parametrize("cell, rate", [(BUSY_TRAIN, "train_obj_per_busy_s"),
                                        (BUSY_TEST, "refine_obj_per_busy_s")])
def test_busy_rate_where_listed(tiny_run, cell, rate):
    """A cell whose end-to-end rate is read from the device's busy time
    reports it, and not the host-clock rate of the other cells."""
    metrics = tiny_run(cell)["metrics"]
    assert set(metrics) == {rate, "setup_s"} and metrics[rate]["value"] > 0


def test_device_busy_is_the_union_of_spans():
    from port_bench.trace import union_s
    assert union_s([(0, 2e9), (1e9, 3e9), (5e9, 6e9)]) == pytest.approx(4.0)
    assert union_s([]) == 0.0


def test_percentile():
    from port_bench.harness import percentile
    values = list(range(1, 101))
    assert percentile(values, 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
