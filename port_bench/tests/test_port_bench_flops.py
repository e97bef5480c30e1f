"""The counts of operations and bytes against PERF.md's kernel table."""

import pytest

from port_bench import flops
from port_bench.reference.model import forward_flops

SIZES = {"num_pcl": 1024, "num_kps": 1024, "pclnet_out_dim": 1024, "point_feat_dim": 64,
         "stn_widths": [64, 128, 1024, 512, 256], "main_widths": [128, 512],
         "rot_feat_dim": 256}


@pytest.mark.parametrize("fn,args,ms", [
    (flops.k1, (512, 1024), 0.6254), (flops.k2, (512, 1024), 0.1390),
    (flops.k3, (256, 2048), 0.1737), (flops.k4, (512, 2048), 1.0423)])
def test_kernel_bounds(fn, args, ms):
    assert fn(*args) * 1e3 == pytest.approx(ms, abs=6e-5)


def test_k3_model_work():
    head = 2 * 2048 * (64 * 512 + 2 * 256 * 256)
    assert 256 * head / 1e9 == pytest.approx(171.8, abs=0.05)


def test_training_tails_forward_bounds():
    # K5 fwd 0.2779 ms and K6 fwd 1.2507 ms at 1024 clouds (the backward adds to each)
    assert flops.k5(1024, 1024) * 1e3 > 0.2779
    assert flops.k6(1024, 1024) * 1e3 > 1.2507
    assert flops.bound_s(0, 2 * 1024 * 1024 * 128 * 1024) * 1e3 == pytest.approx(0.2779, abs=5e-5)


def test_forward_flops_by_column():
    # K9 rows: 146.3, 150.3, 627.1 GFLOP over 512 clouds; K3: 171.8 over 256 objects
    per_object = forward_flops(SIZES)
    columns = (146.3 + 150.3 + 627.1) / 512 * 2
    assert per_object / 1e9 == pytest.approx(columns + 171.8 / 256, rel=2e-3)
    assert per_object / 1e9 == pytest.approx(4.28, abs=0.01)
