"""The plain reference against the port's plain path (the published recipe,
float32, no kernel) at a small size on the CPU: both drivers' numbers read
at float32 rounding."""

import pytest
import torch


def _run(tiny_cell, name, seed=3000000777):
    import importlib
    cell = tiny_cell(name)
    driver = importlib.import_module(f"port_bench.drivers.{cell.workload['driver']}")
    run = driver.build(cell, seed, torch.device("cpu"))
    if not run.training:
        run.call()
    return run


def test_train_reference_follows_the_port(tiny_cell):
    got = _run(tiny_cell, "recipe_f32.train_b120").readings()
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-3
    assert got["state_gap"] < 1e-3 and got["trans_gap_mm"] < 1e-2
    assert got["leaves_kept"] >= 60


def test_follow_judge_reads_nought_on_the_reference(tiny_cell):
    """The step-by-step judge, given the reference's own float32 steps in
    the program's place, finds every iteration and Ranger step as it
    computes them."""
    got = _run(tiny_cell, "shipped_bf16.train_b512").readings("f32")
    assert got["loss_gap"] < 1e-6 and got["grad_gap_worst_leaf"] < 1e-5
    assert got["trans_gap_mm"] < 1e-3 and got["rot_gap_deg"] < 1e-4
    assert got["update_gap"] < 1e-6 and got["state_gap"] < 1e-6


def test_test_reference_follows_the_port(tiny_cell):
    got = _run(tiny_cell, "recipe_f32.test_g32").readings()
    assert got["calls_judged"] == 1 and got["cloud_faults"] == 0
    assert got["rot_gap_deg"] < 1e-3 and got["trans_gap_mm"] < 1e-2 and got["scale_gap_mm"] < 1e-2


def test_sampler_judge_finds_a_moved_point(tiny_cell):
    from port_bench.reference import sampler
    run = _run(tiny_cell, "shipped_bf16.test_g32")
    i, pcl, idx, n_in, _ = next(iter(run.kept.values()))
    g = run.pool[i]
    args = (g["depth"][0].long(), g["K"][0], (g["packed"][0].long() & 1).bool(), g["poses"][0, 0],
            g["scales"][0, 0], run.ratio)
    assert sampler.object_faults(*args, pcl[0], idx[0], n_in[0]) == []
    moved = pcl[0].clone()
    moved[0, 2] += 1e-3
    assert sampler.object_faults(*args, moved, idx[0], n_in[0])
    assert sampler.object_faults(*args, pcl[0], idx[0], n_in[0] + 1)


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys
    code = ("import sys; import port_bench.reference.model, port_bench.reference.train, "
            "port_bench.reference.sampler, port_bench.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'catre_tpu_torch', 'catre_tpu', 'jax', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(__import__("pathlib").Path(__file__).parents[2]))
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["port_bench.drivers.train", "port_bench.drivers.test_frames",
                                    "port_bench.harness", "port_bench.trace", "port_bench.run"])
def test_no_jax_after_a_dry_import(module):
    import subprocess
    import sys
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'catre_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(__import__("pathlib").Path(__file__).parents[2]))
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_jax_after_a_run(tiny_run):
    from port_bench.harness import forbidden_modules
    tiny_run("shipped_bf16.test_g32")
    assert forbidden_modules() == []
