"""Guards of the PyTorch port: it runs without JAX, its kernels build only
where nvcc is, the chip smoke check refuses a host without a card, and the
card-only tests are marked and skip here."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from catre_tpu_torch import ops
from catre_tpu_torch.ops import _build
from catre_tpu_torch.ops import encoder_epilogue as enc_ops

ROOT = Path(__file__).resolve().parents[1]


def _run(args, timeout=600):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from catre_tpu_torch.entry import entry\n"
        "fn, args = entry(device='cpu', batch_size=2)\n"
        "poses, scales = fn(*args)\n"
        "assert poses.shape == (5, 2, 3, 4) and scales.shape == (5, 2, 3)\n"
        "assert torch.isfinite(poses).all() and torch.isfinite(scales).all()\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "print('port ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "port ok" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _run(["chip_smoke.py"], timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this host has nvcc")
    for name in _build.KERNEL_SOURCES:
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.load(name)


def test_wrappers_route_cpu_to_twin_and_refuse_other_devices():
    ops.reset_launch_counts()
    x = torch.randn(2, 16, 128)
    w, b = torch.randn(1024, 128) * 0.05, torch.randn(1024) * 0.1
    out = enc_ops.dense_relu_max(x, w, b, torch.float32)
    torch.testing.assert_close(out, enc_ops.dense_relu_max_twin(x, w, b, torch.float32))
    assert ops.launch_counts() == {"dense_relu_max": 0, "dense_relu_dense_max": 0,
                                   "rot_head": 0}
    with pytest.raises(ValueError, match="no kernel"):
        enc_ops.dense_relu_max(x.to("meta"), w, b, torch.float32)


def test_cuda_tests_are_marked_and_skip_here():
    target = "tests/test_torch_cuda.py"
    unmarked = _run(["-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                     "--collect-only", "-q", "-m", "not cuda", target])
    assert "no tests collected" in unmarked.stdout or " 0 selected" in unmarked.stdout \
        or "deselected" in unmarked.stdout, unmarked.stdout[-2000:]
    if torch.cuda.is_available():
        return
    run = _run(["-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", "-m", "cuda",
                "-rs", target])
    assert run.returncode == 0, run.stdout[-2000:]
    assert "skipped" in run.stdout and "passed" not in run.stdout and "failed" not in run.stdout
