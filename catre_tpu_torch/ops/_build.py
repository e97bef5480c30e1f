"""Build the CUDA kernels in `catre_tpu_torch/csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
`sm_90a` into `build/catre_tpu_torch/<name>-<hash>.so` under the repository
root, at first use. The hash covers the source, the shared headers and the
flags, so an edited kernel is rebuilt and an unchanged one is reused. There
is no fallback: without `nvcc` or without a card, `load` raises
`KernelBuildError`, and the op wrappers let it propagate.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "catre_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("encoder_epilogue", "rot_head")


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded."""


def find_nvcc() -> str:
    """Path of `nvcc`: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of catre_tpu_torch build only where the CUDA toolkit is installed")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless the hashed library exists; returns its
    path. The compiler's report (registers, shared memory, spills from
    `-Xptxas -v`) is kept beside it as `.log`."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    try:
        return ctypes.CDLL(str(build(name)))
    except OSError as e:
        raise KernelBuildError(f"cannot load the {name} kernel library: {e}") from e


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def cuda_inputs(kernel: str, *tensors) -> None:
    """Every tensor must be contiguous and on the first tensor's CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: non-contiguous input of shape {tuple(t.shape)}")
