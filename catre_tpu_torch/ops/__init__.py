"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch twin.

On a CPU tensor every wrapper runs its twin; on a CUDA tensor it launches
its kernel or raises. `launch_counts()` reports how often each kernel ran.
"""

from . import encoder_epilogue, rot_head


def launch_counts() -> dict:
    return {**encoder_epilogue.LAUNCHES, **rot_head.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (encoder_epilogue.LAUNCHES, rot_head.LAUNCHES):
        for k in counts:
            counts[k] = 0
