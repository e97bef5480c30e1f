"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch twin, and
the ball-crop sampler (`sampling`, plain PyTorch on either device).

On a CPU tensor every kernel wrapper runs its twin; on a CUDA tensor it
launches its kernel or raises. `launch_counts()` reports how often each
kernel ran.
"""

from . import (encoder_chain, encoder_epilogue, encoder_epilogue_train, rot_head,
               rot_head_multi, rot_head_train)

_COUNTERS = (encoder_epilogue.LAUNCHES, rot_head.LAUNCHES, rot_head_train.LAUNCHES,
             encoder_epilogue_train.LAUNCHES, rot_head_multi.LAUNCHES, encoder_chain.LAUNCHES)


def launch_counts() -> dict:
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0
