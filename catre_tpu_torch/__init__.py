"""catre_tpu_torch: PyTorch/CUDA port of catre_tpu for NVIDIA Hopper.

The JAX package `catre_tpu` is the reference; every module here names its
JAX counterpart by file and function. This package imports `torch` and
never `jax` (nor anything from `catre_tpu`): the machine with the card has
no JAX.

Slice 1 covers test-time refinement: `engine.refiner.make_refine_fn` over
`models.catre.refine_forward`, with the encoder tails (`ops.encoder_epilogue`)
and the fused rotation head (`ops.rot_head`) as hand-written CUDA kernels.
Slice 2 covers the training step: `engine.train.make_train_step` with the
losses, Ranger and the batch augmentation, the rotation head's backward
(`ops.rot_head_train`) as a hand-written CUDA kernel. The solver
(`solver.build`: the whole optimizer registry, clipping, LR_MULT, FREEZE;
`solver.schedule`) and the training init modes follow in slice 19.
"""

from .models.catre import CATREConfig, CATREDisRShared, init_model, refine_forward

__all__ = ["CATREConfig", "CATREDisRShared", "init_model", "refine_forward"]
