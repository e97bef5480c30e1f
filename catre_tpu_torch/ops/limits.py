"""The kernels' shape limits, checked on a model's config before any weight
is built.

Where the JAX package's Pallas kernels take any width, the port's kernels
take the widths they were built for. `check_model_limits` runs the ops' own
checks on the widths a `CATREConfig` gives them (the encoder's fixed widths
from `models/pointnet.py`), so each limit is written once, and raises for a
config whose fused flags ask a kernel for what it does not take, naming the
flag to turn off and the limit. It does not fall back to the plain layers,
which would hide the kernel. Limits that need the built library (the shared
memory of the K5 / K6 backwards and of K9's f32 tiles) are checked at
launch, on the card.
"""

from __future__ import annotations

import torch

from ..models.pointnet import MAIN_C2, MAIN_C3, POINT_FEAT, STN_C2, STN_C3
from .encoder_chain import check_k9_bf16, check_k9_widths
from .encoder_epilogue import _check_widths, check_k1_bf16, check_k2_bf16
from .encoder_epilogue_train import _check_argmax_rows, _check_routing
from .rot_head import check_rot_head_widths


def check_model_limits(mcfg) -> None:
    """Raise when the fused flags of `mcfg` (a `CATREConfig`) ask a kernel
    for widths or point counts it does not take; the error names every
    refusal's flag, kernels and limit."""
    bf16 = mcfg.dtype == torch.bfloat16
    c4, points = mcfg.pclnet_out_dim, sorted({mcfg.num_pcl, mcfg.num_kps})
    rot = (mcfg.pclnet_out_dim, POINT_FEAT, mcfg.rot_feat_dim, mcfg.rot_num_layers,
           (mcfg.rot_out_dim + 1) // 2, mcfg.rot_num_gn_groups)
    checks = []          # (flag, kernels, check)
    for flag, kernels, on in (("MODEL.FUSED_HEADS", "K3 (K7/K8)", mcfg.uses_rot_head_kernel),
                              ("MODEL.FUSED_HEADS_TRAIN", "K3 + K4",
                               mcfg.uses_rot_head_train_kernels)):
        if on:
            checks.append((flag, kernels, lambda: check_rot_head_widths(*rot)))
    if mcfg.uses_tail_kernels and not mcfg.uses_column_kernels:
        def tails():
            _check_widths("K1", MAIN_C2, MAIN_C3, c4)
            _check_widths("K2", STN_C2, STN_C3)
            if bf16:
                check_k1_bf16("K1", None, MAIN_C2, MAIN_C3, c4)
                check_k2_bf16("K2", None, STN_C2)
        checks.append(("MODEL.FUSED_ENCODER_EPILOGUE", "K1/K2", tails))
    if mcfg.uses_tail_train_kernels:
        def train_tails():
            _check_widths("K6", MAIN_C2, MAIN_C3, c4)
            _check_widths("K5", STN_C2, STN_C3)
            for p in points:
                _check_routing("K6", p, c4)
                _check_routing("K5", p, STN_C3)
                if bf16:
                    _check_argmax_rows("K5/K6", p)
            if bf16:
                check_k1_bf16("K6", None, MAIN_C2, MAIN_C3, c4)
                check_k2_bf16("K5", None, STN_C2)
        checks.append(("MODEL.FUSED_ENCODER_TRAIN", "K5/K6", train_tails))
    if mcfg.uses_column_kernels:    # fused_encoder: set on the CATREConfig, not by a config key
        def columns():
            check_k9_widths("K9 main", POINT_FEAT, MAIN_C2, MAIN_C3, c4)
            if bf16:
                check_k9_bf16("K9 main", None, POINT_FEAT, MAIN_C2, MAIN_C3, c4)
        checks.append(("fused_encoder", "K9", columns))
    refused = []
    for flag, kernels, check in checks:
        try:
            check()
        except ValueError as e:
            refused.append(f"{flag} asks {kernels} for what it does not take ({e}); set "
                           f"{flag}=False to run the plain layers")
    if refused:
        raise ValueError("the kernels' shape limits (README, port section): "
                         + " | ".join(refused))
