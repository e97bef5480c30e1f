"""From the UPPERCASE config tree to `CATREConfig` (model part only).

Counterpart of `catre_tpu/config/build.py::model_config_from` (:93) and
`_fused_ok` (:61). Training flags (FUSED_HEADS_TRAIN, FUSED_ENCODER_TRAIN)
belong to the training slice and are not read yet.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from ..geom.rotations import get_rot_dim
from ..models.catre import CATREConfig

logger = logging.getLogger(__name__)

CONFIG_DIR = Path(__file__).resolve().parents[2] / "catre_tpu" / "configs"
# the shipped production variant: bf16, fused heads, fused encoder tails
FLAGSHIP_CONFIG = (CONFIG_DIR / "nocs_real" /
                   "aug05_kpsMS_r9d_catreDisR_shared_tspcl_convPerRot_scaleexp_120e_tpu.py")


def _fused_ok(flag, rot_type: str) -> bool:
    """The rotation head kernel hard-codes the 3+3 rot6d neck: for any other
    ROT_TYPE the build logs a warning and picks the plain head."""
    flag = bool(flag)
    if flag and not rot_type.endswith("rot6d"):
        logger.warning(
            "FUSED_HEADS requested with ROT_TYPE=%s: the fused head supports rot6d "
            "only; using the plain head", rot_type)
        return False
    return flag


def model_config_from(cfg) -> CATREConfig:
    net = cfg.MODEL.CATRE
    rot = net.ROT_HEAD
    ts = net.TS_HEAD
    rot_type = rot.get("ROT_TYPE", "ego_rot6d")
    rot_out_dim = get_rot_dim(rot_type)  # raises on an unknown ROT_TYPE
    cfg_rot_dim = rot.INIT_CFG.get("rot_dim", None)
    if cfg_rot_dim is not None and int(cfg_rot_dim) != (rot_out_dim + 1) // 2:
        raise ValueError(
            f"ROT_HEAD.INIT_CFG.rot_dim={cfg_rot_dim} inconsistent with ROT_TYPE={rot_type} "
            f"(total width {rot_out_dim} needs per-head rot_dim {(rot_out_dim + 1) // 2})")
    return CATREConfig(
        num_pcl=int(cfg.INPUT.NUM_PCL),
        num_kps=int(cfg.INPUT.NUM_KPS),
        pclnet_out_dim=int(net.PCLNET.INIT_CFG.get("out_dim", 1024)),
        feature_transform=bool(net.PCLNET.INIT_CFG.get("feature_transform", True)),
        rot_feat_dim=int(rot.INIT_CFG.get("feat_dim", 256)),
        rot_num_layers=int(rot.INIT_CFG.get("num_layers", 2)),
        rot_num_gn_groups=int(rot.INIT_CFG.get("num_gn_groups", 32)),
        ts_feat_dim=int(ts.INIT_CFG.get("feat_dim", 256)),
        ts_num_layers=int(ts.INIT_CFG.get("num_layers", 2)),
        ts_num_gn_groups=int(ts.INIT_CFG.get("num_gn_groups", 32)),
        ts_with_kps_feature=bool(ts.get("WITH_KPS_FEATURE", False)),
        ts_with_init_scale=bool(ts.get("WITH_INIT_SCALE", False)),
        ts_with_init_trans=bool(ts.get("WITH_INIT_TRANS", False)),
        rot_type=rot_type,
        scale_type=rot.get("SCLAE_TYPE", "iter_add"),  # (sic) the reference's key
        delta_t_space=rot.get("DELTA_T_SPACE", "image"),
        delta_t_weight=float(rot.get("DELTA_T_WEIGHT", 1.0)),
        delta_z_style=rot.get("DELTA_Z_STYLE", "cosypose"),
        t_transform_k_aware=bool(rot.get("T_TRANSFORM_K_AWARE", True)),
        zero_center_input=bool(cfg.INPUT.get("ZERO_CENTER_INPUT", False)),
        refine_scale=bool(cfg.MODEL.get("REFINE_SCLAE", True)),
        dtype=torch.bfloat16 if cfg.MODEL.get("BF16", False) else None,
        fused_heads=_fused_ok(cfg.MODEL.get("FUSED_HEADS", False), rot_type),
        fused_encoder_epilogue=bool(cfg.MODEL.get("FUSED_ENCODER_EPILOGUE", True)),
    )
