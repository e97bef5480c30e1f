"""From the UPPERCASE config tree to the port's typed configs.

Counterpart of `catre_tpu/config/build.py`: `validate_config` (:39) with
`_unknown_key_paths` (:23), `model_config_from` (:93) with `_fused_ok` (:61)
and `_enc_train_ok` (:73), `loss_config_from` (:143), `noise_config_from`
(:167, every field) and `loader_config_from` (:203) with
`_mean_table_matches` (:189), for the fields the loader reads in either
phase (JAX's test-init fields, `sample_depth_from_ball`, which nothing reads,
and `bbox_type_test` etc., which `engine.runner.do_test` reads from the config
itself, are not carried).

`model_config_from` also checks the kernels' shape limits before any weight
is built (`ops.limits.check_model_limits`): a config whose fused flags ask
a kernel for a width it does not take raises, naming the flag to turn off
and the limit.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from ..data.loader import LoaderConfig
from ..engine.train import InputNoiseConfig
from ..geom.rotations import get_rot_dim
from ..losses import LossConfig
from ..models.catre import CATREConfig
from ..ops.limits import check_model_limits

logger = logging.getLogger(__name__)

CONFIG_DIR = Path(__file__).resolve().parents[2] / "catre_tpu" / "configs"
# the shipped production variant: bf16, fused heads, fused encoder tails
FLAGSHIP_CONFIG = (CONFIG_DIR / "nocs_real" /
                   "aug05_kpsMS_r9d_catreDisR_shared_tspcl_convPerRot_scaleexp_120e_tpu.py")

# subtrees whose children are free-form kwargs (module- or optimizer-specific)
_OPEN_SUBTREES = {"INIT_CFG", "OPTIMIZER_CFG"}
# keys the CLI and the runner put in, not part of the config-file schema
_EXTRA_TOP_KEYS = {"NUM_CHIPS", "STRICT_CFG"}


def _unknown_key_paths(cfg: dict, schema: dict, prefix: str = "") -> list:
    unknown = []
    for k, v in cfg.items():
        if prefix == "" and k in _EXTRA_TOP_KEYS:
            continue
        if k not in schema:
            unknown.append(prefix + k)
            continue
        if k in _OPEN_SUBTREES:
            continue
        sv = schema[k]
        if isinstance(v, dict) and isinstance(sv, dict):
            unknown += _unknown_key_paths(v, sv, prefix + k + ".")
    return unknown


def validate_config(cfg, strict: bool | None = None) -> list:
    """Check the merged config against the base schema
    (`catre_tpu/configs/_base_/catre_base.py`, the typo keys SCLAE_TYPE and
    REFINE_SCLAE included): an unknown key path is warned about, or rejected
    when strict (STRICT_CFG=True or strict=True), since a key that nothing
    reads silently spoils an ablation. -> the unknown dotted key paths."""
    from .loader import load_config

    schema = load_config(str(CONFIG_DIR / "_base_" / "catre_base.py"))
    if strict is None:
        strict = bool(cfg.get("STRICT_CFG", False))
    unknown = _unknown_key_paths(cfg, schema)
    if unknown:
        msg = "unknown config keys (not in the base schema): " + ", ".join(sorted(unknown))
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
    return unknown


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


def _enc_train_ok(cfg, fused_heads_train: bool) -> bool:
    """FUSED_ENCODER_TRAIN rides the fused training delta path, which exists
    only under FUSED_HEADS_TRAIN (and so rot6d); otherwise it is dropped with
    a warning."""
    flag = bool(cfg.MODEL.get("FUSED_ENCODER_TRAIN", False))
    if flag and not fused_heads_train:
        logger.warning("FUSED_ENCODER_TRAIN requires FUSED_HEADS_TRAIN (and rot6d); "
                       "training uses the plain encoder")
        return False
    return flag


def _t(x):
    """Nested lists as tuples, for the hashable dataclass fields."""
    return tuple(_t(v) for v in x) if isinstance(x, (list, tuple)) else x


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
    fht = _fused_ok(cfg.MODEL.get("FUSED_HEADS_TRAIN", False), rot_type)
    mcfg = CATREConfig(
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
        fused_heads_train=fht,
        fused_encoder_train=_enc_train_ok(cfg, fht),
    )
    check_model_limits(mcfg)
    return mcfg


def loss_config_from(cfg) -> LossConfig:
    lc = cfg.MODEL.CATRE.LOSS_CFG
    return LossConfig(
        pm_loss_type=lc.get("PM_LOSS_TYPE", "L1"),
        pm_smooth_l1_beta=float(lc.get("PM_SMOOTH_L1_BETA", 1.0)),
        pm_loss_sym=bool(lc.get("PM_LOSS_SYM", False)),
        pm_r_only=bool(lc.get("PM_R_ONLY", False)),
        pm_with_scale=bool(lc.get("PM_WITH_SCALE", True)),
        pm_disentangle_t=bool(lc.get("PM_DISENTANGLE_T", False)),
        pm_disentangle_z=bool(lc.get("PM_DISENTANGLE_Z", False)),
        pm_t_use_points=bool(lc.get("PM_T_USE_POINTS", True)),
        pm_lw=float(lc.get("PM_LW", 1.0)),
        pm_norm_by_extent=bool(lc.get("PM_NORM_BY_EXTENT", False)),
        rot_loss_type=lc.get("ROT_LOSS_TYPE", "angular"),
        rot_yaxis_loss_type=lc.get("ROT_YAXIS_LOSS_TYPE", "L1"),
        rot_lw=float(lc.get("ROT_LW", 0.0)),
        trans_loss_type=lc.get("TRANS_LOSS_TYPE", "L1"),
        trans_loss_disentangle=bool(lc.get("TRANS_LOSS_DISENTANGLE", True)),
        trans_lw=float(lc.get("TRANS_LW", 0.0)),
        scale_loss_type=lc.get("SCALE_LOSS_TYPE", "L1"),
        scale_lw=float(lc.get("SCALE_LW", 0.0)),
    )


def noise_config_from(cfg) -> InputNoiseConfig:
    inp = cfg.INPUT
    return InputNoiseConfig(
        noise_rot_std=_t(inp.get("NOISE_ROT_STD_TRAIN", (15, 10, 5, 2.5))),
        noise_trans_std=_t(inp.get("NOISE_TRANS_STD_TRAIN")),
        noise_scale_std=_t(inp.get("NOISE_SCALE_STD_TRAIN")),
        noise_rot_max=float(inp.get("NOISE_ROT_MAX_TRAIN", 45)),
        init_trans_min_z=float(inp.get("INIT_TRANS_MIN_Z", 0.1)),
        init_scale_min=float(inp.get("INIT_SCALE_MIN", 0.04)),
        bbox3d_aug_prob=float(inp.get("BBOX3D_AUG_PROB", 0.0)),
        rt_aug_prob=float(inp.get("RT_AUG_PROB", 0.0)),
        init_pose_types=_t(inp.get("INIT_POSE_TYPE_TRAIN", ["gt_noise"])),
        init_scale_types=_t(inp.get("INIT_SCALE_TYPE_TRAIN", ["gt_noise"])),
        random_trans_min=_t(inp.get("RANDOM_TRANS_MIN", (-0.35, -0.35, 0.5))),
        random_trans_max=_t(inp.get("RANDOM_TRANS_MAX", (0.35, 0.35, 1.3))),
        random_scale_min=_t(inp.get("RANDOM_SCALE_MIN", (0.04, 0.04, 0.04))),
        random_scale_max=_t(inp.get("RANDOM_SCALE_MAX", (0.5, 0.3, 0.4))),
        canonical_rot=_t(inp.get("CANONICAL_ROT", ((1, 0, 0, 0.5), (0, 0, 1, -0.7)))),
        canonical_trans=_t(inp.get("CANONICAL_TRANS", (0.0, 0.0, 1.0))),
        canonical_size=_t(inp.get("CANONICAL_SIZE", (0.2, 0.2, 0.2))),
    )


def _mean_table_matches(num_kps: int) -> bool:
    """True when the mean-shape asset exists with `num_kps` points: only
    then may a test loader leave the per-batch mean points out (its consumer
    gathers them on the device from the table)."""
    from ..data.assets import mean_shape_array

    try:
        return mean_shape_array().shape[1] == num_kps
    except FileNotFoundError:
        return False


def loader_config_from(cfg, phase: str = "train") -> LoaderConfig:
    """The loader's LoaderConfig, with the JAX defaults. A train config that
    asks for colour augmentation or background replacement raises: the port
    has neither (ROADMAP item 12c). As in the JAX package no key sets
    `with_nocs` (WITH_NOCS is not in the base schema, which warns about it):
    the NOCS path is asked for on the LoaderConfig itself."""
    inp = cfg.INPUT
    color_aug = float(inp.get("COLOR_AUG_PROB", 0.0))
    change_bg = float(inp.get("CHANGE_BG_PROB", 0.0))
    if phase == "train" and (color_aug > 0 or change_bg > 0):
        raise NotImplementedError(f"INPUT.COLOR_AUG_PROB = {color_aug}, CHANGE_BG_PROB = "
                                  f"{change_bg}: the port's loader has no colour augmentation "
                                  "or background replacement; ROADMAP.md item 12c")
    kps_type = str(inp.get("KPS_TYPE", "mean_shape"))
    num_kps = int(inp.get("NUM_KPS", 1024))
    use_cmra_model = bool(inp.get("USE_CMRA_MODEL", True))
    # USE_CMRA_MODEL on a cmra split ships per-instance priors, which a
    # category table cannot stand in for
    names = (tuple(cfg.DATASETS.get("TEST", ())) if phase == "test" else
             tuple(cfg.DATASETS.get("TRAIN", ())) + tuple(cfg.DATASETS.get("TRAIN2", ())))
    cmra_prior = use_cmra_model and any("cmra" in str(n) for n in names)
    return LoaderConfig(
        num_pcl=int(inp.NUM_PCL),
        depth_sample_ball_ratio=float(inp.get("DEPTH_SAMPLE_BALL_RATIO", 0.5)),
        fps_sample=bool(inp.get("FPS_SAMPLE", False)),
        sample_window=int(inp.get("SAMPLE_WINDOW", 0)),
        aug_depth=bool(inp.get("AUG_DEPTH", False)) and phase == "train",
        drop_depth_prob=float(inp.get("DROP_DEPTH_PROB", 0.5)),
        drop_depth_ratio=float(inp.get("DROP_DEPTH_RATIO", 0.2)),
        add_noise_depth_prob=float(inp.get("ADD_NOISE_DEPTH_PROB", 0.9)),
        add_noise_depth_level=float(inp.get("ADD_NOISE_DEPTH_LEVEL", 0.01)),
        max_objs_per_image=int(cfg.DATALOADER.get("MAX_OBJS_PER_IMAGE", 8)),
        occlude_mask_test=bool(inp.get("OCCLUDE_MASK_TEST", False)),
        kps_type=kps_type,
        num_kps=num_kps,
        use_cmra_model=use_cmra_model,
        cache_decoded=str(cfg.DATALOADER.get("CACHE_DECODED", "")),
        pcl_with_color=bool(inp.get("PCL_WITH_COLOR", False)),
        sampler_train=str(cfg.DATALOADER.get("SAMPLER_TRAIN", "TrainingSampler")),
        repeat_threshold=float(cfg.DATALOADER.get("REPEAT_THRESHOLD", 0.0)),
        init_pose_train_path=(inp.get("INIT_POSE_TRAIN_PATH", "")
                              if "last_frame" in tuple(inp.get("INIT_POSE_TYPE_TRAIN", ()))
                              else ""),
        # fps keypoints never read mean points; cmra per-instance priors must ship
        ship_mean_points=(
            False if kps_type.lower() == "fps" else
            not (phase == "test" and kps_type.lower() == "mean_shape" and not cmra_prior
                 and _mean_table_matches(num_kps))),
    )
