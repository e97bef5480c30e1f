"""NOCS / CAMERA dataset metadata: category names and ids, camera
intrinsics, per-category mean scales, symmetry info, the instance -> category
map and the asset paths.

A jax-free copy of `catre_tpu/data/meta.py` (numpy only), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

# ---------------------------------------------------------------- paths
def set_data_root(root: str) -> None:
    """Point every asset and dataset path below at `root` (by default the
    CATRE_DATA_ROOT environment variable, else `datasets/` of the checkout).
    Readers look the paths up here when they are called, so this may run
    after the port is imported."""
    global DATA_ROOT, NOCS_ROOT, MODEL_DIR, CR_MEAN_MODEL_PATH, TRAIN_MODEL_PATH, \
        TEST_MODEL_PATH, ABS_SCALE_PATH, MUG_META_PATH, MUG_HANDLE_PATH, FPS_POINTS_PATH
    DATA_ROOT = root
    NOCS_ROOT = osp.join(DATA_ROOT, "NOCS")
    MODEL_DIR = osp.join(NOCS_ROOT, "obj_models")
    CR_MEAN_MODEL_PATH = osp.join(MODEL_DIR, "cr_normed_mean_model_points_spd.pkl")
    TRAIN_MODEL_PATH = osp.join(MODEL_DIR, "real_train_spd.pkl")
    TEST_MODEL_PATH = osp.join(MODEL_DIR, "real_test_spd.pkl")
    ABS_SCALE_PATH = osp.join(MODEL_DIR, "abs_scale.pkl")
    MUG_META_PATH = osp.join(MODEL_DIR, "mug_meta.pkl")
    MUG_HANDLE_PATH = osp.join(MODEL_DIR, "mug_handle.pkl")
    FPS_POINTS_PATH = osp.join(MODEL_DIR, "fps_points_spd.pkl")


set_data_root(os.environ.get("CATRE_DATA_ROOT", osp.join(osp.dirname(__file__), "../../datasets")))

# ---------------------------------------------------------------- objects
OBJECTS = ["bottle", "bowl", "camera", "can", "laptop", "mug"]
OBJ2ID = {"bottle": 1, "bowl": 2, "camera": 3, "can": 4, "laptop": 5, "mug": 6}
ID2OBJ = {v: k for k, v in OBJ2ID.items()}
SYNSET_NAMES = ["BG"] + OBJECTS  # eval protocol class list (test_utils.py:762)

INST2OBJ = {
    # test insts
    "bottle_red_stanford_norm": "bottle",
    "bottle_shampoo_norm": "bottle",
    "bottle_shengjun_norm": "bottle",
    "bowl_blue_white_chinese_norm": "bowl",
    "bowl_shengjun_norm": "bowl",
    "bowl_white_small_norm": "bowl",
    "camera_canon_len_norm": "camera",
    "camera_canon_wo_len_norm": "camera",
    "camera_shengjun_norm": "camera",
    "can_arizona_tea_norm": "can",
    "can_green_norm": "can",
    "can_lotte_milk_norm": "can",
    "laptop_air_xin_norm": "laptop",
    "laptop_alienware_norm": "laptop",
    "laptop_mac_pro_norm": "laptop",
    "mug_anastasia_norm": "mug",
    "mug_brown_starbucks_norm": "mug",
    "mug_daniel_norm": "mug",
    # train insts
    "bottle3_scene5_norm": "bottle",
    "bottle_blue_google_norm": "bottle",
    "bottle_starbuck_norm": "bottle",
    "bowl_blue_ikea_norm": "bowl",
    "bowl_brown_ikea_norm": "bowl",
    "bowl_chinese_blue_norm": "bowl",
    "camera_anastasia_norm": "camera",
    "camera_dslr_len_norm": "camera",
    "camera_dslr_wo_len_norm": "camera",
    "can_milk_wangwang_norm": "can",
    "can_porridge_norm": "can",
    "can_tall_yellow_norm": "can",
    "laptop_air_0_norm": "laptop",
    "laptop_air_1_norm": "laptop",
    "laptop_dell_norm": "laptop",
    "mug2_scene3_norm": "mug",
    "mug_vignesh_norm": "mug",
    "mug_white_green_norm": "mug",
}

# ---------------------------------------------------------------- cameras
# REAL275 intrinsics (`ref/nocs.py:103`)
REAL_INTRINSICS = np.array(
    [[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], dtype=np.float32
)
# CAMERA25 synthetic intrinsics (`ref/cmra.py:48`)
CMRA_INTRINSICS = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]], dtype=np.float32)
IM_WIDTH, IM_HEIGHT = 640, 480

# per-category mean scale in meters (`ref/nocs.py:105-112`)
MEAN_SCALE = {
    "bottle": 0.001 * np.array([87, 220, 89], dtype=np.float32),
    "bowl": 0.001 * np.array([165, 80, 165], dtype=np.float32),
    "camera": 0.001 * np.array([88, 128, 156], dtype=np.float32),
    "can": 0.001 * np.array([68, 146, 72], dtype=np.float32),
    "laptop": 0.001 * np.array([346, 200, 335], dtype=np.float32),
    "mug": 0.001 * np.array([146, 83, 114], dtype=np.float32),
}


def mean_scales_array() -> np.ndarray:
    """(6, 3) mean scales indexed by 0-based category id."""
    return np.stack([MEAN_SCALE[ID2OBJ[i + 1]] for i in range(6)])


def get_sym_info(obj_name: str, mug_handle: int = 1):
    """y-axis symmetry axis or None (`ref/nocs.py:138-158`)."""
    if obj_name in ("bottle", "bowl", "can"):
        return np.array([0, 1, 0], dtype=np.int64)
    if obj_name == "mug" and mug_handle != 1:
        return np.array([0, 1, 0], dtype=np.int64)
    return None


def sym_flag(obj_name: str, mug_handle: int = 1) -> bool:
    return get_sym_info(obj_name, mug_handle) is not None


def is_sym_class_for_eval(class_name: str, handle_visibility) -> bool:
    """Eval-protocol symmetry (`test_utils.py:178-182`): bottle/bowl/can
    always; mug only when the handle is not visible."""
    if class_name in ("bottle", "bowl", "can"):
        return True
    return class_name == "mug" and int(handle_visibility) == 0
