"""The port's command line (`catre_tpu_torch/main.py`) and config surface
(`config/loader.py`, `config/build.py`) against the JAX package's.

- `apply_overrides`, `Config.get_path` and `dump_config` give JAX's output on
  the same inputs; the three shipped configs validate clean under
  STRICT_CFG, an unknown key is rejected and every consumed key accepted
  (`tests/test_cli.py`, `tests/test_config_surface.py`).
- `main([... "--eval-only", "--device", "cpu", ...])` scores a written split
  from a checkpoint of the port and writes `config_dump.py`, `log.txt` and
  `predictions.pkl`; with --num-machines 2 or --num-chips 2, training or
  not, it raises and names the ROADMAP item; on a host without a
  card the default device raises; on a host with four, the default command
  line runs on one and --num-chips 0 raises.
- The kernels' shape limits: a config whose fused flags ask for a width the
  kernels refuse raises in `model_config_from`, naming the flag and the
  limit; the shipped configs build."""

import dataclasses
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from catre_tpu.config.build import validate_config as jax_validate_config
from catre_tpu.config.loader import apply_overrides as jax_apply_overrides
from catre_tpu.config.loader import dump_config as jax_dump_config
from catre_tpu.config.loader import load_config as jax_load_config
from catre_tpu.main import my_default_argument_parser as jax_parser
from catre_tpu_torch import main as tmain
from catre_tpu_torch.config.build import (CONFIG_DIR, FLAGSHIP_CONFIG, model_config_from,
                                          validate_config)
from catre_tpu_torch.config.loader import apply_overrides, dump_config, load_config
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.data import nocs as tnocs
from catre_tpu_torch.engine import runner as trunner
from catre_tpu_torch.entry import flagship_config, write_example_split
from catre_tpu_torch.models.catre import init_model
from catre_tpu_torch.ops.limits import check_model_limits
from catre_tpu_torch.utils.checkpoint import latest_step, save_checkpoint

SHIPPED = sorted(str(p) for p in (CONFIG_DIR / "nocs_real").glob("*.py"))
OVERRIDES = ["SOLVER.IMS_PER_BATCH=4", "MODEL.WEIGHTS='x.pth'", "MODEL.WEIGHTS2=x.pth",
             "INPUT.NOISE_ROT_STD_TRAIN=(5,2.5)", "DEBUG=True", "NEW.SUB.KEY=[1, 'a']",
             "TEST.IMS_PER_BATCH=8", "MODEL.CATRE.ROT_HEAD.SCLAE_TYPE=iter_mul"]
TABLE = np.random.default_rng(11).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1


@pytest.mark.parametrize("path", SHIPPED, ids=os.path.basename)
def test_overrides_and_dump_match_jax(path, tmp_path):
    ours = apply_overrides(load_config(path), OVERRIDES)
    ref = jax_apply_overrides(jax_load_config(path), OVERRIDES)
    assert ours == ref
    assert ours.get_path("MODEL.CATRE.ROT_HEAD.SCLAE_TYPE") == "iter_mul"
    assert ours.get_path("NEW.SUB.KEY") == [1, "a"] and ours.NEW.SUB.KEY == [1, "a"]
    assert ours.get_path("MODEL.NOPE", 7) == ref.get_path("MODEL.NOPE", 7) == 7
    dump_config(ours, str(tmp_path / "ours.py"))
    jax_dump_config(ref, str(tmp_path / "ref.py"))
    assert (tmp_path / "ours.py").read_text() == (tmp_path / "ref.py").read_text()
    with pytest.raises(ValueError, match="KEY=VALUE"):
        apply_overrides(ours, ["MODEL.BF16"])


@pytest.mark.parametrize("path", SHIPPED, ids=os.path.basename)
def test_shipped_configs_validate_clean_and_build(path):
    cfg = load_config(path)
    assert validate_config(cfg, strict=True) == [] == jax_validate_config(
        jax_load_config(path), strict=True)
    model_config_from(cfg)


def test_strict_mode_rejects_unknown_and_accepts_consumed_keys():
    cfg = load_config(str(FLAGSHIP_CONFIG))
    cfg["MODEL"]["CATRE"]["LOSS_CFG"]["PM_TYPO_LW"] = 1.0
    with pytest.raises(ValueError, match="PM_TYPO_LW"):
        validate_config(cfg, strict=True)
    assert validate_config(cfg, strict=False) == ["MODEL.CATRE.LOSS_CFG.PM_TYPO_LW"]
    cfg = load_config(str(FLAGSHIP_CONFIG))
    apply_overrides(cfg, ["STRICT_CFG=True", "NUM_CHIPS=1", "OPTIMIZER_CFG_X=1"])
    with pytest.raises(ValueError, match="OPTIMIZER_CFG_X"):
        validate_config(cfg)
    cfg = load_config(str(FLAGSHIP_CONFIG))
    consumed = ["MODEL.FUSED_HEADS=True", "MODEL.FUSED_HEADS_TRAIN=True",
                "MODEL.FUSED_ENCODER_EPILOGUE=False", "TEST.IMS_PER_BATCH=8",
                "TRAIN.PROFILE_ITERS=3", "MODEL.BF16=True", "INPUT.USE_CMRA_MODEL=False",
                "INPUT.COLOR_AUG_SYN_ONLY=True", "INPUT.BP_DEPTH=True",
                "DATALOADER.FILTER_EMPTY_DETS=False", "INPUT.KPS_TYPE=fps", "INPUT.NUM_KPS=32",
                "VAL.EVAL_CACHED=True", "TEST.SAVE_RESULTS_ONLY=True", "DATASETS.DET_THR=0.3",
                "MODEL.CATRE.PCLNET.INIT_CFG.anything=1", "SOLVER.OPTIMIZER_CFG.betas=(0.9, 0.99)",
                "MODEL.REFINE_SCLAE=False", "MODEL.CATRE.ROT_HEAD.SCLAE_TYPE=iter_mul"]
    apply_overrides(cfg, consumed)
    assert validate_config(cfg, strict=True) == []


def test_argparser_matches_jax():
    argv = ["--config-file", "x.py", "--eval-only", "--num-chips", "1", "--fp16-allreduce",
            "MODEL.WEIGHTS=a.pth", "SOLVER.IMS_PER_BATCH=2"]
    ours, ref = tmain.my_default_argument_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert {k: v for k, v in vars(ours).items() if k != "device"} == vars(ref)
    assert ours.device == "cuda"
    assert tmain.my_default_argument_parser().parse_args(
        ["--config-file", "x.py", "--device", "cpu"]).device == "cpu"


# ---- the CLI on a written split

@pytest.fixture()
def cli_env(tmp_path, monkeypatch):
    """A written split under the shipped config's dataset name, the seeded
    mean-shape table, and a checkpoint of the port (seed 3, f32, 64 points)."""
    tl.clear_decoded_caches()
    (tmp_path / "split").mkdir()
    recs = write_example_split(str(tmp_path / "split"), 5, h=96, w=128, m=4, seed=2)
    monkeypatch.setitem(tnocs._DATASET_REGISTRY, "nocs_test_real", lambda: [dict(r) for r in recs])
    monkeypatch.setattr(tassets, "mean_shape_array", lambda *a, **k: TABLE)
    cfg = apply_overrides(load_config(str(FLAGSHIP_CONFIG)), ["INPUT.NUM_PCL=64"])
    model = init_model(model_config_from(cfg), seed=3)
    save_checkpoint(str(tmp_path / "ckpt"), 12, {"model": model})
    yield tmp_path, recs, model
    tl.clear_decoded_caches()
    for h in tmain._HANDLERS:            # the log file of the run
        logging.getLogger().removeHandler(h)
        h.close()
    tmain._HANDLERS.clear()


def _argv(tmp_path, *extra, eval_only=True):
    return ["--config-file", str(FLAGSHIP_CONFIG), *(["--eval-only"] if eval_only else []),
            "--device", "cpu", *extra, f"OUTPUT_DIR={tmp_path / 'out'}",
            f"MODEL.WEIGHTS={tmp_path / 'ckpt'}", "MODEL.LOAD_POSES_TEST=False",
            "INPUT.NUM_PCL=64", "MODEL.CATRE.N_ITER_TEST=2", "TEST.IMS_PER_BATCH=2",
            "DATALOADER.MAX_OBJS_PER_IMAGE=4", "DATALOADER.NUM_WORKERS=0", "SEED=-1"]


def test_cli_eval_only_scores_the_split(cli_env):
    tmp_path, recs, model = cli_env
    out = tmain.main(_argv(tmp_path))
    res = out["nocs_test_real"]
    files = set(os.listdir(tmp_path / "out"))
    assert {"config_dump.py", "log.txt", "predictions.pkl"} <= files
    assert "metrics_tab_iter2.txt" in files
    assert "weights loaded" in (tmp_path / "out" / "log.txt").read_text()
    dumped = (tmp_path / "out" / "config_dump.py").read_text()
    assert "'NUM_PCL': 64" in dumped and "'SEED': -1" not in dumped     # the clock's seed
    with open(tmp_path / "out" / "predictions.pkl", "rb") as f:
        preds = pickle.load(f)
    assert len(preds) == 3 and sorted(preds[0]) == sorted(r["scene_im_id"] for r in recs)
    assert sorted(res["results"]) == [0, 1, 2] and res["stats"]["load_s"] > 0
    # iteration 0 is the split's init (= gt): 100 on IoU50 for the classes present
    present = sorted({a["category_id"] + 1 for r in recs for a in r["annotations"]})
    assert all(res["results"][0]["iou_aps"][c, 2] == 1.0 for c in present)
    assert latest_step(str(tmp_path / "ckpt")) == 12


@pytest.mark.parametrize("extra, eval_only, match", [
    # training on several devices (the case keeps its id)
    pytest.param(("--num-chips", "2"), False, "item 14", id="extra0-False-item 13b"),
    (("--num-machines", "2"), True, "item 14"),
    (("--dist-url", "tcp://localhost:23456"), True, "item 14"),
    (("--num-chips", "2"), True, "item 14"),
])
def test_cli_refusals_name_their_item(cli_env, extra, eval_only, match):
    tmp_path = cli_env[0]
    with pytest.raises(NotImplementedError, match=match):
        tmain.main(_argv(tmp_path, *extra, eval_only=eval_only))


class _PastTheCheck(Exception):
    pass


@pytest.mark.parametrize("num_chips, refused", [((), False), (("--num-chips", "1"), False),
                                                (("--num-chips", "0"), True),
                                                (("--num-chips", "2"), True)])
def test_cli_default_runs_on_one_of_several_cards(cli_env, monkeypatch, num_chips, refused):
    """On a host with four cards the default command line evaluates on one;
    --num-chips 0 (every card) or 2 names item 14."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def build_model(*a, **k):
        raise _PastTheCheck

    monkeypatch.setattr(trunner, "build_model", build_model)
    argv = [a for a in _argv(cli_env[0], *num_chips) if a not in ("--device", "cpu")]
    if refused:
        with pytest.raises(NotImplementedError, match="item 14"):
            tmain.main(argv)
    else:
        with pytest.raises(_PastTheCheck):
            tmain.main(argv)


def test_cli_default_device_needs_a_card(cli_env):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    argv = [a for a in _argv(cli_env[0]) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA card"):
        tmain.main(argv)


# ---- the kernels' shape limits

REFUSED = {  # flag -> (overrides, the limit the message names)
    "MODEL.FUSED_HEADS": (["MODEL.FUSED_HEADS_TRAIN=False", "MODEL.FUSED_ENCODER_TRAIN=False",
                           "MODEL.CATRE.ROT_HEAD.INIT_CFG.feat_dim=128"], "1024 + 64 -> 256"),
    "MODEL.FUSED_HEADS_TRAIN": (["MODEL.FUSED_HEADS=False",
                                 "MODEL.CATRE.ROT_HEAD.INIT_CFG.num_gn_groups=16"], "GN 32"),
    "MODEL.FUSED_ENCODER_EPILOGUE": (["MODEL.FUSED_HEADS_TRAIN=False",
                                      "MODEL.FUSED_ENCODER_TRAIN=False",
                                      "MODEL.CATRE.PCLNET.INIT_CFG.out_dim=1000"],
                                     "multiples of 64 -> 128"),
    "MODEL.FUSED_ENCODER_TRAIN": (["MODEL.FUSED_HEADS=False", "INPUT.NUM_PCL=70000"],
                                  "rows 0 .. 65535"),
}


@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_refused_widths_raise_in_model_config_from(flag):
    opts, limit = REFUSED[flag]
    cfg = apply_overrides(load_config(str(FLAGSHIP_CONFIG)), opts)
    with pytest.raises(ValueError) as e:
        model_config_from(cfg)
    assert f"set {flag}=False" in str(e.value) and limit in str(e.value)
    apply_overrides(cfg, [f"{flag}=False"])
    if flag == "MODEL.FUSED_ENCODER_EPILOGUE":    # out_dim 1000 also leaves K3's 1024 inputs
        apply_overrides(cfg, ["MODEL.FUSED_HEADS=False"])
    model_config_from(cfg)


def test_bf16_tail_width_and_k9_limits():
    cfg = apply_overrides(load_config(str(FLAGSHIP_CONFIG)), [
        "MODEL.FUSED_HEADS=False", "MODEL.FUSED_HEADS_TRAIN=False",
        "MODEL.CATRE.PCLNET.INIT_CFG.out_dim=4224"])
    model_config_from(cfg)                      # the tails are off with the rot head kernel
    mcfg = dataclasses.replace(model_config_from(cfg), fused_heads=True)
    with pytest.raises(ValueError, match="exceed 128->512->4096"):
        check_model_limits(dataclasses.replace(mcfg, pclnet_out_dim=4224, rot_feat_dim=256))
    with pytest.raises(ValueError, match="K9"):
        check_model_limits(dataclasses.replace(mcfg, fused_encoder=True, pclnet_out_dim=1000))
    # fused_encoder is set on the CATREConfig, and checked there
    with pytest.raises(ValueError, match="set fused_encoder=False") as e:
        flagship_config(fused_encoder=True, pclnet_out_dim=1000)
    assert "multiples of 64, 128, 128" in str(e.value)
    flagship_config(fused_encoder=True)
