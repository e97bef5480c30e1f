"""What both drivers share: the port's config read from its file and held
to the configuration's sizes, and the weights made for it."""

from __future__ import annotations

import dataclasses

import torch

from ..harness import ROOT

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def port_config(cell):
    """The port's config tree of the cell's configuration, with the point
    counts of `model` (which only the tests shrink), after checking that
    what the port reads from it is what the configuration's file states."""
    from catre_tpu_torch.config.build import (loss_config_from, model_config_from,
                                              noise_config_from)
    from catre_tpu_torch.config.loader import load_config

    c = cell.config
    cfg = load_config(str(ROOT / c["port_config"]))
    cfg.INPUT.NUM_PCL, cfg.INPUT.NUM_KPS = c["model"]["num_pcl"], c["model"]["num_kps"]
    mcfg = model_config_from(cfg)
    got = {"model": {k: getattr(mcfg, k) for k in c["port"]},
           "loss": dataclasses.asdict(loss_config_from(cfg)),
           "noise": dataclasses.asdict(noise_config_from(cfg)),
           "solver": dict(cfg.SOLVER.OPTIMIZER_CFG)}
    got["model"]["dtype"] = next(k for k, v in _DTYPES.items() if v == mcfg.dtype)
    want = {"model": c["port"], "loss": c["loss"],
            "noise": {k: v for k, v in c["noise"].items() if k != "max_sym_disc_step"},
            "solver": {k: c["solver"][k] for k in got["solver"]}}
    sizes = {"pclnet_out_dim": mcfg.pclnet_out_dim, "rot_feat_dim": mcfg.rot_feat_dim,
             "rot_num_layers": mcfg.rot_num_layers, "rot_num_gn_groups": mcfg.rot_num_gn_groups,
             "ts_feat_dim": mcfg.ts_feat_dim, "ts_num_layers": mcfg.ts_num_layers,
             "ts_num_gn_groups": mcfg.ts_num_gn_groups,
             "n_iter": int(cfg.MODEL.CATRE.N_ITER_TEST),
             "n_iter_train": int(cfg.MODEL.CATRE.N_ITER_TRAIN),
             "max_sym_disc_step": float(cfg.INPUT.MAX_SYM_DISC_STEP)}
    stated = {**c["model"], "max_sym_disc_step": c["noise"]["max_sym_disc_step"]}
    mismatch = [f"{k}: port {sizes[k]!r}, file {stated[k]!r}" for k in sizes
                if sizes[k] != stated[k]]
    for section, values in want.items():
        for k, v in values.items():
            g = got[section].get(k)
            if _plain(g) != _plain(v):
                mismatch.append(f"{section}.{k}: port {g!r}, file {v!r}")
    if mismatch:
        raise RuntimeError(f"{c['port_config']} is not the configuration {c['name']}: "
                           + "; ".join(mismatch))
    return cfg


def _plain(v):
    """Tuples and lists alike, numbers as floats, for comparing a config
    with its JSON file."""
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    return float(v)


def control_mode(cell) -> str:
    """The control's precision: the one next below the configuration's."""
    return "fp8" if cell.config["port"]["dtype"] == "bfloat16" else "tf32"


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
