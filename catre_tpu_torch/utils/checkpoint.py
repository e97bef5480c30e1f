"""Checkpoints: the reference's torch layout loaded straight into the port, and
the port's own checkpoints saved and restored with `torch.save`.

Counterpart of `catre_tpu/utils/checkpoint.py`. The reference releases
weight-only torch checkpoints (`model_final_wo_optim-82cf930e.pth`) keyed by
the module structure of `CATRE_disR_shared`:
  pcl_net.{stn,fstn,conv1..4}.*,
  rot_head.rot_head_{x,y}.{layers,neck,conv_p}.*,
  ts_head.{linears,fc_t,fc_s}.*
`state_dict_from_reference` maps them onto `models.catre.CATREDisRShared`
by the key map of `torch_state_dict_to_params` (:77, with `_dense` :27, `_gn`
:39, `_stn` :43 and `_rot_head` :55), taken to the port's names without
going through flax:
  - a Conv1d weight (out, in, 1) becomes (out, in); a Linear keeps its own;
  - a rotation head's `layers` are [conv, GN, GELU] per layer: `layers.0`
    (256, 1088, 1) splits into `layer0_global_weight` (the first 1024
    inputs) and `layer0_point_weight` (the last 64), `layers.1` / `.4` become
    `gns.0` / `.1` and `layers.3` becomes `layers.0`; `neck.0` is `neck`;
    `conv_p.weight` (1, 2048, 1) becomes `point_weight`, `conv_p.bias`
    `point_bias`;
  - the TS head's `linears` are [Linear, GN, GELU] per layer: `linears.0` /
    `.3` become `linears.0` / `.1`, `linears.1` / `.4` become `gns.0` / `.1`;
  - `pcl_net.fstn` is read when the model has one (optional, as at :87).
`load_torch_state_dict` (:118) reads every container the reference's
checkpointer reads. The native half (`save_checkpoint`, `load_checkpoint`,
`latest_step`) stands where the JAX package uses orbax (:175-206): one file
a step in a directory. Over a process group the main process writes it and
every process waits for it (`save_checkpoint` is collective); every process
reads it.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import re
from typing import Any, Mapping

import numpy as np
import torch

from ..parallel import comm

logger = logging.getLogger(__name__)

IN_POINT = 64
FORMAT = "catre_tpu_torch"
_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


# ---- the reference layout

def _tensor(x) -> torch.Tensor:
    """torch tensor or ndarray -> f32 CPU tensor."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _conv(w: torch.Tensor) -> torch.Tensor:
    """Conv1d(k=1) weight (out, in, 1) -> (out, in); a Linear's stays."""
    return w[:, :, 0] if w.dim() == 3 else w


def _ref_key_to_port(key: str, value: torch.Tensor) -> list:
    """One reference key -> [(port key, tensor)], or [] for a key the port
    does not read."""
    m = re.fullmatch(r"(rot_head\.rot_head_[xy])\.(layers\.(\d+)|neck\.0|conv_p)\.(weight|bias)",
                     key)
    if m:
        head, part, idx, kind = m[1], m[2], m[3], m[4]
        if part == "conv_p":
            return [(f"{head}.point_weight", value.reshape(-1)) if kind == "weight"
                    else (f"{head}.point_bias", value.reshape(-1))]
        if part == "neck.0":
            return [(f"{head}.neck.{kind}", _conv(value) if kind == "weight" else value)]
        layer, slot = divmod(int(idx), 3)
        if slot == 1:
            return [(f"{head}.gns.{layer}.{kind}", value)]
        if slot != 0:
            return []
        if layer > 0:
            return [(f"{head}.layers.{layer - 1}.{kind}",
                     _conv(value) if kind == "weight" else value)]
        if kind == "bias":
            return [(f"{head}.layer0_bias", value)]
        w = _conv(value)
        n_global = w.shape[1] - IN_POINT
        return [(f"{head}.layer0_global_weight", w[:, :n_global]),
                (f"{head}.layer0_point_weight", w[:, n_global:])]
    m = re.fullmatch(r"ts_head\.linears\.(\d+)\.(weight|bias)", key)
    if m:
        layer, slot = divmod(int(m[1]), 3)
        if slot == 0:
            return [(f"ts_head.linears.{layer}.{m[2]}", value)]
        return [(f"ts_head.gns.{layer}.{m[2]}", value)] if slot == 1 else []
    if re.fullmatch(r"(pcl_net\.((stn|fstn)\.)?(conv\d|fc\d)|ts_head\.fc_[ts])\.(weight|bias)",
                    key):
        return [(key, _conv(value))]
    return []


def state_dict_from_reference(sd: Mapping[str, Any], model: torch.nn.Module) -> dict:
    """A reference-layout state dict (torch tensors or numpy arrays, a DDP
    `module.` prefix allowed) -> a state dict for `model` (f32 CPU tensors).
    Raises on a parameter of `model` left unfilled or on a shape mismatch;
    warns and lists the reference keys it did not read."""
    sd = _strip_ddp_prefix(sd)
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out, unread = {}, []
    for key, value in sd.items():
        converted = [(k, v) for k, v in _ref_key_to_port(str(key), _tensor(value))
                     if k in expected]
        if not converted:
            unread.append(str(key))
        for k, v in converted:
            if k in out:
                raise ValueError(f"two reference keys map to {k}")
            if tuple(v.shape) != expected[k]:
                raise ValueError(f"{key} -> {k}: shape {tuple(v.shape)}, the model expects "
                                 f"{expected[k]}")
            out[k] = v.contiguous()
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"parameters of the model not filled by the checkpoint: {missing}")
    if unread:
        logger.warning("reference checkpoint keys not read: %s", sorted(unread))
    return out


def _strip_ddp_prefix(sd: Mapping[str, Any]) -> Mapping[str, Any]:
    """Drop a uniform 'module.' prefix (DDP-saved state dicts; the reference
    strips it with consume_prefix_in_state_dict_if_present,
    `my_checkpoint.py:76-79`)."""
    keys = [k for k in sd.keys() if isinstance(k, str)]
    if keys and all(k.startswith("module.") for k in keys):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def load_torch_state_dict(path: str) -> Mapping[str, Any]:
    """A reference-format checkpoint container -> a flat state dict, as
    `core/utils/my_checkpoint.py:48-84` (`_load_file`) reads it: torch .pth
    (bare or {'model': ...}), detectron2 model-zoo .pkl ({'model',
    '__author__'}), Caffe2 / Detectron1 .pkl ('blobs', with `_momentum`
    entries and `weight_order` pruned), `torchvision://` names and http(s)
    URLs (through torch.hub's checkpoint cache)."""
    import pickle

    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        if "model" in data and "__author__" in data:
            sd = data["model"]
        else:
            if "blobs" in data:
                data = data["blobs"]
            sd = {k: v for k, v in data.items() if not str(k).endswith("_momentum")}
            sd.pop("weight_order", None)
    elif path.startswith("torchvision://"):
        try:
            import torchvision.models as tvm
        except ImportError as e:
            raise RuntimeError(
                "torchvision:// checkpoints need torchvision installed "
                "(the reference resolves them through mmcv's torchvision "
                "model zoo, my_checkpoint.py:70-71)") from e
        weights = tvm.get_model_weights(path[len("torchvision://"):]).DEFAULT
        sd = torch.hub.load_state_dict_from_url(weights.url, map_location="cpu")
    elif path.startswith(("http://", "https://")):
        sd = torch.hub.load_state_dict_from_url(path, map_location="cpu")
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "model" in ckpt and not any("." in k for k in ckpt):
            sd = ckpt["model"]
        else:
            sd = ckpt
    return _strip_ddp_prefix(sd)


def load_reference_checkpoint(path: str, model: torch.nn.Module) -> dict:
    """A reference checkpoint in any container -> a state dict for `model`."""
    return state_dict_from_reference(load_torch_state_dict(path), model)


# ---- native checkpoints

def _state_of(value):
    if isinstance(value, torch.Generator):
        return value.get_state()
    return value.state_dict() if hasattr(value, "state_dict") else value


def _step_files(ckpt_dir: str) -> dict:
    """step -> path of the port's checkpoints in `ckpt_dir`."""
    if not osp.isdir(ckpt_dir):
        return {}
    out = {}
    for name in os.listdir(ckpt_dir):
        m = _STEP_FILE.fullmatch(name)
        if m:
            out[int(m[1])] = osp.join(ckpt_dir, name)
    return out


def save_checkpoint(ckpt_dir: str, step: int, state: Mapping[str, Any], keep: int = 5) -> str:
    """Write `state` as `ckpt_dir/step_<step>.pt` and keep the newest `keep`
    steps. `state` holds "model" (a module or its state dict) and, when
    given, "optimizer" (any optimizer of `solver.build` or its state dict:
    moments, counts, Lookahead slow copies and the Lookahead layers' own, a
    registry transform's state of a rotation head's layer-0 pair under
    `layer0_global_weight`), "generator" (a CPU `torch.Generator` or its
    state) and any other picklable entry. Over a process group only the main
    process writes, and every process returns once the file is there. ->
    the file's path."""
    path = osp.join(ckpt_dir, f"step_{int(step):08d}.pt")
    if comm.is_main_process():
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = {"format": FORMAT, "step": int(step)}
        payload.update({k: _state_of(v) for k, v in state.items()})
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        files = _step_files(ckpt_dir)
        for old in sorted(files)[:-keep] if keep > 0 else []:
            os.remove(files[old])
    comm.synchronize()
    return path


def latest_step(ckpt_dir: str) -> int | None:
    steps = _step_files(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int | None = None) -> dict:
    """The checkpoint of `step` (default the latest) in `ckpt_dir`: a dict
    with "step", "model" (a state dict on the CPU) and whatever else was
    saved. Raises FileNotFoundError when the directory holds none; a
    directory with other content (an orbax checkpoint of the JAX package,
    say) is named as such."""
    steps = _step_files(ckpt_dir)
    if not steps:
        other = sorted(os.listdir(ckpt_dir)) if osp.isdir(ckpt_dir) else []
        hint = (f"; it holds {other[:5]}: an orbax checkpoint of the JAX package is not read "
                f"here, converting it is ROADMAP item 14b") if other else ""
        raise FileNotFoundError(f"no checkpoint of the port in {ckpt_dir}{hint}")
    if step is None:
        step = max(steps)
    if step not in steps:
        raise FileNotFoundError(f"no checkpoint of step {step} in {ckpt_dir} (steps "
                                f"{sorted(steps)})")
    ckpt = torch.load(steps[step], map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{steps[step]} is not a checkpoint of the port")
    return ckpt
