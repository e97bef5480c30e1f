"""Carry JAX (flax) parameters across to the port.

Counterpart of the converter half of `catre_tpu/utils/checkpoint.py`
(`torch_state_dict_to_params` :77, which goes the other way, from the
reference's torch layout to flax). Here a flax parameter tree of numpy
arrays becomes a state dict of `models.catre.CATREDisRShared`:
  - a flax Dense kernel is (in, out): transposed to (out, in);
  - a flax GroupNorm `scale` is the port's `weight`;
  - a rotation head's `layer0_kernel` (1024 + 64, 256) splits into rows
    [:1024] (`layer0_global_weight`) and [1024:] (`layer0_point_weight`);
  - `point_weight` is (2048,), `point_bias_param` (1,) becomes `point_bias`;
  - `linear{i}`/`gn{i}` of the TS head become `linears.{i}`/`gns.{i}`, and a
    rotation head's `layer{i}` (i >= 1) becomes `layers.{i-1}`.
Every leaf must be consumed and every port parameter filled, with matching
shapes; otherwise `params_from_jax` raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

IN_POINT = 64


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _module_name(parts) -> str:
    out = []
    for i, name in enumerate(parts):
        parent = parts[i - 1] if i else ""
        m = re.fullmatch(r"(linear|layer|gn)(\d+)", name)
        if m and parent == "ts_head":
            out.append(f"{'linears' if m[1] == 'linear' else 'gns'}.{m[2]}")
        elif m and parent.startswith("rot_head_"):
            idx = int(m[2])
            out.append(f"layers.{idx - 1}" if m[1] == "layer" else f"gns.{idx}")
        else:
            out.append(name)
    return ".".join(out)


def _convert_leaf(path, leaf):
    """-> list of (port key, array) for one flax leaf."""
    *mod, last = path
    if len(mod) >= 1 and mod[-1] == "Dense_0":
        name = _module_name(mod[:-1])
        if last == "kernel":
            return [(f"{name}.weight", leaf.T)]
        if last == "bias":
            return [(f"{name}.bias", leaf)]
    name = _module_name(mod)
    if last == "scale":
        return [(f"{name}.weight", leaf)]
    if last == "bias":
        return [(f"{name}.bias", leaf)]
    if last == "layer0_kernel":
        n_global = leaf.shape[0] - IN_POINT
        return [(f"{name}.layer0_global_weight", leaf[:n_global].T),
                (f"{name}.layer0_point_weight", leaf[n_global:].T)]
    if last in ("layer0_bias", "point_weight"):
        return [(f"{name}.{last}", leaf)]
    if last == "point_bias_param":
        return [(f"{name}.point_bias", leaf)]
    return []


def params_from_jax(tree: dict, model: torch.nn.Module) -> dict:
    """flax parameter tree (nested dicts of arrays) -> state dict for `model`
    (f32 CPU tensors). Raises on an unconsumed leaf, an unfilled parameter or
    a shape mismatch."""
    expected = {k: v.shape for k, v in model.state_dict().items()}
    sd, unconsumed = {}, []
    for path, leaf in _flatten(tree):
        converted = [(k, a) for k, a in _convert_leaf(path, leaf) if k in expected]
        if not converted:
            unconsumed.append("/".join(path))
        for key, arr in converted:
            if key in sd:
                raise ValueError(f"two flax leaves map to {key}")
            if tuple(arr.shape) != tuple(expected[key]):
                raise ValueError(f"{'/'.join(path)} -> {key}: shape {arr.shape}, "
                                 f"port expects {tuple(expected[key])}")
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(expected) - set(sd))
    if unconsumed or missing:
        raise ValueError(f"flax leaves not consumed: {unconsumed}; port parameters "
                         f"not filled: {missing}")
    return sd
