"""Seeded weights of a configuration, made on the device in two large draws.

The law: the PointNet's layers as PyTorch initialises a Conv1d / Linear
(uniform within 1/sqrt(fan in), weights and biases); the heads' layers
N(0, 0.001) and their outputs fc_t / fc_s N(0, 0.01), as CATRE's
`normal_init`; GroupNorm at 1 and 0. The heads' output biases hold the
identity delta (rot6d x (1, 0, 0) and y (0, 1, 0), cosypose translation
(0, 0, 1), scale 0) and each point weight averages 1 / (P + K) around its
N(0, 0.001): a refiner near its fixed point, whose random part moves a pose
by about a degree and a depth by about a tenth an iteration. At the
initialisation alone every delta is near 0, the cosypose depth collapses to
0 and the next iteration divides by it.
"""

from __future__ import annotations

import math

import torch

_SALT = 0x5EED_3A7   # the weights' stream, apart from the traffic's


def _fan_in(name: str, shapes: dict) -> int:
    return shapes[name.rsplit(".", 1)[0] + ".weight"][1]


def make_weights(shapes: dict, seed: int, device) -> dict:
    """name -> float32 tensor on `device` for every name of `shapes`."""
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ _SALT) % (2 ** 63))
    total = sum(math.prod(s) for s in shapes.values())
    uniform = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u, z = uniform[at:at + n].reshape(shape), normal[at:at + n].reshape(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("pcl_net."):
            out[name] = u / math.sqrt(_fan_in(name, shapes))
        elif ".gns." in name:
            out[name] = torch.ones(shape, device=device) if leaf == "weight" else z * 0.0
        elif leaf == "point_weight":
            out[name] = 1.0 / shape[0] + 0.001 * z
        elif leaf.endswith("weight"):
            out[name] = z * (0.01 if ".fc_" in name else 0.001)
        else:
            out[name] = torch.zeros(shape, device=device)
    out["ts_head.fc_t.bias"][2] = 1.0
    out["rot_head.rot_head_x.neck.bias"][0] = 1.0
    out["rot_head.rot_head_y.neck.bias"][1] = 1.0
    return {n: v.contiguous() for n, v in out.items()}


def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into the model's parameters, which must be exactly
    these names and shapes."""
    params = dict(model.named_parameters())
    if {n: tuple(p.shape) for n, p in params.items()} != \
            {n: tuple(v.shape) for n, v in weights.items()}:
        raise ValueError("the program's parameters are not the configuration's: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
