"""CATRE's refiner in plain PyTorch, float32: the judge of the benchmark.

The network of CATRE's NOCS_REAL recipe (`aug05_kpsMS_r9d_catreDisR_shared_
tspcl_convPerRot_scaleexp_120e`): a PointNet (STN3d, conv1, STNkd, conv2-4,
no BatchNorm) shared by the observed cloud and the prior keypoints posed by
the current estimate, a rotation head per axis (layer 0 on [global feature,
point feature] of every point, GroupNorm, exact GELU, a second such layer,
a neck to 3 values, a learned weighted sum over all points), a translation
and size head on [global feature, max point feature, init scale], rot6d by
Gram-Schmidt, image-space cosypose translation with K, additive scale.

Written from the published description over a dict of float32 tensors named
as the port's `named_parameters()` (the benchmark loads the same tensors into
both); it imports nothing of the port. `quantizer(mode)` gives the rounding
of every product: "f32" none (the reference); "fp8" (a control) rounds each
operand tensor and each layer's result, before and after its bias, to
float8 e4m3 with a per-tensor scale, as a program that computes and stores in
fp8 would (the bf16 program rounds the same points to bfloat16); "tf32" (a
control) rounds the operands to TF32's 10-bit mantissa, to nearest, which is
what the card's TF32 products take in, on any device. Every sum stays in
float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x):
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _straight(rnd):
    """The rounded value forward, the gradient straight through."""
    return lambda x: x + (rnd(x.detach()) - x.detach())


def _same(x):
    return x


class Rounding:
    """q(x) rounds a product's operand, q.out(y) a layer's result."""

    def __init__(self, operand, result):
        self.operand, self.out = operand, result

    def __call__(self, x):
        return self.operand(x)


def quantizer(mode: str) -> Rounding:
    """The rounding of `mode`."""
    if mode == "f32":
        return Rounding(_same, _same)
    if mode == "tf32":
        return Rounding(_straight(_tf32), _same)
    if mode == "fp8":
        return Rounding(_straight(_fp8), _straight(_fp8))
    raise ValueError(f"unknown precision {mode!r}")


@contextlib.contextmanager
def precision(mode: str):
    """The block's matrix products in true float32 whatever the card's
    settings (their operands rounded as `mode` says), then the settings as
    they were."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield quantizer(mode)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def param_shapes(m: dict) -> dict:
    """name -> shape of every parameter, from the configuration's sizes."""
    pf, out = m["point_feat_dim"], m["pclnet_out_dim"]
    stn = m["stn_widths"]            # conv1-3, fc1-2
    main = m["main_widths"]          # conv2, conv3
    shapes = {}

    def dense(name, cin, cout):
        shapes[name + ".weight"] = (cout, cin)
        shapes[name + ".bias"] = (cout,)

    for prefix, k in (("pcl_net.stn", 3), ("pcl_net.fstn", pf)):
        widths = [k] + list(stn)
        for i, layer in enumerate(("conv1", "conv2", "conv3", "fc1", "fc2")):
            dense(f"{prefix}.{layer}", widths[i], widths[i + 1])
        dense(f"{prefix}.fc3", widths[-1], k * k)
    dense("pcl_net.conv1", 3, pf)
    dense("pcl_net.conv2", pf, main[0])
    dense("pcl_net.conv3", main[0], main[1])
    dense("pcl_net.conv4", main[1], out)
    f = m["ts_feat_dim"]
    ts_in = out + pf + 3
    for i in range(m["ts_num_layers"]):
        dense(f"ts_head.linears.{i}", ts_in if i == 0 else f, f)
    for i in range(m["ts_num_layers"]):
        shapes[f"ts_head.gns.{i}.weight"] = (f,)
        shapes[f"ts_head.gns.{i}.bias"] = (f,)
    dense("ts_head.fc_t", f, 3)
    dense("ts_head.fc_s", f, 3)
    r = m["rot_feat_dim"]
    for axis in ("x", "y"):
        h = f"rot_head.rot_head_{axis}"
        shapes[h + ".layer0_global_weight"] = (r, out)
        shapes[h + ".layer0_point_weight"] = (r, pf)
        shapes[h + ".layer0_bias"] = (r,)
        shapes[h + ".point_weight"] = (m["num_pcl"] + m["num_kps"],)
        shapes[h + ".point_bias"] = (1,)
        for i in range(m["rot_num_layers"]):
            shapes[f"{h}.gns.{i}.weight"] = (r,)
            shapes[f"{h}.gns.{i}.bias"] = (r,)
        for i in range(m["rot_num_layers"] - 1):
            dense(f"{h}.layers.{i}", r, r)
        dense(h + ".neck", r, 3)
    return shapes


def _dense(p, name, x, q, act=False):
    y = q.out(q.out(q(x) @ q(p[name + ".weight"]).t()) + p[name + ".bias"])
    return torch.relu(y) if act else y


def _group_norm(x, weight, bias, groups, eps=1e-5):
    """GroupNorm over (points, channels of the group) per sample; x (B, P, C)
    or (B, C)."""
    shape = x.shape
    g = x.reshape(shape[0], -1, groups, shape[-1] // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), unbiased=False, keepdim=True)
    return ((g - mean) / torch.sqrt(var + eps)).reshape(shape) * weight + bias


def _stn(p, prefix, x, k, q):
    h = _dense(p, prefix + ".conv1", x, q, True)
    h = _dense(p, prefix + ".conv2", h, q, True)
    g = _dense(p, prefix + ".conv3", h, q, True).amax(dim=1)
    f = _dense(p, prefix + ".fc1", g, q, True)
    f = _dense(p, prefix + ".fc2", f, q, True)
    f = _dense(p, prefix + ".fc3", f, q)
    return (f + torch.eye(k, device=x.device).reshape(1, -1)).reshape(-1, k, k)


def pointnet(p, x, q):
    """(N, P, 3) -> point features (N, P, 64), global feature (N, 1024)."""
    x = q.out(q(x) @ q(_stn(p, "pcl_net.stn", x, 3, q)))
    x = _dense(p, "pcl_net.conv1", x, q, True)
    x = q.out(q(x) @ q(_stn(p, "pcl_net.fstn", x, x.shape[-1], q)))
    h = _dense(p, "pcl_net.conv2", x, q, True)
    h = _dense(p, "pcl_net.conv3", h, q, True)
    return x, _dense(p, "pcl_net.conv4", h, q).amax(dim=1)


def _rot_head(p, h, m, pf, g_pcl, g_kps, n_pcl, q):
    w_g, w_pt = p[h + ".layer0_global_weight"], p[h + ".layer0_point_weight"]
    x = q.out(q(pf) @ q(w_pt).t())                                     # (B, P+K, F)
    g = q.out(torch.stack([q(g_pcl) @ q(w_g).t(), q(g_kps) @ q(w_g).t()], 1))  # (B, 2, F)
    cloud = (torch.arange(pf.shape[1], device=pf.device) >= n_pcl).long()
    x = q.out(q.out(x + g[:, cloud]) + p[h + ".layer0_bias"])
    groups = m["rot_num_gn_groups"]
    x = F.gelu(_group_norm(x, p[h + ".gns.0.weight"], p[h + ".gns.0.bias"], groups))
    for i in range(m["rot_num_layers"] - 1):
        x = _dense(p, f"{h}.layers.{i}", x, q)
        x = F.gelu(_group_norm(x, p[f"{h}.gns.{i + 1}.weight"], p[f"{h}.gns.{i + 1}.bias"],
                               groups))
    x = _dense(p, h + ".neck", x, q)                                  # (B, P+K, 3)
    return q.out(q.out(torch.einsum("bpd,p->bd", q(x), q(p[h + ".point_weight"])))
                 + p[h + ".point_bias"])


def deltas(p, m, x, kps, init_scale, q):
    """The network: centred cloud (B, P, 3), posed keypoints (B, K, 3), init
    scale (B, 3) -> rot6d (B, 6), translation deltas (B, 3), scale deltas
    (B, 3)."""
    b = x.shape[0]
    pf, gf = pointnet(p, torch.cat([x, kps], 0), q)
    pcl_pf, kps_pf, g_pcl, g_kps = pf[:b], pf[b:], gf[:b], gf[b:]
    t = torch.cat([g_pcl, pcl_pf.amax(dim=1), init_scale], 1)
    for i in range(m["ts_num_layers"]):
        t = _dense(p, f"ts_head.linears.{i}", t, q)
        t = F.gelu(_group_norm(t, p[f"ts_head.gns.{i}.weight"], p[f"ts_head.gns.{i}.bias"],
                               m["ts_num_gn_groups"]))
    point_feats = torch.cat([pcl_pf, kps_pf], 1)
    rot = torch.cat([_rot_head(p, f"rot_head.rot_head_{a}", m, point_feats, g_pcl, g_kps,
                               x.shape[1], q) for a in ("x", "y")], 1)
    return rot, _dense(p, "ts_head.fc_t", t, q), _dense(p, "ts_head.fc_s", t, q)


def rot6d_to_mat(d6):
    """(B, 6) -> (B, 3, 3), columns x, y, z by Gram-Schmidt."""
    x = F.normalize(d6[:, 0:3], dim=-1, eps=1e-12)
    z = F.normalize(torch.linalg.cross(x, d6[:, 3:6], dim=-1), dim=-1, eps=1e-12)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def refine_step(p, m, pcl, kps, pose, scale, K, q):
    """One iteration: (B, 3, 4) pose and (B, 3) scale estimates -> the next."""
    R, t = pose[:, :, :3], pose[:, :, 3]
    x = pcl - t[:, None, :]                                       # zero-centred cloud
    posed = (kps * scale[:, None, :]) @ R.transpose(1, 2)
    rot6d, dt, ds = deltas(p, m, x, posed, scale, q)
    z = dt[:, 2:3] * t[:, 2:3]                                    # cosypose depth
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], 1)
    xy = z * (dt[:, :2] / f + t[:, :2] / t[:, 2:3])
    R_new = rot6d_to_mat(rot6d) @ R
    return torch.cat([R_new, torch.cat([xy, z], 1)[:, :, None]], 2), scale + ds


def refine(p, m, pcl, kps, pose, scale, K, n_iter: int, q, block: int = 64):
    """n_iter iterations in blocks of `block` objects -> poses (n_iter + 1,
    B, 3, 4), scales (n_iter + 1, B, 3); index 0 holds the estimates given."""
    poses, scales = [], []
    with torch.no_grad():
        for s in range(0, pcl.shape[0], block):
            e = slice(s, s + block)
            po, sc = [pose[e]], [scale[e]]
            for _ in range(n_iter):
                a, b = refine_step(p, m, pcl[e], kps[e], po[-1], sc[-1], K[e], q)
                po.append(a)
                sc.append(b)
            poses.append(torch.stack(po))
            scales.append(torch.stack(sc))
    return torch.cat(poses, 1), torch.cat(scales, 1)


def forward_flops(m: dict) -> float:
    """Dense operations of one object through one iteration: both clouds
    through the three conv columns of the PointNet and the two rotation
    heads' per-point layers 0 and 1 (the rest, under 1%, is not counted)."""
    pf, out = m["point_feat_dim"], m["pclnet_out_dim"]
    c1, c2, c3 = m["stn_widths"][:3]
    m2, m3 = m["main_widths"]
    points = m["num_pcl"], m["num_kps"]
    per_point = (2 * (3 * c1 + c1 * c2 + c2 * c3) + 2 * (pf * c1 + c1 * c2 + c2 * c3)
                 + 2 * (pf * m2 + m2 * m3 + m3 * out))
    heads = 2 * 2 * (pf * m["rot_feat_dim"] + m["rot_feat_dim"] ** 2)
    return float(sum(points) * (per_point + heads))

