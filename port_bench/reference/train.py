"""CATRE's training step in plain PyTorch, float32: the judge of the train
cells.

One outer step: the batch augmentation and the iteration-0 estimates drawn
from a CPU `torch.Generator` (CATRE's `aug_bbox_DZI`-free 3D path: a 3D box
rescale on one coin a batch, a rigid shift on another, then gt_noise pose and
scale estimates), then per inner iteration a forward, the NOCS_REAL loss
(point matching over the prior keypoints, symmetry-aware; angular rotation
loss over non-symmetric objects, L1 on the y axis over symmetric ones; L1
translation split xy / z; L1 scale), a backward, NaNs in the gradients set to
0 and one Ranger step (gradient centralisation, RAdam, Lookahead), the pose
fed forward detached. The draws follow the order the configuration's
recipe takes them, so the same generator state gives the same numbers.

The rows of a batch go through in blocks; each loss term is a sum over the
block divided by the whole batch's count, so the gradients add up to the
whole batch's.

Two judges, with one shape of result (`train_steps`): a float32 program is
trained alongside, from the same weights and draws, on its own; a bf16
program's trajectory leaves a float32 one's after the first inner iterations
by more than rounding (the refine feeds each pose forward and the L1 terms
turn on signs), so it is judged step by step (`follow`): every inner
iteration from the parameters the program had before it and the pose and
scale the program fed it, and every Ranger step from the program's
parameters, gradients and optimizer state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import refine_step


def euler_to_mat(a):
    """XYZ euler angles (B, 3), radians -> Rx @ Ry @ Rz."""
    x, y, z = a.unbind(-1)
    c, s = torch.cos, torch.sin
    o, n = torch.ones_like(x), torch.zeros_like(x)
    rz = torch.stack([c(z), -s(z), n, s(z), c(z), n, n, n, o], -1).reshape(-1, 3, 3)
    ry = torch.stack([c(y), n, s(y), n, o, n, -s(y), n, c(y)], -1).reshape(-1, 3, 3)
    rx = torch.stack([o, n, n, n, c(x), -s(x), n, s(x), c(x)], -1).reshape(-1, 3, 3)
    return rx @ ry @ rz


def sym_bank(step: float) -> torch.Tensor:
    """Rotations about y by i * 2pi / ceil(pi / step), identity first."""
    count = int(np.ceil(np.pi / step))
    a = np.arange(count) * (2.0 * np.pi / count)
    c, s = np.cos(a), np.sin(a)
    R = np.zeros((count, 3, 3))
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1], R[:, 2, 0], R[:, 2, 2] = c, s, 1.0, -s, c
    return torch.from_numpy(R.astype(np.float32))


def _row(generator, ladder):
    ladder = torch.as_tensor(ladder, dtype=torch.float32)
    return ladder[int(torch.randint(ladder.shape[0], (), generator=generator))]


def prepare(generator, batch: dict, noise: dict) -> dict:
    """Augmented cloud, gt and the iteration-0 estimates of one step."""
    dev = batch["pcl"].device
    pcl, pose, scale = batch["pcl"], batch["obj_pose"], batch["obj_scale"]
    if float(torch.rand((), generator=generator)) < noise["bbox3d_aug_prob"]:
        e = (torch.rand(3, generator=generator) * 0.4 + 0.8).to(dev)
        exz = (e[0] + e[2]) / 2
        ratios = torch.where(batch["sym_flag"][:, None], torch.stack([exz, e[1], exz])[None],
                             e[None])
        R, t = pose[:, :, :3], pose[:, :, 3]
        local = torch.einsum("bji,bpj->bpi", R, pcl - t[:, None]) * ratios[:, None]
        pcl, scale = torch.einsum("bij,bpj->bpi", R, local) + t[:, None], scale * ratios
    if float(torch.rand((), generator=generator)) < noise["rt_aug_prob"]:
        rxyz = torch.deg2rad((torch.rand(3, generator=generator) * 30.0 - 15.0).to(dev))
        shift = torch.tensor([0.005, 0.005, 0.025])
        dt = (torch.rand(3, generator=generator) * 2 * shift - shift).to(dev)
        c, s = torch.cos(rxyz), torch.sin(rxyz)
        o, n = torch.ones_like(c[0]), torch.zeros_like(c[0])
        rx = torch.stack([o, n, n, n, c[0], -s[0], n, s[0], c[0]]).reshape(3, 3)
        ry = torch.stack([c[1], n, s[1], n, o, n, -s[1], n, c[1]]).reshape(3, 3)
        rz = torch.stack([c[2], -s[2], n, s[2], c[2], n, n, n, o]).reshape(3, 3)
        dR = rz @ ry @ rx
        pcl = torch.einsum("ij,bpj->bpi", dR, pcl + dt)
        pose = torch.cat([dR @ pose[:, :, :3], (torch.einsum("ij,bj->bi", dR, pose[:, :, 3] + dt)
                                                 )[:, :, None]], 2)
    b = pcl.shape[0]
    rot_std = _row(generator, noise["noise_rot_std"])
    euler = torch.randn((b, 3), generator=generator).to(dev) * rot_std
    lim = noise["noise_rot_max"]
    dR = euler_to_mat(torch.deg2rad(euler.clamp(-lim, lim)))
    t_std = _row(generator, noise["noise_trans_std"]).to(dev)
    t = pose[:, :, 3] + torch.randn((b, 3), generator=generator).to(dev) * t_std
    t = torch.cat([t[:, :2], t[:, 2:].clamp(min=max(noise["init_trans_min_z"], 1e-4))], 1)
    s_std = _row(generator, noise["noise_scale_std"]).to(dev)
    s = scale + torch.randn((b, 3), generator=generator).to(dev) * s_std
    s = s.clamp(max(noise["init_scale_min"], 1e-4), noise["init_scale_max"])
    return dict(batch, pcl=pcl, obj_pose=pose, obj_scale=scale,
                pose_est=torch.cat([dR @ pose[:, :, :3], t[:, :, None]], 2), scale_est=s)


def loss_terms(pose, scale, batch, bank, counts) -> dict:
    """The NOCS_REAL loss terms of these rows, each a sum over them divided
    by the whole batch's count of its rows."""
    R, t = pose[:, :, :3], pose[:, :, 3]
    gR, gt, gs = batch["obj_pose"][:, :, :3], batch["obj_pose"][:, :, 3], batch["obj_scale"]
    sym = batch["sym_flag"]
    cand = torch.einsum("bij,kjl->bkil", gR, bank)
    best = torch.where(sym, torch.einsum("bij,bkij->bk", R.detach(), cand).argmax(1), 0)
    gR_sym = cand[torch.arange(R.shape[0], device=R.device), best]
    kps = batch["obj_kps"]
    est = (kps * scale[:, None]) @ R.transpose(1, 2)
    tgt = (kps * gs[:, None]) @ gR_sym.transpose(1, 2)
    symf = sym.float()
    ang = (1.0 - (torch.einsum("bij,bij->b", R, gR) - 1.0) / 2.0) / 2.0
    return {
        "loss_PM_R": 3.0 * (est - tgt).abs().mean(dim=(1, 2)).sum() / counts["valid"],
        "loss_rot": (ang * (1 - symf)).sum() / max(counts["nonsym"], 1.0),
        "loss_yaxis_rot": ((R[:, :, 1] - gR[:, :, 1]).abs().mean(1) * symf).sum()
        / max(counts["sym"], 1.0),
        "loss_trans_xy": (t[:, :2] - gt[:, :2]).abs().mean(1).sum() / counts["valid"],
        "loss_trans_z": (t[:, 2] - gt[:, 2]).abs().sum() / counts["valid"],
        "loss_scale": (scale - gs).abs().mean(1).sum() / counts["valid"],
    }


class Ranger:
    """Ranger over a dict of parameters: gradient centralisation (weights of
    two or more dimensions over all but the first; the rotation heads' layer
    0, stored as a global and a point part, over both together; the point
    weights over all of them), RAdam (rectified once its SMA length passes
    5), decoupled weight decay, Lookahead (k, alpha). `state` (the step
    count, first and second moments and slow weights of each parameter)
    starts the optimizer from a state other than its first."""

    def __init__(self, params: dict, solver: dict, state: dict | None = None):
        self.p, self.lr, (self.b1, self.b2) = params, solver["lr"], solver["betas"]
        self.eps, self.wd = solver["eps"], solver["weight_decay"]
        self.k, self.alpha = solver["k"], solver["alpha"]
        if state:
            self.t = next(iter(state.values()))[0]
            self.m = {n: s[1].clone() for n, s in state.items()}
            self.v = {n: s[2].clone() for n, s in state.items()}
            self.slow = {n: s[3].clone() for n, s in state.items()}
        else:
            self.t = 0
            self.m = {n: torch.zeros_like(v) for n, v in params.items()}
            self.v = {n: torch.zeros_like(v) for n, v in params.items()}
            self.slow = {n: v.detach().clone() for n, v in params.items()}

    def state(self) -> dict:
        return {n: (self.t, self.m[n].clone(), self.v[n].clone(), self.slow[n].clone())
                for n in self.p}

    def _centralised(self, grads):
        out = dict(grads)
        for n, g in grads.items():
            if n.endswith("layer0_global_weight"):
                g2 = grads[n.replace("global", "point")]
                mean = (g.sum(1, keepdim=True) + g2.sum(1, keepdim=True)) / (
                    g.shape[1] + g2.shape[1])
                out[n], out[n.replace("global", "point")] = g - mean, g2 - mean
            elif n.endswith(".point_weight"):
                out[n] = g - g.mean()
            elif g.dim() > 1 and not n.endswith("layer0_point_weight"):
                out[n] = g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
        return out

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        t, b1, b2 = self.t, self.b1, self.b2
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        b2t, one_minus_b2t = math.exp(t * math.log(b2)), -math.expm1(t * math.log(b2))
        one_minus_b1t = -math.expm1(t * math.log(b1))
        n_sma = n_sma_max - 2.0 * t * b2t / one_minus_b2t
        for n, g in self._centralised(grads).items():
            p, m, v = self.p[n], self.m[n], self.v[n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            if n_sma > 5.0:
                r = math.sqrt(one_minus_b2t * (n_sma - 4) / (n_sma_max - 4) * (n_sma - 2) / n_sma
                              * n_sma_max / (n_sma_max - 2)) / one_minus_b1t
                upd = -self.lr * r * m / (v.sqrt() + self.eps)
            else:
                upd = -self.lr / one_minus_b1t * m
            if self.wd:
                upd = upd - self.wd * self.lr * p
            p.add_(upd)
        if t % self.k == 0:
            for n, p in self.p.items():
                self.slow[n].add_(p - self.slow[n], alpha=self.alpha)
                p.copy_(self.slow[n])


def ranger_step(before: dict, grads: dict, state: dict | None, solver: dict):
    """One Ranger step from `before` with `grads` and the optimizer `state`
    (None at the first step) -> (the parameters after it, its state after
    it)."""
    params = {n: v.clone() for n, v in before.items()}
    opt = Ranger(params, solver, state)
    opt.step(grads)
    return params, opt.state()


def _prepared(batch, generator_state, noise, fault):
    gen = torch.Generator()
    gen.set_state(generator_state)
    b = prepare(gen, batch, noise)
    if fault == "half":
        b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
    symf = b["sym_flag"].float()
    counts = {"valid": float(b["pcl"].shape[0]), "sym": float(symf.sum()),
              "nonsym": float((1 - symf).sum())}
    return b, counts


def iteration(p: dict, m: dict, b: dict, counts: dict, pose_est, scale_est, bank, q,
              block: int = 128, alter: bool = False):
    """One inner iteration's forward and backward over the rows of `b` in
    blocks -> (loss terms, gradients, the pose and the scale predicted)."""
    grads = {n: torch.zeros_like(v) for n, v in p.items()}
    terms, poses, scales = {}, [], []
    for s in range(0, pose_est.shape[0], block):
        e = slice(s, s + block)
        rows = {k: v[e] for k, v in b.items()}
        pose, scale = refine_step(p, m, rows["pcl"], rows["obj_kps"], pose_est[e],
                                  scale_est[e], rows["K"], q)
        part = loss_terms(pose, scale, rows, bank, counts)
        if alter:
            part["loss_PM_R"] = part["loss_PM_R"] * 1.5
        sum(part.values()).backward()
        for n, v in p.items():
            grads[n] += v.grad
            v.grad = None
        for k, v in part.items():
            terms[k] = terms.get(k, 0.0) + v.detach()
        poses.append(pose.detach())
        scales.append(scale.detach())
    return terms, {n: torch.nan_to_num(g) for n, g in grads.items()}, \
        torch.cat(poses), torch.cat(scales)


def _record(before: dict, grads: dict, after: dict, state: dict) -> dict:
    return {"before": before, "grad": grads, "after": after, "state": state}


def train_steps(params: dict, m: dict, noise: dict, solver: dict, batches, generator_states,
                q, fault: str = ""):
    """len(batches) outer steps from `params` (copied) on `batches` (dicts of
    device tensors), step i drawing from a CPU generator in state
    generator_states[i] -> (loss terms: one {term: (n_iter,)} dict a step;
    one record a Ranger step: the parameters before it, the gradients it
    took, the parameters after it and its state after it, {name: (step,
    exp_avg, exp_avg_sq, slow)}; the poses of each step: "init_pose" and
    each inner iteration's "pose" (n_iter, B, 3, 4) and "scale" (n_iter,
    B, 3)). `fault` plants one of the faults a training step can have, to
    read what it does to the numbers compared: "half" trains on the first
    half of each batch's rows, the means over them; "loss" alters the
    point-matching term where it is produced (x 1.5), "late" only from the
    second inner iteration on; "state" scales the second moments by 1.1
    after each Ranger step, the parameters' update left as it was."""
    p = {n: v.detach().clone().requires_grad_(True) for n, v in params.items()}
    opt = Ranger(p, solver)
    bank = sym_bank(noise["max_sym_disc_step"]).to(next(iter(p.values())).device)
    history, records, poses = [], [], []
    for batch, state in zip(batches, generator_states):
        b, counts = _prepared(batch, state, noise, fault)
        pose_est, scale_est = b["pose_est"], b["scale_est"]
        per_iter, out = [], []
        for k in range(m["n_iter_train"]):
            alter = fault == "loss" or (fault == "late" and k > 0)
            before = {n: v.detach().clone() for n, v in p.items()}
            terms, grads, pose_est, scale_est = iteration(p, m, b, counts, pose_est, scale_est,
                                                          bank, q, alter=alter)
            opt.step(grads)
            if fault == "state":
                for v in opt.v.values():
                    v.mul_(1.1)
            records.append(_record(before, grads, {n: v.detach().clone() for n, v in p.items()},
                                   opt.state()))
            per_iter.append(terms)
            out.append((pose_est, scale_est))
        history.append({k: torch.stack([t[k] for t in per_iter]) for k in per_iter[0]})
        poses.append({"init_pose": b["pose_est"], "pose": torch.stack([o[0] for o in out]),
                      "scale": torch.stack([o[1] for o in out])})
    return history, records, poses


def follow(records: list, poses: list, m: dict, noise: dict, solver: dict, batches,
           generator_states, q):
    """The program's outer steps (its `records` and `poses`, in the shape
    `train_steps` gives) done again step by step from its own state: inner
    iteration k of a step from the parameters the program had before that
    Ranger step, fed the step's own iteration-0 estimates (k = 0) or the pose
    and scale the program's iteration k - 1 gave; each Ranger step from the
    program's parameters and gradients and its state after the step before
    -> what the reference computes from them, in `train_steps`' shape."""
    n_iter = m["n_iter_train"]
    bank = sym_bank(noise["max_sym_disc_step"]).to(batches[0]["pcl"].device)
    history, out_records, out_poses = [], [], []
    for s, (batch, gen_state) in enumerate(zip(batches, generator_states)):
        b, counts = _prepared(batch, gen_state, noise, "")
        pose_est, scale_est = b["pose_est"], b["scale_est"]
        rows = pose_est.shape[0]
        per_iter, out = [], []
        for k in range(n_iter):
            i = s * n_iter + k
            r = records[i]
            fed = poses[s]["pose"], poses[s]["scale"]
            if k and fed[0].shape[1] == rows:      # else: rows left out, which the gaps show
                pose_est, scale_est = fed[0][k - 1].float(), fed[1][k - 1].float()
            p = {n: v.detach().clone().requires_grad_(True) for n, v in r["before"].items()}
            terms, grads, pose_est, scale_est = iteration(p, m, b, counts, pose_est, scale_est,
                                                          bank, q)
            state = records[i - 1]["state"] if i else None
            after, new_state = ranger_step(r["before"], r["grad"], state, solver)
            out_records.append(_record(r["before"], grads, after, new_state))
            per_iter.append(terms)
            out.append((pose_est, scale_est))
        history.append({k: torch.stack([t[k] for t in per_iter]) for k in per_iter[0]})
        out_poses.append({"init_pose": b["pose_est"], "pose": torch.stack([o[0] for o in out]),
                          "scale": torch.stack([o[1] for o in out])})
    return history, out_records, out_poses
