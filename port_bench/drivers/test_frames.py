"""Test-path cells: a group of depth frames a call, as a user's detector hands
them over, through the port's group sampler (`data.loader.make_group_sampler`
over the config's test loader settings, the auto window resolved from the
frames' boxes) into the refine (`engine.refiner.make_refine_fn`, N_ITER_TEST
iterations), the mean-shape keypoints gathered by class on the card from a
seeded table; a call ends when the poses and scales of every iteration are
readable on the host. One group is in flight: a closed loop.

The frames come from a pool of groups made on the card from the seed and
held in pinned host memory, so each call uploads its group. After the
window, a sample of the window's calls, drawn from the seed, is judged: each
real object's sampled cloud by `reference.sampler`, and its poses and scales
of every iteration against the plain refine on that cloud.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import traffic, weights
from ..reference import compare, sampler
from ..reference import model as ref_model
from .common import control_mode, port_config, sync

UPLOAD = ("depth", "packed", "mask_bbox", "K", "poses", "scales", "classes")


class TestRun:
    training = False

    def __init__(self, cell, seed: int, device: torch.device):
        from catre_tpu_torch.config.build import loader_config_from, model_config_from
        from catre_tpu_torch.data.loader import auto_sample_window, make_group_sampler
        from catre_tpu_torch.engine.refiner import make_refine_fn
        from catre_tpu_torch.models.catre import init_model
        from catre_tpu_torch.ops.limits import check_model_limits

        self.cell, self.device = cell, device
        t, m = cell.traffic, cell.config["model"]
        cfg = port_config(cell)
        gen = traffic.generator(seed, 2, device)
        pin = device.type == "cuda"
        self.pool = []
        for _ in range(t["pool"]):
            g = traffic.make_frames(t, t["frames_per_call"], gen, device)
            self.pool.append({k: (v.cpu().pin_memory() if pin else v.cpu()) for k, v in g.items()})
        self.table = traffic.make_kps_table(t, m["num_kps"], gen, device)
        lcfg = loader_config_from(cfg, "test")
        if lcfg.sample_window < 0:
            boxes = [{"annotations": [{"bbox_est": [0.0, 0.0, float(s), float(s)]}]}
                     for g in self.pool for s in g["bbox_size"].flatten().tolist() if s > 0]
            lcfg.sample_window = auto_sample_window(boxes, "test")
        self.window = lcfg.sample_window
        self.ratio = lcfg.depth_sample_ball_ratio
        self.sampler = make_group_sampler(lcfg, train_aug=False, device=device)
        mcfg = model_config_from(cfg)
        check_model_limits(mcfg)
        model = init_model(mcfg, seed=seed, device=device)
        self.weights = weights.make_weights(ref_model.param_shapes(m), seed, device)
        weights.load_into(model, self.weights)
        self.refine = make_refine_fn(model, n_iter=m["n_iter"])
        self.draws = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
        self.real = [int(g["n_objs"].sum()) for g in self.pool]
        self.slots_per_call = t["frames_per_call"] * t["slots_per_frame"]
        self.iterations = m["n_iter"]
        self.forward_flops = ref_model.forward_flops(m)
        self.sample = set(np.random.default_rng(seed).choice(
            t["sample_from"], size=t["sample_calls"], replace=False).tolist())
        self.kept, self.outputs = {}, []
        self.calls, self.objects_done, self.latencies = 0, 0, []
        for _ in range(t["warmup_calls"]):
            self.call()
        self.kept, self.outputs = {}, []
        self.calls, self.objects_done, self.latencies = 0, 0, []

    def call(self) -> None:
        t0 = time.perf_counter()
        i = self.calls % len(self.pool)
        host = self.pool[i]
        with record_function("bench.upload"):
            g = {k: host[k].to(self.device, non_blocking=True) for k in UPLOAD}
        with record_function("bench.sampler"):
            pcls, idx, n_in = self.sampler(g["depth"], g["K"], g["packed"], g["poses"],
                                           g["scales"], g["mask_bbox"], generator=self.draws)
        with record_function("bench.refine"):
            frames, slots = g["poses"].shape[:2]
            b = frames * slots
            poses, scales = self.refine(
                pcls.reshape(b, -1, 3), self.table[g["classes"].reshape(b)],
                g["poses"].reshape(b, 3, 4), g["scales"].reshape(b, 3),
                g["K"].repeat_interleave(slots, 0))
        with record_function("bench.download"):
            out = torch.cat([poses.reshape(poses.shape[0], b, 12), scales], -1).cpu()
        self.latencies.append(time.perf_counter() - t0)
        self.objects_done += self.real[i]
        self.outputs.append((i, out))
        if self.calls in self.sample:
            self.kept[self.calls] = (i, pcls.reshape(b, -1, 3), idx.reshape(b, -1),
                                     n_in.reshape(b), out)
        self.calls += 1

    def sync(self) -> None:
        sync(self.device)

    def end_to_end(self, win) -> dict:
        out = {"refine_obj_per_s": win.objects / win.seconds}
        if win.busy_s:
            out["refine_obj_per_busy_s"] = win.objects / win.busy_s
        return out

    def failed(self) -> int:
        """Calls whose real objects came back with a value that is not finite."""
        bad = 0
        for i, out in self.outputs:
            rows = self._real_rows(i)
            bad += int(not torch.isfinite(out[:, rows]).all())
        return bad

    def _real_rows(self, i: int) -> torch.Tensor:
        g = self.pool[i]
        slots = g["poses"].shape[1]
        return (torch.arange(slots)[None, :] < g["n_objs"][:, None]).reshape(-1).nonzero()[:, 0]

    def release(self) -> None:
        del self.refine, self.sampler, self.outputs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, mode: str | None = None) -> dict:
        """The numbers compared over the sampled calls: the program's against
        the reference, or with `mode`, the reference computed in that
        precision in the program's place (on the same sampled clouds)."""
        m = self.cell.config["model"]
        faults, gaps = 0, []
        for call, (i, pcl, idx, n_in, out) in sorted(self.kept.items()):
            g = {k: v.to(self.device) for k, v in self.pool[i].items()}
            frames, slots = g["poses"].shape[:2]
            rows = self._real_rows(i).to(self.device)
            for r in rows.tolist():
                f, j = divmod(r, slots)
                mask = ((g["packed"][f].long() >> j) & 1).bool()
                found = sampler.object_faults(g["depth"][f].long(), g["K"][f], mask,
                                              g["poses"][f, j], g["scales"][f, j], self.ratio,
                                              pcl[r], idx[r], n_in[r])
                faults += bool(found)
            args = (pcl[rows].float(), self.table[g["classes"].reshape(-1)[rows]],
                    g["poses"].reshape(-1, 3, 4)[rows], g["scales"].reshape(-1, 3)[rows],
                    g["K"].repeat_interleave(slots, 0)[rows])
            with ref_model.precision("f32") as q:
                ref_p, ref_s = ref_model.refine(self.weights, m, *args, m["n_iter"], q)
            if mode is None:
                got = out[:, rows.cpu()].to(self.device)
                got_p, got_s = got[..., :12].reshape(got.shape[0], -1, 3, 4), got[..., 12:]
            else:
                with ref_model.precision(mode) as q:
                    got_p, got_s = ref_model.refine(self.weights, m, *args, m["n_iter"], q)
            gaps.append(compare.pose_gaps(got_p[1:], got_s[1:], ref_p[1:], ref_s[1:]))
        out = {k: max(g[k] for g in gaps) for k in gaps[0]} if gaps else {}
        out["cloud_faults"] = float(faults)
        out["calls_judged"] = float(len(self.kept))
        return out

    def check(self) -> dict:
        limits = self.cell.workload["limits"]
        got = self.readings()
        if not self.kept:
            return {"calls_judged": (0.0, -1.0)}
        return {k: (got[k], limits[k]) for k in limits}

    def control(self) -> dict:
        return self.readings(control_mode(self.cell))


def build(cell, seed: int, device: torch.device) -> TestRun:
    return TestRun(cell, seed, device)
