"""Training cells: the port's training step (`entry.flagship_trainer` with the
configuration's config tree), one outer step a call (N_ITER_TRAIN inner
forward, loss, backward and Ranger steps), on batches that cycle through a
pool made on the card from the seed.

Set-up builds the trainer, loads the seeded weights and takes the first
`check_steps` steps through the same call the window takes, on the pool's
first batches: they warm every shape, and what they produce is what the
reference judges after the window. For those steps the step keeps each
inner iteration's pose and scale (its own `with_vis` record), and hooks on
the optimizer keep, for each Ranger step, the parameters before it, the
gradients as it got them, the parameters after it and its state after it.
The workload's `judge` says how the reference judges them
(`reference.train`): "own", a float32 run of the same steps from the same
weights and draws; "follow", every inner iteration and Ranger step again
from the program's own state. The hooks go before the window, which goes on
with the same trainer. Calls do not wait for the card; the window drains it
at its end.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import traffic, weights
from ..reference import compare
from ..reference import model as ref_model
from ..reference import train as ref_train
from .common import control_mode, port_config, sync

# the faults `port_bench/control.py` reads in the reference (`reference.train.train_steps`)
FAULTS = ("half", "loss", "late", "state")


class TrainRun:
    training = True

    def __init__(self, cell, seed: int, device: torch.device):
        from catre_tpu_torch.entry import flagship_trainer

        self.cell, self.device = cell, device
        t, m = cell.traffic, cell.config["model"]
        cfg = port_config(cell)
        self.trainer = flagship_trainer(device, batch_size=1, seed=seed, cfg=cfg)
        self.model = self.trainer.step.model
        self.weights = weights.make_weights(ref_model.param_shapes(m), seed, device)
        weights.load_into(self.model, self.weights)
        gen = traffic.generator(seed, 1, device)
        self.pool = [traffic.make_batch(t["rows"], m["num_pcl"], m["num_kps"], gen, device)
                     for _ in range(t["pool"])]
        self.rows = t["rows"]
        self.slots_per_call = self.rows
        self.iterations = m["n_iter_train"]
        self.forward_flops = ref_model.forward_flops(m)
        self.objects_done, self.latencies, self.steps = 0, [], 0
        self.losses = []
        self.states, self.history, self.records, self.poses = [], [], [], []
        hooks = self._record(self.trainer.step.optimizer)
        self.trainer.step.with_vis = True
        for _ in range(t["check_steps"]):
            self.states.append(self.trainer.generator.get_state())
            metrics = self._step()
            self.history.append({k: v.detach().clone() for k, v in metrics.items()
                                 if k.startswith("loss_") and k != "loss_total"})
            vis = metrics["_vis"]
            self.poses.append({"init_pose": vis["init_pose"], "pose": vis["pose"],
                               "scale": vis["scale"]})
        self.trainer.step.with_vis = False
        for h in hooks:
            h.remove()
        sync(device)
        self.objects_done, self.losses = 0, []

    def _record(self, optimizer) -> tuple:
        """Hooks that keep each optimizer step's inputs, result and state on
        the host."""
        named = list(self.model.named_parameters())

        def host(tensors):
            return {n: t.detach().to("cpu", copy=True) for n, t in tensors}

        def before(opt, args, kwargs):
            self.records.append({"before": host(named),
                                 "grad": host((n, p.grad) for n, p in named)})

        def after(opt, args, kwargs):
            self.records[-1]["after"] = host(named)
            state = [opt.state.get(p, {}) for _, p in named]
            self.records[-1]["state"] = None if any("step" not in x for x in state) else {
                n: (x["step"], *(x[k].detach().to("cpu", copy=True) for k in compare.STATE))
                for (n, _), x in zip(named, state)}

        return optimizer.register_step_pre_hook(before), optimizer.register_step_post_hook(after)

    def _step(self):
        t = self.trainer
        with record_function("bench.step"):
            t.state, metrics = t.step(t.state, self.pool[self.steps % len(self.pool)],
                                      t.generator, t.lr)
        self.steps += 1
        self.objects_done += self.rows
        self.losses.append(metrics["loss_total"].detach())
        return metrics

    def call(self) -> None:
        self._step()

    def end_to_end(self, win) -> dict:
        out = {"train_obj_per_s": win.objects / win.seconds}
        if win.busy_s:
            out["train_obj_per_busy_s"] = win.objects / win.busy_s
        return out

    def sync(self) -> None:
        sync(self.device)

    def failed(self) -> int:
        return int((~torch.isfinite(torch.stack(self.losses))).sum()) if self.losses else 0

    def release(self) -> None:
        del self.trainer, self.model, self.losses
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, mode: str | None = None, fault: str = "") -> dict:
        """The numbers compared (`compare.train_gaps`): the program's set-up
        steps judged by the reference, or with `mode`, the reference computed
        in that precision in the program's place (with `fault`, a fault
        planted in it: `reference.train.train_steps`) and judged the same
        way."""
        c, dev = self.cell.config, self.device
        m, noise = c["model"], c["noise"]
        solver = {**c["solver"], "betas": tuple(c["solver"]["betas"])}
        batches = [self.pool[i % len(self.pool)] for i in range(len(self.states))]
        if mode is None:
            records = [{k: ({n: (x[0], *(y.to(dev) for y in x[1:])) for n, x in v.items()}
                            if k == "state" else {n: x.to(dev) for n, x in v.items()})
                        if v is not None else None for k, v in r.items()} for r in self.records]
            got = self.history, records, self.poses
        else:
            with ref_model.precision(mode) as q:
                got = ref_train.train_steps(self.weights, m, noise, solver, batches, self.states,
                                            q, fault)
        follows = self.cell.workload["judge"] == "follow"
        with ref_model.precision("f32") as q:
            if follows:
                ref = ref_train.follow(got[1], got[2], m, noise, solver, batches, self.states, q)
            else:
                ref = ref_train.train_steps(self.weights, m, noise, solver, batches, self.states,
                                            q)
        return compare.train_gaps(got, ref, follows)

    def check(self) -> dict:
        limits = self.cell.workload["limits"]
        got = self.readings()
        return {k: (got[k], limits[k]) for k in limits}

    def control(self) -> dict:
        return self.readings(control_mode(self.cell))


def build(cell, seed: int, device: torch.device) -> TrainRun:
    return TrainRun(cell, seed, device)
