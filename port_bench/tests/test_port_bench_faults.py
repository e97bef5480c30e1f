"""`correct` comes out false when the timed path is broken underneath or
when the control stands in the program's place: a whole run on the CPU at
a small size, the harness's look for a card skipped, under each cell's own
limits."""

import importlib

import pytest
import torch

TRAIN = ["shipped_bf16.train_b512", "recipe_f32.train_b120"]
TEST = ["shipped_bf16.test_g32", "recipe_f32.test_g32"]


def _unchanged_state(mp):
    from catre_tpu_torch.solver.ranger import Ranger
    mp.setattr(Ranger, "_update", lambda self: None)


def _half_batch_train(mp):
    import catre_tpu_torch.engine.train as train
    real = train.prepare_global_rows

    def half(generator, batch, noise_cfg, rank, world):
        out = real(generator, batch, noise_cfg, rank, world)
        n = out["pcl"].shape[0] // 2
        return {k: v[:n] for k, v in out.items()}
    mp.setattr(train, "prepare_global_rows", half)


def _altered_loss(mp):
    import catre_tpu_torch.engine.train as train
    real = train.catre_loss

    def altered(*args, **kw):
        out = real(*args, **kw)
        out["loss_PM_R"] = out["loss_PM_R"] * 1.5
        return out
    mp.setattr(train, "catre_loss", altered)


def _altered_loss_late(mp):
    """The loss altered from each step's second inner iteration on."""
    import catre_tpu_torch.engine.train as train
    real, calls = train.catre_loss, [0]

    def altered(*args, **kw):
        out = real(*args, **kw)
        calls[0] += 1
        if calls[0] % 4 != 1:
            out["loss_PM_R"] = out["loss_PM_R"] * 1.5
        return out
    mp.setattr(train, "catre_loss", altered)


def _wrong_handoff(mp):
    """The pose handed to each step's second and later inner iterations
    moved by 0.1 m."""
    import catre_tpu_torch.engine.train as train
    real, calls = train.refine_forward, [0]

    def moved(model, pcl, kps, pose_est, *args, **kw):
        calls[0] += 1
        if calls[0] % 4 != 1:
            pose_est = pose_est.clone()
            pose_est[:, :, 3] += 0.1
        return real(model, pcl, kps, pose_est, *args, **kw)
    mp.setattr(train, "refine_forward", moved)


def _altered_state(mp):
    """The second moments scaled by 1.1 after each Ranger step, the
    parameters' update left as it was."""
    from catre_tpu_torch.solver.ranger import Ranger
    real = Ranger._update

    def altered(self):
        real(self)
        for state in self.state.values():
            if "exp_avg_sq" in state:
                state["exp_avg_sq"].mul_(1.1)
    mp.setattr(Ranger, "_update", altered)


def _wrap_refine(mp, change):
    import catre_tpu_torch.engine.refiner as refiner
    real = refiner.make_refine_fn

    def make(model, n_iter):
        fn = real(model, n_iter)
        return lambda pcl, kps, pose, scale, K, mean_scales=None: change(
            fn, pcl, kps, pose, scale, K)
    mp.setattr(refiner, "make_refine_fn", make)


def _unchanged_refine(mp):
    def change(fn, pcl, kps, pose, scale, K):
        return pose[None].repeat(5, 1, 1, 1), scale[None].repeat(5, 1, 1)
    _wrap_refine(mp, change)


def _half_batch_refine(mp):
    def change(fn, pcl, kps, pose, scale, K):
        poses, scales = (t.clone() for t in fn(pcl, kps, pose, scale, K))
        h = pose.shape[0] // 2
        poses[:, h:] = pose[h:]
        scales[:, h:] = scale[h:]
        return poses, scales
    _wrap_refine(mp, change)


def _altered_answer(mp):
    def change(fn, pcl, kps, pose, scale, K):
        poses, scales = (t.clone() for t in fn(pcl, kps, pose, scale, K))
        poses[-1, 0, :, 3] += 0.1
        return poses, scales
    _wrap_refine(mp, change)


def _altered_point(mp):
    import catre_tpu_torch.data.loader as loader
    real = loader.make_group_sampler

    def make(cfg, train_aug, device="cuda"):
        fn = real(cfg, train_aug, device)

        def sample(*args, **kw):
            pcls, idx, n_in = fn(*args, **kw)
            pcls = pcls.clone()
            pcls[0, 0, 0, 0] += 0.002
            return pcls, idx, n_in
        return sample
    mp.setattr(loader, "make_group_sampler", make)


FAULTS = [(c, f) for c in TRAIN for f in (_unchanged_state, _half_batch_train, _altered_loss,
                                           _altered_loss_late, _wrong_handoff, _altered_state)] \
    + [(c, f) for c in TEST for f in (_unchanged_refine, _half_batch_refine, _altered_answer,
                                       _altered_point)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny_run, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = tiny_run(cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", TRAIN + TEST)
def test_sound_run_is_correct(tiny_run, cell):
    r = tiny_run(cell)
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("cell", TRAIN + TEST)
def test_control_is_not_correct(tiny_cell, cell):
    """The reference one precision below the configuration's, in the
    program's place, fails one of the cell's numbers."""
    c = tiny_cell(cell)
    driver = importlib.import_module(f"port_bench.drivers.{c.workload['driver']}")
    run = driver.build(c, 3000000555, torch.device("cpu"))
    if not run.training:
        run.call()
    got = run.control()
    assert any(got[k] > lim for k, lim in c.workload["limits"].items()), got
