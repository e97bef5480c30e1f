"""The port's training runner (`catre_tpu_torch/engine/runner.py::do_train`)
against the JAX package's `do_train` on the CPU.

Set-up, after `tests/test_torch_runner.py`: `entry.write_example_split`'s
split (8 frames of 120 x 160, 4 slots) registered as `nocs_train_real` and
`nocs_test_real` in both registries; both mean-shape tables patched to one
seeded table; both packages reading one reference-layout `.pth` as
MODEL.WEIGHTS; the shipped `..._120e_tpu.py` with bf16 and the fused flags
off, NUM_PCL 64, IMS_PER_BATCH 4, TOTAL_EPOCHS 2, N_ITER_TRAIN 2,
N_ITER_TRAIN_WARM_EPOCH 2, WARMUP_ITERS 1, CHECKPOINT_PERIOD 1 and PRINT_FREQ
1: 4 iterations at n = 1, 1, 2, 2, checkpoints at iterations 1 and 3.

The draws are made the same on both sides. The loader's: the port's train
loader takes the priority and depth-augmentation fields that the JAX loader
draws from its image keys (`test_torch_train_loader.JaxDraws`), so the clouds
are within 2 ulp of each point's depth of JAX's jitted loader. The step's:
NOISE_ROT_STD_TRAIN, NOISE_TRANS_STD_TRAIN and NOISE_SCALE_STD_TRAIN are zero
and BBOX3D_AUG_PROB / RT_AUG_PROB are 0 in both configs, so each step's init
is the gt on both sides whatever its generator draws (the port's generator is
not JAX's key). The tensorboard writer of both packages is stubbed: it would
import TensorFlow here, and `test_torch_train_cli.py` holds the port's.

JAX's `do_train` runs once, in a module-scoped fixture. Checks: metrics.json
has the same iterations and keys (iter0/* alone in epoch 1), lr and epoch
equal, every iter{i}/loss_* within rtol 2e-3, the same checkpoint steps, and
the port's last checkpoint within atol 1e-3 of JAX's last orbax checkpoint
(read with JAX's `load_checkpoint`, mapped by `params_from_jax`).
"""

import copy
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catre_tpu.config.loader import apply_overrides as jax_apply_overrides
from catre_tpu.config.loader import load_config as jax_load_config
from catre_tpu.data import assets as jassets
from catre_tpu.data import loader as jl
from catre_tpu.data import nocs as jnocs
from catre_tpu.engine import runner as jrunner
from catre_tpu.engine.train import TrainState as JaxTrainState
from catre_tpu.solver import build_optimizer as jax_build_optimizer
from catre_tpu.utils import checkpoint as jckpt
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, model_config_from
from catre_tpu_torch.config.loader import apply_overrides, load_config
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.data import nocs as tnocs
from catre_tpu_torch.engine import runner
from catre_tpu_torch.entry import write_example_split
from catre_tpu_torch.models.catre import init_model
from catre_tpu_torch.utils import checkpoint as tckpt
from catre_tpu_torch.utils.convert import params_from_jax

from test_torch_train_loader import JaxDraws
from torch_mirror import TorchCATRE, TorchConvOutPerRotHead

M, NPCL, H, W, FRAMES = 4, 64, 120, 160, 8
TABLE = np.random.default_rng(11).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
NAMES = ("nocs_train_real", "nocs_test_real")
LOSS_RTOL, PARAM_ATOL = 2e-3, 1e-3
ITERS, CKPT_STEPS = 4, [1, 3]


class _NoTensorboard:
    def __init__(self, logdir):
        pass

    def write(self, storage):
        storage.pop_images()
        storage.pop_histograms()

    def close(self):
        pass


def _opts(out_dir, weights):
    return [f"OUTPUT_DIR={out_dir}", f"MODEL.WEIGHTS={weights}", "SEED=0",
            f"INPUT.NUM_PCL={NPCL}", "MODEL.BF16=False", "MODEL.FUSED_HEADS=False",
            "MODEL.FUSED_HEADS_TRAIN=False", "MODEL.FUSED_ENCODER_TRAIN=False",
            "SOLVER.IMS_PER_BATCH=4", "SOLVER.TOTAL_EPOCHS=2", "MODEL.CATRE.N_ITER_TRAIN=2",
            "MODEL.CATRE.N_ITER_TRAIN_WARM_EPOCH=2", "SOLVER.WARMUP_ITERS=1",
            "SOLVER.CHECKPOINT_PERIOD=1", "TRAIN.PRINT_FREQ=1", "DATALOADER.NUM_WORKERS=0",
            f"DATALOADER.MAX_OBJS_PER_IMAGE={M}",
            "INPUT.NOISE_ROT_STD_TRAIN=(0.0,)", "INPUT.NOISE_TRANS_STD_TRAIN=[(0.0, 0.0, 0.0)]",
            "INPUT.NOISE_SCALE_STD_TRAIN=[(0.0, 0.0, 0.0)]", "INPUT.BBOX3D_AUG_PROB=0.0",
            "INPUT.RT_AUG_PROB=0.0"]


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's do_train on the same split, weights and draws -> the
    output directories (port, jax) and the port's returned state."""
    root = tmp_path_factory.mktemp("do_train")
    split = write_example_split(str(root), FRAMES, h=H, w=W, m=M, seed=7)
    torch.manual_seed(5)
    ref = TorchCATRE()
    ref.rot_head = TorchConvOutPerRotHead(num_points=NPCL + 1024)
    weights = str(root / "model.pth")
    torch.save({"model": ref.state_dict()}, weights)
    assert tl.auto_sample_window(split, "train") == 64      # the window JaxDraws assumes

    mp = pytest.MonkeyPatch()
    fresh = functools.partial(copy.deepcopy, split)
    try:
        for name in NAMES:
            mp.setitem(jnocs._DATASET_REGISTRY, name, fresh)
            mp.setitem(tnocs._DATASET_REGISTRY, name, fresh)
        mp.setattr(jassets, "mean_shape_array", lambda *a, **k: TABLE)
        mp.setattr(tassets, "mean_shape_array", lambda *a, **k: TABLE)
        mp.setattr(jrunner, "TensorboardWriter", _NoTensorboard)
        mp.setattr(runner, "TensorboardWriter", _NoTensorboard)
        jd = JaxDraws(0, True)
        mp.setattr(runner, "CATRELoader", functools.partial(tl.CATRELoader, draws=jd.draws,
                                                            aug_draws=jd.aug_draws))
        tl.clear_decoded_caches()
        jl._DECODED_CACHE_REGISTRY.clear()
        port_dir, jax_dir = root / "port", root / "jax"
        state = runner.do_train(apply_overrides(load_config(str(FLAGSHIP_CONFIG)),
                                                _opts(port_dir, weights)), device="cpu")
        jcfg = jax_apply_overrides(jax_load_config(str(FLAGSHIP_CONFIG)), _opts(jax_dir, weights))
        jrunner.do_train(jcfg)
    finally:
        mp.undo()
        tl.clear_decoded_caches()
        jl._DECODED_CACHE_REGISTRY.clear()
    return port_dir, jax_dir, jcfg, state


def test_metrics_json_matches_jax(runs):
    """The same iterations and keys; lr and epoch equal; the warm-up's refine
    counts (iter1/* from epoch 2 on)."""
    port, ref = _metrics(runs[0]), _metrics(runs[1])
    assert [r["iteration"] for r in port] == [r["iteration"] for r in ref] == list(range(ITERS))
    for a, b in zip(port, ref):
        assert sorted(a) == sorted(b), a["iteration"]
        assert a["lr"] == b["lr"] and a["epoch"] == b["epoch"]
        n = 1 if a["epoch"] == 1 else 2
        assert {k.split("/")[0] for k in a if k.startswith("iter") and "/" in k} == \
            {f"iter{i}" for i in range(n)}
    assert [r["epoch"] for r in port] == [1, 1, 2, 2]
    assert "time" not in port[0] and "time" in port[1]


def test_train_step_matches_jax(runs):
    """Every iteration's iter{i}/loss_* and loss_total within rtol 2e-3."""
    port, ref = _metrics(runs[0]), _metrics(runs[1])
    n_checked = 0
    for a, b in zip(port, ref):
        for k in a:
            if "/loss_" in k or k == "loss_total":
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                           err_msg=f"{a['iteration']} {k}")
                n_checked += 1
    assert n_checked > 3 * ITERS


def test_checkpoints_match_jax(runs):
    """The same checkpoint steps; the port's last checkpoint, which is its
    final state, within atol 1e-3 of JAX's last orbax checkpoint."""
    port_dir, jax_dir, jcfg, state = runs
    assert sorted(tckpt._step_files(str(port_dir / "ckpt"))) == CKPT_STEPS
    assert jckpt.latest_step(str(jax_dir / "ckpt")) == CKPT_STEPS[-1]
    assert sorted(int(d) for d in os.listdir(jax_dir / "ckpt") if d.isdigit()) == CKPT_STEPS

    _, _, params = jrunner.build_model(jcfg)
    target = JaxTrainState(params, jax_build_optimizer(jcfg.SOLVER).init(params),
                           jnp.zeros([], jnp.int32))
    restored = jckpt.load_checkpoint(str(jax_dir / "ckpt"), target)
    saved = tckpt.load_checkpoint(str(port_dir / "ckpt"))
    assert saved["step"] == CKPT_STEPS[-1] and state.step == ITERS
    model = init_model(model_config_from(jcfg))
    ref = params_from_jax(restored.params, model)
    assert sorted(ref) == sorted(saved["model"]) == sorted(state.params)
    for k, v in ref.items():
        assert torch.equal(saved["model"][k], state.params[k].detach()), k
        np.testing.assert_allclose(saved["model"][k].numpy(), v.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
