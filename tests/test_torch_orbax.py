"""The port reads the JAX package's orbax checkpoint directories
(`catre_tpu_torch/utils/checkpoint.py::read_orbax_params`) as written by
`catre_tpu/utils/checkpoint.py::save_checkpoint`, in both of its layouts:
`{"params": ...}` (its `tools/convert_checkpoint.py`) and a
`TrainState(params, opt_state, step)` with an optax state (its `do_train`).

Weights: `tests/torch_mirror.py` models (rotation heads over 64 + 1024
points) carried to flax by `torch_state_dict_to_params`. The port's
`build_model` reads the directory through MODEL.WEIGHTS (plain f32 refine of
the shipped config at NUM_PCL = 64), JAX restores the same directory with its
own `load_checkpoint`, and the 4-iteration refines agree within 5e-4
(`tests/test_fused_refine.py`). Also: the latest and an explicit step, a
temporary directory of an unfinished save skipped, a bf16 leaf read through
its bits, `tools/convert_checkpoint.py` from an orbax directory bit-equal to
the direct read, no jax or orbax imported by the read (a subprocess), and
with tensorstore blocked a raise that names the converter."""

import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from catre_tpu.config.build import model_config_from as jax_model_config_from
from catre_tpu.config.loader import apply_overrides as jax_apply_overrides
from catre_tpu.config.loader import load_config as jax_load_config
from catre_tpu.engine.refiner import make_refine_fn as jax_make_refine_fn
from catre_tpu.engine.train import TrainState
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.utils import checkpoint as jck
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
from catre_tpu_torch.config.loader import apply_overrides, load_config
from catre_tpu_torch.engine.refiner import make_refine_fn
from catre_tpu_torch.engine.runner import build_model
from catre_tpu_torch.entry import example_batch
from catre_tpu_torch.tools.convert_checkpoint import main as convert_main
from catre_tpu_torch.utils import checkpoint as ck

from torch_mirror import TorchCATRE, TorchConvOutPerRotHead

NPCL, B, N_IT = 64, 2, 4
OPTS = [f"INPUT.NUM_PCL={NPCL}", "MODEL.BF16=False", "MODEL.FUSED_HEADS=False",
        "MODEL.FUSED_HEADS_TRAIN=False", "MODEL.FUSED_ENCODER_TRAIN=False", "SEED=0"]
NAMES = ("pcl", "obj_kps", "obj_pose", "obj_scale", "K", "obj_mean_scales")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flax_params(seed):
    torch.manual_seed(seed)
    model = TorchCATRE()
    model.rot_head = TorchConvOutPerRotHead(num_points=NPCL + 1024)
    return jck.torch_state_dict_to_params(model.state_dict())


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """params: steps 2 and 5 (other weights), a tmp dir of step 9; train:
    a TrainState with an adam state at step 7."""
    root = tmp_path_factory.mktemp("orbax")
    p2, p5, p7 = _flax_params(1), _flax_params(2), _flax_params(3)
    jck.save_checkpoint(str(root / "params"), 2, {"params": p2})
    jck.save_checkpoint(str(root / "params"), 5, {"params": p5})
    tmp = root / "params" / "9.orbax-checkpoint-tmp-1792326972"
    (tmp / "default").mkdir(parents=True)
    (tmp / ck.ORBAX_STEP_FILE).write_text("{}")
    state = TrainState(p7, optax.adam(1e-3).init(p7), jnp.asarray(7))
    jck.save_checkpoint(str(root / "train"), 7, state)
    return {"root": root, "params": (str(root / "params"), {"params": p5}, "params"),
            "train": (str(root / "train"), state, "params"), "p2": p2}


def _cfg(weights):
    return apply_overrides(load_config(str(FLAGSHIP_CONFIG)), OPTS + [f"MODEL.WEIGHTS={weights}"])


@pytest.mark.parametrize("layout", ["params", "train"])
def test_build_model_reads_orbax_and_refines_as_jax(dirs, layout):
    path, abstract, _ = dirs[layout]
    restored = jck.load_checkpoint(path, abstract)
    params = restored["params"] if isinstance(restored, dict) else restored.params
    jcfg = jax_model_config_from(jax_apply_overrides(jax_load_config(str(FLAGSHIP_CONFIG)), OPTS))
    b = {k: v.numpy() for k, v in example_batch(B, NPCL, 1024, seed=4).items()}
    poses_ref, scales_ref = jax_make_refine_fn(JaxModel(jcfg), jcfg, n_iter=N_IT)(
        params, *(jnp.asarray(b[n]) for n in NAMES))

    model, mcfg, load_s = build_model(_cfg(path), "cpu")
    assert mcfg.num_pcl == NPCL and not mcfg.fused_heads and load_s > 0
    poses, scales = make_refine_fn(model, N_IT)(*(torch.from_numpy(b[n]) for n in NAMES))
    np.testing.assert_allclose(poses.numpy(), np.asarray(poses_ref), atol=5e-4, rtol=0)
    np.testing.assert_allclose(scales.numpy(), np.asarray(scales_ref), atol=5e-4, rtol=0)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == np.float32 and la[k].shape == lb[k].shape, k
        assert la[k].tobytes() == lb[k].astype(np.float32).tobytes(), k


def test_steps_tmp_dirs_and_bf16_leaves(dirs, tmp_path):
    path = dirs["params"][0]
    assert ck.is_orbax_dir(path) and ck.orbax_steps(path) == [2, 5]
    assert not ck.is_orbax_dir(str(tmp_path)) and ck.orbax_steps(str(tmp_path / "none")) == []
    _same_tree(ck.read_orbax_params(path), dirs["params"][1]["params"])
    _same_tree(ck.read_orbax_params(path, step=2), dirs["p2"])
    _same_tree(ck.read_orbax_params(dirs["train"][0]), dirs["train"][1].params)
    with pytest.raises(FileNotFoundError, match="steps"):
        ck.read_orbax_params(path, step=9)

    # a bf16 leaf comes back as the f32 of its bits
    vals = np.array([1.0, -2.5, 3.1415927, 1e-20, -0.0, 65504.0, 0.1], np.float32)
    jck.save_checkpoint(str(tmp_path / "bf16"), 0,
                        {"params": {"m": {"w": jnp.asarray(vals, jnp.bfloat16)}}})
    got = ck.read_orbax_params(str(tmp_path / "bf16"))["m"]["w"]
    want = np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_convert_tool_from_orbax_is_the_direct_read(dirs, tmp_path):
    path = dirs["params"][0]
    model, _, _ = build_model(_cfg(path), "cpu")
    direct = ck.load_orbax_checkpoint(path, model, step=2)
    out = str(tmp_path / "port")
    argv = [path, out, "--step", "2", "--config-file", str(FLAGSHIP_CONFIG)]
    with pytest.raises(ValueError, match="point_weight"):     # the 1024-point model
        convert_main(argv)
    cfg_file = tmp_path / "small.py"
    cfg_file.write_text(f"_base_ = [{str(FLAGSHIP_CONFIG)!r}]\nINPUT = dict(NUM_PCL={NPCL})\n")
    assert convert_main(argv[:-1] + [str(cfg_file)]) == 0
    assert ck.latest_step(out) == 2
    sd = ck.load_checkpoint(out)["model"]
    assert sorted(sd) == sorted(direct)
    for k in sd:
        assert torch.equal(sd[k], direct[k]), k
    loaded, _, _ = build_model(_cfg(out), "cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, direct[k]), k
    # a checkpoint directory of the port is not taken for an orbax one
    assert not ck.is_orbax_dir(out)
    with pytest.raises(FileNotFoundError, match="convert_checkpoint"):
        ck.load_checkpoint(path)


def test_read_imports_neither_jax_nor_orbax(dirs):
    code = (
        "import sys\n"
        "from catre_tpu_torch.utils import checkpoint as ck\n"
        f"tree = ck.read_orbax_params({dirs['params'][0]!r})\n"
        "assert tree['pcl_net']['conv1']['Dense_0']['kernel'].shape == (3, 64)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'orbax', 'flax', 'catre_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('read ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0 and "read ok" in proc.stdout, proc.stderr[-2000:]


def test_without_tensorstore_the_read_names_the_converter(dirs, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(RuntimeError, match="catre_tpu_torch.tools.convert_checkpoint"):
        ck.read_orbax_params(dirs["params"][0])
    with pytest.raises(RuntimeError, match="tensorstore"):
        build_model(_cfg(dirs["train"][0]), "cpu")
