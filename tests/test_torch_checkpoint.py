"""The port's checkpoints (`catre_tpu_torch/utils/checkpoint.py`) against the
JAX package's (`catre_tpu/utils/checkpoint.py`).

- The reference layout: a `tests/torch_mirror.py::TorchCATRE` state dict
  goes into the port through `state_dict_from_reference` and into JAX
  through `torch_state_dict_to_params`; one delta forward agrees within 2e-4
  (`tests/test_model_parity.py`) and the 4-iteration refine within 5e-4
  (`tests/test_fused_refine.py`). Every container of the reference's
  checkpointer (.pth bare and {'model'}, detectron2 .pkl, Caffe2 .pkl, a DDP
  `module.` prefix, a URL through torch.hub) gives the port the same state
  dict bit for bit, and JAX the same params, as the bare state dict
  (`tests/test_checkpoint_formats.py`). An unfilled parameter or a wrong
  shape raises; unread keys are named.
- The port's own checkpoints: model, Ranger with its Lookahead slow copies,
  step and CPU generator round-trip after one step, `keep` prunes, a
  directory without them raises and names what it holds.
- `tools/convert_checkpoint.py` writes a directory `runner.build_model`
  loads."""

import logging
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.engine.refiner import make_refine_fn as jax_make_refine_fn
from catre_tpu.models import CATREConfig as JaxConfig
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.utils import checkpoint as jck
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
from catre_tpu_torch.config.loader import load_config
from catre_tpu_torch.engine.refiner import make_refine_fn
from catre_tpu_torch.engine.runner import build_model
from catre_tpu_torch.entry import example_batch
from catre_tpu_torch.models.catre import CATREConfig, init_model
from catre_tpu_torch.solver.build import build_optimizer
from catre_tpu_torch.tools.convert_checkpoint import main as convert_main
from catre_tpu_torch.utils import checkpoint as ck

from torch_mirror import TorchCATRE

B, N_IT = 2, 4


@pytest.fixture(scope="module")
def mirror_sd():
    torch.manual_seed(0)
    return TorchCATRE().state_dict()


@pytest.fixture(scope="module")
def port_sd(mirror_sd):
    return ck.state_dict_from_reference(mirror_sd, init_model(CATREConfig(), seed=1))


def _port_model(sd):
    model = init_model(CATREConfig(), seed=2)
    model.load_state_dict(sd)
    return model


def _inputs(seed):
    b = example_batch(B, 1024, 1024, seed=seed)
    return {k: v.numpy() for k, v in b.items()}


def test_delta_forward_and_refine_match_jax(mirror_sd, port_sd):
    params = jck.torch_state_dict_to_params(mirror_sd)
    jcfg = JaxConfig()
    jmodel = JaxModel(jcfg)
    model = _port_model(port_sd)
    b = _inputs(3)
    x, kps = b["pcl"] - b["obj_pose"][:, None, :, 3], b["obj_kps"]
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(kps),
                       jnp.asarray(b["obj_scale"]), jnp.zeros((B, 3)))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(kps), torch.from_numpy(b["obj_scale"]),
                    torch.zeros(B, 3))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-4, rtol=0)

    names = ("pcl", "obj_kps", "obj_pose", "obj_scale", "K", "obj_mean_scales")
    poses_ref, scales_ref = jax_make_refine_fn(jmodel, jcfg, n_iter=N_IT)(
        params, *(jnp.asarray(b[n]) for n in names))
    poses, scales = make_refine_fn(model, N_IT)(*(torch.from_numpy(b[n]) for n in names))
    assert poses.shape == (N_IT + 1, B, 3, 4)
    np.testing.assert_allclose(poses.numpy(), np.asarray(poses_ref), atol=5e-4, rtol=0)
    np.testing.assert_allclose(scales.numpy(), np.asarray(scales_ref), atol=5e-4, rtol=0)


def _write(kind, path, sd):
    """Write `sd` in the container `kind`; -> the path the loaders take."""
    sd_np = {k: v.numpy() for k, v in sd.items()}
    if kind == "pth":
        torch.save(sd, path)
    elif kind == "pth_model":
        torch.save({"model": sd}, path)
    elif kind == "ddp":
        torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    elif kind == "d2_pkl":
        with open(path, "wb") as f:
            pickle.dump({"model": sd_np, "__author__": "Detectron2",
                         "matching_heuristics": True}, f)
    elif kind == "caffe2_pkl":
        blobs = dict(sd_np, weight_order=["x"])
        blobs["pcl_net.conv1.weight_momentum"] = np.zeros(3, np.float32)
        with open(path, "wb") as f:
            pickle.dump({"blobs": blobs}, f)
    return str(path)


@pytest.mark.parametrize("kind", ["pth", "pth_model", "ddp", "d2_pkl", "caffe2_pkl", "url"])
def test_every_container_gives_the_same_weights(kind, tmp_path, monkeypatch, mirror_sd, port_sd):
    if kind == "url":
        seen = {}

        def fake_load(url, map_location=None):
            seen["url"] = url
            return dict(mirror_sd)

        monkeypatch.setattr(torch.hub, "load_state_dict_from_url", fake_load)
        path = "https://example.org/model_final.pth"
    else:
        path = _write(kind, tmp_path / f"model.{'pkl' if kind.endswith('pkl') else 'pth'}",
                      mirror_sd)
    ours = ck.load_reference_checkpoint(path, init_model(CATREConfig(), seed=1))
    assert sorted(ours) == sorted(port_sd)
    for k, v in port_sd.items():
        assert ours[k].dtype == torch.float32 and torch.equal(ours[k], v), k
    theirs = jck.torch_state_dict_to_params(jck.load_torch_state_dict(path))
    want = jck.torch_state_dict_to_params(mirror_sd)
    la, lb = jax.tree_util.tree_leaves(theirs), jax.tree_util.tree_leaves(want)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if kind == "url":
        assert seen["url"].startswith("https://example.org/")


def test_key_map_splits_layer0_and_renames(mirror_sd, port_sd):
    w = mirror_sd["rot_head.rot_head_x.layers.0.weight"][:, :, 0]
    assert torch.equal(port_sd["rot_head.rot_head_x.layer0_global_weight"], w[:, :1024])
    assert torch.equal(port_sd["rot_head.rot_head_x.layer0_point_weight"], w[:, 1024:])
    pairs = {"rot_head.rot_head_y.gns.0.weight": "rot_head.rot_head_y.layers.1.weight",
             "rot_head.rot_head_y.layers.0.bias": "rot_head.rot_head_y.layers.3.bias",
             "rot_head.rot_head_y.gns.1.bias": "rot_head.rot_head_y.layers.4.bias",
             "ts_head.linears.1.weight": "ts_head.linears.3.weight",
             "ts_head.gns.1.weight": "ts_head.linears.4.weight",
             "pcl_net.fstn.fc3.bias": "pcl_net.fstn.fc3.bias"}
    for port_key, ref_key in pairs.items():
        assert torch.equal(port_sd[port_key], mirror_sd[ref_key]), port_key
    assert torch.equal(port_sd["rot_head.rot_head_x.point_weight"],
                       mirror_sd["rot_head.rot_head_x.conv_p.weight"].reshape(-1))
    assert torch.equal(port_sd["rot_head.rot_head_x.point_bias"],
                       mirror_sd["rot_head.rot_head_x.conv_p.bias"])
    assert torch.equal(port_sd["pcl_net.conv4.weight"], mirror_sd["pcl_net.conv4.weight"][:, :, 0])


def test_unfilled_or_misshapen_parameters_raise(mirror_sd, caplog):
    model = init_model(CATREConfig(), seed=1)
    partial = {k: v for k, v in mirror_sd.items() if not k.startswith("ts_head.fc_s")}
    with pytest.raises(ValueError, match="ts_head.fc_s"):
        ck.state_dict_from_reference(partial, model)
    bad = dict(mirror_sd)
    bad["pcl_net.conv2.weight"] = torch.zeros(128, 32, 1)
    with pytest.raises(ValueError, match="shape"):
        ck.state_dict_from_reference(bad, model)
    # a model with more points has a longer point_weight than the checkpoint
    with pytest.raises(ValueError, match="point_weight"):
        ck.state_dict_from_reference(mirror_sd, init_model(CATREConfig(num_pcl=1500), seed=1))
    extra = dict(mirror_sd, **{"rot_head.extra.weight": torch.zeros(3)})
    with caplog.at_level(logging.WARNING):
        ck.state_dict_from_reference(extra, model)
    assert "rot_head.extra.weight" in caplog.text


def test_fstn_is_optional(mirror_sd):
    model = init_model(CATREConfig(feature_transform=False), seed=1)
    no_fstn = {k: v for k, v in mirror_sd.items() if ".fstn." not in k}
    sd = ck.state_dict_from_reference(no_fstn, model)
    model.load_state_dict(sd)
    with pytest.raises(ValueError, match="fstn"):
        ck.state_dict_from_reference(no_fstn, init_model(CATREConfig(), seed=1))


def test_torchvision_scheme_needs_torchvision():
    try:
        import torchvision  # noqa: F401

        pytest.skip("torchvision installed; the scheme would resolve")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="torchvision"):
        ck.load_torch_state_dict("torchvision://resnet50")


def _trained(seed):
    """A small model and Ranger after one step on seeded gradients, and a CPU
    generator that has drawn."""
    cfg = load_config(str(FLAGSHIP_CONFIG))
    model = init_model(CATREConfig(num_pcl=64, num_kps=64), seed=seed)
    opt = build_optimizer(cfg.SOLVER, model.named_parameters())
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen) * 1e-2
    opt.step()
    torch.rand(5, generator=gen)
    return model, opt, gen


def _step(model, opt, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen) * 1e-2
    opt.step()


def test_native_checkpoint_round_trip(tmp_path):
    model, opt, gen = _trained(0)
    assert all("slow" in s for s in opt.state.values())
    d = str(tmp_path / "ckpt")
    for step in range(7):
        ck.save_checkpoint(d, step, {"model": model, "optimizer": opt, "generator": gen}, keep=3)
    assert ck.latest_step(d) == 6
    assert sorted(ck._step_files(d)) == [4, 5, 6]
    got = ck.load_checkpoint(d)
    assert got["step"] == 6 and ck.load_checkpoint(d, step=4)["step"] == 4
    with pytest.raises(FileNotFoundError, match="step 2"):
        ck.load_checkpoint(d, step=2)

    model2, opt2, _ = _trained(1)
    model2.load_state_dict(got["model"])
    opt2.load_state_dict(got["optimizer"])
    gen2 = torch.Generator()
    gen2.set_state(got["generator"])
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    for p, p2 in zip(model.parameters(), model2.parameters()):
        s, s2 = opt.state[p], opt2.state[p2]
        assert s["step"] == s2["step"] == 1
        for name in ("exp_avg", "exp_avg_sq", "slow"):
            assert torch.equal(s[name], s2[name]), name
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=gen2))
    # the restored pair steps on as the original does (through a Lookahead sync at 6)
    for i in range(6):
        _step(model, opt, 10 + i)
        _step(model2, opt2, 10 + i)
    for p, p2 in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, p2)


def test_directory_without_checkpoints_raises(tmp_path):
    assert ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.load_checkpoint(str(tmp_path / "none"))
    orbax = tmp_path / "orbax"
    (orbax / "0" / "default").mkdir(parents=True)
    (orbax / "0" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match="convert_checkpoint"):
        ck.load_checkpoint(str(orbax))


def test_convert_tool_writes_what_build_model_loads(tmp_path, mirror_sd, port_sd):
    pth = _write("pth_model", tmp_path / "model.pth", mirror_sd)
    out = tmp_path / "converted"
    assert convert_main([pth, str(out), "--step", "3"]) == 0
    assert ck.latest_step(str(out)) == 3
    cfg = load_config(str(FLAGSHIP_CONFIG))
    for weights in (str(out), pth):
        cfg.MODEL.WEIGHTS = weights
        model, mcfg, load_s = build_model(cfg, "cpu")
        assert mcfg.num_pcl == 1024 and load_s > 0
        for k, v in port_sd.items():
            assert torch.equal(model.state_dict()[k], v), (weights, k)
