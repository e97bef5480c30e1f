"""The port over several processes (`catre_tpu_torch/parallel/`, the train
step, `do_train`, `do_test` and the CLI over a process group) on the CPU.

- `comm` at world 1 is a no-op as JAX's is; `inference_slice` partitions
  [0, n) exactly and equals JAX's on its case grid; `pad_to_multiple` equals
  JAX's; the backend follows the devices; the launcher's refusals.
- The loss of a batch equals the sum of its halves' losses when each half
  divides by the whole batch's mask counts (`masked_mean`'s `count`).
- One module fixture writes a split of 13 frames and the inputs, then runs
  `tests/_torch_parallel_worker.py` (jax, flax and catre_tpu blocked there):
  two gloo processes through `parallel.launch`, then world 1 in the
  launcher's process. The global batch is 8 rows of 64 + 64 points, rank 0
  rows 0-3 (4 valid, 2 of them symmetric), rank 1 rows 4-7 (2 valid, 1
  symmetric); the model is the shipped width's at those points, JAX's
  weights converted.
  (a) two steps with the port's own draws (both augmentation coins at 1),
      world 2 against world 1: the losses before the first optimizer step
      within rtol 1e-5 (measured 2.2e-7), every later loss within 1e-4
      (measured 1.1e-5 at one thread a rank, 3.7e-5 at four), the parameters
      within 2e-5 x max(1, max|p|) (measured 3.3e-6 to 4.2e-6: 7.1e-5 on a
      bias of 26), the two ranks' parameters bit-equal. The later figures are
      f32 summation order carried by Ranger's normalised steps: world 1 alone
      on one thread against eight gives first gradients 3.8e-4 apart relative
      to their norms (a max-pool's arg-max moves with the order of a sum);
  (b) two steps on the batches JAX prepared, world 2 against JAX's step on
      the 8-device CPU mesh (`tests/test_parallel.py`'s set-up): losses
      rtol 2e-3, parameters atol 1e-3 (`tests/test_torch_do_train.py`'s);
  (c) `do_test` on the split's first 6 frames: rank 0's summaries equal
      world 1's within 1e-9, its predictions bit-equal; rank 1's results are
      empty;
  (d) the train loader over the 13 records splits the first epoch 7 / 6,
      disjoint and complete.
- (e) `python -m catre_tpu_torch.main --device cpu --num-chips 2` trains 2
  iterations with a checkpoint and one evaluation, the split found under
  CATRE_DATA_ROOT through the dataset cache; only rank 0 writes
  metrics.json; a run in which rank 1 fails exits non-zero.
"""

import copy
import json
import os
import os.path as osp
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.engine.train import InputNoiseConfig as JaxNoiseConfig
from catre_tpu.engine.train import TrainState as JaxTrainState
from catre_tpu.engine.train import make_train_step as jax_make_train_step
from catre_tpu.engine.train import prepare_train_batch as jax_prepare_train_batch
from catre_tpu.geom import axis_symmetry_rotation_bank
from catre_tpu.losses import LossConfig as JaxLossConfig
from catre_tpu.models import CATREConfig as JaxConfig
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.models import init_params
from catre_tpu.parallel import comm as jcomm
from catre_tpu.parallel import make_mesh, replicate_tree, shard_batch
from catre_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from catre_tpu.solver import build_optimizer as jax_build_optimizer
from catre_tpu_torch.data import meta, nocs
from catre_tpu_torch.entry import train_batch, write_example_split
from catre_tpu_torch.losses import LossConfig, catre_loss
from catre_tpu_torch.losses.catre_loss import loss_masks
from catre_tpu_torch.models.catre import CATREConfig, init_model
from catre_tpu_torch.parallel import comm, launch, mesh
from catre_tpu_torch.utils.convert import params_from_jax

import _torch_parallel_worker as W
from test_engine import _synthetic_batch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
VALID = np.array([1, 1, 1, 1, 1, 1, 0, 0], dtype=bool)
SYM = np.array([1, 1, 0, 0, 1, 0, 0, 0], dtype=bool)
FRAMES, CLI_FRAMES = 13, 4
# world 2 vs world 1: the losses before any update, every later one, the parameters x max(1, |p|)
LOSS_RTOL, LATER_LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4, 2e-5
JAX_LOSS_RTOL, JAX_PARAM_ATOL = 2e-3, 1e-3    # vs JAX's sharded step
WORKER_TIMEOUT_S = 300
THREADS = "2"            # OMP_NUM_THREADS of a launch: one thread a rank beside the suite's workers


def _env(data_root=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "CATRE_"))}
    env["OMP_NUM_THREADS"] = THREADS
    if data_root is not None:
        env["CATRE_DATA_ROOT"] = data_root
    return env


def _write_table(data_root):
    path = osp.join(data_root, "NOCS", "obj_models", osp.basename(meta.CR_MEAN_MODEL_PATH))
    os.makedirs(osp.dirname(path))
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        pickle.dump({o: rng.normal(size=(32, 3)).astype(np.float32) * 0.1
                     for o in meta.OBJECTS}, f)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's outputs (rank 0, rank 1, world 1) and JAX's sharded run
    (metrics of each step, final parameters under the port's names)."""
    work = str(tmp_path_factory.mktemp("parallel"))
    data_root = osp.join(work, "data")
    os.makedirs(osp.join(work, "split"))
    records = write_example_split(osp.join(work, "split"), FRAMES, h=96, w=128, m=4, seed=5)
    _write_table(data_root)

    jcfg = JaxConfig(num_pcl=W.NPTS, num_kps=W.NPTS)
    params = init_params(JaxModel(jcfg), jcfg, jax.random.PRNGKey(1))
    port = init_model(CATREConfig(num_pcl=W.NPTS, num_kps=W.NPTS), seed=0)
    weights = params_from_jax(_np(params), port)
    batch = {k: np.array(v) for k, v in _synthetic_batch(b=8, p=W.NPTS, k=W.NPTS,
                                                          seed=7).items()}
    batch["valid"], batch["sym_flag"] = VALID.copy(), SYM.copy()
    jnoise = JaxNoiseConfig(bbox3d_aug_prob=0.0, rt_aug_prob=0.0)
    keys = jax.random.split(jax.random.PRNGKey(2), W.STEPS)
    prepared = [{k: np.array(v) for k, v in jax_prepare_train_batch(key, dict(batch),
                                                                     jnoise).items()}
                for key in keys]
    torch.save({"weights": weights, "batch": batch, "prepared": prepared, "records": records,
                "data_root": data_root}, osp.join(work, "inputs.pt"))
    proc = subprocess.Popen([sys.executable, osp.join(ROOT, "tests", "_torch_parallel_worker.py"),
                             work], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # JAX's step on the 8-device mesh while the workers run
        tx = jax_build_optimizer({"OPTIMIZER_CFG": {"type": "Ranger", "lr": W.LR}})
        jstep = jax_make_train_step(JaxModel(jcfg), jcfg, JaxLossConfig(), jnoise, tx,
                                    axis_symmetry_rotation_bank(max_sym_disc_step=0.1),
                                    n_iter=W.N_ITER)
        dp = make_mesh(8)
        jstate = JaxTrainState(replicate_tree(dp, params), replicate_tree(dp, tx.init(params)),
                               replicate_tree(dp, jnp.zeros([], jnp.int32)))
        jmetrics = []
        with dp:
            for key in keys:
                jstate, m = jstep(jstate, shard_batch(dp, dict(batch)), key, W.LR)
                jmetrics.append({k: np.asarray(v) for k, v in m.items()})
        jparams = params_from_jax(_np(jstate.params), port)
        log, _ = proc.communicate(timeout=WORKER_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "parallel worker ok" in log, log[-6000:]
    outs = [torch.load(osp.join(work, f"{name}.pt"), weights_only=False)
            for name in ("rank0", "rank1", "world1")]
    return {"ranks": outs[:2], "world1": outs[2], "jax": (jmetrics, jparams),
            "records": records, "work": work}


# ---- world 1, and the pieces without a group

def test_comm_is_a_no_op_at_world_one():
    comm.init_dist()
    assert (comm.get_rank(), comm.get_world_size()) == (0, 1)
    assert comm.is_main_process() and not comm.is_dist_avail_and_initialized()
    assert comm.all_gather({"a": 1}) == [{"a": 1}]
    assert comm.reduce_dict({"x": 2.0}) == {"x": 2.0}
    np.testing.assert_array_equal(comm.gather_arrays(np.arange(3)), np.arange(3))
    t = torch.arange(3.0)
    assert comm.all_reduce_(t) is t and t.tolist() == [0.0, 1.0, 2.0]
    comm.synchronize()
    comm.destroy()


def test_inference_slice_covers_exactly_once():
    """JAX's case grid: every record on exactly one rank, n < world and n %
    world != 0 included, each slice JAX's."""
    for n in (0, 1, 3, 7, 8, 9, 100):
        for world in (1, 2, 3, 8):
            ids = []
            for rank in range(world):
                sl = comm.inference_slice(n, rank, world)
                assert sl == jcomm.inference_slice(n, rank, world)
                ids.extend(range(n)[sl])
            assert ids == list(range(n)), (n, world, ids)


def test_pad_to_multiple_matches_jax():
    rng = np.random.default_rng(0)
    batch = {"pcl": rng.normal(size=(13, 4, 3)), "valid": np.ones(13, dtype=bool),
             "obj_cls": np.arange(13)}
    out, want = mesh.pad_to_multiple(batch, 8), jax_pad_to_multiple(batch, 8)
    assert out["pcl"].shape[0] == 16 and out["valid"].sum() == 13
    for k in batch:
        np.testing.assert_array_equal(out[k], want[k])
    assert mesh.pad_to_multiple(batch, 13) is batch


def test_backend_follows_the_devices():
    assert comm.backend_for(["cpu", "cpu"]) == "gloo"
    assert comm.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert comm.backend_for(["cuda:0", "cuda:0"]) == "gloo"     # two ranks on one card


def test_launch_refusals(monkeypatch):
    with pytest.raises(ValueError, match="--dist-url"):
        launch.launch(print, (), ["cpu"], num_machines=2)
    with pytest.raises(ValueError, match="machine rank"):
        launch.launch(print, (), ["cpu"], num_machines=2, machine_rank=2,
                      dist_url="tcp://127.0.0.1:1")
    assert launch.launch(lambda device, x: (device, x), (5,), ["cpu"]) == ("cpu", 5)
    assert launch.local_devices(2, "cpu") == ["cpu", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert launch.local_devices(0, "cuda") == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="2 card"):
        launch.local_devices(3, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        launch.local_devices(2, "cuda")


def test_loss_shares_sum_to_the_batch_loss():
    """Each half divided by the whole batch's mask counts: the two halves'
    terms sum to the whole batch's, and so do their gradients."""
    b = train_batch(8, 32, 32, seed=3)
    valid, sym = torch.from_numpy(VALID), torch.from_numpy(SYM)
    noise = torch.randn(8, 3, 3, generator=torch.Generator().manual_seed(0))
    out_rot = (b["obj_pose"][:, :3, :3] + 0.05 * noise).requires_grad_()
    args = dict(out_trans=b["obj_pose"][:, :3, 3] + 0.01, out_scale=b["obj_scale"] * 1.1,
                gt_rot=b["obj_pose"][:, :3, :3], gt_trans=b["obj_pose"][:, :3, 3],
                gt_scale=b["obj_scale"], obj_kps=b["obj_kps"])
    bank = torch.as_tensor(axis_symmetry_rotation_bank(max_sym_disc_step=0.1))
    whole = catre_loss(LossConfig(), out_rot=out_rot, sym_flags=sym, sym_bank=bank,
                       valid_mask=valid, **args)
    g_whole, = torch.autograd.grad(sum(whole.values()), out_rot)
    counts = {k: m.sum() for k, m in loss_masks(sym, valid).items()}
    shares, g_shares = [], torch.zeros_like(out_rot)
    for rows in (slice(0, 4), slice(4, 8)):
        part = catre_loss(LossConfig(), out_rot=out_rot[rows], sym_flags=sym[rows],
                          sym_bank=bank, valid_mask=valid[rows], counts=counts,
                          **{k: v[rows] for k, v in args.items()})
        g_shares += torch.autograd.grad(sum(part.values()), out_rot)[0]
        shares.append(part)
    assert sorted(whole) == sorted(shares[0])
    for k in whole:
        torch.testing.assert_close(shares[0][k] + shares[1][k], whole[k], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(g_shares, g_whole, rtol=1e-5, atol=1e-7)


# ---- two gloo processes against world 1 and JAX

def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def test_world_two_train_steps_equal_world_one(runs):
    ranks, ref = runs["ranks"], runs["world1"]["own"]
    for r in ranks:
        for step, (m, want) in enumerate(zip(r["own"]["metrics"], ref["metrics"])):
            assert sorted(m) == sorted(want)
            for k in want:
                if step == 0:       # inner iteration 0 comes before any optimizer step
                    _close(m[k][:1], want[k][:1], LOSS_RTOL, 0, f"step 0 iteration 0 {k}")
                _close(m[k], want[k], LATER_LOSS_RTOL, 0, f"step {step} {k}")
        for name, p in ref["params"].items():
            _close(r["own"]["params"][name].numpy(), p.numpy(), 0,
                   PARAM_RTOL * max(1.0, p.abs().max().item()), name)
    for name, p in ranks[0]["own"]["params"].items():
        assert torch.equal(p, ranks[1]["own"]["params"][name]), name


def test_world_two_matches_jax_sharded_step(runs):
    jmetrics, jparams = runs["jax"]
    for r in runs["ranks"]:
        for step, (m, jm) in enumerate(zip(r["jax"]["metrics"], jmetrics)):
            for k in ("loss_total", "loss_PM_R", "loss_rot", "loss_yaxis_rot", "error_t"):
                _close(m[k], jm[k], JAX_LOSS_RTOL, 0, f"step {step} {k}")
        for name, p in jparams.items():
            _close(r["jax"]["params"][name].numpy(), p.numpy(), 0, JAX_PARAM_ATOL, name)


def test_world_two_do_test_equals_world_one(runs):
    (rank0, rank1), ref = runs["ranks"], runs["world1"]["test"]
    assert rank1["test"]["results"] == {}
    got = rank0["test"]["results"]
    assert sorted(got) == sorted(ref["results"]) == [0, 1]
    for it, res in ref["results"].items():
        for k, v in res["summary"].items():
            assert got[it]["summary"][k] == pytest.approx(v, abs=1e-9), (it, k)


def test_world_two_predictions_are_world_one_s(runs):
    """rank 0's predictions.pkl holds every image, bit-equal to world 1's."""
    got, want = [pickle.load(open(osp.join(runs["work"], d, "predictions.pkl"), "rb"))
                 for d in ("test_world2", "test_world1")]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b) and len(b) == W.TEST_FRAMES
        for sid in b:
            for k in b[sid]:
                assert a[sid][k].tobytes() == b[sid][k].tobytes(), (sid, k)


def test_train_loader_splits_the_epoch(runs):
    ids0, ids1 = (r["loader"] for r in runs["ranks"])
    assert (len(ids0), len(ids1)) == (7, 6)
    assert set(ids0).isdisjoint(ids1)
    assert set(ids0) | set(ids1) == {r["scene_im_id"] for r in runs["records"]}


# ---- the command line over two processes

def _cli_root(tmp_path, records):
    """A data root whose dataset cache holds `records` as nocs_train_real and
    nocs_test_real, with the mean-shape table."""
    root = str(tmp_path / "data")
    _write_table(root)
    old = meta.DATA_ROOT
    try:
        meta.set_data_root(root)
        for name in ("nocs_train_real", "nocs_test_real"):
            path = nocs.NOCSDataset(name)._cache_path()
            os.makedirs(osp.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(records, f)
    finally:
        meta.set_data_root(old)
    return root


def _cli(root, out, *extra):
    opts = [f"OUTPUT_DIR={out}", "SEED=0", "INPUT.NUM_PCL=32", "INPUT.NUM_KPS=32",
            "SOLVER.IMS_PER_BATCH=2", "SOLVER.TOTAL_EPOCHS=1", "MODEL.CATRE.N_ITER_TRAIN=1",
            "SOLVER.WARMUP_ITERS=1", "TRAIN.PRINT_FREQ=1", "SOLVER.CHECKPOINT_PERIOD=1",
            "TEST.EVAL_PERIOD=2",
            "MODEL.LOAD_POSES_TEST=False", "TEST.IMS_PER_BATCH=2", "MODEL.CATRE.N_ITER_TEST=1",
            "DATALOADER.MAX_OBJS_PER_IMAGE=4", "DATALOADER.NUM_WORKERS=0"]
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG

    return subprocess.run([sys.executable, "-m", "catre_tpu_torch.main", "--config-file",
                           str(FLAGSHIP_CONFIG), "--device", "cpu", "--num-chips", "2", *extra,
                           *opts], cwd=ROOT, env=_env(root), capture_output=True, text=True,
                          timeout=WORKER_TIMEOUT_S)


def test_cli_trains_and_evaluates_over_two_processes(runs, tmp_path):
    root = _cli_root(tmp_path, runs["records"][:CLI_FRAMES])
    out = tmp_path / "out"
    proc = _cli(root, out)
    assert proc.returncode == 0, proc.stderr[-6000:]
    files = set(os.listdir(out))
    assert {"log.txt", "log.rank1.txt", "config_dump.py", "metrics.json", "ckpt",
            "predictions.pkl"} <= files
    assert [f for f in files if "rank" in f] == ["log.rank1.txt"]
    lines = [json.loads(x) for x in open(out / "metrics.json")]
    assert [x["iteration"] for x in lines] == [0, 1]               # once each: rank 0 alone
    assert all(np.isfinite(x["loss_total"]) for x in lines)
    assert sorted(os.listdir(out / "ckpt")) == ["step_00000001.pt"]
    assert "training done: 2 iterations" in (out / "log.rank1.txt").read_text()
    assert "a process group of 2, backend gloo" in (out / "log.txt").read_text()
    with open(out / "predictions.pkl", "rb") as f:
        preds = pickle.load(f)
    assert sorted(preds[0]) == sorted(r["scene_im_id"] for r in runs["records"][:CLI_FRAMES])


def test_cli_exits_non_zero_when_a_rank_fails(runs, tmp_path):
    """rank 1's share of the test split (records 2 and 3) holds a depth file
    that is no PNG: rank 1 raises, rank 0 is stopped, the command fails."""
    records = copy.deepcopy(runs["records"][:CLI_FRAMES])
    bad = tmp_path / "bad_depth.png"
    bad.write_bytes(b"not a png")
    records[3]["depth_file"] = str(bad)
    root = _cli_root(tmp_path, records)
    proc = _cli(root, tmp_path / "out", "--eval-only")
    assert proc.returncode != 0
    assert "process 1 terminated with" in proc.stderr or "bad_depth" in proc.stderr, \
        proc.stderr[-4000:]
