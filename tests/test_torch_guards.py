"""Guards of the PyTorch port: it runs without JAX, its kernels build only
where nvcc is, the chip smoke check refuses a host without a card, and the
card-only tests are marked and skip here."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from catre_tpu_torch import ops
from catre_tpu_torch.ops import _build
from catre_tpu_torch.ops import encoder_epilogue as enc_ops

ROOT = Path(__file__).resolve().parents[1]


def _run(args, timeout=600):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from catre_tpu_torch.entry import entry\n"
        "fn, args = entry(device='cpu', batch_size=2)\n"
        "poses, scales = fn(*args)\n"
        "assert poses.shape == (5, 2, 3, 4) and scales.shape == (5, 2, 3)\n"
        "assert torch.isfinite(poses).all() and torch.isfinite(scales).all()\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "print('port ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "port ok" in proc.stdout


@pytest.mark.parametrize("override", ["fused_encoder=True", "fused_block_size=2"])
def test_port_variants_run_with_jax_blocked(override):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from catre_tpu_torch.entry import entry\n"
        f"fn, args = entry(device='cpu', batch_size=2, num_pcl=64, num_kps=64, {override})\n"
        "poses, scales = fn(*args)\n"
        "assert poses.shape == (5, 2, 3, 4) and scales.shape == (5, 2, 3)\n"
        "assert torch.isfinite(poses).all() and torch.isfinite(scales).all()\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "print('variant ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "variant ok" in proc.stdout


def test_port_trains_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from catre_tpu_torch.entry import flagship_config, train_entry\n"
        "cfg = flagship_config()\n"
        "assert cfg.uses_rot_head_train_kernels and cfg.uses_tail_train_kernels\n"
        "state, hist = train_entry(device='cpu', batch_size=2, steps=1, num_pcl=64, num_kps=64)\n"
        "assert state.step == 1 and hist[0]['loss_total'].shape == (4,)\n"
        "assert all(torch.isfinite(v).all() for m in hist for v in m.values())\n"
        "assert all(torch.isfinite(p).all() for p in state.params.values())\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "print('train ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "train ok" in proc.stdout


def test_sampler_and_loader_run_with_jax_blocked():
    code = (
        "import sys\n"
        "for blocked in ('jax', 'flax', 'cv2', 'PIL'):\n"
        "    sys.modules[blocked] = None\n"
        "import torch\n"
        "from catre_tpu_torch.ops import sampling\n"
        "from catre_tpu_torch.data import aug, loader\n"
        "from catre_tpu_torch.entry import example_frames\n"
        "f = example_frames(2, 96, 128, m=4, objs=(1, 4), size_px=(16, 60))\n"
        "args = [f[k] for k in ('depth', 'K', 'packed', 'poses', 'scales', 'mask_bbox')]\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "for window, train in ((48, False), (0, True)):\n"
        "    cfg = loader.LoaderConfig(num_pcl=32, sample_window=window, max_objs_per_image=4)\n"
        "    sample = loader.make_group_sampler(cfg, train, device='cpu')\n"
        "    pcl, idx, n = sample(*args, generator=gen)\n"
        "    assert pcl.shape == (2, 4, 32, 3) and torch.isfinite(pcl).all()\n"
        "    assert idx.shape == (2, 4, 32) and n.shape == (2, 4)\n"
        "d = aug.aug_depth(sampling.depth_metres(torch.from_numpy(f['depth'])), gen)\n"
        "assert d.shape == (2, 96, 128)\n"
        "# the whole test loader, on frames written to disk and read back\n"
        "import tempfile\n"
        "import numpy as np\n"
        "from catre_tpu_torch.entry import shipped_test_loader, write_example_split\n"
        "table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32)\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    recs = write_example_split(root, 5, 96, 128, m=4)\n"
        "    for cache in ('device', '', 'ram'):\n"
        "        ld = shipped_test_loader(recs, device='cpu', mean_points=table, num_pcl=32,\n"
        "                                 ims_per_batch=2, num_workers=2, cache_decoded=cache)\n"
        "        batches = list(ld)\n"
        "        assert [len(b['scene_im_ids']) for b in batches] == [2, 2, 2]\n"
        "        assert all(torch.isfinite(b['pcl']).all() for b in batches)\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "assert not any(sys.modules.get(m) for m in ('jax', 'flax', 'cv2', 'PIL'))\n"
        "print('sampler ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "sampler ok" in proc.stdout


def test_evaluator_runs_with_jax_blocked():
    """`entry.evaluate_split` (the shipped loader, refine, `CATREEvaluator` and
    `run_inference`) and the standalone scorer without jax, flax, cv2 or PIL."""
    code = (
        "import sys\n"
        "for blocked in ('jax', 'flax', 'cv2', 'PIL'):\n"
        "    sys.modules[blocked] = None\n"
        "import math, pickle, tempfile\n"
        "import numpy as np\n"
        "from catre_tpu_torch.entry import evaluate_split, write_example_split\n"
        "from catre_tpu_torch.eval import CATREEvaluator, nocs_eval\n"
        "table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32)\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    recs = write_example_split(root, 5, 96, 128, m=4)\n"
        "    stats, res = evaluate_split(recs, device='cpu', mean_table=table, num_pcl=32,\n"
        "                                max_objs_per_image=4, ims_per_batch=2, warmup=0,\n"
        "                                output_dir=root + '/out')\n"
        "    assert stats['images'] == 5 and sorted(res) == [0, 1, 2, 3, 4]\n"
        "    assert all(math.isfinite(v) for r in res.values() for v in r['summary'].values())\n"
        "    preds = pickle.load(open(root + '/out/predictions.pkl', 'rb'))\n"
        "    assert len(preds) == 5 and len(preds[0]) == 5\n"
        "    gts = CATREEvaluator(recs)._gts\n"
        "    results = {k: dict(**g, **preds[0][k]) for k, g in gts.items()}\n"
        "    pickle.dump(results, open(root + '/r.pkl', 'wb'))\n"
        "    assert nocs_eval._main([root + '/r.pkl']) == 0\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "assert not any(sys.modules.get(m) for m in ('jax', 'flax', 'cv2', 'PIL'))\n"
        "print('evaluator ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "evaluator ok" in proc.stdout and "3D IoU at 75" in proc.stdout


def test_cli_and_checkpoints_run_with_jax_blocked():
    """Every module of the port (the tools too) imports with jax, flax, cv2,
    PIL, matplotlib, orbax and torchvision blocked, and without importing
    tensorstore (the orbax reader imports it when it reads); then the CLI
    scores a written split from a checkpoint of the port and from a reference
    .pth converted by `tools/convert_checkpoint.py`, with the mean-shape table
    read from a pickle under a data root set after import
    (`meta.set_data_root`)."""
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'flax', 'cv2', 'PIL', 'matplotlib', 'orbax', 'torchvision')\n"
        "for blocked in BLOCKED:\n"
        "    sys.modules[blocked] = None\n"
        "import importlib, os, pickle, pkgutil, tempfile\n"
        "import numpy as np, torch\n"
        "import catre_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(catre_tpu_torch.__path__, "
        "'catre_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'catre_tpu_torch.main', 'catre_tpu_torch.engine.runner', "
        "'catre_tpu_torch.data.nocs', 'catre_tpu_torch.utils.checkpoint', "
        "'catre_tpu_torch.tools.convert_checkpoint', 'catre_tpu_torch.ops.limits', "
        "'catre_tpu_torch.solver.schedule', 'catre_tpu_torch.solver.optimizer', "
        "'catre_tpu_torch.solver.transforms', 'catre_tpu_torch.solver.extra', "
        "'catre_tpu_torch.solver.ranger_family', 'catre_tpu_torch.parallel.comm', "
        "'catre_tpu_torch.parallel.mesh', 'catre_tpu_torch.parallel.launch', "
        "'catre_tpu_torch.tools.alignment', 'catre_tpu_torch.tools.pose_data', "
        "'catre_tpu_torch.tools.prepare_init_results', 'catre_tpu_torch.tools.synth_nocs', "
        "'catre_tpu_torch.tools.fps_sample', 'catre_tpu_torch.tools.soak', "
        "'catre_tpu_torch.tools.sampler_spread', 'catre_tpu_torch.tools.repro_diff', "
        "'catre_tpu_torch.tools.trainrun_report', 'catre_tpu_torch.tools.fetch_assets', "
        "'catre_tpu_torch.data.aug_color', 'catre_tpu_torch.data.jpeg', "
        "'catre_tpu_torch.data.imgproc'} "
        "<= set(names)\n"
        "assert 'tensorstore' not in sys.modules\n"
        "from catre_tpu_torch import main\n"
        "from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, model_config_from\n"
        "from catre_tpu_torch.config.loader import apply_overrides, load_config\n"
        "from catre_tpu_torch.data import meta, nocs\n"
        "from catre_tpu_torch.entry import write_example_split\n"
        "from catre_tpu_torch.models.catre import init_model\n"
        "from catre_tpu_torch.tools import convert_checkpoint\n"
        "from catre_tpu_torch.utils.checkpoint import save_checkpoint\n"
        "sys.path.insert(0, 'tests')\n"
        "from torch_mirror import TorchCATRE, TorchConvOutPerRotHead\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    meta.set_data_root(root)\n"
        "    os.makedirs(meta.MODEL_DIR)\n"
        "    rng = np.random.default_rng(0)\n"
        "    shapes = {o: rng.normal(size=(1024, 3)).astype(np.float32) for o in meta.OBJECTS}\n"
        "    pickle.dump(shapes, open(meta.CR_MEAN_MODEL_PATH, 'wb'))\n"
        "    recs = write_example_split(root, 4, 96, 128, m=4)\n"
        "    nocs.register_dataset('nocs_test_real', lambda: [dict(r) for r in recs])\n"
        "    cfg = apply_overrides(load_config(str(FLAGSHIP_CONFIG)), ['INPUT.NUM_PCL=32'])\n"
        "    save_checkpoint(root + '/ckpt', 0, {'model': init_model(model_config_from(cfg))})\n"
        "    ref = TorchCATRE()\n"
        "    ref.rot_head = TorchConvOutPerRotHead(num_points=32 + 1024)\n"
        "    torch.save(ref.state_dict(), root + '/model.pth')\n"
        "    sys.argv = ['x', root + '/model.pth', root + '/converted', '--config-file',\n"
        "                str(FLAGSHIP_CONFIG)]\n"
        "    try:\n"
        "        convert_checkpoint.main(sys.argv[1:])\n"
        "        raise AssertionError('a 1024-point config took a 32-point checkpoint')\n"
        "    except ValueError as e:\n"
        "        assert 'point_weight' in str(e)\n"
        "    opts = ['INPUT.NUM_PCL=32', 'MODEL.LOAD_POSES_TEST=False', 'TEST.IMS_PER_BATCH=2',\n"
        "            'DATALOADER.MAX_OBJS_PER_IMAGE=4', 'MODEL.CATRE.N_ITER_TEST=1']\n"
        "    for weights in ('/ckpt', '/model.pth'):\n"
        "        out = main.main(['--config-file', str(FLAGSHIP_CONFIG), '--eval-only',\n"
        "                         '--device', 'cpu',\n"
        "                         'OUTPUT_DIR=' + root + '/out' + weights[1:5],\n"
        "                         'MODEL.WEIGHTS=' + root + weights, *opts])\n"
        "        res = out['nocs_test_real']\n"
        "        assert sorted(res['results']) == [0, 1] and res['stats']['load_s'] > 0\n"
        "        assert os.path.exists(root + '/out' + weights[1:5] + '/predictions.pkl')\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "assert not any(sys.modules.get(m) for m in BLOCKED)\n"
        "print('cli ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cli ok" in proc.stdout


def test_cli_trains_with_jax_blocked():
    """`main.main` without --eval-only (do_train: the train loader, the
    step, checkpoints, a periodic evaluation, the writers) on a written split
    with jax, flax, cv2 and PIL blocked, and TensorFlow too (the tensorboard
    writer then takes tensorboard's own stub); no module of `catre_tpu` is
    loaded."""
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'flax', 'cv2', 'PIL', 'tensorflow')\n"
        "for blocked in BLOCKED:\n"
        "    sys.modules[blocked] = None\n"
        "import json, os, pickle, tempfile\n"
        "import numpy as np\n"
        "from catre_tpu_torch import main\n"
        "from catre_tpu_torch.config.build import FLAGSHIP_CONFIG\n"
        "from catre_tpu_torch.data import meta, nocs\n"
        "from catre_tpu_torch.entry import write_example_split\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    meta.set_data_root(root)\n"
        "    os.makedirs(meta.MODEL_DIR)\n"
        "    rng = np.random.default_rng(0)\n"
        "    shapes = {o: rng.normal(size=(32, 3)).astype(np.float32) * 0.1\n"
        "              for o in meta.OBJECTS}\n"
        "    pickle.dump(shapes, open(meta.CR_MEAN_MODEL_PATH, 'wb'))\n"
        "    recs = write_example_split(root, 4, 96, 128, m=4)\n"
        "    for name in ('nocs_train_real', 'nocs_test_real'):\n"
        "        nocs.register_dataset(name, lambda: [dict(r) for r in recs])\n"
        "    out = root + '/out'\n"
        "    state = main.main(['--config-file', str(FLAGSHIP_CONFIG), '--device', 'cpu',\n"
        "                       'OUTPUT_DIR=' + out, 'SEED=0', 'INPUT.NUM_PCL=32',\n"
        "                       'INPUT.NUM_KPS=32', 'SOLVER.IMS_PER_BATCH=2',\n"
        "                       'SOLVER.TOTAL_EPOCHS=2', 'MODEL.CATRE.N_ITER_TRAIN=2',\n"
        "                       'MODEL.CATRE.N_ITER_TRAIN_WARM_EPOCH=2', 'SOLVER.WARMUP_ITERS=1',\n"
        "                       'TRAIN.PRINT_FREQ=1', 'SOLVER.CHECKPOINT_PERIOD=1',\n"
        "                       'TEST.EVAL_PERIOD=4', 'MODEL.LOAD_POSES_TEST=False',\n"
        "                       'TEST.IMS_PER_BATCH=2', 'MODEL.CATRE.N_ITER_TEST=1',\n"
        "                       'DATALOADER.MAX_OBJS_PER_IMAGE=4', 'DATALOADER.NUM_WORKERS=0'])\n"
        "    assert state.step == 4\n"
        "    assert sorted(os.listdir(out + '/ckpt')) == ['step_00000001.pt', 'step_00000003.pt']\n"
        "    lines = [json.loads(x) for x in open(out + '/metrics.json')]\n"
        "    assert [x['iteration'] for x in lines] == [0, 1, 2, 3]\n"
        "    assert 'iter1/loss_total' in lines[3] and 'iter1/loss_total' not in lines[1]\n"
        "    assert os.path.exists(out + '/predictions.pkl')\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "assert not any(sys.modules.get(m) for m in BLOCKED)\n"
        "print('train cli ok')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "train cli ok" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _run(["chip_smoke.py"], timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this host has nvcc")
    for name in _build.KERNEL_SOURCES:
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.load(name)


def test_wrappers_route_cpu_to_twin_and_refuse_other_devices():
    ops.reset_launch_counts()
    x = torch.randn(2, 16, 128)
    w, b = torch.randn(1024, 128) * 0.05, torch.randn(1024) * 0.1
    out = enc_ops.dense_relu_max(x, w, b, torch.float32)
    torch.testing.assert_close(out, enc_ops.dense_relu_max_twin(x, w, b, torch.float32))
    assert ops.launch_counts() == {
        "dense_relu_max": 0, "dense_relu_dense_max": 0, "rot_head": 0, "rot_head_bwd": 0,
        "dense_relu_max_train_fwd": 0, "dense_relu_max_train_bwd": 0,
        "dense_relu_dense_max_train_fwd": 0, "dense_relu_dense_max_train_bwd": 0,
        "rot_head_grouped": 0, "rot_head_blocked": 0, "chain3_max": 0}
    with pytest.raises(ValueError, match="no kernel"):
        enc_ops.dense_relu_max(x.to("meta"), w, b, torch.float32)


def test_cuda_tests_are_marked_and_skip_here():
    target = "tests/test_torch_cuda.py"
    unmarked = _run(["-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                     "--collect-only", "-q", "-m", "not cuda", target])
    assert "no tests collected" in unmarked.stdout or " 0 selected" in unmarked.stdout \
        or "deselected" in unmarked.stdout, unmarked.stdout[-2000:]
    if torch.cuda.is_available():
        return
    run = _run(["-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", "-m", "cuda",
                "-rs", target])
    assert run.returncode == 0, run.stdout[-2000:]
    assert "skipped" in run.stdout and "passed" not in run.stdout and "failed" not in run.stdout
