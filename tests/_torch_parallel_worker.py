"""Worker script of `tests/test_torch_parallel.py`: the port over two gloo
processes on the CPU, and the same work at world 1.

Run as:  python tests/_torch_parallel_worker.py <workdir>

jax, flax and catre_tpu are blocked before anything is imported, here and in
the two processes that `catre_tpu_torch.parallel.launch` spawns (they import
this script again, as __mp_main__); the test module imports its constants.
`<workdir>/inputs.pt`, written by the test module, holds the model's weights
(JAX's, converted), the global train batch, the two batches JAX's step
prepared, and the data root of a written split of 13 frames with its
mean-shape table. Each rank writes `<workdir>/rank<r>.pt`:
  - "own": two train steps on its rows of the global batch with the port's
    own draws (box and rigid-shift coins at 1): the metrics and parameters;
  - "jax": two steps of `step_on_prepared` on its rows of the batches JAX
    prepared;
  - "test": `do_test` on the split's first TEST_FRAMES frames (`results`
    empty on rank 1);
  - "loader": the scene ids of the train loader's first epoch, one image a
    batch, on this rank's stride.
Then this process runs "own" and "test" at world 1 into `world1.pt`.
"""

import sys

if __name__ in ("__main__", "__mp_main__"):     # the script, or a process it spawned
    for _blocked in ("jax", "flax", "catre_tpu"):
        sys.modules[_blocked] = None

import copy                                   # noqa: E402
import os.path as osp                         # noqa: E402

import numpy as np                            # noqa: E402
import torch                                  # noqa: E402

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, loader_config_from  # noqa: E402
from catre_tpu_torch.config.loader import apply_overrides, load_config  # noqa: E402
from catre_tpu_torch.data import meta, nocs                      # noqa: E402
from catre_tpu_torch.data.loader import CATRELoader              # noqa: E402
from catre_tpu_torch.engine import runner                        # noqa: E402
from catre_tpu_torch.engine.train import (InputNoiseConfig, init_train_state,  # noqa: E402
                                          make_train_step)
from catre_tpu_torch.geom.symmetry import axis_symmetry_rotation_bank  # noqa: E402
from catre_tpu_torch.losses import LossConfig                    # noqa: E402
from catre_tpu_torch.models.catre import CATREConfig, init_model  # noqa: E402
from catre_tpu_torch.parallel import comm                        # noqa: E402
from catre_tpu_torch.parallel.launch import launch               # noqa: E402
from catre_tpu_torch.solver.build import build_optimizer         # noqa: E402

WORLD = 2
NPTS = 64                # points and keypoints of the train model
N_ITER = 2               # inner iterations a train step
STEPS = 2
LR = 1e-3
OWN_SEED = 17            # the generator of the "own" steps (seed + step)
TEST_FRAMES = 6          # the split's first frames that do_test scores, 3 a rank and a batch
GROUP_TIMEOUT_S = 120    # a collective that waits longer raises


def eval_overrides(out_dir):
    """The do_test config: the shipped file at 32 points, seed-0 weights."""
    return [f"OUTPUT_DIR={out_dir}", "SEED=0", "INPUT.NUM_PCL=32", "INPUT.NUM_KPS=32",
            "MODEL.LOAD_POSES_TEST=False", "TEST.IMS_PER_BATCH=3",
            "DATALOADER.MAX_OBJS_PER_IMAGE=4", "MODEL.CATRE.N_ITER_TEST=1",
            "DATALOADER.NUM_WORKERS=0"]


def _setup(inputs):
    """The data root and the registered splits of `inputs`."""
    meta.set_data_root(inputs["data_root"])
    records = inputs["records"]
    nocs.register_dataset("nocs_test_real", lambda: copy.deepcopy(records[:TEST_FRAMES]))


def _train(inputs, rows: slice, own: bool) -> dict:
    """Two train steps of the small model on `rows` of the global batch:
    with the port's draws (`own`), else on the batches JAX prepared."""
    model = init_model(CATREConfig(num_pcl=NPTS, num_kps=NPTS), seed=0)
    model.load_state_dict(inputs["weights"])
    opt = build_optimizer({"OPTIMIZER_CFG": {"type": "Ranger", "lr": LR}},
                          model.named_parameters())
    probs = 1.0 if own else 0.0
    step = make_train_step(model, LossConfig(), InputNoiseConfig(bbox3d_aug_prob=probs,
                                                                 rt_aug_prob=probs),
                           opt, axis_symmetry_rotation_bank(max_sym_disc_step=0.1), N_ITER)
    state = init_train_state(model, opt)
    metrics = []
    for i in range(STEPS):
        if own:
            batch = {k: torch.from_numpy(v[rows]) for k, v in inputs["batch"].items()}
            state, m = step(state, batch, torch.Generator().manual_seed(OWN_SEED + i), LR)
        else:
            batch = {k: torch.from_numpy(v[rows]) for k, v in inputs["prepared"][i].items()}
            state, m = step.step_on_prepared(state, batch, LR)
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    return {"metrics": metrics, "params": {k: v.detach().clone() for k, v in
                                           model.state_dict().items()}}


def _do_test(inputs, out_dir) -> dict:
    cfg = apply_overrides(load_config(str(FLAGSHIP_CONFIG)), eval_overrides(out_dir))
    return runner.do_test(cfg, device="cpu")["nocs_test_real"]


def _loader_ids(inputs, rank: int) -> list:
    cfg = apply_overrides(load_config(str(FLAGSHIP_CONFIG)), eval_overrides(""))
    loader = CATRELoader(inputs["records"], loader_config_from(cfg, "train"), phase="train",
                         ims_per_batch=1, seed=3, rank=rank, world_size=WORLD, device="cpu")
    n = len(range(rank, len(inputs["records"]), WORLD))      # this rank's share of an epoch
    batches = iter(loader)
    return [next(batches)["scene_im_ids"][0] for _ in range(n)]


def rank_main(device, workdir):
    inputs = torch.load(osp.join(workdir, "inputs.pt"), weights_only=False)
    _setup(inputs)
    rank, world = comm.get_rank(), comm.get_world_size()
    assert world == WORLD and device == "cpu", (world, device)
    n = inputs["batch"]["pcl"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    out = {"own": _train(inputs, rows, own=True), "jax": _train(inputs, rows, own=False),
           "test": _do_test(inputs, osp.join(workdir, "test_world2")),
           "loader": _loader_ids(inputs, rank)}
    torch.save(out, osp.join(workdir, f"rank{rank}.pt"))


def main(workdir):
    launch(rank_main, (workdir,), ["cpu"] * WORLD, timeout_s=GROUP_TIMEOUT_S)
    torch.set_num_threads(max(1, torch.get_num_threads() // WORLD))     # each rank's threads
    inputs = torch.load(osp.join(workdir, "inputs.pt"), weights_only=False)
    _setup(inputs)
    out = {"own": _train(inputs, slice(None), own=True),
           "test": _do_test(inputs, osp.join(workdir, "test_world1"))}
    torch.save(out, osp.join(workdir, "world1.pt"))
    assert not any(m.startswith(("jax.", "flax.", "catre_tpu.")) for m in sys.modules)
    assert not any(sys.modules.get(m) for m in ("jax", "flax", "catre_tpu"))
    print("parallel worker ok", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
