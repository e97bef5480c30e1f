"""Process identity and collectives over a `torch.distributed` process group.

Counterpart of `catre_tpu/parallel/comm.py`: `init_dist` (:23), the rank
accessors (:45-58), `synchronize` (:61), `all_gather` (:70), `gather_arrays`
(:89), `inference_slice` (:98) and `reduce_dict` (:110). Behavioural
reference: `core/utils/my_comm.py` (init_dist :174, reduce_dict :27,
all_gather :70, synchronize :82, the rank accessors :251-297).

One process drives one card. Without a group, or in a group of one, every
call is a no-op, as in the JAX package. The backend follows the devices
(`backend_for`): gloo on the CPU, NCCL when every process has a card of its
own, gloo when processes share a card (NCCL refuses two ranks on one
device); `main.setup` logs it once. Under gloo a tensor on the card goes
through host memory. A group that does not form raises: nothing carries on at
world 1.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600          # a collective that waits longer raises (a rank died or hangs)


def backend_for(devices) -> str:
    """The backend of a group whose local processes run on `devices` (one
    entry a process): gloo on the CPU or where two share a card, else nccl."""
    devices = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devices):
        return "gloo"
    return "nccl" if len({d.index for d in devices}) == len(devices) else "gloo"


def init_dist(dist_url: str | None = None, world_size: int = 1, rank: int = 0,
              backend: str = "gloo", timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group at `dist_url` (e.g. tcp://host:port) as `rank`
    of `world_size`. World 1 without an address is a no-op."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    if world_size <= 1 and not dist_url:
        return
    if not dist_url:
        raise ValueError(f"a process group of world {world_size} needs an address (dist_url)")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dist.init_process_group(backend, init_method=dist_url, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def destroy() -> None:
    """Leave the process group, where there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def is_dist_avail_and_initialized() -> bool:
    return get_world_size() > 1


def synchronize() -> None:
    """Barrier across processes (ref `my_comm.py:82-96`)."""
    if get_world_size() > 1:
        dist.barrier()


def all_reduce_(tensor: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `tensor` in place over the group (sum by default); a tensor on
    the card goes through host memory under gloo. -> `tensor`."""
    if get_world_size() == 1:
        return tensor
    if tensor.is_cuda and dist.get_backend() == "gloo":
        host = tensor.cpu()
        dist.all_reduce(host, op=op)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=op)
    return tensor


def all_reduce_grads_(params) -> None:
    """Sum the gradients of `params` over the group, in one flat bucket."""
    if get_world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def all_gather(data) -> list:
    """Any picklable `data` from every process, in rank order (ref
    `my_comm.py:70-171`)."""
    if get_world_size() == 1:
        return [data]
    out = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out


def gather_arrays(x: np.ndarray) -> np.ndarray:
    """A numpy array from every process, concatenated along axis 0 in rank
    order."""
    if get_world_size() == 1:
        return np.asarray(x)
    return np.concatenate([np.asarray(a) for a in all_gather(np.asarray(x))], axis=0)


def inference_slice(n: int, rank: int | None = None, world_size: int | None = None) -> slice:
    """Exact contiguous per-process split of n test records (the reference's
    `InferenceSampler`, `my_distributed_sampler.py:172-200`): every record
    lies on exactly one process."""
    rank = get_rank() if rank is None else rank
    world_size = get_world_size() if world_size is None else world_size
    shard_size = (n - 1) // world_size + 1
    begin = min(shard_size * rank, n)
    end = min(shard_size * (rank + 1), n)
    return slice(begin, end)


def reduce_dict(metrics: dict, average: bool = True) -> dict:
    """Host scalars averaged (or summed) over the processes (ref
    `my_comm.py:27-67`)."""
    if get_world_size() == 1:
        return metrics
    keys = sorted(metrics)
    vec = all_reduce_(torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64))
    if average:
        vec /= get_world_size()
    return {k: float(v) for k, v in zip(keys, vec)}
