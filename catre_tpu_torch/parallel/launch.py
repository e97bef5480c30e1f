"""Start one process per card and join them in a process group.

Counterpart of the reference's launcher (`core/utils/default_args_setup.py:73-90`
with detectron2's `launch`): world = machines x processes a machine; process
`local_rank` of machine `machine_rank` has global rank machine_rank x
processes a machine + local_rank, runs on `devices[local_rank]` (made the
current card) and joins the group at `dist_url` with the backend that
`comm.backend_for` picks for this machine's devices. The JAX package starts
one process a host and runs a mesh inside it (`catre_tpu/main.py`); its
counterpart here is this function.

The children are spawned, so `fn` and its arguments must pickle (a function
at a module's top level). A child that raises makes `launch` raise after the
others are stopped; a collective waits at most `timeout_s` for a lost rank.
"""

from __future__ import annotations

import socket

import torch
import torch.multiprocessing as mp

from . import comm


def free_port() -> int:
    """A TCP port free on this machine now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_devices(num_local: int, device: str = "cuda") -> list:
    """The devices of `num_local` processes on this machine: one card each,
    or the CPU for every process. 0 means every card (one process on the
    CPU). More processes than cards raise."""
    if num_local < 0:
        raise ValueError(f"{num_local} processes a machine")
    kind = torch.device(device).type
    if kind == "cpu":
        return ["cpu"] * max(num_local, 1)
    if kind != "cuda":
        raise ValueError(f"device {device!r}: processes run on cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("processes on the card need a CUDA card; pass device='cpu' (the CLI's "
                           "--device cpu) to run them on the CPU")
    n_cards = torch.cuda.device_count()
    n = n_cards if num_local == 0 else num_local
    if n > n_cards:
        raise ValueError(f"{n} processes, one a card, and this machine has {n_cards} card(s)")
    return [f"cuda:{i}" for i in range(n)]


def launch(fn, args=(), devices=("cuda:0",), num_machines: int = 1, machine_rank: int = 0,
           dist_url: str = "", timeout_s: float = comm.TIMEOUT_S):
    """Run fn(device, *args) in one process for each entry of `devices` on
    this machine, in a group of num_machines x len(devices) processes at
    `dist_url` (on one machine a free local port when empty). At world 1 fn
    runs in this process, with no group, and its result is returned; else
    None once every process has ended well."""
    num_local = len(devices)
    world = num_machines * num_local
    if num_local < 1 or num_machines < 1:
        raise ValueError(f"{num_local} processes on each of {num_machines} machines")
    if not 0 <= machine_rank < num_machines:
        raise ValueError(f"machine rank {machine_rank} outside {num_machines} machines")
    if world == 1:
        return fn(devices[0], *args)
    if not dist_url:
        if num_machines > 1:
            raise ValueError(f"{num_machines} machines need the group's address (--dist-url "
                             "tcp://<machine 0>:<port>)")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_worker, nprocs=num_local, join=True, start_method="spawn",
                       args=(fn, tuple(args), list(devices), machine_rank, world, dist_url,
                             comm.backend_for(devices), timeout_s))
    return None


def _worker(local_rank, fn, args, devices, machine_rank, world, dist_url, backend, timeout_s):
    device = torch.device(devices[local_rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:         # the processes share this machine's threads (OMP_NUM_THREADS, else its cores)
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    comm.init_dist(dist_url, world, machine_rank * len(devices) + local_rank, backend, timeout_s)
    try:
        fn(str(device), *args)
        comm.synchronize()        # no rank leaves the group while another still reads it
    finally:
        comm.destroy()
