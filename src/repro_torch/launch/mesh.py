"""The launchers' process group (the counterpart of
``repro.launch.mesh.make_mesh``).

The reference builds a ``("data", "model")`` or ``("pod", "data",
"model")`` mesh of the devices one process sees. The port runs one
process a rank, started by ``torchrun``, and its data axes are the
default process group: rank r is (pod r // data, data r % data).

    torchrun --nproc-per-node 4 -m repro_torch.launch.train ... --data 4
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.backend import resolve_device

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def make_group(data: int, model: int = 1, pods: int = 1, device=None):
    """``(group, device)`` for ``data * pods`` data-parallel ranks: None
    and the resolved device for one rank; otherwise the default process
    group, joined here from torchrun's environment (or the one a caller
    has already initialised), and this rank's card (``LOCAL_RANK``, made
    the current one before anything is allocated on it), or the CPU
    over gloo when ``device="cpu"``. Raises when there is no group to
    join, when its size is not ``data * pods`` and when the host has too
    few cards; never runs one rank in place of a group. ``model > 1``
    (tensor parallelism) raises naming ROADMAP A13d."""
    if model > 1:
        raise NotImplementedError(
            f"--model {model}: tensor parallelism is not ported yet; the "
            "port is data-parallel (ROADMAP A13d)")
    n = data * pods
    if n < 1:
        raise ValueError(f"--data {data} --pods {pods}: no ranks")
    if n == 1:
        return None, resolve_device(device)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not dist.is_initialized():
        missing = [key for key in _ENV if key not in os.environ]
        if missing:
            raise RuntimeError(
                f"--data {data} --pods {pods} asks for {n} data-parallel "
                f"ranks, but there is no process group to join ({missing} "
                "unset): start the launcher under torchrun "
                f"--nproc-per-node {n}")
        size = int(os.environ["WORLD_SIZE"])
        if size != n:
            raise ValueError(f"WORLD_SIZE={size}, but --data {data} --pods "
                             f"{pods} asks for {n} ranks")
        if not cpu:
            local = int(os.environ["LOCAL_RANK"])
            resolve_device("cuda")
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK={local}, but this host sees "
                    f"{torch.cuda.device_count()} CUDA devices")
            torch.cuda.set_device(local)
        dist.init_process_group("gloo" if cpu else "nccl")
    elif dist.get_world_size() != n:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, but --data {data} --pods {pods} asks "
                         f"for {n}")
    if cpu:
        return dist.group.WORLD, torch.device("cpu")
    dev = resolve_device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dist.group.WORLD, dev
