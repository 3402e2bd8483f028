"""The launchers' process groups (the counterpart of
``repro.launch.mesh.make_mesh``).

The reference builds a ``("data", "model")`` or ``("pod", "data",
"model")`` mesh of the devices one process sees. The port runs one
process a rank, started by ``torchrun``, and each axis is a process
group. Ranks are numbered model-minor, the reference mesh's device
order: rank r is data index r // model (pod-major over the pods' data
ranks) and model index r % model. The model group of data index d is the
ranks [d * model, (d + 1) * model); the data group of model index m is
the ranks that share m.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train ... --data 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.train ... --model 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.train ... --data 2 \
        --model 2
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.backend import resolve_device

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def axis_groups(data: int, model: int):
    """``(data group, model group)`` of this rank in the default group of
    ``data * model`` ranks (``data`` counting every pod's): the model
    group None at ``model`` 1, when the data group is the default group
    itself. Every rank creates every subgroup, in the same order (NCCL
    requires it)."""
    if model == 1:
        return dist.group.WORLD, None
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return data_group, model_group


def make_group(data: int, model: int = 1, pods: int = 1, device=None):
    """``(data group, model group, device)`` for ``data * pods`` data
    ranks of ``model`` model ranks each: (None, None, the resolved device)
    for one rank; otherwise the default process group, joined here from
    torchrun's environment (or the one a caller has already initialised),
    cut into the two axes' groups (:func:`axis_groups`; the model group
    None at ``model`` 1), and this rank's card (``LOCAL_RANK``, made the
    current one before anything is allocated on it), or the CPU over
    gloo when ``device="cpu"``. Raises when there is no group to join,
    when its size is not ``data * pods * model`` and when the host has
    too few cards; never runs one rank in place of a group."""
    n = data * pods * model
    if data < 1 or pods < 1 or model < 1:
        raise ValueError(f"--data {data} --pods {pods} --model {model}: "
                         "no ranks")
    if n == 1:
        return None, None, resolve_device(device)
    ask = f"--data {data} --pods {pods} --model {model}"
    cpu = device is not None and torch.device(device).type == "cpu"
    if not dist.is_initialized():
        missing = [key for key in _ENV if key not in os.environ]
        if missing:
            raise RuntimeError(
                f"{ask} asks for {n} ranks, but there is no process group "
                f"to join ({missing} unset): start the launcher under "
                f"torchrun --nproc-per-node {n}")
        size = int(os.environ["WORLD_SIZE"])
        if size != n:
            raise ValueError(f"WORLD_SIZE={size}, but {ask} asks for {n} "
                             "ranks")
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
                         f"ranks, but {ask} asks for {n}")
    group, model_group = axis_groups(data * pods, model)
    if cpu:
        return group, model_group, torch.device("cpu")
    dev = resolve_device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return group, model_group, dev
