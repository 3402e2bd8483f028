"""Parallelism context of the port (the counterpart of
``repro.models.parallel`` at tensor-parallel degree 1).

The reference threads a ``Parallel`` of named mesh axes through its
model code, under ``shard_map``. The port runs one process a rank, and
its data axes are one ``torch.distributed`` process group: ``group``
(None: one rank, or the default group when one is initialised).
``cache_seq_sharded`` is the reference's ``cache_seq_axis``: the decode
cache's sequence axis split over the group (context-parallel decode).

Ranks number the reference's data axes pod-major: rank r is (pod r //
data, data r % data) of a ``("pod", "data")`` mesh, which is the
reference's ``_dp_index`` of that device, so :func:`data_index` is the
group rank. The collectives here are plain ``torch.distributed`` calls
on the group; a sum is taken in rank order on every rank (an all-gather,
then the adds), so every rank holds the same bits.

The tensor-parallel fields (``model_axis``, ``tp``, ``seq_parallel``,
``attn_dist``) come with ROADMAP A13d: asking for one raises.
"""
from __future__ import annotations

import functools
import operator
from dataclasses import dataclass

import torch
import torch.distributed as dist

_TP_FIELDS = ("model_axis", "tp", "seq_parallel", "attn_dist")


def world(group=None) -> tuple[int, int]:
    """(size, rank) of the group, (1, 0) when torch.distributed is off."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


@dataclass(frozen=True)
class Parallel:
    group: object = None               # the data axes' process group
    cache_seq_sharded: bool = False    # decode cache seq split over group

    def __getattr__(self, name: str):
        if name in _TP_FIELDS:
            raise NotImplementedError(
                f"Parallel.{name}: tensor parallelism is not ported yet; "
                "the port's Parallel is data-parallel only (ROADMAP A13d)")
        raise AttributeError(name)

    @property
    def size(self) -> int:
        return world(self.group)[0]

    @property
    def rank(self) -> int:
        return world(self.group)[1]


def data_index(group=None) -> int:
    """This rank's index over the data axes, in the reference's
    ``_dp_index`` order (pod-major over ``("pod", "data")``)."""
    return world(group)[1]


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of x over the group (exact in any order);
    x itself over one rank."""
    if world(group)[0] == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in rank order (the
    reference's ``all_gather(..., tiled=True)`` over the data axes)."""
    n, _ = world(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x_0 + x_1 + ... over the group in rank order, the same bits on
    every rank; x itself over one rank."""
    n, _ = world(group)
    if n == 1:
        return x
    parts = all_gather_rows(x.reshape((1,) + tuple(x.shape)), group)
    return functools.reduce(operator.add, parts.unbind(0))


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's ``pmean`` over the data axes: the rank-order sum
    scaled by fp32(1/n), as XLA rewrites the division by the constant
    n; x itself over one rank."""
    n, _ = world(group)
    if n == 1:
        return x
    return all_reduce_sum(x, group) * (1.0 / n)
