"""Parallelism context of the port (the counterpart of
``repro.models.parallel``).

The reference threads a ``Parallel`` of named mesh axes through its
model code, under ``shard_map`` on a ``("data", "model")`` or ``("pod",
"data", "model")`` mesh. The port runs one process a rank, and each axis
is a ``torch.distributed`` process group: ``group``, the data axes (None:
one rank, or the default group when one is initialised; an explicit
group of one rank when only the model axis is split), and
``model_group``, the model axis (None: tensor-parallel degree 1).
``cache_seq_sharded`` is the reference's ``cache_seq_axis``: the decode
cache's sequence axis split over the data group (context-parallel
decode). ``seq_parallel`` is Megatron-SP: the residual stream split by
sequence over the model group (``launch.mesh.make_group`` builds both
groups; rank r is data index r // model, model index r % model).

Ranks number the reference's data axes pod-major: rank r of the data
group is (pod r // data, data r % data) of a ``("pod", "data")`` mesh,
which is the reference's ``_dp_index`` of that device, so
:func:`data_index` is the data group's rank. The collectives here are
plain ``torch.distributed`` calls on a group; a sum is taken in rank
order on every rank (an all-gather, then the adds), so every rank holds
the same bits.

The model group's collectives are ``torch.autograd.Function``s whose
backward is the transpose JAX takes under ``shard_map(check_vma=False)``,
not Megatron's f/g pair: psum <-> psum, all_gather (tiled) <->
psum_scatter, all_to_all <-> the inverse all_to_all. Each rank seeds the
backward pass with its own disjoint share of the loss
(``transformer.chunked_xent``), and those transposes carry the other
ranks' terms to it; a replicated leaf's gradient is then this rank's
share, summed over the model group by the train step.

Ring attention (``attn_dist="ring"``, the reference's context-parallel
attention over the model group, reached through the train step's
``attn_dist``) rotates key/value blocks around the model group with
:func:`ppermute_model`, whose backward is the inverse shift (JAX's
transpose of ``ppermute``).
"""
from __future__ import annotations

import functools
import operator
from dataclasses import dataclass

import torch
import torch.distributed as dist


def world(group=None) -> tuple[int, int]:
    """(size, rank) of the group, (1, 0) when torch.distributed is off."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


ATTN_DISTS = ("sp", "ring")


@dataclass(frozen=True)
class Parallel:
    group: object = None               # the data axes' process group
    cache_seq_sharded: bool = False    # decode cache seq split over group
    model_group: object = None         # the model axis' process group
    seq_parallel: bool = False         # residual seq split over the model
    attn_dist: str = "sp"              # "sp" (heads) | "ring" (sequence)

    def __post_init__(self):
        if self.attn_dist not in ATTN_DISTS:
            raise ValueError(f"unknown attn_dist {self.attn_dist!r} "
                             f"(expected one of {ATTN_DISTS})")

    @property
    def size(self) -> int:
        return world(self.group)[0]

    @property
    def rank(self) -> int:
        return world(self.group)[1]

    @property
    def tp(self) -> int:
        """The tensor-parallel degree (the model group's size)."""
        return 1 if self.model_group is None else world(self.model_group)[0]

    @property
    def model_rank(self) -> int:
        """This rank's index on the model axis (the reference's
        ``axis_index``)."""
        return 0 if self.model_group is None else world(self.model_group)[1]

    @property
    def tp_on(self) -> bool:
        return self.tp > 1

    @property
    def sp(self) -> bool:
        """Whether the residual stream is split by sequence (the
        reference's ``seq_parallel and tp > 1``)."""
        return self.seq_parallel and self.tp_on

    @property
    def model_axis(self):
        """The reference's field: "model" under tensor parallelism."""
        return "model" if self.tp_on else None


def ring_on(pal) -> bool:
    """Whether attention runs as the reference's ring (context parallel
    over the model group): every rank all the heads, its own block of the
    sequence."""
    return (pal is not None and pal.tp_on
            and getattr(pal, "attn_dist", "sp") == "ring")


def data_index(group=None) -> int:
    """This rank's index over the data axes, in the reference's
    ``_dp_index`` order (pod-major over ``("pod", "data")``)."""
    return world(group)[1]


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_slice(n: int, pal, what: str = "a dimension") -> int:
    """One rank's length of a dimension of n split over the model group;
    ValueError naming ``what`` and the degree where tp does not divide n
    (the reference asserts it; nothing is padded)."""
    tp = 1 if pal is None else pal.tp
    if n % tp:
        raise ValueError(f"{what} of {n} does not split over tp={tp}")
    return n // tp


def heads_padded(n_heads: int, pal) -> int:
    """A head count rounded up to a multiple of the model group's size."""
    return n_heads if pal is None or not pal.tp_on else pad_to(n_heads,
                                                                pal.tp)


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


def _rank_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts[0] + parts[1] + ... in that order."""
    return functools.reduce(operator.add, parts.unbind(0))


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x_0 + x_1 + ... over the group in rank order, the same bits on
    every rank; x itself over one rank."""
    n, _ = world(group)
    if n == 1:
        return x
    return _rank_sum(all_gather_rows(x.reshape((1,) + tuple(x.shape)), group))


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's ``pmean`` over the data axes: the rank-order sum
    scaled by fp32(1/n), as XLA rewrites the division by the constant
    n; x itself over one rank."""
    n, _ = world(group)
    if n == 1:
        return x
    return all_reduce_sum(x, group) * (1.0 / n)


def _gather_along(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Every rank's x concatenated along ``axis`` in rank order."""
    n, _ = world(group)
    parts = all_gather_rows(x.reshape((1,) + tuple(x.shape)), group)
    return torch.cat(parts.unbind(0), axis) if n > 1 else x


def _scatter_sum(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Rank r's chunk r of x along ``axis``, summed over the ranks in
    rank order (one all-to-all, then the adds)."""
    n, _ = world(group)
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    front = x.movedim(axis, 0)
    chunks = front.reshape((n, front.shape[0] // n) + tuple(front.shape[1:]))
    chunks = chunks.contiguous()
    got = torch.empty_like(chunks)
    dist.all_to_all_single(got, chunks, group=group)
    return _rank_sum(got).movedim(0, axis)


def _all_to_all(x: torch.Tensor, split: int, concat: int,
                group) -> torch.Tensor:
    """The reference's ``all_to_all(x, split_axis=split,
    concat_axis=concat, tiled=True)``: x cut into n chunks along
    ``split``, chunk j sent to rank j, the chunks received concatenated
    along ``concat`` in source rank order."""
    n, _ = world(group)
    front = x.movedim(split, 0)
    chunks = front.reshape((n, front.shape[0] // n) + tuple(front.shape[1:]))
    chunks = chunks.contiguous()
    got = torch.empty_like(chunks)
    dist.all_to_all_single(got, chunks, group=group)
    got = got.movedim(1, split + 1)          # (n, *x's dims, split cut)
    return torch.cat(got.unbind(0), concat)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather_along(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.axis, ctx.group), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _scatter_sum(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g.contiguous(), ctx.axis, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.split, ctx.concat, ctx.group = split, concat, group
        return _all_to_all(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.concat, ctx.split, ctx.group), None, None,
                None)


def _ppermute(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """x sent to rank (r + shift) % n of the group, what rank (r - shift)
    % n sent received in its place."""
    n, r = world(group)
    if shift % n == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _ppermute(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, -ctx.shift, ctx.group), None, None


def ppermute_model(x: torch.Tensor, pal, shift: int = 1) -> torch.Tensor:
    """The reference's ``ppermute`` over the model axis with the
    permutation i -> (i + shift) % tp: this rank's x goes to model rank
    (r + shift) % tp, and the result is model rank (r - shift) % tp's x;
    its backward sends the gradient back by the inverse shift. x at tp
    1."""
    if pal is None or not pal.tp_on:
        return x
    return _Ppermute.apply(x, shift, pal.model_group)


def psum_model(x: torch.Tensor, pal) -> torch.Tensor:
    """x summed over the model group (rank order); x at tp 1."""
    if pal is None or not pal.tp_on:
        return x
    return _Psum.apply(x, pal.model_group)


def psum_scatter_model(x: torch.Tensor, pal, axis: int) -> torch.Tensor:
    """The row-parallel reduction under sequence parallelism: this rank's
    chunk of x along ``axis``, summed over the model group."""
    if pal is None or not pal.tp_on:
        return x
    return _PsumScatter.apply(x, axis, pal.model_group)


def all_gather_model(x: torch.Tensor, pal, axis: int) -> torch.Tensor:
    """The model group's x concatenated along ``axis`` in rank order."""
    if pal is None or not pal.tp_on:
        return x
    return _AllGather.apply(x, axis, pal.model_group)


def all_to_all_model(x: torch.Tensor, pal, split: int,
                     concat: int) -> torch.Tensor:
    """The reference's tiled ``all_to_all`` over the model axis."""
    if pal is None or not pal.tp_on:
        return x
    return _AllToAll.apply(x, split, concat, pal.model_group)


def seq_gathered(x: torch.Tensor, pal) -> torch.Tensor:
    """x (B, S/tp, d), this rank's sequence chunk under ``pal.sp``, with
    the sequence gathered over the model group; x itself otherwise."""
    return all_gather_model(x, pal, 1) if pal is not None and pal.sp else x


def row_parallel_out(y: torch.Tensor, pal) -> torch.Tensor:
    """A row-parallel product's partial output (B, S, d) summed over the
    model group, or psum-scattered back to the rank's sequence chunk
    under ``pal.sp``."""
    if pal is not None and pal.sp:
        return psum_scatter_model(y, pal, 1)
    return psum_model(y, pal)


def pmean_model(x: torch.Tensor, pal) -> torch.Tensor:
    """The model group's mean of x, outside autograd (the reference's
    ``pmean`` over "model"); x at tp 1."""
    if pal is None or not pal.tp_on:
        return x
    return all_reduce_mean(x.detach(), pal.model_group)


def pmax_model(x: torch.Tensor, pal) -> torch.Tensor:
    """The elementwise maximum over the model group, outside autograd
    (the reference takes it of a stop-gradient value)."""
    if pal is None or not pal.tp_on:
        return x.detach()
    return all_reduce_max(x.detach(), pal.model_group)


def broadcast_model(x: torch.Tensor, pal) -> torch.Tensor:
    """x as model rank 0 holds it, on every rank of the model group (in
    place)."""
    if pal is not None and pal.tp_on:
        dist.broadcast(x, dist.get_global_rank(pal.model_group, 0),
                       group=pal.model_group)
    return x


def axis_index(pal) -> int:
    """This rank's index on the model axis (0 at tp 1)."""
    return 0 if pal is None else pal.model_rank
