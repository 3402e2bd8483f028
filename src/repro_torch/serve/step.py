"""Serving steps at one rank: prefill and batched greedy decode (the port
of ``repro.serve.step``'s ``build_prefill`` and ``build_decode_step`` on
a 1x1 mesh).

Each builder returns a plain function: ``prefill(params, batch) ->
(logits (B, V), cache)`` with a cache of ``run.shape.seq_len`` positions
(a sliding model: min(window, seq_len) slots), and ``decode(params,
cache, token (B, 1)) -> (logits (B, V), cache)``, which writes the cache
in place. Both run under ``torch.inference_mode``. The model is
``resolve_model_cfg(run)``: ``attn_override="sliding"`` serves a dense
model's sliding variant.

The reference also serves a data-parallel batch, context-parallel decode
(the cache's sequence axis sharded when the batch is smaller than the
data axes) and tensor parallelism; each raises here, naming the ROADMAP
item that will port it.
"""
from __future__ import annotations

import torch

from repro_torch.backend import configure_numerics, resolve_device
from repro_torch.configs.base import RunConfig, resolve_model_cfg
from repro_torch.models import transformer as tfm


def check_serving(run: RunConfig, data: int = 1, model: int = 1) -> None:
    """Raise NotImplementedError for a serving layout beyond one rank."""
    if model > 1:
        raise NotImplementedError(
            f"tensor-parallel serving (model={model}) is not ported yet; "
            "the port serves one rank (ROADMAP A13)")
    if data > 1:
        what = ("context-parallel decode (batch "
                f"{run.shape.global_batch} < data {data})"
                if run.shape.global_batch < data else
                f"a data-parallel batch (data={data})")
        raise NotImplementedError(
            f"{what} is not ported yet; the port serves one rank "
            "(ROADMAP A14)")


def _build(run: RunConfig, device, data: int, model: int):
    resolve_device(device)
    configure_numerics()
    check_serving(run, data, model)
    cfg = resolve_model_cfg(run)
    tfm.check_model(cfg)
    return cfg


def build_prefill(run: RunConfig, device=None, *, data: int = 1,
                  model: int = 1):
    """``fn(params, batch) -> (logits, cache)``; batch = {"tokens": (B,
    S)}."""
    cfg = _build(run, device, data, model)

    def fn(params: dict, batch: dict):
        with torch.inference_mode():
            return tfm.prefill(params, batch["tokens"], cfg,
                               max_seq=run.shape.seq_len)
    return fn


def build_decode_step(run: RunConfig, device=None, *, data: int = 1,
                      model: int = 1):
    """``fn(params, cache, token) -> (logits, cache)``, the cache updated
    in place."""
    cfg = _build(run, device, data, model)

    def fn(params: dict, cache: dict, token: torch.Tensor):
        with torch.inference_mode():
            return tfm.decode_step(params, cache, token, cfg)
    return fn


def delta_applier_from_snapshot(run: RunConfig, snap_dir: str, device=None,
                                step=None):
    """A replica's entry to the delta broadcast at one rank: the snapshot
    under ``snap_dir`` at ``step`` (default: the latest) restored as the
    serving params (templates on the ``meta`` device, so nothing else is
    allocated) and a ``DeltaApplier`` at its ``param_version``, whose
    floor starts there. Returns ``(applier, params)``."""
    from repro_torch.models import init_params
    from repro_torch.serve.delta import DeltaApplier, read_snapshot
    dev = resolve_device(device)
    tmpl = init_params(resolve_model_cfg(run), torch.Generator(),
                       torch.device("meta"))
    params, version = read_snapshot(snap_dir, tmpl, step, device=dev)
    return DeltaApplier(params, version=version), params
