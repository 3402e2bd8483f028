"""The port's memory model (``repro_torch.roofline.memory_model``)
against the reference's ``repro.roofline.memory_model``: the breakdown
(every term, ``total`` and ``peak``) and ``fits_hbm``'s verdict, equal
float for float over every registered arch, the four input shapes, the
three step kinds, every sparsifier kind on both pipelines, both error
state dtypes, both REGTOP-k state formats, a donated and an undonated
state, and the (tp, dp) meshes (1, 1), (4, 4) and (16, 16). The port's
only change is ``fits_hbm``'s default capacity: the H100's memory, where
the reference's is the v5e's 16 GB."""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import base as jbase  # noqa: E402
from repro.roofline import memory_model as jmm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.roofline import memory_model as tmm  # noqa: E402

KINDS = ("topk", "dgc", "regtopk", "thresholdk", "randk", "sketchtopk",
         "none", "globaltopk")
PIPELINES = ("reference", "fused")
EF_DTYPES = ("float32", "bfloat16")
STATE_FORMATS = ("dense", "sparse")
MESHES = ((1, 1), (4, 4), (16, 16))
STEPS = ("train", "prefill", "decode")
TERMS = ("params", "grads", "opt", "ef", "cache", "activations",
         "compress_transient", "state_double_buffer", "total", "peak")
V5E_HBM = 16e9               # the reference's fits_hbm default


def _runs(mod, arch: str, shape: str, kind: str, pipeline: str):
    sp = mod.SparsifierConfig(kind=kind, pipeline=pipeline,
                              comm_mode="sparse", sparsity=0.001)
    return mod.RunConfig(model=mod.get_config(arch),
                         shape=mod.SHAPES[shape], sparsifier=sp)


@pytest.mark.parametrize("arch", tbase.list_archs())
def test_per_device_memory_matches_the_reference(arch):
    assert tbase.list_archs() == jbase.list_archs()
    n = 0
    for shape, kind, pipeline in itertools.product(
            jbase.SHAPES, KINDS, PIPELINES):
        jrun = _runs(jbase, arch, shape, kind, pipeline)
        trun = _runs(tbase, arch, shape, kind, pipeline)
        for step, ef, fmt, donate, (tp, dp) in itertools.product(
                STEPS, EF_DTYPES, STATE_FORMATS, (True, False), MESHES):
            kw = dict(tp=tp, dp=dp, kind=step, ef_dtype=ef,
                      state_format=fmt, donate_ef=donate)
            want = jmm.per_device_memory(jrun, **kw)
            got = tmm.per_device_memory(trun, **kw)
            for term in TERMS:
                assert getattr(got, term) == getattr(want, term), (
                    shape, kind, pipeline, kw, term)
            ok, mb = tmm.fits_hbm(trun, hbm_bytes=V5E_HBM, **kw)
            assert (ok, dataclasses.asdict(mb)) == (
                jmm.fits_hbm(jrun, **kw)[0], dataclasses.asdict(want))
            n += 1
    assert n == len(jbase.SHAPES) * len(KINDS) * len(PIPELINES) * \
        len(STEPS) * len(EF_DTYPES) * len(STATE_FORMATS) * 2 * len(MESHES)


def test_fits_hbm_defaults_to_the_h100():
    """``fits_hbm`` gates on the H100's 85,017,493,504 bytes: StableLM-3B
    trains on one card at 8 layers (the measured cell), and not at full
    depth (J = 2.8 G: 3 x 4 B of Adam state and the fp32 gradient alone
    pass 45 GB, the 256 x 4096 batch's activations the rest)."""
    assert tmm.H100_TOTAL_MEMORY == 85_017_493_504
    full = _runs(tbase, "stablelm-3b", "train_4k", "regtopk", "fused")
    ok, mb = tmm.fits_hbm(full, tp=1, dp=1)
    assert not ok and mb.peak > tmm.H100_TOTAL_MEMORY
    cut = dataclasses.replace(full, model=dataclasses.replace(
        full.model, n_layers=8), shape=tbase.ShapeConfig("main", 128, 8,
                                                          "train"))
    ok, mb = tmm.fits_hbm(cut, tp=1, dp=1)
    assert ok and mb.peak == mb.total + mb.compress_transient
