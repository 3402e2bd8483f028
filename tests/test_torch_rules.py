"""Package rules of the PyTorch port: it stands alone (no jax, nothing of
the reference package), it runs on the card unless the CPU is asked for,
its kernel wrappers never fall back to the plain version, and configs it
does not serve yet raise instead of being rerouted."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.backend import resolve_device  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.core import aggregate, sparsify  # noqa: E402
from repro_torch.kernels.compress import kernel as pk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b"
    r"|import_module\(\s*['\"](?:jax|repro)\b", re.MULTILINE)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 10
    pkg = ROOT / "src" / "repro_torch"
    for module in ("serve/step.py", "serve/__init__.py", "launch/serve.py",
                   "configs/granite_8b.py", "configs/qwen1_5_32b.py",
                   "configs/starcoder2_7b.py", "serve/delta.py",
                   "checkpoint/__init__.py", "checkpoint/io.py",
                   "core/faults.py", "core/allocate.py",
                   "models/parallel.py", "launch/mesh.py", "models/moe.py",
                   "configs/granite_moe_3b_a800m.py",
                   "configs/deepseek_v2_lite_16b.py", "models/xlstm.py",
                   "models/mamba.py", "configs/xlstm_125m.py",
                   "configs/jamba_v0_1_52b.py"):
        assert pkg / module in files, module
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []


FINISHED_ITEMS = re.compile(r"ROADMAP A1(3[def]?|4|6)\b")


def test_no_gate_names_a_finished_item():
    """A13 (every family), A13d (tensor parallelism), A13e
    (context-parallel decode), A13f (bidirectional MLA), A14 (deltas over
    a group) and A16 (the cost models and the bucket auto-tune) are
    ported: no file of the port names them as a ROADMAP item any more
    (A4, a speed item, is left alone by the pattern)."""
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0)}"
                 for p in _port_files()
                 for m in FINISHED_ITEMS.finditer(p.read_text())]
    assert offenders == []
    for item in ("ROADMAP A13", "ROADMAP A13d", "ROADMAP A13e",
                 "ROADMAP A13f", "ROADMAP A14)", "ROADMAP A16"):
        assert FINISHED_ITEMS.search(item), item
    for item in ("ROADMAP A4", "ROADMAP A17"):
        assert not FINISHED_ITEMS.search(item), item


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.kernels import x", "import repro",
                 "  from repro import configs",
                 "importlib.import_module('jax')"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "# jax.tree_util order"):
        assert not FORBIDDEN.search(line), line


def test_cpu_step_runs_without_jax(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.launch.train import main\n"
        "main(['--arch', 'stablelm-3b', '--smoke', '--steps', '1',"
        " '--batch', '2', '--seq', '16', '--device', 'cpu'])\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--arch', 'granite-8b', '--smoke', '--batch', '2',"
        " '--prompt-len', '8', '--new-tokens', '2', '--device', 'cpu'])\n"
        "main(['--arch', 'stablelm-3b', '--smoke', '--steps', '2',"
        " '--batch', '2', '--seq', '16', '--device', 'cpu',"
        " '--publish-deltas', 'spool', '--checkpoint-dir', 'ckpt'])\n"
        "serve.main(['--arch', 'stablelm-3b', '--smoke', '--batch', '2',"
        " '--prompt-len', '8', '--new-tokens', '2', '--device', 'cpu',"
        " '--apply-deltas', 'spool',"
        " '--delta-fault-schedule', 'loss:0.4,seed=2'])\n"
        "main(['--arch', 'stablelm-3b', '--smoke', '--steps', '2',"
        " '--batch', '2', '--seq', '16', '--device', 'cpu',"
        " '--comm', 'sparse', '--pipeline', 'fused',"
        " '--allocation', 'adaptive', '--overlap', 'backward'])\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.')"
        " for m in sys.modules)\n"
        "print('NOJAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX_OK" in res.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch.launch.train import main, run_config, parse_args, train
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        restore_train_state)
    run = run_config(parse_args(["--arch", "stablelm-3b", "--smoke"]))
    calls = [lambda: resolve_device(None), lambda: resolve_device("cuda"),
             lambda: init_train_state(run), lambda: build_train_step(run),
             lambda: restore_train_state("ckpt", 1, run),
             lambda: train(run, log=lambda m: None),
             lambda: main(["--arch", "stablelm-3b", "--smoke", "--steps",
                           "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_serve_entry_points_default_to_the_card():
    """The serve builders and launcher take the card unless the CPU is
    named, and raise naming the missing device without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch.launch import serve as launcher
    from repro_torch.serve.step import (build_decode_step, build_prefill,
                                        delta_applier_from_snapshot)
    args = launcher.parse_args(["--arch", "granite-8b", "--smoke"])
    assert args.device is None
    run = launcher.run_config(args)
    calls = [lambda: build_prefill(run), lambda: build_decode_step(run),
             lambda: build_prefill(run, "cuda"),
             lambda: launcher.serve(run, log=lambda m: None),
             lambda: launcher.main(["--arch", "granite-8b", "--smoke"]),
             lambda: delta_applier_from_snapshot(run, "spool/snapshots"),
             lambda: launcher.main(["--arch", "granite-8b", "--smoke",
                                    "--apply-deltas", "spool"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    build_prefill(run, "cpu")
    build_decode_step(run, "cpu")


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_data_parallel_launchers_take_the_card(launcher, monkeypatch):
    """Under torchrun's environment ``--data 2`` joins the group on this
    rank's card: without a card it raises naming the missing device, and
    never joins over gloo on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    import importlib
    import torch.distributed as dist
    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    for key, val in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0"),
                     ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(key, val)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--arch", "stablelm-3b", "--smoke", "--data", "2"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("field", ["model_axis", "tp", "seq_parallel",
                                   "attn_dist"])
def test_tensor_parallel_fields_raise(field):
    """The reference's tensor-parallel fields read as its defaults on a
    one-rank ``Parallel`` (no model group: tp 1); ring attention
    (``attn_dist="ring"``) is ported, off at tp 1, and an ``attn_dist``
    the reference does not have is a ValueError naming it."""
    from repro_torch.models.parallel import Parallel, ring_on
    want = {"model_axis": None, "tp": 1, "seq_parallel": False,
            "attn_dist": "sp"}
    assert getattr(Parallel(), field) == want[field]
    assert not Parallel(seq_parallel=True).sp and not Parallel().tp_on
    assert Parallel(attn_dist="ring").attn_dist == "ring"
    assert not ring_on(Parallel(attn_dist="ring"))
    with pytest.raises(ValueError, match="unknown attn_dist 'cp'"):
        Parallel(attn_dist="cp")
    assert Parallel().size == 1 and Parallel().rank == 0


@pytest.mark.parametrize("arch,outside", [
    ("deepseek-v2-lite-16b", False), ("xlstm-125m", False),
    ("jamba-v0.1-52b", False), ("whisper-small", True),
    ("phi-3-vision-4.2b", True)])
def test_tensor_parallel_gates(arch, outside):
    """Under a model group (``model`` > 1) every family draws a rank's
    share of its parameters: MLA, the SSM family (xLSTM), the hybrid
    (Jamba), and since A13d's last part the encoder-decoder (its
    encoder, and its decoder's ``cross`` leaves and cache by head) and
    the vision stub (``outside`` marks those two, once outside the
    slice). Context-parallel decode beside the model group (a data
    group of 2 here) gives every family its slice of the attention
    slots (MLA's ckv and krope too) and the whole of every recurrent
    state, split by channels over the model group (A13e, done)."""
    from repro_torch.core.flatten import tree_items, tree_size
    from repro_torch.models import attention, transformer
    from repro_torch.models.parallel import Parallel

    class Model(Parallel):
        tp, tp_on, model_rank = 2, True, 0

    cfg = cfgs.reduced_config(cfgs.get_config(arch))
    local = transformer.init_params(cfg, torch.Generator(), "meta", Model())
    whole = transformer.init_params(cfg, torch.Generator(), "meta")
    assert tree_size(local) < tree_size(whole)
    class TwoDataRanks(Model):
        size = 2

    cp = TwoDataRanks(cache_seq_sharded=True)
    cache = transformer.init_decode_cache(cfg, 1, 8, torch.float32, "meta",
                                          cp, enc_seq=4)
    one = transformer.init_decode_cache(cfg, 1, 8, torch.float32, "meta",
                                        Model(), enc_seq=4)
    for (path, leaf), (_, full) in zip(tree_items(cache), tree_items(one)):
        if path[0] != "cross" and path[-1] in attention.CACHE_KEYS:
            lead = int(path[0] == "blocks")
            assert leaf.shape[lead + 1] * 2 == full.shape[lead + 1], path
        else:
            assert leaf.shape == full.shape, path
    if not outside:
        return
    assert cache["blocks"]["l0"]["k"].shape[-2] == cfg.n_kv_heads // 2
    if cfg.is_encoder_decoder:
        assert local["encoder"]["blocks"]["attn"]["wq"].shape[-1] * 2 == \
            whole["encoder"]["blocks"]["attn"]["wq"].shape[-1]
        assert local["blocks"]["l0"]["cross"]["wo"].shape[-2] * 2 == \
            whole["blocks"]["l0"]["cross"]["wo"].shape[-2]
        assert cache["cross"]["k"].shape[-2] == cfg.n_kv_heads // 2


def test_card_path_never_calls_the_plain_version(monkeypatch):
    """With tensors the wrappers treat as on the card, a kernel that
    cannot be loaded raises; the plain versions are never reached."""
    plain_calls = []
    monkeypatch.setattr(pk, "_on_card", lambda x: True)
    monkeypatch.setattr(pk, "sweep1_plain",
                        lambda *a, **k: plain_calls.append("sweep1"))
    monkeypatch.setattr(pk, "sweep2_plain",
                        lambda *a: plain_calls.append("sweep2"))

    def no_library(name):
        raise RuntimeError(f"cannot load {name}")
    monkeypatch.setattr(pk, "_lib", no_library)
    x = torch.zeros(4096)
    before = (pk.sweep1.launches, pk.sweep1_dgc.launches,
              pk.sweep2.launches)
    with pytest.raises(RuntimeError, match="cannot load sweep1"):
        pk.sweep1(x, x, torch.ones(1))
    with pytest.raises(RuntimeError, match="cannot load sweep1"):
        pk.sweep1(x, x, torch.ones(1), x, 0.9)          # dgc mode
    with pytest.raises(RuntimeError, match="cannot load sweep1"):
        pk.sweep1_dgc(x, x, x, torch.ones(1), 0.9)
    with pytest.raises(RuntimeError, match="cannot load sweep2"):
        pk.sweep2(x, torch.ones(1), 32)
    assert plain_calls == []
    assert (pk.sweep1.launches, pk.sweep1_dgc.launches,
            pk.sweep2.launches) == before


def test_other_devices_raise():
    x = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError, match="no sweep for device"):
        pk.sweep1(x, x, torch.ones(1, device="meta"))
    with pytest.raises(RuntimeError, match="no sweep for device"):
        pk.sweep1_dgc(x, x, x, torch.ones(1, device="meta"), 0.9)


def _served(cfg, j: int = 100):
    """The config is served: the sync builds, the state has the
    reference's keys and dtypes, and one step of the sync runs."""
    from repro.configs.base import SparsifierConfig as JaxSparsifierConfig
    from repro.core import sparsify as jsp
    sync = aggregate.GradientSync(cfg)
    st = sparsify.init_state(cfg, j, "cpu")
    jst = jsp.init_state(JaxSparsifierConfig(**dataclasses.asdict(cfg)), j)
    # the port keeps uint32 indices as int32 views of the same bits
    assert {k: str(v.dtype).replace("uint32", "int32")
            for k, v in jst.items()} == {
        k: str(v.dtype).replace("torch.", "") for k, v in st.items()}
    g_agg, new = sync(st, torch.randn(j, generator=torch.Generator()
                                      .manual_seed(0)))
    assert g_agg.shape == (j,) and set(new) == set(st)


# the bucket auto-tune's case keeps its id from when it raised A16
@pytest.mark.parametrize("field,value,outcome", [
    ("selector", "histogram_kernel", "served"),
    pytest.param("num_buckets", 0, "served", id="num_buckets-0-A16"),
    ("allocation", "adaptive", "served"), ("overlap", "backward", "served"),
    ("ef_dtype", "bfloat16", "served"), ("selector", "histogram", "served"),
    ("kind", "none", "served"), ("allocation", "proportional", "served"),
    ("kind", "globaltopk", "served"), ("state_format", "sparse", "served")])
def test_configs_outside_the_slice_raise(field, value, outcome):
    """Every config of the grid is served: the bucket auto-tune
    (``num_buckets=0``), the fused pipeline's allocation, streaming and
    ``histogram_kernel`` (which runs
    the reference pipeline, as the reference's dispatch routes it), and
    with a bf16 error state on the reference pipeline REGTOP-k in either
    layout, the histogram selectors and the dense-wire baselines."""
    fused = cfgs.SparsifierConfig(kind="regtopk", pipeline="fused",
                                  comm_mode="sparse")
    cfg = fused if field in ("allocation", "overlap", "num_buckets") or \
        value == "histogram_kernel" else dataclasses.replace(
            fused, pipeline="reference", ef_dtype="bfloat16",
            **({"kind": "topk"} if field == "selector" else {}))
    if field == "ef_dtype":
        cfg = dataclasses.replace(cfg, ef_dtype="float32")
    _served(dataclasses.replace(cfg, ef_dtype="float32"))
    bad = dataclasses.replace(cfg, **{field: value})
    if outcome == "served":
        _served(bad)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {outcome}"):
        aggregate.GradientSync(bad)
    with pytest.raises(NotImplementedError):
        sparsify.init_state(bad, 100, "cpu")


@pytest.mark.parametrize("field", ["comm_mode", "combine", "wire_dtype"])
def test_unknown_sync_fields_raise_value_error(field):
    """An unknown ``comm_mode``, ``combine`` or ``wire_dtype`` is a
    ValueError naming the field and the values the port takes, not a
    gate of unported work; the known values build."""
    cfg = cfgs.SparsifierConfig(kind="regtopk", pipeline="fused",
                                comm_mode="sparse")
    for known in {"comm_mode": aggregate.COMM_MODES,
                  "combine": aggregate.COMBINES,
                  "wire_dtype": aggregate.WIRE_DTYPES}[field]:
        aggregate.GradientSync(dataclasses.replace(cfg, **{field: known}))
    bad = dataclasses.replace(cfg, **{field: "allgather"})
    with pytest.raises(ValueError, match=f"unknown {field}"):
        aggregate.GradientSync(bad)
    with pytest.raises(ValueError, match="allgather"):
        aggregate.check_supported(bad)


def _reference_grid():
    """Every SparsifierConfig over the values the reference documents
    for each field that changes what its GradientSync serves."""
    import itertools
    fields = dict(
        kind=("topk", "dgc", "regtopk", "randk", "thresholdk", "sketchtopk",
              "none", "globaltopk"),
        pipeline=("reference", "fused"),
        selector=("exact", "histogram", "histogram_kernel"),
        ef_dtype=("float32", "bfloat16"),
        comm_mode=("sparse", "simulate", "dense"),
        num_buckets=(0, 1, 3),
        state_format=("dense", "sparse"),
        allocation=("global", "proportional"),
        overlap=("none", "backward"),
        combine=("mean", "support"))
    for values in itertools.product(*fields.values()):
        yield dict(zip(fields, values))


def test_only_the_bucket_auto_tune_and_the_references_errors_remain():
    """Walks the grid of configs: where the reference's GradientSync
    raises its ValueError, the port raises the same message; where it
    builds, the port builds too, ``num_buckets=0`` (the bucket auto-tune)
    included, which resolves at build time from J and one rank to the
    reference's count at the same constants (``auto``), and the state
    has the reference's keys."""
    from repro.configs.base import SparsifierConfig as JaxSparsifierConfig
    from repro.core import aggregate as jagg
    from repro.core import sparsify as jsp
    outcomes = {"served": 0, "auto": 0, "ValueError": 0}
    layouts = {}
    for fields in _reference_grid():
        cfg = cfgs.SparsifierConfig(**fields)
        try:
            jagg.GradientSync(JaxSparsifierConfig(**fields), None)
        except ValueError as ref:
            with pytest.raises(ValueError) as got:
                aggregate.GradientSync(cfg)
            assert str(got.value) == str(ref), fields
            outcomes["ValueError"] += 1
            continue
        if cfg.num_buckets == 0:
            # 64 elements resolve to one bucket at either package's
            # constants; the baselines select nothing and keep the 0
            sync = aggregate.GradientSync(cfg, j=64)
            assert sync.cfg.num_buckets == (
                0 if sync.selection == "none" else jsp.resolve_num_buckets(
                    JaxSparsifierConfig(**fields), 64)), fields
            outcomes["auto"] += 1
        aggregate.GradientSync(cfg)
        key = tuple(fields[f] for f in ("kind", "pipeline", "selector",
                                        "state_format"))
        if key not in layouts:
            jst = jsp.init_state(JaxSparsifierConfig(**fields), 64)
            layouts[key] = set(jst)
            assert set(sparsify.init_state(cfg, 64, "cpu")) == set(jst), \
                fields
        outcomes["served"] += 1
    assert all(outcomes.values()), outcomes


# every family and MLA are served (item None): the reduced smoke model's
# widths with 4 experts of 64, top-2; MLA at lora 32, rope dim 16;
# xLSTM's alternating mLSTM and sLSTM; Mamba at d_state 8 beside
# attention; Whisper's 2-layer encoder over 16 stub frames with
# cross-attention; Phi-3-vision's 16 stub patches
SERVED_BY_FIELD = {
    ("family", "moe"): dict(moe=cfgs.MoEConfig(n_experts=4, top_k=2,
                                               d_expert=64)),
    ("attn_kind", "mla"): dict(kv_lora_rank=32, rope_head_dim=16,
                               v_head_dim=32),
    ("family", "ssm"): dict(attn_every=0, rope=False, ssm=cfgs.SSMConfig(
        kind="xlstm", d_state=8)),
    ("family", "hybrid"): dict(attn_every=2, attn_offset=1, rope=False,
                               ssm=cfgs.SSMConfig(kind="mamba", d_state=8)),
    ("family", "audio"): dict(rope=False, is_encoder_decoder=True,
                              n_enc_layers=2, frontend="audio_stub",
                              n_frontend_tokens=16),
    ("family", "vlm"): dict(frontend="vision_stub", n_frontend_tokens=16)}


# the ids are the cases' names from when the SSM, hybrid, audio and
# vision families and the Mamba mixer raised
@pytest.mark.parametrize("field,value,item", [
    pytest.param("family", "moe", None, id="family-moe-None"),
    pytest.param("family", "ssm", None, id="family-ssm-A13"),
    pytest.param("family", "hybrid", None, id="family-hybrid-A13"),
    pytest.param("family", "audio", None, id="family-audio-A13"),
    pytest.param("attn_kind", "mla", None, id="attn_kind-mla-None"),
    pytest.param("family", "vlm", None, id="family-vlm-A13"),
    pytest.param("mixer", "mamba", None, id="mixer-mamba-A13")])
def test_models_outside_the_slice_raise(field, value, item):
    """Every dense layout is served (rmsnorm, GELU, QKV bias, tied
    embeddings, no RoPE, sliding attention), and so are the MoE, SSM
    (xLSTM) and hybrid (Mamba beside attention) families, the audio
    (an encoder over stub frames, cross-attention) and vision (stub
    patches) families, MLA, and a Mamba mixer in a dense model's
    pattern: init, loss, cache and prefill run, a batch carrying the
    model's stub inputs. A case with an item would raise naming it at
    init, in the loss, in the cache and in the serve step."""
    from repro_torch.data.synthetic import stub_inputs
    from repro_torch.models import init_params, loss_fn, transformer
    from repro_torch.serve.step import build_prefill
    cfg = cfgs.reduced_config(cfgs.get_config("stablelm-3b"))
    for served in (dict(norm="rmsnorm"), dict(act="gelu"),
                   dict(qkv_bias=True), dict(tie_embeddings=True),
                   dict(rope=False), dict(attn_kind="sliding")):
        init_params(dataclasses.replace(cfg, **served), torch.Generator(),
                    "cpu")
    if field == "mixer":
        bad = dataclasses.replace(cfg, attn_every=2,
                                  ssm=cfgs.SSMConfig(kind=value))
    else:
        bad = dataclasses.replace(cfg, **{field: value},
                                  **SERVED_BY_FIELD.get((field, value), {}))
    run = cfgs.RunConfig(model=bad, shape=cfgs.ShapeConfig(
        "serve", 8, 1, "decode"))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    if item is None:
        params = init_params(bad, torch.Generator().manual_seed(0), "cpu")
        stubs = stub_inputs(bad, 1, torch.Generator().manual_seed(0), "cpu")
        loss = loss_fn(params, {"tokens": tokens, "targets": tokens,
                                **stubs}, bad)
        assert torch.isfinite(loss)
        transformer.init_decode_cache(bad, 1, 8, torch.float32)
        logits, _ = build_prefill(run, "cpu")(params, {"tokens": tokens,
                                                       **stubs})
        assert logits.shape == (1, bad.vocab_size)
        return
    for call in (lambda: init_params(bad, torch.Generator(), "cpu"),
                 lambda: loss_fn({}, {}, bad),
                 lambda: transformer.init_decode_cache(bad, 1, 8,
                                                       torch.float32),
                 lambda: build_prefill(run, "cpu")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            call()


@pytest.mark.parametrize("change,error,match", [
    pytest.param(dict(enc_causal=True), ValueError, "enc_causal=True",
                 id="causal-encoder"),
    pytest.param(dict(attn_kind="mla", kv_lora_rank=32, rope_head_dim=16,
                      v_head_dim=32), None, None, id="mla-encoder-decoder")])
def test_encoder_decoders_outside_the_slice_raise(change, error, match):
    """A causal encoder (the reference's is bidirectional whatever
    ``enc_causal`` says) raises ValueError at init (at one rank and under
    a model group), in the loss and in the cache. An MLA encoder-decoder
    (``error`` None) builds in each of them, with the reference's tree
    (the encoder's MLA leaves, the plain cross-attention's) and its
    cache's leaves; bidirectional MLA attention runs at one rank, split
    by heads and under ring attention (tests/test_torch_mla_encoder.py
    holds it against the reference)."""
    from repro_torch.models import attention, init_params, loss_fn
    from repro_torch.models import transformer
    from repro_torch.models.parallel import Parallel

    class Model(Parallel):
        tp, tp_on, model_rank = 2, True, 0

    cfg = dataclasses.replace(
        cfgs.reduced_config(cfgs.get_config("whisper-small")), **change)
    if error is not None:
        for call in (lambda: init_params(cfg, torch.Generator(), "cpu"),
                     lambda: init_params(cfg, torch.Generator(), "meta",
                                         Model()),
                     lambda: loss_fn({}, {}, cfg),
                     lambda: transformer.init_decode_cache(cfg, 1, 8,
                                                           torch.float32)):
            with pytest.raises(error, match=match):
                call()
        return
    import jax
    from repro.configs import base as jbase
    from repro.models import init_params as jax_init_params
    from repro.models.parallel import Parallel as JaxParallel
    from repro.models.transformer import init_decode_cache as jax_cache
    from repro_torch.core.flatten import tree_items
    jcfg = dataclasses.replace(
        jbase.reduced_config(jbase.get_config("whisper-small")), **change)
    want = jax.eval_shape(lambda: jax_init_params(
        jcfg, JaxParallel(), jax.random.PRNGKey(0)))
    want = sorted(("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path), tuple(leaf.shape))
                  for path, leaf in jax.tree_util.tree_leaves_with_path(want))
    tree = init_params(cfg, torch.Generator(), "cpu")
    assert sorted(("/".join(map(str, path)), tuple(leaf.shape))
                  for path, leaf in tree_items(tree)) == want
    init_params(cfg, torch.Generator(), "meta", Model())
    cache = transformer.init_decode_cache(cfg, 1, 8, torch.float32,
                                          enc_seq=16)
    jcache = jax.eval_shape(lambda: jax_cache(jcfg, JaxParallel(), 1, 8,
                                              "float32", enc_seq=16))
    assert sorted(leaf.shape for _, leaf in tree_items(cache)) == sorted(
        leaf.shape for leaf in jax.tree_util.tree_leaves(jcache))
    tok = torch.zeros(2, 8, dtype=torch.long)
    frames = torch.randn(2, 16, cfg.d_model)
    assert torch.isfinite(loss_fn(tree, {"tokens": tok, "targets": tok,
                                         "frames": frames}, cfg))
    x = torch.randn(1, 4, cfg.d_model)
    p = tree["encoder"]["blocks"]["attn"]
    one = {key: val[0] for key, val in p.items()}
    assert torch.isfinite(attention.attn_fwd_full(one, x, cfg,
                                                  causal=False)).all()


def test_unknown_family_raises_value_error():
    """A family the reference does not have raises ValueError naming it
    wherever the model is checked (init, the loss)."""
    from repro_torch.models import init_params, loss_fn
    cfg = dataclasses.replace(
        cfgs.reduced_config(cfgs.get_config("stablelm-3b")), family="video")
    for call in (lambda: init_params(cfg, torch.Generator(), "cpu"),
                 lambda: loss_fn({}, {}, cfg)):
        with pytest.raises(ValueError, match="unknown family 'video'"):
            call()


def test_unknown_mixer_raises():
    """An SSM kind the reference does not have makes a mixer no layer
    runs: ValueError naming it."""
    from repro_torch.models import init_params
    cfg = dataclasses.replace(
        cfgs.reduced_config(cfgs.get_config("stablelm-3b")), attn_every=2,
        ssm=cfgs.SSMConfig(kind="s4"))
    with pytest.raises(ValueError, match="unknown mixer 's4'"):
        init_params(cfg, torch.Generator(), "cpu")


def test_unknown_attn_kind_raises():
    """An attention kind the reference does not have (it knows full,
    sliding and MLA) is a ValueError naming it, as an unknown family or
    mixer is."""
    from repro_torch.models import init_params
    cfg = dataclasses.replace(
        cfgs.reduced_config(cfgs.get_config("stablelm-3b")),
        attn_kind="linear")
    with pytest.raises(ValueError) as err:
        init_params(cfg, torch.Generator(), "cpu")
    assert str(err.value) == (
        "stablelm-3b-smoke: unknown attn_kind 'linear' (expected one of "
        "('full', 'sliding', 'mla'))")


# the ids are the cases' names from when context-parallel decode of these
# models raised
@pytest.mark.parametrize("arch,item", [
    pytest.param("xlstm-125m", "A13e", id="xlstm-125m-A13e"),
    pytest.param("jamba-v0.1-52b", "A13e", id="jamba-v0.1-52b-A13e"),
    pytest.param("deepseek-v2-lite-16b", "A13",
                 id="deepseek-v2-lite-16b-A13")])
def test_context_parallel_decode_of_ssm_models_raises(arch, item,
                                                      monkeypatch):
    """Context-parallel decode (a batch below the group's size) of an SSM,
    hybrid or MLA model builds (ROADMAP A13e, done): the decode builder
    over a data group of 2 takes a cache of half the slots, which the
    cache's own layout gives (the attention leaves' slots halved, the
    recurrent state whole); a data-parallel batch of the same model
    builds too. tests/test_torch_world_cp.py holds the numbers against
    the reference."""
    from repro_torch.core.flatten import tree_items
    from repro_torch.models import attention, transformer
    from repro_torch.models.parallel import Parallel
    from repro_torch.serve import step as serve_step
    monkeypatch.setattr(serve_step, "world", lambda group: (2, 0))
    cfg = cfgs.reduced_config(cfgs.get_config(arch))

    class TwoDataRanks(Parallel):
        size = 2
    for batch in (1, 2):
        run = cfgs.RunConfig(model=cfg, shape=cfgs.ShapeConfig(
            "serve", 8, batch, "decode"))
        serve_step.build_decode_step(run, "cpu")
        assert serve_step.serve_parallel(run, decode=True) \
            .cache_seq_sharded == (batch == 1)
    cache = transformer.init_decode_cache(
        cfg, 1, 8, torch.float32, pal=TwoDataRanks(cache_seq_sharded=True))
    one = transformer.init_decode_cache(cfg, 1, 8, torch.float32)
    state = 0
    for (path, leaf), (_, full) in zip(tree_items(cache), tree_items(one)):
        if path[-1] in attention.CACHE_KEYS:
            lead = int(path[0] == "blocks")
            assert leaf.shape[lead + 1] == 4 == full.shape[lead + 1] // 2
        else:
            assert leaf.shape == full.shape, path
            state += path != ("pos",)
    assert (state > 0) == (cfg.ssm is not None)


def test_context_parallel_mla_decode_raises():
    """Context-parallel decode of an MLA model runs (ROADMAP A13e, done):
    over a data group of one rank its cache is the one-rank cache, and
    its decode step equals the one-rank step, bitwise in the expanded
    form (the merge scales by exp(0)) and within 1e-6 of the scale in
    the absorbed form (the reference's cp form: the context merged
    unnormalised, then divided, not the one-rank softmax)."""
    from repro_torch.models import attention, init_params, transformer
    from repro_torch.models.parallel import Parallel
    base = cfgs.reduced_config(cfgs.get_config("deepseek-v2-lite-16b"))
    cp = Parallel(cache_seq_sharded=True)
    for absorb in (False, True):
        cfg = dataclasses.replace(base, mla_absorb=absorb)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        layer = params["prefix"][0]["attn"]
        x = torch.randn((1, 1, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
        caches = [transformer.init_decode_cache(cfg, 1, 8, torch.float32,
                                                pal=pal)
                  for pal in (cp, None)]
        for c in caches:
            c["prefix"][0]["ckv"].normal_(generator=torch.Generator()
                                          .manual_seed(2))
            c["prefix"][0]["krope"].normal_(generator=torch.Generator()
                                            .manual_seed(3))
        pos = torch.tensor(5, dtype=torch.int32)
        with torch.inference_mode():
            got = attention.attn_decode(layer, x, caches[0]["prefix"][0], pos,
                                        cfg, cp)
            want = attention.attn_decode(layer, x, caches[1]["prefix"][0],
                                         pos, cfg)
        assert got.shape == (1, 1, cfg.d_model)
        for name in ("ckv", "krope"):
            assert torch.equal(caches[0]["prefix"][0][name],
                               caches[1]["prefix"][0][name])
        if absorb:
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-6 * scale
        else:
            assert torch.equal(got, want)


def test_optimizers_outside_the_slice_raise():
    """An unknown kind raises ValueError, as the reference's does;
    ``zero1=False`` is accepted and shards anyway, as the reference
    ignores the field: the state is the same as with zero1=True."""
    from repro_torch.optim import apply_updates, init_opt_state
    for kind in ("sgd", "momentum", "adam", "adamw"):
        init_opt_state(cfgs.OptimizerConfig(kind=kind), torch.zeros(4))
    bad = cfgs.OptimizerConfig(kind="lamb")
    with pytest.raises(ValueError, match="lamb"):
        init_opt_state(bad, torch.zeros(4))
    with pytest.raises(ValueError, match="lamb"):
        apply_updates(bad, {"master": torch.zeros(4),
                            "step": torch.zeros((), dtype=torch.int32)},
                      torch.zeros(4))
    g = torch.arange(4.0)
    for kind in ("sgd", "adam"):
        states = [init_opt_state(cfgs.OptimizerConfig(kind=kind, zero1=z),
                                 torch.ones(4)) for z in (True, False)]
        assert sorted(states[0]) == sorted(states[1])
        outs = [apply_updates(cfgs.OptimizerConfig(kind=kind, zero1=z), st,
                              g)[0] for z, st in zip((True, False), states)]
        assert torch.equal(outs[0], outs[1])


def test_sketch_card_path_never_calls_the_plain_version(monkeypatch):
    """The encode kernels (B3, B4) on tensors treated as on the card: a
    kernel that cannot be loaded raises, the plain versions are never
    reached and no launch is counted."""
    plain_calls = []
    monkeypatch.setattr(pk, "_on_card", lambda x: True)
    monkeypatch.setattr(pk, "sweep1_sketch_plain",
                        lambda *a: plain_calls.append("sweep1_sketch"))
    monkeypatch.setattr(pk, "sketch_encode_plain",
                        lambda *a: plain_calls.append("sketch_encode"))

    def no_library(name):
        raise RuntimeError(f"cannot load {name}")
    monkeypatch.setattr(pk, "_lib", no_library)
    from repro_torch.core import sketch
    x = torch.zeros(4096)
    before = (pk.sweep1_sketch.launches, pk.sketch_encode.launches)
    with pytest.raises(RuntimeError, match="cannot load sketch"):
        pk.sweep1_sketch(x, x, 3, 512)
    with pytest.raises(RuntimeError, match="cannot load sketch"):
        sketch.encode(x, 3, 512)
    assert plain_calls == []
    assert (pk.sweep1_sketch.launches, pk.sketch_encode.launches) == before


@pytest.mark.parametrize("fn", ["sweep1_sketch", "sketch_encode"])
def test_sketch_kernels_on_other_devices_raise(fn):
    x = torch.zeros(8, device="meta")
    args = (x, x) if fn == "sweep1_sketch" else (x,)
    with pytest.raises(RuntimeError, match="no sweep for device"):
        getattr(pk, fn)(*args, 3, 512)


@pytest.mark.parametrize("field,value,item", [
    ("num_buckets", 4, "served"), ("wire_dtype", "bfloat16", "served"),
    ("allocation", "proportional", ValueError),
    ("selector", "histogram", "served"),
    ("ef_dtype", "bfloat16", "served"), ("overlap", "backward", ValueError),
    ("err_decay", 0.9, "served"), ("combine", "support", "served"),
    pytest.param("num_buckets", 0, "served", id="num_buckets-0-A16"),
    ("allocation", "adaptive", ValueError)])
def test_sketch_configs_outside_the_slice_raise(field, value, item):
    """The sketch serves buckets, the bf16 state and wire, the histogram
    selectors and the elastic fields on both pipelines (``item``
    "served": the sync builds, the state has the reference's keys and
    dtypes, one step runs), the bucket auto-tune too (its case keeps its
    id from when it raised); allocation and streaming, which the
    reference does not define
    for the sketch (``item`` ValueError), raise its ValueError, at build
    time as the reference's GradientSync does."""
    from repro.configs.base import SparsifierConfig as JaxSparsifierConfig
    from repro.core import aggregate as jagg
    for pipeline in ("fused", "reference"):
        cfg = cfgs.SparsifierConfig(kind="sketchtopk", pipeline=pipeline,
                                    comm_mode="sparse")
        aggregate.GradientSync(cfg)
        bad = dataclasses.replace(cfg, **{field: value})
        if item is ValueError:
            with pytest.raises(ValueError) as ref:
                jagg.GradientSync(JaxSparsifierConfig(
                    **dataclasses.asdict(bad)), None)
            with pytest.raises(ValueError) as got:
                aggregate.GradientSync(bad)
            assert str(got.value) == str(ref.value)
            continue
        if item == "served":
            _served(bad, 4096)
            continue
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            aggregate.GradientSync(bad)


def test_participation_masks_raise():
    """A participation mask with kind="sketchtopk" is served (it raised
    before the elastic sketch was ported): the per-step sync takes a
    bit and reports n_active, and round() takes a mask; only a bad
    combine raises, the reference's ValueError."""
    cfg = cfgs.SparsifierConfig(kind="sketchtopk", pipeline="fused",
                                comm_mode="sparse")
    sync = aggregate.GradientSync(cfg)
    st = sparsify.init_state(cfg, 64, "cpu")
    for p in (True, False):
        _, new, stats = sync(st, torch.ones(64), participate=torch.tensor(p),
                             with_stats=True)
        assert float(stats["n_active"]) == float(p)
        assert int(new["step"]) == 1
    g_agg, new = sync.round([st, st], [torch.ones(64)] * 2,
                            participate=[True, False])
    assert g_agg.shape == (64,) and len(new) == 2
    with pytest.raises(ValueError, match="combine"):
        aggregate.GradientSync(dataclasses.replace(cfg, combine="median"))


def test_reference_kernels_card_path_never_calls_the_plain_version(
        monkeypatch):
    """B5 (scores), B6 (apply) and B7 (histogram) on tensors treated as on
    the card: a kernel that cannot be loaded raises, the plain versions
    are never reached and no launch is counted."""
    from repro_torch.kernels.fused_ef import kernel as fef
    from repro_torch.kernels.topk_select import kernel as hk
    plain_calls = []
    for mod, names in ((fef, ("scores_plain", "apply_plain")),
                       (hk, ("histogram_plain",))):
        monkeypatch.setattr(mod, "on_card", lambda x: True)

        def no_library(name):
            raise RuntimeError(f"cannot load {name}")
        monkeypatch.setattr(mod, "lib", no_library)
        for name in names:
            monkeypatch.setattr(mod, name,
                                lambda *a, _n=name, **k: plain_calls.append(_n))
    x = torch.zeros(4096)
    before = (fef.scores.launches, fef.apply.launches, hk.histogram.launches)
    with pytest.raises(RuntimeError, match="cannot load fused_ef"):
        fef.scores(x, x, x, x, x, omega=1.0, mu=0.5, Q=0.0)
    with pytest.raises(RuntimeError, match="cannot load fused_ef"):
        fef.apply(x, x)
    with pytest.raises(RuntimeError, match="cannot load hist"):
        hk.histogram(x, torch.ones(()))
    assert plain_calls == []
    assert (fef.scores.launches, fef.apply.launches,
            hk.histogram.launches) == before


def test_reference_kernels_on_other_devices_raise():
    from repro_torch.kernels.fused_ef import kernel as fef
    from repro_torch.kernels.topk_select import kernel as hk
    x = torch.zeros(8, device="meta")
    for call in (lambda: fef.scores(x, x, x, x, x, omega=1.0, mu=0.5, Q=0.0),
                 lambda: fef.apply(x, x),
                 lambda: hk.histogram(x, torch.ones((), device="meta"))):
        with pytest.raises(RuntimeError, match="no sweep for device"):
            call()


def test_package_data_ships_every_kernel_source():
    """The setuptools package-data globs cover every CUDA source the
    kernels build from, so an installed repro_torch can build them."""
    import tomllib
    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["repro_torch"]
    pkg = ROOT / "src" / "repro_torch"
    shipped = {p for pattern in globs for p in pkg.glob(pattern)}
    sources = set((pkg / "kernels").glob("*/csrc/*"))
    assert len(sources) >= 7
    assert sources <= shipped, sorted(str(p.relative_to(pkg))
                                      for p in sources - shipped)
