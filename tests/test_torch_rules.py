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
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []


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
    from repro_torch.train.step import build_train_step, init_train_state
    run = run_config(parse_args(["--arch", "stablelm-3b", "--smoke"]))
    calls = [lambda: resolve_device(None), lambda: resolve_device("cuda"),
             lambda: init_train_state(run), lambda: build_train_step(run),
             lambda: train(run, log=lambda m: None),
             lambda: main(["--arch", "stablelm-3b", "--smoke", "--steps",
                           "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


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


@pytest.mark.parametrize("field,value,item", [
    ("selector", "histogram", "A8"), ("num_buckets", 4, "A8"),
    ("allocation", "adaptive", "A9"), ("overlap", "backward", "A11"),
    ("ef_dtype", "bfloat16", "A8"), ("kind", "thresholdk", "A8"),
    ("num_buckets", 0, "A8"), ("allocation", "proportional", "A9"),
    ("kind", "randk", "A8"), ("wire_dtype", "bfloat16", "A8")])
def test_configs_outside_the_slice_raise(field, value, item):
    cfg = cfgs.SparsifierConfig(kind="regtopk", pipeline="fused",
                                comm_mode="sparse")
    aggregate.GradientSync(cfg)
    bad = dataclasses.replace(cfg, **{field: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        aggregate.GradientSync(bad)
    if field not in ("comm_mode", "wire_dtype"):
        with pytest.raises(NotImplementedError):
            sparsify.init_state(bad, 100, "cpu")


@pytest.mark.parametrize("field,value,item", [
    ("norm", "rmsnorm", "A7"), ("act", "gelu", "A7"),
    ("qkv_bias", True, "A7"), ("tie_embeddings", True, "A7"),
    ("family", "moe", "A13")])
def test_models_outside_the_slice_raise(field, value, item):
    from repro_torch.models import init_params
    cfg = cfgs.reduced_config(cfgs.get_config("stablelm-3b"))
    bad = dataclasses.replace(cfg, **{field: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        init_params(bad, torch.Generator(), "cpu")


def test_optimizers_outside_the_slice_raise():
    """An unknown kind raises ValueError, as the reference's does; an
    unsharded optimizer (zero1=False) is not served and names A7."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        init_opt_state(cfgs.OptimizerConfig(zero1=False), torch.zeros(4))


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
    ("num_buckets", 4, "A8"), ("wire_dtype", "bfloat16", "A8"),
    ("allocation", "proportional", "A9"), ("selector", "histogram", "A8"),
    ("ef_dtype", "bfloat16", "A8"), ("overlap", "backward", "A11"),
    ("err_decay", 0.9, "A10"), ("combine", "support", "A10"),
    ("num_buckets", 0, "A8"), ("kind", "randk", "A8")])
def test_sketch_configs_outside_the_slice_raise(field, value, item):
    for pipeline in ("fused", "reference"):
        cfg = cfgs.SparsifierConfig(kind="sketchtopk", pipeline=pipeline,
                                    comm_mode="sparse")
        aggregate.GradientSync(cfg)
        bad = dataclasses.replace(cfg, **{field: value})
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            aggregate.GradientSync(bad)


def test_participation_masks_raise():
    cfg = cfgs.SparsifierConfig(kind="sketchtopk", pipeline="fused",
                                comm_mode="sparse")
    sync = aggregate.GradientSync(cfg)
    st = sparsify.init_state(cfg, 64, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        sync(st, torch.zeros(64), participate=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        sync.round([st], [torch.zeros(64)], participate=[True])


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
