"""The harness: cells, configurations, traffic and metrics found by file
name; BENCHMARK.json within the contract; the result line's keys; the
check for JAX's modules; no run without a card; and a run with the
timed path broken underneath, once for each fault a cell can have, and
with the control in the program's place, coming out not correct."""
import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from bench import cell as cell_mod
from bench import checks, spec
from bench.tests.conftest import ROOT

sys.path.insert(0, str(ROOT / "bench"))
import run as bench_run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in bench_json()
                                  ["workloads"]])
def test_every_cell_loads(name):
    cell = spec.load(name)
    assert cell.chips in (1, 4)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}


def test_benchmark_json_keeps_the_contract():
    b = bench_json()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    # the whole check at 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, cells // 4)
    configs = {c["name"] for c in b["configs"]}
    assert configs == {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [x["name"] for x in b["configs"] + b["workloads"]
             + b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                          "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]} \
            if "workloads" in m else True


def test_added_cell_config_traffic_and_metric_are_found(tmp_path):
    """A new cell, configuration, traffic mix and per-layer metric are
    found by their file names, with only new files and new entries in
    BENCHMARK.json: no other file changes."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench/configs/stablelm-3b-4e1t.l8.json")
                     .read_text())
    cfg.update(name="stablelm-3b-4e1t.l4", num_hidden_layers=4)
    (root / "bench/configs/stablelm-3b-4e1t.l4.json").write_text(
        json.dumps(cfg))
    job = json.loads((root / "bench/traffic/regtopk.b1s4096.json")
                     .read_text())
    job.update(name="regtopk.b2s2048", batch_per_rank=2, seq=2048)
    (root / "bench/traffic/regtopk.b2s2048.json").write_text(
        json.dumps(job))
    (root / "bench/metrics/steps_traced.py").write_text(
        'UNIT = "steps"\nMOVES = "train_tokens_per_s"\n\n\n'
        "def read(view):\n    return view.steps\n")
    own = {"name": "stablelm3b.l4.long", "config": "stablelm-3b-4e1t.l4",
           "traffic": "regtopk.b2s2048", "chips": 1, "why": "test",
           "limits": {"loss_gap": 1e-3, "grad_gap": 0.1,
                      "update_gap": 0.1}}
    (root / "bench/workloads/stablelm3b.l4.long.json").write_text(
        json.dumps(own))
    b["configs"].append({"name": "stablelm-3b-4e1t.l4", "source": "test",
                         "file": "bench/configs/stablelm-3b-4e1t.l4.json",
                         "reduced": ["num_hidden_layers"], "why": "test"})
    b["workloads"].append({k: own[k] for k in ("name", "config", "traffic",
                                               "chips", "why")})
    b["per_layer"].append({"name": "steps_traced", "unit": "steps",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "train_tokens_per_s",
                           "workloads": ["stablelm3b.l4.long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load("stablelm3b.l4.long", root)
    assert cell.config["num_hidden_layers"] == 4
    assert cell.job["seq"] == 2048
    assert cell.readers["steps_traced"].read(
        type("V", (), {"steps": 6})()) == 6
    assert "steps_traced" not in spec.load("stablelm3b.regtopk",
                                           root).readers
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_family_and_a_sparsifier_are_found_by_name(tmp_path):
    """A configuration naming a family, and a traffic naming a kind, that
    exist only as new files are loaded from them."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for folder in ("families", "reference/models"):
        shutil.copy(root / "bench" / folder / "dense.py",
                    root / "bench" / folder / "dense_copy.py")
    for folder in ("sparsifiers", "reference/sparsifiers"):
        shutil.copy(root / "bench" / folder / "none.py",
                    root / "bench" / folder / "none_copy.py")
    path = root / "bench/reference/sparsifiers/none_copy.py"
    path.write_text(path.read_text().replace('("none",)',
                                             '("none_copy",)'))
    cfg = json.loads((root / "bench/configs/stablelm-3b-4e1t.l8.json")
                     .read_text())
    cfg["family"] = "dense_copy"
    job = json.loads((root / "bench/traffic/dense.b1s4096.json")
                     .read_text())
    job["sparsifier"]["kind"] = "none_copy"
    got = spec.parts(cfg, job, root)
    assert got["family"].__file__.endswith("families/dense_copy.py")
    assert got["model"].__file__.endswith("models/dense_copy.py")
    assert got["ref_sparsifier"].__file__.endswith(
        "sparsifiers/none_copy.py")
    cfg["family"] = "no_such_family"
    with pytest.raises(FileNotFoundError):
        spec.parts(cfg, job, root)


@pytest.mark.parametrize("part,key,value", [
    ("sparsifier", "num_buckets", 8), ("sparsifier", "ef_dtype", "bfloat16"),
    ("sparsifier", "wire_dtype", "bfloat16"),
    ("sparsifier", "selector", "histogram"), ("sparsifier", "momentum", 0.9),
    ("optimizer", "weight_decay", 0.1), ("optimizer", "kind", "adamw")])
def test_traffic_the_reference_does_not_follow_is_refused(part, key, value):
    cfg = json.loads((ROOT / "bench/configs/stablelm-3b-4e1t.l8.json")
                     .read_text())
    job = json.loads((ROOT / "bench/traffic/regtopk.b1s4096.json")
                     .read_text())
    spec.parts(cfg, job)
    job[part][key] = value
    with pytest.raises((ValueError, FileNotFoundError)):
        spec.parts(cfg, job)


def test_a_file_that_disagrees_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "bench/workloads/stablelm3b.regtopk.json"
    own = json.loads(path.read_text())
    own["chips"] = 4
    path.write_text(json.dumps(own))
    with pytest.raises(ValueError, match="chips"):
        spec.load("stablelm3b.regtopk", root)


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "stablelm3b.regtopk", "--seed",
                         str(2 ** 33), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA device" in out.err


def test_refuses_in_a_tree_of_the_benchmark_alone(tmp_path):
    """Without the program's sources beside it the run fails, printing
    no result."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "stablelm3b.regtopk",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""


def test_import_check_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in bench_run.BANNED:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert bench_run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert bench_run.banned_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert bench_run.banned_modules() == ["jax", "repro"]


def test_reference_import_check_finds_the_program(tmp_path, monkeypatch):
    shutil.copytree(ROOT / "bench" / "reference", tmp_path / "bench" /
                    "reference", ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(bench_run, "ROOT", tmp_path)
    assert bench_run.reference_imports() == []
    path = tmp_path / "bench" / "reference" / "optimizers" / "adam.py"
    path.write_text("from repro_torch.optim import apply_updates\n"
                    + path.read_text())
    assert bench_run.reference_imports() == ["repro_torch.optim"]


# -- a run driven on the CPU at a tiny size --------------------------------

CELL = "stablelm3b.regtopk"
# traffic -> (chips, limits) of a tiny cell; the regtopk cell's limits
# (the dense exchange has no compressor state; four ranks end equal)
TINY_TRAFFIC = {"dense.b1s4096": (1, ("loss_gap", "grad_gap",
                                      "update_gap")),
                "regtopk.b1s4096.dp4": (4, ("loss_gap", "grad_gap",
                                            "update_gap", "dense_grad_gap",
                                            "ranks_differing"))}


def tiny_cell(name: str = CELL, traffic_name: str = "") -> spec.Cell:
    """The cell ``name`` (with ``traffic_name``, the traffic of that file
    in its place) at a tiny width and in float32 (the CPU has no bf16
    matmuls to hold)."""
    cell = spec.load(name)
    if traffic_name:
        job = json.loads((ROOT / "bench" / "traffic" /
                          f"{traffic_name}.json").read_text())
        cell.job = job
        cell.chips, keep = TINY_TRAFFIC[traffic_name]
        cell.limits = {k: dict(cell.limits, ranks_differing=0)[k]
                       for k in keep}
        cell.parts = spec.parts(cell.config, job)
    cell.config = dict(cell.config, hidden_size=64, intermediate_size=96,
                       num_attention_heads=4, num_key_value_heads=4,
                       num_hidden_layers=2, vocab_size=256,
                       torch_dtype="float32")
    cell.job = dict(cell.job, seq=64,
                    sparsifier=dict(cell.job["sparsifier"], sparsity=0.01)
                    if "sparsity" in cell.job["sparsifier"]
                    else cell.job["sparsifier"])
    return cell


def drive(cell, seed: int, trace: bool = False, **kw) -> dict:
    """A run without the look for a card: rank 0's result object."""
    rec = cell_mod.run_rank(cell, seed, 0.3, trace, dev=torch.device("cpu"),
                            started=0.0, **kw)
    if rec is None:
        return None
    real = torch.cuda.get_device_name
    torch.cuda.get_device_name = lambda i=0: "cpu"
    try:
        return bench_run.result(cell, rec, trace, [])
    finally:
        torch.cuda.get_device_name = real


def test_result_line_has_the_contracts_keys():
    torch.set_num_threads(2)
    cell = tiny_cell()
    plain = drive(cell, 2 ** 32 + 5)
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "fallback_reasons", "checks"]
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(plain["checks"]) == list(cell.limits)
    traced = drive(cell, 2 ** 32 + 5, trace=True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "fallback_reasons",
                            "checks"]
    assert set(traced["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes", "busy_s",
                                     "window_s"}
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    json.dumps(traced)


def _unchanged(real):
    def step(self, state, batch):
        from repro_torch.train.step import TrainState
        keep = (state.params, state.opt,
                {k: v.clone() for k, v in state.ef.items()})
        _, metrics = real(self, state, batch)
        return TrainState(*keep), metrics
    return step


def _half_batch(real):
    def step(self, state, batch):
        # the loss's mean over the first half of the batch's tokens alone
        from bench.reference.follow import first_half
        return real(self, state, dict(batch,
                                      targets=first_half(batch["targets"])))
    return step


def _other_draw(real):
    def feed(self, t):
        data = real(self, t)
        return dict(data, tokens=(data["tokens"] + 1) % self.run.model
                    .vocab_size)
    return feed


@pytest.mark.parametrize("fault", ["", "unchanged", "half_batch"])
@pytest.mark.parametrize("traffic_name", ["", "dense.b1s4096"])
def test_a_broken_step_is_not_correct(traffic_name, fault, monkeypatch):
    from repro_torch.train.step import TrainStep
    torch.set_num_threads(2)
    if fault:
        wrap = {"unchanged": _unchanged, "half_batch": _half_batch}[fault]
        monkeypatch.setattr(TrainStep, "__call__",
                            wrap(TrainStep.__call__))
    line = drive(tiny_cell(traffic_name=traffic_name), 77)
    assert line["correct"] is (not fault), line["checks"]


def test_a_batch_drawn_otherwise_is_not_correct(monkeypatch):
    """The window's batches come from the program's draw and the
    reference's from the benchmark's copy: a drift shows."""
    torch.set_num_threads(2)
    monkeypatch.setattr(cell_mod.Rank, "feed",
                        _other_draw(cell_mod.Rank.feed))
    line = drive(tiny_cell(), 78)
    assert line["correct"] is False, line["checks"]


def _rank(rank, world, init, fault, queue):
    torch.set_num_threads(1)
    if fault == "no_exchange":
        from repro_torch.core import aggregate

        def local(values, indices, j, group=None, **kw):
            # this rank's own payload, never sent nor received
            dense = torch.zeros(j, dtype=values.dtype)
            return dense.index_add_(0, indices.long() & 0xFFFFFFFF, values)
        aggregate.sparse_allgather_combine = local
    cell = tiny_cell(traffic_name="regtopk.b1s4096.dp4")
    line = drive(cell, 91, rank=rank, world=world, init=init)
    if rank == 0:
        queue.put(line)


@pytest.mark.parametrize("fault", ["", "no_exchange"])
def test_four_ranks_without_the_exchange_are_not_correct(fault, tmp_path):
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_rank, args=(r, 4, init, fault, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    line = queue.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert line["correct"] is (not fault), line["checks"]
    # ZeRO-1's all-gather of the master leaves the ranks equal even so:
    # the gaps catch this fault
    assert line["checks"]["ranks_differing"]["value"] == 0


def test_the_control_is_not_correct():
    """The reference in float8 in the program's place fails the cell's
    limits."""
    torch.set_num_threads(2)
    for traffic_name in ("", "dense.b1s4096"):
        cell = tiny_cell(traffic_name=traffic_name)
        ref = cell_mod.reference_readings(cell, 13, 1, torch.device("cpu"))
        ctl = cell_mod.reference_readings(cell, 13, 1, torch.device("cpu"),
                                          mode="fp8")
        ok, table = checks.judge(checks.gaps(ctl, ref)[0], cell.limits)
        assert not ok, table


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "stablelm3b.regtopk",
         "--seed", str(2 ** 31 + 11), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
