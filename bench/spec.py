"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its file ``bench/workloads/<name>.json`` (the limits of its check), its
configuration ``bench/configs/<config>.json``, its traffic
``bench/traffic/<traffic>.json``, the modules of its configuration's
``family`` (``bench/families/<family>.py`` and the reference's
``bench/reference/models/<family>.py``), of its sparsifier's kind
(``bench/sparsifiers/<kind>.py`` and ``bench/reference/sparsifiers/
<kind>.py``) and of its optimizer's (``bench/reference/optimizers/
<kind>.py``), and the reader of each per-layer metric it reports,
``bench/metrics/<metric>.py``. A cell, a configuration, a traffic mix,
a family, a kind or a metric is added by adding files and entries:
nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from bench import traffic

ROOT = Path(__file__).resolve().parents[1]
CHECKS = ("loss_gap", "grad_gap", "update_gap", "dense_grad_gap",
          "ranks_differing")
IDENT = re.compile(r"^[a-z_][a-z0-9_]*$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration's file
    job: dict                    # the traffic's file
    limits: dict                 # number compared -> its limit
    end_to_end: list             # BENCHMARK.json entries the cell reports
    per_layer: list
    readers: dict = field(default_factory=dict)   # metric -> module
    parts: dict = field(default_factory=dict)     # part -> module (PARTS)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(root: Path, rel: str):
    """The module of the file ``root / rel``. Raises FileNotFoundError."""
    path = root / rel
    if not path.is_file():
        raise FileNotFoundError(f"no module {path}")
    name = "bench_" + re.sub(r"[^A-Za-z0-9_]", "_", rel[:-3])
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, name: str):
    """The module ``bench/metrics/<name>.py``: ``UNIT``, ``MOVES`` and
    ``read(view)``, which returns the metric's value or None."""
    return load_module(root, f"bench/metrics/{name}.py")


# part of a cell -> (folder, where its name is read: file and key)
PARTS = {"family": ("bench/families", "config", "family"),
         "model": ("bench/reference/models", "config", "family"),
         "sparsifier": ("bench/sparsifiers", "sparsifier", "kind"),
         "ref_sparsifier": ("bench/reference/sparsifiers", "sparsifier",
                            "kind"),
         "optimizer": ("bench/reference/optimizers", "optimizer", "kind")}


def parts(config: dict, job: dict, root: Path = ROOT) -> dict:
    """{part: module} of a configuration and a traffic, each found by
    the name its file gives. Raises ValueError or FileNotFoundError."""
    out = {}
    for part, (folder, where, key) in PARTS.items():
        src = config if where == "config" else job[where]
        name = src.get(key)
        if not isinstance(name, str) or not IDENT.match(name):
            raise ValueError(f"{where} {key} {name!r} is no module name")
        out[part] = load_module(root, f"{folder}/{name}.py")
    missing = [k for k in out["family"].KEYS if k not in config]
    if missing:
        raise ValueError(f"configuration {config.get('name')}: missing "
                         f"{missing}")
    for where, part in (("sparsifier", "ref_sparsifier"),
                        ("optimizer", "optimizer")):
        traffic.check_honoured(job[where], out[part].HONOURS, where)
    return out


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with everything it reads, checked against
    ``BENCHMARK.json``. Raises ValueError or FileNotFoundError."""
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise ValueError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    own = _json(root / "bench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if own.get(key) != entry[key]:
            raise ValueError(f"cell {name}: {key} is {own.get(key)!r} in its "
                             f"file and {entry[key]!r} in BENCHMARK.json")
    limits = own.get("limits", {})
    if not limits or not set(limits) <= set(CHECKS) or (
            entry["chips"] > 1 and "ranks_differing" not in limits):
        raise ValueError(f"cell {name}: limits {sorted(limits)} (of "
                         f"{CHECKS}; ranks_differing on more than one "
                         "card)")
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    job = _json(root / "bench" / "traffic" / f"{entry['traffic']}.json")
    traffic.check(job, entry["traffic"])
    if job["ranks"] != entry["chips"]:
        raise ValueError(f"cell {name}: traffic {entry['traffic']} runs "
                         f"{job['ranks']} ranks on {entry['chips']} chips")
    cell = Cell(name, entry["chips"], config, job, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                parts=parts(config, job, root))
    for metric in cell.per_layer:
        mod = load_reader(root, metric["name"])
        if (mod.UNIT, mod.MOVES) != (metric["unit"], metric["moves"]):
            raise ValueError(f"metric {metric['name']}: its reader says "
                             f"{mod.UNIT!r} moving {mod.MOVES!r}")
        cell.readers[metric["name"]] = mod
    return cell
