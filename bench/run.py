"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. It prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted`` (the
window's steps), ``failed`` (steps whose loss was not finite), ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``,
``fallback_reasons`` (the window's steps whose compressor took its
dense fallback, by reason), and last ``checks``: each number compared with the reference beside its limit,
which also end its standard error. It exits non-zero, printing no
result, without a CUDA card or with fewer cards than the cell asks
for, when the plain reference imports anything but torch, or when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded in
a process of the run once its window has closed.

A cell on more than one card starts one process a card (this script
with ``--rank``), joined over NCCL at a free localhost port; rank 0
reports to this process, which prints the result.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")
RANK_DEADLINE_S = 1100


def _paths() -> None:
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def banned_modules() -> list:
    """Loaded modules whose top-level name is a banned one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def reference_imports() -> list:
    """The top-level names the plain reference (``bench/reference``)
    imports that are neither torch nor its own: the reference may take
    nothing of the program, of JAX or of the JAX package."""
    import ast
    found = set()
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                found.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                found.add(node.module)
    return sorted(name for name in found if name.split(".")[0] not in
                  ("torch", "math", "__future__")
                  and not name.startswith("bench.reference"))


def cache_env() -> dict:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "bench-cache"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "CUDA_CACHE_PATH": str(cache / "cuda")}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # one rank of a cell on several cards (started by this script)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default="", help=argparse.SUPPRESS)
    ap.add_argument("--started", type=float, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return 2


def _metric_values(cell, rec: dict, trace: bool) -> dict:
    from bench.cell import p90
    win = rec["window"]
    if trace:
        out = {}
        for metric in cell.per_layer:
            value = cell.readers[metric["name"]].read(rec["view"])
            if value is not None:
                out[metric["name"]] = {"value": value, "unit": metric["unit"]}
        return out
    job = cell.job
    tokens = (len(win["step_ms"]) * job["batch_per_rank"] * job["ranks"]
              * job["seq"])
    values = {"train_tokens_per_s": tokens / win["window_s"],
              "step_ms_p90": p90(rec["step_ms_max"]),
              "peak_mem_gib": rec["peak_bytes"] / 2 ** 30,
              "setup_s": rec["setup_s"]}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def result(cell, rec: dict, trace: bool, extra_banned: list) -> dict:
    """The result object of rank 0's record."""
    import torch
    from bench import checks
    ok, table = checks.judge(rec["values"], cell.limits)
    win = rec["window"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": bool(ok and win["bad"] == 0 and not extra_banned),
           "attempted": len(win["step_ms"]), "failed": win["bad"],
           "metrics": _metric_values(cell, rec, trace), "device": device}
    if trace:
        view = rec["view"]
        print(f"bench: traced {view.steps} steps, {len(view.ops)} device "
              f"operations; device spans of {sorted(view.device_spans)}",
              file=sys.stderr)
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["window_trace_s"]
        out["breakdown"] = {"device_ops": rec["view"].device_ops(),
                            "idle_gaps": rec["view"].idle_gaps()}
    out["fallback_reasons"] = win["fallback_reasons"]
    out["checks"] = table
    return out


def rank_main(args) -> int:
    """One rank of a cell on several cards: rank 0 writes its record's
    pieces the parent needs as one JSON line on standard output."""
    import torch
    from bench import cell as cell_mod
    from bench import spec
    cell = spec.load(args.workload, ROOT)
    rec = cell_mod.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                            rank=args.rank, world=cell.chips,
                            init=args.init, started=args.started,
                            dev=torch.device("cuda", args.rank))
    found = banned_modules()
    if found:
        print(f"bench: rank {args.rank} loaded {found}", file=sys.stderr)
    if rec is None:
        return 3 if found else 0
    line = result(cell, rec, bool(args.trace), found)
    print(json.dumps({"result": line, "banned": found}), flush=True)
    return 0


def run_ranks(argv: list, chips: int) -> str:
    """Start ``argv`` + ["--rank", r, "--init", <a free localhost port>]
    once a card, wait for all of them and stop them all when one fails
    or RANK_DEADLINE_S passes; rank 0's standard output. Raises
    RuntimeError unless every rank exits 0."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, *argv, "--rank", str(r),
         "--init", f"tcp://localhost:{port}"],
        stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
        text=True) for r in range(chips)]
    deadline = time.time() + RANK_DEADLINE_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    out = procs[0].stdout.read()
    procs[0].stdout.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")
    return out


def spawn_ranks(args, chips: int, started: float) -> dict:
    """One process a card running :func:`rank_main`; rank 0's record."""
    out = run_ranks([str(Path(__file__).resolve()),
                     "--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace",
                     str(args.trace), "--started", repr(started)], chips)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if not lines:
        raise RuntimeError("rank 0 printed no record")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    os.environ.update(cache_env())
    _paths()
    if args.rank is not None:
        return rank_main(args)
    from bench import spec
    try:
        cell = spec.load(args.workload, ROOT)
    except (OSError, ValueError, KeyError) as err:
        return _fail(f"cell {args.workload!r}: {err}")
    if reference_imports():
        return _fail(f"the reference imports {reference_imports()}")
    import torch
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"cell {cell.name} asks for {cell.chips} cards, "
                     f"{torch.cuda.device_count()} present")
    if cell.chips > 1:
        try:
            got = spawn_ranks(args, cell.chips, started)
        except RuntimeError as err:
            return _fail(str(err))
        line, banned = got["result"], got["banned"]
    else:
        from bench import cell as cell_mod
        rec = cell_mod.run_rank(cell, args.seed, args.seconds,
                                bool(args.trace), started=started,
                                dev=torch.device("cuda", 0))
        line = result(cell, rec, bool(args.trace), [])
        banned = []
    banned = sorted(set(banned) | set(banned_modules()))
    if banned:
        return _fail(f"modules of JAX or of the JAX package loaded: "
                     f"{banned}")
    for name, row in line["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
