"""The readings that a cell's limits are set from: the program against
the reference, and the control and the faults against it, seed after
seed in one process a card. Not run by the benchmark's own runs.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--program] [--variants fp8,half_batch,no_exchange] [--skew 20]

``--program`` reads the program's first steps on the cell's cards (one
process a card, as ``bench/run.py`` starts them) against the reference
on rank 0. ``--variants`` reads each named stand-in against the
reference on one card: "fp8" is the control (the reference's linear
layers in float8), "half_batch" and "no_exchange" the faults
(``bench.reference.follow``). ``--skew N`` counts, on one card, the
steps of N whose compressor took its dense fallback, by reason, on the
window's uniform tokens and on a Zipf draw (the i-th most frequent of a
seeded permutation of the vocabulary drawn with weight i^-1.1, as words
in text are), to show whether the fallback depends on the token draw.
One JSON line a seed and reading, on standard output: {"seed", "kind",
"values", "where", "seconds"}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--skew", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default="", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def emit(seed: int, kind: str, values: dict, where: dict, t0: float):
    print(json.dumps({"seed": seed, "kind": kind, "values": values,
                      "where": where,
                      "seconds": time.perf_counter() - t0}), flush=True)


def program_rank(cell, seeds: list, rank: int, world: int, init: str):
    import torch
    import torch.distributed as dist

    from bench import cell as cm
    from bench import checks
    dev, group = cm.join(rank, world, init)
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats(dev)
            r = cm.Rank(cell, seed, dev, group, rank, world)
            prog = r.read_first_steps()
            prog["peak_bytes"] = r.program_peak()
            if world > 1:
                prog["ranks_differing"] = r.ranks_differing()
            r.free()
            del r
            if rank == 0:
                ref = cm.reference_readings(cell, seed, world, dev)
                values, where = checks.gaps(prog, ref)
                where["loss"] = prog["loss"]
                where["ref_loss"] = ref["loss"]
                where["peak_bytes"] = prog["peak_bytes"]
                emit(seed, "program", values, where, t0)
            if world > 1:
                dist.barrier(group=group)
    finally:
        if world > 1:
            dist.destroy_process_group()


def variants(cell, seeds: list, kinds: list) -> None:
    import torch

    from bench import cell as cm
    from bench import checks
    dev = torch.device("cuda", 0)
    for seed in seeds:
        ref = cm.reference_readings(cell, seed, cell.chips, dev)
        for kind in kinds:
            t0 = time.perf_counter()
            mode = "fp8" if kind == "fp8" else "fp32"
            fault = "" if kind == "fp8" else kind
            other = cm.reference_readings(cell, seed, cell.chips, dev, mode,
                                          fault)
            values, where = checks.gaps(other, ref)
            emit(seed, kind, values, where, t0)


def zipf_feed(r, exponent: float = 1.1):
    """A feed for the Rank ``r`` (one rank) that draws its tokens from a
    Zipf law over a seeded permutation of the vocabulary."""
    import torch
    vocab = r.cell.config["vocab_size"]
    gen = torch.Generator(device=r.dev).manual_seed(r.dseed)
    perm = torch.randperm(vocab, generator=gen, device=r.dev)
    weight = torch.arange(1, vocab + 1, device=r.dev,
                          dtype=torch.float64) ** -exponent

    def feed(t: int) -> dict:
        g = torch.Generator(device=r.dev).manual_seed(
            (int(r.dseed) << 32) + int(t))
        draw = torch.multinomial(weight, r.rows * r.seq, replacement=True,
                                 generator=g)
        tokens = perm[draw].view(r.rows, r.seq)
        targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1],
                                                            -1)], 1)
        return {"tokens": tokens, "targets": targets}
    return feed


def skew(cell, seeds: list, steps: int) -> None:
    from collections import Counter

    import torch

    from bench import cell as cm
    dev = torch.device("cuda", 0)
    for seed in seeds:
        for draw in ("uniform", "zipf"):
            t0 = time.perf_counter()
            r = cm.Rank(cell, seed, dev, None, 0, 1)
            if draw == "zipf":
                r.feed = zipf_feed(r)
            per_step = []
            for t in range(steps):
                before = Counter(r.step.gsync.fallback_reasons)
                r.take(t)
                per_step.append(dict(Counter(r.step.gsync.fallback_reasons)
                                     - before))
            total = Counter()
            for grew in per_step:
                total.update(grew)
            emit(seed, f"skew_{draw}",
                 {"fallback_steps": sum(bool(g) for g in per_step),
                  "steps": steps}, {"reasons": dict(total)}, t0)
            r.free()
            del r


def main(argv=None) -> int:
    args = parse(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import spec
    cell = spec.load(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.rank is not None:
        program_rank(cell, seeds, args.rank, cell.chips, args.init)
        return 0
    if args.program:
        if cell.chips == 1:
            program_rank(cell, seeds, 0, 1, "")
        else:
            from bench.run import run_ranks
            try:
                sys.stdout.write(run_ranks(
                    [str(Path(__file__).resolve()), "--workload",
                     args.workload, "--seeds", args.seeds], cell.chips))
            except RuntimeError as err:
                print(f"calibrate: {err}", file=sys.stderr)
                return 1
    if args.variants:
        variants(cell, seeds, args.variants.split(","))
    if args.skew:
        skew(cell, seeds, args.skew)
    return 0


if __name__ == "__main__":
    sys.exit(main())
