"""chip_smoke.py's multi-card check, ``world_rank``, over gloo on the CPU
at a small J: one process a rank, as ``--world`` starts them on the
cards over NCCL. Each rank syncs SYNC_STEPS steps of every WORLD_CASES
config through GradientSync; rank 0 asserts that g_agg is bitwise the
same on every rank and, with every rank's final state, equal to an
in-process ``round()`` of the same workers, and prints one ``world``
line a case. This runs the check's own logic without cards."""
import json
import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
J = 20_603          # not a multiple of any tile or vector width


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_world_check_passes_over_gloo(world):
    sys.path.insert(0, ROOT)
    import chip_smoke
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]), OMP_NUM_THREADS="1")
    code = ("import sys, chip_smoke; sys.exit(chip_smoke.world_rank("
            f"{{r}}, {world}, {port}, backend='gloo', j={J}))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(r=r)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    lines = [json.loads(line) for line in logs[0].splitlines()
             if line.startswith('{"phase": "world"')]
    assert [line["case"] for line in lines] == list(chip_smoke.WORLD_CASES)
    for line in lines:
        assert (line["backend"], line["world"], line["j"]) == ("gloo", world,
                                                               J)
        assert line["steps"] == chip_smoke.SYNC_STEPS
        assert line["bitwise_across_ranks"] and line["equals_round"]
    for log in logs[1:]:
        assert '"phase": "world"' not in log
