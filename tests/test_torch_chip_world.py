"""chip_smoke.py's multi-card check, ``world_rank``, over gloo on the CPU
at a small J: one process a rank, as ``--world`` starts them on the
cards over NCCL. Each rank syncs SYNC_STEPS steps of every WORLD_CASES
config through GradientSync; rank 0 asserts that g_agg is bitwise the
same on every rank and, with every rank's final state, equal to an
in-process ``round()`` of the same workers, and prints one ``world``
line a case. Then the multi-rank phases at the reduced configs: the
launcher's train() over the group (the main path, dense SGD, and the
main path replayed in one process), serve() of a data-parallel batch
and context-parallel decode, and at world 4 the tensor-parallel phases
(train() on (1, 4) and (2, 2) grids of reduced StableLM-3B, on a (1, 4)
grid of reduced Granite-MoE-3B-A800M and of reduced DeepSeek-V2-Lite
(MLA), on a (2, 2) grid of reduced xLSTM-125M, on (1, 4) grids of
reduced Whisper-small and Phi-3-vision-4.2B with their frames and
patches, and of reduced StableLM-3B with ring attention, each flagged
cell's step 0 against one rank; serve() of reduced Qwen1.5-32B,
DeepSeek-V2-Lite in both MLA forms, Jamba-v0.1-52B, Whisper-small and
Phi-3-vision over a model group of 4, one line a cell; one reduced Mamba
layer split by channel against one rank's; one ring attention layer of
reduced StableLM and of reduced DeepSeek (MLA) against one rank's; the
launcher's train() with a checkpoint and published deltas over the
group, restored bitwise on every rank, a replica from the snapshot and
the deltas equal to the joined parameters), each printing from rank 0.
This runs the check's own logic without cards."""
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
        assert '"phase": "world' not in log
    every = [json.loads(ln) for ln in logs[0].splitlines()
             if ln.startswith('{"phase": "world_')]
    phases = {line["phase"]: line for line in every}
    assert list(phases) == list(chip_smoke.WORLD_TRAIN) + [
        "world_serve", "world_decode_cp"] + ([] if world < 4 else list(
            chip_smoke.WORLD_TP) + list(chip_smoke.TP_PHASES))
    for name in chip_smoke.WORLD_TRAIN:
        line = phases[name]
        assert line["world"] == world and line["params_bitwise_across_ranks"]
        assert line["rows_a_rank"] * world == line["global_batch"]
        assert line["losses"][-1] < line["losses"][0]
    assert phases["world_train_small"]["equals_replay"] is True
    serve = phases["world_serve"]
    assert serve["rows_a_rank"] * world == chip_smoke.SERVE_BATCH
    assert max(serve["prefill_rel_err"], serve["decode_rel_err"]) < \
        chip_smoke.SERVE_RTOL
    cps = [line for line in every if line["phase"] == "world_decode_cp"]
    assert [(line["arch"].removesuffix("-smoke"), line["mla_absorb"])
            for line in cps] == [
        (arch, absorb) for arch, _, _, _, forms in chip_smoke.WORLD_CP_CELLS
        for absorb in forms]
    for cp in cps:
        assert cp["slots_a_rank"] * world == cp["cache_slots"]
        assert cp["max_rel_err"] < chip_smoke.SERVE_RTOL
        assert cp["recurrent_bitwise_across_ranks"]
        assert (cp["recurrent_elements"] > 0) == (cp["family"] in (
            "ssm", "hybrid"))
    if world < 4:
        return
    for name, cell in chip_smoke.WORLD_TP.items():
        line = phases[name]
        assert (line["data"], line["tp"], line["global_batch"]) == (
            *cell.mesh, cell.batch)
        assert line["attn_dist"] == cell.attn_dist
        assert line["params_bitwise_across_data"]
        assert line["losses"][-1] < line["losses"][0]
        assert len(set(line["j_local_by_rank"])) == 1
        assert (line["step0"] is not None) == cell.step0
        if cell.step0:
            res = line["step0"]["float32"]
            assert res["loss_rel_err"] < chip_smoke.TP_LOSS_RTOL
            assert res["grad_rel_err"] < chip_smoke.TP_GRAD_RTOL
            assert res["replicated_grads_bitwise_across_model"]
    assert phases["world_train_ep"]["experts_a_card"] == 1
    assert phases["world_train_mla"]["step0"]["float32"]["moe_check"][
        "load_balance_loss"] == 0.0
    assert phases["world_train_ring"]["heads_a_card"] == [4, 4]
    assert phases["world_train_whisper"]["heads_a_card"] == [1, 1]
    assert phases["world_train_whisper"]["n_enc_layers"] == 2
    assert phases["world_train_phi3v"]["stub"] == "vision_stub"
    serve_tp = [line for line in every if line["phase"] == "world_serve_tp"]
    assert [(line["arch"].removesuffix("-smoke"), line["attn"])
            for line in serve_tp] == [
        (arch, attn) for arch, _, attn in chip_smoke.TP_SERVE_CELLS]
    for line in serve_tp:
        assert line["tp"] == world
        assert max(line["prefill_rel_err"], line["decode_rel_err"]) < \
            chip_smoke.SERVE_RTOL < line["row_gap"]
    mamba = phases["world_mamba_layer"]
    assert mamba["tp"] == world and mamba["grads_finite"]
    assert mamba["d_inner_a_card"] * world == mamba["d_inner"]
    assert mamba["one_card_rel_err"] < chip_smoke.TP_MAMBA_RTOL
    ring = [line for line in every if line["phase"] == "world_ring_layer"]
    assert [line["attn"] for line in ring] == ["full", "mla"]
    for line in ring:
        assert line["seq_a_card"] * world == line["seq"]
        assert max(line["out_rel_err"], line["grad_rel_err"]) < \
            chip_smoke.RING_LAYER_RTOL
    ckpt = phases["world_ckpt_tp"]
    assert ckpt["restored_bitwise_by_rank"] == [True] * world
    assert ckpt["replica_equals_joined"] and ckpt["final_snapshot_equal"]
    assert ckpt["deltas"] == chip_smoke.TRAIN_STEPS
    assert ckpt["save_and_join_s"] > 0
    apply = [line for line in every if line["phase"] == "world_apply_tp"]
    assert [(line["data"], line["tp"]) for line in apply] == list(
        chip_smoke.APPLY_MESHES)
    for line in apply:
        assert line["equals_joined"] and line["pinned_unchanged"]
        assert line["counters_equal_across_ranks"]
        assert line["counters"]["param_version"] == chip_smoke.TRAIN_STEPS
        assert line["counters"]["resyncs"] == 1
        assert line["pinned_version"] == 0
        assert len(line["intake_ms_by_rank"]) == world
        assert line["one_rank_apply_ms"] > 0
    assert apply[1]["trees_bitwise_across_ranks"] is True
