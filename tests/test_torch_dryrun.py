"""The port's dry run (``python -m repro_torch.launch.dryrun``: rank 0's
step traced on the meta device under a fake process group) against the
reference's (``python -m repro.launch.dryrun``: the jitted step lowered
and compiled on abstract arrays), each in a subprocess as
tests/test_system.py runs the reference's, on ``--mesh 2x2`` at
StableLM-3B cut through ``--set`` to 2 layers of d_model 128 (4 heads of
32, d_ff 256, vocabulary 512, fp32):

- train, prefill and decode (REGTOP-k fused with sparse comm and
  ``--num-buckets 0``), and a sketch-coordinated train step under a
  fault schedule with a delta channel: the analytic keys equal the
  reference record's (params, active_params, num_buckets_requested, the
  sparse-gather wire, the sketch, fault and delta fields);
- ``hlo_flops`` equal to a count made by hand from the shapes
  (:func:`hand_flops`);
- the flops in order: model_flops / chips <= the port's <= the
  reference's. Measured here: train 7.23e11 <= 4.05e12 <= 5.22e12,
  prefill 2.41e11 <= 4.84e12 <= 9.00e12, decode 2.94e7 <= 1.099e9 <=
  1.103e9. 6ND counts no attention score (S^2) and no recompute; the
  port recomputes each layer's forward in the backward pass (remat,
  ``torch.utils.checkpoint``, which stops at the layer's last saved
  input: the down projection runs twice, not three times) and skips
  the key blocks wholly above the causal diagonal, which the
  reference's chunked scan computes and masks (prefill: 272 of 512
  blocks of 1024 x 2048 at 32768 positions); decode attends over every
  slot in both.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
SET = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
           d_ff=256, vocab_size=512, dtype="float32")
MAIN = ["--sparsifier", "regtopk", "--comm", "sparse", "--pipeline",
        "fused", "--num-buckets", "0"]
SKETCH = ["--sparsifier", "sketchtopk", "--comm", "sparse", "--pipeline",
          "fused", "--fault-schedule", "iid:0.3,seed=0", "--err-decay", "0.9",
          "--delta-k", "4096", "--delta-fault-schedule", "loss:0.05",
          "--variant", "sketch"]
ANALYTIC = ("arch", "shape", "variant", "mesh", "kind", "attn_override",
            "num_buckets_requested", "allocation", "params", "active_params",
            "sparse_gather_wire_bytes", "sketch_rows",
            "sketch_width_effective", "sketch_allreduce_bytes", "fault",
            "delta", "wire_dtype", "overlap", "unknown_trip_loops")


def _cmd(module: str, out: str, shapes: str, flags) -> list:
    sets = [x for k, v in SET.items() for x in ("--set", f"{k}={v}")]
    return [sys.executable, "-m", module, "--arch", "stablelm-3b",
            "--shape", shapes, "--mesh", "2x2", "--out", out, *sets, *flags]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{(package, shape, variant): record} of both dry runs, the four
    processes side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    runs = {}
    for pkg, module in (("port", "repro_torch.launch.dryrun"),
                        ("ref", "repro.launch.dryrun")):
        for name, shapes, flags in (
                ("main", "train_4k,prefill_32k,decode_32k", MAIN),
                ("sketch", "train_4k", SKETCH)):
            out = str(tmp / f"{pkg}_{name}.json")
            runs[(pkg, name, out)] = subprocess.Popen(
                _cmd(module, out, shapes, flags), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        logs = {key: p.communicate(timeout=400)[0]
                for key, p in runs.items()}
    finally:
        for p in runs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = {}
    for (pkg, name, out), p in runs.items():
        assert p.returncode == 0, logs[(pkg, name, out)]
        assert "0 failed" in logs[(pkg, name, out)]
        with open(out) as fh:
            for rec in json.load(fh)["results"]:
                recs[(pkg, rec["shape"], rec["variant"])] = rec
    return recs


KEYS = [("train_4k", ""), ("prefill_32k", ""), ("decode_32k", ""),
        ("train_4k", "sketch")]


@pytest.mark.parametrize("shape,variant", KEYS)
def test_analytic_keys_match_the_reference(records, shape, variant):
    port, ref = records[("port", shape, variant)], \
        records[("ref", shape, variant)]
    assert set(ref) <= set(port)
    for key in ANALYTIC:
        assert port.get(key) == ref.get(key), key
    if variant:
        assert port["fault"]["sparse_gather_wire_bytes_active"] > 0
        assert port["delta"]["k"] == 4096 and "fault" in port["delta"]
        assert port["sketch_allreduce_bytes"] > 0
    assert port["memory"] == dict.fromkeys(ref["memory"], -1)
    assert port["hlo_flops"] == port["flops"] > 0
    assert port["hlo_bytes"] == port["bytes_accessed"] > 0
    assert port["hlo_collective_wire_bytes"] == \
        port["collective_bytes"]["total"] == \
        sum(port["hlo_collectives"].values()) > 0


@pytest.mark.parametrize("shape,variant", KEYS)
def test_the_record_names_its_stages(records, shape, variant):
    """Every stage that runs is in the record, traced or counted from a
    contract: a train step's sync by its kernels' byte contracts (B1 and
    B2 once a resolved bucket on the fused local path, B3 once on the
    sketch's) and its wire."""
    rec = records[("port", shape, variant)]
    stages = rec["stages"]
    if rec["kind"] != "train":
        assert stages == {"traced": [f"serve/{rec['kind']}"],
                          "contract": []}
        return
    assert stages["contract"] == ["train/sync"]
    assert "train/loss_grad" in stages["traced"]
    sync = rec["sync_contract"]
    assert sync["bytes"] > 0 and all(b > 0 for _, b in sync["stages"])
    want = {"sweep1_sketch_gated": 1} if variant else \
        {"sweep1": rec["num_buckets"], "sweep2": rec["num_buckets"]}
    assert sync["kernels"] == want
    assert sync["wire"]["all-gather"] == \
        rec["sparse_gather_wire_bytes"] / 2       # ring (g - 1) / g at 2
    # ZeRO-1's parameter all-gather is traced
    assert rec["traced_collective_calls"]["all-gather"] > 0


def hand_flops(kind: str) -> float:
    """Matmul flops of rank 0's step from the shapes: tp = 2 (2 query and
    2 key/value heads of 32, d_ff 128, vocabulary 256 a rank), dp = 2.
    Attention counts the blocks the port computes: queries in chunks of
    1024, keys in blocks of 2048, causal blocks wholly above the
    diagonal skipped; decode every slot of the cache."""
    d, hl, kvl, hd, ffl, vl, layers = 128, 2, 2, 32, 128, 256, 2

    def layer(tokens, attn):
        return (2 * tokens * d * (hl + 2 * kvl) * hd + attn
                + 2 * tokens * hl * hd * d + 3 * 2 * tokens * d * ffl)

    def causal_blocks(s):
        return sum(-(-min(s, q0 + 1024) // 2048)
                   for q0 in range(0, s, 1024))
    if kind == "decode":
        b, slots = 128 // 2, 32768
        return layers * layer(b, 4 * b * hl * slots * hd) + 2 * b * d * vl
    b, s = (256 // 2, 4096) if kind == "train" else (32 // 2, 32768)
    t = b * s
    attn = causal_blocks(s) * 4 * b * hl * 1024 * 2048 * hd
    if kind == "prefill":        # the head over the last position only
        return layers * layer(t, attn) + 2 * b * d * vl
    # forward, the remat recompute up to the down projection, backward
    # (twice the forward); the head's forward and backward
    down = 2 * t * ffl * d
    return layers * (4 * layer(t, attn) - down) + 3 * 2 * t * d * vl


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_flops_by_hand_and_in_order(records, shape):
    from repro_torch.roofline.analysis import roofline_terms
    port, ref = records[("port", shape, "")], records[("ref", shape, "")]
    assert port["hlo_flops"] == hand_flops(port["kind"])
    if shape == "prefill_32k":
        assert sum(-(-min(32768, q0 + 1024) // 2048)
                   for q0 in range(0, 32768, 1024)) == 272
    terms = roofline_terms(port)
    assert terms["model_flops"] / 4 <= port["hlo_flops"] <= ref["hlo_flops"]
    assert terms["step_time_lb_s"] > 0 and terms["chips"] == 4
