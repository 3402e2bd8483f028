"""The benchmark's plain reference against the port's CPU path at a tiny
size: the dense decoder family's layouts (its loss and gradient, with
an untied or a tied head, with or without query, key and value biases),
REGTOP-k's selection, error feedback and posterior over steps and
workers, dense SGD's mean, and Adam."""
import sys

import pytest
import torch

from bench import weights
from bench.families import dense as family
from bench.reference.models import dense as ref_model
from bench.reference.optimizers import adam as ref_adam
from bench.reference.sparsifiers import none as ref_none
from bench.reference.sparsifiers import regtopk as ref_sp
from bench.tests.conftest import ROOT

TINY = {
    "stablelm": dict(norm="layernorm", layer_norm_eps=1e-5,
                     partial_rotary_factor=0.25, num_key_value_heads=4),
    "llama": dict(norm="rmsnorm", rms_norm_eps=1e-5,
                  partial_rotary_factor=1.0, num_key_value_heads=2),
    "llama_tied_bias": dict(norm="rmsnorm", rms_norm_eps=1e-5,
                            partial_rotary_factor=1.0, num_key_value_heads=2,
                            tie_word_embeddings=True, use_qkv_bias=True),
}


def tiny_config(layout: str) -> dict:
    cfg = dict(name=f"tiny-{layout}", source="test", family="dense",
               hidden_size=64, intermediate_size=96, num_attention_heads=4,
               num_hidden_layers=2, vocab_size=256, rope_theta=10000.0,
               hidden_act="silu", use_qkv_bias=False,
               tie_word_embeddings=False, torch_dtype="float32")
    cfg.update(TINY[layout])
    return cfg


def test_reference_imports_nothing_of_the_program():
    """The run's own check of the reference's imports finds nothing."""
    sys.path.insert(0, str(ROOT / "bench"))
    import run
    assert run.reference_imports() == []


@pytest.mark.parametrize("layout", sorted(TINY))
def test_decoder_loss_and_gradient(layout):
    from repro_torch.core.flatten import tree_from_items, tree_items
    from repro_torch.models import loss_and_aux
    torch.manual_seed(0)
    cfg = tiny_config(layout)
    w = weights.make_weights(family.leaf_specs(cfg), 7, "cpu")
    if cfg["use_qkv_bias"]:
        # drawn at zero: give the biases values so that they count
        for name in ("bq", "bk", "bv"):
            w["blocks"]["l0"]["attn"][name].normal_()
    tokens = torch.randint(0, cfg["vocab_size"], (3, 16))
    targets = torch.cat([tokens[:, 1:], torch.full((3, 1), -1)], 1)
    paths = [p for p, _ in tree_items(w)]
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in
              tree_items(w)]
    tree = tree_from_items(zip(paths, leaves))
    loss, _ = loss_and_aux(tree, {"tokens": tokens, "targets": targets},
                           family.port_config(cfg))
    grads = torch.autograd.grad(loss, leaves)
    rleaves = [leaf.detach().clone().requires_grad_(True) for leaf in
               leaves]
    rtree = tree_from_items(zip(paths, rleaves))
    s, count = ref_model.nll_sum(rtree, tokens, targets, cfg)
    rloss = s / count
    rgrads = torch.autograd.grad(rloss, rleaves)
    assert float(rloss.detach()) == pytest.approx(float(loss.detach()),
                                                  rel=1e-5)
    for g, rg in zip(grads, rgrads):
        torch.testing.assert_close(rg, g, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("workers", [1, 3])
def test_regtopk_steps(workers):
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    j, sparsity = 20_000, 0.002
    cfg = SparsifierConfig(kind="regtopk", sparsity=sparsity, mu=0.5,
                           pipeline="fused", comm_mode="sparse")
    k = sparsify.resolve_k(cfg, j)
    assert k == ref_sp.resolve_k(sparsity, j)
    gen = torch.Generator().manual_seed(3)
    states = [sparsify.init_state(cfg, j, "cpu") for _ in range(workers)]
    sp = {"kind": "regtopk", "sparsity": sparsity, "mu": 0.5, "Q": 0.0}
    refs = [ref_sp.Worker(j, sp, 1.0 / workers, "cpu")
            for _ in range(workers)]
    for step in range(4):
        outs, payloads = [], []
        for n in range(workers):
            g = torch.randn(j, generator=gen) * (1 + torch.rand(j,
                                                                generator=gen))
            out = sparsify.compress(cfg, states[n], g, omega=1.0 / workers)
            idx, values = refs[n].compress(g.clone())
            got = out.indices.long() & 0xFFFFFFFF
            assert sorted(got.tolist()) == sorted(idx.tolist()), (step, n)
            order = torch.argsort(idx)
            torch.testing.assert_close(
                values[order], out.values[torch.argsort(got)], rtol=0,
                atol=0)
            outs.append(out)
            payloads.append((idx, values))
        agg = ref_sp.combine(payloads, j, "cpu")
        dense = torch.zeros(j)
        for out in outs:
            dense.index_add_(0, out.indices.long() & 0xFFFFFFFF, out.values)
        dense.mul_(1.0 / workers)
        torch.testing.assert_close(agg, dense, rtol=1e-6, atol=1e-7)
        for n in range(workers):
            states[n] = sparsify.observe_aggregate(cfg, outs[n].state, dense)
            refs[n].observe(agg)
            torch.testing.assert_close(refs[n].err, states[n]["err_prev"],
                                       rtol=0, atol=0)


def test_adam_steps():
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim import apply_updates, init_opt_state
    gen = torch.Generator().manual_seed(5)
    p = torch.randn(1000, generator=gen)
    opt = OptimizerConfig(kind="adam", lr=1e-3)
    state = init_opt_state(opt, p.clone())
    ref = ref_adam.Optimizer(p.clone(), {"kind": "adam", "lr": 1e-3,
                                          "b1": opt.b1, "b2": opt.b2,
                                          "eps": opt.eps})
    for _ in range(3):
        g = torch.randn(1000, generator=gen) * (torch.rand(1000,
                                                           generator=gen)
                                                > 0.5)
        master, state = apply_updates(opt, state, g)
        ref.step(g)
        # a step moves a parameter by about lr: 1e-4 of a step apart
        torch.testing.assert_close(ref.p, master, rtol=1e-6, atol=1e-7)


def test_dense_sgd_is_the_mean():
    gen = torch.Generator().manual_seed(8)
    grads = [torch.randn(500, generator=gen) for _ in range(3)]
    workers = [ref_none.Worker(500, {"kind": "none"}, 1 / 3, "cpu")
               for _ in grads]
    agg = ref_none.combine([w.compress(g) for w, g in zip(workers, grads)],
                           500, "cpu")
    torch.testing.assert_close(agg, sum(grads) / 3)


def test_the_family_draws_the_programs_tree():
    """The family's tree has the program's leaves and shapes, tied or
    not, with or without biases."""
    from repro_torch.core.flatten import tree_items
    from repro_torch.models import init_params
    for layout in TINY:
        cfg = tiny_config(layout)
        ours = [(p, s) for p, s, _ in family.leaf_specs(cfg)]
        theirs = [(p, tuple(leaf.shape)) for p, leaf in tree_items(
            init_params(family.port_config(cfg), torch.Generator(), "cpu"))]
        assert ours == theirs, layout
