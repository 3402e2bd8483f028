"""The port's dense decoder against the reference's on the same weights:
the parameter layout and flat order (bitwise, for every dense layout),
the loss and the flat gradient (fp32 tolerance), and RoPE alone. The
other layouts' losses and gradients: ``test_torch_layouts.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.flatten import TreeFlattener as JaxFlattener  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models.parallel import Parallel  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.flatten import TreeFlattener, tree_items  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402

# fp32 on both sides, but XLA and torch sum matmuls and reductions in
# different orders: a few fp32 ulps of relative drift per element
RTOL, ATOL = 1e-5, 1e-6


def _configs():
    jcfg = jbase.reduced_config(jbase.get_config("stablelm-3b"))
    tcfg = tbase.reduced_config(tbase.get_config("stablelm-3b"))
    return jcfg, tcfg


def _setup(seed=0, batch=2, seq=16):
    jcfg, tcfg = _configs()
    jparams = jax_init_params(jcfg, Parallel(), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((batch, 1), np.int32)],
                             1)
    return jcfg, tcfg, jparams, tokens, targets


DENSE_ARCHS = ("stablelm-3b", "granite-8b", "qwen1.5-32b", "starcoder2-7b")
# every dense layout: the four configs, and a tied-embedding variant
# without RoPE (sinusoidal positions) of the GELU/QKV-bias layout
LAYOUTS = DENSE_ARCHS + ("tied-norope",)
CONFIG_FIELDS = ("name", "family", "source", "n_layers", "d_model",
                 "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                 "rope", "rotary_pct", "rope_theta", "norm", "act", "dtype",
                 "qkv_bias", "tie_embeddings", "attn_kind", "window",
                 "max_seq_len", "remat")


def layout_configs(layout: str):
    """(reference, port) reduced configs of one dense layout."""
    import dataclasses
    arch = "starcoder2-7b" if layout == "tied-norope" else layout
    out = [mod.reduced_config(mod.get_config(arch)) for mod in (jbase, tbase)]
    if layout == "tied-norope":
        out = [dataclasses.replace(c, tie_embeddings=True, rope=False)
               for c in out]
    return out


def test_reduced_config_matches_reference():
    import dataclasses
    for arch in DENSE_ARCHS:
        full_j, full_t = jbase.get_config(arch), tbase.get_config(arch)
        for jcfg, tcfg in ((full_j, full_t), layout_configs(arch)):
            for field in CONFIG_FIELDS:
                assert getattr(jcfg, field) == getattr(tcfg, field), \
                    (arch, field)
            assert jcfg.param_count() == tcfg.param_count(), arch
        for depth in (1, 3, 8):
            assert dataclasses.replace(full_t, n_layers=depth).param_count() \
                == dataclasses.replace(full_j, n_layers=depth).param_count()
    full_t = tbase.get_config("stablelm-3b")
    assert full_t.param_count() == 2_795_443_200
    assert dataclasses.replace(full_t, n_layers=8).param_count() == \
        892_032_000
    assert tbase.get_config("granite-8b").param_count() == 8_254_689_280
    assert tbase.get_config("starcoder2-7b").param_count() == 7_400_268_800


def test_init_layout_and_flat_order_match():
    """Every dense layout: the port's init has the reference's leaves in
    the reference's order and shapes (QKV biases, the GELU MLP's biases,
    a norm without a bias, no head when tied), the parameter count is
    the analytic one, and the flat vector is bitwise the reference's."""
    for layout in LAYOUTS:
        jcfg, tcfg = layout_configs(layout)
        jparams = jax_init_params(jcfg, Parallel(), jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.device_get(jparams))
        ours = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        jitems = [(tuple(k.key for k in path), leaf) for path, leaf in
                  jax.tree_util.tree_flatten_with_path(jparams)[0]]
        assert [p for p, _ in tree_items(ours)] == [p for p, _ in jitems], \
            layout
        assert [tuple(leaf.shape) for _, leaf in tree_items(ours)] == \
            [tuple(leaf.shape) for _, leaf in jitems], layout
        assert sum(leaf.numel() for _, leaf in tree_items(ours)) == \
            tcfg.param_count() == jcfg.param_count(), layout
        flat = TreeFlattener(tparams).flatten(tparams)
        jflat = JaxFlattener(jparams).flatten(jparams)
        assert np.array_equal(np.asarray(jflat).view(np.int32),
                              flat.numpy().view(np.int32)), layout
        back = params_to_jax(tparams)
        for (p, a), (_, b) in zip(tree_items(back),
                                  tree_items(jax.device_get(jparams))):
            assert np.array_equal(a, b), (layout, p)


def test_unflatten_views_round_trip():
    _, tcfg, jparams, _, _ = _setup()
    tparams = params_from_jax(jax.device_get(jparams))
    flat = TreeFlattener(tparams)
    vec = flat.flatten(tparams)
    tree = flat.unflatten(vec)
    for (p, a), (_, b) in zip(tree_items(tree), tree_items(tparams)):
        assert torch.equal(a, b), p
        assert a.untyped_storage().data_ptr() == \
            vec.untyped_storage().data_ptr()


def test_loss_and_gradient_match_reference():
    jcfg, tcfg, jparams, tokens, targets = _setup()
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, batch, jcfg, Parallel()), has_aux=True)(
            jparams)
    jflat = np.asarray(JaxFlattener(jparams).flatten(jgrads))
    tparams = params_from_jax(jax.device_get(jparams))
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_items(tparams)]
    tbatch = {"tokens": torch.from_numpy(tokens).long(),
              "targets": torch.from_numpy(targets).long()}
    loss = loss_fn(tparams, tbatch, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    tflat = TreeFlattener(tparams).flatten(list(grads)).numpy()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(tflat, jflat, rtol=RTOL, atol=ATOL)


def test_rope_matches_reference_to_one_ulp():
    """Interleaved partial RoPE at StableLM-3B's head shape (hd 80, 20
    rotary dims). The angles are bitwise equal; cos and sin come from
    XLA's and torch's own approximations and agree to 1 ulp. So each
    rotated element x1*cos - x2*sin agrees to 1 ulp of the table times
    (|x1| + |x2|), plus the rounding of the two products and the sum;
    the dims past the rotary ones pass through bitwise."""
    rng = np.random.default_rng(1)
    seq, rot, theta = 512, 20, 10_000.0
    x = rng.standard_normal((2, seq, 4, 80)).astype(np.float32)
    pos = np.arange(seq, dtype=np.int32)
    jangle = (jnp.asarray(pos)[:, None].astype(jnp.float32)
              * theta ** (-jnp.arange(0, rot, 2, dtype=jnp.float32) / rot))
    tangle = tattn.rope_angles(torch.from_numpy(pos), rot, theta)
    assert np.array_equal(np.asarray(jangle), tangle.numpy())
    for jf, tf in ((jnp.cos, torch.cos), (jnp.sin, torch.sin)):
        d = (np.asarray(jf(jangle)).view(np.int32).astype(np.int64)
             - tf(tangle).numpy().view(np.int32))
        assert np.abs(d).max() <= 1
    want = np.asarray(jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), rot,
                                       theta))
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), rot,
                           theta).numpy()
    pair = np.abs(x[..., 0:rot:2]) + np.abs(x[..., 1:rot:2])
    bound = np.repeat(pair, 2, -1) * 2.0 ** -23 * 3
    assert np.all(np.abs(want[..., :rot] - got[..., :rot]) <= bound)
    assert np.array_equal(want[..., rot:], got[..., rot:])
