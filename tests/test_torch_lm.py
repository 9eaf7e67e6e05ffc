"""Next-token LM training in the port against the JAX package: the dense
configs (``tinyllama-1.1b`` and ``-swa``, ``qwen2-1.5b``, ``qwen3-32b``),
``with_peft``, the LoRA layers (``init_lora_linear``, ``linear``,
``merge_lora``), ``lm_loss`` with its gradients, ``lm_task``,
``make_synthetic_tokenlm`` and the bridge over LoRA trees.

The JAX package's ``init_lm`` params (under ``with_peft``) are carried
across with the bridge; the LoRA ``B`` factors are then set to the same
seeded numpy draw on both sides, so the adapters contribute to the
forward and every adapter leaf has a gradient.  Tolerances (f32 reduced
configs, batch 2 × 24, logits of magnitude ~6): loss rtol 1e-5, the
adapter gradients atol 2e-6 + rtol 1e-4 (matmuls sum in another order);
the data and the masks bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import jax_numpy_params, to_torch_params, torch_config

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import param_count as jparam_count
from repro.configs import with_peft as jwith_peft
from repro.data.synthetic import DATASETS as J_DATASETS
from repro.data.synthetic import make_synthetic_tokenlm as j_tokenlm
from repro.fl.task import lm_task as j_lm_task
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import (get_config, get_reduced, list_archs,
                                 param_count, with_peft)
from repro_torch.data.synthetic import DATASETS, make_synthetic_tokenlm
from repro_torch.fl.task import lm_task
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.utils.device import seeded_generator
from repro_torch.utils.tree_math import tree_flatten, tree_leaves, tree_paths

NEW_ARCHS = ("tinyllama-1.1b", "tinyllama-1.1b-swa", "qwen2-1.5b",
             "qwen3-32b")
LOSS_ARCHS = ("tinyllama-1.1b", "qwen1.5-0.5b")
B, S, RANK = 2, 24, 4


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_map_over_field_for_field(arch):
    assert arch in list_archs()
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jget_reduced(arch), get_reduced(arch))):
        assert torch_config(jc) == tc


@pytest.mark.parametrize("arch,peft", [(a, None) for a in NEW_ARCHS] +
                         [("tinyllama-1.1b", "lora:8"),
                          ("qwen1.5-0.5b", "lora:8"),
                          ("qwen3-32b", "lora:16")])
def test_param_count_matches_jax_at_full_width(arch, peft):
    n = param_count(with_peft(get_config(arch), peft))
    assert n == jparam_count(jwith_peft(jget_config(arch), peft))
    if arch == "tinyllama-1.1b":
        # 1,100,048,384 base parameters; rank-8 adapters on the 7 linears
        # of 22 layers: 8·((2048+2048) + 2·(2048+256) + (2048+2048)
        # + 2·(2048+5632) + (5632+2048)) = 286,720 a layer
        assert n == 1_100_048_384 + (22 * 286_720 if peft else 0)


def test_with_peft_matches_jax_and_rejects_bad_specs():
    for peft in (None, "lora:1", "lora:8"):
        assert torch_config(jwith_peft(jget_reduced("qwen2-1.5b"), peft)) == \
            with_peft(get_reduced("qwen2-1.5b"), peft)
    for bad, msg in (("adapters:8", "unknown peft spec"),
                     ("lora", "unknown peft spec"),
                     ("lora:0", "positive integer"),
                     ("lora:x", "positive integer")):
        with pytest.raises(ValueError, match=msg):
            with_peft(get_reduced("qwen2-1.5b"), bad)


# ---------------------------------------------------------------------------
# LoRA layers
# ---------------------------------------------------------------------------

def test_lora_linear_zero_init_is_the_base_linear_bitwise():
    """Adding adapters draws the base ``w`` as before (and leaves the
    generator where the base draw leaves it); ``B`` starts at zero, so
    the adapted forward equals the base forward bitwise, with the bias."""
    x = torch.randn(4, 3, 16, generator=seeded_generator(1))
    g_base, g_lora = seeded_generator(0), seeded_generator(0)
    base = TL.init_linear(g_base, 16, 8, bias=True)
    lora = TL.init_linear(g_lora, 16, 8, bias=True, lora_rank=RANK)
    assert torch.equal(base["w"], lora["w"])
    assert torch.equal(g_base.get_state(), g_lora.get_state())
    assert sorted(lora) == ["b", "lora_a", "lora_b", "w"]
    assert lora["lora_a"].shape == (16, RANK) and \
        not torch.equal(lora["lora_a"], torch.zeros_like(lora["lora_a"]))
    assert torch.equal(lora["lora_b"], torch.zeros(RANK, 8))
    assert torch.equal(TL.linear(base, x), TL.linear(lora, x))
    with pytest.raises(ValueError, match="positive integer"):
        TL.init_lora_linear(seeded_generator(0), 8, 8, rank=0)


def test_lora_model_init_keeps_every_base_leaf_bitwise():
    cfg = get_reduced("tinyllama-1.1b")
    base = TT.init_lm(cfg, seed=5, device="cpu")
    lora = TT.init_lm(with_peft(cfg, "lora:4"), seed=5, device="cpu")
    paths = dict(zip(tree_paths(lora), tree_leaves(lora)))
    for path, leaf in zip(tree_paths(base), tree_leaves(base)):
        assert torch.equal(paths[path], leaf), path
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)))
    a, _, _ = TT.lm_forward(base, cfg, {"tokens": toks})
    b, _, _ = TT.lm_forward(lora, with_peft(cfg, "lora:4"), {"tokens": toks})
    assert torch.equal(a, b)


def _perturbed_jax_lora(arch, seed=0):
    """The JAX reduced config under ``lora:RANK``, its seeded ``init_lm``
    params with every ``lora_b`` set to a seeded numpy draw (numpy)."""
    jcfg = jwith_peft(jget_reduced(arch), f"lora:{RANK}")
    jp = jax_numpy_params(JT.init_lm(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jp)
    leaves = []
    for path, leaf in flat:
        if str(getattr(path[-1], "key", "")) == "lora_b":
            leaf = (0.05 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        leaves.append(np.array(leaf))
    return jcfg, jax.tree_util.tree_unflatten(treedef, leaves)


def test_merge_lora_matches_jax_and_the_adapter_forward():
    """``merge_lora`` folds W + (α/r)·A·B in f32: the same merged weights
    as the JAX package's (atol 1e-6), and the merged plain model's
    logits within 2e-5 of the adapter model's."""
    jcfg, jp = _perturbed_jax_lora("tinyllama-1.1b")
    tp = to_torch_params(jp)
    merged = TL.merge_lora(tp)
    jmerged = JL.merge_lora(jp)
    assert not any("lora" in p for p in tree_paths(merged))
    for a, b in zip(tree_leaves(merged), jax.tree_util.tree_leaves(jmerged)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    cfg = torch_config(jcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)))
    adapted, _, _ = TT.lm_forward(tp, cfg, {"tokens": toks})
    plain, _, _ = TT.lm_forward(merged, dataclasses.replace(cfg, lora_rank=0),
                                {"tokens": toks})
    np.testing.assert_allclose(adapted.numpy(), plain.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_bridge_carries_the_lora_tree(arch):
    """A JAX ``init_lm`` tree under ``with_peft`` crosses the bridge and
    back unchanged, in the leaf order (and paths) of the port's own
    ``init_lm``, bf16 leaves through their bit patterns."""
    jcfg = dataclasses.replace(jwith_peft(jget_reduced(arch), "lora:4"),
                               dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    jp = jax_numpy_params(JT.init_lm(jax.random.PRNGKey(2), jcfg))
    tp = bridge.params_from_numpy(jp)
    jpaths = ["/".join(str(getattr(k, "key", k)) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert tree_paths(tp) == jpaths
    assert sum("lora_" in p for p in jpaths) == 14      # 7 linears × a, b
    back = bridge.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
    own, own_def = tree_flatten(TT.init_lm(torch_config(jcfg), device="cpu"))
    assert own_def == tree_flatten(tp)[1]
    assert [(t.shape, t.dtype) for t in own] == \
        [(t.shape, t.dtype) for t in tree_leaves(tp)]


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

def _batch(vocab, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1                 # ignored positions
    labels[0, :5] = -1
    return toks, labels


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_and_adapter_gradients_match_jax(arch):
    jcfg, jp = _perturbed_jax_lora(arch)
    toks, labels = _batch(jcfg.vocab_size)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}

    def jloss(p):
        return JT.lm_loss(p, jcfg, jb)[0]

    jl, jg = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray,
                                                              jp))
    cfg = torch_config(jcfg)
    tp = to_torch_params(jp)
    leaves, treedef = tree_flatten(tp)
    pv = [x.requires_grad_(True) for x in leaves]
    from repro_torch.utils.tree_math import tree_unflatten
    tl, metrics = TT.lm_loss(tree_unflatten(treedef, pv), cfg,
                             {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(tl, pv)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert torch.equal(metrics["xent"], tl)
    jpaths = tree_paths(tp)
    n_lora = 0
    for path, g, jgl in zip(jpaths, grads, jax.tree_util.tree_leaves(jg)):
        if "lora_" in path:
            n_lora += 1
            assert np.abs(np.asarray(jgl)).max() > 0, path
            np.testing.assert_allclose(g.numpy(), np.asarray(jgl), atol=2e-6,
                                       rtol=1e-4, err_msg=path)
    assert n_lora == 14


def test_xent_ignores_label_minus_one_and_keeps_f32():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[1, 2:] = -1
    tl, tm_ = TT._xent(torch.from_numpy(logits).to(torch.bfloat16),
                       torch.from_numpy(labels))
    jl, jm = JT._xent(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    assert tl.dtype == torch.float32
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    every = -np.ones_like(labels)
    assert float(TT._xent(torch.from_numpy(logits),
                          torch.from_numpy(every))[0]) == 0.0


def test_attention_kernel_under_autograd_raises():
    """The attention kernel has no backward: training through it raises
    instead of falling back to the plain attention."""
    cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"),
                              attn_impl="pallas_interpret")
    p = TT.init_lm(cfg, device="cpu")
    toks, labels = _batch(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    p["blocks"]["attn"]["wq"]["w"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        TT.lm_loss(p, cfg, batch)
    with torch.no_grad():               # the serve path still runs it
        loss, _ = TT.lm_loss(p, cfg, batch)
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# lm_task and the token data
# ---------------------------------------------------------------------------

def test_lm_task_matches_jax():
    jcfg, jp = _perturbed_jax_lora("qwen1.5-0.5b")
    jtask, ttask = j_lm_task(jcfg), lm_task(torch_config(jcfg))
    assert ttask.kind == jtask.kind == "tokenlm"
    tp = to_torch_params(jp)
    toks, labels = _batch(jcfg.vocab_size)
    jx, tx = jnp.asarray(toks), torch.from_numpy(toks)
    np.testing.assert_allclose(
        float(ttask.loss_fn(tp, tx, torch.from_numpy(labels))),
        float(jtask.loss_fn(jax.tree_util.tree_map(jnp.asarray, jp), jx,
                            jnp.asarray(labels))), rtol=1e-5)
    np.testing.assert_allclose(ttask.repr_fn(tp, tx).numpy(),
                               np.asarray(jtask.repr_fn(jp, jx)), atol=2e-5)
    pred, jpred = ttask.predict_fn(tp, tx).numpy(), np.asarray(
        jtask.predict_fn(jp, jx))
    assert (pred == jpred).mean() > 0.99
    # shapes on the meta device, the init on the generator's device
    shapes = ttask.shapes()
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    own = ttask.init(seeded_generator(0))
    assert [t.shape for t in tree_leaves(own)] == \
        [t.shape for t in tree_leaves(shapes)]


@pytest.mark.parametrize("kw", [
    dict(n_clients=4, seq_len=16, n_seq_per_client=8, vocab=512, beta=0.5,
         seed=0),
    dict(n_clients=3, seq_len=9, n_seq_per_client=5, vocab=5000, beta=0.3,
         n_topics=3, n_test=7, seed=4)])
def test_make_synthetic_tokenlm_is_byte_identical(kw):
    """Vocabularies below and above the 4096-token bucket."""
    a, b = make_synthetic_tokenlm(**kw), j_tokenlm(**kw)
    for f in ("x", "y", "n_real", "test_x", "test_y"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert (a.n_classes, a.name) == (b.n_classes, b.name)


def test_tokenlm_bigram_is_registered():
    kw = dict(n_clients=4, seed=1, seq_len=8, n_seq_per_client=4, vocab=64)
    a = DATASETS.get("tokenlm-bigram")(**kw)
    b = J_DATASETS.get("tokenlm-bigram")(**kw)
    assert a.x.tobytes() == b.x.tobytes()
    assert a.test_y.tobytes() == b.test_y.tobytes()
