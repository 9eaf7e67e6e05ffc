"""Training the MoE, MLA, VLM and audio zoo: ``lm_loss`` gradients of the
port against ``jax.grad`` of the JAX package's, the trainable filter of
a MoE fine-tune, and the train CLI's input-mode check.

Gradients on the reduced deepseek-v2-lite-16b (MoE + MLA, aux loss),
deepseek-v3-671b (sigmoid router, q-LoRA MLA, multi-token prediction),
internvl2-1b (vlm) and musicgen-medium (audio, 4 codebooks), f32, batch
2 and 24 positions (vlm: 8 patches + 16 tokens): the whole loss (xent,
aux and mtp together), and the MoE aux loss alone for the deepseeks.
The JAX package's ``init_lm`` params are carried across with the
bridge.  Tolerance per leaf: |Δ| ≤ 1e-5 · max|JAX gradient leaf| +
1e-8 (measured worst relative gap 3.3e-6: matmuls and softmaxes sum in
another order).

The filter ``/(lora_a|lora_b)$|/router/w$`` taken verbatim selects the
same leaves as the JAX package's on the reduced configs, and at full
width deepseek-v2-lite-16b + lora:8's dense prefix adapters and its 26
MoE routers (one stacked leaf): 3,719,680 elements, exactly; deepseek-v3
adds its ``mtp`` block's router.
"""
import functools

import numpy as np
import pytest
import torch
from torch_parity import to_torch_params, torch_config

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import with_peft as jwith_peft
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.sharding import rules as jrules
from repro_torch.configs import get_config, with_peft
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm

B, S = 2, 24
ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b", "internvl2-1b",
         "musicgen-medium")
ROUTER_FILTER = r"/(lora_a|lora_b)$|/router/w$"
N_SLICE = 3_719_680           # deepseek-v2-lite-16b + lora:8, the filter


def _batch(jc):
    rng = np.random.default_rng(1)
    if jc.input_mode == "tokens":
        return {"tokens": rng.integers(0, jc.vocab_size, (B, S)),
                "labels": rng.integers(0, jc.vocab_size, (B, S))}
    if jc.input_mode == "vlm":
        P = jc.n_prefix_tokens
        return {"patch_embeds": rng.standard_normal(
                    (B, P, jc.d_model)).astype(np.float32),
                "tokens": rng.integers(0, jc.vocab_size, (B, S - P)),
                "labels": rng.integers(0, jc.vocab_size, (B, S - P))}
    return {"frame_embeds": rng.standard_normal(
                (B, S, jc.d_model)).astype(np.float32),
            "labels": rng.integers(0, jc.vocab_size, (B, S, jc.n_codebooks))}


def _jax_objective(jc, what):
    if what == "loss":
        return lambda p, b: JT.lm_loss(p, jc, b)[0]
    return lambda p, b: JT.lm_forward(p, jc, b)[1]


def _torch_objective(tc, what):
    if what == "loss":
        return lambda p, b: TT.lm_loss(p, tc, b)[0]
    return lambda p, b: TT.lm_forward(p, tc, b)[1]


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    jc = jget_reduced(arch)
    return jc, JT.init_lm(jax.random.PRNGKey(0), jc)


@pytest.mark.parametrize("arch,what", [(a, "loss") for a in ARCHS] +
                         [(a, "aux") for a in ARCHS[:2]])
def test_lm_loss_gradients_match_jax(arch, what):
    jc, jp = _jax_init(arch)
    batch = _batch(jc)
    jv, jg = jax.jit(jax.value_and_grad(_jax_objective(jc, what)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = to_torch_params(jp)
    leaves, treedef = tm.tree_flatten(tp)
    live = [t.requires_grad_(True) for t in leaves]
    tv = _torch_objective(torch_config(jc), what)(
        tm.tree_unflatten(treedef, live),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tg = torch.autograd.grad(tv, live, allow_unused=True)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    assert float(jv) > 0
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    moved = 0
    for g, w in zip(tg, jleaves):
        w = np.asarray(w, np.float32)
        g = np.zeros_like(w) if g is None else g.detach().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-8)
        moved += bool(np.abs(w).max() > 0)
    # the aux loss reaches the routers (and what feeds them), not the head
    assert moved > (2 if what == "aux" else len(jleaves) // 2)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
@pytest.mark.parametrize("filt", ["lora", ROUTER_FILTER])
def test_trainable_filter_selects_the_jax_leaves(arch, filt):
    jc = jwith_peft(jget_reduced(arch), "lora:4")
    jshapes = jax.eval_shape(lambda k: JT.init_lm(k, jc),
                             jax.random.PRNGKey(0))
    tshapes = TT.init_lm(torch_config(jc), device="meta")
    assert rules.trainable_mask(tshapes, filt) == \
        tuple(jrules.trainable_mask(jshapes, filt))
    picked = [p for p, m in zip(tm.tree_paths(tshapes),
                                rules.trainable_mask(tshapes, filt)) if m]
    routers = [p for p in picked if p.endswith("/router/w")]
    if filt == "lora":
        assert not routers
    else:
        want = ["blocks/moe/router/w"]
        if arch == "deepseek-v3-671b":
            want.append("mtp/block/moe/router/w")
        assert routers == want


def test_router_filter_at_full_width():
    """deepseek-v2-lite-16b + lora:8: the dense layer's 6 MLP adapters
    (311,808) and the 26 routers of 2048 x 64 stacked in one leaf."""
    cfg = with_peft(get_config("deepseek-v2-lite-16b"), "lora:8")
    shapes = TT.init_lm(cfg, device="meta")
    mask = rules.trainable_mask(shapes, ROUTER_FILTER)
    leaves = [(p, t) for p, t, m in zip(tm.tree_paths(shapes),
                                        tm.tree_leaves(shapes), mask) if m]
    router = dict(leaves)["blocks/moe/router/w"]
    assert tuple(router.shape) == (26, 2048, 64)
    assert len(leaves) == 7
    assert sum(t.numel() for _, t in leaves) == N_SLICE
    assert sum(t.numel() for p, t in leaves if "lora" in p) == 311_808
    jc = jwith_peft(jget_config("deepseek-v2-lite-16b"), "lora:8")
    jshapes = jax.eval_shape(lambda k: JT.init_lm(k, jc),
                             jax.random.PRNGKey(0))
    assert mask == tuple(jrules.trainable_mask(jshapes, ROUTER_FILTER))


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-1b"])
def test_train_cli_refuses_embedding_archs_as_jax(arch, capsys):
    """Both CLIs return 2 with the same message before building data."""
    argv = ["--arch", arch, "--rounds", "1", "--cyclic-rounds", "0"]
    assert jtrain.main(argv) == 2
    want = capsys.readouterr().err
    assert train.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got == want and "pod driver trains token-mode archs" in got
