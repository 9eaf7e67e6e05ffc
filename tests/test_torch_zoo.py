"""The rest of the zoo in ``repro_torch.models.transformer`` against
``repro.models.transformer``: reduced deepseek-v2-lite-16b (MoE + MLA, a
dense-FFN prefix layer), deepseek-v3-671b (sigmoid router, q-LoRA MLA,
multi-token prediction), internvl2-1b (vlm: patch embeddings before the
tokens, tied embeddings) and musicgen-medium (audio: frame embeddings
in, 4 codebooks out).  The JAX package's ``init_lm`` params are carried
across with the bridge, the same numpy batch goes through both, and
``lm_forward``, ``lm_loss`` (xent, aux, mtp), ``prefill`` (logits and
the whole cache, dense prefix included) and three teacher-forced
``decode_step``s are compared; internvl2 and musicgen also under
``attn_impl="pallas_interpret"`` (the JAX side runs its attention kernel
in interpret mode, the port the kernel's plain version).  Batch 2 and 40
positions (vlm: 16 patches + 24 tokens).  The audio decode steps are fed
the serving engine's stand-in frames of the JAX side's greedy codes.

Tolerance: f32 at atol = rtol = 5e-5, as in ``test_torch_transformer.py``
(the measured gap is ~1e-5 at most: matmuls and softmaxes sum in another
order).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import param_count as jparam_count
from repro.configs import with_peft as jwith_peft
from repro.models import transformer as JT
from repro_torch.configs import (get_config, get_reduced, param_count,
                                 with_peft)
from repro_torch.models import transformer as TT
from repro_torch.utils import tree_math as tm
from torch_parity import to_torch_params, torch_config

B, S, STEPS = 2, 40, 3
ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b", "internvl2-1b",
         "musicgen-medium")
PARAMS = {"deepseek-v2-lite-16b": 15_706_484_224,
          "deepseek-v3-671b": 682_636_465_152,
          "internvl2-1b": 493_780_992,
          "musicgen-medium": 1_824_671_232}
CASES = [(a, "xla") for a in ARCHS] + \
        [(a, "pallas_interpret") for a in ("internvl2-1b", "musicgen-medium")]
TOL = dict(atol=5e-5, rtol=5e-5)


def _jcfg(arch, impl="xla"):
    return dataclasses.replace(jget_reduced(arch), attn_impl=impl)


def _np(x):
    if isinstance(x, torch.Tensor):     # a copy: the cache changes in place
        return x.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(jc):
    """A numpy batch of the config's input mode, with labels."""
    rng = np.random.default_rng(0)
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


def _feed(jc, logits):
    """The next decode input from the last logits: the greedy ids, or
    for audio the serving engine's stand-in frame (a one-hot of ``id %
    d_model`` averaged over the codebooks)."""
    ids = np.argmax(logits[:, -1], axis=-1)[:, None]
    if jc.input_mode != "embeddings":
        return ids
    oh = np.eye(jc.d_model, dtype=np.float32)[ids % jc.d_model]
    return oh.mean(axis=2).reshape(B, 1, jc.d_model)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, impl):
    """The JAX package on seeded params and a seeded batch: its params,
    the batch, the decode steps' inputs and numpy results."""
    jc = _jcfg(arch, impl)
    jp = JT.init_lm(jax.random.PRNGKey(0), jc)
    batch = _batch(jc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    jl, aux, _ = jax.jit(lambda p, b: JT.lm_forward(p, jc, b))(jp, jb)
    out["forward"], out["aux"] = _np(jl), float(aux)
    _, metrics = jax.jit(lambda p, b: JT.lm_loss(p, jc, b))(jp, jb)
    out["loss"] = {k: float(v) for k, v in metrics.items()}
    pb = {k: v for k, v in jb.items() if k != "labels"}
    jl, jcache, jS = jax.jit(lambda p, b: JT.prefill(p, jc, b, S + STEPS))(
        jp, pb)
    assert int(jS) == S
    out["prefill"] = _np(jl)
    out["prefill_cache"] = [_np(x) for x in
                            jax.tree_util.tree_leaves(jcache)]
    dec = jax.jit(lambda p, t, c, n: JT.decode_step(p, jc, t, c, n))
    fed = [_feed(jc, out["prefill"])]
    steps = []
    for i in range(STEPS):
        jl, jcache = dec(jp, jnp.asarray(fed[-1]), jcache, jnp.int32(S + i))
        steps.append(_np(jl))
        fed.append(_feed(jc, steps[-1]))
    out["decode"] = np.stack(steps)
    out["decode_cache"] = [_np(x) for x in
                           jax.tree_util.tree_leaves(jcache)]
    return jp, batch, fed[:STEPS], out


@functools.lru_cache(maxsize=None)
def _run(arch, impl):
    """Both packages on the same params and batch; the port's decode
    steps are fed the JAX side's inputs."""
    jp, batch, fed, jout = _jax_run(arch, impl)
    tc = torch_config(_jcfg(arch, impl))
    tp = to_torch_params(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    tl, aux, _ = TT.lm_forward(tp, tc, tb)
    out["forward"], out["aux"] = _np(tl), float(aux)
    _, metrics = TT.lm_loss(tp, tc, tb)
    out["loss"] = {k: float(v) for k, v in metrics.items()}
    pb = {k: v for k, v in tb.items() if k != "labels"}
    tl, tcache, tS = TT.prefill(tp, tc, pb, S + STEPS)
    assert tS == S
    out["prefill"] = _np(tl)
    out["prefill_cache"] = [_np(x) for x in tm.tree_leaves(tcache)]
    steps = []
    for i, x in enumerate(fed):
        tl, tcache = TT.decode_step(tp, tc, torch.from_numpy(x), tcache,
                                    S + i)
        steps.append(_np(tl))
    out["decode"] = np.stack(steps)
    out["decode_cache"] = [_np(x) for x in tm.tree_leaves(tcache)]
    return {"jax": jout, "torch": out}


@pytest.mark.parametrize("stage", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("arch,impl", CASES)
def test_logits_match_jax(arch, impl, stage):
    out = _run(arch, impl)
    got, want = out["torch"][stage], out["jax"][stage]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch,impl", CASES)
def test_loss_matches_jax(arch, impl):
    """xent (the image prefix left out in vlm mode, 4 codebooks in audio
    mode), the MoE aux loss, deepseek-v3's mtp loss, and their total."""
    out = _run(arch, impl)
    got, want = out["torch"]["loss"], out["jax"]["loss"]
    assert set(got) == set(want)
    assert ("mtp" in got) == (arch == "deepseek-v3-671b")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    np.testing.assert_allclose(out["torch"]["aux"], out["jax"]["aux"], **TOL)
    assert (out["jax"]["aux"] > 0) == arch.startswith("deepseek")


@pytest.mark.parametrize("stage", ["prefill_cache", "decode_cache"])
@pytest.mark.parametrize("arch,impl", CASES)
def test_cache_matches_jax(arch, impl, stage):
    """MLA's latent rows and rope keys (dense prefix and stack) or the
    k/v rows, leaf for leaf."""
    out = _run(arch, impl)
    got, want = out["torch"][stage], out["jax"][stage]
    assert len(got) == len(want) == (4 if arch.startswith("deepseek") else 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax_at_full_width(arch):
    n = param_count(get_config(arch))
    assert n == jparam_count(jget_config(arch)) == PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_map_over_field_for_field(arch):
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jget_reduced(arch), get_reduced(arch))):
        assert torch_config(jc) == tc


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_init_lm_tree(arch):
    """A JAX ``init_lm`` tree — the ``dense_blocks`` list, the ``mtp``
    subtree, an f32 router under bf16 params, no ``embed`` for audio —
    crosses the bridge unchanged, with the layout the port's own
    ``init_lm`` draws."""
    jc = dataclasses.replace(jget_reduced(arch), param_dtype=jnp.bfloat16)
    jp = JT.init_lm(jax.random.PRNGKey(1), jc)
    tp = to_torch_params(jp)
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves, tdef = tm.tree_flatten(tp)
    for j, t in zip(jleaves, tleaves):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_np(j), _np(t))
    own, own_def = tm.tree_flatten(TT.init_lm(torch_config(jc), device="cpu"))
    assert own_def == tdef
    assert [(t.shape, t.dtype) for t in own] == \
        [(t.shape, t.dtype) for t in tleaves]
    assert isinstance(tp.get("dense_blocks", []), list)
    assert ("mtp" in tp) == jc.mtp and ("embed" in tp) == \
        (jc.input_mode != "embeddings")


def test_lora_tree_of_deepseek_matches_jax():
    """``with_peft(deepseek-v2-lite, "lora:4")``: adapters only where the
    JAX package puts them — the dense prefix's MLP; MLA, the experts and
    the shared experts take none."""
    jc = jwith_peft(jget_reduced("deepseek-v2-lite-16b"), "lora:4")
    tc = with_peft(get_reduced("deepseek-v2-lite-16b"), "lora:4")
    assert torch_config(jc) == tc
    jp = jax.eval_shape(lambda k: JT.init_lm(k, jc), jax.random.PRNGKey(0))
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    tp = TT.init_lm(tc, device="meta")
    assert jpaths == tm.tree_paths(tp)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jp)] == \
        [tuple(t.shape) for t in tm.tree_leaves(tp)]
    adapters = sorted({p.rsplit("/", 2)[0] for p in jpaths if "lora_" in p})
    assert adapters == ["dense_blocks/0/mlp"]


def test_init_lm_stack_draws_layer_by_layer():
    """The stack is drawn one layer at a time into its slot: the same
    draws, in the same order, as drawing every layer and stacking them."""
    cfg = get_reduced("deepseek-v3-671b")
    got = TT.init_lm(cfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    embed = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen)
    blocks = [TT._init_block(gen, cfg, moe_layer=True)
              for _ in range(cfg.n_layers - cfg.n_dense_layers)]
    want = tm.tree_map(lambda *xs: torch.stack(xs), *blocks)
    assert torch.equal(got["embed"], (embed * 0.02).to(cfg.param_dtype))
    for a, b in zip(tm.tree_leaves(got["blocks"]), tm.tree_leaves(want)):
        assert torch.equal(a, b)
    again = TT.init_lm(cfg, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tm.tree_leaves(got), tm.tree_leaves(again)))
