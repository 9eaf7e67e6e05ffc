"""``repro_torch.models.transformer`` against ``repro.models.transformer``
on the reduced dense (qwen1.5-0.5b), SSM (mamba2-1.3b) and hybrid
(hymba-1.5b) configs: the JAX package's ``init_lm`` params are carried
across with the bridge, the same numpy token batch goes through both,
and ``lm_forward``, ``prefill`` (logits and cache) and three
``decode_step``s are compared under ``attn_impl = ssd_impl = "xla"`` and
``"pallas_interpret"`` (the JAX side runs its Pallas kernels in
interpret mode, the port its plain versions), plus one bf16 variant of
reduced hymba.  Batch 2, prompt 40: longer than hymba's window (32) and
not a multiple of the chunk (32).  The decode steps are teacher-forced on
the JAX side's greedy tokens.  The JAX oracles of qwen1.5-0.5b and
mamba2-1.3b run "xla" alone (see ``_oracle_impl``).

Tolerances: f32 at atol = rtol = 5e-5 on logits of magnitude ~4 (the
measured gap is ~6e-6: matmuls and the cumulative SSD decay sum in
another order, and XLA's exp/rsqrt/sin/cos round differently in the
last bit).  bf16 at atol 0.15, about ten bf16 ulps at the logits'
scale: every op of the two layers rounds its bf16 output, and the two
packages round at different points (XLA fuses elementwise chains in f32).
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import param_count as jparam_count
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_reduced, param_count
from repro_torch.models import transformer as TT
from repro_torch.utils.tree_math import tree_flatten, tree_leaves
from torch_parity import to_torch_params, torch_config

B, S, STEPS = 2, 40, 3
ARCHS = ("hymba-1.5b", "qwen1.5-0.5b", "mamba2-1.3b")
CASES = [(a, impl, "float32") for a in ARCHS
         for impl in ("xla", "pallas_interpret")] + \
        [("hymba-1.5b", "pallas_interpret", "bfloat16")]


def _jcfg(arch, impl="xla", dtype="float32"):
    cfg = dataclasses.replace(jget_reduced(arch), attn_impl=impl,
                              ssd_impl=impl)
    if dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, dtype=jnp.bfloat16,
                                  param_dtype=jnp.bfloat16)
    return cfg


def _np(x):
    if isinstance(x, torch.Tensor):     # a copy: the cache changes in place
        return x.float().numpy().copy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _oracle_impl(arch, impl):
    """The JAX side's impl for a case: hymba-1.5b, the model the port
    serves on the card, is held against both JAX impls; qwen1.5-0.5b and
    mamba2-1.3b hold both of the port's impls against the JAX "xla" path
    alone (the two JAX impls agree to ~1e-6 there), one JAX compile each
    instead of two."""
    return impl if arch == "hymba-1.5b" else "xla"


@functools.lru_cache(maxsize=None)
def _jax_run(arch, impl, dtype):
    """The JAX package on seeded params and tokens: its params, the
    tokens, the decode steps' (greedy) input tokens, numpy results."""
    jc = _jcfg(arch, impl, dtype)
    jp = JT.init_lm(jax.random.PRNGKey(0), jc)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (B, S))
    jb = {"tokens": jnp.asarray(toks)}
    max_len = S + STEPS
    out = {}

    jl, _, _ = jax.jit(lambda p, b: JT.lm_forward(p, jc, b))(jp, jb)
    out["forward"] = _np(jl)
    jl, jcache, jS = jax.jit(lambda p, b: JT.prefill(p, jc, b, max_len))(jp, jb)
    assert int(jS) == S
    out["prefill"] = _np(jl)
    out["prefill_cache"] = [_np(x) for x in
                            jax.tree_util.tree_leaves(jcache["scan"])]
    dec = jax.jit(lambda p, t, c, n: JT.decode_step(p, jc, t, c, n))
    fed = [np.argmax(_np(jl)[:, -1], axis=-1)[:, None]]
    jd = []
    for i in range(STEPS):
        jl, jcache = dec(jp, jnp.asarray(fed[-1]), jcache, jnp.int32(S + i))
        jd.append(_np(jl))
        fed.append(np.argmax(jd[-1][:, -1], axis=-1)[:, None])
    out["decode"] = np.stack(jd)
    out["decode_cache"] = [_np(x) for x in
                           jax.tree_util.tree_leaves(jcache["scan"])]
    return jp, toks, fed[:STEPS], out


@functools.lru_cache(maxsize=None)
def _run(arch, impl, dtype):
    """Both packages on the same params and tokens; numpy results.  The
    port's decode steps are fed the JAX side's tokens."""
    jp, toks, fed, jout = _jax_run(arch, _oracle_impl(arch, impl), dtype)
    tc = torch_config(_jcfg(arch, impl, dtype))
    tp = to_torch_params(jp)
    tb = {"tokens": torch.from_numpy(toks)}
    out = {}

    tl, _, _ = TT.lm_forward(tp, tc, tb)
    out["forward"] = _np(tl)
    tl, tcache, tS = TT.prefill(tp, tc, tb, S + STEPS)
    assert tS == S
    out["prefill"] = _np(tl)
    out["prefill_cache"] = [_np(x) for x in tree_leaves(tcache["scan"])]
    td = []
    for i, tok in enumerate(fed):
        tl, tcache = TT.decode_step(tp, tc, torch.from_numpy(tok), tcache,
                                    S + i)
        td.append(_np(tl))
    out["decode"] = np.stack(td)
    out["decode_cache"] = [_np(x) for x in tree_leaves(tcache["scan"])]
    return {"jax": jout, "torch": out}


def _close(got, want, dtype):
    tol = dict(atol=5e-5, rtol=5e-5) if dtype == "float32" else \
        dict(atol=0.15, rtol=0.0)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("stage", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("arch,impl,dtype", CASES)
def test_logits_match_jax(arch, impl, dtype, stage):
    out = _run(arch, impl, dtype)
    assert out["torch"][stage].shape == out["jax"][stage].shape
    assert np.isfinite(out["torch"][stage]).all()
    _close(out["torch"][stage], out["jax"][stage], dtype)


@pytest.mark.parametrize("stage", ["prefill_cache", "decode_cache"])
@pytest.mark.parametrize("arch,impl,dtype", CASES)
def test_cache_matches_jax(arch, impl, dtype, stage):
    """KV rows and SSM (state, conv tail), leaf for leaf."""
    out = _run(arch, impl, dtype)
    assert len(out["torch"][stage]) == len(out["jax"][stage])
    for got, want in zip(out["torch"][stage], out["jax"][stage]):
        assert got.shape == want.shape
        _close(got, want, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_init_lm_tree(arch):
    """A JAX ``init_lm`` tree (stacked blocks, f32 A_log/D/dt_bias, bf16
    leaves) crosses the bridge unchanged, with the layout the port's own
    ``init_lm`` draws."""
    jc = _jcfg(arch, dtype="bfloat16")
    jp = JT.init_lm(jax.random.PRNGKey(1), jc)
    tp = to_torch_params(jp)
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves, tdef = tree_flatten(tp)
    for j, t in zip(jleaves, tleaves):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_np(j), _np(t))
    own, own_def = tree_flatten(TT.init_lm(torch_config(jc), device="cpu"))
    assert own_def == tdef
    assert [(t.shape, t.dtype) for t in own] == \
        [(t.shape, t.dtype) for t in tleaves]


def test_init_lm_distributions():
    """The port draws with the JAX package's distributions, so the
    activations have the same scale."""
    cfg = get_reduced("hymba-1.5b")
    p = TT.init_lm(cfg, seed=3, device="cpu")
    jp = JT.init_lm(jax.random.PRNGKey(3), jget_reduced("hymba-1.5b"))
    ssm, blk = p["blocks"]["ssm"], p["blocks"]
    np.testing.assert_allclose(_np(ssm["A_log"]),
                               _np(jp["blocks"]["ssm"]["A_log"]), rtol=1e-6)
    assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
    dt = torch.nn.functional.softplus(ssm["dt_bias"].double())
    assert dt.min() >= 0.001 - 1e-9 and dt.max() <= 0.1 + 1e-9
    for w, std in ((p["embed"], 0.02), (blk["attn"]["wq"]["w"], 256 ** -0.5),
                   (blk["mlp"]["w_down"]["w"], 512 ** -0.5),
                   (ssm["conv_w"], 0.5), (p["lm_head"], 256 ** -0.5)):
        assert abs(w.float().std().item() / std - 1) < 0.05
        assert abs(w.float().mean().item()) < 0.05 * std
    assert torch.equal(ssm["conv_b"], torch.zeros_like(ssm["conv_b"]))
    # the same seed draws the same params; another seed does not
    again = TT.init_lm(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(p), tree_leaves(again)))
    other = TT.init_lm(cfg, seed=4, device="cpu")
    assert not torch.equal(p["embed"], other["embed"])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax_at_full_width(arch):
    n = param_count(get_config(arch))
    assert n == jparam_count(jget_config(arch))
    if arch == "hymba-1.5b":
        assert n == 1_640_872_320


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_map_over_field_for_field(arch):
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jget_reduced(arch), get_reduced(arch))):
        assert torch_config(jc) == tc


def test_unported_options_raise():
    """The options that raised before the port had them (MoE, MLA,
    multi-token prediction, the VLM and audio inputs) now build: every
    config of the JAX package's zoo, and ``mtp`` on a dense model.
    Their numbers are held against the JAX package in
    ``test_torch_zoo.py``."""
    from repro.configs import list_archs as jlist_archs
    for arch in jlist_archs():
        TT.init_lm(torch_config(jget_reduced(arch)), device="meta")
    moe = TT.init_lm(torch_config(jget_reduced("deepseek-v2-lite-16b")),
                     device="cpu")
    assert "moe" in moe["blocks"] and "mlp" in moe["dense_blocks"][0]
    lora = dataclasses.replace(get_reduced("qwen1.5-0.5b"), lora_rank=4)
    assert "lora_a" in TT.init_lm(lora, device="cpu")["blocks"]["attn"]["wq"]
    mtp = dataclasses.replace(get_reduced("qwen1.5-0.5b"), mtp=True)
    assert set(TT.init_lm(mtp, device="cpu")["mtp"]) == \
        {"block", "proj", "norm_prev", "norm_emb"}
    vlm = TT.init_lm(torch_config(jget_reduced("internvl2-1b")), device="cpu")
    assert "embed" in vlm and "lm_head" not in vlm     # tied embeddings


def test_entry_points_default_to_cuda():
    cfg = get_reduced("qwen1.5-0.5b")
    if torch.cuda.is_available():
        p = TT.init_lm(cfg)
        assert p["embed"].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_decode_cache(cfg, 1, 8)


def test_decode_cache_is_updated_in_place():
    cfg = get_reduced("hymba-1.5b")
    p = TT.init_lm(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 5),
                         generator=torch.Generator().manual_seed(0))
    _, cache, n = TT.prefill(p, cfg, {"tokens": toks}, 8)
    kc = cache["scan"]["kv"][0]
    before = kc[:, :, n].clone()
    _, cache2 = TT.decode_step(p, cfg, toks[:, :1], cache, n)
    assert cache2["scan"]["kv"][0] is kc
    assert not torch.equal(kc[:, :, n], before)
    with pytest.raises(ValueError):
        TT.decode_step(p, cfg, toks[:, :1], cache, 8)
    assert math.isfinite(float(cache2["scan"]["ssm"][0].abs().sum()))
