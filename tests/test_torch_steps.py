"""``repro_torch.launch.steps`` against ``repro.launch.steps``.

``make_train_step`` on the reduced qwen2-1.5b, deepseek-v2-lite-16b (MoE
+ MLA, aux loss), deepseek-v3-671b (with the multi-token loss),
internvl2-1b (vlm) and musicgen-medium (audio, 4 codebooks), at f32:
the JAX package's ``init_lm`` params carried across with the bridge, the
same numpy batch (batch 4, 16 positions; vlm 8 patches + 8 tokens) and
two steps from zero momentum (the second exercises β·m), at ``n_micro``
1 and 2, with and without weight decay (the full 2 × 2 on qwen2-1.5b,
one crossing per other arch, to hold the file's JAX compiles down).
Also ``_split_micro``'s row order, ``make_prefill_step`` /
``make_serve_step`` against the JAX ones, and ``init_momentum`` /
``momentum_specs`` dtypes and shapes on a bf16 config.

Tolerances: the loss rtol 1e-5; momentum and params per leaf within
1e-5 · max|JAX leaf| + 1e-7 (the gradients differ by at most ~3.3e-6
relative: matmuls and softmaxes sum in another order); the prefill and
decode logits atol = rtol = 5e-5, as in ``test_torch_zoo.py``.
"""
import functools

import numpy as np
import pytest
import torch
from torch_parity import (jax_leaves, to_torch_params, torch_config,
                          torch_leaves)

import jax
import jax.numpy as jnp
from repro.configs import get_reduced as jget_reduced
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import steps as TS
from repro_torch.models.transformer import init_lm
from repro_torch.utils import tree_math as tm

B, S = 4, 16
LR, BETA, WD = 0.1, 0.9, 1e-3
# (arch, n_micro, weight_decay)
CASES = [("qwen2-1.5b", n, wd) for n in (1, 2) for wd in (0.0, WD)] + \
    [(a, n, wd) for a in ("deepseek-v2-lite-16b", "deepseek-v3-671b",
                          "internvl2-1b", "musicgen-medium")
     for n, wd in ((1, 0.0), (2, WD))]


def _batch(jc, seed=0):
    """A numpy batch of the config's input mode, with labels."""
    rng = np.random.default_rng(seed)
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


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    jc = jget_reduced(arch)
    return jc, JT.init_lm(jax.random.PRNGKey(0), jc)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-7)


@pytest.mark.parametrize("arch,n_micro,wd", CASES)
def test_train_step_matches_jax(arch, n_micro, wd):
    jc, jp = _jax_init(arch)
    batch = _batch(jc)
    jspec = JS.TrainSpec(lr=LR, momentum=BETA, weight_decay=wd,
                         n_micro=n_micro)
    jstep = jax.jit(JS.make_train_step(jc, jspec))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JS.init_momentum(jp)
    tstep = TS.make_train_step(torch_config(jc), TS.TrainSpec(
        lr=LR, momentum=BETA, weight_decay=wd, n_micro=n_micro))
    tp = to_torch_params(jp)
    tm_ = TS.init_momentum(tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = torch_leaves(tp)
    j_cur = (jp, jm)
    for _ in range(2):
        jp2, jm2, jmet = jstep(*j_cur, jb)
        tp, tm_, tmet = tstep(tp, tm_, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        _close(torch_leaves(tm_), jax_leaves(jm2))
        _close(torch_leaves(tp), jax_leaves(jp2))
        j_cur = (jp2, jm2)
    # the step is functional: the caller's params are not written
    assert all(np.array_equal(a, b) for a, b in
               zip(before, torch_leaves(to_torch_params(jp))))
    assert all(t.dtype == torch.float32 for t in tm.tree_leaves(tm_))


def test_n_micro_2_equals_n_micro_1_on_a_dense_arch():
    """Two strided microbatches of 2 rows give the gradient of the batch
    of 4 (the loss is a mean over equal-sized microbatches)."""
    jc, jp = _jax_init("qwen2-1.5b")
    tc = torch_config(jc)
    tb = {k: torch.from_numpy(v) for k, v in _batch(jc).items()}
    outs = []
    for n in (1, 2):
        step = TS.make_train_step(tc, TS.TrainSpec(lr=LR, n_micro=n))
        tp = to_torch_params(jp)
        outs.append(step(tp, TS.init_momentum(tp), tb))
    np.testing.assert_allclose(float(outs[1][2]["loss"]),
                               float(outs[0][2]["loss"]), rtol=1e-5)
    _close(torch_leaves(outs[1][0]), torch_leaves(outs[0][0]))


def test_split_micro_takes_strided_rows_as_jax():
    x = np.arange(6 * 3).reshape(6, 3)
    got = TS._split_micro({"x": torch.from_numpy(x)}, 3)["x"].numpy()
    want = np.asarray(JS._split_micro({"x": jnp.asarray(x)}, 3)["x"])
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 2, 3)
    np.testing.assert_array_equal(got[1], x[[1, 4]])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-lite-16b",
                                  "musicgen-medium"])
def test_prefill_and_serve_steps_match_jax(arch):
    jc, jp = _jax_init(arch)
    batch = {k: v for k, v in _batch(jc).items() if k != "labels"}
    jl, jcache = jax.jit(JS.make_prefill_step(jc, S + 2))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tc, tp = torch_config(jc), to_torch_params(jp)
    tl, tcache = TS.make_prefill_step(tc, S + 2)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5,
                               rtol=5e-5)
    ids = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    if jc.input_mode == "embeddings":
        tok = np.eye(jc.d_model, dtype=np.float32)[ids % jc.d_model]
        tok = tok.mean(axis=2).reshape(B, 1, jc.d_model)
    else:
        tok = ids
    jl2, _ = jax.jit(JS.make_serve_step(jc))(jp, jnp.asarray(tok), jcache,
                                             jnp.int32(S))
    with torch.no_grad():
        tl2, _ = TS.make_serve_step(tc)(tp, torch.from_numpy(tok), tcache, S)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=5e-5,
                               rtol=5e-5)


def test_momentum_init_and_specs_dtypes():
    """f32 momentum for every floating leaf of a bf16 model; the specs
    allocate nothing (``meta``) and describe the same tree."""
    cfg = get_config("internvl2-1b")
    shapes = init_lm(cfg, device="meta")
    specs = TS.momentum_specs(shapes)
    assert all(s.device.type == "meta" and s.dtype == torch.float32
               for s in tm.tree_leaves(specs))
    assert [tuple(s.shape) for s in tm.tree_leaves(specs)] == \
        [tuple(p.shape) for p in tm.tree_leaves(shapes)]
    assert tm.tree_paths(specs) == tm.tree_paths(shapes)
    small = {"w": torch.ones(3, dtype=torch.bfloat16),
             "n": torch.arange(4)}
    mom = TS.init_momentum(small)
    assert mom["w"].dtype == torch.float32 and not mom["w"].any()
    assert mom["n"].dtype == torch.int64 and not mom["n"].any()
    assert TS.momentum_specs(small, torch.bfloat16)["w"].dtype == \
        torch.bfloat16
    assert TS.momentum_specs(small)["n"].dtype == torch.int64
