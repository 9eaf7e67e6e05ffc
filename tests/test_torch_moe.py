"""``repro_torch.models.layers``' ``moe`` and ``mla_attention`` against
``repro.models.layers``' on numpy-seeded inputs: the JAX package's
``init_moe`` / ``init_mla`` params carried across with the bridge, the
same activations through both.

MoE: softmax (deepseek-v2) and sigmoid (deepseek-v3) routers, with and
without shared experts, at the default capacity factor and at one that
drops pairs, and deepseek-v2-lite's decode routing (E 64, top-6, T 8, so
C = 1 and most pairs collide); the output, the aux loss, the top-k
choice and the dropped-pair count.  MLA with and without ``q_lora_rank``:
a prefill into the latent cache, then 3 cached decode steps.

Tolerances: f32 at atol = rtol = 5e-5 (the measured gap is ~1e-6:
matmuls and softmaxes sum in another order); bf16 at atol 0.15, about
ten bf16 ulps at the outputs' scale, since both packages round every
op's bf16 output but at different points.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import layers as JL
from repro_torch.models import layers as TL
from torch_parity import jax_numpy_params, to_torch_params

D = 32
# (label, n_experts, top_k, d_ff_expert, n_shared, capacity_factor,
#  scoring, B, S)
MOE_CASES = [
    ("softmax", 8, 2, 16, 0, 1.25, "softmax", 2, 12),
    ("softmax_shared", 8, 2, 16, 2, 1.25, "softmax", 2, 12),
    ("sigmoid", 8, 2, 16, 0, 1.25, "sigmoid", 2, 12),
    ("sigmoid_shared", 8, 2, 16, 1, 1.25, "sigmoid", 2, 12),
    ("drops", 8, 3, 16, 1, 0.5, "softmax", 2, 12),
    ("decode_c1", 64, 6, 16, 2, 1.25, "softmax", 8, 1),
]
TOL = {"float32": dict(atol=5e-5, rtol=5e-5),
       "bfloat16": dict(atol=0.15, rtol=0.0)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _moe_cfg(case, module):
    _, E, K, f, shared, cf, scoring, _, _ = case
    return module.MoEConfig(d_model=D, n_experts=E, top_k=K, d_ff_expert=f,
                            n_shared=shared, d_ff_shared=0,
                            capacity_factor=cf, router_scoring=scoring)


@functools.lru_cache(maxsize=None)
def _moe_run(label, dtype):
    case = next(c for c in MOE_CASES if c[0] == label)
    B, S = case[-2:]
    jc = _moe_cfg(case, JL)
    jp = JL.init_moe(jax.random.PRNGKey(1), jc, JDT[dtype])
    x = np.random.default_rng(2).standard_normal((B, S, D)).astype(np.float32)
    jx = jnp.asarray(x).astype(JDT[dtype])
    jout, jaux = jax.jit(lambda p, v: JL.moe(p, v, jc))(jp, jx)
    router = jnp.einsum("td,de->te", jx.reshape(B * S, D).astype(jnp.float32),
                        jp["router"]["w"])
    scores = (jax.nn.sigmoid(router) if jc.router_scoring == "sigmoid"
              else jax.nn.softmax(router, axis=-1))
    jidx = np.asarray(jax.lax.top_k(scores, jc.top_k)[1])

    tc = _moe_cfg(case, TL)
    tp = to_torch_params(jp)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with TL.record_routing() as log:
        tout, taux = TL.moe(tp, tx, tc)
    return dict(jout=_np(jout), jaux=float(jaux), jidx=jidx,
                tout=_np(tout), taux=float(taux), log=log, tx=tx, tp=tp,
                tc=tc, tout_raw=tout)


def _dropped(idx: np.ndarray, E: int, C: int) -> int:
    """Pairs past capacity, counted in flattened (token, k) order."""
    seen = np.zeros(E, np.int64)
    dropped = 0
    for e in idx.reshape(-1):
        dropped += seen[e] >= C
        seen[e] += 1
    return int(dropped)


@pytest.mark.parametrize("label", [c[0] for c in MOE_CASES])
def test_moe_matches_jax(label):
    out = _moe_run(label, "float32")
    assert out["tout"].shape == out["jout"].shape
    np.testing.assert_allclose(out["tout"], out["jout"], **TOL["float32"])
    assert math.isclose(out["taux"], out["jaux"], rel_tol=1e-5, abs_tol=1e-9)


@pytest.mark.parametrize("label", [c[0] for c in MOE_CASES])
def test_moe_routes_and_drops_as_jax(label):
    """The same top-k experts per token, the capacity of the reference's
    formula, and the dropped pairs its exclusive cumsum implies."""
    out = _moe_run(label, "float32")
    case = next(c for c in MOE_CASES if c[0] == label)
    _, E, K, _, _, cf, _, B, S = case
    (rec,) = out["log"]
    np.testing.assert_array_equal(rec["topk_idx"].numpy(), out["jidx"])
    C = max(int(math.ceil(K * B * S / E * cf)), 1)
    assert rec["capacity"] == C and rec["pairs"] == B * S * K
    assert int(rec["dropped"]) == _dropped(out["jidx"], E, C)
    if label in ("drops", "decode_c1"):
        assert int(rec["dropped"]) > 0
    if label == "decode_c1":
        assert C == 1           # deepseek-v2-lite's decode at batch 8


def test_moe_bf16_matches_jax():
    out = _moe_run("softmax_shared", "bfloat16")
    np.testing.assert_allclose(out["tout"], out["jout"], **TOL["bfloat16"])
    assert math.isclose(out["taux"], out["jaux"], rel_tol=1e-3)


@pytest.mark.parametrize("label", ["drops", "decode_c1"])
def test_moe_is_bitwise_repeatable(label):
    """Dispatch is an index write to unique slots and the combine sums
    in a fixed k order, so two calls give the same bits."""
    out = _moe_run(label, "float32")
    again, aux = TL.moe(out["tp"], out["tx"], out["tc"])
    assert torch.equal(again, out["tout_raw"])
    assert float(aux) == out["taux"]


def test_init_moe_tree_matches_jax():
    """The same leaves (paths, shapes, dtypes): an f32 router under bf16
    params, and shared experts without adapters."""
    jc = _moe_cfg(MOE_CASES[1], JL)
    jp = JL.init_moe(jax.random.PRNGKey(0), jc, jnp.bfloat16)
    tp = TL.init_moe(torch.Generator().manual_seed(0),
                     _moe_cfg(MOE_CASES[1], TL), torch.bfloat16)
    jleaves = jax.tree_util.tree_flatten_with_path(jax_numpy_params(jp))[0]
    from repro_torch.utils.tree_math import tree_leaves, tree_paths
    assert ["/".join(k.key for k in path) for path, _ in jleaves] == \
        tree_paths(tp)
    for (_, j), t in zip(jleaves, tree_leaves(tp)):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).replace("torch.", "")
    assert tp["router"]["w"].dtype == torch.float32
    assert "lora_a" not in tp["shared"]["w_up"]


# --- MLA ---------------------------------------------------------------------

MLA_CASES = {"v2_lite": None, "v3_q_lora": 24}
B, S, STEPS = 2, 10, 3


def _mla_cfg(module, q_lora_rank):
    return module.MLAConfig(d_model=D, n_heads=4, kv_lora_rank=16,
                            q_lora_rank=q_lora_rank, qk_nope_dim=8,
                            qk_rope_dim=4, v_head_dim=8)


@functools.lru_cache(maxsize=None)
def _mla_run(label, dtype):
    """Both packages: a full-sequence call, a prefill of S positions into
    a cache of S + STEPS, then STEPS one-position calls."""
    q_lora = MLA_CASES[label]
    jc, tc = _mla_cfg(JL, q_lora), _mla_cfg(TL, q_lora)
    jp = JL.init_mla(jax.random.PRNGKey(3), jc, JDT[dtype])
    tp = to_torch_params(jp)
    x = np.random.default_rng(4).standard_normal(
        (B, S + STEPS, D)).astype(np.float32)
    jdt, tdt = JDT[dtype], getattr(torch, dtype)
    T = S + STEPS
    out = {"jax": {}, "torch": {}}

    jfn = jax.jit(lambda p, v, pos, c, n: JL.mla_attention(
        p, v, jc, pos, kv_cache=c, cache_len=n))
    jfull = jax.jit(lambda p, v, pos: JL.mla_attention(p, v, jc, pos))
    jx = jnp.asarray(x).astype(jdt)
    o, _ = jfull(jp, jx[:, :S], jnp.arange(S))
    out["jax"]["full"] = _np(o)
    cache = (jnp.zeros((B, T, jc.kv_lora_rank), jdt),
             jnp.zeros((B, T, jc.qk_rope_dim), jdt))
    o, cache = jfn(jp, jx[:, :S], jnp.arange(S), cache, jnp.int32(0))
    steps = [_np(o)]
    for i in range(STEPS):
        o, cache = jfn(jp, jx[:, S + i:S + i + 1],
                       jnp.arange(S + i, S + i + 1), cache, jnp.int32(S + i))
        steps.append(_np(o))
    out["jax"]["steps"], out["jax"]["cache"] = steps, [_np(c) for c in cache]

    tx = torch.from_numpy(x).to(tdt)
    o, _ = TL.mla_attention(tp, tx[:, :S], tc, torch.arange(S))
    out["torch"]["full"] = _np(o)
    cache = (torch.zeros(B, T, tc.kv_lora_rank, dtype=tdt),
             torch.zeros(B, T, tc.qk_rope_dim, dtype=tdt))
    o, cache2 = TL.mla_attention(tp, tx[:, :S], tc, torch.arange(S),
                                 kv_cache=cache, cache_len=0)
    assert cache2[0] is cache[0] and cache2[1] is cache[1]   # in place
    steps = [_np(o)]
    for i in range(STEPS):
        o, cache = TL.mla_attention(tp, tx[:, S + i:S + i + 1], tc,
                                    torch.arange(S + i, S + i + 1),
                                    kv_cache=cache, cache_len=S + i)
        steps.append(_np(o))
    out["torch"]["steps"] = steps
    out["torch"]["cache"] = [_np(c) for c in cache]
    return out


@pytest.mark.parametrize("label", list(MLA_CASES))
def test_mla_matches_jax(label):
    out = _mla_run(label, "float32")
    np.testing.assert_allclose(out["torch"]["full"], out["jax"]["full"],
                               **TOL["float32"])
    for got, want in zip(out["torch"]["steps"], out["jax"]["steps"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL["float32"])
    for got, want in zip(out["torch"]["cache"], out["jax"]["cache"]):
        np.testing.assert_allclose(got, want, **TOL["float32"])
    # the prefill through the cache equals the full-sequence call
    np.testing.assert_allclose(out["torch"]["steps"][0],
                               out["torch"]["full"], atol=1e-6, rtol=1e-6)


def test_mla_bf16_matches_jax():
    out = _mla_run("v3_q_lora", "bfloat16")
    for got, want in zip(out["torch"]["steps"], out["jax"]["steps"]):
        np.testing.assert_allclose(got, want, **TOL["bfloat16"])


def test_mla_rejects_a_cache_overrun():
    tc = _mla_cfg(TL, None)
    tp = TL.init_mla(torch.Generator().manual_seed(0), tc)
    cache = (torch.zeros(1, 4, tc.kv_lora_rank),
             torch.zeros(1, 4, tc.qk_rope_dim))
    x = torch.zeros(1, 1, D)
    with pytest.raises(ValueError):
        TL.mla_attention(tp, x, tc, torch.arange(4, 5), kv_cache=cache,
                         cache_len=4)
