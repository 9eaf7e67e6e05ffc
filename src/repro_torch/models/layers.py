"""Core layers (the counterpart of ``repro/models/layers.py``): init/apply
pairs over nested-dict params with the JAX package's layout.

Conventions, as in the JAX package: params are nested dicts of tensors;
``init_*`` draws from a ``torch.Generator`` (on the device the params
live on) and returns params; the apply functions are plain functions on
tensors; params stay in their dtype and activations run in ``x``'s dtype
with f32 normalisation and softmax.  Linear weights are ``(d_in,
d_out)``.

The draws differ from ``jax.random``'s for the same seed; tests that
compare the two packages carry the JAX package's weights across with
``repro_torch.bridge.params_from_numpy``.  ``gen=None`` draws nothing
and returns tensors on the ``meta`` device, which is how parameter
counts are taken without allocating.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Pytree = Any
FULL_WINDOW = 2 ** 30


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _randn(gen: Optional[torch.Generator], shape: Sequence[int]) -> torch.Tensor:
    if gen is None:
        return torch.empty(tuple(shape), device="meta")
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def _rand(gen: Optional[torch.Generator], shape: Sequence[int]) -> torch.Tensor:
    if gen is None:
        return torch.empty(tuple(shape), device="meta")
    return torch.rand(tuple(shape), generator=gen, device=gen.device)


def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    return torch.device("meta") if gen is None else gen.device


def he_normal(gen: Optional[torch.Generator], shape: Sequence[int],
              dtype=torch.float32, fan_in: Optional[int] = None
              ) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    std = math.sqrt(2.0 / max(fan, 1))
    return (_randn(gen, shape) * std).to(dtype)


def normal_init(gen: Optional[torch.Generator], shape: Sequence[int],
                std=0.02, dtype=torch.float32) -> torch.Tensor:
    return (_randn(gen, shape) * std).to(dtype)


# ---------------------------------------------------------------------------
# linear / norm
# ---------------------------------------------------------------------------

def init_linear(gen, d_in: int, d_out: int, bias: bool = False,
                dtype=torch.float32, std: Optional[float] = None,
                lora_rank: int = 0) -> Pytree:
    """Plain linear, or — with ``lora_rank > 0`` — a LoRA-adapted linear
    (see :func:`init_lora_linear`)."""
    if lora_rank:
        return init_lora_linear(gen, d_in, d_out, lora_rank, bias=bias,
                                dtype=dtype, std=std)
    p = {"w": normal_init(gen, (d_in, d_out),
                          std=std if std is not None else d_in ** -0.5,
                          dtype=dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen_device(gen))
    return p


# LoRA (Hu et al. 2106.09685): y = x·W + (α/r)·x·A·B with A (d_in, r)
# normal-init and B (r, d_out) zero-init, so the adapted model starts
# exactly at the base model.  Only A and B train under the "lora"
# trainable filter (repro_torch.sharding.rules.TRAINABLE_FILTERS).
LORA_ALPHA = 16.0


def lora_scale(rank: int) -> float:
    return LORA_ALPHA / rank


def _side_generator(gen: torch.Generator) -> torch.Generator:
    """A generator on ``gen``'s device seeded from ``gen``'s current
    state, which it leaves as it was: the adapter draws come from it, so
    adding adapters changes no base draw of the model."""
    state = gen.get_state().numpy().tobytes()
    seed = int.from_bytes(hashlib.blake2b(state, digest_size=8).digest(),
                          "little") >> 1
    side = torch.Generator(device=gen.device)
    side.manual_seed(seed)
    return side


def init_lora_linear(gen, d_in: int, d_out: int, rank: int,
                     bias: bool = False, dtype=torch.float32,
                     std: Optional[float] = None) -> Pytree:
    """LoRA-adapted linear: the base ``w`` (and optional ``b``) drawn
    exactly as :func:`init_linear` draws them, plus ``lora_a`` (normal,
    std d_in^-0.5, from a side generator) and ``lora_b`` (zeros), so the
    adapted forward at init equals the base forward bitwise."""
    if rank <= 0:
        raise ValueError(f"lora rank must be a positive integer, got {rank}")
    side = None if gen is None else _side_generator(gen)
    p = init_linear(gen, d_in, d_out, bias=bias, dtype=dtype, std=std)
    p["lora_a"] = normal_init(side, (d_in, rank), std=d_in ** -0.5,
                              dtype=dtype)
    p["lora_b"] = torch.zeros((rank, d_out), dtype=dtype,
                              device=gen_device(gen))
    return p


def linear(p: Pytree, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x·w``, then the adapter term ``(α/r)·(x·A)·B``, then the bias —
    the JAX package's order of operations."""
    dtype = dtype or x.dtype
    y = torch.matmul(x, p["w"].to(dtype))
    if "lora_a" in p:
        a, b = p["lora_a"].to(dtype), p["lora_b"].to(dtype)
        z = torch.matmul(x, a)
        y = y + lora_scale(a.shape[-1]) * torch.matmul(z, b)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def merge_lora(p: Pytree) -> Pytree:
    """Fold each LoRA adapter into its base weight — ``W + (α/r)·A·B`` in
    f32, cast back to W's dtype — giving plain linears; recurses through
    nested dicts, so it merges a whole model tree."""
    if not isinstance(p, dict):
        return p
    if "lora_a" in p:
        a, b = p["lora_a"].float(), p["lora_b"].float()
        w = p["w"].float() + lora_scale(a.shape[-1]) * (a @ b)
        out = {k: v for k, v in p.items() if k not in ("lora_a", "lora_b")}
        out["w"] = w.to(p["w"].dtype)
        return out
    return {k: merge_lora(v) for k, v in p.items()}


def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> Pytree:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: Pytree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd) or (B, S, hd); positions: (S,)."""
    if positions.dim() != 1:
        raise ValueError(f"positions must be 1-D, got {tuple(positions.shape)}")
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[:, None].float() * freqs               # (S, hd/2)
    if x.dim() == 4:
        angles = angles[:, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm / qkv-bias / sliding window)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding window; None = full causal
    attn_impl: str = "xla"  # xla | pallas | pallas_interpret
    lora_rank: int = 0


def init_attention(gen, cfg: AttnConfig, dtype=torch.float32) -> Pytree:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    r = cfg.lora_rank
    p = {
        "wq": init_linear(gen, d, H * hd, bias=cfg.qkv_bias, dtype=dtype,
                          lora_rank=r),
        "wk": init_linear(gen, d, KH * hd, bias=cfg.qkv_bias, dtype=dtype,
                          lora_rank=r),
        "wv": init_linear(gen, d, KH * hd, bias=cfg.qkv_bias, dtype=dtype,
                          lora_rank=r),
        "wo": init_linear(gen, H * hd, d, bias=False, dtype=dtype,
                          lora_rank=r),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, gen_device(gen))
        p["k_norm"] = init_rmsnorm(hd, dtype, gen_device(gen))
    return p


def _sdpa(q, k, v, *, causal: bool, window: Optional[int], q_offset: int,
          impl: str = "xla") -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KH, hd); GQA broadcast inside.
    ``q_offset`` is the position of q[0] relative to k[0] (decode)."""
    if impl in ("pallas", "pallas_interpret"):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            # as in the JAX package: the attention kernel has no backward,
            # and training runs the plain attention (attn_impl="xla")
            raise NotImplementedError(
                f"attn_impl={impl!r} has no backward; train with "
                f"attn_impl='xla'")
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset,
                                    interpret=(impl == "pallas_interpret"))
    if impl != "xla":
        raise ValueError(f"unknown attn_impl {impl!r}")
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, S, KH, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * hd ** -0.5
    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention(p: Pytree, x: torch.Tensor, cfg: AttnConfig,
              positions: torch.Tensor,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_len: Optional[int] = None, tp=None, row_extra=None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence (train/prefill) or incremental (decode) attention.

    kv_cache: (k_cache, v_cache) of shape (B, T_max, KH, hd).  When given,
    the new k/v are written into it IN PLACE at ``cache_len`` (a host
    int) and attention runs over the whole cache; the returned cache is
    the same pair of tensors.  Returns (out, cache).

    ``tp`` (a ``sharding.tensor_parallel.TPContext`` whose plan splits
    the heads) computes this rank's q heads and the kv heads they read
    (a cache holds those kv heads only): q, k and v column-parallel (kv
    heads that do not split: the rank's columns of ``wk``/``wv``
    gathered whole, or where |model| does not divide their width the
    whole projections' columns of the rank's kv head), the qkv biases
    and ``qk_norm`` on the local heads, ``wo`` row-parallel
    (``row_extra``, another partial output of the rank, reduced with
    it).
    """
    B, S, d = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if tp is not None and tp.plan.attn:
        from repro_torch.sharding import tensor_parallel as tpl
        H, (lo, KH) = tp.heads, tp.kv_range
        xc = tpl.copy_to_model(x, tp)
        cols = None if tp.plan.kv else slice(lo * hd, (lo + KH) * hd)
        q = tpl.column_linear(p["wq"], x, xc, tp).reshape(B, S, H, hd)

        def kv(w):
            if not tp.plan.kv_cols:
                return tpl.column_linear(w, x, xc, tp, cols)
            # the rank's columns, gathered whole, then its kv head
            y = tpl.gather_from_model(tpl.column_linear(w, x, xc, tp), tp)
            return tpl.copy_to_model(y, tp)[..., cols]
        k = kv(p["wk"]).reshape(B, S, KH, hd)
        v = kv(p["wv"]).reshape(B, S, KH, hd)
    else:
        q = linear(p["wq"], x).reshape(B, S, H, hd)
        k = linear(p["wk"], x).reshape(B, S, KH, hd)
        v = linear(p["wv"], x).reshape(B, S, KH, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        out = _sdpa(q, k, v, causal=True, window=cfg.window, q_offset=0,
                    impl=cfg.attn_impl)
        new_cache = (k, v)
    else:
        kc, vc = kv_cache
        if not 0 <= cache_len <= kc.shape[1] - S:
            raise ValueError(f"cache_len {cache_len} + {S} new positions "
                             f"exceed the cache's {kc.shape[1]}")
        kc[:, cache_len:cache_len + S] = k.to(kc.dtype)
        vc[:, cache_len:cache_len + S] = v.to(vc.dtype)
        out = _sdpa(q, kc, vc, causal=True, window=cfg.window,
                    q_offset=cache_len, impl=cfg.attn_impl)
        new_cache = (kc, vc)
    out = out.reshape(B, S, H * hd)
    if tp is not None and tp.plan.attn:
        return tpl.row_linear(p["wo"], out, tp, extra=row_extra), new_cache
    return linear(p["wo"], out), new_cache


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int           # 512
    q_lora_rank: Optional[int]  # None (v2-lite) or 1536 (v3)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0


def init_mla(gen, cfg: MLAConfig, dtype=torch.float32) -> Pytree:
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = init_linear(gen, d, cfg.q_lora_rank, dtype=dtype)
        p["q_a_norm"] = init_rmsnorm(cfg.q_lora_rank, dtype, gen_device(gen))
        p["wq_b"] = init_linear(gen, cfg.q_lora_rank, H * qk_dim, dtype=dtype)
    else:
        p["wq"] = init_linear(gen, d, H * qk_dim, dtype=dtype)
    # joint KV compression + decoupled rope key
    p["wkv_a"] = init_linear(gen, d, cfg.kv_lora_rank + cfg.qk_rope_dim,
                             dtype=dtype)
    p["kv_a_norm"] = init_rmsnorm(cfg.kv_lora_rank, dtype, gen_device(gen))
    p["wkv_b"] = init_linear(gen, cfg.kv_lora_rank,
                             H * (cfg.qk_nope_dim + cfg.v_head_dim),
                             dtype=dtype)
    p["wo"] = init_linear(gen, H * cfg.v_head_dim, d, dtype=dtype)
    return p


def mla_attention(p: Pytree, x: torch.Tensor, cfg: MLAConfig,
                  positions: torch.Tensor,
                  kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  cache_len: Optional[int] = None, tp=None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """MLA with a latent cache: it holds (c_kv, k_rope) only, (B, T,
    kv_lora_rank) + (B, T, qk_rope_dim), written IN PLACE at the host int
    ``cache_len`` as :func:`attention` writes its k/v.  ``wkv_b`` expands
    the whole cache to per-head keys and values on every call; the
    logits are f32 under the causal mask alone.  Returns (out, cache).

    ``tp`` (a ``sharding.tensor_parallel.TPContext`` whose plan splits
    the heads) computes this rank's heads: ``wq`` (or ``wq_b``) and
    ``wkv_b`` column-parallel, ``wo`` row-parallel; the latent
    projections ``wq_a`` and ``wkv_a`` column-parallel too, their
    columns gathered whole (``gather_from_model``), as XLA's partitioner
    splits them; the latents' norms and the cache are whole on every
    rank, and the latents (the q latent, ``c_kv``, ``k_rope``) pass
    ``copy_to_model``, so their gradients sum the ranks' heads once."""
    B, S, d = x.shape
    H, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    split = tp is not None and tp.plan.attn
    if split:
        from repro_torch.sharding import tensor_parallel as tpl
        # every linear of x is column-parallel: its gradient sums the
        # ranks' columns once
        H, x = tp.heads, tpl.copy_to_model(x, tp)

    def latent(w):                      # column-parallel, gathered whole
        y = linear(w, x)
        return tpl.gather_from_model(y, tp) if split else y
    if cfg.q_lora_rank:
        q = rmsnorm(p["q_a_norm"], latent(p["wq_a"]))
        q = linear(p["wq_b"], tpl.copy_to_model(q, tp) if split else q)
    else:
        q = linear(p["wq"], x)
    q_nope, q_rope = q.reshape(B, S, H, nope + rope).split([nope, rope], -1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv, k_rope = latent(p["wkv_a"]).split([cfg.kv_lora_rank, rope], -1)
    c_kv = rmsnorm(p["kv_a_norm"], c_kv)                     # (B, S, r)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)  # shared by heads
    if split:
        c_kv, k_rope = tpl.copy_to_model(c_kv, tp), \
            tpl.copy_to_model(k_rope, tp)

    if kv_cache is not None:
        cc, kr = kv_cache
        if not 0 <= cache_len <= cc.shape[1] - S:
            raise ValueError(f"cache_len {cache_len} + {S} new positions "
                             f"exceed the cache's {cc.shape[1]}")
        cc[:, cache_len:cache_len + S] = c_kv.to(cc.dtype)
        kr[:, cache_len:cache_len + S] = k_rope.to(kr.dtype)
        c_kv, k_rope, q_offset, new_cache = cc, kr, cache_len, (cc, kr)
    else:
        q_offset, new_cache = 0, (c_kv, k_rope)

    T = c_kv.shape[1]
    kv = linear(p["wkv_b"], c_kv).reshape(B, T, H, nope + cfg.v_head_dim)
    k_nope, v = kv.split([nope, cfg.v_head_dim], -1)
    # (q_nope·k_nope + q_rope·k_rope) * scale, masked, in place: at
    # deepseek-v2-lite's prefill each (B, H, S, T) f32 copy is 2.2 GB
    logits = torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
    logits.add_(torch.einsum("bshd,btd->bhst", q_rope.float(),
                             k_rope.float()))
    logits.mul_((nope + rope) ** -0.5)
    qpos = q_offset + torch.arange(S, device=x.device)
    mask = torch.arange(T, device=x.device)[None, :] <= qpos[:, None]
    logits.masked_fill_(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    out = out.reshape(B, S, H * cfg.v_head_dim).to(x.dtype)
    if split:
        return tpl.row_linear(p["wo"], out, tp), new_cache
    return linear(p["wo"], out), new_cache


# ---------------------------------------------------------------------------
# MLPs and MoE
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, dtype=torch.float32,
             lora_rank: int = 0) -> Pytree:
    return {
        "w_gate": init_linear(gen, d_model, d_ff, dtype=dtype,
                              lora_rank=lora_rank),
        "w_up": init_linear(gen, d_model, d_ff, dtype=dtype,
                            lora_rank=lora_rank),
        "w_down": init_linear(gen, d_ff, d_model, dtype=dtype,
                              lora_rank=lora_rank),
    }


def mlp(p: Pytree, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU MLP; with ``tp`` whose plan splits the MLP, ``w_gate`` and
    ``w_up`` column-parallel and ``w_down`` row-parallel."""
    if tp is not None and tp.plan.mlp:
        from repro_torch.sharding import tensor_parallel as tpl
        xc = tpl.copy_to_model(x, tp)
        h = F.silu(tpl.column_linear(p["w_gate"], x, xc, tp)) * \
            tpl.column_linear(p["w_up"], x, xc, tp)
        return tpl.row_linear(p["w_down"], h, tp)
    return linear(p["w_down"],
                  F.silu(linear(p["w_gate"], x)) * linear(p["w_up"], x))


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_scoring: str = "softmax"  # softmax (v2) | sigmoid (v3)
    aux_loss_coef: float = 0.001
    routed_scaling: float = 1.0


def init_moe(gen, cfg: MoEConfig, dtype=torch.float32) -> Pytree:
    """The router in f32 whatever ``dtype``; the experts' SwiGLU weights
    stacked over a leading expert axis; the shared experts a plain MLP
    (no LoRA, as in the JAX package)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    std = d ** -0.5
    p = {
        "router": {"w": normal_init(gen, (d, E), std=std)},
        "experts": {
            "w_gate": normal_init(gen, (E, d, f), std=std, dtype=dtype),
            "w_up": normal_init(gen, (E, d, f), std=std, dtype=dtype),
            "w_down": normal_init(gen, (E, f, d), std=f ** -0.5, dtype=dtype),
        },
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, d, cfg.d_ff_shared
                               or cfg.d_ff_expert * cfg.n_shared, dtype=dtype)
    return p


# Set by ``record_routing``: each ``moe`` call appends its routing there.
_ROUTING_LOG: Optional[List[Dict[str, Any]]] = None


@contextlib.contextmanager
def record_routing() -> Iterator[List[Dict[str, Any]]]:
    """Within the block, every ``moe`` call appends ``{"topk_idx" (T, K),
    "dropped" (a 0-d count of routed pairs past capacity), "capacity",
    "pairs"}`` to the yielded list: device tensors, read by the caller
    after the run, so the calls wait on nothing."""
    global _ROUTING_LOG
    prev, _ROUTING_LOG = _ROUTING_LOG, []
    try:
        yield _ROUTING_LOG
    finally:
        _ROUTING_LOG = prev


def moe(p: Pytree, x: torch.Tensor, cfg: MoEConfig, tp=None, group=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE, the JAX package's semantics: f32 router
    logits; softmax or sigmoid scores; the top-k weights normalised by
    ``sum + 1e-20`` and times ``routed_scaling``; the aux loss from the
    softmax probabilities and the top-1 choice whatever the scoring.
    Each expert takes ``C = max(ceil(K·T/E · capacity_factor), 1)``
    slots, filled in token-major (token, k) order; a pair past them is
    dropped.  Returns (out, aux_loss).

    The kept slots are unique, so dispatch is a plain index write (the
    dropped pairs all go to one spare row, which nothing reads), and the
    combine sums each token's K weighted rows in k order: no atomics,
    so two calls on the same input give the same bits.

    ``tp`` (a ``sharding.tensor_parallel.TPContext``) whose plan splits
    the experts: the rank computes its ``n_experts/|model|`` experts and
    its columns of the shared experts (row-parallel ``w_down``); the two
    partial outputs sum, then one :func:`reduce_from_model`.  The
    dispatch input and the combine weights pass :func:`copy_to_model`,
    so the input's and the router's gradients sum the ranks' experts
    once; the router is whole and routes alike on every rank.

    ``group`` (a ``sharding.batch_group.BatchGroup`` of n ranks, each
    with its rows of the batch): the whole batch's MoE, as on the JAX
    pod, whose batch is one global array.  The aux loss's top-1 counts
    and probability sums add over the group; C is that of the group's
    T·n tokens; a pair's slot is its slot among the rank's pairs plus
    the pairs the earlier ranks (row-major, the batch's row order) sent
    to its expert, so the kept pairs are the whole batch's first C of
    each expert.  The ``(E, C_pad, d)`` buffer (C rounded up to a
    multiple of n; a padded slot is never kept) is reduce-scattered
    along the slots, the experts run on the rank's ``C_pad/n`` slots,
    and their output is all-gathered back: the expert GEMMs split n
    ways, as XLA's partitioner splits them.

    Without either, the function is the one-rank MoE, bit for bit."""
    if tp is not None and not tp.plan.experts:
        tp = None
    if tp is not None or group is not None:
        from repro_torch.sharding import batch_group as bgl
        from repro_torch.sharding import tensor_parallel as tpl
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, K = cfg.n_experts, cfg.top_k
    n = 1 if group is None else group.size

    router_logits = torch.matmul(xt.float(), p["router"]["w"].float())
    probs = torch.softmax(router_logits, dim=-1)
    scores = torch.sigmoid(router_logits) \
        if cfg.router_scoring == "sigmoid" else probs
    topk_scores, topk_idx = torch.topk(scores, K, dim=-1)       # (T, K)
    topk_w = topk_scores / (topk_scores.sum(-1, keepdim=True) + 1e-20)
    topk_w = topk_w * cfg.routed_scaling

    # load-balance aux loss (Switch-style)
    # (the top-1 share of each expert: a one-hot mean, counted at a fixed
    # shape so that no device validates the indices on the host)
    top1 = topk_idx[:, 0]
    top1_counts = torch.zeros(E, dtype=torch.float32, device=x.device
                              ).scatter_add_(0, top1, torch.ones(
                                  top1.shape, dtype=torch.float32,
                                  device=x.device))
    if group is None:
        frac_tokens, mean_probs = top1_counts / T, probs.mean(0)
    else:
        sums = bgl.batch_sum(torch.cat([top1_counts, probs.sum(0)]), group)
        frac_tokens, mean_probs = (sums / (T * n)).split(E)
    aux = cfg.aux_loss_coef * E * torch.sum(frac_tokens * mean_probs)

    # capacity dispatch: a pair's slot is the number of pairs before it
    # (in flattened (token, k) order) routed to the same expert — its
    # rank in a stable sort by expert, less its expert's first position
    C = max(int(math.ceil(K * T * n / E * cfg.capacity_factor)), 1)
    Cp = -(-C // n) * n
    flat_e = topk_idx.reshape(-1)                               # (T*K,)
    order = torch.sort(flat_e, stable=True).indices
    # the per-expert counts at a fixed shape (E,): a bincount's shape
    # would depend on the data, which a fake-tensor capture cannot follow
    counts = torch.zeros(E, dtype=flat_e.dtype, device=x.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(T * K, device=x.device) - first[flat_e[order]]
    slot = torch.empty_like(rank).scatter_(0, order, rank)
    if group is not None:       # plus the earlier ranks' pairs
        slot = slot + bgl.gather_counts(counts, group)[:group.index].sum(
            0)[flat_e]
    keep = slot < C
    # this rank's experts: a pair routed elsewhere goes to the spare row
    lo, El = tp.expert_range if tp is not None else (0, E)
    mine = keep & (flat_e >= lo) & (flat_e < lo + El) \
        if tp is not None else keep
    dst = torch.where(mine, (flat_e - lo) * Cp + slot, El * Cp)
    token = torch.arange(T, device=x.device).repeat_interleave(K)
    xc = tpl.copy_to_model(xt, tp) if tp is not None else xt
    buf = xc.new_zeros(El * Cp + 1, d)
    buf[dst] = xc[token]
    h = buf[:El * Cp].view(El, Cp, d)
    if group is not None:       # the rank's C_pad/n slots of the sum
        h = bgl.scatter_slots(h, group)

    # expert computation: batched SwiGLU GEMMs over (E, C, d)
    w = p["experts"]
    y = torch.bmm(F.silu(torch.bmm(h, w["w_gate"].to(x.dtype)))
                  * torch.bmm(h, w["w_up"].to(x.dtype)),
                  w["w_down"].to(x.dtype))
    if group is not None:
        y = bgl.gather_slots(y, group)

    # combine: each pair's row (zero when dropped) times its weight, the
    # K of a token summed in k order
    y = torch.cat([y.reshape(El * Cp, d), y.new_zeros(1, d)])
    wk = tpl.copy_to_model(topk_w, tp) if tp is not None else topk_w
    gathered = (y[dst] * wk.reshape(-1, 1).to(x.dtype)).view(T, K, d)
    out = gathered[:, 0]
    for k in range(1, K):
        out = out + gathered[:, k]

    if _ROUTING_LOG is not None:
        _ROUTING_LOG.append({"topk_idx": topk_idx, "dropped": (~keep).sum(),
                             "capacity": C, "pairs": T * K})
    if tp is not None:
        if cfg.n_shared:
            sp = p["shared"]
            hs = F.silu(linear(sp["w_gate"], xc)) * linear(sp["w_up"], xc)
            out = out + linear(sp["w_down"], hs)
        out = tpl.reduce_from_model(out, tp)
    elif cfg.n_shared:
        out = out + mlp(p["shared"], xt)
    return out.reshape(B, S, d), aux
