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

import dataclasses
import hashlib
import math
from typing import Any, Optional, Sequence, Tuple

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
              cache_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence (train/prefill) or incremental (decode) attention.

    kv_cache: (k_cache, v_cache) of shape (B, T_max, KH, hd).  When given,
    the new k/v are written into it IN PLACE at ``cache_len`` (a host
    int) and attention runs over the whole cache; the returned cache is
    the same pair of tensors.  Returns (out, cache).
    """
    B, S, d = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
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
    return linear(p["wo"], out), new_cache


# ---------------------------------------------------------------------------
# MLP
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


def mlp(p: Pytree, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    return linear(p["w_down"],
                  F.silu(linear(p["w_gate"], x)) * linear(p["w_up"], x))
