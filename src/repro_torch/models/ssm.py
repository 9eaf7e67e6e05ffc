"""Mamba2 (SSD) layer (the counterpart of ``repro/models/ssm.py``).

Layer I/O follows mamba_ssm.Mamba2, as in the JAX package: one input
projection producing (z, x, B, C, dt), a short depthwise causal conv over
(x, B, C), the SSD core, a gated RMSNorm and an output projection.  The
SSD core over a whole sequence is ``ssd_chunked`` (``ssd_impl="xla"``)
or the K8 kernel through ``kernels/ops.py`` (``"pallas"``: the CUDA
kernel on a CUDA tensor; ``"pallas_interpret"``: its plain version).
Single-token decode (``ssm_decode_step``) is a plain recurrence, as in
the JAX package.

Tensor parallelism (``tp``: a ``sharding.tensor_parallel.TPContext``
whose plan splits the SSM heads; None leaves the whole layer): the
in-projection is column-parallel on the rank's tile of ``in_proj`` (the
rules' columns of the packed z, x, B, C, dt), its output all-gathered;
the rank takes z, x and dt of its heads and all of B and C (one group);
the conv runs over its x channels and every B, C channel (the whole
``conv_w``, ``conv_b``); the SSD core on its heads (``A``, ``D``,
``dt_bias`` sliced); the gated RMSNorm over the whole ``d_inner``
(``rmsnorm_over_model``); ``out_proj`` row-parallel on the rank's rows
(the leaf is whole: the rules shard its ``d_model`` columns).  The decode state
holds the rank's heads and conv channels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ssd_ref as ssd_reference  # noqa: F401
from repro_torch.models.layers import (
    _rand, gen_device, init_linear, init_rmsnorm, linear, normal_init,
    rmsnorm)
from repro_torch.sharding import tensor_parallel as tpl

Pytree = Any


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128
    ssd_impl: str = "xla"  # xla | pallas | pallas_interpret
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's softplus turns
    linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_ssm(gen, cfg: SSMConfig, dtype=torch.float32) -> Pytree:
    dev = gen_device(gen)
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    p = {"in_proj": init_linear(gen, cfg.d_model, d_in_proj, dtype=dtype),
         "conv_w": normal_init(gen, (cfg.d_conv, cfg.conv_dim),
                               std=cfg.d_conv ** -0.5, dtype=dtype),
         "conv_b": torch.zeros(cfg.conv_dim, dtype=dtype, device=dev),
         "A_log": torch.log(torch.linspace(1.0, 16.0, cfg.n_heads,
                                           device=dev)).float(),
         "D": torch.ones(cfg.n_heads, dtype=torch.float32, device=dev)}
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    u = _rand(gen, (cfg.n_heads,)) * (hi - lo) + lo
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(u))).float()
    p["out_norm"] = init_rmsnorm(cfg.d_inner, dtype, dev)
    p["out_proj"] = init_linear(gen, cfg.d_inner, cfg.d_model, dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# SSD core (chunked, plain torch: the "xla" path)
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None,
                return_final_state: bool = False):
    """SSD over a full sequence, every chunk at once and a short loop
    over the chunk states.  x (b, s, h, p); dt (b, s, h) positive; A (h,)
    negative; B/C (b, s, g, n).  Returns y (b, s, h, p) and optionally
    the final state (b, h, p, n) f32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).float()
    Cc = C.reshape(b, nc, chunk, g, n).float()
    hpg = h // g

    dA = dtc * A[None, None, None, :]
    dA_cum = torch.cumsum(dA, dim=2)
    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j.  The mask
    # goes in before the exp: above the diagonal cum_i - cum_j > 0 can
    # overflow (a 128-token chunk at full width), and exp's inf there,
    # though the forward drops it, would make the backward's 0·inf NaN
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]   # (b,nc,l,l,h)
    li = torch.arange(chunk, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    Lmat = torch.exp(torch.where(causal, seg, -torch.inf))
    CB = torch.einsum("bclgn,bcmgn->bclmg", Cc, Bc)
    CB = CB.repeat_interleave(hpg, dim=-1)                      # (b,nc,l,l,h)
    M = CB * Lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", M, xc)

    # chunk states
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)    # (b,nc,l,h)
    Bh = Bc.repeat_interleave(hpg, dim=3) if g != h else Bc
    weighted_x = xc * (dtc * decay_to_end)[..., None]
    states = torch.einsum("bclhn,bclhp->bchpn", Bh, weighted_x)

    # inter-chunk recurrence over the nc chunk states
    chunk_decay = torch.exp(torch.sum(dA, dim=2))               # (b, nc, h)
    carry = (torch.zeros(b, h, p, n, device=x.device) if initial_state is None
             else initial_state.float())
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                     # (b,nc,h,p,n)

    decay_from_start = torch.exp(dA_cum)
    Ch = Cc.repeat_interleave(hpg, dim=3) if g != h else Cc
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Ch, entering)
    y_inter = y_inter * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :s]
    if return_final_state:
        return y.to(x.dtype), carry
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# layer apply: full sequence and single-step decode
# ---------------------------------------------------------------------------

def _split_proj(cfg: SSMConfig, zxbcdt: torch.Tensor):
    di = cfg.d_inner
    return torch.split(zxbcdt, [di, cfg.conv_dim, zxbcdt.shape[-1] - di
                                - cfg.conv_dim], dim=-1)


def _split(tp) -> bool:
    return tp is not None and tp.plan.ssm


def local_channels(t: torch.Tensor, cfg: SSMConfig, tp) -> torch.Tensor:
    """The rank's conv channels of ``t`` ``(..., conv_dim)``: the x
    channels of its heads, then every B and C channel."""
    lo, nh = tp.ssm_range
    hd = cfg.head_dim
    return torch.cat([t[..., lo * hd:(lo + nh) * hd], t[..., cfg.d_inner:]],
                     dim=-1)


def _heads(tp):
    """The slice of the per-head vectors this rank computes."""
    if not _split(tp):
        return slice(None)
    lo, nh = tp.ssm_range
    return slice(lo, lo + nh)


def _in_proj(p: Pytree, x: torch.Tensor, cfg: SSMConfig, tp):
    """``(z, xBC, dt)`` of the layer's heads (the rank's under ``tp``: the
    whole packed projection from the gathered column-parallel GEMM, the
    copy after it summing every rank's use in the backward) and the
    conv's weight and bias over the same channels."""
    if not _split(tp):
        z, xBC, dt = _split_proj(cfg, linear(p["in_proj"], x))
        return z, xBC, dt, p["conv_w"], p["conv_b"]
    y = linear(p["in_proj"], tpl.copy_to_model(x, tp))
    z, xBC, dt = _split_proj(cfg, tpl.copy_to_model(
        tpl.gather_from_model(y, tp), tp))
    lo, nh = tp.ssm_range
    hd = cfg.head_dim
    return (z[..., lo * hd:(lo + nh) * hd], local_channels(xBC, cfg, tp),
            dt[..., lo:lo + nh], local_channels(p["conv_w"], cfg, tp),
            local_channels(p["conv_b"], cfg, tp))


def _out(p: Pytree, y: torch.Tensor, z: torch.Tensor, tp, reduce: bool):
    """The gated RMSNorm and ``out_proj``: under ``tp`` over the whole
    ``d_inner`` from the rank's heads, ``out_proj`` row-parallel on the
    rank's rows of the whole leaf (with ``reduce`` False its partial
    output: the hybrid block reduces it with the attention's;
    ``out_proj`` has no bias)."""
    if not _split(tp):
        return linear(p["out_proj"], rmsnorm(p["out_norm"], y * F.silu(z)))
    lo, n = tp.rank * y.shape[-1], y.shape[-1]
    y = tpl.rmsnorm_over_model({"scale": p["out_norm"]["scale"][lo:lo + n]},
                               y * F.silu(z), tp)
    rows = {"w": p["out_proj"]["w"][lo:lo + n]}
    if reduce:
        return tpl.row_linear(rows, y, tp)
    return linear(rows, y)


def ssm_forward(p: Pytree, x: torch.Tensor, cfg: SSMConfig,
                return_final_state: bool = False, tp=None,
                reduce: bool = True):
    """Full-sequence forward.  x: (B, S, d_model).  Under ``tp`` the
    rank's heads (the module doc); ``reduce`` False returns the rank's
    partial output, unreduced."""
    Bsz, S, _ = x.shape
    z, xBC, dt, w, b = _in_proj(p, x, cfg, tp)
    raw = xBC
    heads = _heads(tp)
    nh = dt.shape[-1]
    w = w.to(xBC.dtype)                                        # (k, conv_dim)
    pad = F.pad(xBC, (0, 0, cfg.d_conv - 1, 0))
    conv = sum(pad[:, i:i + S] * w[i] for i in range(cfg.d_conv))
    xBC = F.silu(conv + b.to(xBC.dtype))
    gn = cfg.n_groups * cfg.d_state
    xs, Bmat, Cmat = torch.split(xBC, [nh * cfg.head_dim, gn, gn], dim=-1)
    xs = xs.reshape(Bsz, S, nh, cfg.head_dim)
    Bmat = Bmat.reshape(Bsz, S, cfg.n_groups, cfg.d_state)
    Cmat = Cmat.reshape(Bsz, S, cfg.n_groups, cfg.d_state)
    dt = softplus(dt.float() + p["dt_bias"][heads])            # (B, S, nh)
    A = -torch.exp(p["A_log"][heads])

    if cfg.ssd_impl in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops as kops
        y, final = kops.ssd_with_state(
            xs.contiguous(), dt.contiguous(), A.contiguous(),
            Bmat.contiguous(), Cmat.contiguous(), chunk=cfg.chunk,
            interpret=cfg.ssd_impl == "pallas_interpret")
    elif cfg.ssd_impl == "xla":
        y, final = ssd_chunked(xs, dt, A, Bmat, Cmat, cfg.chunk,
                               return_final_state=True)
    else:
        raise ValueError(f"unknown ssd_impl {cfg.ssd_impl!r}")

    y = y + xs * p["D"][heads][None, None, :, None].to(xs.dtype)
    y = y.reshape(Bsz, S, nh * cfg.head_dim)
    out = _out(p, y, z, tp, reduce)
    if return_final_state:
        # decode conv state = last (d_conv-1) *pre-activation* xBC inputs
        # (the rank's channels of the gathered projection under tp)
        tail = raw[:, -(cfg.d_conv - 1):] if _split(tp) else \
            _tail_conv_inputs(p, x, cfg)
        return out, (final, tail)
    return out


def _tail_conv_inputs(p: Pytree, x: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """Last (d_conv-1) raw xBC inputs — the decode conv state."""
    return _split_proj(cfg, linear(p["in_proj"], x[:, -(cfg.d_conv - 1):]))[1]


def init_ssm_state(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device=None, tp=None):
    """Decode-time carried state: (ssm_state, conv_state); under a ``tp``
    that splits the heads, the rank's heads and conv channels."""
    nh, conv = cfg.n_heads, cfg.conv_dim
    if _split(tp):
        nh = tp.ssm_range[1]
        conv = nh * cfg.head_dim + 2 * cfg.n_groups * cfg.d_state
    return (torch.zeros(batch, nh, cfg.head_dim, cfg.d_state,
                        dtype=torch.float32, device=device),
            torch.zeros(batch, cfg.d_conv - 1, conv, dtype=dtype,
                        device=device))


def local_ssm_state(state, cfg: SSMConfig, tp):
    """The rank's part of a whole decode state (``init_ssm_state``'s
    layout, any leading dims): its heads and its conv channels."""
    if not _split(tp):
        return state
    ssm_state, conv_state = state
    lo, nh = tp.ssm_range
    return (ssm_state.narrow(ssm_state.dim() - 3, lo, nh),
            local_channels(conv_state, cfg, tp))


def ssm_decode_step(p: Pytree, x: torch.Tensor, state, cfg: SSMConfig,
                    tp=None, reduce: bool = True):
    """Single-token decode.  x: (B, 1, d_model); state from
    ``init_ssm_state``.  Returns (out, (new_ssm_state, new_conv_state));
    ``tp`` and ``reduce`` as in :func:`ssm_forward`."""
    ssm_state, conv_state = state
    Bsz = x.shape[0]
    z, xBC, dt, w, b = _in_proj(p, x, cfg, tp)
    heads = _heads(tp)
    nh = dt.shape[-1]
    xBC = xBC[:, 0]                                              # (B, conv_dim)
    hist = torch.cat([conv_state, xBC[:, None]], dim=1)          # (B, k, conv_dim)
    w = w.to(xBC.dtype)
    # one rounding of the f32 sum, as XLA's dot_general does for bf16
    conv = torch.einsum("bkc,kc->bc", hist.float(), w.float()).to(xBC.dtype)
    act = F.silu(conv + b.to(xBC.dtype))
    gn = cfg.n_groups * cfg.d_state
    xs, Bmat, Cmat = torch.split(act, [nh * cfg.head_dim, gn, gn], dim=-1)
    xs = xs.reshape(Bsz, nh, cfg.head_dim)
    Bmat = Bmat.reshape(Bsz, cfg.n_groups, cfg.d_state)
    Cmat = Cmat.reshape(Bsz, cfg.n_groups, cfg.d_state)
    hpg = nh // cfg.n_groups
    Bh = Bmat.repeat_interleave(hpg, dim=1)
    Ch = Cmat.repeat_interleave(hpg, dim=1)
    dtv = softplus(dt[:, 0].float() + p["dt_bias"][heads])       # (B, nh)
    A = -torch.exp(p["A_log"][heads])
    decay = torch.exp(dtv * A[None, :])
    new_state = ssm_state * decay[:, :, None, None] + \
        dtv[:, :, None, None] * xs.float()[:, :, :, None] * \
        Bh.float()[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch.float()).to(x.dtype)
    y = y + xs * p["D"][heads][None, :, None].to(x.dtype)
    y = y.reshape(Bsz, 1, nh * cfg.head_dim)
    return _out(p, y, z, tp, reduce), (new_state, hist[:, 1:])
