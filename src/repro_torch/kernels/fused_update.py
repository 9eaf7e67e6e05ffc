"""Fused FL-update kernels over flat buffers: CUDA for Hopper + plain twins.

The counterpart of ``repro/kernels/fused_update.py``'s ``local_step``,
``weighted_delta`` and ``server_update``.  Each function here comes in
two forms:

  ``<name>``        the wrapper.  On a CUDA tensor it launches the
                    hand-written kernel of ``csrc/fused_update.cu`` (or
                    raises); on a CPU tensor it runs the plain version.
                    It counts its launches in ``<name>.launches``.
  ``<name>_plain``  the same math, step by step, in torch ops — each
                    arithmetic step a separate op, so it rounds where
                    the kernel rounds.  The CPU tests hold it against
                    the Pallas kernel; ``chip_smoke.py`` holds the CUDA
                    kernel against it on the card.

Semantics follow the Pallas kernels exactly (f32 compute, cast on
store, op order), with one difference of form: the carried state is
updated IN PLACE — ``local_step`` writes ``p`` (and ``m``),
``server_update`` writes ``p`` and its moments — and returns the same
tensors; ``weighted_delta`` returns a new tensor.  Traced scalars are
f32 device tensors (``scalars``/``weights``), never host numbers, so a
round never waits on the device.

Buffers are 1-D.  The carried ones are padded to ``GRID_ALIGN`` (1024)
elements, so the kernels always take their 16-byte vector path; any
other length takes a one-element-per-thread path.  Pad lanes stay zero.

The CUDA library is built at first use with ``nvcc`` from the sources
in this package into ``build/repro_torch/`` at the repository root and
loaded with ctypes (``kernels/library.py``); nothing is compiled at
import.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.library import (
    DTYPE_CODE as _DTYPE_CODE, check_launch as _check_launch, lib as _lib,
    ptr as _ptr, stream as _stream)

LANES = 128
# carried buffers are padded to a multiple of this many elements (the
# JAX package's one (8, 128) tile), which keeps every kernel on its
# 16-byte vector path
GRID_ALIGN = 8 * LANES

_OPT_CODE = {"none": 0, "momentum": 1, "adam": 2}


# ---------------------------------------------------------------------------
# argument checks (shared by the CUDA path and the plain path)
# ---------------------------------------------------------------------------

def _check_1d(name: str, t: torch.Tensor, n: int, dtype: torch.dtype,
              device: torch.device) -> None:
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} must have shape ({n},), got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_param(p: torch.Tensor) -> None:
    if p.dim() != 1:
        raise ValueError(f"p must be 1-D, got shape {tuple(p.shape)}")
    if p.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported buffer dtype {p.dtype} "
                        f"(float32 or bfloat16)")
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")


# ---------------------------------------------------------------------------
# local step tail
# ---------------------------------------------------------------------------

def local_step_plain(p, g, m, c, scalars, *, weight_decay: float = 0.0,
                     momentum: float = 0.0):
    """``g ← g·clip_scale (+c) (+wd·p)``; ``m ← g + β·m``;
    ``p ← p − step·(m or g)``, f32 compute, cast on store, in place.
    ``scalars`` is the f32 ``(clip_scale, step_size)`` tensor."""
    clip_scale, step_size = scalars[0], scalars[1]
    p32 = p.float()
    gg = g.float() * clip_scale
    if c is not None:
        gg = gg + c.float()
    if weight_decay:
        gg = gg + weight_decay * p32
    eff = gg
    if m is not None:
        m32 = gg + momentum * m.float()
        m.copy_(m32)
        eff = m32
    p.copy_(p32 - step_size * eff)
    return p, m


def local_step(p: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor],
               c: Optional[torch.Tensor], scalars: torch.Tensor, *,
               weight_decay: float = 0.0, momentum: float = 0.0):
    """One fused client SGD step over a 1-D flat buffer, in place on
    ``p`` (and ``m``).  ``m``/``c`` are None when momentum / the
    correction is off; ``m`` must be given exactly when ``momentum`` is
    non-zero.  Returns ``(p, m)``."""
    _check_param(p)
    n, dt, dev = p.shape[0], p.dtype, p.device
    _check_1d("g", g, n, dt, dev)
    if m is not None:
        _check_1d("m", m, n, dt, dev)
    if c is not None:
        _check_1d("c", c, n, dt, dev)
    _check_1d("scalars", scalars, 2, torch.float32, dev)
    if (m is not None) != bool(momentum):
        raise ValueError("pass a momentum buffer exactly when momentum != 0")
    if not p.is_cuda:
        return local_step_plain(p, g, m, c, scalars,
                                weight_decay=weight_decay, momentum=momentum)
    if n:
        err = _lib().fu_local_step(
            _ptr(p), _ptr(g), _ptr(m), _ptr(c), _ptr(scalars), n,
            _DTYPE_CODE[dt], m is not None, c is not None,
            float(weight_decay), float(momentum), _stream(p))
        _check_launch("local_step", err)
        local_step.launches += 1
    return p, m


local_step.launches = 0


# ---------------------------------------------------------------------------
# weighted delta aggregation
# ---------------------------------------------------------------------------

def weighted_delta_plain(stacked, p, weights, *, extra=None,
                         deltas: bool = False):
    """``cast(p₃₂ + e + Σₖ w̄ₖ·(sₖ − p₃₂))``, k ascending (``deltas``
    drops the ``− p₃₂``).  Returns a new tensor of ``p``'s dtype."""
    p32 = p.float()
    acc = extra if extra is not None else torch.zeros_like(p32)
    for k in range(stacked.shape[0]):
        s = stacked[k].float()
        acc = acc + weights[k] * (s if deltas else s - p32)
    return (p32 + acc).to(p.dtype)


def weighted_delta(stacked: torch.Tensor, p: torch.Tensor,
                   weights: torch.Tensor, *,
                   extra: Optional[torch.Tensor] = None,
                   deltas: bool = False) -> torch.Tensor:
    """FedAvg aggregation over a stacked ``(K, N)`` buffer with the
    ``(K,)`` f32 normalized client weights; ``extra`` is an optional f32
    ``(N,)`` term added in the same pass.  K is read at run time."""
    _check_param(p)
    n, dt, dev = p.shape[0], p.dtype, p.device
    if stacked.dim() != 2 or stacked.shape[1] != n:
        raise ValueError(f"stacked must have shape (K, {n}), got "
                         f"{tuple(stacked.shape)}")
    if stacked.dtype != dt or stacked.device != dev:
        raise TypeError("stacked must match p's dtype and device")
    if not stacked.is_contiguous():
        raise ValueError("stacked must be contiguous")
    K = stacked.shape[0]
    _check_1d("weights", weights, K, torch.float32, dev)
    if extra is not None:
        _check_1d("extra", extra, n, torch.float32, dev)
    if not p.is_cuda:
        return weighted_delta_plain(stacked, p, weights, extra=extra,
                                    deltas=deltas)
    out = torch.empty_like(p)
    if n:
        err = _lib().fu_weighted_delta(
            _ptr(out), _ptr(stacked), _ptr(p), _ptr(weights), _ptr(extra),
            n, K, _DTYPE_CODE[dt], bool(deltas), _stream(p))
        _check_launch("weighted_delta", err)
        weighted_delta.launches += 1
    return out


weighted_delta.launches = 0


# ---------------------------------------------------------------------------
# server update (apply delta + FedAvgM / FedAdam moments)
# ---------------------------------------------------------------------------

def server_update_plain(p, delta, moments, scalars, *, opt: str = "none",
                        beta: float = 0.9, b1: float = 0.9, b2: float = 0.99,
                        eps: float = 1e-8):
    """none: ``p ← p + d``; momentum: ``m ← β·m + g``, ``p ← p − lr·m``;
    adam: ``μ ← b1·μ + (1−b1)·g``, ``ν ← b2·ν + (1−b2)·g·g``,
    ``p ← p − lr·(μ/bc1)/(√(ν/bc2)+ε)``; ``g = −d``, in place.
    ``scalars`` is the f32 ``(lr,)`` or ``(lr, bc1, bc2)`` tensor."""
    p32 = p.float()
    if opt == "none":
        p.copy_(p32 + delta)
        return p, tuple(moments)
    lr = scalars[0]
    g = -delta
    if opt == "momentum":
        (m,) = moments
        m32 = beta * m.float() + g
        m.copy_(m32)
        p.copy_(p32 - lr * m32)
        return p, (m,)
    mu, nu = moments
    bc1, bc2 = scalars[1], scalars[2]
    mu32 = b1 * mu.float() + (1.0 - b1) * g
    nu32 = b2 * nu.float() + (1.0 - b2) * g * g
    mu.copy_(mu32)
    nu.copy_(nu32)
    u = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
    p.copy_(p32 - lr * u)
    return p, (mu, nu)


def server_update(p: torch.Tensor, delta: torch.Tensor,
                  moments: Sequence[torch.Tensor], scalars: torch.Tensor, *,
                  opt: str = "none", beta: float = 0.9, b1: float = 0.9,
                  b2: float = 0.99, eps: float = 1e-8):
    """Apply the aggregated f32 ``delta`` to ``p`` under a server
    optimizer, in place on ``p`` and ``moments`` (() for "none", (m,)
    for "momentum", (mu, nu) for "adam").  Returns ``(p, moments)``."""
    if opt not in _OPT_CODE:
        raise ValueError(f"unknown server opt {opt!r}")
    _check_param(p)
    n, dt, dev = p.shape[0], p.dtype, p.device
    _check_1d("delta", delta, n, torch.float32, dev)
    moments = tuple(moments)
    if len(moments) != _OPT_CODE[opt]:
        raise ValueError(f"server opt {opt!r} takes {_OPT_CODE[opt]} "
                         f"moment buffers, got {len(moments)}")
    for i, mo in enumerate(moments):
        _check_1d(f"moments[{i}]", mo, n, dt, dev)
    _check_1d("scalars", scalars, 3 if opt == "adam" else 1,
              torch.float32, dev)
    if not p.is_cuda:
        return server_update_plain(p, delta, moments, scalars, opt=opt,
                                   beta=beta, b1=b1, b2=b2, eps=eps)
    if n:
        m1 = moments[0] if moments else None
        m2 = moments[1] if len(moments) > 1 else None
        err = _lib().fu_server_update(
            _ptr(p), _ptr(delta), _ptr(m1), _ptr(m2), _ptr(scalars), n,
            _DTYPE_CODE[dt], _OPT_CODE[opt], float(beta), float(b1),
            float(b2), float(1.0 - b1), float(1.0 - b2), float(eps),
            _stream(p))
        _check_launch("server_update", err)
        server_update.launches += 1
    return p, moments


server_update.launches = 0

KERNELS = (local_step, weighted_delta, server_update)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
