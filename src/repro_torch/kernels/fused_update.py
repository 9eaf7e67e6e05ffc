"""Fused FL-update kernels over flat buffers: CUDA for Hopper + plain twins.

The counterpart of ``repro/kernels/fused_update.py``'s ``local_step``,
``weighted_delta``, ``server_update``, ``compress_delta``,
``dp_clip_noise`` and ``delta_accum``, plus ``dp_clip_noise_rows`` (one
``dp_clip_noise`` launch for a round's clients), ``topk_threshold`` (a
jnp function in ``repro/fl/compression.py``, a kernel here) and
``topk_compress`` (the threshold and ``compress_delta`` in one launch).
Each function here comes in two forms:

  ``<name>``        the wrapper.  On a CUDA tensor it launches the
                    hand-written kernel of ``csrc/fused_update.cu`` or
                    ``csrc/upload.cu`` (or raises); on a CPU tensor it
                    runs the plain version.
                    It counts its launches in ``<name>.launches``
                    (``local_step`` also those with the scaffold
                    correction ``c`` in ``local_step.c_launches``).
  ``<name>_plain``  the same math, step by step, in torch ops — each
                    arithmetic step a separate op, so it rounds where
                    the kernel rounds.  The CPU tests hold it against
                    the Pallas kernel; ``chip_smoke.py`` holds the CUDA
                    kernel against it on the card.

Semantics follow the Pallas kernels exactly (f32 compute, cast on
store, op order), with one difference of form: the carried state is
updated IN PLACE — ``local_step`` writes ``p`` (and ``m``),
``server_update`` writes ``p`` and its moments, ``delta_accum`` writes
the round's f32 accumulator ``d`` (never ``w`` or ``p``) — and returns
the same tensors; the others return new tensors.  Traced scalars are
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

import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import work as _work
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


@_work.counted("local_step", _work.local_step)
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
        local_step.c_launches += c is not None
    return p, m


local_step.launches = 0
local_step.c_launches = 0


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


@_work.counted("weighted_delta", _work.weighted_delta)
def weighted_delta(stacked: torch.Tensor, p: torch.Tensor,
                   weights: torch.Tensor, *,
                   extra: Optional[torch.Tensor] = None,
                   deltas: bool = False) -> torch.Tensor:
    """FedAvg aggregation over a stacked ``(K, N)`` buffer with the
    ``(K,)`` f32 normalized client weights; ``extra`` is an optional f32
    ``(N,)`` term added in the same pass.  K is read at run time.  The
    stack has ``p``'s dtype, or f32 when it holds client deltas
    (``deltas``), as the compressed and materialized DP uploads are."""
    _check_param(p)
    n, dt, dev = p.shape[0], p.dtype, p.device
    if stacked.dim() != 2 or stacked.shape[1] != n:
        raise ValueError(f"stacked must have shape (K, {n}), got "
                         f"{tuple(stacked.shape)}")
    if stacked.device != dev or not (
            stacked.dtype == dt or (deltas and stacked.dtype == torch.float32)):
        raise TypeError("stacked must be on p's device, with p's dtype "
                        "(or f32 when deltas=True)")
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
            n, K, _DTYPE_CODE[dt], _DTYPE_CODE[stacked.dtype], bool(deltas),
            _stream(p))
        _check_launch("weighted_delta", err)
        weighted_delta.launches += 1
    return out


weighted_delta.launches = 0


# ---------------------------------------------------------------------------
# delta accumulation (the pod backend's FedAvg sum, one client per call)
# ---------------------------------------------------------------------------

def delta_accum_plain(d, w, p, coeff):
    """``d ← d + c·(w₃₂ − p₃₂)``, or ``d ← d + c·w₃₂`` when ``p`` is
    None, in place on the f32 ``d``; ``coeff`` is the f32 ``(1,)``
    tensor holding ``c``."""
    term = w.float() if p is None else w.float() - p.float()
    d.copy_(d + coeff * term)
    return d


@_work.counted("delta_accum", _work.delta_accum)
def delta_accum(d: torch.Tensor, w: torch.Tensor, p: Optional[torch.Tensor],
                coeff: torch.Tensor) -> torch.Tensor:
    """One client's contribution to the pod backend's running f32
    weighted-delta sum, in place on the accumulator ``d``:
    ``d + coeff·(w₃₂ − p₃₂)``, or the accum-only ``d + coeff·w₃₂`` when
    ``p`` is None (the hierarchical lanes' p-free partials and the
    compressed uploads, which are deltas already).  ``w``/``p`` are f32
    or bf16 of one dtype; ``coeff`` is an f32 device tensor of one
    element.  Returns ``d``."""
    if d.dim() != 1:
        raise ValueError(f"d must be 1-D, got shape {tuple(d.shape)}")
    n, dev = d.shape[0], d.device
    _check_1d("d", d, n, torch.float32, dev)
    if w.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported w dtype {w.dtype} (float32 or "
                        f"bfloat16)")
    _check_1d("w", w, n, w.dtype, dev)
    if p is not None:
        _check_1d("p", p, n, w.dtype, dev)
    if coeff.numel() != 1:
        raise ValueError(f"coeff must hold one element, got shape "
                         f"{tuple(coeff.shape)}")
    _check_1d("coeff", coeff.reshape(1), 1, torch.float32, dev)
    if not d.is_cuda:
        return delta_accum_plain(d, w, p, coeff.reshape(1))
    if n:
        err = _lib().fu_delta_accum(_ptr(d), _ptr(w), _ptr(p), _ptr(coeff),
                                    n, _DTYPE_CODE[w.dtype], _stream(d))
        _check_launch("delta_accum", err)
        delta_accum.launches += 1
    return d


delta_accum.launches = 0


# ---------------------------------------------------------------------------
# server update (apply delta + FedAvgM / FedAdam moments)
# ---------------------------------------------------------------------------

def server_update_plain(p, delta, moments, scalars, *, avg=None,
                        opt: str = "none", beta: float = 0.9, b1: float = 0.9,
                        b2: float = 0.99, eps: float = 1e-8):
    """none: ``p ← p + d``; momentum: ``m ← β·m + g``, ``p ← p − lr·m``;
    adam: ``μ ← b1·μ + (1−b1)·g``, ``ν ← b2·ν + (1−b2)·g·g``,
    ``p ← p − lr·(μ/bc1)/(√(ν/bc2)+ε)``; ``g = −d``, in place.
    ``scalars`` is the f32 ``(lr,)`` or ``(lr, bc1, bc2)`` tensor.  The
    aggregate form (``avg`` given, ``delta`` None) first forms
    ``d = avg₃₂ − p₃₂``."""
    if avg is not None:
        delta = avg.float() - p.float()
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


@_work.counted("server_update", _work.server_update)
def server_update(p: torch.Tensor, delta: Optional[torch.Tensor],
                  moments: Sequence[torch.Tensor], scalars: torch.Tensor, *,
                  avg: Optional[torch.Tensor] = None, opt: str = "none",
                  beta: float = 0.9, b1: float = 0.9, b2: float = 0.99,
                  eps: float = 1e-8):
    """Apply the aggregated f32 ``delta`` to ``p`` under a server
    optimizer, in place on ``p`` and ``moments`` (() for "none", (m,)
    for "momentum", (mu, nu) for "adam").  The aggregate form takes the
    round's aggregate ``avg`` (``p``'s dtype) instead, with ``delta``
    None, and forms ``d = avg₃₂ − p₃₂`` in the same launch: exactly one
    of the two is given.  Returns ``(p, moments)``."""
    if opt not in _OPT_CODE:
        raise ValueError(f"unknown server opt {opt!r}")
    if (delta is None) == (avg is None):
        raise ValueError("pass exactly one of delta and avg")
    _check_param(p)
    n, dt, dev = p.shape[0], p.dtype, p.device
    if avg is None:
        _check_1d("delta", delta, n, torch.float32, dev)
    else:
        _check_1d("avg", avg, n, dt, dev)
    moments = tuple(moments)
    if len(moments) != _OPT_CODE[opt]:
        raise ValueError(f"server opt {opt!r} takes {_OPT_CODE[opt]} "
                         f"moment buffers, got {len(moments)}")
    for i, mo in enumerate(moments):
        _check_1d(f"moments[{i}]", mo, n, dt, dev)
    _check_1d("scalars", scalars, 3 if opt == "adam" else 1,
              torch.float32, dev)
    if not p.is_cuda:
        return server_update_plain(p, delta, moments, scalars, avg=avg,
                                   opt=opt, beta=beta, b1=b1, b2=b2, eps=eps)
    if n:
        m1 = moments[0] if moments else None
        m2 = moments[1] if len(moments) > 1 else None
        err = _lib().fu_server_update(
            _ptr(p), _ptr(delta if avg is None else avg), _ptr(m1),
            _ptr(m2), _ptr(scalars), n, _DTYPE_CODE[dt], _OPT_CODE[opt],
            avg is not None, float(beta), float(b1), float(b2),
            float(1.0 - b1), float(1.0 - b2), float(eps), _stream(p))
        _check_launch("server_update", err)
        server_update.launches += 1
    return p, moments


server_update.launches = 0

# ---------------------------------------------------------------------------
# compressed client upload: top-k mask + blockwise quantization
# ---------------------------------------------------------------------------

# blockwise-symmetric quantization constants (the JAX package's): the f32
# scale is nudged up by SCALE_PAD before its bf16 round-to-nearest, so the
# wire scale is never below amax/qmax and no quantized value clips
QMAX = {8: 127.0, 16: 32767.0}
SCALE_PAD = 1.0 + 2.0 ** -6
# topk_threshold's two kernels, chosen by n: up to topk_cut() elements
# one launch on a cluster of TOPK_CLUSTER CTAs, each holding a slice of
# at most TOPK_SLICE_MAX keys (a multiple of TOPK_SLICE_GRANULE) in
# shared memory (csrc/upload.cu's kCluster, kClusterSliceMax,
# kSliceGranule); above it one launch per radix pass
TOPK_CLUSTER = 16
TOPK_SLICE_MAX = 40 * 1024
TOPK_SLICE_GRANULE = 128
TOPK_RADIX_LAUNCHES = 4


def _check_bits(bits: int) -> None:
    if bits not in (8, 16, 32):
        raise ValueError(f"compress_delta bits must be 8|16|32, got {bits}")


def compress_delta_plain(d, thresh, *, bits: int = 32, topk: bool = False,
                         with_residual: bool = False):
    """``x = d·[|d| ≥ τ]`` (``topk``), then per 128-lane row (rows start
    at element 0) ``scale = bf16(amax/qmax·SCALE_PAD)`` and
    ``c = clip(round_half_even(x/scale), ±qmax)·scale`` (``bits`` 8 or
    16; an all-zero row gives zeros), residual ``r = d − c``.  The
    divisions are tensor by tensor: a division by a host scalar may run
    as a multiplication by its reciprocal."""
    n = d.shape[0]
    d0 = d.float()
    x = d0.clone()
    if topk:
        x = torch.where(x.abs() >= thresh, x, torch.zeros_like(x))
    if bits != 32 and n:
        rows = -(-n // LANES)
        xb = torch.nn.functional.pad(x, (0, rows * LANES - n)).reshape(
            rows, LANES)
        qmax = QMAX[bits]
        amax = xb.abs().amax(dim=-1, keepdim=True)
        scale = ((amax / torch.full_like(amax, qmax)) * SCALE_PAD).to(
            torch.bfloat16).float()
        pos = scale > 0.0
        q = torch.where(pos, xb / torch.where(pos, scale, torch.ones_like(scale)),
                        torch.zeros_like(xb))
        q = torch.clamp(torch.round(q), -qmax, qmax)
        x = (q * scale).reshape(-1)[:n]
    return (x, d0 - x) if with_residual else x


@_work.counted("compress_delta", _work.compress_delta)
def compress_delta(d: torch.Tensor, thresh: Optional[torch.Tensor], *,
                   bits: int = 32, topk: bool = False,
                   with_residual: bool = False):
    """The compressed form of one client's f32 flat delta in one pass:
    top-k masking at the device threshold ``thresh`` (read only when
    ``topk``), then blockwise int8/int16 fake quantization (``bits`` 32
    skips it).  Returns ``c``, or ``(c, r)`` with the error-feedback
    residual ``r = d − c`` when ``with_residual``; both f32, new
    tensors.  Pad lanes stay zero."""
    _check_bits(bits)
    if d.dim() != 1:
        raise ValueError(f"d must be 1-D, got shape {tuple(d.shape)}")
    n, dev = d.shape[0], d.device
    _check_1d("d", d, n, torch.float32, dev)
    if topk:
        if thresh is None:
            raise ValueError("topk=True needs the threshold tensor")
        _check_1d("thresh", thresh.reshape(1), 1, torch.float32, dev)
    if not d.is_cuda:
        return compress_delta_plain(d, thresh, bits=bits, topk=topk,
                                    with_residual=with_residual)
    c = torch.empty_like(d)
    r = torch.empty_like(d) if with_residual else None
    if n:
        err = _lib().up_compress_delta(
            _ptr(d), _ptr(thresh) if topk else None, _ptr(c), _ptr(r), n,
            bits, bool(topk), _stream(d))
        _check_launch("compress_delta", err)
        compress_delta.launches += 1
    return (c, r) if with_residual else c


compress_delta.launches = 0


def _check_k(k: int, n: int) -> int:
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"topk_threshold needs 1 <= k <= {n}, got {k}")
    return k


def topk_threshold_plain(d, k: int) -> torch.Tensor:
    """τ = the k-th largest |d| as a 0-dim f32 tensor, by the JAX
    package's greedy search: 31 compare-and-count steps over the bits of
    |d| (a non-negative float orders like its int32 bit pattern), most
    significant first, keeping a bit while at least k elements are at or
    above the candidate.  No value crosses to the host."""
    k = _check_k(k, d.shape[0])
    bits = d.float().abs().view(torch.int32)
    prefix = torch.zeros((), dtype=torch.int32, device=d.device)
    for shift in range(30, -1, -1):
        cand = prefix | (1 << shift)
        keep = (bits >= cand).sum() >= k
        prefix = torch.where(keep, cand, prefix)
    return prefix.view(torch.float32)


def topk_slice(n: int, n_ctas: int = TOPK_CLUSTER) -> int:
    """Keys per CTA of the cluster threshold: ⌈n / n_ctas⌉ rounded up
    to ``TOPK_SLICE_GRANULE`` (at least one granule).  CTA r holds
    elements ``[r·slice, (r+1)·slice)``; places past n hold no key."""
    per = -(-n // n_ctas)
    return max(TOPK_SLICE_GRANULE, -(-per // TOPK_SLICE_GRANULE)
               * TOPK_SLICE_GRANULE)


def topk_cut() -> int:
    """The most elements the one-launch cluster threshold takes."""
    return TOPK_CLUSTER * TOPK_SLICE_MAX


def topk_launches(n: int) -> int:
    """Kernel launches of one ``topk_threshold`` call on n elements."""
    return 1 if n <= topk_cut() else TOPK_RADIX_LAUNCHES


def topk_cluster_plain(d, k: int, n_ctas: int = TOPK_CLUSTER
                       ) -> torch.Tensor:
    """The cluster kernel's arithmetic, step by step: the keys
    ``bits(|d|)`` cut into ``n_ctas`` slices of ``topk_slice`` keys (a
    key past n is 0xFFFFFFFF, whose sign bit matches no prefix), then
    four 8-bit radix passes, most significant digit first.  A pass
    counts, per slice, the digit of each key whose higher digits equal
    the prefix so far, sums the slices' 256-bin histograms, and takes
    the digit t with S(t) ≥ rank > S(t+1), S the suffix sums; the rank
    left is rank − S(t+1).  Returns τ as a 0-dim f32 tensor; no value
    crosses to the host."""
    n = d.shape[0]
    k = _check_k(k, n)
    if not 1 <= n_ctas <= 16:
        raise ValueError(f"n_ctas must be in 1..16, got {n_ctas}")
    dev = d.device
    slice_ = topk_slice(n, n_ctas)
    bits = d.float().abs().view(torch.int32).long() & 0xFFFFFFFF
    keys = torch.cat([bits, torch.full((n_ctas * slice_ - n,), 0xFFFFFFFF,
                                       dtype=torch.long, device=dev)])
    keys = keys.view(n_ctas, slice_)
    prefix = torch.zeros((), dtype=torch.long, device=dev)
    rank = torch.full((), k, dtype=torch.long, device=dev)
    for p in range(4):
        shift = 24 - 8 * p
        fixed = (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF if p else 0
        hit = (keys & (fixed | 0x80000000)) == prefix
        digit = (keys >> shift) & 0xFF
        hist = torch.zeros(n_ctas, 256, dtype=torch.long, device=dev)
        hist.scatter_add_(1, digit, hit.long())
        total = hist.sum(dim=0)
        suffix = total.flip(0).cumsum(0).flip(0)        # S(t)
        above = suffix - total                          # S(t + 1)
        t = torch.argmax(((suffix >= rank) & (above < rank)).long())
        # (t read on the device: a fake-tensor capture has no value)
        prefix = prefix | (t << shift)
        rank = rank - above.gather(0, t.reshape(1)).reshape(())
    return prefix.to(torch.int32).view(torch.float32)


@functools.lru_cache(maxsize=1)
def _topk_workspace_words() -> int:
    return int(_lib().up_topk_workspace_words())


@_work.counted("topk_threshold", _work.topk_threshold)
def topk_threshold(d: torch.Tensor, k: int) -> torch.Tensor:
    """τ = the k-th largest |d| of a 1-D f32 buffer, exactly, as a 0-dim
    f32 tensor on ``d``'s device; the card never waits on the host and
    the host never reads τ.  Zero padding appended to ``d`` leaves τ
    unchanged when ``k`` counts logical elements.  On a CUDA tensor it
    runs ``topk_launches(n)`` launches: up to ``topk_cut()`` elements
    one launch on a cluster of ``TOPK_CLUSTER`` CTAs, above it four
    radix passes.  A refused launch raises."""
    if d.dim() != 1:
        raise ValueError(f"d must be 1-D, got shape {tuple(d.shape)}")
    n, dev = d.shape[0], d.device
    _check_1d("d", d, n, torch.float32, dev)
    k = _check_k(k, n)
    if not d.is_cuda:
        return topk_threshold_plain(d, k)
    tau = torch.empty((), dtype=torch.float32, device=dev)
    launches = topk_launches(n)
    if launches == 1:
        err = _lib().up_topk_cluster(_ptr(d), n, k, _ptr(tau), _stream(d))
    else:
        ws = torch.empty(_topk_workspace_words(), dtype=torch.int32,
                         device=dev)
        err = _lib().up_topk_threshold(_ptr(d), n, k, _ptr(tau), _ptr(ws),
                                       _stream(d))
    _check_launch("topk_threshold", err)
    topk_threshold.launches += launches
    return tau


topk_threshold.launches = 0


def topk_compress_plain(d, k: int, *, bits: int = 32,
                        with_residual: bool = False):
    """The fused kernel's arithmetic: τ by ``topk_cluster_plain``, then
    ``compress_delta_plain`` with top-k at τ.  Returns ``(c, r, τ)``;
    ``r`` is None unless ``with_residual``."""
    tau = topk_cluster_plain(d, k)
    out = compress_delta_plain(d, tau, bits=bits, topk=True,
                               with_residual=with_residual)
    c, r = out if with_residual else (out, None)
    return c, r, tau


@_work.counted("topk_compress", _work.topk_compress)
def topk_compress(d: torch.Tensor, k: int, *, bits: int = 32,
                  with_residual: bool = False):
    """The top-k compressed upload of one client's 1-D f32 delta: τ = the
    k-th largest |d|, then ``compress_delta`` with top-k at τ (``bits``
    8 or 16 quantize, 32 keeps the values).  Returns ``(c, r, τ)``, new
    f32 tensors, ``r = d − c`` or None unless ``with_residual``; τ is a
    0-dim tensor the host never reads.  On a CUDA tensor a size
    dispatch: up to ``topk_cut()`` elements ONE launch (counted here) of
    as many 16-CTA clusters as the card runs at once, each finding τ as
    the cluster threshold does and compressing its share of the rows as
    the epilogue; above it ``topk_threshold`` then ``compress_delta``
    (4 + 1 launches, counted by those two).  A refused launch raises."""
    _check_bits(bits)
    if d.dim() != 1:
        raise ValueError(f"d must be 1-D, got shape {tuple(d.shape)}")
    n, dev = d.shape[0], d.device
    _check_1d("d", d, n, torch.float32, dev)
    k = _check_k(k, n)
    if not d.is_cuda:
        return topk_compress_plain(d, k, bits=bits,
                                   with_residual=with_residual)
    if n > topk_cut():
        tau = topk_threshold(d, k)
        out = compress_delta(d, tau, bits=bits, topk=True,
                             with_residual=with_residual)
        c, r = out if with_residual else (out, None)
        return c, r, tau
    tau = torch.empty((), dtype=torch.float32, device=dev)
    c = torch.empty_like(d)
    r = torch.empty_like(d) if with_residual else None
    err = _lib().up_topk_compress(_ptr(d), n, k, bits, _ptr(tau), _ptr(c),
                                  _ptr(r), _stream(d))
    _check_launch("topk_compress", err)
    topk_compress.launches += 1
    return c, r, tau


topk_compress.launches = 0


# ---------------------------------------------------------------------------
# DP clip + noise: the materialized private upload of one client
# ---------------------------------------------------------------------------

def dp_clip_noise_plain(d, z, scalars):
    """``u = clip_scale·d (+ noise_scale·z)``, f32; ``scalars`` is the
    f32 ``(clip_scale, noise_scale)`` tensor."""
    u = scalars[0] * d.float()
    if z is not None:
        u = u + scalars[1] * z
    return u


@_work.counted("dp_clip_noise", _work.dp_clip_noise)
def dp_clip_noise(d: torch.Tensor, z: Optional[torch.Tensor],
                  scalars: torch.Tensor) -> torch.Tensor:
    """One client's DP upload over a 1-D f32 delta in one pass, as a new
    f32 tensor: the delta scaled by ``clip_scale`` plus ``noise_scale``
    times the standard-normal buffer ``z`` (``z=None`` drops the noise
    term).  Pad lanes stay zero."""
    if d.dim() != 1:
        raise ValueError(f"d must be 1-D, got shape {tuple(d.shape)}")
    n, dev = d.shape[0], d.device
    _check_1d("d", d, n, torch.float32, dev)
    if z is not None:
        _check_1d("z", z, n, torch.float32, dev)
    _check_1d("scalars", scalars, 2, torch.float32, dev)
    if not d.is_cuda:
        return dp_clip_noise_plain(d, z, scalars)
    out = torch.empty_like(d)
    if n:
        err = _lib().up_dp_clip_noise(_ptr(out), _ptr(d), _ptr(z),
                                      _ptr(scalars), n, _stream(d))
        _check_launch("dp_clip_noise", err)
        dp_clip_noise.launches += 1
    return out


dp_clip_noise.launches = 0


def dp_clip_noise_rows_plain(w, p, z, clip_scales, noise_scale):
    """Row k: the subtraction ``w[k]₃₂ − p₃₂``, then
    ``dp_clip_noise_plain`` with ``(clip_scales[k], noise_scale)`` and
    ``z[k]``.  Returns a new ``(K, N)`` f32 tensor."""
    ns = noise_scale.reshape(())
    rows = [dp_clip_noise_plain(w[k].float() - p.float(),
                                None if z is None else z[k],
                                torch.stack([clip_scales[k], ns]))
            for k in range(w.shape[0])]
    if not rows:
        return torch.empty((0, p.shape[0]), dtype=torch.float32,
                           device=p.device)
    return torch.stack(rows)


@_work.counted("dp_clip_noise_rows", _work.dp_clip_noise_rows)
def dp_clip_noise_rows(w: torch.Tensor, p: torch.Tensor,
                       z: Optional[torch.Tensor], clip_scales: torch.Tensor,
                       noise_scale: torch.Tensor) -> torch.Tensor:
    """The DP uploads of all K clients of a round in ONE launch, as a new
    ``(K, N)`` f32 tensor: row k is ``clip_scales[k]·(w[k]₃₂ − p₃₂)``
    plus ``noise_scale·z[k]`` (``z=None`` drops the noise term), rounded
    as the subtraction and ``dp_clip_noise`` it replaces round it.  ``w``
    is the stacked client end states ``(K, N)`` in ``p``'s dtype, ``z``
    the stacked f32 standard-normal draws, ``clip_scales`` the f32
    ``(K,)`` scales, ``noise_scale`` an f32 tensor of one element.
    Counted on ``dp_clip_noise.launches``."""
    _check_param(p)
    n, dt, dev = p.shape[0], p.dtype, p.device
    if w.dim() != 2 or w.shape[1] != n:
        raise ValueError(f"w must have shape (K, {n}), got "
                         f"{tuple(w.shape)}")
    K = w.shape[0]
    if w.dtype != dt or w.device != dev:
        raise TypeError(f"w must be {dt} on {dev}, got {w.dtype} on "
                        f"{w.device}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    if z is not None:
        if tuple(z.shape) != (K, n):
            raise ValueError(f"z must have shape ({K}, {n}), got "
                             f"{tuple(z.shape)}")
        if z.dtype != torch.float32 or z.device != dev:
            raise TypeError(f"z must be float32 on {dev}, got {z.dtype} on "
                            f"{z.device}")
        if not z.is_contiguous():
            raise ValueError("z must be contiguous")
    _check_1d("clip_scales", clip_scales, K, torch.float32, dev)
    if noise_scale.numel() != 1:
        raise ValueError(f"noise_scale must hold one element, got shape "
                         f"{tuple(noise_scale.shape)}")
    _check_1d("noise_scale", noise_scale.reshape(1), 1, torch.float32, dev)
    if not p.is_cuda:
        return dp_clip_noise_rows_plain(w, p, z, clip_scales, noise_scale)
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    if n and K:
        err = _lib().up_dp_clip_noise_rows(
            _ptr(out), _ptr(w), _ptr(p), _ptr(z), _ptr(clip_scales),
            _ptr(noise_scale), n, K, _DTYPE_CODE[dt], _stream(p))
        _check_launch("dp_clip_noise_rows", err)
        dp_clip_noise.launches += 1
    return out


# the update kernels, the client-upload kernels and the pod backend's
# aggregation kernel
KERNELS = (local_step, weighted_delta, server_update)
UPLOAD_KERNELS = (compress_delta, topk_threshold, dp_clip_noise,
                  topk_compress)
POD_KERNELS = (delta_accum,)


def reset_launch_counts() -> None:
    for fn in KERNELS + UPLOAD_KERNELS + POD_KERNELS:
        fn.launches = 0
    local_step.c_launches = 0
