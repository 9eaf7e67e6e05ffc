"""The work of each hand-written kernel, for the compile analysis.

Each function here takes a kernel wrapper's arguments and returns
``(ops, bytes)``: the operations the kernel does on them and the bytes
it must move (each input read once, each output written once), the
counts ``chip_smoke.py``'s kernel rows divide by the card's peaks for
their ``bound_ms``.  Where the work depends on the data (attention's
masked pairs), the count is this call's.

A counter (``repro_torch.launch.hlo_analysis.StepCounter``) installs
itself with :func:`counting`.  Each wrapper is decorated with
:func:`counted`: while a counter is installed, a call adds its kernel's
``(ops, bytes)`` to it once, and whatever ran inside the call — the
plain version, on CPU, meta or fake tensors — is taken back out of the
counter, so no intermediate of the plain version is counted in the
kernel's place.  A wrapper called inside another (the compressed
upload's threshold above the cluster's cut) counts in its caller's
place.  With no counter installed the decorator only forwards the call.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np

Work = Tuple[int, int]

_ACTIVE: List = []      # the installed counters, innermost last
_DEPTH = [0]            # counted wrappers on the call stack


@contextlib.contextmanager
def counting(counter):
    """Install ``counter`` (``snapshot()``, ``restore(snap)``,
    ``add_kernel(name, ops, nbytes)``) for the kernels called inside."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.remove(counter)


def counted(name: str, work: Callable[..., Work]):
    """Decorate the wrapper of kernel ``name`` whose work is
    ``work(*args, **kwargs)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE or _DEPTH[0]:
                return fn(*args, **kwargs)
            counter = _ACTIVE[-1]
            ops, nbytes = work(*args, **kwargs)
            snap = counter.snapshot()
            _DEPTH[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _DEPTH[0] -= 1
                counter.restore(snap)
            counter.add_kernel(name, int(ops), int(nbytes))
            return out
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# the update kernels (K1-K3), the pod's K6, the upload kernels (K4, the
# top-k threshold, K5)
# ---------------------------------------------------------------------------

def local_step(p, g, m, c, scalars, *, weight_decay: float = 0.0,
               momentum: float = 0.0) -> Work:
    """K1: p, g (m, c) read, p (m) written, the two scalars; the clip
    scale, the correction add, decay, momentum and the step."""
    n, e = p.numel(), p.element_size()
    has_m, has_c = m is not None, c is not None
    return (n * (1 + has_c + 2 * bool(weight_decay) + 2 * has_m + 2),
            n * e * (3 + 2 * has_m + has_c) + 8)


def weighted_delta(stacked, p, weights, *, extra=None,
                   deltas: bool = False) -> Work:
    """K2: the K rows and p (and the extra term) read, the result
    written, the K weights."""
    K, n, e = stacked.shape[0], p.numel(), p.element_size()
    has_extra = extra is not None
    return (n * ((2 if deltas else 3) * K + 1 + has_extra),
            n * e * (K + 2) + n * 4 * has_extra + 4 * K)


_SERVER_OPS = {"none": 1, "momentum": 4, "adam": 13}


def server_update(p, delta, moments, scalars, *, avg=None, opt: str = "none",
                  **_) -> Work:
    """K3: p, the f32 delta (or the aggregate, p's dtype) and the moments
    read, p and the moments written, the scalars."""
    n, e = p.numel(), p.element_size()
    src = e if avg is not None else 4
    m_bytes = sum(m.element_size() for m in moments)
    return (n * (_SERVER_OPS[opt] + (avg is not None)),
            n * (2 * e + src + 2 * m_bytes) + 4 * scalars.numel())


def delta_accum(d, w, p, coeff) -> Work:
    """K6: the f32 accumulator, w (and p) read, the accumulator written,
    the coefficient."""
    n, e = w.numel(), w.element_size()
    with_p = p is not None
    return n * (2 + with_p), n * (4 + e + e * with_p + 4) + 4


def compress_delta(d, thresh, *, bits: int = 32, topk: bool = False,
                   with_residual: bool = False) -> Work:
    """K4: d read, c (and r) written, τ read."""
    n, res = d.numel(), bool(with_residual)
    return (n * (3 * topk + (7 if bits != 32 else 0) + res),
            4 * n + 4 * n * (1 + res) + 4 * topk)


def topk_threshold(d, k: int) -> Work:
    """The threshold: |d| read once, τ written; abs and a compare per
    element."""
    n = d.numel()
    return 2 * n, 4 * n + 4


def topk_compress(d, k: int, *, bits: int = 32,
                  with_residual: bool = False) -> Work:
    """The fused top-k upload: the threshold's work and K4's at τ, d read
    once."""
    n, res = d.numel(), bool(with_residual)
    return (2 * n + n * (3 + (7 if bits != 32 else 0) + res),
            4 * n + 4 * n * (1 + res) + 4)


def dp_clip_noise(d, z, scalars) -> Work:
    """K5, one client: d (and z) read, the upload written, the scales."""
    n, has_z = d.numel(), z is not None
    return n * (1 + 2 * has_z), 4 * n * (2 + has_z) + 8


def dp_clip_noise_rows(w, p, z, clip_scales, noise_scale) -> Work:
    """K5's rows form: the K end states (and draws) and p read, the K
    uploads written, the scales."""
    K, n, e = w.shape[0], p.numel(), p.element_size()
    has_z = z is not None
    return (K * n * (2 + 2 * has_z),
            K * n * (e + 4 * has_z + 4) + n * e + 4 * K + 4)


# ---------------------------------------------------------------------------
# K7 attention, K8 the SSD scan
# ---------------------------------------------------------------------------

def attention_pairs(S: int, T: int, window: Optional[int], q_offset: int,
                    kv_len: Optional[int]) -> Tuple[int, int]:
    """``(pairs, rows)``: the unmasked (query, key) pairs of one head and
    batch row, and the key rows they read."""
    from repro_torch.kernels.flash_attention import FULL_WINDOW
    win = FULL_WINDOW if window is None else window
    kvl = T if kv_len is None else kv_len
    qp = q_offset + np.arange(S, dtype=np.int64)
    hi = np.minimum(qp, kvl - 1)
    lo = np.maximum(0, qp - win + 1)
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    rows = max(0, min(q_offset + S - 1, kvl - 1)
               - max(0, q_offset - win + 1) + 1)
    return pairs, rows


def flash_attention(q, k, v, *, window: Optional[int] = None,
                    q_offset: int = 0, kv_len: Optional[int] = None) -> Work:
    """K7: q read and the output written, the key and value rows the
    unmasked pairs read; QKᵀ and PV over those pairs."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    pairs, rows = attention_pairs(S, T, window, q_offset, kv_len)
    e = q.element_size()
    return (4 * hd * pairs * B * H,
            2 * B * S * H * hd * e + 2 * B * rows * KH * hd * e)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128) -> Work:
    """K8: x, B, C, dt, A read, y and the f32 final state written; per
    chunk the intra-chunk products and the state passes."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    e = x.element_size()
    ops = 0
    for c0 in range(0, s, chunk):
        lc = min(chunk, s - c0)
        ops += lc * (lc + 1) * (n + p) + 4 * lc * p * n
    return (ops * b * h,
            2 * b * s * h * p * e + 2 * b * s * g * n * e + 4 * b * s * h
            + 4 * h + 4 * b * h * p * n)
