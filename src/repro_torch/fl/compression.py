"""Compressed client→server communication — blockwise symmetric
quantization + magnitude top-k sparsification with error feedback.

The counterpart of ``repro/fl/compression.py`` on the host engine.  The
P2 client upload ``δᵢ = wᵢ − w`` is compressed per flat dtype bucket
(``repro_torch.utils.flatten.FlatView``) before it enters the round
aggregate, so the aggregate consumes exactly the values a decompressed
wire payload would carry:

top-k sparsification (``density < 1``)
    Keep the ``k = max(1, ceil(density·n))`` largest-magnitude elements
    of the bucket as the threshold mask ``d·[|d| ≥ τ]``, ``τ`` the k-th
    largest ``|d|`` (ties at τ are all kept).  ``k`` counts the bucket's
    LOGICAL elements; the zero pad lanes of a carried buffer change
    neither τ nor the block scales.

blockwise symmetric quantization (``bits ∈ {8, 16}``)
    Per 128-lane block, ``scale = bf16((amax/qmax)·SCALE_PAD)`` and
    ``c = round(d/scale)·scale`` (half-even, clip ±qmax).

error feedback (``error_feedback=True``)
    The compression error ``r = δ − compress(δ + r_prev)`` is carried
    per client in the engine's client store (``algo_state
    ["ef_residuals"]``, one f32 row per client) and added to the next
    round's delta.

The identity spec (``bits=32, density=1.0``) is statically off.  Lossy
compression composes with neither ``secure_agg`` nor DP; both are
rejected at spec construction (:func:`validate_compression`, the JAX
package's messages).

On the flat path each bucket of each client is one ``topk_compress``
call when sparsifying (on the card one launch up to ``topk_cut()``
elements: the radix select of the threshold with ``compress_delta`` as
its epilogue; above it the threshold's passes, then ``compress_delta``)
or one ``compress_delta`` kernel pass when only quantizing; one
``weighted_delta(deltas=True)`` pass then aggregates the stacked
compressed deltas.  :func:`reference_compress` is the plain
twin (``kernels.fused_update.topk_threshold_plain`` and
``compress_delta_plain``), bit-equal to the JAX package's
``numpy_compress``; :func:`tree_compressed_aggregate` is the tree-path
form, bit-equal to the fused one on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import ops
from repro_torch.kernels.fused_update import LANES

Pytree = Any

# bytes per wire element: quantized values ship at bits/8, coordinates
# of surviving top-k elements as int32, block scales as bf16
_INDEX_BYTES = 4
_SCALE_BYTES = 2
_FULL_BYTES = 4                 # uncompressed deltas ship as f32


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Static compressed-communication parameters for the P2 upload.
    ``bits=32, density=1.0`` is the identity spec — statically off."""
    bits: int = 32
    density: float = 1.0
    error_feedback: bool = False

    def __post_init__(self):
        if self.bits not in (8, 16, 32):
            raise ValueError(f"compression bits must be one of 8|16|32, "
                             f"got {self.bits!r}")
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"compression density must be in (0, 1], "
                             f"got {self.density!r}")
        if self.error_feedback and self.identity:
            raise ValueError(
                "error_feedback=True needs lossy compression (bits<32 or "
                "density<1): the identity spec has a zero residual by "
                "definition")

    @property
    def quantizes(self) -> bool:
        return self.bits != 32

    @property
    def sparsifies(self) -> bool:
        return self.density < 1.0

    @property
    def identity(self) -> bool:
        return not self.quantizes and not self.sparsifies

    @property
    def lossy(self) -> bool:
        return not self.identity


def compression_on(spec: Optional[CompressionSpec]) -> bool:
    """Whether the round aggregate needs the compressed path at all."""
    return spec is not None and spec.lossy


def validate_compression(spec: Optional[CompressionSpec], *,
                         dp=None, secure_agg: bool = False) -> None:
    """Reject invalid mechanism combinations at construction time."""
    if not compression_on(spec):
        return
    if secure_agg:
        raise ValueError(
            "secure_agg=True is incompatible with lossy compression "
            "(bits<32 or density<1): pairwise masks cancel only over "
            "exact-real uploads — quantizing or sparsifying the masked "
            "field breaks the telescoping sum (see docs/ARCHITECTURE.md, "
            "'Compressed communication')")
    if dp is not None:
        raise ValueError(
            "dp is incompatible with lossy compression: the DP "
            "sensitivity bound is certified on the exact clipped delta, "
            "not its quantized form — run DP-FedAvg uncompressed or "
            "compression without DP")


# ---------------------------------------------------------------------------
# top-k threshold
# ---------------------------------------------------------------------------

def topk_k(spec: CompressionSpec, n: int) -> int:
    """Elements kept per bucket of LOGICAL size n (never 0, never > n)."""
    return min(n, max(1, int(math.ceil(spec.density * n))))


def topk_threshold(d: torch.Tensor, k: int, *,
                   interpret: bool = False) -> torch.Tensor:
    """τ = the k-th largest |d| (a 0-dim f32 device tensor), exactly the
    value ``np.partition(|d|, n-k)[n-k]`` selects.  The kernel route (a
    radix select on a CUDA tensor, the plain greedy bit search on a CPU
    tensor), or the plain version with ``interpret``."""
    return ops.fused_topk_threshold(d.reshape(-1).float(), k,
                                    interpret=interpret)


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def reference_compress(d: torch.Tensor, spec: CompressionSpec, *,
                       logical_size: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of ``kernels.ops.fused_compress_delta`` with its
    threshold: ``(c, r)`` for one 1-D delta, the residual against the
    ORIGINAL delta.  ``logical_size`` sets the top-k population when
    ``d`` carries trailing zero padding."""
    d32 = d.float()
    n = d32.shape[-1]
    tau = (_fu.topk_threshold_plain(d32, topk_k(spec, logical_size or n))
           if spec.sparsifies else None)
    return _fu.compress_delta_plain(d32, tau, bits=spec.bits,
                                    topk=spec.sparsifies, with_residual=True)


# ---------------------------------------------------------------------------
# wire accounting — the closed-form payload the ledger checks against
# ---------------------------------------------------------------------------

def payload_bytes(spec: Optional[CompressionSpec], sizes) -> int:
    """Closed-form wire bytes of ONE client's upload over the per-bucket
    LOGICAL element counts ``sizes`` (f32 when uncompressed).  Per lossy
    bucket: kept values at ``bits/8`` bytes, an int32 coordinate per
    kept value when sparsified, one bf16 scale per 128-lane block when
    quantized."""
    total = 0
    for n in sizes:
        if n == 0:
            continue
        if not compression_on(spec):
            total += _FULL_BYTES * n
            continue
        k = topk_k(spec, n) if spec.sparsifies else n
        total += k * (spec.bits // 8)
        if spec.sparsifies:
            total += _INDEX_BYTES * k
        if spec.quantizes:
            total += _SCALE_BYTES * (-(-n // LANES))
    return int(total)


def payload_ratio(spec: Optional[CompressionSpec], sizes) -> float:
    """Uncompressed-over-compressed upload bytes (1.0 when off)."""
    comp = payload_bytes(spec, sizes)
    full = _FULL_BYTES * sum(sizes)
    return (full / comp) if comp else 1.0


# ---------------------------------------------------------------------------
# round aggregates (host engine) — tree form and fused form
# ---------------------------------------------------------------------------

def tree_compressed_aggregate(spec: CompressionSpec, view, params: Pytree,
                              w_locals: Pytree, weights: torch.Tensor,
                              residuals: Optional[Dict[str, torch.Tensor]]
                              = None):
    """The compressed FedAvg aggregate on the TREE path: flatten through
    ``view`` (logical buckets), compress each client's delta with
    :func:`reference_compress`, and aggregate ``cast(p₃₂ + Σₖ w̄ₖ·cₖ)``
    with k ascending — bit-equal to :func:`fused_compressed_aggregate`
    on the CPU.  ``residuals`` are the gathered ``{bucket: (K, n)}`` EF
    rows; returns ``(new_params_tree, new_residuals or None)``."""
    wbar = (weights / torch.sum(weights)).to(torch.float32)
    p_bufs = view.flatten(params)
    stacked = view.flatten_stacked(w_locals)
    new_p: Dict[str, torch.Tensor] = {}
    new_r: Dict[str, torch.Tensor] = {}
    for name, s in stacked.items():
        p32 = p_bufs[name].float()
        d = s.float() - p32[None]
        if residuals is not None:
            d = d + residuals[name]
        cs, rs = zip(*(reference_compress(d[k], spec)
                       for k in range(d.shape[0])))
        acc = torch.zeros_like(p32)
        for k, c in enumerate(cs):
            acc = acc + wbar[k] * c
        new_p[name] = (p32 + acc).to(p_bufs[name].dtype)
        new_r[name] = torch.stack(rs)
    return view.unflatten(new_p), (new_r if spec.error_feedback else None)


def fused_compressed_aggregate(spec: CompressionSpec, fops,
                               p_bufs: Dict[str, torch.Tensor],
                               stacked_bufs: Dict[str, torch.Tensor],
                               weights: torch.Tensor,
                               residuals: Optional[Dict[str, torch.Tensor]]
                               = None):
    """The compressed aggregate on the flat path: per client,
    ``δₖ = stacked[k] − p (+ rₖ)`` → ``(cₖ, rₖ′) = compress(δₖ)`` (one
    ``FlatParamOps.compress_delta`` per client), then ONE
    ``weighted_delta(deltas=True)`` pass per bucket over the stacked
    ``cₖ``: ``cast(p₃₂ + Σₖ w̄ₖ·cₖ)``.  Returns ``(new_p_bufs, new
    residual rows or None)``."""
    wbar = (weights / torch.sum(weights)).to(torch.float32)
    K = next(iter(stacked_bufs.values())).shape[0]
    cs, rs = [], []
    for k in range(K):
        d = {name: s[k].float() - p_bufs[name].float()
             for name, s in stacked_bufs.items()}
        if residuals is not None:
            d = {name: x + residuals[name][k] for name, x in d.items()}
        c, r = fops.compress_delta(d, spec)
        cs.append(c)
        rs.append(r)
    c_stacked = {name: torch.stack([c[name] for c in cs])
                 for name in stacked_bufs}
    new_p = fops.weighted_delta(p_bufs, c_stacked, wbar, deltas=True)
    if not spec.error_feedback:
        return new_p, None
    return new_p, {name: torch.stack([r[name] for r in rs])
                   for name in stacked_bufs}
