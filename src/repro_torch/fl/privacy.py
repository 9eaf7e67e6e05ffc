"""Security-critical FL primitives — DP-FedAvg clipping/noise and a
secure-aggregation simulation, on the P2 round aggregate.

The counterpart of ``repro/fl/privacy.py`` on the host engine.

DP-FedAvg (:class:`DPSpec`)
    Each client's round delta ``δᵢ = wᵢ − w`` is clipped to ``C`` —
    ``scaleᵢ = min(1, C/(‖δᵢ‖+ε))`` — and Gaussian noise of stddev
    ``σ·C`` per client is added before weighting:

        w⁺ = cast(w₃₂ + Σᵢ w̄ᵢ·scaleᵢ·δᵢ + Σᵢ w̄ᵢ·σC·zᵢ)

    On the fused path the clip scale folds into the aggregation
    coefficient and the noise rides the ``extra`` operand of the
    ``weighted_delta`` kernel: one pass per bucket.
    :func:`materialized_dp_aggregate` is the same upload built for all
    clients of a round by one ``dp_clip_noise_rows`` kernel, then summed.

Secure-aggregation simulation (``secure_agg=True``)
    Clients ``i < j`` both draw ``z`` from their shared pair key and add
    ``+z`` (lower id) / ``−z`` (higher id) after weighting, so
    ``m_ij = −m_ji`` bitwise and the masks of the participant set
    telescope to zero up to float reassociation.

Key derivation.  The JAX package folds threefry keys; the port seeds a
``torch.Generator`` on the device instead, from integers mixed with
``utils.device.fold_in``: the round key is ``fold_in(seed, round)``
(the engine's), the noise of client ``i`` is keyed by
``(round key, DP_NOISE_TAG, i)`` and the mask of pair ``(lo, hi)`` by
``(round key, MASK_TAG, lo, hi)`` with ``lo < hi`` (sorted, so both
endpoints draw the same bits).  Every draw is per leaf
(``FlatView.normal`` / :func:`tree_normal`), so the tree and flat paths
see the same values.  The draws therefore differ from the JAX
package's; :func:`round_extra` takes them through an injectable
``normal_fn(kind, a, b)`` (``kind`` "dp" with ``a`` the client id, or
"mask" with the sorted pair), which the parity tests fill with the JAX
package's threefry draws (``RoundSchedule.noise_draws``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import fold_in

Pytree = Any
# normal_fn(kind, a, b) -> standard-normal f32 draws in the caller's
# representation (buffer dict or tree): kind "dp" (a = client id, b =
# None) or "mask" (a < b, the pair's sorted ids)
NormalFn = Callable[[str, int, Optional[int]], Pytree]

# tags separating the privacy key streams from each other (the JAX
# package's fold_in tags)
DP_NOISE_TAG = 0x6470_0001      # "dp" noise stream
MASK_TAG = 0x6d61_0002          # "ma"sk pairwise stream
_TAGS = {"dp": DP_NOISE_TAG, "mask": MASK_TAG}

# matches the step-tail clip epsilon
CLIP_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DPSpec:
    """Static DP-FedAvg parameters: clip bound ``C`` and noise
    multiplier ``σ`` (noise stddev ``σ·C`` per client before weighting).
    ``clip=inf`` with ``sigma=0`` is the identity mechanism."""
    clip: float
    sigma: float = 0.0

    def __post_init__(self):
        if not self.clip > 0.0:
            raise ValueError(f"DP clip bound must be positive, got "
                             f"{self.clip}")
        if self.sigma < 0.0:
            raise ValueError(f"DP noise multiplier must be >= 0, got "
                             f"{self.sigma}")
        if self.sigma > 0.0 and not math.isfinite(self.clip):
            raise ValueError("DP noise needs a finite clip bound "
                             "(the noise stddev is sigma*clip)")

    @property
    def clips(self) -> bool:
        """Whether clipping is a real (finite-bound) operation."""
        return math.isfinite(self.clip)

    @property
    def noised(self) -> bool:
        return self.sigma > 0.0


def privacy_on(dp: Optional[DPSpec], secure_agg: bool) -> bool:
    """Whether the round aggregate needs the privacy-aware path at all."""
    return dp is not None or secure_agg


# ---------------------------------------------------------------------------
# keys and draws
# ---------------------------------------------------------------------------

def draw_key(round_key: int, kind: str, a: int,
             b: Optional[int] = None) -> int:
    """The generator seed of one draw: ``(round key, tag, a[, b])``."""
    data = (_TAGS[kind], a) if b is None else (_TAGS[kind], a, b)
    return fold_in(round_key, *data)


def keyed_normal_fn(round_key: int, draw: Callable[[int], Pytree]
                    ) -> NormalFn:
    """The default ``normal_fn``: ``draw(seed)`` (``FlatParamOps.normal``
    or :func:`tree_normal`) at the seed :func:`draw_key` derives."""
    return lambda kind, a, b=None: draw(draw_key(round_key, kind, a, b))


def tree_normal(key: int, tree: Pytree, device=None) -> Pytree:
    """Standard-normal f32 tree over ``tree``'s shapes, leaf ``i``
    (tree_flatten order) drawn from a generator seeded with
    ``fold_in(key, i)`` — the same values per parameter as
    ``FlatView.normal(key)``.  Integer leaves draw zeros."""
    leaves, treedef = tm.tree_flatten(tree)
    gen = torch.Generator(device=device or "cpu")
    outs = []
    for i, leaf in enumerate(leaves):
        if leaf.dtype.is_floating_point:
            gen.manual_seed(fold_in(key, i))
            outs.append(torch.randn(tuple(leaf.shape), generator=gen,
                                    dtype=torch.float32, device=device))
        else:
            outs.append(torch.zeros(tuple(leaf.shape), dtype=torch.float32,
                                    device=device))
    return tm.tree_unflatten(treedef, outs)


def pair_sign(cid: int, other: int) -> float:
    """+1 for the lower id, −1 for the higher, 0 for self — the sign
    convention that makes ``m_ij = −m_ji`` hold bitwise."""
    return float((other > cid) - (other < cid))


# ---------------------------------------------------------------------------
# clip scales
# ---------------------------------------------------------------------------

def clip_scale(dp: DPSpec, sq: torch.Tensor) -> torch.Tensor:
    """``min(1, C/(‖δ‖+ε))`` from a squared delta norm (any shape).  The
    division is tensor by tensor (``C / t`` would multiply by ``t``'s
    reciprocal)."""
    norm = torch.sqrt(sq) + CLIP_EPS
    return torch.clamp(torch.full_like(norm, dp.clip) / norm,
                       max=1.0).to(torch.float32)


def flat_delta_sqnorm(w_bufs: Dict[str, torch.Tensor],
                      p_bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """‖w − p‖² over every bucket for ONE client (pad lanes are zero in
    both operands and add nothing)."""
    return sum(torch.sum((w.float() - p_bufs[name].float()) ** 2)
               for name, w in w_bufs.items())


def tree_delta_sqnorm(w_end: Pytree, params: Pytree) -> torch.Tensor:
    """‖w − p‖² over every leaf for ONE client (tree path)."""
    return sum(torch.sum((w.float() - p.float()) ** 2)
               for w, p in zip(tm.tree_leaves(w_end), tm.tree_leaves(params)))


def stacked_clip_scales(dp: Optional[DPSpec], params_leaves,
                        stacked_leaves) -> Optional[torch.Tensor]:
    """Per-client ``(K,)`` clip scales from stacked (K, ...) locals (leaf
    lists — shared by the tree and flat aggregates).  ``None`` when
    clipping is statically off."""
    if dp is None or not dp.clips:
        return None
    sq = sum(torch.sum((wl.float() - p.float()[None]) ** 2,
                       dim=tuple(range(1, wl.dim())))
             for p, wl in zip(params_leaves, stacked_leaves))
    return clip_scale(dp, sq)


# ---------------------------------------------------------------------------
# the round's additive extra: Σᵢ (w̄ᵢ·σC·zᵢ + mᵢ)
# ---------------------------------------------------------------------------

def _axpy(acc: Pytree, s, z: Pytree) -> Pytree:
    return tm.tree_map(lambda a, b: a + s * b, acc, z)


def client_mask(cid: int, ids: Sequence[int], normal_fn: NormalFn,
                zeros_fn: Callable) -> Pytree:
    """Client ``cid``'s secure-agg mask against participant set ``ids``:
    ``mᵢ = Σⱼ sign(idsⱼ − cid)·normal(pair key)``, j in order.  The self
    term (sign 0) adds nothing and is not drawn."""
    m = zeros_fn()
    for other in ids:
        if other == cid:
            continue
        z = normal_fn("mask", min(cid, other), max(cid, other))
        m = _axpy(m, pair_sign(cid, other), z)
    return m


def round_extra(dp: Optional[DPSpec], secure_agg: bool, ids: Sequence[int],
                wbar: torch.Tensor, *, zeros_fn: Callable,
                normal_fn: NormalFn) -> Optional[Pytree]:
    """The additive privacy term of one round's aggregate:
    ``Σᵢ (w̄ᵢ·σC·zᵢ + mᵢ)``, clients in ``ids`` order, in whatever f32
    representation ``zeros_fn``/``normal_fn`` speak.  None when both
    mechanisms are off.  ``ids`` are host integers: the draws are keyed
    by client id.  The masks are built per client (each pair drawn from
    EACH endpoint), the honest O(K²) simulation."""
    noised = dp is not None and dp.noised
    if not noised and not secure_agg:
        return None
    ids = [int(i) for i in ids]
    acc = zeros_fn()
    for i, cid in enumerate(ids):
        if noised:
            acc = _axpy(acc, wbar[i] * (dp.sigma * dp.clip),
                        normal_fn("dp", cid, None))
        if secure_agg:
            acc = tm.tree_map(torch.add, acc,
                              client_mask(cid, ids, normal_fn, zeros_fn))
    return acc


# ---------------------------------------------------------------------------
# round aggregates (host engine)
# ---------------------------------------------------------------------------

def tree_dp_aggregate(dp: Optional[DPSpec], secure_agg: bool,
                      ids: Sequence[int], params: Pytree, w_locals: Pytree,
                      weights: torch.Tensor, normal_fn: NormalFn) -> Pytree:
    """The privacy-aware FedAvg aggregate over stacked (K, ...) local
    trees: ``cast(p₃₂ + Σₖ w̄ₖ·scaleₖ·(wₖ − p) + extra)`` per leaf;
    ``normal_fn`` speaks trees."""
    wbar = (weights / torch.sum(weights)).to(torch.float32)
    scales = stacked_clip_scales(dp, tm.tree_leaves(params),
                                 tm.tree_leaves(w_locals))
    coeffs = wbar if scales is None else wbar * scales
    extra = round_extra(
        dp, secure_agg, ids, wbar,
        zeros_fn=lambda: tm.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params),
        normal_fn=normal_fn)

    def leaf(p, wl, e=None):
        p32 = p.float()
        d = torch.tensordot(coeffs, wl.float() - p32[None], dims=1)
        if e is not None:
            d = d + e
        return (p32 + d).to(p.dtype)

    if extra is None:
        return tm.tree_map(leaf, params, w_locals)
    return tm.tree_map(leaf, params, w_locals, extra)


def fused_dp_aggregate(dp: Optional[DPSpec], secure_agg: bool, fops,
                       ids: Sequence[int], p_bufs: Dict[str, torch.Tensor],
                       stacked_bufs: Dict[str, torch.Tensor],
                       weights: torch.Tensor,
                       normal_fn: NormalFn) -> Dict[str, torch.Tensor]:
    """The same aggregate on the flat path: the clip scales fold into
    the aggregation coefficients and the noise + mask total rides the
    ``extra`` operand of ONE ``weighted_delta`` kernel per bucket;
    ``normal_fn`` speaks padded buffer dicts."""
    wbar = (weights / torch.sum(weights)).to(torch.float32)
    names = list(stacked_bufs)
    scales = stacked_clip_scales(dp, [p_bufs[n] for n in names],
                                 [stacked_bufs[n] for n in names])
    coeffs = wbar if scales is None else wbar * scales
    extra = round_extra(dp, secure_agg, ids, wbar,
                        zeros_fn=lambda: fops.zeros(torch.float32),
                        normal_fn=normal_fn)
    return fops.weighted_delta(p_bufs, stacked_bufs, coeffs, extra=extra)


def materialized_dp_aggregate(dp: DPSpec, secure_agg: bool, fops,
                              ids: Sequence[int],
                              p_bufs: Dict[str, torch.Tensor],
                              stacked_bufs: Dict[str, torch.Tensor],
                              weights: torch.Tensor,
                              normal_fn: NormalFn) -> Dict[str, torch.Tensor]:
    """The upload form of :func:`fused_dp_aggregate`: client k's upload
    ``uₖ = scaleₖ·δₖ + σC·zₖ`` is built from the same draws (stacked once
    per bucket) by ONE ``dp_clip_noise_rows`` launch per bucket for all
    K clients, straight into the ``(K, N)`` f32 stack that one
    ``weighted_delta(deltas=True)`` per bucket sums into
    ``cast(p₃₂ + masks + Σₖ w̄ₖ·uₖ)`` with the mask total as ``extra``
    (the f32 uploads aggregate over buffers of any param dtype).  Bitwise
    the uploads of one ``dp_clip_noise`` per client; equal to the folded
    aggregate up to f32 reassociation."""
    wbar = (weights / torch.sum(weights)).to(torch.float32)
    names = list(stacked_bufs)
    scales = stacked_clip_scales(dp, [p_bufs[n] for n in names],
                                 [stacked_bufs[n] for n in names])
    if scales is None:
        scales = torch.ones_like(wbar)
    noise_scale = torch.full_like(wbar[0], dp.sigma * dp.clip
                                  if dp.noised else 0.0)
    ids = [int(i) for i in ids]
    z = None
    if dp.noised:
        draws = [normal_fn("dp", cid, None) for cid in ids]
        z = {n: torch.stack([dr[n] for dr in draws]) for n in names}
    uploads = fops.dp_clip_noise_rows(p_bufs, stacked_bufs, z, scales,
                                      noise_scale)
    masks = round_extra(None, secure_agg, ids, wbar,
                        zeros_fn=lambda: fops.zeros(torch.float32),
                        normal_fn=normal_fn)
    return fops.weighted_delta(p_bufs, uploads, wbar, extra=masks,
                               deltas=True)
