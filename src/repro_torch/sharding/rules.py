"""Parameter/batch partition rules: FSDP (data) × tensor/expert (model).

The counterpart of ``repro/sharding/rules.py`` (the parts the pod
backend reads), over the port's own PartitionSpec :class:`P` and any
mesh that has ``axis_names``, ``devices`` (an array in the mesh shape)
and a ``shape`` dict — a :class:`repro_torch.launch.mesh.Mesh`, or a
stand-in that only names the axes.

Layout policy (path-pattern → PartitionSpec, matched by path suffix):
embeddings / lm_head put vocab on ``model`` and d_model on ``data``;
in-projections shard d_in over ``data`` (FSDP) and d_out over ``model``
(TP); out-projections the transpose; MoE expert banks put the expert
axis on ``model``; SSM conv and per-head parameters follow ``model``;
norms and small vectors replicate.  Every rule degrades gracefully: a
dim the axis does not divide replicates on that axis, so the same rules
drive a 16×16 pod, a 2×16×16 multi-pod and a one-rank mesh.

The trainable-slice filters (``TRAINABLE_FILTERS``, ``trainable_mask``)
pick the leaves a PEFT run trains; ``batch_pspecs`` and ``cache_pspecs``
place a step's batch and decode cache (the compile analysis reads them).
"""
from __future__ import annotations

import math
import re
from typing import Any, Optional, Sequence, Tuple

from repro_torch.utils import tree_math as tm

Pytree = Any

DATA, MODEL, POD = "data", "model", "pod"


class P(tuple):
    """A PartitionSpec: one entry per dim — an axis name, a tuple of
    axis names (the dim is sharded over their product), or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def is_pspec(x) -> bool:
    return isinstance(x, P)


# (path regex, spec for the leaf's LOGICAL (unstacked) trailing dims)
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(^|/)embed$",                          (MODEL, DATA)),
    (r"(^|/)lm_head$",                        (DATA, MODEL)),
    (r"/lora_a$",                             (DATA, None)),
    (r"/lora_b$",                             (None, MODEL)),
    (r"(wq|wk|wv|wq_a|wq_b|wkv_a|wkv_b|w_gate|w_up|in_proj|proj)/w$", (DATA, MODEL)),
    (r"(wo|w_down|out_proj)/w$",              (MODEL, DATA)),
    (r"experts/w_gate$",                      (MODEL, DATA, None)),
    (r"experts/w_up$",                        (MODEL, DATA, None)),
    (r"experts/w_down$",                      (MODEL, None, DATA)),
    (r"router/w$",                            (None, None)),
    (r"conv_w$",                              (None, MODEL)),
    (r"conv_b$",                              (MODEL,)),
    (r"(A_log|D|dt_bias)$",                   (None,)),
    (r"(wq|wk|wv|w_gate|w_up|in_proj)/b$",    (MODEL,)),
    (r"/b$",                                  (None,)),
    (r"(scale|bias)$",                        (None,)),
)


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_size(ax, axis_sizes: dict) -> int:
    if isinstance(ax, (tuple, list)):
        return math.prod(axis_sizes.get(a, 1) for a in ax)
    return axis_sizes.get(ax, 1)


def _fit_axes(spec: Sequence, shape: Tuple[int, ...], axis_sizes: dict) -> P:
    """Left-pad to rank; drop axes that don't divide the dim evenly.
    Entries may be axis names or tuples of axis names (combined axes)."""
    spec = list(spec)
    pad = len(shape) - len(spec)
    if pad < 0:                       # leaf smaller than rule (degenerate)
        spec = spec[-len(shape):] if shape else []
        pad = 0
    full = [None] * pad + spec
    out = []
    for dim, ax in zip(shape, full):
        n = _axis_size(ax, axis_sizes)
        if ax is not None and n > 1 and dim % n == 0:
            out.append(tuple(ax) if isinstance(ax, (tuple, list)) else ax)
        else:
            out.append(None)
    return P(*out)


# fsdp_tp: FSDP over data, tensor/expert parallel over model;
# fsdp_only: the first shardable dim over (pod, data, model), no TP;
# replicated: params replicated (the batch still shards)
LAYOUTS = ("fsdp_tp", "fsdp_only", "replicated")


def _apply_layout(rule: Sequence, layout: str, mesh) -> Sequence:
    if layout == "fsdp_tp" or layout not in LAYOUTS:
        return rule
    if layout == "replicated":
        return [None] * len(rule)
    combined = tuple(a for a in (POD, DATA, MODEL) if a in mesh.axis_names)
    out = []
    used = False
    for ax in rule:
        if ax in (DATA, MODEL) and not used:
            out.append(combined)      # first shardable dim gets full FSDP
            used = True
        else:
            out.append(None)
    return out


def param_pspecs(params_tree: Pytree, mesh, layout: str = "fsdp_tp") -> Pytree:
    """PartitionSpec tree matching ``params_tree`` (anything with
    ``.shape`` at the leaves)."""
    axis_sizes = _axis_sizes(mesh)
    leaves, treedef = tm.tree_flatten(params_tree)
    specs = []
    for path, leaf in zip(tm.tree_paths(params_tree), leaves):
        shape = tuple(leaf.shape)
        for pattern, rule in _PARAM_RULES:
            if re.search(pattern, path):
                specs.append(_fit_axes(_apply_layout(rule, layout, mesh),
                                       shape, axis_sizes))
                break
        else:
            specs.append(P())         # unmatched: replicate
    return tm.tree_unflatten(treedef, specs)


# ---------------------------------------------------------------------------
# trainable-slice filters (federated PEFT)
# ---------------------------------------------------------------------------
#
# A trainable filter is a path pattern selecting which leaves the fused
# flat path optimizes and uploads; the other leaves pack into read-only
# "frozen:" buckets that never enter a kernel, the round carry or the
# upload (repro_torch.utils.flatten).  Filters match by path suffix like
# the param rules above.

TRAINABLE_FILTERS = {
    # LoRA adapters: only the A/B factors train, every base weight stays
    # frozen (models.layers.init_lora_linear)
    "lora": r"/(lora_a|lora_b)$",
    # head-only fine-tuning: output head (+ tied embedding) and final norm
    "head": r"((^|/)(embed|lm_head)|norm_f/(scale|bias))$",
}


def resolve_trainable_filter(filter_spec: Optional[str]) -> Optional[str]:
    """A named filter resolves to its registered path regex; anything
    else is taken as a path regex verbatim."""
    if filter_spec is None:
        return None
    return TRAINABLE_FILTERS.get(filter_spec, filter_spec)


def trainable_mask(tree: Pytree, filter_spec: Optional[str]
                   ) -> Optional[Tuple[bool, ...]]:
    """Per-leaf trainable booleans in ``tree_flatten`` order for a
    path-pattern filter (the ``filter=`` of ``FlatView.of`` /
    ``ShardedFlatView.of``).  ``None``: no filter, every leaf trains.  A
    filter that selects zero leaves raises here, at construction."""
    pattern = resolve_trainable_filter(filter_spec)
    if pattern is None:
        return None
    paths = tm.tree_paths(tree)
    mask = tuple(bool(re.search(pattern, p)) for p in paths)
    if paths and not any(mask):
        raise ValueError(
            f"trainable filter {filter_spec!r} (pattern {pattern!r}) "
            f"matches zero leaves of the param tree — nothing would "
            f"train; check the filter against the model's param paths "
            f"(a LoRA filter needs a model built with lora_rank > 0)")
    return mask


# ---------------------------------------------------------------------------
# sharded flat buffers (the pod's fused flat-first carries)
# ---------------------------------------------------------------------------

def sharded_flat_view(params_tree: Pytree, mesh, layout: str = "fsdp_tp",
                      filter_spec: Optional[str] = None):
    """ShardedFlatView for ``params_tree`` under this mesh + layout:
    leaves bucket per (dtype, mesh-axis group) straight from the
    :func:`param_pspecs` rules (see
    ``repro_torch.utils.flatten.ShardedFlatView``).  ``filter_spec`` (a
    trainable filter, see :func:`trainable_mask`) splits the leaves into
    trainable buckets and read-only ``frozen:`` buckets with the same
    per-group decomposition."""
    from repro_torch.utils.flatten import ShardedFlatView
    return ShardedFlatView.of(params_tree,
                              param_pspecs(params_tree, mesh, layout),
                              _axis_sizes(mesh),
                              filter=trainable_mask(params_tree, filter_spec))


def flat_buffer_pspec(group) -> P:
    """PartitionSpec for one ShardGroup's ``(n_shards, per_shard)``
    buffer: the shard axis over the group's mesh axes, per-shard data
    unsharded."""
    if not group.axes:
        return P(None, None)
    entry = group.axes if len(group.axes) > 1 else group.axes[0]
    return P(entry, None)


def frozen_flat_shardings(view) -> dict:
    """The placement (a PartitionSpec) of each FROZEN bucket of a
    ShardedFlatView: the read-only constant keeps the per-group
    decomposition of the trainable buffers, so the frozen base shards
    where its group does and is never replicated beyond it."""
    return {g.name: flat_buffer_pspec(g) for g in view.frozen_groups}


def mesh_axis_size(mesh, axis: str = DATA) -> int:
    """Size of a named mesh axis (1 when the axis is absent)."""
    return _axis_sizes(mesh).get(axis, 1)


def lane_axis_pspec(leaf_rank: int = 3) -> P:
    """Hierarchical-aggregation lane buffers ``(G, n_shards, per_shard)``:
    the pod-lane axis over the mesh ``data`` axis — one pod per data
    shard — each lane's flat tile whole, so the per-lane accumulation is
    shard-local and the cross-pod combine is one all-reduce over
    ``data``."""
    return P(DATA, *([None] * (leaf_rank - 1)))


# ---------------------------------------------------------------------------
# federated batch / client-stack sharding
# ---------------------------------------------------------------------------

def batch_axes(mesh, layout: str = "fsdp_tp") -> Tuple[str, ...]:
    """The mesh axes a batch shards over: (pod, data), or every axis for
    the ``fsdp_only`` and ``replicated`` layouts' step batches
    (``batch_pspecs``).  The pod's federated batch reads the default:
    (pod, data) under every layout."""
    if layout in ("fsdp_only", "replicated"):
        return tuple(a for a in (POD, DATA, MODEL) if a in mesh.axis_names)
    return tuple(a for a in (POD, DATA) if a in mesh.axis_names)


def batch_pspecs(batch_tree: Pytree, mesh, layout: str = "fsdp_tp"
                 ) -> Pytree:
    """Shard every batch leaf's leading batch dim over (pod, data) — over
    ALL axes for the fsdp_only and replicated layouts; when the batch dim
    is too small (long_500k's B 1), shard the sequence dim over ``data``
    instead, so a giant cache still distributes."""
    axis_sizes = _axis_sizes(mesh)
    baxes = batch_axes(mesh, layout)
    b_total = math.prod(axis_sizes[a] for a in baxes)
    n_data = axis_sizes.get(DATA, 1)

    def leaf_spec(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        if shape[0] % b_total == 0 and shape[0] >= b_total:
            return P(baxes if len(baxes) > 1 else baxes[0],
                     *([None] * (len(shape) - 1)))
        # sequence-dim fallback (dim 1 is time for caches and long decode)
        if len(shape) >= 2 and shape[1] % n_data == 0 \
                and shape[1] >= n_data and n_data > 1:
            return P(None, DATA, *([None] * (len(shape) - 2)))
        return P()

    return tm.tree_map(leaf_spec, batch_tree)


def cache_pspecs(cache_tree: Pytree, mesh, batch_size: int) -> Pytree:
    """The KV/SSM decode cache's layout.  Leaves are per-layer ``(B, ...)``
    or stacked ``(L, B, ...)``: the batch dim shards over (pod, data),
    then ONE more dim over ``model`` — the largest trailing dim the axis
    divides (KV heads, MLA's latent rank, the SSM head dim, or the time
    axis when the batch is too small to shard, as long_500k's B 1)."""
    axis_sizes = _axis_sizes(mesh)
    baxes = batch_axes(mesh)
    b_total = math.prod(axis_sizes[a] for a in baxes)
    m = axis_sizes.get(MODEL, 1)

    def leaf_spec(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        # the batch dim: 0 for per-layer leaves, 1 for stacked ones
        bdim = None
        if shape[0] == batch_size:
            bdim = 0
        elif len(shape) > 1 and shape[1] == batch_size:
            bdim = 1
        spec: list = [None] * len(shape)
        if bdim is not None and batch_size % b_total == 0 \
                and batch_size >= b_total:
            spec[bdim] = baxes if len(baxes) > 1 else baxes[0]
        # one model-sharded dim: the largest eligible dim after the batch
        if m > 1:
            start = (bdim + 1) if bdim is not None else 1
            cands = [(shape[d], d) for d in range(start, len(shape))
                     if shape[d] % m == 0 and shape[d] >= m]
            if cands:
                spec[max(cands)[1]] = MODEL
        return P(*spec)

    return tm.tree_map(leaf_spec, cache_tree)


def fl_batch_pspec(mesh, leaf_rank: int, batch_axis: int = 2) -> P:
    """Client batch stacks: shard ONE batch-like axis over (pod, data)
    — axis 2 (B) of a pre-sampled ``(K, t_i, B, ...)`` round, or axis 1
    (the sample pool) of the ``(n_clients, n_per_client, ...)`` data."""
    baxes = batch_axes(mesh)
    ax = baxes if len(baxes) > 1 else baxes[0]
    spec = [None] * leaf_rank
    if leaf_rank > batch_axis:
        spec[batch_axis] = ax
    return P(*spec)


def client_axis_pspec(mesh, leaf_rank: int, n_clients: int) -> P:
    """Stacked per-client leaves ``(n_clients, ...)``: the leading client
    axis over the mesh ``data`` axis (replicated when the client count
    does not divide it)."""
    n = _axis_sizes(mesh).get(DATA, 1)
    if leaf_rank < 1 or n <= 1 or n_clients % n != 0 or n_clients < n:
        return P(*([None] * leaf_rank))
    return P(DATA, *([None] * (leaf_rank - 1)))
