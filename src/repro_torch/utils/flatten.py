"""FlatView — pack a tree of tensors into contiguous per-dtype 1-D buffers.

The counterpart of ``repro/utils/flatten.py:FlatView``, with the same
contract:

  view = FlatView.of(tree)          # shapes/dtypes only
  bufs = view.flatten(tree)         # {dtype_name: (total,) 1-D buffer}
  tree == view.unflatten(bufs)      # exact round-trip, any nesting

Leaves are taken in jax.tree_util order (dict keys sorted, see
``tree_math.tree_flatten``) and grouped by dtype name ("float32",
"bfloat16", ...) in first-seen order; each owns a static ``[offset,
offset + size)`` slice of its buffer, so a port buffer equals the JAX
package's buffer element for element.

Trainable-slice partitioning (federated PEFT): ``of(tree, filter=...)``
takes a per-leaf boolean mask (True = trainable, tree_flatten order;
``repro_torch.sharding.rules.trainable_mask`` builds one) and routes
frozen leaves into ``"frozen:"``-prefixed buckets with offsets of their
own.  ``flatten``, ``zeros``, ``normal``, the stacked variants and
``buffer_sizes`` then speak the TRAINABLE buckets only; the frozen
leaves pack once through ``flatten_frozen`` and merge back at
``unflatten(bufs, frozen)`` (absent frozen buckets zero-fill).  With
``filter=None`` there are no frozen buckets.

``unflatten`` returns VIEWS into the buffers.  When a buffer requires
grad, the views come from one autograd node per bucket whose backward
concatenates the leaf gradients into a single packed gradient (pad lanes
zero) — the counterpart of the JAX package differentiating with respect
to the flat buffers, so the fused step tail consumes the gradient with
no per-step pack.  Frozen buffers never require grad: no node spans
them, and autograd computes no gradient for a frozen weight.

:class:`ShardedFlatView` is the mesh-aware sibling (the pod backend's):
leaves bucket per (dtype, mesh-axis group) into ``(n_shards,
per_shard)`` buffers, the JAX package's layout element for element,
tile permutation included; frozen leaves keep their group.  A rank
holds one row of each bucket: each leaf's local tile, packed
(:meth:`ShardedFlatView.flatten_local`, laid out by
:meth:`ShardedFlatView.local_view`).  The model sees whole leaves: the
rows gathered over a bucket's axes go back into the leaves of
:meth:`ShardedFlatView.whole_view` (:meth:`ShardedFlatView.rows_to_whole`),
and a whole-leaf gradient comes back as the bucket's rows
(:meth:`ShardedFlatView.whole_to_rows`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.utils.device import fold_in
from repro_torch.utils.tree_math import (tree_flatten, tree_paths,
                                         tree_unflatten)

Pytree = Any


def dtype_name(dtype) -> str:
    """Canonical dtype name for a torch or numpy dtype ("float32")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return dtype.name


def torch_dtype(name: str) -> torch.dtype:
    """The dtype of a bucket from its name (a dtype name, possibly with
    the frozen prefix and the ``@axes`` of a sharded group)."""
    name = name[len(FROZEN_PREFIX):] if is_frozen_bucket(name) else name
    return getattr(torch, name.partition("@")[0])


# frozen leaves pack into buckets under this name prefix; the plain
# bucket name (dtype / dtype@axes) follows it unchanged
FROZEN_PREFIX = "frozen:"


def _merged_runs(runs) -> Tuple[Tuple[int, int], ...]:
    """``(offset, size)`` runs in order, adjacent ones joined."""
    out = []
    for o, k in runs:
        if out and out[-1][0] + out[-1][1] == o:
            out[-1] = (out[-1][0], out[-1][1] + k)
        else:
            out.append((o, k))
    return tuple(out)


def take_runs(row: torch.Tensor, runs) -> torch.Tensor:
    """The elements of ``row`` (along its last dim) in ``runs``, in
    order: ``row[..., index]`` for the index the runs spell, without
    forming it."""
    pieces = [row[..., o:o + k] for o, k in runs]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)


def put_runs(out: torch.Tensor, runs, src: torch.Tensor) -> torch.Tensor:
    """``out[..., index] = src`` for the index ``runs`` spell (in place)."""
    pos = 0
    for o, k in runs:
        out[..., o:o + k].copy_(src[..., pos:pos + k])
        pos += k
    return out


def is_frozen_bucket(name: str) -> bool:
    return name.startswith(FROZEN_PREFIX)


def _check_filter(filter, n_leaves: int):
    """Normalize a per-leaf trainable mask (None = all trainable)."""
    if filter is None:
        return None
    mask = tuple(bool(b) for b in filter)
    if len(mask) != n_leaves:
        raise ValueError(f"trainable filter has {len(mask)} entries for a "
                         f"{n_leaves}-leaf tree")
    return mask


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's static slice of its dtype buffer."""
    buffer: str                 # canonical dtype name, e.g. "float32"
    offset: int                 # element offset into the buffer
    size: int                   # number of elements (1 for scalar leaves)
    shape: Tuple[int, ...]      # original leaf shape


class _LeafViews(torch.autograd.Function):
    """Leaf views of one bucket whose backward packs the leaf gradients
    into ONE buffer-shaped gradient (a single concatenate)."""

    @staticmethod
    def forward(ctx, buf, slots):
        ctx.slots = slots
        ctx.n = buf.shape[-1]
        return tuple(buf[s.offset:s.offset + s.size].view(s.shape)
                     for s in slots)

    @staticmethod
    def backward(ctx, *grads):
        parts = [g.reshape(-1) for g in grads]
        end = ctx.slots[-1].offset + ctx.slots[-1].size
        if ctx.n > end:                 # grid pad lanes: zero gradient
            parts.append(grads[0].new_zeros(ctx.n - end))
        return torch.cat(parts), None


@dataclasses.dataclass(frozen=True)
class FlatView:
    """Static packing plan for one tree structure (see module doc)."""
    treedef: Any
    slots: Tuple[LeafSlot, ...]

    @classmethod
    def of(cls, tree: Pytree, filter=None) -> "FlatView":
        """Build a view from shapes/dtypes only (torch tensors, meta
        tensors or numpy arrays).  ``filter`` is an optional per-leaf
        trainable mask: False routes the leaf into a ``frozen:`` bucket."""
        leaves, treedef = tree_flatten(tree)
        mask = _check_filter(filter, len(leaves))
        sizes: Dict[str, int] = {}
        slots = []
        for i, leaf in enumerate(leaves):
            name = dtype_name(leaf.dtype)
            if mask is not None and not mask[i]:
                name = FROZEN_PREFIX + name
            size = int(math.prod(leaf.shape))
            off = sizes.get(name, 0)
            slots.append(LeafSlot(buffer=name, offset=off, size=size,
                                  shape=tuple(leaf.shape)))
            sizes[name] = off + size
        return cls(treedef=treedef, slots=tuple(slots))

    @property
    def all_sizes(self) -> Dict[str, int]:
        """Total elements per bucket, trainable and frozen, first-seen
        order."""
        sizes: Dict[str, int] = {}
        for s in self.slots:
            sizes[s.buffer] = s.offset + s.size
        return sizes

    @property
    def buffer_sizes(self) -> Dict[str, int]:
        """Total elements per TRAINABLE dtype buffer, first-seen order
        (everything a round optimizes and uploads)."""
        return {n: k for n, k in self.all_sizes.items()
                if not is_frozen_bucket(n)}

    @property
    def frozen_sizes(self) -> Dict[str, int]:
        """Total elements per frozen bucket ({} without a filter)."""
        return {n: k for n, k in self.all_sizes.items()
                if is_frozen_bucket(n)}

    @property
    def total_size(self) -> int:
        return sum(self.buffer_sizes.values())

    def _check(self, tree: Pytree) -> list:
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure mismatch with this FlatView")
        return leaves

    def _pack(self, tree: Pytree, frozen: bool) -> Dict[str, torch.Tensor]:
        parts: Dict[str, list] = {}
        for slot, leaf in zip(self.slots, self._check(tree)):
            if is_frozen_bucket(slot.buffer) == frozen:
                parts.setdefault(slot.buffer, []).append(leaf.reshape(-1))
        return {name: torch.cat(chunks) for name, chunks in parts.items()}

    def flatten(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """Pack ``tree``'s trainable leaves into ``{dtype_name: (total,)
        buffer}`` (a copy; every leaf without a filter)."""
        return self._pack(tree, frozen=False)

    def flatten_frozen(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """Pack the FROZEN leaves into their ``frozen:`` buckets — the
        once-per-phase read-only constant ({} without a filter)."""
        return self._pack(tree, frozen=True)

    def frozen_zeros(self, device=None) -> Dict[str, torch.Tensor]:
        """Zero frozen buckets at their dtypes: the fill-in for
        unflattening a trainable-only tree (server moments, deltas)."""
        return {name: torch.zeros((size,), dtype=torch_dtype(name),
                                  device=device)
                for name, size in self.frozen_sizes.items()}

    def _merged(self, bufs: Dict[str, torch.Tensor],
                frozen: Optional[Dict[str, torch.Tensor]]):
        if not self.frozen_sizes:
            return bufs
        device = next(iter(bufs.values())).device if bufs else None
        return dict(bufs, **(frozen if frozen else
                             self.frozen_zeros(device)))

    def unflatten(self, bufs: Dict[str, torch.Tensor],
                  frozen: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Pytree:
        """Inverse of :meth:`flatten`: leaves are views of ``bufs``
        (which may carry grid padding past the logical size).  With a
        filter, ``frozen`` supplies the ``frozen:`` buckets
        (:meth:`flatten_frozen`); absent, they zero-fill."""
        bufs = self._merged(bufs, frozen)
        leaves = [None] * len(self.slots)
        for name in self.all_sizes:
            idx = [i for i, s in enumerate(self.slots) if s.buffer == name]
            buf = bufs[name]
            if buf.requires_grad and torch.is_grad_enabled():
                views = _LeafViews.apply(
                    buf, tuple(self.slots[i] for i in idx))
            else:
                views = [buf[self.slots[i].offset:self.slots[i].offset +
                             self.slots[i].size].view(self.slots[i].shape)
                         for i in idx]
            for i, v in zip(idx, views):
                leaves[i] = v
        return tree_unflatten(self.treedef, leaves)

    def trainable_by_path(self, bufs: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
        """Views of the trainable buckets ``bufs`` as ``{path: leaf}``
        (``tree_paths`` of the tree), the frozen leaves left out."""
        paths = tree_paths(tree_unflatten(self.treedef, [0] * len(self.slots)))
        return {path: bufs[s.buffer][s.offset:s.offset + s.size].view(
            s.shape) for path, s in zip(paths, self.slots)
            if not is_frozen_bucket(s.buffer)}

    def flatten_stacked(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """Pack a tree whose (trainable) leaves carry one shared leading
        axis K into ``{dtype_name: (K, total)}`` buffers."""
        parts: Dict[str, list] = {}
        for slot, leaf in zip(self.slots, self._check(tree)):
            if not is_frozen_bucket(slot.buffer):
                parts.setdefault(slot.buffer, []).append(
                    leaf.reshape(leaf.shape[0], -1))
        return {name: torch.cat(chunks, dim=1)
                for name, chunks in parts.items()}

    def unflatten_stacked(self, bufs: Dict[str, torch.Tensor],
                          frozen: Optional[Dict[str, torch.Tensor]] = None
                          ) -> Pytree:
        """Inverse of :meth:`flatten_stacked` (views).  With a filter,
        frozen slots broadcast the shared 1-D ``frozen`` bucket
        (zero-filled when absent) over the K axis.  The empty tree
        round-trips to itself."""
        K = next(iter(bufs.values())).shape[0] if bufs else 0
        bufs = self._merged(bufs, frozen)
        leaves = []
        for s in self.slots:
            buf = bufs[s.buffer]
            if is_frozen_bucket(s.buffer):
                row = buf[s.offset:s.offset + s.size].view(s.shape)
                leaves.append(row.expand((K,) + s.shape))
            else:
                leaves.append(buf[:, s.offset:s.offset + s.size].reshape(
                    (K,) + s.shape))
        return tree_unflatten(self.treedef, leaves)

    def zeros(self, dtype=None, device=None) -> Dict[str, torch.Tensor]:
        """Zero trainable buffers with this view's sizes; ``dtype``
        overrides the per-buffer dtype (e.g. an f32 accumulator over bf16
        params)."""
        return {name: torch.zeros((size,), dtype=dtype or torch_dtype(name),
                                  device=device)
                for name, size in self.buffer_sizes.items()}

    def normal(self, key: int, device=None) -> Dict[str, torch.Tensor]:
        """Standard-normal f32 buffers over this plan, drawn PER LEAF:
        leaf ``i`` (tree_flatten order) draws at its own shape from a
        generator on ``device`` seeded with ``fold_in(key, i)``, then
        packs like :meth:`flatten`.  The draws do not depend on the
        packing, so ``repro_torch.fl.privacy.tree_normal`` gives the
        same values per parameter.  Integer leaves draw zeros; frozen
        leaves emit nothing (``i`` stays the global slot index)."""
        gen = torch.Generator(device=device or "cpu")
        parts: Dict[str, list] = {}
        for i, slot in enumerate(self.slots):
            if is_frozen_bucket(slot.buffer):
                continue
            if torch_dtype(slot.buffer).is_floating_point:
                gen.manual_seed(fold_in(key, i))
                draw = torch.randn(slot.shape, generator=gen,
                                   dtype=torch.float32, device=device)
            else:
                draw = torch.zeros(slot.shape, dtype=torch.float32,
                                   device=device)
            parts.setdefault(slot.buffer, []).append(draw.reshape(-1))
        return {name: torch.cat(chunks) for name, chunks in parts.items()}


# ---------------------------------------------------------------------------
# sharded flat view — per-(dtype × mesh-axis-group) buffers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedLeafSlot:
    """One leaf's static slice of its bucket, PER SHARD."""
    buffer: str                   # bucket name, e.g. "float32@data+model"
    offset: int                   # element offset within each shard row
    size: int                     # elements per shard for this leaf
    shape: Tuple[int, ...]        # global (unsharded) leaf shape
    # mesh axes tiling each dim, in the dim's tiling order (() = unsharded)
    dim_axes: Tuple[Tuple[str, ...], ...]


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """One bucket: all leaves of one dtype sharded over one axis set."""
    name: str
    dtype: str
    axes: Tuple[str, ...]         # canonical (mesh) order; () = replicated
    n_shards: int
    size: int                     # elements per shard (bucket total)


def _spec_entries(pspec, rank: int) -> Tuple[Tuple[str, ...], ...]:
    """Normalize a PartitionSpec-like into per-dim axis-name tuples,
    right-padded with () to the leaf rank."""
    entries = tuple(pspec) if pspec is not None else ()
    out = []
    for e in entries:
        if e is None:
            out.append(())
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    out += [()] * (rank - len(out))
    return tuple(out[:rank])


@dataclasses.dataclass(frozen=True)
class ShardedFlatView:
    """Static packing plan bucketing leaves per (dtype, mesh-axis group),
    the counterpart of ``repro/utils/flatten.py:ShardedFlatView`` with
    the same layout element for element.

    Each bucket's buffer is ``(n_shards, per_shard)``: axis 0 enumerates
    the shards of the group's mesh axes in canonical (mesh-order)
    row-major order, and every leaf owns the static per-shard slice
    ``[offset, offset + size)`` of axis 1 — so the rank at a given mesh
    coordinate holds each leaf's local tile in one contiguous run of its
    row (:meth:`local_rows`).  Size-1 axes never shard anything and are
    dropped, so a one-rank mesh gives one replicated row per dtype: the
    :class:`FlatView` layout (:meth:`local_view`)."""
    treedef: Any
    slots: Tuple[ShardedLeafSlot, ...]
    groups: Tuple[ShardGroup, ...]
    axis_sizes: Tuple[Tuple[str, int], ...]   # canonical order, all axes

    @classmethod
    def of(cls, tree: Pytree, pspecs: Pytree,
           axis_sizes: Dict[str, int], filter=None) -> "ShardedFlatView":
        """Build a view from leaf shapes/dtypes plus a matching
        PartitionSpec tree (``repro_torch.sharding.rules.param_pspecs``);
        ``axis_sizes`` maps mesh axis name → size in mesh order.
        ``filter`` is the per-leaf trainable mask (see :class:`FlatView`):
        frozen leaves bucket into ``frozen:``-prefixed groups that keep
        their (dtype × mesh-axis group) decomposition."""
        from repro_torch.sharding.rules import is_pspec
        leaves, treedef = tree_flatten(tree)
        mask = _check_filter(filter, len(leaves))
        spec_leaves, _ = tree_flatten(
            pspecs, is_leaf=lambda x: x is None or is_pspec(x))
        if len(spec_leaves) != len(leaves):
            raise ValueError(
                f"pspec tree has {len(spec_leaves)} leaves for a "
                f"{len(leaves)}-leaf param tree")
        order = tuple(axis_sizes)
        cursor: Dict[str, int] = {}
        meta: Dict[str, Tuple[str, Tuple[str, ...], int]] = {}
        slots = []
        for i, (leaf, pspec) in enumerate(zip(leaves, spec_leaves)):
            shape = tuple(leaf.shape)
            dtype = dtype_name(leaf.dtype)
            dim_axes = tuple(
                tuple(a for a in entry if axis_sizes.get(a, 1) > 1)
                for entry in _spec_entries(pspec, len(shape)))
            used = [a for entry in dim_axes for a in entry]
            if len(set(used)) != len(used):
                raise ValueError(f"mesh axis repeated in spec {pspec}")
            for dim, entry in zip(shape, dim_axes):
                n = math.prod(axis_sizes[a] for a in entry)
                if n > 1 and dim % n != 0:
                    raise ValueError(
                        f"dim {dim} not divisible by axes {entry} ({n})")
            axes = tuple(a for a in order if a in used)
            n_shards = math.prod(axis_sizes[a] for a in axes)
            name = dtype + ("@" + "+".join(axes) if axes else "")
            if mask is not None and not mask[i]:
                name = FROZEN_PREFIX + name
            size = int(math.prod(shape)) // max(n_shards, 1)
            off = cursor.get(name, 0)
            slots.append(ShardedLeafSlot(buffer=name, offset=off, size=size,
                                         shape=shape, dim_axes=dim_axes))
            cursor[name] = off + size
            meta[name] = (dtype, axes, n_shards)
        groups = tuple(ShardGroup(name=name, dtype=m[0], axes=m[1],
                                  n_shards=m[2], size=cursor[name])
                       for name, m in meta.items())
        return cls(treedef=treedef, slots=tuple(slots), groups=groups,
                   axis_sizes=tuple((a, int(axis_sizes[a])) for a in order))

    @property
    def trainable_groups(self) -> Tuple[ShardGroup, ...]:
        return tuple(g for g in self.groups if not is_frozen_bucket(g.name))

    @property
    def frozen_groups(self) -> Tuple[ShardGroup, ...]:
        return tuple(g for g in self.groups if is_frozen_bucket(g.name))

    def _axis_size(self, name: str) -> int:
        return dict(self.axis_sizes)[name]

    def local_rows(self, coords: Dict[str, int]) -> Dict[str, int]:
        """The row of each bucket that the rank at mesh coordinates
        ``coords`` (axis → index) holds: its row-major index over the
        group's axes (0 for a replicated group)."""
        rows = {}
        for g in self.groups:
            i = 0
            for a in g.axes:
                i = i * self._axis_size(a) + int(coords.get(a, 0))
            rows[g.name] = i
        return rows

    @functools.cached_property
    def group_map(self) -> Dict[str, ShardGroup]:
        return {g.name: g for g in self.groups}

    def _tile_shape(self, slot: ShardedLeafSlot) -> Tuple[int, ...]:
        """The shape of one rank's tile of a leaf: each dim divided by the
        product of the axes that tile it."""
        return tuple(dim // math.prod(self._axis_size(a) for a in entry)
                     for dim, entry in zip(slot.shape, slot.dim_axes))

    def local_view(self) -> FlatView:
        """The rank-local layout as a :class:`FlatView`: the same buckets
        (frozen ones included) and per-shard offsets, each slot one
        leaf's local tile.  A shard row is its tiles packed in row-major
        order (the factor axes of ``_leaf_to_shards`` lead, the blocks
        follow in dim order), so every per-shard size, offset and the
        top-k population of a bucket is the view's.  With every group
        replicated it is the host :class:`FlatView` of the tree."""
        return FlatView(treedef=self.treedef, slots=tuple(
            LeafSlot(buffer=s.buffer, offset=s.offset, size=s.size,
                     shape=self._tile_shape(s)) for s in self.slots))

    @functools.cached_property
    def _whole_view(self) -> FlatView:
        slots, sizes = [], {}
        for s in self.slots:
            name = s.buffer.partition("@")[0]
            size = int(math.prod(s.shape))
            off = sizes.get(name, 0)
            slots.append(LeafSlot(buffer=name, offset=off, size=size,
                                  shape=s.shape))
            sizes[name] = off + size
        return FlatView(treedef=self.treedef, slots=tuple(slots))

    def whole_view(self) -> FlatView:
        """The layout of whole leaves: one bucket per dtype (and
        ``frozen:`` dtype), the :class:`FlatView` of the tree under the
        same filter — what a one-rank mesh carries.  A gathered model
        lives in its buffers, so its leaves sit at the offsets of a
        replicated run's."""
        return self._whole_view

    def model_local(self, local, axis: str = "model"):
        """The model-local layout: each leaf whole over its other axes
        and, where ``local[i]`` (tree_flatten order), only this rank's
        tile over ``axis`` — the tree a tensor-parallel step computes on.

        Returns ``(view, parts)``.  ``view`` is a ShardedFlatView over the
        same per-shard rows in which each bucket sharded over ``axis``
        splits into a ``|local`` part (its local leaves: ``axis`` dropped
        from the part's axes, each slot's shape its tile over ``axis``)
        and a ``|whole`` part (its other leaves, gathered over every axis
        as before); ``view.whole_view()`` is the model-local layout.
        ``parts[bucket]`` lists ``(part, runs)``: the part's elements in
        the bucket's row as ``(offset, size)`` runs in row order (one per
        run of adjacent leaves; :func:`take_runs`, :func:`put_runs`),
        ``runs`` None when the part is the whole row.
        A dim tiled by ``axis`` and another axis together has no
        contiguous ``axis`` tile: such a local leaf raises."""
        m = self._axis_size(axis) if axis in dict(self.axis_sizes) else 1
        slots, cursor, meta, runs = [], {}, {}, {}
        for s, keep in zip(self.slots, local):
            g = self.group_map[s.buffer]
            name, dim_axes, shape, axes = s.buffer, s.dim_axes, s.shape, \
                g.axes
            if m > 1 and axis in g.axes:
                if keep:
                    if any(axis in e and len(e) > 1 for e in s.dim_axes):
                        raise ValueError(f"a dim tiled by {axis!r} and "
                                         f"another axis: {s.dim_axes}")
                    name = s.buffer + "|local"
                    dim_axes = tuple(tuple(a for a in e if a != axis)
                                     for e in s.dim_axes)
                    shape = tuple(d // m if axis in e else d
                                  for d, e in zip(s.shape, s.dim_axes))
                    axes = tuple(a for a in g.axes if a != axis)
                else:
                    name = s.buffer + "|whole"
            off = cursor.get(name, 0)
            slots.append(ShardedLeafSlot(buffer=name, offset=off,
                                         size=s.size, shape=shape,
                                         dim_axes=dim_axes))
            cursor[name] = off + s.size
            meta[name] = (g.dtype, axes,
                          math.prod(self._axis_size(a) for a in axes))
            runs.setdefault(s.buffer, {}).setdefault(name, []).append(
                (s.offset, s.size))
        view = ShardedFlatView(
            treedef=self.treedef, slots=tuple(slots), axis_sizes=self.axis_sizes,
            groups=tuple(ShardGroup(name=n, dtype=d, axes=a, n_shards=k,
                                    size=cursor[n])
                         for n, (d, a, k) in meta.items()))
        parts = {}
        for bucket, by_part in runs.items():
            size = self.group_map[bucket].size
            parts[bucket] = tuple(
                (name, None if len(by_part) == 1 and cursor[name] == size
                 else _merged_runs(r))
                for name, r in by_part.items())
        return view, parts

    def _local_tile(self, leaf: torch.Tensor, slot: ShardedLeafSlot,
                    coords: Dict[str, int]) -> torch.Tensor:
        """The rank at ``coords``'s tile of ``leaf`` (a view): along each
        dim, block number row-major over the dim's axes."""
        for d, entry in enumerate(slot.dim_axes):
            if not entry:
                continue
            i, n = 0, 1
            for a in entry:
                i = i * self._axis_size(a) + int(coords.get(a, 0))
                n *= self._axis_size(a)
            blk = leaf.shape[d] // n
            leaf = leaf.narrow(d, i * blk, blk)
        return leaf

    def flatten_local(self, tree: Pytree, coords: Dict[str, int], *,
                      frozen: bool = False) -> Dict[str, torch.Tensor]:
        """The rank at ``coords``'s row of every trainable bucket (or of
        every ``frozen:`` bucket), packed from its tiles only — equal to
        ``flatten(tree)[name][local_rows(coords)[name]]`` without forming
        the other rows."""
        parts: Dict[str, list] = {}
        for slot, leaf in zip(self.slots, self._check(tree)):
            if is_frozen_bucket(slot.buffer) == frozen:
                parts.setdefault(slot.buffer, []).append(
                    self._local_tile(leaf, slot, coords).reshape(-1))
        return {name: torch.cat(chunks) for name, chunks in parts.items()}

    def normal_local(self, key: int, coords: Dict[str, int],
                     device=None) -> Dict[str, torch.Tensor]:
        """The rank's rows of standard-normal f32 trainable buckets: each
        leaf draws at its GLOBAL shape from ``fold_in(key, i)`` (as
        :meth:`FlatView.normal` does, and the JAX package's sharded view)
        and the rank keeps its tile, so a value depends on its parameter
        only, never on the layout."""
        gen = torch.Generator(device=device or "cpu")
        parts: Dict[str, list] = {}
        for i, slot in enumerate(self.slots):
            if is_frozen_bucket(slot.buffer):
                continue
            if torch_dtype(self.group_map[slot.buffer].dtype) \
                    .is_floating_point:
                gen.manual_seed(fold_in(key, i))
                draw = torch.randn(slot.shape, generator=gen,
                                   dtype=torch.float32, device=device)
            else:
                draw = torch.zeros(slot.shape, dtype=torch.float32,
                                   device=device)
            parts.setdefault(slot.buffer, []).append(
                self._local_tile(draw, slot, coords).reshape(-1))
        return {name: torch.cat(chunks) for name, chunks in parts.items()}

    def rows_to_whole(self, name: str, rows: torch.Tensor,
                      whole: Dict[str, torch.Tensor]) -> None:
        """Write bucket ``name``'s leaves from its gathered ``(n_shards,
        >= size)`` rows into the :meth:`whole_view` buffers ``whole``,
        in place."""
        for s, w in zip(self.slots, self._whole_view.slots):
            if s.buffer == name:
                whole[w.buffer][w.offset:w.offset + w.size].view(
                    w.shape).copy_(self._shards_to_leaf(
                        rows[:, s.offset:s.offset + s.size], s))

    def whole_to_rows(self, name: str, whole: Dict[str, torch.Tensor],
                      width: Optional[int] = None) -> torch.Tensor:
        """Bucket ``name``'s ``(n_shards, width)`` rows (``width`` ≥ the
        per-shard size, zero past it; default the size) of the leaves
        held in the :meth:`whole_view` buffers ``whole``: the inverse of
        :meth:`rows_to_whole`, for a gradient."""
        g = self.group_map[name]
        parts = [self._leaf_to_shards(
            whole[w.buffer][w.offset:w.offset + w.size].view(w.shape), s)
            for s, w in zip(self.slots, self._whole_view.slots)
            if s.buffer == name]
        width = g.size if width is None else width
        if width > g.size:
            parts.append(parts[0].new_zeros((g.n_shards, width - g.size)))
        return torch.cat(parts, dim=1)

    # -- per-leaf shard transform ------------------------------------------

    def _perm_info(self, slot: ShardedLeafSlot):
        """(expanded shape, factor->front permutation, n_shards) for one
        leaf: every sharded dim splits into its axis factors, and the
        factors move to the front in canonical (mesh) order."""
        order = [a for a, _ in self.axis_sizes]
        expanded, factor_pos = [], {}
        for dim, entry in zip(slot.shape, slot.dim_axes):
            for a in entry:
                factor_pos[a] = len(expanded)
                expanded.append(self._axis_size(a))
                dim //= self._axis_size(a)
            expanded.append(dim)
        block_pos = [i for i in range(len(expanded))
                     if i not in factor_pos.values()]
        perm = [factor_pos[a] for a in order if a in factor_pos] + block_pos
        n_shards = math.prod(self._axis_size(a) for a in factor_pos)
        return expanded, perm, n_shards

    def _leaf_to_shards(self, leaf: torch.Tensor,
                        slot: ShardedLeafSlot) -> torch.Tensor:
        """(global leaf) -> (n_shards, per_shard) rows, shard-major in
        canonical axis order."""
        expanded, perm, n_shards = self._perm_info(slot)
        out = leaf.reshape(expanded).permute(perm)
        return out.reshape(n_shards, slot.size)

    def _shards_to_leaf(self, rows: torch.Tensor,
                        slot: ShardedLeafSlot) -> torch.Tensor:
        expanded, perm, _ = self._perm_info(slot)
        inv = [perm.index(i) for i in range(len(perm))]
        mid = rows.reshape([expanded[i] for i in perm])
        return mid.permute(inv).reshape(slot.shape)

    # -- pack / unpack ------------------------------------------------------

    def _check(self, tree: Pytree) -> list:
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure mismatch with this "
                             "ShardedFlatView")
        return leaves

    def _pack(self, tree: Pytree, frozen: bool) -> Dict[str, torch.Tensor]:
        parts: Dict[str, list] = {}
        for slot, leaf in zip(self.slots, self._check(tree)):
            if is_frozen_bucket(slot.buffer) == frozen:
                parts.setdefault(slot.buffer, []).append(
                    self._leaf_to_shards(leaf, slot))
        return {name: torch.cat(rows, dim=1) for name, rows in parts.items()}

    def flatten(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """Pack ``tree``'s trainable leaves into ``{bucket: (n_shards,
        per_shard)}`` (every leaf without a filter)."""
        return self._pack(tree, frozen=False)

    def flatten_frozen(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """Pack the FROZEN leaves into their ``frozen:`` buckets, with the
        same per-group shard decomposition ({} without a filter)."""
        return self._pack(tree, frozen=True)

    def unflatten(self, bufs: Dict[str, torch.Tensor],
                  frozen: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Pytree:
        """Inverse of :meth:`flatten` (buffers may carry padding past
        each row's logical size); ``frozen`` supplies the ``frozen:``
        buckets (:meth:`flatten_frozen`; zero-filled when absent)."""
        if self.frozen_groups and not frozen:
            frozen = {g.name: torch.zeros((g.n_shards, g.size),
                                          dtype=torch_dtype(g.dtype))
                      for g in self.frozen_groups}
        if self.frozen_groups:
            bufs = dict(bufs, **frozen)
        leaves = [self._shards_to_leaf(
            bufs[s.buffer][:, s.offset:s.offset + s.size], s)
            for s in self.slots]
        return tree_unflatten(self.treedef, leaves)
