"""Client local training — the inner loop shared by P1 (cyclic) and P2 (FL).

The counterpart of ``repro/fl/local.py``.  One function runs ``n_steps``
of SGD on one client, with the algorithm's loss and gradient shaping
chosen by ``LocalSpec.variant``:

  plain    : vanilla local SGD (FedAvg, and CyclicFL's P1)
  fedprox  : + (mu/2)·‖w − w_global‖²          [Li et al., MLSys'20]
  scaffold : g ← g + (c − c_i) in the step tail [Karimireddy, ICML'20]
  moon     : + mu·contrastive(z, z_glob, z_prev) [Li et al., CVPR'21]

The caller hands the local fn ``sample(step) -> (bx, by, rng)``, so the
local run is independent of where its batch indices and its dropout
come from (a ``torch.Generator`` on the device, or an injected index
source and keep-mask).  ``rng`` reaches the task's loss as its step
draw (None: no draw); a model without dropout ignores it.

The post-gradient step tail — global-norm clip, scaffold correction,
decoupled weight decay, heavy-ball momentum, SGD axpy — has two
implementations behind ``LocalSpec.update_impl``:

  tree             : per-leaf ``tree_math`` algebra; the local fn takes
                     and returns parameter TREES.
  fused[_interpret]: FLAT-FIRST — the local fn takes the flat buffer
                     dict of a :class:`FlatParamOps` and updates it IN
                     PLACE.  Each step differentiates with respect to
                     the buffers (the tree exists only as views inside
                     the loss), so autograd hands back ONE packed
                     gradient per bucket, and the whole tail is one
                     ``local_step`` kernel per bucket.  "fused" launches
                     the CUDA kernel on a CUDA buffer (plain version on a
                     CPU buffer); "fused_interpret" runs the plain
                     version on any device.

The clip scale and the step size stay f32 device tensors: nothing in a
local run waits on the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.fl.compression import (CompressionSpec, topk_k,
                                        validate_compression)
from repro_torch.fl.privacy import DPSpec, flat_delta_sqnorm
from repro_torch.fl.task import Task
from repro_torch.kernels import ops
from repro_torch.kernels.fused_update import GRID_ALIGN
from repro_torch.sharding import tensor_parallel as tpl
from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import seeded_generator
from repro_torch.utils.flatten import FlatView, torch_dtype

Pytree = Any
# a step's dropout source: a torch.Generator, a keep-mask, or None
StepRng = Optional[Union[torch.Generator, torch.Tensor]]
# sample(step) -> (bx, by, rng)
Sample = Callable[[int], Tuple[torch.Tensor, torch.Tensor, StepRng]]

UPDATE_IMPLS = ("tree", "fused", "fused_interpret")
VARIANTS = ("plain", "fedprox", "scaffold", "moon")


def validate_update_impl(update_impl: str) -> str:
    if update_impl not in UPDATE_IMPLS:
        raise ValueError(f"unknown update_impl {update_impl!r} "
                         f"(choose from {UPDATE_IMPLS})")
    return update_impl


def parse_peft(peft: str) -> Tuple[str, int]:
    """``"lora:<r>"`` → ``("lora", r)``; anything else raises."""
    kind, sep, rank_s = peft.partition(":")
    if not sep or kind != "lora":
        raise ValueError(f"unknown peft spec {peft!r} "
                         f"(expected 'lora:<rank>')")
    try:
        rank = int(rank_s)
    except ValueError:
        raise ValueError(f"lora rank must be a positive integer, "
                         f"got {rank_s!r}") from None
    if rank <= 0:
        raise ValueError(f"lora rank must be a positive integer, got {rank}")
    return kind, rank


def validate_peft(peft: Optional[str], *,
                  trainable_filter: Optional[str] = None,
                  update_impl: str = "tree") -> Optional[str]:
    """Construction-time checks for the trainable-slice knobs: the peft
    spec must parse, and either knob needs the fused flat path — the
    tree path has no trainable/frozen partition."""
    if peft is not None:
        parse_peft(peft)
    if (peft is not None or trainable_filter is not None) \
            and update_impl == "tree":
        raise ValueError(
            "peft/trainable_filter needs the fused flat path "
            "(update_impl='fused'|'fused_interpret') — the tree backend "
            "has no trainable-slice partition")
    return peft


def effective_trainable_filter(spec: "LocalSpec") -> Optional[str]:
    """The filter a round runs under: an explicit ``trainable_filter``
    wins; otherwise ``peft`` implies the named ``"lora"`` filter; None
    means every leaf trains."""
    if spec.trainable_filter is not None:
        return spec.trainable_filter
    if spec.peft is not None:
        return "lora"
    return None


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """Static description of one client's local-training run."""
    n_steps: int
    batch_size: int
    lr: float
    momentum: float = 0.0
    weight_decay: float = 0.0
    variant: str = "plain"          # plain | fedprox | scaffold | moon
    mu: float = 0.0                 # prox / moon coefficient
    temperature: float = 0.5        # moon
    grad_clip: Optional[float] = None
    update_impl: str = "tree"       # tree | fused | fused_interpret
    # round-aggregate privacy (repro_torch.fl.privacy) and compressed
    # uploads (repro_torch.fl.compression): both apply at AGGREGATION,
    # the local run itself is unchanged
    dp: Optional[DPSpec] = None
    secure_agg: bool = False
    compression: Optional[CompressionSpec] = None
    # the trainable slice (PEFT): peft="lora:<r>" declares the model's
    # LoRA adapters of rank r and implies the "lora" filter;
    # trainable_filter names a filter of
    # repro_torch.sharding.rules.TRAINABLE_FILTERS (or is a path regex).
    # Either makes the fused path — gradients, step tail, aggregation,
    # server moments, uploads — run over the trainable buckets only; the
    # frozen leaves ride outside as a read-only constant
    peft: Optional[str] = None
    trainable_filter: Optional[str] = None

    def __post_init__(self):
        validate_update_impl(self.update_impl)
        validate_compression(self.compression, dp=self.dp,
                             secure_agg=self.secure_agg)
        validate_peft(self.peft, trainable_filter=self.trainable_filter,
                      update_impl=self.update_impl)
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r} "
                             f"(choose from {VARIANTS})")


def _moon_contrastive(z: torch.Tensor, z_glob: torch.Tensor,
                      z_prev: torch.Tensor, temperature: float
                      ) -> torch.Tensor:
    """Model-contrastive loss: pull the local representation toward the
    global model's, push it away from the previous local model's."""

    def cos(a, b):
        a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
        b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-12)
        return torch.sum(a * b, dim=-1)

    sim_g = cos(z, z_glob) / temperature
    sim_p = cos(z, z_prev) / temperature
    return torch.mean(-sim_g + torch.logsumexp(torch.stack([sim_g, sim_p]),
                                               dim=0))


# ---------------------------------------------------------------------------
# FlatParamOps — the flat-buffer representation of one task
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatParamOps:
    """A packing plan plus how to run the fused kernels on its buffers.

    The engine carries params and server moments as the buffer dicts
    this produces — padded to ``GRID_ALIGN`` and resident on ``device``
    — and every update stage goes through the dict-level methods below
    (one kernel per bucket)."""
    view: FlatView
    interpret: bool
    device: torch.device

    def flatten(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        return self.view.flatten(tree)

    def unflatten(self, bufs: Dict[str, torch.Tensor],
                  frozen: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Pytree:
        """The tree from the trainable buffers, merging ``frozen`` (the
        frozen buckets zero-fill when absent: right for moments)."""
        return self.view.unflatten(bufs, frozen)

    def prox_anchor(self, bufs: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """FedProx's anchor: each trainable leaf's value at the round's
        start, by path, in the layout of the step's tree (views of
        ``bufs`` here).  A frozen leaf is left out: it never moves in a
        round, so its distance is exactly 0."""
        return self.view.trainable_by_path(bufs)

    # -- the frozen bucket (filtered views; empty without a filter) --------

    def flatten_frozen(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """Pack the FROZEN leaves: once per phase."""
        return self.view.flatten_frozen(tree)

    def place_frozen(self, bufs: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Commit the frozen constant on ``device``, not padded — no
        kernel reads it — and read only for the rest of the phase.
        ``bufs`` come from :meth:`flatten_frozen`, which packs into fresh
        storage (never the caller's tensors), so buffers already on the
        device are kept as they are: a second copy of a full-width base
        model does not fit beside the first."""
        return {name: b.detach().to(self.device)
                for name, b in bufs.items()}

    @staticmethod
    def _pad_len(n: int) -> int:
        return -(-n // GRID_ALIGN) * GRID_ALIGN if n else 0

    @property
    def padded_sizes(self) -> Dict[str, int]:
        return {name: self._pad_len(size)
                for name, size in self.view.buffer_sizes.items()}

    def pad(self, bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Copy each buffer onto ``device``, its last axis right-padded
        with zeros to the next GRID_ALIGN multiple.  Always a copy: the
        engine updates its buffers in place, so they must never alias
        the caller's."""
        out = {}
        for name, b in bufs.items():
            buf = torch.zeros(tuple(b.shape[:-1]) +
                              (self._pad_len(b.shape[-1]),), dtype=b.dtype,
                              device=self.device)
            buf[..., :b.shape[-1]].copy_(b)
            out[name] = buf
        return out

    def zeros(self, dtype: Optional[torch.dtype] = None
              ) -> Dict[str, torch.Tensor]:
        """Zero buffers in carry layout (padded, on ``device``);
        ``dtype`` overrides the bucket dtype (an f32 accumulator)."""
        return {name: torch.zeros(size, dtype=dtype or torch_dtype(name),
                                  device=self.device)
                for name, size in self.padded_sizes.items()}

    def normal(self, key: int) -> Dict[str, torch.Tensor]:
        """Per-leaf standard-normal f32 buffers in carry layout (pad
        lanes zero), drawn on ``device`` (``FlatView.normal``)."""
        return self.pad(self.view.normal(key, self.device))

    def place(self, bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Commit freshly packed buffers as the engine's working copy:
        padded, on ``device``, never aliasing the caller's tensors."""
        return self.pad(bufs)

    def stacked_empty(self, K: int) -> Dict[str, torch.Tensor]:
        """Uninitialized ``(K, padded)`` buffers: P2 writes client k's
        end state into row k and aggregates the stack with no re-pack."""
        return {name: torch.empty((K, size), dtype=torch_dtype(name),
                                  device=self.device)
                for name, size in self.padded_sizes.items()}

    # -- kernel execution ---------------------------------------------------

    def grad_sqsum(self, g_bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Σ‖g‖² over every bucket — one reduction per bucket."""
        return sum(torch.dot(g, g) for g in g_bufs.values())

    def delta_sqnorm(self, w_bufs: Dict[str, torch.Tensor],
                     p_bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """‖w − p‖² over every bucket for one client (DP's clip norm)."""
        return flat_delta_sqnorm(w_bufs, p_bufs)

    def local_step(self, p_bufs, g_bufs, m_bufs, c_bufs, scalars, *,
                   weight_decay: float, momentum: float):
        """The fused client step tail over every bucket, in place.
        Returns ``(p_bufs, m_bufs)`` (``m_bufs`` empty when momentum is
        off)."""
        for name, p in p_bufs.items():
            ops.fused_local_step(
                p, g_bufs[name], m_bufs[name] if momentum else None,
                None if c_bufs is None else c_bufs[name], scalars,
                weight_decay=weight_decay, momentum=momentum,
                interpret=self.interpret)
        return p_bufs, m_bufs

    def _logical_size(self, name: str) -> int:
        """Logical element count of bucket ``name`` — the top-k
        population (the zero pad lanes never change the k-th largest
        |d|, so a logical k over a padded buffer is exact)."""
        return self.view.buffer_sizes[name]

    def weighted_delta(self, p_bufs, stacked_bufs, wbar, extra=None, *,
                       deltas: bool = False):
        """FedAvg aggregation of the stacked ``(K, N)`` buffers into new
        buffers.  ``extra`` (an f32 buffer dict: the round's DP noise and
        secure-agg mask total) is added in the same pass; ``deltas``
        reads the stack as client deltas (the compressed aggregate)."""
        return {name: ops.fused_weighted_delta(
                    stacked_bufs[name], p, wbar,
                    None if extra is None else extra[name], deltas=deltas,
                    interpret=self.interpret)
                for name, p in p_bufs.items()}

    def compress_delta(self, d_bufs, spec: CompressionSpec):
        """Compressed form of one client's f32 delta dict, per bucket: when
        sparsifying, one top-k compressed upload over the bucket's
        logical k (one launch up to ``topk_cut()``); otherwise one
        compress pass.  Returns ``(c_bufs, r_bufs)``; ``r_bufs`` is None
        unless error feedback."""
        with_r = spec.error_feedback
        c_out, r_out = {}, {}
        for name, d in d_bufs.items():
            if spec.sparsifies:
                c, r, _ = ops.fused_topk_compress(
                    d, topk_k(spec, self._logical_size(name)),
                    bits=spec.bits, with_residual=with_r,
                    interpret=self.interpret)
            else:
                out = ops.fused_compress_delta(
                    d, None, bits=spec.bits, with_residual=with_r,
                    interpret=self.interpret)
                c, r = out if with_r else (out, None)
            c_out[name] = c
            if with_r:
                r_out[name] = r
        return c_out, (r_out if with_r else None)

    def dp_clip_noise_rows(self, p_bufs, w_bufs, z_bufs, clip_scales,
                           noise_scale):
        """The DP uploads of all K clients of a round, one pass per
        bucket: row k of the ``(K, N)`` f32 result is
        ``clip_scales[k]·(w[k] − p) (+ noise_scale·z[k])`` from the
        stacked end states ``w_bufs`` and the stacked draws ``z_bufs``
        (None drops the noise term); the scales are f32 device tensors."""
        return {name: ops.fused_dp_clip_noise_rows(
                    w_bufs[name], p, None if z_bufs is None else z_bufs[name],
                    clip_scales, noise_scale, interpret=self.interpret)
                for name, p in p_bufs.items()}

    def delta_accum(self, delta_bufs, w_bufs, p_bufs, coeff):
        """One client's term of the pod's running f32 delta, in place on
        ``delta_bufs``: ``delta += coeff·(w − p)`` per bucket, or the
        accum-only ``delta += coeff·w`` when ``p_bufs`` is None (the
        hierarchical lanes' p-free partials, and compressed uploads,
        which are deltas already); ``coeff`` is an f32 device scalar.
        ``w_bufs`` and ``p_bufs`` are never written."""
        for name, d in delta_bufs.items():
            ops.fused_delta_accum(d, w_bufs[name],
                                  None if p_bufs is None else p_bufs[name],
                                  coeff, interpret=self.interpret)
        return delta_bufs

    def apply_delta(self, p_bufs, delta_bufs):
        """p ← cast(p₃₂ + delta) per bucket, in place."""
        one = torch.ones(1, dtype=torch.float32, device=self.device)
        new_p, _ = self.server_update(p_bufs, delta_bufs, (), one,
                                      opt="none")
        return new_p

    def server_update(self, p_bufs, delta_bufs, moments, scalars, *,
                      avg_bufs=None, opt: str, beta: float = 0.9,
                      b1: float = 0.9, b2: float = 0.99):
        """Server optimizer over every bucket, in place.  ``moments`` is
        a tuple of buffer dicts mirroring ``p_bufs``; ``scalars`` the f32
        device tensor the kernel expects.  With ``avg_bufs`` (the
        round's aggregate) and ``delta_bufs`` None, each kernel forms
        ``avg − p`` itself.  Returns ``(p_bufs, moments)``."""
        for name, p in p_bufs.items():
            ops.fused_server_update(
                p, None if delta_bufs is None else delta_bufs[name],
                tuple(m[name] for m in moments), scalars,
                avg=None if avg_bufs is None else avg_bufs[name], opt=opt,
                beta=beta, b1=b1, b2=b2, interpret=self.interpret)
        return p_bufs, tuple(moments)


@functools.lru_cache(maxsize=64)
def param_shapes(task: Task) -> Pytree:
    """The task's params as shapes and dtypes: ``task.shapes()`` on the
    ``meta`` device where the task has it, else a CPU instance."""
    if task.shapes is not None:
        return task.shapes()
    return task.init(seeded_generator(0))


@functools.lru_cache(maxsize=64)
def host_flat_ops(task: Task, interpret: bool, device: torch.device,
                  filter_spec: Optional[str] = None) -> FlatParamOps:
    """The FlatParamOps for one task on one device (cached).
    ``filter_spec`` (a TRAINABLE_FILTERS name or a path regex) splits the
    view into trainable and frozen buckets."""
    from repro_torch.sharding import rules
    shapes = param_shapes(task)
    return FlatParamOps(
        view=FlatView.of(shapes,
                         filter=rules.trainable_mask(shapes, filter_spec)),
        interpret=interpret, device=torch.device(device))


# ---------------------------------------------------------------------------
# the step tail — tree version and fused flat-buffer twin
# ---------------------------------------------------------------------------

def tree_step_tail(spec: LocalSpec, params: Pytree, grads: Pytree,
                   mom: Pytree, c_diff: Optional[Pytree], lr_scale):
    """The per-leaf update (clip → correction → decay → momentum →
    axpy).  Returns new ``(params, mom)``."""
    if spec.grad_clip:
        grads = tm.global_clip(grads, spec.grad_clip)
    if c_diff is not None:
        grads = tm.add(grads, c_diff)
    if spec.weight_decay:
        grads = tm.add_scaled(grads, params, spec.weight_decay)
    if spec.momentum:
        mom = tm.add_scaled(grads, mom, spec.momentum)
        eff = mom
    else:
        eff = grads
    params = tm.tree_map(
        lambda p, g: (p - spec.lr * lr_scale * g).to(p.dtype), params, eff)
    return params, mom


def step_scalars(spec: LocalSpec, fops: FlatParamOps,
                 g_bufs: Optional[Dict], step_size: torch.Tensor
                 ) -> torch.Tensor:
    """The ``(clip_scale, step_size)`` f32 device tensor of one step:
    the global clip norm is one reduction per bucket."""
    if spec.grad_clip:
        sq = fops.grad_sqsum(g_bufs)
        clip_scale = torch.clamp(spec.grad_clip / (torch.sqrt(sq) + 1e-12),
                                 max=1.0).to(torch.float32)
    else:
        clip_scale = torch.ones_like(step_size)
    return torch.stack([clip_scale, step_size])


def fused_step_tail(spec: LocalSpec, fops: FlatParamOps, p_bufs: Dict,
                    g_bufs: Dict, m_bufs: Dict, c_bufs: Optional[Dict],
                    lr_scale):
    """The same tail over flat buffers, in place: one kernel per bucket."""
    scalars = step_scalars(spec, fops, g_bufs, spec.lr * lr_scale)
    return fops.local_step(p_bufs, g_bufs, m_bufs, c_bufs, scalars,
                           weight_decay=spec.weight_decay,
                           momentum=spec.momentum)


def make_local_fn(task: Task, spec: LocalSpec,
                  flat_ops: Optional[FlatParamOps] = None,
                  reduce_grads: Optional[Callable[[Pytree], Pytree]] = None
                  ) -> Callable:
    """Build the per-client local-training function.

    tree impl : ``local(w_start, sample, lr_scale, extras=None,
                frozen=None) -> (w_end, loss)`` over parameter TREES
                (``frozen`` is unused: the tree path has no partition).
    fused impl: ``local(p_bufs, sample, lr_scale, extras=None,
                frozen=None) -> (p_bufs, loss)`` over the trainable
                buffer dict of ``flat_ops``, updated IN PLACE; ``frozen``
                is the read-only frozen bucket dict, merged at the loss
                (no gradient is taken with respect to it).

    ``sample(step) -> (bx, by, rng)`` yields the step's batch and
    dropout source (the loss's ``rng``); ``lr_scale``
    is the round's f32 device scalar; ``loss`` is the mean local loss
    (a device scalar).  Each step's gradient passes through
    ``reduce_grads`` (a tree → tree function, given the gradient tree
    or the dict of gradient buckets; None is the identity) before the
    step tail: the pod backend averages it over the batch's data group
    there.

    ``extras`` is the algorithm's context (None or {} when unused):
      w_global    : the anchor (never written): fedprox's trainable
                    leaves by path (``FlatParamOps.prox_anchor``), moon's
                    tree
      c_diff      : the (c − c_i) correction tree for scaffold (tree)
      c_diff_flat : the same as a buffer dict in ``flat_ops``' carry
                    layout (fused; a row of the round's (K, N) stack is
                    taken as it is)
      w_prev      : the previous local model's tree for moon
    """
    fused = spec.update_impl != "tree"
    if fused and flat_ops is None:
        raise ValueError("the fused local fn runs over a FlatParamOps")

    def loss_for_variant(params, extras, bx, by, rng):
        base = task.loss_fn(params, bx, by, rng)
        if spec.variant == "fedprox":
            # over a model-local tree, the distance sums over ``model``
            prox = 0.5 * spec.mu * tpl.squared_distance(
                params, extras["w_global"], tpl.context_of(params))
            return base + prox
        if spec.variant == "moon":
            z = task.repr_fn(params, bx)
            with torch.no_grad():       # the reference's stop_gradient
                z_glob = task.repr_fn(extras["w_global"], bx)
                z_prev = task.repr_fn(extras["w_prev"], bx)
            return base + spec.mu * _moon_contrastive(z, z_glob, z_prev,
                                                      spec.temperature)
        return base

    def local_tree(w_start: Pytree, sample: Sample, lr_scale,
                   extras: Optional[Dict] = None, frozen=None):
        extras = extras or {}
        c_diff = extras["c_diff"] if spec.variant == "scaffold" else None
        params = w_start
        mom = tm.zeros_like(params) if spec.momentum else ()
        losses = []
        for s in range(spec.n_steps):
            bx, by, rng = sample(s)
            leaves, treedef = tm.tree_flatten(params)
            pv = [x.detach().requires_grad_(True) for x in leaves]
            loss = loss_for_variant(tm.tree_unflatten(treedef, pv), extras,
                                    bx, by, rng)
            grads = tm.tree_unflatten(treedef,
                                      torch.autograd.grad(loss, pv))
            if reduce_grads is not None:
                grads = reduce_grads(grads)
            with torch.no_grad():
                params, mom = tree_step_tail(spec, params, grads, mom,
                                             c_diff, lr_scale)
            losses.append(loss.detach())
        return params, torch.stack(losses).mean()

    def local_fused(p_bufs: Dict, sample: Sample, lr_scale,
                    extras: Optional[Dict] = None,
                    frozen: Optional[Dict] = None):
        extras = extras or {}
        c_bufs = extras["c_diff_flat"] if spec.variant == "scaffold" else None
        m_bufs = ({name: torch.zeros_like(b) for name, b in p_bufs.items()}
                  if spec.momentum else {})
        step_size = spec.lr * lr_scale
        fixed = None if spec.grad_clip else step_scalars(
            spec, flat_ops, None, step_size)
        losses = []
        for s in range(spec.n_steps):
            bx, by, rng = sample(s)
            # differentiate w.r.t. the FLAT buffers: the tree is views of
            # them, and autograd packs the gradient per bucket
            pv = {name: b.detach().requires_grad_(True)
                  for name, b in p_bufs.items()}
            loss = loss_for_variant(flat_ops.unflatten(pv, frozen), extras,
                                    bx, by, rng)
            g_bufs = dict(zip(pv, torch.autograd.grad(loss,
                                                      list(pv.values()))))
            if reduce_grads is not None:
                g_bufs = reduce_grads(g_bufs)
            with torch.no_grad():
                scalars = fixed if fixed is not None else step_scalars(
                    spec, flat_ops, g_bufs, step_size)
                flat_ops.local_step(p_bufs, g_bufs, m_bufs, c_bufs, scalars,
                                    weight_decay=spec.weight_decay,
                                    momentum=spec.momentum)
            losses.append(loss.detach())
        return p_bufs, torch.stack(losses).mean()

    return local_fused if fused else local_tree
