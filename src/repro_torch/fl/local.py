"""Client local training — the inner loop shared by P1 (cyclic) and P2 (FL).

The counterpart of ``repro/fl/local.py`` for the plain variant (vanilla
local SGD: FedAvg, and CyclicFL's P1).  One function runs ``n_steps`` of
SGD on one client; the caller hands it ``sample(step) -> (bx, by)``, so
the local run is independent of where its batch indices come from (a
``torch.Generator`` on the device, or an injected index source).

The post-gradient step tail — global-norm clip, decoupled weight decay,
heavy-ball momentum, SGD axpy — has two implementations behind
``LocalSpec.update_impl``:

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
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.fl.task import Task
from repro_torch.kernels import ops
from repro_torch.kernels.fused_update import GRID_ALIGN
from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import seeded_generator
from repro_torch.utils.flatten import FlatView, torch_dtype

Pytree = Any
Sample = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]

UPDATE_IMPLS = ("tree", "fused", "fused_interpret")


def validate_update_impl(update_impl: str) -> str:
    if update_impl not in UPDATE_IMPLS:
        raise ValueError(f"unknown update_impl {update_impl!r} "
                         f"(choose from {UPDATE_IMPLS})")
    return update_impl


def not_ported(option: str, item: str):
    """Raise for an option the port does not run yet, naming the
    ROADMAP.md item that will bring it."""
    raise NotImplementedError(
        f"{option} is not ported to repro_torch yet (ROADMAP.md item {item})")


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """Static description of one client's local-training run."""
    n_steps: int
    batch_size: int
    lr: float
    momentum: float = 0.0
    weight_decay: float = 0.0
    variant: str = "plain"          # fedprox | scaffold | moon: M4b
    grad_clip: Optional[float] = None
    update_impl: str = "tree"       # tree | fused | fused_interpret

    def __post_init__(self):
        validate_update_impl(self.update_impl)
        if self.variant != "plain":
            not_ported(f"variant={self.variant!r}", "M4b")


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

    def unflatten(self, bufs: Dict[str, torch.Tensor]) -> Pytree:
        return self.view.unflatten(bufs)

    @staticmethod
    def _pad_len(n: int) -> int:
        return -(-n // GRID_ALIGN) * GRID_ALIGN if n else 0

    @property
    def padded_sizes(self) -> Dict[str, int]:
        return {name: self._pad_len(size)
                for name, size in self.view.buffer_sizes.items()}

    def pad(self, bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Copy each buffer onto ``device``, right-padded with zeros to
        the next GRID_ALIGN multiple.  Always a copy: the engine updates
        its buffers in place, so they must never alias the caller's."""
        out = {}
        for name, b in bufs.items():
            buf = torch.zeros(self._pad_len(b.shape[-1]), dtype=b.dtype,
                              device=self.device)
            buf[:b.shape[-1]].copy_(b)
            out[name] = buf
        return out

    def zeros(self) -> Dict[str, torch.Tensor]:
        """Zero buffers in carry layout (padded, on ``device``)."""
        return {name: torch.zeros(size, dtype=torch_dtype(name),
                                  device=self.device)
                for name, size in self.padded_sizes.items()}

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

    def weighted_delta(self, p_bufs, stacked_bufs, wbar):
        """FedAvg aggregation of the stacked ``(K, N)`` buffers into new
        buffers."""
        return {name: ops.fused_weighted_delta(
                    stacked_bufs[name], p, wbar, interpret=self.interpret)
                for name, p in p_bufs.items()}

    def apply_delta(self, p_bufs, delta_bufs):
        """p ← cast(p₃₂ + delta) per bucket, in place."""
        one = torch.ones(1, dtype=torch.float32, device=self.device)
        new_p, _ = self.server_update(p_bufs, delta_bufs, (), one,
                                      opt="none")
        return new_p

    def server_update(self, p_bufs, delta_bufs, moments, scalars, *,
                      opt: str, beta: float = 0.9, b1: float = 0.9,
                      b2: float = 0.99):
        """Server optimizer over every bucket, in place.  ``moments`` is
        a tuple of buffer dicts mirroring ``p_bufs``; ``scalars`` the f32
        device tensor the kernel expects.  Returns ``(p_bufs,
        moments)``."""
        for name, p in p_bufs.items():
            ops.fused_server_update(
                p, delta_bufs[name], tuple(m[name] for m in moments),
                scalars, opt=opt, beta=beta, b1=b1, b2=b2,
                interpret=self.interpret)
        return p_bufs, tuple(moments)


@functools.lru_cache(maxsize=64)
def param_shapes(task: Task) -> Pytree:
    """A CPU instance of the task's params — its shapes and dtypes."""
    return task.init(seeded_generator(0))


@functools.lru_cache(maxsize=64)
def host_flat_ops(task: Task, interpret: bool,
                  device: torch.device) -> FlatParamOps:
    """The FlatParamOps for one task on one device (cached)."""
    return FlatParamOps(view=FlatView.of(param_shapes(task)),
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
                  flat_ops: Optional[FlatParamOps] = None) -> Callable:
    """Build the per-client local-training function.

    tree impl : ``local(w_start, sample, lr_scale) -> (w_end, loss)``
                over parameter TREES.
    fused impl: ``local(p_bufs, sample, lr_scale) -> (p_bufs, loss)``
                over the buffer dict of ``flat_ops``, updated IN PLACE.

    ``sample(step) -> (bx, by)`` yields the step's batch; ``lr_scale``
    is the round's f32 device scalar; ``loss`` is the mean local loss
    (a device scalar).
    """
    fused = spec.update_impl != "tree"
    if fused and flat_ops is None:
        raise ValueError("the fused local fn runs over a FlatParamOps")

    def local_tree(w_start: Pytree, sample: Sample, lr_scale):
        params = w_start
        mom = tm.zeros_like(params) if spec.momentum else ()
        losses = []
        for s in range(spec.n_steps):
            bx, by = sample(s)
            leaves, treedef = tm.tree_flatten(params)
            pv = [x.detach().requires_grad_(True) for x in leaves]
            loss = task.loss_fn(tm.tree_unflatten(treedef, pv), bx, by, None)
            grads = tm.tree_unflatten(treedef,
                                      torch.autograd.grad(loss, pv))
            with torch.no_grad():
                params, mom = tree_step_tail(spec, params, grads, mom, None,
                                             lr_scale)
            losses.append(loss.detach())
        return params, torch.stack(losses).mean()

    def local_fused(p_bufs: Dict, sample: Sample, lr_scale):
        m_bufs = ({name: torch.zeros_like(b) for name, b in p_bufs.items()}
                  if spec.momentum else {})
        step_size = spec.lr * lr_scale
        fixed = None if spec.grad_clip else step_scalars(
            spec, flat_ops, None, step_size)
        losses = []
        for s in range(spec.n_steps):
            bx, by = sample(s)
            # differentiate w.r.t. the FLAT buffers: the tree is views of
            # them, and autograd packs the gradient per bucket
            pv = {name: b.detach().requires_grad_(True)
                  for name, b in p_bufs.items()}
            loss = task.loss_fn(flat_ops.unflatten(pv), bx, by, None)
            g_bufs = dict(zip(pv, torch.autograd.grad(loss, list(pv.values()))))
            with torch.no_grad():
                scalars = fixed if fixed is not None else step_scalars(
                    spec, flat_ops, g_bufs, step_size)
                flat_ops.local_step(p_bufs, g_bufs, m_bufs, None, scalars,
                                    weight_decay=spec.weight_decay,
                                    momentum=spec.momentum)
            losses.append(loss.detach())
        return p_bufs, torch.stack(losses).mean()

    return local_fused if fused else local_tree
