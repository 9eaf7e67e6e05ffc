"""Roofline terms of a captured step (the counterpart of
``repro/launch/hlo_analysis.py``).

The JAX package reads a compiled XLA artifact: ``cost_analysis()`` for
FLOPs and bytes, the post-SPMD HLO text for collectives.  The port has
no HLO: it counts the PyTorch program a rank runs, captured by running
it once (on fake tensors, so nothing is allocated, or for real) under a
:class:`StepCounter`, which reads three counts:

  * FLOPs, from ``torch.utils.flop_counter.FlopCounterMode`` (the
    matmul-class operations: mm, bmm, addmm, convolution, attention);
  * bytes accessed: for every aten operation that moves data, the bytes
    of its tensor inputs and outputs (logical sizes, a broadcast input at
    its broadcast size).  Views, allocations (``empty*``) and
    collectives count nothing.  This is an upper bound of what a fusing
    compiler moves: XLA counts "bytes accessed" per fusion, so an
    elementwise chain XLA fuses into one pass is one read and one write
    there and every link's read and write here;
  * collectives, by kind, from the pod's own counters
    (``repro_torch.fl.pod.COLLECTIVES`` and ``COLLECTIVE_BYTES``, the
    bytes each received on this rank), not re-derived.

Each hand-written kernel counts as the work it does
(``repro_torch.kernels.work``: the operations and bytes its bound
counts), added to FLOPs and bytes, and what ran inside its wrapper (the
plain version on CPU or fake tensors) is taken back out — in a capture
and on the card alike, where the kernels, bound through ctypes, are
invisible to a dispatch mode.

``_shape_bytes``, ``collective_bytes_by_op`` and
``total_collective_bytes`` of the JAX module parse HLO text, which the
port never has; ``POD_KIND_OPS`` maps ``COLLECTIVE_OPS`` onto the pod's
kinds instead.  The terms divide by the H100's rates
(``repro_torch.launch.mesh``): one rank's counts over one card's peak.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.fl import pod
from repro_torch.kernels import work
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# the pod's collective kinds (repro_torch.fl.pod) and the XLA collective
# each issues: "grad" reduce-scatters a bucket sharded over its batch
# axes and all-reduces over the rest; "tp" all-reduces over model (a
# tensor-parallel step; a serve step also all-gathers its logits); "moe"
# all-gathers an MoE layer's counts and expert outputs, all-reduces its
# aux sums and reduce-scatters its dispatch buffer over the batch group
# (XLA's partitioned dispatch); the port issues no all-to-all and no
# collective-permute
POD_KIND_OPS = {
    "grad": ("reduce-scatter", "all-reduce"),
    "gather": ("all-gather",),
    "clip": ("all-reduce",),
    "batch": ("all-reduce",),
    "lane_combine": ("all-reduce",),
    "store_gather": ("all-reduce",),
    "store_spill": ("all-reduce",),
    "tp": ("all-reduce", "all-gather"),
    "moe": ("all-gather", "all-reduce", "reduce-scatter"),
}

_FREE_OPS = ("_unsafe_view", "empty", "empty_like", "empty_strided",
             "new_empty", "new_empty_strided", "lift_fresh", "alias")


def _moves_data(func) -> bool:
    if getattr(func, "namespace", None) != "aten" or func.is_view:
        return False
    return func._schema.name.split("::")[-1] not in _FREE_OPS


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    """Sums each data-moving aten op's input and output bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _moves_data(func):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


class StepCounter:
    """Counts what runs inside it: ``flops``, ``bytes``, the pod's
    collectives (``collectives``, ``collective_bytes``, by kind) and the
    hand-written kernels (``kernels``: name → calls, ops, bytes; a call
    on fake, meta or CPU tensors launches nothing, so these are wrapper
    calls, never launches).
    Enter it after a ``FakeTensorMode``, so it sees each op first."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flop = FlopCounterMode(display=False)
        self._bytes = _BytesMode()
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.collectives: Dict[str, int] = {}
        self.collective_bytes: Dict[str, int] = {}
        self._kernel_work = [0, 0]

    @property
    def flops(self) -> int:
        return int(self._flop.get_total_flops()) + self._kernel_work[0]

    @property
    def bytes(self) -> int:
        return int(self._bytes.bytes) + self._kernel_work[1]

    def snapshot(self):
        return ({k: dict(v) for k, v in self._flop.flop_counts.items()},
                self._bytes.bytes)

    def restore(self, snap) -> None:
        flops, nbytes = snap
        self._flop.flop_counts.clear()
        for k, v in flops.items():
            self._flop.flop_counts[k].update(v)
        self._bytes.bytes = nbytes

    def add_kernel(self, name: str, ops: int, nbytes: int) -> None:
        row = self.kernels.setdefault(name, dict(calls=0, ops=0, bytes=0))
        row["calls"] += 1
        row["ops"] += ops
        row["bytes"] += nbytes
        self._kernel_work[0] += ops
        self._kernel_work[1] += nbytes

    def __enter__(self):
        self._coll0 = dict(pod.COLLECTIVES), dict(pod.COLLECTIVE_BYTES)
        self._flop.__enter__()
        self._bytes.__enter__()
        self._work = work.counting(self)
        self._work.__enter__()
        return self

    def __exit__(self, *exc):
        self._work.__exit__(*exc)
        self._bytes.__exit__(*exc)
        self._flop.__exit__(*exc)
        n0, b0 = self._coll0
        self.collectives = {k: pod.COLLECTIVES[k] - n0[k] for k in n0}
        self.collective_bytes = {k: pod.COLLECTIVE_BYTES[k] - b0[k]
                                 for k in b0}
        return False

    def detail(self) -> Dict[str, object]:
        """The collective bytes by kind and their counts (``_counts``),
        as the JAX module's ``collective_bytes_by_op`` gives them."""
        return dict(self.collective_bytes, _counts=dict(self.collectives))


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float            # PER RANK (the rank's captured program)
    hlo_bytes: float            # PER RANK bytes accessed
    collective_bytes: int       # PER RANK bytes received by collectives
    collective_detail: Dict[str, int]
    model_flops: float = 0.0    # 6·N(_active)·D — GLOBAL
    bytes_per_device: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops * self.n_chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "collective_detail": {k: v for k, v in
                                  self.collective_detail.items()
                                  if not k.startswith("_")},
            "collective_counts": self.collective_detail.get("_counts", {}),
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "bytes_per_device": self.bytes_per_device,
        }


def analyze_captured(counter: StepCounter, *, arch: str, shape: str,
                     mesh_name: str, n_chips: int,
                     model_flops: float = 0.0) -> RooflineTerms:
    """The roofline terms of one rank's captured program (the
    counterpart of ``analyze_compiled``)."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=float(counter.flops), hlo_bytes=float(counter.bytes),
        collective_bytes=sum(counter.collective_bytes.values()),
        collective_detail=counter.detail(), model_flops=model_flops)
