"""Public entry points of the fused FL-update kernels.

The counterpart of the ``fused_*`` half of ``repro/kernels/ops.py``.
The FL layers call these through ``repro_torch.fl.local.FlatParamOps``
(one call per dtype bucket) with ``interpret=fused_interpret(impl)``:

  ``update_impl="fused"``            the kernel wrapper — the CUDA
                                     kernel on a CUDA tensor, the plain
                                     version on a CPU tensor;
  ``update_impl="fused_interpret"``  the plain version on any device
                                     (the tests' and ``chip_smoke.py``'s
                                     end-to-end reference).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fused_update as _fu


def fused_interpret(update_impl: str) -> bool:
    """True when ``update_impl`` asks for the plain versions explicitly.
    Unlike the JAX package, the backend does not decide here: each
    wrapper picks the kernel or the plain version from its tensors'
    device."""
    return update_impl == "fused_interpret"


def fused_local_step(p, g, m, c, scalars, *, weight_decay: float = 0.0,
                     momentum: float = 0.0, interpret: bool = False):
    """Fused client step tail over one flat buffer, in place on ``p``
    (and ``m``).  Returns ``(p, m)``."""
    fn = _fu.local_step_plain if interpret else _fu.local_step
    return fn(p, g, m, c, scalars, weight_decay=weight_decay,
              momentum=momentum)


def fused_weighted_delta(stacked, p, weights,
                         extra: Optional[torch.Tensor] = None, *,
                         deltas: bool = False,
                         interpret: bool = False) -> torch.Tensor:
    """FedAvg aggregation over a stacked (K, N) flat buffer:
    ``cast(p32 + sum_k w_k * (stacked[k] - p) (+ extra))``."""
    fn = _fu.weighted_delta_plain if interpret else _fu.weighted_delta
    return fn(stacked, p, weights, extra=extra, deltas=deltas)


def fused_server_update(p, delta, moments, scalars, *, opt: str = "none",
                        beta: float = 0.9, b1: float = 0.9, b2: float = 0.99,
                        eps: float = 1e-8, interpret: bool = False):
    """Apply an aggregated f32 delta under a server optimizer (none /
    FedAvgM momentum / FedAdam), in place.  Returns (p, moments)."""
    fn = _fu.server_update_plain if interpret else _fu.server_update
    return fn(p, delta, tuple(moments), scalars, opt=opt, beta=beta, b1=b1,
              b2=b2, eps=eps)
