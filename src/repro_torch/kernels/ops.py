"""Public entry points of the port's kernels.

The counterpart of ``repro/kernels/ops.py``.  The models call
``flash_attention``, ``ssd`` and ``ssd_with_state`` when a config selects
``attn_impl``/``ssd_impl`` ``"pallas"`` (the wrapper: the CUDA kernel on a
CUDA tensor, the plain version on a CPU tensor) or ``"pallas_interpret"``
(``interpret=True``: the plain version on any device).

The FL layers call the ``fused_*`` half (the update kernels, the
client-upload kernels ``fused_compress_delta``, ``fused_topk_threshold``,
``fused_topk_compress``, ``fused_dp_clip_noise_rows`` and its one-client
form ``fused_dp_clip_noise``, and the pod backend's
``fused_delta_accum``) through
``repro_torch.fl.local.FlatParamOps`` (one call per dtype bucket) with
``interpret=fused_interpret(impl)``:

  ``update_impl="fused"``            the kernel wrapper — the CUDA
                                     kernel on a CUDA tensor, the plain
                                     version on a CPU tensor;
  ``update_impl="fused_interpret"``  the plain version on any device
                                     (the tests' and ``chip_smoke.py``'s
                                     end-to-end reference).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    interpret: bool = False) -> torch.Tensor:
    """Causal GQA attention, q (B, S, H, hd) against k/v (B, T, KH, hd)."""
    if not causal:
        raise NotImplementedError("only causal attention is implemented "
                                  "(decoder-only archs)")
    fn = _fa.flash_attention_plain if interpret else _fa.flash_attention
    return fn(q, k, v, window=window, q_offset=q_offset, kv_len=kv_len)


def ssd_with_state(x, dt, A, B, C, *, chunk: int = 128,
                   interpret: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan; returns ``(y, final_state)``."""
    fn = _ssd.ssd_scan_plain if interpret else _ssd.ssd_scan
    return fn(x, dt, A, B, C, chunk=chunk)


def ssd(x, dt, A, B, C, *, chunk: int = 128,
        interpret: bool = False) -> torch.Tensor:
    """Mamba2 SSD scan; returns ``y``."""
    return ssd_with_state(x, dt, A, B, C, chunk=chunk, interpret=interpret)[0]


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


def fused_server_update(p, delta, moments, scalars, *, avg=None,
                        opt: str = "none", beta: float = 0.9, b1: float = 0.9,
                        b2: float = 0.99, eps: float = 1e-8,
                        interpret: bool = False):
    """Apply an aggregated f32 delta, or (``avg`` given, ``delta`` None)
    the round's aggregate, under a server optimizer (none / FedAvgM
    momentum / FedAdam), in place.  Returns (p, moments)."""
    fn = _fu.server_update_plain if interpret else _fu.server_update
    return fn(p, delta, tuple(moments), scalars, avg=avg, opt=opt,
              beta=beta, b1=b1, b2=b2, eps=eps)


def fused_delta_accum(delta, w_end, p, coeff, *, interpret: bool = False):
    """One client's contribution to the pod backend's running f32
    weighted-delta sum, in place on ``delta``: ``delta + coeff·(w_end₃₂
    − p₃₂)``, or the p-free accum-only form ``delta + coeff·w_end₃₂``
    when ``p=None`` (hierarchical per-lane partials, compressed
    uploads).  Returns ``delta``."""
    fn = _fu.delta_accum_plain if interpret else _fu.delta_accum
    return fn(delta, w_end, p, coeff.reshape(1))


def fused_compress_delta(d, thresh, *, bits: int = 32, topk: bool = False,
                         with_residual: bool = False,
                         interpret: bool = False):
    """Compressed form of one client's f32 flat delta: top-k mask at the
    device threshold, blockwise int8/int16 fake quantization; returns
    ``c`` or ``(c, r)``."""
    fn = _fu.compress_delta_plain if interpret else _fu.compress_delta
    return fn(d, thresh, bits=bits, topk=topk, with_residual=with_residual)


def fused_topk_threshold(d, k: int, *, interpret: bool = False
                         ) -> torch.Tensor:
    """The k-th largest |d| of a flat f32 buffer, a 0-dim device tensor."""
    fn = _fu.topk_threshold_plain if interpret else _fu.topk_threshold
    return fn(d, k)


def fused_topk_compress(d, k: int, *, bits: int = 32,
                        with_residual: bool = False,
                        interpret: bool = False):
    """The top-k compressed upload of one client's f32 flat delta: the
    k-th largest |d| and the compressed form at it; returns ``(c, r,
    τ)``, ``r`` None unless ``with_residual``."""
    fn = _fu.topk_compress_plain if interpret else _fu.topk_compress
    return fn(d, k, bits=bits, with_residual=with_residual)


def fused_dp_clip_noise(d, z, clip_scale, noise_scale, *,
                        interpret: bool = False) -> torch.Tensor:
    """One client's DP upload over one flat buffer:
    ``clip_scale·d₃₂ (+ noise_scale·z)`` in a single pass (K5), as a new
    f32 tensor; ``z=None`` drops the Gaussian term.  The scales are
    floats or f32 device scalars."""
    def scalar(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=d.device).reshape(())
    scalars = torch.stack([scalar(clip_scale), scalar(noise_scale)])
    fn = _fu.dp_clip_noise_plain if interpret else _fu.dp_clip_noise
    return fn(d.float(), z, scalars)


def fused_dp_clip_noise_rows(w, p, z, clip_scales, noise_scale, *,
                             interpret: bool = False) -> torch.Tensor:
    """A round's DP uploads in one pass: row k of the ``(K, N)`` f32
    result is ``clip_scales[k]·(w[k] − p) (+ noise_scale·z[k])``."""
    fn = _fu.dp_clip_noise_rows_plain if interpret else \
        _fu.dp_clip_noise_rows
    return fn(w, p, z, clip_scales, noise_scale)
