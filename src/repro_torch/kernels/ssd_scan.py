"""Mamba2 SSD chunked scan: a CUDA kernel for Hopper + its plain twin.

The counterpart of ``repro/kernels/ssd_scan.py``.

  ``ssd_scan``        the wrapper.  On a CUDA tensor it launches the kernel
                      of ``csrc/ssd_scan.cu`` (or raises); on a CPU tensor
                      it runs the plain version.  It counts its launches in
                      ``ssd_scan.launches``.
  ``ssd_scan_plain``  the Pallas kernel's algorithm in torch ops, chunk by
                      chunk in order with the f32 (p, n) state carried
                      across, batched over (b, h).

x (b, s, h, p), dt (b, s, h) f32 and positive, A (h,) f32 and negative,
B/C (b, s, g, n) in x's dtype with head h reading group ``h // (h // g)``.
Returns ``(y (b, s, h, p) in x's dtype, final state (b, h, p, n) f32)``.
A sequence that is not a multiple of ``chunk`` is padded with dt = 0,
which leaves the state untouched.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import library

SMEM_LIMIT = 232_448       # bytes of shared memory a block may use (sm_90)
_MB = 32                   # rows of the L x L matrix the kernel holds at once
HEAD_DIMS = (32, 64, 128)  # the head sizes the kernel is built for
MAX_STATE = 128            # the largest d_state and chunk it takes


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory the CUDA kernel needs (``csrc/ssd_scan.cu``)."""
    ldn = n + 1
    return 4 * (chunk * p + 2 * chunk * ldn + _MB * chunk + p * ldn
                + 4 * chunk)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    pad = (-s) % chunk
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(B.float(), (0, 0, 0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.float(), (0, 0, 0, 0, 0, pad))
    Bh = Bf.repeat_interleave(hpg, dim=2) if hpg > 1 else Bf   # (b, sp, h, n)
    Ch = Cf.repeat_interleave(hpg, dim=2) if hpg > 1 else Cf
    A = A.float()
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()[None, :, :, None]
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    ys = [xf.new_zeros(b, 0, h, p)]
    for c0 in range(0, s + pad, chunk):
        xc, dtc = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        Bc, Cc = Bh[:, c0:c0 + chunk], Ch[:, c0:c0 + chunk]
        cum = torch.cumsum(dtc * A, dim=1)                       # (b, L, h)
        seg = cum[:, :, None, :] - cum[:, None, :, :]            # (b, Li, Lj, h)
        decay = torch.where(lower, torch.exp(seg), 0.0)
        CB = torch.einsum("bihn,bjhn->bijh", Cc, Bc)
        M = CB * decay * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", M, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bihn,bhpn->bihp", Cc, state)
        ys.append(y)
        total = cum[:, -1]                                       # (b, h)
        w = (dtc * torch.exp(total[:, None] - cum))[..., None] * xc
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bihp,bihn->bhpn", w, Bc)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


def _check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError("x must be (b, s, h, p) and B, C (b, s, g, n)")
    b, s, h, p = x.shape
    if dt.shape != (b, s, h) or A.shape != (h,):
        raise ValueError(f"dt must be {(b, s, h)} and A {(h,)}, got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    if B.shape[:2] != (b, s) or B.shape[2] < 1 or h % B.shape[2]:
        raise ValueError(f"B/C {tuple(B.shape)} do not fit x "
                         f"{tuple(x.shape)} (h % g == 0)")
    if x.dtype not in library.DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype} (float32 or bfloat16)")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("B and C must share x's dtype")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over the whole sequence; returns ``(y, final_state)``."""
    _check(x, dt, A, B, C, chunk)
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if p not in HEAD_DIMS or n % 8 or n > MAX_STATE or chunk > MAX_STATE:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"d_state a multiple of 8 and d_state, chunk <= "
                         f"{MAX_STATE}; got {p}, {n}, {chunk}")
    if smem_bytes(chunk, p, n) > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk}, head_dim {p}, d_state {n} need "
                         f"{smem_bytes(chunk, p, n)} bytes of shared memory "
                         f"(limit {SMEM_LIMIT})")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    y = torch.empty_like(x)
    final = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    if s == 0:
        return y, final.zero_()
    err = library.lib().ssd_forward(
        library.ptr(y), library.ptr(final), library.ptr(x), library.ptr(dt),
        library.ptr(A), library.ptr(B), library.ptr(C), b, s, h, p, g, n,
        chunk, library.DTYPE_CODE[x.dtype], library.stream(x))
    library.check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
