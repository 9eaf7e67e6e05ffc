"""Causal GQA flash attention: a CUDA kernel for Hopper + its plain twin.

The counterpart of ``repro/kernels/flash_attention.py``.

  ``flash_attention``        the wrapper.  On a CUDA tensor it launches
                             the kernel of ``csrc/flash_attention.cu`` (or
                             raises); on a CPU tensor it runs the plain
                             version.  It counts its launches in
                             ``flash_attention.launches``.
  ``flash_attention_plain``  the same function in dense torch ops: the CPU
                             tests hold it against the Pallas kernel, and
                             ``chip_smoke.py`` holds the kernel against it.
  ``split_merge_plain``      the decode kernel's arithmetic in dense torch
                             ops: per-chunk partials (m, l, acc) merged as
                             the kernel's last block merges them.  Only the
                             CPU tests call it.

Semantics follow the Pallas kernel: q (B, S, H, hd) and k/v (B, T, KH,
hd), q head h reads kv head ``h // (H // KH)``; key ``t`` is visible to
query ``i`` when ``t <= q_offset + i``, ``t > q_offset + i - window`` and
``t < kv_len``.  q is scaled by ``hd ** -0.5`` in f32 before Q·Kᵀ, the
softmax is taken in f32 with masked scores at -1e30 and their weights
zeroed explicitly, and the output is divided by ``max(l, 1e-30)``, so a
query that sees no key gives 0 (the dense ``attention_ref`` would give
the mean of v there).  ``q_offset``, ``window`` and ``kv_len`` are host
ints: one compiled kernel serves sliding-window, global and decode
layers, and the caller (the port's decode loop) knows them without a
device read.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import library, work

NEG_INF = -1e30
FULL_WINDOW = 2 ** 30
HEAD_DIMS = (16, 32, 64, 128)      # the head sizes the kernel is built for
LOG2E = 1.4426950408889634


def _scalars(T: int, window: Optional[int], q_offset: int,
             kv_len: Optional[int]):
    window = FULL_WINDOW if window is None else int(window)
    kv_len = T if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= T:
        raise ValueError(f"kv_len must lie in [0, {T}], got {kv_len}")
    return int(q_offset), window, kv_len


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: Optional[int] = None, q_offset: int = 0,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """Dense masked attention with the kernel's semantics (module doc)."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    q_offset, window, kv_len = _scalars(T, window, q_offset, kv_len)
    qg = (q.float() * hd ** -0.5).reshape(B, S, KH, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    qpos = q_offset + torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window) & (kpos < kv_len)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    denom = torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2, 4)   # (B, S, KH, G, 1)
    return (out / denom).reshape(B, S, H, hd).to(q.dtype)


def split_merge_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      chunk: int, window: Optional[int] = None,
                      q_offset: int = 0,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """The split decode's arithmetic (``fa_split_kernel``) in dense ops.

    Keys are cut into chunks of ``chunk`` positions.  Each chunk gives every
    row a partial in the log2 domain: m, the max of its visible scores
    ``q·k * hd**-0.5 * log2(e)`` (-1e30 when it sees none), l = Σ 2^(s-m)
    over visible keys and acc = Σ 2^(s-m) v.  The merge takes M, the max of
    m over the chunks with l > 0, weights w = 2^(m-M) (0 where l = 0), and
    returns Σ w acc / max(Σ w l, 1e-30): a row no chunk saw gives 0."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    q_offset, window, kv_len = _scalars(T, window, q_offset, kv_len)
    n = -(-T // chunk)
    pad = n * chunk - T
    qg = (q.float() * (hd ** -0.5 * LOG2E)).reshape(B, S, KH, G, hd)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf)
    qpos = q_offset + torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(n * chunk, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window) & (kpos < kv_len)
    s = torch.where(mask, s, NEG_INF).reshape(B, KH, G, S, n, chunk)
    mask = mask.reshape(S, n, chunk)
    m = s.amax(dim=-1)                                  # (B, KH, G, S, n)
    p = torch.where(mask, torch.exp2(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgsnc,bnckd->bkgsnd", p,
                       vf.reshape(B, n, chunk, KH, hd))
    seen = l > 0
    M = torch.where(seen, m, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.where(seen, torch.exp2(m - M), 0.0)
    L = torch.clamp_min((w * l).sum(dim=-1), 1e-30)     # (B, KH, G, S)
    out = (w[..., None] * acc).sum(dim=-2) / L[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _workspace(q: torch.Tensor, nbytes: int, groups: int):
    """The decode's workspace on q's device and current stream
    (``library.workspace``): ``nbytes`` of split partials and ``groups``
    tickets, two zero-filled buffers.  Ticket g has its own place whatever
    the call's shape, so partials of another batch never land on it; the
    kernel's merging block resets the tickets it used, so they are ready
    for the next call on the stream without a memset.  Decode calls in
    flight on two streams each have their own pair."""
    return library.workspace("flash_attention", q.device, library.stream(q),
                             parts=(nbytes, torch.uint8),
                             tickets=(groups, torch.int32))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, T, KH, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(batch, head_dim, H % KH == 0)")
    if q.dtype not in library.DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype} (float32 or bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


@work.counted("flash_attention", work.flash_attention)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention; returns (B, S, H, hd) in q's dtype.

    A call with S·(H/KH) <= 16 rows per kv head (decode) uses a workspace
    kept per (device, stream) (``_workspace``): calls on several streams
    may be in flight at once."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, window=window,
                                     q_offset=q_offset, kv_len=kv_len)
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    q_offset, window, kv_len = _scalars(T, window, q_offset, kv_len)
    out = torch.empty_like(q)
    if B * S * H == 0 or T == 0:
        return out.zero_()
    lib = library.lib()
    n_ws = lib.fa_workspace_bytes(B, S, T, H, KH, hd)
    if n_ws < 0:
        raise ValueError(f"flash_attention cannot take q {tuple(q.shape)} "
                         f"against k/v {tuple(k.shape)}")
    ws, tickets = _workspace(q, n_ws, B * KH) if n_ws else (None, None)
    err = lib.fa_forward(
        library.ptr(out), library.ptr(q), library.ptr(k), library.ptr(v),
        B, S, T, H, KH, hd, q_offset, window, kv_len,
        library.DTYPE_CODE[q.dtype], library.ptr(ws), library.ptr(tickets),
        library.stream(q))
    library.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
