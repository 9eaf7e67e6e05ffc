"""Mamba2 SSD chunked scan: a CUDA kernel for Hopper + its plain twin.

The counterpart of ``repro/kernels/ssd_scan.py``.

  ``ssd_scan``        the wrapper.  On a CUDA tensor it launches the kernel
                      of ``csrc/ssd_scan.cu`` (or raises); on a CPU tensor
                      it runs the plain version.  It counts its launches in
                      ``ssd_scan.launches``.
  ``ssd_scan_plain``  the Pallas kernel's algorithm in torch ops, chunk by
                      chunk in order with the f32 (p, n) state carried
                      across, batched over (b, h).
  ``ssd_chunk_parallel_plain``  the card kernel's decomposition in dense
                      torch ops: every chunk at once, the recurrence over
                      the chunk states, then the entering states' term,
                      with the bf16 pair rounding of the bf16 path's
                      operands.  Only the CPU tests call it.

x (b, s, h, p), dt (b, s, h) f32 and positive, A (h,) f32 and negative,
B/C (b, s, g, n) in x's dtype with head h reading group ``h // (h // g)``.
Returns ``(y (b, s, h, p) in x's dtype, final state (b, h, p, n) f32)``.
A sequence that is not a multiple of ``chunk`` is padded with dt = 0,
which leaves the state untouched.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import library, work

SMEM_LIMIT = 232_448       # bytes of shared memory a block may use (sm_90)
HEAD_DIMS = (32, 64, 128)  # the head sizes the kernel is built for
MAX_STATE = 128            # the largest d_state and chunk it takes
_WARPS = 4                 # warps of a CTA of the state and scan kernels


def smem_bytes(chunk: int, p: int, n: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """The least shared memory a CTA of the CUDA kernels needs: the larger
    of the state kernel's and the scan kernel's, with one buffer of the
    per-head data and one head per CTA (``csrc/ssd_scan.cu``: state_smem,
    scan_smem).  The launcher takes two buffers and more heads where they
    fit."""
    e = 2 if dtype == torch.bfloat16 else 4
    lp = -(-chunk // 16) * 16                   # rows padded to 16
    np_ = -(-n // 16) * 16                      # d_state padded to 16
    ldx, ldk = p + 16 // e, np_ + 16 // e       # row strides + 16 bytes
    tiles = (lp // 16) * (lp // 16 + 1) // 2    # lower 16 x 16 tiles of C.B^T
    state = lp * ldx * e + 2 * lp * ldk * e + lp * 4 + 16
    slab = _WARPS * 16 * (lp + 4) * 4 if e == 4 else 0   # f32: a warp's M
    scan = (lp * ldx * e + lp * ldk * e + p * ldk * 4 + tiles * 1024 + slab
            + 3 * lp * 4)
    return max(state, scan)


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


def _pair(t: torch.Tensor) -> torch.Tensor:
    """An f32 tensor as the bf16 pair hi + lo the kernel feeds the tensor
    cores (each value to ~16 bits)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssd_chunk_parallel_plain(x: torch.Tensor, dt: torch.Tensor,
                             A: torch.Tensor, B: torch.Tensor,
                             C: torch.Tensor, *, chunk: int = 128
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's decomposition (``csrc/ssd_scan.cu``) in dense
    ops, chunks padded with dt = 0 as the kernel pads them:

      (a) per (batch, chunk, group) C·Bᵀ once; per head M = C·Bᵀ ⊙
          exp(cum_i − cum_j) ⊙ dt_j (j <= i), y_intra = M·x, and the
          chunk's state contribution S = Σ_i x_i (w_i B_i)ᵀ with w_i =
          dt_i exp(tot − cum_i);
      (b) the recurrence state = state · exp(tot_c) + S_c over the chunks
          in f32, keeping the state entering each chunk;
      (c) y = exp(cum_i) · C_i · state_in + y_intra, rounded once.

    With bf16 inputs the f32 operands of the kernel's tensor-core products
    (M, w·B and the entering state) are rounded to bf16 pairs hi + lo
    first, as the kernel rounds them; x, B and C are exact in bf16."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    pair = _pair if x.dtype == torch.bfloat16 else (lambda t: t)

    def chunks(t):
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(b, nc, chunk, *t.shape[2:])
    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(B), chunks(C)
    dth = dtc.permute(0, 1, 3, 2)                          # (b, nc, h, L)
    cum = torch.cumsum(dth * A.float()[:, None], dim=-1)
    tot = cum[..., -1]                                     # (b, nc, h)
    # (a)
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)        # once per group
    CB = CB.repeat_interleave(hpg, dim=2)                  # (b, nc, h, L, L)
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()
    decay = torch.where(lower, torch.exp(cum[..., :, None]
                                         - cum[..., None, :]), 0.0)
    M = CB * decay * dth[..., None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", pair(M), xc)
    w = dth * torch.exp(tot[..., None] - cum)              # (b, nc, h, L)
    wB = w.permute(0, 1, 3, 2)[..., None] * Bc.repeat_interleave(hpg, dim=3)
    S = torch.einsum("bcihp,bcihn->bchpn", xc, pair(wB))
    # (b)
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    enter = []
    for c in range(nc):
        enter.append(state)
        state = state * torch.exp(tot[:, c])[..., None, None] + S[:, c]
    enter = torch.stack(enter, dim=1)                      # (b, nc, h, p, n)
    # (c)
    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           Cc.repeat_interleave(hpg, dim=3), pair(enter))
    y = torch.exp(cum).permute(0, 1, 3, 2)[..., None] * y_inter + y_intra
    return y.reshape(b, nc * chunk, h, p)[:, :s].to(x.dtype), state


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


@work.counted("ssd_scan", work.ssd_scan)
def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over the whole sequence; returns ``(y, final_state)``.

    On the card one call is three kernel launches on the current stream
    (chunk states, their recurrence, the outputs); ``ssd_scan.launches``
    counts calls."""
    _check(x, dt, A, B, C, chunk)
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if p not in HEAD_DIMS or n % 8 or n > MAX_STATE or chunk > MAX_STATE:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"d_state a multiple of 8 and d_state, chunk <= "
                         f"{MAX_STATE}; got {p}, {n}, {chunk}")
    need = smem_bytes(chunk, p, n, x.dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk}, head_dim {p}, d_state {n} in "
                         f"{x.dtype} need {need} bytes of shared memory "
                         f"(limit {SMEM_LIMIT})")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    y = torch.empty_like(x)
    final = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    if s == 0:
        return y, final.zero_()
    lib = library.lib()
    # the chunk states, the entering states, tot and C·Bᵀ: scratch of this
    # call alone, from the caching allocator on the current stream
    ws = torch.empty(lib.ssd_workspace_bytes(b, s, h, p, g, n, chunk),
                     dtype=torch.uint8, device=x.device)
    err = lib.ssd_forward(
        library.ptr(y), library.ptr(final), library.ptr(x), library.ptr(dt),
        library.ptr(A), library.ptr(B), library.ptr(C), b, s, h, p, g, n,
        chunk, library.DTYPE_CODE[x.dtype], library.ptr(ws),
        library.stream(x))
    library.check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
