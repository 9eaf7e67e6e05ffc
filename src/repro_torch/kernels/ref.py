"""Naive torch oracles for the kernels (the counterpart of
``repro/kernels/ref.py``).

Deliberately plain and exact: dense masked softmax attention, and the SSD
recurrence one step at a time.  The tests hold the kernels' plain
versions against these; the model never calls them.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Dense attention oracle.  q: (B, S, H, hd); k/v: (B, T, KH, hd) with
    H % KH == 0 (GQA); window w keeps keys with qpos - w < kpos <= qpos.
    A fully masked row gets the uniform average of v (plain softmax)."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, S, KH, G, hd).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * hd ** -0.5
    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor,
            initial_state: Optional[torch.Tensor] = None):
    """Sequential SSD recurrence.  x: (b, s, h, p); dt: (b, s, h);
    A: (h,); B/C: (b, s, g, n).  Returns (y (b, s, h, p), final (b, h, p,
    n) f32).

    state_t = state_{t-1} * exp(dt_t A_h) + dt_t * x_t B_t^T
    y_t     = C_t · state_t
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    Bh = B.repeat_interleave(hpg, dim=2).float()
    Ch = C.repeat_interleave(hpg, dim=2).float()
    xf, dtf, A = x.float(), dt.float(), A.float()
    state = (torch.zeros(b, h, p, n, device=x.device) if initial_state is None
             else initial_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * A[None, :])
        state = state * decay[:, :, None, None] + \
            dtf[:, t, :, None, None] * xf[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(b, 0, h, p)
    return y.to(x.dtype), state
