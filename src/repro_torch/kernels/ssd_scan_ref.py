"""Plain PyTorch version of the Mamba-2 SSD chunked scan (arXiv:2405.21060).

A port of `repro/kernels/ssd_scan_ref.py`.  Per batch b and head h:

    state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * B_t x_t^T
    y_t     = C_t . state_t

evaluated chunk by chunk in the "state-space duality" form: inside a
chunk a masked (Q, Q) product, ``(C B^T * exp(segsum(dt A)) * dt) x``;
across chunks a scan over the chunk states, here a Python loop.

Shapes:
  x:  (B, S, H, P)   dt: (B, S, H) float32   A: (H,) float32  (A < 0)
  Bm: (B, S, G, N)   Cm: (B, S, G, N)        (H % G == 0)
Returns (y (B, S, H, P) in x's dtype, final_state (B, H, N, P) float32).
"""

from __future__ import annotations

import torch

__all__ = ["ssd_scan_ref", "ssd_decode_step_ref"]


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int = 128):
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    if x.numel() == 0:                                           # no step: the zero state
        return torch.empty_like(x), torch.zeros((b, h, n, p), dtype=torch.float32,
                                                device=x.device)
    rep = h // g
    Bh = Bm.repeat_interleave(rep, dim=2).float()
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    xf, dtf = x.float(), dt.float()

    nc = s // chunk
    xc = xf.reshape(b, nc, chunk, h, p)
    dtc = dtf.reshape(b, nc, chunk, h)
    Bc = Bh.reshape(b, nc, chunk, h, n)
    Cc = Ch.reshape(b, nc, chunk, h, n)

    dA = dtc * A.float()                                         # log-decay per step (< 0)
    dA_cum = torch.cumsum(dA, dim=2)                             # inclusive

    # -- intra-chunk (the dual, attention-like block) -----------------------
    diff = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b, c, i, j, h)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    # the mask goes in BEFORE exp: masked entries have diff > 0 and may
    # overflow to inf
    decay = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    M = scores * decay * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # -- chunk states --------------------------------------------------------
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (b, c, q, h)
    weighted_B = (decay_to_end * dtc)[..., None] * Bc            # (b, c, q, h, n)
    chunk_states = torch.einsum("bcqhn,bcqhp->bchnp", weighted_B, xc)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                 # (b, c, h)

    # -- inter-chunk recurrence: the state entering each chunk ----------------
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    states_in = torch.stack(states_in, dim=1)                    # (b, c, h, n, p)

    y_inter = torch.einsum("bcihn,bchnp->bcihp", Cc * torch.exp(dA_cum)[..., None], states_in)
    y = (y_diag + y_inter).reshape(b, s, h, p).to(x.dtype)
    return y, state


def ssd_decode_step_ref(x, dt, A, Bm, Cm, state):
    """One-token state update.  x: (B, H, P), dt: (B, H), Bm/Cm: (B, G, N),
    state: (B, H, N, P).  Returns (y (B, H, P) in x's dtype, new state)."""
    h = x.shape[1]
    rep = h // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dA = torch.exp(dt.float() * A.float())                                  # (B, H)
    contrib = dt.float()[..., None, None] * Bh[..., :, None] * x.float()[..., None, :]
    new_state = state * dA[..., None, None] + contrib                      # (B, H, N, P)
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return y.to(x.dtype), new_state
