"""The Mamba-2 (SSD) layer in PyTorch: `mamba2-780m`'s mixer.

A port of `repro/models/ssm.py`, leaf for leaf and step for step:
in_proj -> [z | x | B | C | dt]; a causal depthwise conv on x; the SSD scan
through ``binding["ssd_scan"]`` (on the card the CUDA kernel); the D skip;
an RMSNorm gated by silu(z) (plain code, not the ``rmsnorm`` op, as in
JAX); out_proj.  B and C are one group shared by every head.

Decode keeps two pieces of state a layer: the (conv_k - 1) last pre-conv
inputs and the (H, N, P) SSM state, both O(1) in the sequence length.
The one-token update is plain code (`ssd_decode_step_ref`), as in JAX:
it moves the state once and does little arithmetic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan_ref import ssd_decode_step_ref
from repro_torch.models.schema import LeafSpec

__all__ = ["ssm_schema", "ssm_apply", "ssm_decode", "ssm_prefill_chunk",
           "ssm_init_cache_shapes"]

_NGROUPS = 1  # B/C shared across heads (mamba2 default ngroups=1)


def ssm_schema(cfg: ModelConfig) -> dict[str, LeafSpec]:
    d = cfg.d_model
    din = cfg.ssm_d_inner
    h = cfg.ssm_heads
    n = cfg.ssm_state
    return {
        "w_z": LeafSpec((d, din), ("embed", "ssm_inner"), init="scaled"),
        "w_x": LeafSpec((d, din), ("embed", "ssm_inner"), init="scaled"),
        "w_b": LeafSpec((d, _NGROUPS * n), ("embed", None), init="scaled"),
        "w_c": LeafSpec((d, _NGROUPS * n), ("embed", None), init="scaled"),
        "w_dt": LeafSpec((d, h), ("embed", "ssm_heads"), init="scaled"),
        "dt_bias": LeafSpec((h,), ("ssm_heads",), init="zeros"),
        "a_log": LeafSpec((h,), ("ssm_heads",), init="normal", scale=0.5),
        "d_skip": LeafSpec((h,), ("ssm_heads",), init="ones"),
        "conv_w": LeafSpec((cfg.ssm_conv, din), (None, "ssm_inner"), init="scaled"),
        "conv_b": LeafSpec((din,), ("ssm_inner",), init="zeros"),
        "norm_scale": LeafSpec((din,), ("ssm_inner",), init="ones"),
        "w_out": LeafSpec((din, d), ("ssm_inner", "embed"), init="scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as shifted adds.  x: (B, S, Din), w: (K, Din)."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + pad[:, i:i + s, :].float() * w[i].float()
    return (y + b.float()).to(x.dtype)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _projections(params, x: torch.Tensor):
    return (x @ params["w_z"], x @ params["w_x"], x @ params["w_b"], x @ params["w_c"],
            x @ params["w_dt"])


def _scan_chunk(cfg: ModelConfig, s: int) -> int:
    """JAX's choice of the scan's chunk: the config's, cut to the sequence,
    and the largest common divisor where it does not divide it."""
    chunk = min(cfg.ssm_chunk, s)
    return math.gcd(chunk, s) if s % chunk else chunk


def _dt_a(params, dt: torch.Tensor):
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return dt, -torch.exp(params["a_log"].float())


def _gated_out(params, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """D skip, silu(z)-gated RMSNorm, out_proj: y (B, S, H, P) -> (B, S, D)."""
    b, s = y.shape[:2]
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(b, s, -1)
    y = _rms(y * F.silu(z.float()).to(y.dtype), params["norm_scale"])
    return y @ params["w_out"]


def ssm_apply(params, x: torch.Tensor, cfg: ModelConfig, binding, *,
              return_state: bool = False):
    """Whole-sequence forward: x (B, S, D) -> (B, S, D), and with
    `return_state` the decode cache ``{"state", "conv"}`` it leaves."""
    b, s, _ = x.shape
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    z, xs_pre, bm, cm, dt = _projections(params, x)
    xs = F.silu(_causal_conv(xs_pre, params["conv_w"], params["conv_b"]))
    xh = xs.reshape(b, s, h, p)
    dt, a = _dt_a(params, dt)
    y, state = binding["ssd_scan"](xh, dt, a, bm.reshape(b, s, _NGROUPS, n),
                                   cm.reshape(b, s, _NGROUPS, n), chunk=_scan_chunk(cfg, s))
    out = _gated_out(params, y, xh, z)
    if return_state:
        # the last (conv_k - 1) pre-conv inputs, for decode to continue
        return out, {"state": state, "conv": xs_pre[:, -(cfg.ssm_conv - 1):, :]}
    return out


def ssm_init_cache_shapes(cfg: ModelConfig, batch: int):
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    return {
        "state": ((batch, h, n, p), "float32"),
        "conv": ((batch, cfg.ssm_conv - 1, cfg.ssm_d_inner), cfg.dtype),
    }


def ssm_prefill_chunk(params, x: torch.Tensor, cache: dict, pos: int, n_valid: int,
                      cfg: ModelConfig, binding):
    """C-token state advance for chunked prefill: x (B, C, D) at global
    positions pos.., the first `n_valid` real.  Returns (out, new cache).

    The recurrence is linear in the state, so the chunk is scanned from a
    zero state by the bound op and the carried state's contribution added
    in closed form:

        y_t      += C_t . (exp(cumsum(dt A)_t) * state0)
        state_out = scan_final + exp(cumsum(dt A)_C) * state0

    Padded steps (t >= n_valid) get dt = 0: decay 1 and no input, so the
    state passes them unchanged.  The conv window is [cached tail | chunk]
    and the new tail is sliced at n_valid.  At pos == 0 the cached state
    and tail are a slot's leftovers and are taken as zeros.
    """
    b, c, _ = x.shape
    h, p, n, k = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv
    z, xs, bm, cm, dt = _projections(params, x)
    carried = pos > 0
    tail = cache["conv"].to(xs.dtype) if carried else xs.new_zeros((b, k - 1, xs.shape[-1]))

    # position t of the chunk sees ext[t : t + k], as a whole-sequence conv
    # sees pos + t
    ext = torch.cat([tail, xs], dim=1)                  # (B, k-1+C, Din)
    y = torch.zeros(xs.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + ext[:, i:i + c, :].float() * params["conv_w"][i].float()
    xc = F.silu(y + params["conv_b"].float()).to(x.dtype)

    xh = xc.reshape(b, c, h, p)
    dt, a = _dt_a(params, dt)
    dt = dt * (torch.arange(c, device=x.device)[None, :, None] < n_valid)
    bmg, cmg = bm.reshape(b, c, _NGROUPS, n), cm.reshape(b, c, _NGROUPS, n)
    y, state = binding["ssd_scan"](xh, dt, a, bmg, cmg, chunk=_scan_chunk(cfg, c))

    if carried:
        state0 = cache["state"].float()
        decay = torch.exp(torch.cumsum(dt * a[None, None, :], dim=1))   # (B, C, H)
        y = y + torch.einsum("btn,bth,bhnp->bthp", cmg[:, :, 0].float(), decay,
                             state0).to(y.dtype)
        state = state + decay[:, -1][..., None, None] * state0

    out = _gated_out(params, y, xh, z)
    new_tail = ext[:, n_valid:n_valid + k - 1]
    return out, {"state": state, "conv": new_tail.to(cache["conv"].dtype)}


def ssm_decode(params, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token state update: x (B, 1, D) -> (out (B, 1, D), new cache)."""
    b = x.shape[0]
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    z, xs_new, bm, cm, dt = _projections(params, x[:, 0, :])
    dt, a = _dt_a(params, dt)

    window = torch.cat([cache["conv"], xs_new[:, None, :]], dim=1)   # (B, K, Din)
    xc = (window.float() * params["conv_w"][None].float()).sum(dim=1)
    xc = F.silu(xc + params["conv_b"].float()).to(x.dtype)

    xh = xc.reshape(b, h, p)
    y, new_state = ssd_decode_step_ref(xh, dt, a, bm.reshape(b, _NGROUPS, n),
                                       cm.reshape(b, _NGROUPS, n), cache["state"].float())
    out = _gated_out(params, y[:, None], xh[:, None], z[:, None])
    return out, {"state": new_state, "conv": window[:, 1:, :]}
