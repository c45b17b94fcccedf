"""Plain PyTorch versions of the grouped (ragged) expert matmul.

A port of `repro/kernels/moe_gmm_ref.py`.  Rows of ``x`` (T, D) are sorted
by expert and ``group_sizes`` (E,) partitions them; row i of the output is
``x[i] @ w[expert(i)]``, accumulated in fp32 and stored in x's dtype.

  * `moe_gmm_exact` is dropless: a loop over the experts, one product per
    non-empty group.  It reads the group sizes on the host, so it is the
    CPU path of the kernel wrapper and the card's yardstick, never the
    card's serving path.
  * `moe_gmm_ref` is what the reference binding serves, as in the JAX
    package: dropless at ``T <= _EXACT_ROWS_MAX`` rows, and above that the
    capacity formulation — each group packed into ``cap = cf * T / E``
    slots, one batched product, overflow rows returned as 0.  The drop set
    depends on T, which is why decode and small prefill stay exact
    (`docs/kernels.md`, "Dropless reference at decode scale").
"""

from __future__ import annotations

import torch

__all__ = ["moe_gmm_ref", "moe_gmm_exact", "DEFAULT_CAPACITY_FACTOR"]

DEFAULT_CAPACITY_FACTOR = 1.25

# Row count at or below which the reference is dropless (as the JAX one).
_EXACT_ROWS_MAX = 1024


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, in x's dtype (batched over w's lead)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def moe_gmm_exact(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Dropless grouped matmul.  Rows past sum(group_sizes) are 0, and a
    group reaching past T is cut at T (what the kernel does with such
    sizes; the ABI has sum == T)."""
    t, f = x.shape[0], w.shape[-1]
    out = torch.zeros((t, f), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        stop = min(start + max(n, 0), t)
        if stop > start:
            out[start:stop] = _product(x[start:stop], w[e])
        start = stop
    return out


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                capacity_factor: float | None = None) -> torch.Tensor:
    """capacity_factor=None (the binding's call convention) picks the
    dropless path at <= _EXACT_ROWS_MAX rows and the default capacity
    factor above; an explicit value always runs the capacity formulation."""
    t, d = x.shape
    e, _, f = w.shape
    if capacity_factor is None:
        if t <= _EXACT_ROWS_MAX:
            return moe_gmm_exact(x, w, group_sizes)
        capacity_factor = DEFAULT_CAPACITY_FACTOR
    cap = max(int(capacity_factor * t / e + 0.999), 1)

    sizes = group_sizes.to(device=x.device, dtype=torch.int64)
    starts = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)[:-1]])
    # row i belongs to expert ei at intra-group offset oi
    idx = torch.arange(t, device=x.device)
    ei = torch.searchsorted(starts, idx, right=True) - 1
    oi = idx - starts[ei]
    keep = oi < cap

    # pack into capacity slots; dropped rows go to a trash slot
    slot = torch.where(keep, ei * cap + oi, e * cap)
    packed = x.new_zeros((e * cap + 1, d))
    packed[slot] = x
    y = _product(packed[:e * cap].reshape(e, cap, d), w)
    y_flat = torch.cat([y.reshape(e * cap, f), y.new_zeros((1, f))])
    return y_flat[slot] * keep[:, None].to(y.dtype)
