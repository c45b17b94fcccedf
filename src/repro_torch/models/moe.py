"""Mixture-of-Experts layer: dropless top-k routing over grouped matmuls.

A port of `repro/models/moe.py` for serving on one device: routing once
per layer, then the tokens' (token, expert) pairs sorted by expert and
run through the grouped matmul op (``binding["moe_gmm"]``: the CUDA
kernel, or `moe_gmm_ref`).  Shared experts (moonshot) are a dense MLP
added to the routed output.  The JAX package's expert-parallel
``shard_map`` branch, its token chunking and its load-balancing aux loss
are training and mesh paths, not ported here.

Two choices differ in form from the JAX code, not in value:

  * ``w_in`` and ``w_gate`` go through the op one at a time (three
    launches a layer).  The JAX code concatenates them on every call; at
    moonshot's widths that is a 738 MB copy a layer a step, and a fused
    copy kept beside the leaves would not fit the card.  Column for
    column the products are the same, capacity drops included.
  * The combine sums each token's k pairs as a (T, k, D) view instead of
    a scatter-add: after ``inv_order`` the pairs are token-major, and a
    plain reduction has a fixed order where ``index_add_`` on the card
    would use atomics.

Nothing here reads a device tensor on the host: the group sizes come
from a search in the sorted pair experts, not from ``bincount`` (which
syncs on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_schema
from repro_torch.models.schema import LeafSpec

__all__ = ["moe_schema", "moe_apply"]


def moe_schema(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    leaves = {
        "router": LeafSpec((d, e), ("embed", None), init="scaled", dtype="float32"),
        "w_in": LeafSpec((e, d, f), ("experts", "embed", "ff"), init="scaled"),
        "w_gate": LeafSpec((e, d, f), ("experts", "embed", "ff"), init="scaled"),
        "w_out": LeafSpec((e, f, d), ("experts", "ff", "embed"), init="scaled"),
    }
    if cfg.n_shared_experts:
        leaves["shared"] = mlp_schema(cfg, d_ff=cfg.n_shared_experts * cfg.expert_d_ff)
    return leaves


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """(top_p (T, k) f32 renormalised, top_i (T, k) int64).  The JAX
    function also returns the full probabilities, for the aux loss."""
    probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_i


def _gmm_pairs(x_flat, top_p, top_i, w_in, w_gate, w_out, cfg: ModelConfig, binding):
    """Sorted grouped-matmul MoE with the given routing."""
    t, d = x_flat.shape
    e, k = cfg.num_experts, cfg.top_k
    pair_expert = top_i.reshape(-1)                                  # (T*k,)
    # stable, as jnp.argsort: above 1024 rows the reference's capacity
    # slots follow this order, so it decides which rows drop
    order = torch.argsort(pair_expert, stable=True)
    inv_order = torch.argsort(order)
    token_of_pair = torch.arange(t * k, device=x_flat.device) // k
    x_sorted = x_flat[token_of_pair[order]]
    bounds = torch.searchsorted(pair_expert[order],
                                torch.arange(e + 1, device=x_flat.device, dtype=top_i.dtype))
    group_sizes = bounds.diff().to(torch.int32)

    gmm = binding["moe_gmm"]
    h = F.silu(gmm(x_sorted, w_gate, group_sizes)) * gmm(x_sorted, w_in, group_sizes)
    y_pairs = gmm(h, w_out, group_sizes)                            # (T*k, D)
    y_pairs = y_pairs[inv_order] * top_p.reshape(-1, 1).to(y_pairs.dtype)
    return y_pairs.view(t, k, d).sum(dim=1)


def _dense_oracle(x_flat, top_p, top_i, params, cfg: ModelConfig):
    """Every expert on every token, combined by the gate weights: exact and
    O(E / k) wasteful — the tests' oracle."""
    combine = torch.zeros((x_flat.shape[0], cfg.num_experts), dtype=torch.float32,
                          device=x_flat.device)
    combine.scatter_add_(1, top_i, top_p)
    h_in = torch.einsum("td,edf->tef", x_flat, params["w_in"])
    h_gate = torch.einsum("td,edf->tef", x_flat, params["w_gate"])
    y_e = torch.einsum("tef,efd->ted", F.silu(h_gate) * h_in, params["w_out"])
    return torch.einsum("ted,te->td", y_e, combine.to(y_e.dtype))


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, binding) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) in x's dtype: the routed experts' output
    plus, where the config has them, the shared experts'."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    top_p, top_i = _route(x_flat, params["router"], cfg.top_k)
    y = _gmm_pairs(x_flat, top_p, top_i, params["w_in"], params["w_gate"],
                   params["w_out"], cfg, binding)
    if cfg.n_shared_experts:
        y = y + mlp_apply(params["shared"], x, binding).reshape(b * s, d).to(y.dtype)
    return y.reshape(b, s, d).to(x.dtype)
