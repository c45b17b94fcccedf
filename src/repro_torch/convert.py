"""Weights bridge: the JAX package's parameters -> the port's state dict.

`params_from_jax` takes the JAX parameter tree as numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives: ``decoder/p0/*`` stacked over
the blocks) or as torch tensors (already on the model's device, say) and
returns the port's state dict (``layers.{i}.*``) with the block axis
unstacked and every leaf name kept.  A leaf may be in storage form,
``{"q", "scale"}`` (what ``quantize_tree`` or a ``dequantize=False``
restore gives): its codes have the leaf's shape and its scales the leaf's
shape without axis -2.  Shapes are checked against the port's schema,
which is the JAX package's.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant import RAW_BITS
from repro_torch.models.model import Model, flatten_params, tree_items
from repro_torch.models.schema import leaf_items

__all__ = ["params_from_jax", "torch_tree"]


def _to_torch(arr: Any) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.asarray(arr)
    if a.dtype.name in RAW_BITS:
        bits, dtype = RAW_BITS[a.dtype.name]
        return torch.from_numpy(a.view(bits).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def torch_tree(tree: Any) -> Any:
    """A nested tree of numpy arrays (or torch tensors) as torch tensors
    with the same bits (bfloat16 and float8 through their raw bits)."""
    if isinstance(tree, Mapping):
        return {k: torch_tree(v) for k, v in tree.items()}
    return _to_torch(tree)


def _nest(flat: Mapping[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    specs = dict(leaf_items(Model(cfg, binding={}, device="meta").schema()))
    flat = dict(tree_items(np_tree))
    want: dict[str, tuple[int, ...]] = {}
    for path, spec in specs.items():
        if f"{path}/q" in flat and f"{path}/scale" in flat:
            want[f"{path}/q"] = spec.shape
            want[f"{path}/scale"] = spec.shape[:-2] + spec.shape[-1:]
        else:
            want[path] = spec.shape
    if set(flat) != set(want):
        raise KeyError(f"parameter tree mismatch: missing {sorted(set(want) - set(flat))[:4]}, "
                       f"unexpected {sorted(set(flat) - set(want))[:4]}")
    for path, shape in want.items():
        if tuple(np.shape(flat[path])) != shape:
            raise ValueError(f"{path}: shape {tuple(np.shape(flat[path]))}, expected {shape}")
    return flatten_params(_nest({p: _to_torch(a) for p, a in flat.items()}))
