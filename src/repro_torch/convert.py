"""Weights bridge: the JAX package's parameters -> the port's state dict.

`params_from_jax` takes the JAX parameter tree as numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives: ``decoder/p0/*`` stacked over
the blocks) and returns the port's state dict (``layers.{i}.*``) with the
block axis unstacked and every leaf name kept.  Shapes are checked against
the port's schema, which is the JAX package's.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, flatten_params, tree_items
from repro_torch.models.schema import leaf_items

__all__ = ["params_from_jax"]


def _to_torch(arr: Any) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


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
    if set(flat) != set(specs):
        raise KeyError(f"parameter tree mismatch: missing {sorted(set(specs) - set(flat))[:4]}, "
                       f"unexpected {sorted(set(flat) - set(specs))[:4]}")
    for path, spec in specs.items():
        if tuple(np.shape(flat[path])) != spec.shape:
            raise ValueError(f"{path}: shape {np.shape(flat[path])}, expected {spec.shape}")
    return flatten_params(_nest({p: _to_torch(a) for p, a in flat.items()}))
