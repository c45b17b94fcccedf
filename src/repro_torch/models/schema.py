"""Parameter schema: one declarative source for shapes and initialisation.

Every parameter leaf is declared once as a `LeafSpec` (shape + logical
axis names + initializer), as in `repro/models/schema.py`, so the port's
schema tree equals the JAX package's.  `init_params` materializes it with
an explicit `torch.Generator` on the target device, by the same rules:
``normal`` (N(0, 1) * scale), ``scaled`` (N(0, 1) / sqrt(fan_in), where
fan_in is the leaf's first dimension), ``ones`` and ``zeros``.  The
numbers differ from JAX's (another generator); the distributions do not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = ["LeafSpec", "init_params", "map_leaves", "leaf_items", "torch_dtype"]

Tree = dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """"float32" / "bfloat16" (a config's dtype string) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: str | None = None              # None -> model default

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")

    def std(self) -> float:
        if self.init == "normal":
            return self.scale
        # fan-in scaled; a stacked leaf's first dim is its layer count, as
        # in the JAX package, so the same rule gives the same distribution
        fan_in = self.shape[0] if self.shape else 1
        return 1.0 / math.sqrt(max(fan_in, 1))

    def materialize(self, generator: torch.Generator, default_dtype: torch.dtype) -> torch.Tensor:
        dtype = torch_dtype(self.dtype) if self.dtype else default_dtype
        device = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init not in ("normal", "scaled"):
            raise ValueError(f"unknown init {self.init!r}")
        out = torch.empty(self.shape, dtype=dtype, device=device)
        std = self.std()
        # a stacked leaf is drawn one layer at a time: the float32 draw of a
        # whole (layers, d, ff) stack would double its memory on the card
        slabs = out if self.axes and self.axes[0] == "layers" else out[None]
        for slab in slabs:
            slab.copy_(torch.randn(slab.shape, generator=generator, device=device) * std)
        return out


def leaf_items(tree: Tree, prefix: str = "") -> list[tuple[str, LeafSpec]]:
    out: list[tuple[str, LeafSpec]] = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, LeafSpec):
            out.append((path, v))
        else:
            out.extend(leaf_items(v, path))
    return out


def map_leaves(fn: Callable[[str, LeafSpec], Any], tree: Tree, prefix: str = "") -> Tree:
    out: Tree = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out[k] = fn(path, v) if isinstance(v, LeafSpec) else map_leaves(fn, v, path)
    return out


def init_params(schema: Tree, generator: torch.Generator, default_dtype: str) -> Tree:
    """Materialize every leaf of `schema` on the generator's device."""
    dd = torch_dtype(default_dtype)
    return map_leaves(lambda _, s: s.materialize(generator, dd), schema)
