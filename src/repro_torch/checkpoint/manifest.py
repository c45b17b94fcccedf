"""Single-manifest checkpoints, read on PyTorch; the weight quantizer.

The JAX package writes a checkpoint as one ``manifest.json`` (tree paths,
shape, dtype, offset, size and a sha256 prefix of every leaf) and one
``data.blob`` (`repro/checkpoint/manifest.py`, format
``repro-manifest-v1``).  `restore_checkpoint` reads it with numpy and json
alone: bfloat16 and float8_e4m3fn entries are read as raw uint16 / uint8
and reinterpreted with `torch.Tensor.view`, so no ``ml_dtypes`` is needed.
A quantized save (``save_checkpoint(quantize="int8"|"fp8")``) stores each
quantizable leaf as codes plus a ``<path>.scale`` entry; by default they
are dequantized back to the leaf's original dtype, and with
``dequantize=False`` the leaf restores in storage form, ``{"q", "scale"}``
— what a quantized model binds.

`quantize_tree` is the in-memory analogue of a quantized save followed by
a ``dequantize=False`` restore, with the same choice of leaves and the
same codes (`repro_torch.kernels.quant`).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.quant import FORMATS, RAW_BITS, dequantize as dequant
from repro_torch.kernels.quant import quantize_per_channel, storage_dtype

__all__ = ["latest_step", "quantize_tree", "restore_checkpoint"]

FORMAT = "repro-manifest-v1"


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out: list[tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return [(prefix, tree)]


def _unflatten_into(skeleton: Any, values: dict[str, Any], prefix: str = "") -> Any:
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(skeleton[k], values, f"{prefix}/{k}" if prefix else str(k))
                for k in skeleton}
    if isinstance(skeleton, (tuple, list)):
        seq = [_unflatten_into(v, values, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(skeleton)]
        return type(skeleton)(seq) if not hasattr(skeleton, "_fields") else type(skeleton)(*seq)
    return values[prefix]


# --------------------------------------------------------------------------- #
# the weight quantizer
# --------------------------------------------------------------------------- #
# subtrees whose apply functions consume raw arrays (no dequant hook), so
# their weights stay full precision even in a quantized tree
_QUANT_EXCLUDED_SUBTREES = ("moe", "ssm")


def _quantizable(path: str, leaf: Any) -> bool:
    """Leaves the quantizer touches: matmul-style float weights (name
    ``w*`` or the ``tok`` embedding, >= 2-d) outside the moe/ssm subtrees.
    Norm gains, biases and integer leaves stay full precision; a stacked
    norm gain is 2-d too, so the filter is by name, not just rank."""
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2 or not leaf.is_floating_point():
        return False
    parts = path.split("/")
    if any(seg in _QUANT_EXCLUDED_SUBTREES for seg in parts):
        return False
    return parts[-1].startswith("w") or parts[-1] == "tok"


def _quantize_leaf(leaf: torch.Tensor, fmt: str) -> dict[str, torch.Tensor]:
    """``{"q", "scale"}`` of one leaf, axis -2 reduced.  A leaf of rank 3 or
    more is quantized one slice of its leading (block) axis at a time:
    axis -2 never is that axis, so the codes are the same, and the float32
    temporaries are one slice's, not the stack's."""
    if leaf.dim() < 3:
        q, s = quantize_per_channel(leaf, axis=-2, fmt=fmt)
        return {"q": q, "scale": s}
    q = torch.empty(leaf.shape, dtype=storage_dtype(fmt), device=leaf.device)
    s = torch.empty(leaf.shape[:-2] + leaf.shape[-1:], dtype=torch.float32, device=leaf.device)
    for i in range(leaf.shape[0]):
        q[i], s[i] = quantize_per_channel(leaf[i], axis=-2, fmt=fmt)
    return {"q": q, "scale": s}


def quantize_tree(tree: Any, fmt: str) -> Any:
    """Every quantizable leaf of `tree` (torch tensors) becomes a
    ``{"q", "scale"}`` storage subtree (codes and axis -2 per-channel
    float32 scales, on the leaf's device); everything else passes
    through."""
    if fmt not in FORMATS:
        raise ValueError(f"quantize format must be one of {FORMATS}, got {fmt!r}")
    values = {path: _quantize_leaf(leaf, fmt) if _quantizable(path, leaf) else leaf
              for path, leaf in _flatten(tree)}
    return _unflatten_into(tree, values)


# --------------------------------------------------------------------------- #
# the reader
# --------------------------------------------------------------------------- #
def latest_step(directory: Path | str) -> int | None:
    p = Path(directory) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def _tensor(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """One entry's bytes (a uint8 copy) as a CPU tensor of its dtype."""
    if dtype in RAW_BITS:
        bits, tdtype = RAW_BITS[dtype]
        return torch.from_numpy(raw.view(bits).reshape(shape)).view(tdtype)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape))


def restore_checkpoint(directory: Path | str, skeleton: Any, *, step: int | None = None,
                       verify: bool = False, dequantize: bool = True) -> tuple[Any, int]:
    """Restore a ``repro-manifest-v1`` checkpoint into `skeleton`'s
    structure as CPU tensors; returns ``(tree, step)`` (`step` defaults to
    the ``LATEST`` pointer).  ``verify=True`` checks every entry's sha256
    prefix and raises IOError on a mismatch.  Quantized entries are
    dequantized to their original dtype, or with ``dequantize=False``
    restore as ``{"q": codes, "scale": scales}``."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no LATEST pointer in {directory}")
    ckpt_dir = directory / f"step_{step:010d}"
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{ckpt_dir}: format {manifest.get('format')!r}, expected {FORMAT}")
    blob = np.memmap(ckpt_dir / "data.blob", dtype=np.uint8, mode="r")
    entries = manifest["entries"]

    arrays: dict[str, torch.Tensor] = {}
    for path, ent in entries.items():
        raw = np.array(blob[ent["offset"]:ent["offset"] + ent["nbytes"]])
        if verify and hashlib.sha256(raw.tobytes()).hexdigest()[:16] != ent["sha256_16"]:
            raise IOError(f"checksum mismatch for {path} in step {step}")
        arrays[path] = _tensor(raw, ent["dtype"], ent["shape"])

    values: dict[str, Any] = {}
    for path, ent in entries.items():
        if path.endswith(".scale") and path[:-len(".scale")] in entries:
            continue                      # companion of a quantized leaf
        qmeta = ent.get("quant")
        if qmeta is None:
            values[path] = arrays[path]
        elif dequantize:
            values[path] = dequant(arrays[path], arrays[path + ".scale"], axis=int(qmeta["axis"]),
                                   dtype=getattr(torch, qmeta["orig_dtype"]))
        else:
            values[path] = {"q": arrays[path], "scale": arrays[path + ".scale"]}
    return _unflatten_into(skeleton, values), step
