"""Bundle — the container image of a program.

A copy of `repro/core/bundle.py`: same fields, same JSON, same digest,
so a bundle saved by either package loads in the other.

A Docker image packs "the application and all the dependencies needed for
its correct execution" and is hardware-agnostic.  `repro`'s Bundle packs the
*program*: the model configuration, the training/serving recipe, the list of
logical ops the program uses (its "dynamic library dependencies"), required
ABI strings for each, and the environment defaults baked at build time.

Like an image, a bundle is identified by content digest and is immutable;
like an image, it may name a *base* bundle it extends (layering), which the
Gateway flattens at pull time.  Weights are NOT inside the bundle — they
live in checkpoint manifests (the persistent volume of the paper §II-A).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Mapping

from repro_torch.core.abi import AbiString, parse_abi

__all__ = ["Bundle", "BundleError"]

_FORMAT_VERSION = 1


class BundleError(ValueError):
    pass


def _digest(payload: Mapping[str, Any]) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class Bundle:
    name: str                                  # e.g. "qwen2.5-14b"
    tag: str                                   # e.g. "latest"
    model_config: Mapping[str, Any]            # arch definition (may be partial if base set)
    recipe: Mapping[str, Any]                  # optimizer/schedule/serving knobs
    required_ops: Mapping[str, str]            # op name -> required ABI string
    env: Mapping[str, str]                     # baked-in environment defaults
    base: str | None = None                    # "name:tag" of a parent bundle
    tuning_bundle: str | None = None           # path/reference of a portable
    # tuning bundle shipped with this run bundle.  Part of the schema (and
    # the digest); the port has no tuning stack yet, so its Runtime does
    # not read it.
    format_version: int = _FORMAT_VERSION

    # -- identity ----------------------------------------------------------
    @property
    def reference(self) -> str:
        return f"{self.name}:{self.tag}"

    @property
    def digest(self) -> str:
        return _digest(self.to_dict())

    def required_abis(self) -> dict[str, AbiString]:
        return {op: parse_abi(text) for op, text in self.required_ops.items()}

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {
            "format_version": self.format_version,
            "name": self.name,
            "tag": self.tag,
            "base": self.base,
            "tuning_bundle": self.tuning_bundle,
            "model_config": dict(self.model_config),
            "recipe": dict(self.recipe),
            "required_ops": dict(self.required_ops),
            "env": dict(self.env),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Bundle":
        if d.get("format_version") != _FORMAT_VERSION:
            raise BundleError(
                f"unsupported bundle format {d.get('format_version')!r}"
            )
        try:
            return cls(
                name=d["name"],
                tag=d["tag"],
                base=d.get("base"),
                tuning_bundle=d.get("tuning_bundle"),
                model_config=dict(d["model_config"]),
                recipe=dict(d["recipe"]),
                required_ops=dict(d["required_ops"]),
                env=dict(d["env"]),
            )
        except KeyError as e:  # pragma: no cover - defensive
            raise BundleError(f"bundle missing field {e}") from e

    def save(self, path: Path | str) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True))
        return path

    @classmethod
    def load(cls, path: Path | str) -> "Bundle":
        return cls.from_dict(json.loads(Path(path).read_text()))

    # -- layering -------------------------------------------------------------
    def flatten_onto(self, parent: "Bundle") -> "Bundle":
        """Collapse this bundle onto its base (Gateway 'flatten' step).

        Docker semantics: the child layer wins on conflicts; required_ops
        union with child precedence; env merge likewise.
        """
        if self.base != parent.reference:
            raise BundleError(
                f"{self.reference} declares base {self.base!r}, got {parent.reference}"
            )
        return Bundle(
            name=self.name,
            tag=self.tag,
            base=None,
            tuning_bundle=self.tuning_bundle or parent.tuning_bundle,
            model_config={**parent.model_config, **self.model_config},
            recipe={**parent.recipe, **self.recipe},
            required_ops={**parent.required_ops, **self.required_ops},
            env={**parent.env, **self.env},
        )
