"""OpRegistry — the library-substitution engine (the paper's §IV-B).

A logical op (``rmsnorm``, ``attention``, ...) is declared once with its
ABI.  Implementations register against it:

  * REFERENCE — plain PyTorch, hardware-agnostic: the MPICH the image
                ships with.
  * NATIVE    — a hand-written CUDA kernel: the vendor library the host
                bind-mounts in.

At deployment the Runtime asks the registry for a *binding*: a frozen
name -> callable table for one platform.  A native is chosen when the
platform has the feature it requires and its ABI string is compatible
with the declaration; the binding records why each op got what it got.
The registry does not decide whether a reference is acceptable — the
Runtime refuses a CUDA deployment on which an op with a native ends up
on its reference.

A copy of `repro/core/registry.py` without the tuning hooks.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterable, Mapping

from repro_torch.core.abi import AbiIncompatibility, AbiString
from repro_torch.core.platform import Platform

__all__ = ["ImplKind", "OpImpl", "OpDecl", "OpRegistry", "OpBinding",
           "SwapReport", "global_registry"]


class ImplKind(enum.Enum):
    REFERENCE = "reference"
    NATIVE = "native"


@dataclasses.dataclass(frozen=True)
class OpImpl:
    """One implementation of a logical op."""

    abi: AbiString
    kind: ImplKind
    fn: Callable[..., Any]
    requires_feature: str | None = None   # e.g. "cuda_kernels"
    provider: str = ""                    # human label ("cuda", "torch-ref")
    prepare: Callable[[], Any] | None = None   # run once when the impl is
    # bound (builds the CUDA extension); an exception fails the deployment

    def available_on(self, platform: Platform) -> bool:
        return self.requires_feature is None or platform.has(self.requires_feature)


@dataclasses.dataclass(frozen=True)
class OpDecl:
    """The logical op: its required ABI plus registered implementations."""

    abi: AbiString
    impls: tuple[OpImpl, ...] = ()

    @property
    def reference(self) -> OpImpl | None:
        for impl in self.impls:
            if impl.kind is ImplKind.REFERENCE:
                return impl
        return None

    def natives(self) -> tuple[OpImpl, ...]:
        return tuple(i for i in self.impls if i.kind is ImplKind.NATIVE)


@dataclasses.dataclass(frozen=True)
class SwapReport:
    """Per-op outcome of the binding stage."""

    op: str
    bound: str          # provider label of the bound impl
    kind: ImplKind
    swapped: bool       # True if a native impl replaced the reference
    reason: str         # why this impl (or why the swap was refused)


class OpBinding(Mapping[str, Callable[..., Any]]):
    """Frozen name -> callable table handed to the model at execution."""

    def __init__(self, table: dict[str, OpImpl], reports: list[SwapReport]):
        self._table = dict(table)
        self.reports = tuple(reports)

    def __getitem__(self, name: str) -> Callable[..., Any]:
        return self._table[name].fn

    def __iter__(self):
        return iter(self._table)

    def __len__(self) -> int:
        return len(self._table)

    def describe(self) -> str:
        lines = []
        for r in self.reports:
            mark = "->" if r.swapped else "=="
            lines.append(f"  {r.op:<18} {mark} {r.bound:<12} [{r.kind.value}] {r.reason}")
        return "\n".join(lines)


class OpRegistry:
    def __init__(self) -> None:
        self._decls: dict[str, OpDecl] = {}
        self._frozen = False

    # -- declaration -------------------------------------------------------
    def declare(self, abi: AbiString) -> None:
        self._check_mutable()
        if abi.name in self._decls:
            existing = self._decls[abi.name].abi
            if existing != abi:
                raise AbiIncompatibility(abi, existing, "redeclaration with different ABI")
            return
        self._decls[abi.name] = OpDecl(abi=abi)

    def register(self, impl: OpImpl) -> None:
        """Attach an implementation; the ABI check is the libtool-string
        check, and a mismatch is the author's error (raises)."""
        self._check_mutable()
        decl = self._decls.get(impl.abi.name)
        if decl is None:
            raise KeyError(f"op '{impl.abi.name}' was never declared")
        if not decl.abi.compatible_with(impl.abi):
            reason = decl.abi.why_incompatible(impl.abi) or "incompatible"
            raise AbiIncompatibility(decl.abi, impl.abi, reason)
        self._decls[impl.abi.name] = dataclasses.replace(decl, impls=decl.impls + (impl,))

    # -- binding (the deployment-time swap) ---------------------------------
    def bind(self, ops: Iterable[str], platform: Platform, *, native: bool,
             freeze: bool = True) -> OpBinding:
        """Produce the frozen op table for this deployment.

        ``native=False`` reproduces `shifter` without ``--mpi``: every op
        keeps its reference.  ``native=True`` swaps each op whose native is
        available on the platform (its ABI was checked at registration) and
        runs the native's ``prepare`` hook (the kernel build), whose failure
        propagates.
        """
        table: dict[str, OpImpl] = {}
        reports: list[SwapReport] = []
        for name in ops:
            decl = self._decls.get(name)
            if decl is None:
                raise KeyError(f"op '{name}' was never declared")
            ref = decl.reference
            if ref is None:
                raise KeyError(f"op '{name}' has no implementation in this package")
            chosen, swapped, reason = ref, False, "reference (native support disabled)"
            if native:
                reason = "reference (no native impl registered)"
                for cand in decl.natives():
                    if not cand.available_on(platform):
                        reason = (f"reference (native '{cand.provider}' needs "
                                  f"'{cand.requires_feature}' absent on {platform.name})")
                        continue
                    if cand.prepare is not None:
                        cand.prepare()
                    chosen, swapped = cand, True
                    reason = f"native swap ({cand.provider}, abi {cand.abi})"
                    break
            table[name] = chosen
            reports.append(SwapReport(op=name, bound=chosen.provider or chosen.kind.value,
                                      kind=chosen.kind, swapped=swapped, reason=reason))
        if freeze:
            self._frozen = True
        return OpBinding(table, reports)

    # -- lifecycle -----------------------------------------------------------
    @property
    def frozen(self) -> bool:
        return self._frozen

    def thaw(self) -> None:
        """Cleanup-stage reset (successive deployments in one process)."""
        self._frozen = False

    def _check_mutable(self) -> None:
        if self._frozen:
            raise RuntimeError(
                "registry is frozen: ops cannot be (re)registered after the "
                "runtime dropped privileges and started execution")

    def decl(self, name: str) -> OpDecl:
        return self._decls[name]


# The process-global registry `repro_torch.kernels.ops.register_all` fills.
global_registry = OpRegistry()
