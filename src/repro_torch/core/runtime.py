"""Runtime — the Shifter Runtime's deploy stages, on PyTorch.

    prepare environment  -> resolve the platform from the requested device
                            (REPRO_VISIBLE_DEVICES picks the CUDA index),
                            check the bundle's ABIs, swap ops (native
                            support), build the CUDA kernels
    chroot jail          -> Container: the program sees only the frozen
                            OpBinding and the merged env
    drop privileges      -> freeze the registry (no rebinding mid-run)
    export env variables -> bundle env plus the host's REPRO_VISIBLE_DEVICES
    cleanup              -> thaw the registry, release the container

Unlike the JAX package there is no quiet fallback.  A deployment on
``"cuda"`` without a Hopper card raises, and so does one on which an op
that has a registered CUDA kernel ends up on its reference (the platform
lacks the feature it needs) or whose kernel fails to build; a kernel
whose ABI differs from its op's is refused already at registration.  Only
an explicit ``native_ops=False`` binds the references on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping

import torch

from repro_torch.core.bundle import Bundle
from repro_torch.core.env import ENV_VISIBLE, cuda_index
from repro_torch.core.platform import Platform, PlatformError, platform_for
from repro_torch.core.registry import OpBinding, OpRegistry, global_registry

__all__ = ["Runtime", "Container", "DeploymentError"]

# Host variables a container inherits (Shifter: "selected variables from the
# host system are also added", per site configuration).
_HOST_ENV_ALLOWLIST = (ENV_VISIBLE,)


class DeploymentError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Container:
    """A deployed program: ops come only from ``binding``, the device from
    ``platform``, configuration from ``env``/``bundle``.

    ``unported`` names the ops the bundle requires (its ABI matches) that
    this package has no implementation of yet; the binding has no entry
    for them, so a call to one raises KeyError.
    """

    bundle: Bundle
    platform: Platform
    binding: OpBinding
    env: Mapping[str, str]
    native_ops: bool
    unported: tuple[str, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.platform.device

    def describe(self) -> str:
        head = (
            f"container {self.bundle.reference} (digest {self.bundle.digest})\n"
            f"  platform: {self.platform.name} ({self.platform.hardware.name}, "
            f"{self.device})\n"
            f"  native ops: {'enabled' if self.native_ops else 'disabled'}\n"
        )
        lines = [self.binding.describe()]
        lines += [f"  {op:<18} !! not ported (no implementation in repro_torch)"
                  for op in self.unported]
        return head + "\n".join(lines)


class Runtime:
    """Deploys bundles onto a site.  One container at a time.

    Args:
      registry: the op registry to bind from; defaults to the process
        global one, filled by ``repro_torch.kernels.ops.register_all``.
      host_env: the site environment (REPRO_VISIBLE_DEVICES, which the
        container also inherits); defaults to ``os.environ``.
    """

    def __init__(self, registry: OpRegistry | None = None,
                 host_env: Mapping[str, str] | None = None) -> None:
        if registry is None:
            from repro_torch.kernels.ops import register_all

            registry = register_all(global_registry)
        self.registry = registry
        self.host_env = dict(os.environ if host_env is None else host_env)
        self._active: Container | None = None

    def deploy(self, bundle: Bundle, *, device: str | torch.device = "cuda",
               native_ops: bool = True) -> Container:
        """Run the preparation stages and hand back the Container.

        Args:
          device: ``"cuda"`` (the card REPRO_VISIBLE_DEVICES names, 0 when
            unset) or ``"cpu"``.  CUDA without a Hopper card raises.
          native_ops: the ``--mpi`` flag.  On by default; on the card every
            op with a registered CUDA kernel must then bind it.  False binds
            every reference — a caller's explicit choice.

        Raises DeploymentError when the device is missing or unsupported,
        the site cannot satisfy a bundle-required ABI, a native that should
        bind does not, a kernel fails to build, or a container is already
        active in this Runtime.
        """
        if self._active is not None:
            raise DeploymentError("a container is already running in this Runtime; "
                                  "cleanup() first")

        # -- stage: resolve the device ---------------------------------------
        dev = torch.device(device)
        try:
            index = cuda_index(self.host_env) if dev.type == "cuda" else 0
            platform = platform_for(dev, index)
        except (PlatformError, ValueError) as e:
            raise DeploymentError(f"cannot deploy on {device!r}: {e}") from e

        # -- stage: ABI verification against the bundle's requirements ----------
        required = bundle.required_abis()
        for op, want in required.items():
            try:
                decl = self.registry.decl(op)
            except KeyError as e:
                raise DeploymentError(f"site provides no op '{op}'") from e
            why = want.why_incompatible(decl.abi)
            if why is not None:
                raise DeploymentError(
                    f"bundle requires {want} but site declares {decl.abi}: {why}")

        implemented = [op for op in required if self.registry.decl(op).impls]
        unported = tuple(op for op in required if op not in implemented)

        # -- stage: swap ops (builds the kernels of every bound native) --------
        try:
            binding = self.registry.bind(implemented, platform, native=native_ops)
        except (OSError, RuntimeError, ImportError) as e:
            self.registry.thaw()
            raise DeploymentError(f"native kernels failed to build: {e}") from e
        if native_ops and platform.device.type == "cuda":
            for r in binding.reports:
                if not r.swapped and self.registry.decl(r.op).natives():
                    self.registry.thaw()
                    raise DeploymentError(
                        f"op '{r.op}' has a CUDA kernel but bound {r.reason}; "
                        "pass native_ops=False to serve the references on purpose")

        # -- stage: export of environment variables -----------------------------
        env = dict(bundle.env)
        for key in _HOST_ENV_ALLOWLIST:
            if key in self.host_env:
                env[key] = self.host_env[key]

        container = Container(bundle=bundle, platform=platform, binding=binding,
                              env=env, native_ops=native_ops, unported=unported)
        self._active = container
        return container

    def cleanup(self) -> None:
        """Release the container and thaw the registry."""
        self._active = None
        self.registry.thaw()
