"""`make_bundle`: the run bundle of an architecture.

The same content as the JAX package's ``repro.launch.train.make_bundle``
(`repro/launch/train.py:41`): the config dict, the recipe, every declared
op with its ABI string, the baked environment.  A bundle made by either
package therefore has the same digest and deploys on either runtime.
"""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core.bundle import Bundle
from repro_torch.kernels.ops import ABIS, OP_NAMES

__all__ = ["make_bundle"]


def make_bundle(arch: str, *, reduced: bool = False) -> Bundle:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return Bundle(
        name=cfg.name,
        tag="latest",
        model_config=cfg.to_dict(),
        recipe={"optimizer": "adamw", "lr": 3e-4},
        required_ops={op: str(ABIS[op]) for op in OP_NAMES},
        env={"REPRO_BUNDLE_KIND": "train"},
    )
