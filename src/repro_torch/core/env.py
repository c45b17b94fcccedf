"""Environment variables the runtime reads.

  REPRO_VISIBLE_DEVICES   the CUDA device index a deployment on ``"cuda"``
                          binds (the paper's CUDA_VISIBLE_DEVICES leg).
                          Absent means device 0.  Any value that is not one
                          non-negative integer is an error: unlike the JAX
                          package, an invalid value never switches the
                          accelerator off.
"""

from __future__ import annotations

import re
from typing import Mapping

__all__ = ["ENV_VISIBLE", "cuda_index"]

ENV_VISIBLE = "REPRO_VISIBLE_DEVICES"

_INDEX_RE = re.compile(r"^\s*\d+\s*$")


def cuda_index(env: Mapping[str, str]) -> int:
    """The CUDA device index named by REPRO_VISIBLE_DEVICES (0 when absent).

    Raises ValueError for anything but a single non-negative integer.
    """
    value = env.get(ENV_VISIBLE)
    if value is None:
        return 0
    if not _INDEX_RE.match(value):
        raise ValueError(
            f"{ENV_VISIBLE}={value!r} is not a CUDA device index "
            "(one non-negative integer)")
    return int(value)
