"""Build and bind the CUDA kernels, at first use.

The sources under ``csrc/`` are compiled for ``sm_90a`` by
``torch.utils.cpp_extension.load`` into ``<repo>/.torch_ext_build`` the
first time a kernel is needed (a deployment on the card binds them, which
builds them).  Nothing here runs at import time: the package imports on
machines without ``nvcc`` or a GPU, where the kernels are never built.

No source includes PyTorch's headers, so the library is a plain shared
object (``is_python_module=False``) bound with ctypes; it builds in
seconds.  A build failure raises.

`LAUNCHES` counts kernel launches by op name.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that a path
went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "library", "check", "check_layout", "dtype_code", "stream_of"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "binding.cpp", CSRC / "rmsnorm.cu", CSRC / "flash_attention.cu",
           CSRC / "moe_gmm.cu")
# src/repro_torch/kernels/_build.py -> the repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / ".torch_ext_build"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

LAUNCHES: collections.Counter = collections.Counter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The built kernel library (building it on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = load(name="repro_torch_kernels", sources=[str(s) for s in SOURCES],
                        extra_cuda_cflags=CUDA_FLAGS, build_directory=str(BUILD_DIR),
                        is_python_module=False, verbose=False)
            _lib = _bind(ctypes.CDLL(path))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_rmsnorm.argtypes = [i, p, p, p, ctypes.c_longlong, i, f, p]
    lib.repro_rmsnorm.restype = i
    lib.repro_flash_attention.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, p,
                                          i, i, i, i, i, f, i, i, p]
    lib.repro_flash_attention.restype = i
    lib.repro_moe_gmm.argtypes = [i, p, p, p, p, ctypes.c_longlong, i, i, i, p]
    lib.repro_moe_gmm.restype = i
    lib.repro_error_string.argtypes = [i]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned an error (a refused launch never runs)."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (code {code})")


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32, bfloat16)")
    return _DTYPE_CODES[t.dtype]


def check_layout(what: str, *tensors: torch.Tensor) -> None:
    """The kernels read and write in 16-byte vectors along the last
    dimension: every tensor must be contiguous, 16-byte aligned, and its
    last dimension a whole number of vectors."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
            raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} is not laid out in "
                             "whole 16-byte vectors (aligned base, last dim)")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
