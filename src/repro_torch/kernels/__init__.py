"""Kernels: plain PyTorch references and their hand-written CUDA ports.

Nothing here builds or loads CUDA code at import time; see `_build`.
"""
