"""repro_torch — the PyTorch/CUDA port of `repro` for NVIDIA Hopper.

The same container model as the JAX package (ABI-checked op binding
through a site runtime, bundles, the serving engine), on PyTorch, with
hand-written CUDA kernels registered as the native implementations of
the ops the JAX package served with Pallas kernels.  It imports nothing
of JAX or of the `repro` package: what it shares with them (config
records, ABI text, the bundle schema, the scheduler) is copied here and
pinned equal by the tests.
"""

__version__ = "0.1.0"
