"""Checkpoints: the JAX package's framework-neutral manifest format, read
with numpy, and the in-memory weight quantizer."""
