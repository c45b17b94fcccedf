"""Entry points: bundles and the serving engine."""
