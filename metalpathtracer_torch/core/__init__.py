"""Vector math and the counter-based RNG, on torch tensors."""

from metalpathtracer_torch.core import rng, vecmath

__all__ = ["rng", "vecmath"]
