"""Synthetic token data of the port (numpy, as the JAX package's)."""
from .tokens import TokenPipeline, PsiWeightedSampler

__all__ = ["TokenPipeline", "PsiWeightedSampler"]
