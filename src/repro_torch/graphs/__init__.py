"""Graph substrate: structure, seeded generators and the dataset stand-ins.

A copy of the JAX package's numpy-only graph code, so the same seed gives the
same graph in both packages.
"""
from .structure import Graph
from .generators import (erdos_renyi, barabasi_albert,
                         powerlaw_configuration, rmat, clustered_blocks)
from .datasets import load_dataset, DATASETS

__all__ = ["Graph", "erdos_renyi", "barabasi_albert",
           "powerlaw_configuration", "rmat", "clustered_blocks",
           "load_dataset", "DATASETS"]
