"""Dataset registry: seeded synthetic stand-ins for the paper's Konect graphs.

Table II of the paper:

| name     | type     | nodes   | edges   |
|----------|----------|---------|---------|
| dblp     | citation | 12 591  | 49 743  |
| twitter  | social   | 465 017 | 834 797 |
| facebook | social   | 63 731  | 817 035 |
| hepph    | citation | 34 546  | 421 578 |

The container is offline, so we rebuild graphs with matched (N, M) and
heavy-tailed degree distributions (erased configuration model, oversampled so
the post-dedup edge count lands within ~1% of the target). Every graph is
fully determined by its seed.
"""
from __future__ import annotations

from .generators import powerlaw_configuration, rmat, erdos_renyi
from .structure import Graph

__all__ = ["load_dataset", "DATASETS"]

# name -> (n, m, exponent_out, exponent_in, seed)
DATASETS: dict[str, tuple[int, int, float, float, int]] = {
    "dblp": (12_591, 49_743, 2.6, 2.4, 1),
    "facebook": (63_731, 817_035, 2.2, 2.1, 2),
    "twitter": (465_017, 834_797, 2.5, 2.2, 3),
    "hepph": (34_546, 421_578, 2.2, 2.1, 4),
}


def load_dataset(name: str, *, seed: int | None = None) -> Graph:
    """Instantiate a synthetic stand-in with the paper's (N, M)."""
    key = name.lower()
    if key.startswith("rmat"):
        scale = int(key.removeprefix("rmat"))
        return rmat(scale, seed=seed or 7, name=key)
    if key == "tiny":                       # quick smoke graph
        return erdos_renyi(64, 256, seed=seed or 11, name="tiny")
    if key not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    n, m, eo, ei, s = DATASETS[key]
    # oversample: erased configuration model loses ~2-6% to dedup
    g = powerlaw_configuration(n, int(m * 1.08), exponent_out=eo,
                               exponent_in=ei, seed=seed if seed is not None
                               else s, name=key)
    if g.m > m:  # trim deterministically to the exact published edge count
        import numpy as np
        rng = np.random.default_rng(0xC0FFEE ^ (seed if seed is not None else s))
        idx = rng.permutation(g.m)[:m]
        g = Graph(n, g.src[idx], g.dst[idx], name=key)
    return g
