"""GraphSAGE [arXiv:1706.02216] — mean agg, fanout (25, 10), reddit-scale."""
from repro_torch.models.gnn.sage import SageConfig


def config(reduced: bool = False) -> SageConfig:
    if reduced:
        return SageConfig(name="graphsage-reduced", n_layers=2, d_hidden=16,
                          d_feat=8, n_classes=3, sample_sizes=(4, 3))
    return SageConfig(name="graphsage-reddit", n_layers=2, d_hidden=128,
                      aggregator="mean", sample_sizes=(25, 10))
