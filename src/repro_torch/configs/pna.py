"""PNA [arXiv:2004.05718] — 4 aggregators × 3 scalers, d_hidden=75."""
from repro_torch.models.gnn.pna import PNAConfig


def config(reduced: bool = False) -> PNAConfig:
    if reduced:
        return PNAConfig(name="pna-reduced", n_layers=2, d_hidden=16,
                         d_feat=8, n_classes=3)
    return PNAConfig(name="pna", n_layers=4, d_hidden=75)
