"""NequIP [arXiv:2101.03164] — E(3) tensor products, l_max=2, 8 RBF, rc=5."""
from repro_torch.models.gnn.nequip import NequIPConfig


def config(reduced: bool = False) -> NequIPConfig:
    if reduced:
        return NequIPConfig(name="nequip-reduced", n_layers=2, d_hidden=8,
                            l_max=1, n_rbf=4, d_feat=8)
    return NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                        n_rbf=8, cutoff=5.0)
