"""EquiformerV2 [arXiv:2306.12059] — eSCN SO(2) conv, l_max=6, m_max=2."""
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config


def config(reduced: bool = False) -> EquiformerV2Config:
    if reduced:
        return EquiformerV2Config(name="equiformer-v2-reduced", n_layers=2,
                                  d_hidden=16, l_max=2, m_max=1, n_heads=4,
                                  n_rbf=4, d_feat=8)
    return EquiformerV2Config(name="equiformer-v2", n_layers=12,
                              d_hidden=128, l_max=6, m_max=2, n_heads=8,
                              n_rbf=8, cutoff=5.0)
