"""MIND [arXiv:1904.08030] — multi-interest capsule retrieval.

embed_dim=64, 4 interests, 3 routing iterations; 4M-row item table
(row-sharded over "model"), 128k-row profile-tag table via EmbeddingBag.
"""
from repro_torch.models.recsys.mind import MINDConfig


def config(reduced: bool = False) -> MINDConfig:
    if reduced:
        return MINDConfig(name="mind-reduced", n_items=2048, n_profile=512,
                          embed_dim=16, hist_len=10, n_neg=32)
    return MINDConfig(name="mind", n_items=4_194_304, n_profile=131_072,
                      embed_dim=64, n_interests=4, capsule_iters=3,
                      hist_len=50, n_neg=1024)
