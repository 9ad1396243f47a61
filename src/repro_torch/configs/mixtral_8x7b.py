"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, SWA W=4096.
"""
import torch

from repro_torch.models.transformer import LMConfig, MoECfg


def config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="mixtral-8x7b-reduced", n_layers=2, d_model=64,
                        n_heads=8, n_kv_heads=2, d_ff=128, vocab=256,
                        moe=MoECfg(4, 2), sliding_window=64,
                        dtype=torch.float32, param_dtype=torch.float32)
    return LMConfig(name="mixtral-8x7b", n_layers=32, d_model=4096,
                    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
                    moe=MoECfg(8, 2), sliding_window=4096, accum_steps=4)
