"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, SWA W=4096.
"""
import torch

from repro_torch.models.transformer import LMConfig, MoECfg


def config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="mixtral-8x22b-reduced", n_layers=2, d_model=64,
                        n_heads=8, n_kv_heads=2, d_ff=128, vocab=256,
                        moe=MoECfg(4, 2), sliding_window=64,
                        dtype=torch.float32, param_dtype=torch.float32)
    return LMConfig(name="mixtral-8x22b", n_layers=56, d_model=6144,
                    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
                    moe=MoECfg(8, 2), sliding_window=4096,
                    optimizer="adafactor", accum_steps=8)
