"""Nemotron-4-340B — GQA, squared-ReLU FFN [arXiv:2402.16819; unverified].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
Adafactor + aggressive grad accumulation: the 340B-param memory envelope.
"""
import torch

from repro_torch.models.transformer import LMConfig


def config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="nemotron-4-340b-reduced", n_layers=2,
                        d_model=96, n_heads=8, n_kv_heads=2, d_ff=384,
                        vocab=512, act="sq_relu", dtype=torch.float32,
                        param_dtype=torch.float32)
    return LMConfig(name="nemotron-4-340b", n_layers=96, d_model=18432,
                    n_heads=96, n_kv_heads=8, d_ff=73728, vocab=256000,
                    d_head=192, act="sq_relu", optimizer="adafactor",
                    accum_steps=16, q_block=256, k_block=512)
