"""TinyLlama-1.1B — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000, SwiGLU, RoPE.
The JAX config's ``fsdp=False`` has no counterpart: one card, no sharding.
"""
import torch

from repro_torch.models.transformer import LMConfig


def config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="tinyllama-1.1b-reduced", n_layers=2,
                        d_model=64, n_heads=8, n_kv_heads=2, d_ff=176,
                        vocab=256, dtype=torch.float32,
                        param_dtype=torch.float32)
    # fsdp off: 1.1B params + AdamW state fit per TP shard, and pure TP + DP
    # needs no per-step weight all-gathers (the JAX package's choice)
    return LMConfig(name="tinyllama-1.1b", n_layers=22, d_model=2048,
                    n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000,
                    rope_theta=1e4, accum_steps=4, fsdp=False)
