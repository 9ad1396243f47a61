"""Yi-9B — llama-arch GQA [arXiv:2403.04652; hf].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, SwiGLU, RoPE.
"""
import torch

from repro_torch.models.transformer import LMConfig


def config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="yi-9b-reduced", n_layers=3, d_model=96,
                        n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
                        dtype=torch.float32, param_dtype=torch.float32)
    return LMConfig(name="yi-9b", n_layers=48, d_model=4096, n_heads=32,
                    n_kv_heads=4, d_ff=11008, vocab=64000, rope_theta=1e4,
                    accum_steps=4)
