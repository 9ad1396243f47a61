"""LM family of the port: TinyLlama, Yi, Nemotron and Mixtral (dense and
MoE decoders, prefill and decode caches)."""
from .model import (MoECfg, LMConfig, init_params, forward, loss_fn,
                    make_train_step, make_prefill, make_decode_step,
                    init_cache, count_params, active_params)
from .attention import attention

__all__ = ["MoECfg", "LMConfig", "init_params", "forward", "loss_fn",
           "make_train_step", "make_prefill", "make_decode_step",
           "init_cache", "count_params", "active_params", "attention"]
