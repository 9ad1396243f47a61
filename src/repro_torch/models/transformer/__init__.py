"""LM family of the port: TinyLlama, Yi, Nemotron and Mixtral (dense and
MoE decoders, prefill and decode caches), on one device or sharded over a
mesh (tensor parallelism and FSDP), and hybrid decoders (MiMo-V2-Flash:
window and full attention layers, sigmoid-routed experts of which a device
holds a share, a cache a kind; :mod:`.hybrid`), served on one device
through the same entry points."""
from .model import (MoECfg, LMConfig, init_params, forward, loss_fn,
                    loss_and_grads, make_train_step, make_prefill,
                    make_decode_step, init_cache, count_params,
                    active_params, param_specs, cache_specs, shard_params,
                    shard_batch, local_batch, param_layout,
                    shard_numel)
from .attention import attention
from .hybrid import AttnKind, HybridConfig, RoutedMoE

__all__ = ["MoECfg", "LMConfig", "init_params", "forward", "loss_fn",
           "loss_and_grads", "make_train_step", "make_prefill",
           "make_decode_step", "init_cache", "count_params", "active_params",
           "param_specs", "cache_specs", "shard_params", "shard_batch",
           "local_batch", "param_layout", "shard_numel", "attention",
           "AttnKind", "HybridConfig", "RoutedMoE"]
