"""MiMo-V2-Flash — a 309B-A15B hybrid MoE decoder [hf
XiaomiMiMo/MiMo-V2-Flash, config.json].

48L d_model=4096 64H, queries and keys 192 wide, values 128, RoPE on the
first 64 dims (partial_rotary_factor 0.334). The published
``hybrid_layer_pattern``: 39 sliding-window layers (window 128, a sink
logit a head, 8 KV heads, θ 1e4) beside 9 full GQA layers (4 KV heads, θ
5e6); attention_value_scale 0.707. Layer 0 has a dense SwiGLU FFN (16,384),
the other 47 a routed one: 256 experts 2,048 wide, top-8 of sigmoid scores
plus a selection bias (``noaux_tc``), the 8 weights normalised, no shared
expert. Vocabulary 152,576, untied head, RMSNorm ε 1e-5. The 3 MTP layers
are not modelled: decoding here is not speculative.

:func:`from_config` reads a published ``config.json``'s keys; ``layers``
keeps published layers by index (a cut in depth; the dense layers stay
first), ``first_held`` / ``n_held`` the device's contiguous share of the
experts (expert parallelism); the router keeps its outputs and top-k.
"""
import torch

from repro_torch.models.transformer import AttnKind, HybridConfig, RoutedMoE

#: the published config.json's keys that set the model's shape
PUBLISHED = dict(
    hidden_size=4096, num_attention_heads=64, head_dim=192, v_head_dim=128,
    partial_rotary_factor=0.334, num_key_value_heads=4,
    swa_num_key_value_heads=8, sliding_window=128, rope_theta=5000000,
    swa_rope_theta=10000, add_swa_attention_sink_bias=True,
    add_full_attention_sink_bias=False, attention_value_scale=0.707,
    intermediate_size=16384, moe_intermediate_size=2048,
    n_routed_experts=256, num_experts_per_tok=8, vocab_size=152576,
    layernorm_epsilon=1e-05,
    hybrid_layer_pattern=[0, 1, 1, 1, 1, 0] + [1, 1, 1, 1, 1, 0] * 7,
    moe_layer_freq=[0] + [1] * 47)

#: the CPU variant: the pattern of the benchmark's cut (a full dense layer,
#: five window layers and a full one, all routed) at small widths, K and V
#: of different widths, a window shorter than the tests' prompts
REDUCED = dict(
    PUBLISHED, hidden_size=64, num_attention_heads=8, head_dim=24,
    v_head_dim=16, num_key_value_heads=2, swa_num_key_value_heads=4,
    sliding_window=8, intermediate_size=96, moe_intermediate_size=32,
    n_routed_experts=16, num_experts_per_tok=4, vocab_size=256,
    hybrid_layer_pattern=[0, 1, 1, 1, 1, 1, 0],
    moe_layer_freq=[0, 1, 1, 1, 1, 1, 1])


def from_config(spec: dict, *, layers=None, first_held: int = 0,
                n_held: int | None = None, name: str = "mimo-v2-flash",
                dtype: torch.dtype = torch.bfloat16) -> HybridConfig:
    """The port's config of a published ``config.json`` (``spec``)."""
    pattern, moe = spec["hybrid_layer_pattern"], spec["moe_layer_freq"]
    keep = tuple(range(len(pattern))) if layers is None else tuple(layers)
    dense = tuple(i for i in keep if not moe[i])
    if keep[:len(dense)] != dense:
        raise ValueError(f"layers {keep}: the dense layers come first")
    dk = spec["head_dim"]
    kinds = (("full", AttnKind(spec["num_key_value_heads"], None,
                               float(spec["rope_theta"]),
                               spec["add_full_attention_sink_bias"])),
             ("window", AttnKind(spec["swa_num_key_value_heads"],
                                 spec["sliding_window"],
                                 float(spec["swa_rope_theta"]),
                                 spec["add_swa_attention_sink_bias"])))
    return HybridConfig(
        name=name, d_model=spec["hidden_size"],
        n_heads=spec["num_attention_heads"], qk_head_dim=dk,
        v_head_dim=spec["v_head_dim"],
        rotary_dim=int(spec["partial_rotary_factor"] * dk),
        vocab=spec["vocab_size"],
        layers=tuple("window" if pattern[i] else "full" for i in keep),
        kinds=kinds, n_dense_layers=len(dense),
        d_ff=spec["intermediate_size"],
        moe=RoutedMoE(spec["n_routed_experts"], spec["num_experts_per_tok"],
                      spec["moe_intermediate_size"], first_held, n_held),
        value_scale=spec["attention_value_scale"],
        norm_eps=spec["layernorm_epsilon"], dtype=dtype, param_dtype=dtype)


def config(reduced: bool = False, **kw) -> HybridConfig:
    if reduced:
        return from_config(REDUCED, name="mimo-v2-flash-reduced",
                           dtype=torch.float32, **kw)
    return from_config(PUBLISHED, **kw)
