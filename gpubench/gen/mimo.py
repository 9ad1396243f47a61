"""MiMo-V2-Flash's weights and the sessions of a decode cell, drawn from the
seed on the device.

The model's shape is the configuration's own keys (its published
``config.json`` keys and ``cut``), read from ``configs/<config>.json``
beside this generator. The weights are the published tensors, each group
(``attn.full``, ``attn.window``, ``mlp.dense``, ``mlp.moe``) a stack of its
layers' tensors in layer order, matrices ``[d_out, d_in]``: N(0, 1/d_in)
in the storage dtype (bf16), the embedding N(0, 1), norms 1, a window
head's sink N(0, ``sink_scale``²) and the selection bias N(0,
``bias_scale``²) in float32. Each session's history length is log-uniform
over [``history_min``, ``history_max``], its tokens uniform over the
vocabulary; each session's ``turn_tokens`` forced tokens (the inputs of a
turn's decode steps, at positions len … len + turn − 1) are drawn beside
them; the kept sessions are the longest and one drawn from the seed. Every
draw comes from one ``torch.Generator`` on ``device`` in a fixed order.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

__all__ = ["generate", "spec_of", "group_shapes"]

HERE = Path(__file__).resolve().parents[1]


def spec_of(cfg: dict) -> dict:
    """The published config's keys as the model reads them: the router's
    outputs for ``n_routed_experts``, and the kept ``layers``."""
    return dict(cfg, n_routed_experts=cfg["cut"]["router_outputs"],
                layers=list(cfg["cut"]["layers_held"]))


def group_shapes(cfg: dict) -> dict:
    """{group: {name: (shape, scale or None for ones, float32?)}} and the
    top-level tensors under the key ``""``."""
    spec = spec_of(cfg)
    d, h = spec["hidden_size"], spec["num_attention_heads"]
    dk, dv, v = spec["head_dim"], spec["v_head_dim"], spec["vocab_size"]
    layers = spec["layers"]
    pattern, routed = spec["hybrid_layer_pattern"], spec["moe_layer_freq"]
    out = {"": dict(embed_tokens=((v, d), 1.0, False),
                    lm_head=((v, d), d ** -0.5, False),
                    norm=((d,), None, False))}
    for kind, flag in (("full", 0), ("window", 1)):
        n = sum(1 for i in layers if pattern[i] == flag)
        kv = spec["swa_num_key_value_heads" if flag else
                  "num_key_value_heads"]
        sink = spec["add_swa_attention_sink_bias" if flag else
                    "add_full_attention_sink_bias"]
        if not n:
            continue
        g = dict(q_proj=((n, h * dk, d), d ** -0.5, False),
                 k_proj=((n, kv * dk, d), d ** -0.5, False),
                 v_proj=((n, kv * dv, d), d ** -0.5, False),
                 o_proj=((n, d, h * dv), (h * dv) ** -0.5, False),
                 input_layernorm=((n, d), None, False))
        if sink:
            g["attention_sink_bias"] = ((n, h), "sink", True)
        out[f"attn.{kind}"] = g
    n = sum(1 for i in layers if not routed[i])
    f = spec["intermediate_size"]
    if n:
        out["mlp.dense"] = dict(
            gate_proj=((n, f, d), d ** -0.5, False),
            up_proj=((n, f, d), d ** -0.5, False),
            down_proj=((n, d, f), f ** -0.5, False),
            post_attention_layernorm=((n, d), None, False))
    n = sum(1 for i in layers if routed[i])
    e, fe = cfg["n_routed_experts"], spec["moe_intermediate_size"]
    if n:
        out["mlp.moe"] = dict(
            gate=((n, spec["n_routed_experts"], d), d ** -0.5, False),
            e_score_correction_bias=((n, spec["n_routed_experts"]), "bias",
                                     True),
            gate_proj=((n, e, fe, d), d ** -0.5, False),
            up_proj=((n, e, fe, d), d ** -0.5, False),
            down_proj=((n, e, d, fe), fe ** -0.5, False),
            post_attention_layernorm=((n, d), None, False))
    return out


def generate(params: dict, seed: int, device: torch.device) -> dict:
    """``weights`` (published groups), ``spec`` (:func:`spec_of`),
    ``held`` (first expert, count), ``lengths`` (ints), ``histories``
    (one i64 tensor, the sessions one after another), ``offsets``,
    ``forced`` i64[sessions, turn], ``kept`` (two session indices),
    ``turn`` and ``capacity`` (the positions a session may reach: the
    longest history the configuration draws, and a turn)."""
    cfg = json.loads((HERE / "configs" /
                      f"{params['config']}.json").read_text())
    storage = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    scales = dict(sink=float(params["sink_scale"]),
                  bias=float(params["bias_scale"]))
    weights: dict = {}
    for group, tensors in group_shapes(cfg).items():
        for name, (shape, scale, f32) in tensors.items():
            dtype = torch.float32 if f32 else storage
            if scale is None:
                x = torch.ones(shape, dtype=dtype, device=device)
            else:
                x = torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=device)
                x = x.mul_(scales.get(scale, scale)).to(dtype)
            (weights.setdefault(group, {}) if group else weights)[name] = x
    n = int(params["sessions"])
    lo, hi = math.log(params["history_min"]), math.log(params["history_max"])
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    lengths = [int(x) for x in torch.exp(lo + (hi - lo) * u).floor().tolist()]
    vocab = cfg["vocab_size"]
    histories = torch.randint(0, vocab, (sum(lengths),), generator=gen,
                              device=device)
    turn = int(params["turn_tokens"])
    forced = torch.randint(0, vocab, (n, turn), generator=gen, device=device)
    longest = max(range(n), key=lambda i: (lengths[i], -i))
    other = int(torch.randint(0, n - 1, (1,), generator=gen,
                              device=device))
    other += other >= longest
    offsets = [0]
    for length in lengths:
        offsets.append(offsets[-1] + length)
    return dict(weights=weights, spec=spec_of(cfg),
                held=(cfg["cut"]["first_expert"], cfg["n_routed_experts"]),
                lengths=lengths, histories=histories, offsets=offsets,
                forced=forced, kept=[longest, other], turn=turn,
                capacity=int(params["history_max"]) + turn)
