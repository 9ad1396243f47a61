"""A plain reference of MiMo-V2-Flash's forward pass, for comparisons.

Plain ``torch``, one sequence, no cache and no batching, at one dtype
(float32 or wider; TF32 off). It imports nothing of the program and reads
the model from the published config's own keys (``spec``: the keys of
``config.json``, and ``layers``, the published layer indices kept) and
the published tensors (``weights``; names below). Per layer, with h =
RMSNorm(x) before each sub-layer and a residual after it:

* attention of the layer's type (``hybrid_layer_pattern``: 0 full, 1
  sliding window): q = h W_q (64 heads × 192), k = h W_k (n_kv × 192), v =
  h W_v (n_kv × 128), n_kv 4 (full) or 8 (window); RoPE (rotate-half) on
  the first ``partial_rotary_factor`` · 192 dims of q and k, θ
  ``rope_theta`` (full) or ``swa_rope_theta`` (window); z = q·k / √192;
  window layers read keys 0 ≤ i − j < ``sliding_window``, full layers
  are causal; where the type has a sink (``add_swa_attention_sink_bias``,
  ``add_full_attention_sink_bias``), each head's s_h joins the
  denominator (p_j = e^{z_j} / (e^{s_h} + Σ e^z)); out =
  ``attention_value_scale`` · Σ p_j v_j, then W_o;
* FFN: dense SwiGLU (``moe_layer_freq`` 0) or routed: σ = sigmoid(h W_r)
  over the router's outputs, T = the top ``num_experts_per_tok`` of σ +
  b, g_i = σ_i / Σ_T σ, y = Σ_{i ∈ T ∩ held} g_i · SwiGLU_i(h): only the
  held experts (``held`` = (first, count)), whose part of the result is
  what a device of an expert-parallel deployment computes;
* the final RMSNorm and the untied head.

Attention runs in blocks of queries against the keys they may read, so a
32,784-token forward fits on one card.

``weights``: ``embed_tokens`` [V, d], ``lm_head`` [V, d], ``norm`` [d],
and a dict a group, each tensor the stack of its layers' published tensors
in layer order (matrices ``[d_out, d_in]``): ``attn.full`` /
``attn.window`` (``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``,
``input_layernorm``, and ``attention_sink_bias`` for window layers),
``mlp.dense`` (``gate_proj``, ``up_proj``, ``down_proj``,
``post_attention_layernorm``) and ``mlp.moe`` (``gate``,
``e_score_correction_bias``, ``gate_proj``, ``up_proj``, ``down_proj``
over the held experts, ``post_attention_layernorm``).
"""
from __future__ import annotations

import torch

__all__ = ["forward", "routed_ffn", "round_through", "route_gap"]

#: elements of one block of attention scores (a 1 GiB float64 block)
SCORE_BLOCK = 1 << 27


def round_through(w: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """``w`` rounded through the narrow float ``fmt`` with one scale a
    published tensor (its largest magnitude at ``fmt``'s largest finite),
    back in ``w``'s dtype: the weights of a control."""
    red = (-1,) if w.dim() == 1 else (-2, -1)
    amax = w.abs().amax(dim=red, keepdim=True).clamp(min=1e-30)
    scale = amax / torch.finfo(fmt).max
    return (w / scale).to(fmt).to(w.dtype) * scale


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x, pos, theta, rot):
    half = rot // 2
    inv = theta ** (-torch.arange(0, rot, 2, dtype=x.dtype,
                                  device=x.device) / rot)
    ang = pos[:, None].to(x.dtype) * inv[None]             # [S, half]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]],
                     -1)


def _attention(q, k, v, window, sink, scale):
    """q [S, H, dk], k [S, n_kv, dk], v [S, n_kv, dv] → [S, H, dv]."""
    s, h, dk = q.shape
    kv = k.shape[1]
    g = h // kv
    qg = q.reshape(s, kv, g, dk)
    out = []
    step = max(1, SCORE_BLOCK // (h * s))
    for a in range(0, s, step):
        b = min(s, a + step)
        lo = 0 if window is None else max(0, a - window + 1)
        z = torch.einsum("qcgd,kcd->cgqk", qg[a:b], k[lo:b]) / dk ** 0.5
        i = torch.arange(a, b, device=q.device)[:, None]
        j = torch.arange(lo, b, device=q.device)[None]
        ok = j <= i
        if window is not None:
            ok &= (i - j) < window
        z = z.masked_fill(~ok, float("-inf"))
        if sink is not None:
            col = sink.reshape(kv, g, 1, 1).expand(kv, g, b - a, 1)
            p = torch.softmax(torch.cat([z, col], -1), -1)[..., :-1]
        else:
            p = torch.softmax(z, -1)
        out.append(torch.einsum("cgqk,kcd->qcgd", p, v[lo:b]) * scale)
    return torch.cat(out, 0).reshape(s, h, -1)


def _swiglu(x, gate, up, down):
    return (torch.nn.functional.silu(x @ gate.T) * (x @ up.T)) @ down.T


def route_gap(select: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """How far the experts ``pick`` i64[..., k] are from being a top k of
    the selection scores ``select`` [..., E]: half of (the largest score
    outside ``pick`` − the least inside), the least change of the scores
    in max norm that makes ``pick`` a top k; ≤ 0 where it is one."""
    inside = torch.zeros(select.shape, dtype=torch.bool,
                         device=select.device).scatter_(-1, pick, True)
    hi = select.masked_fill(inside, float("-inf")).amax(-1)
    lo = select.masked_fill(~inside, float("inf")).amin(-1)
    return (hi - lo) / 2


def routed_ffn(h, router, bias, top: int, first: int, experts,
               routes: list | None = None) -> torch.Tensor:
    """The held experts' part of a routed FFN: h [S, d], router [E, d],
    bias [E], ``experts`` the (gate, up, down) of experts ``first``,
    ``first`` + 1, … ``routes``: a list that gets (the picked experts
    i64[S, top], the selection scores σ + b [S, E])."""
    sig = torch.sigmoid(h @ router.T)
    _, pick = torch.topk(sig + bias, top)
    if routes is not None:
        routes.append((pick, sig + bias))
    gates = sig.gather(1, pick)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e, (gate, up, down) in enumerate(experts, start=first):
        hit = pick == e                                      # [S, top]
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel():
            g = (gates * hit).sum(-1)[rows, None]
            y[rows] += g * _swiglu(h[rows], gate, up, down)
    return y


def forward(weights: dict, tokens: torch.Tensor, spec: dict, held, *,
            dtype: torch.dtype = torch.float32, last: int | None = None,
            round_to: torch.dtype | None = None,
            routes: list | None = None) -> torch.Tensor:
    """Logits [n, V] (``dtype``) of the last ``last`` positions (all when
    None) of the sequence ``tokens`` i64[S]. ``held``: (first expert,
    count). ``round_to``: every weight rounded through that narrow float
    first (:func:`round_through`). ``routes``: a list that gets, for each
    routed layer in order, (the picked experts i64[n, top], the selection
    scores [n, E]) of those positions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def w(t):
        t = t.to(dtype)
        return t if round_to is None else round_through(t, round_to)

    eps = spec["layernorm_epsilon"]
    hq, dk = spec["num_attention_heads"], spec["head_dim"]
    rot = int(spec["partial_rotary_factor"] * dk)
    top, first, count = spec["num_experts_per_tok"], held[0], held[1]
    n = tokens.shape[0]
    pos = torch.arange(n, device=tokens.device)
    x = w(weights["embed_tokens"])[tokens] if round_to is not None else \
        weights["embed_tokens"][tokens].to(dtype)
    seen = {"attn.full": 0, "attn.window": 0, "mlp.dense": 0, "mlp.moe": 0}
    for layer in spec["layers"]:
        window = spec["hybrid_layer_pattern"][layer] == 1
        group = "attn.window" if window else "attn.full"
        a, seen[group] = seen[group], seen[group] + 1
        g = weights[group]
        kv = spec["swa_num_key_value_heads" if window else
                  "num_key_value_heads"]
        theta = spec["swa_rope_theta" if window else "rope_theta"]
        hh = _rms(x, w(g["input_layernorm"][a]), eps)
        q = (hh @ w(g["q_proj"][a]).T).reshape(n, hq, dk)
        k = (hh @ w(g["k_proj"][a]).T).reshape(n, kv, dk)
        v = (hh @ w(g["v_proj"][a]).T).reshape(n, kv, -1)
        q, k = _rope(q, pos, theta, rot), _rope(k, pos, theta, rot)
        sink = spec["add_swa_attention_sink_bias" if window else
                    "add_full_attention_sink_bias"]
        o = _attention(q, k, v, spec["sliding_window"] if window else None,
                       w(g["attention_sink_bias"][a]) if sink else None,
                       spec["attention_value_scale"])
        x = x + o.reshape(n, -1) @ w(g["o_proj"][a]).T
        del q, k, v, o, hh
        routed = spec["moe_layer_freq"][layer] == 1
        group = "mlp.moe" if routed else "mlp.dense"
        j, seen[group] = seen[group], seen[group] + 1
        m = weights[group]
        hh = _rms(x, w(m["post_attention_layernorm"][j]), eps)
        if not routed:
            x = x + _swiglu(hh, w(m["gate_proj"][j]), w(m["up_proj"][j]),
                            w(m["down_proj"][j]))
            continue
        seen_routes: list | None = None if routes is None else []
        x = x + routed_ffn(
            hh, w(m["gate"][j]), w(m["e_score_correction_bias"][j]), top,
            first, [(w(m["gate_proj"][j, e]), w(m["up_proj"][j, e]),
                     w(m["down_proj"][j, e])) for e in range(count)],
            seen_routes)
        if routes is not None:
            routes.append(tuple(r if last is None else r[-last:]
                                for r in seen_routes[0]))
    x = x if last is None else x[-last:]
    x = _rms(x, w(weights["norm"]), eps)
    return x @ w(weights["lm_head"]).T
