"""Entry: turns of decoding for a card's sessions through the port's LM
serving path.

Set-up builds the port's config of the cut from the configuration's own
keys (``repro_torch.configs.mimo_v2_flash.from_config``), its parameter
tree over the generated published tensors (transposed views, no copy), a
cache a kind for every session (``init_cache``; full layers sized to the
longest history the configuration draws and a turn, whatever the seed's
histories) and prefills each history into its own row (``make_prefill``),
then snapshots the window rings. A
request is one turn: ``turn`` decode steps (``make_decode_step``) of every
session at once, each step's input the session's forced token, its argmax
(the served token) copied to the host; the kept sessions' float32 logits
and every routed layer's picked experts stay on the card (``complete``
fetches the kept sessions' for a kept request). The turn
ends by rewinding the cache to the set-up state (``rewind``: each
session's position, and the ring slots the turn wrote), so every request
is the same work.
"""
from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from gpubench.harness import DTYPES
from gpubench.reference.mimo import forward as reference_forward
from gpubench.reference.mimo import route_gap

__all__ = ["build", "request", "iterations", "work_bytes", "reference",
           "as_served", "rows", "numbers", "describe", "complete",
           "step_weights", "turn_bytes", "turn_flops"]


@dataclasses.dataclass
class Served:
    tokens: np.ndarray           # i64[turn, sessions], the served tokens
    logits: object               # [kept, turn, V] float32 (card or host)
    routes: object               # picked experts: a step's list of
    #                              i64[sessions, top_k] a routed layer
    #                              (card), or i64[kept, turn, layers,
    #                              top_k] (host)


@dataclasses.dataclass
class System:
    cfg: object
    params: dict
    cache: dict
    snap: dict
    decode: object
    forced: torch.Tensor         # i64[sessions, turn]
    kept: torch.Tensor           # i64[2]
    host: torch.Tensor           # i64[turn, sessions], pinned on a card
    turn: int


def model_config(cfg: dict):
    from repro_torch.configs.mimo_v2_flash import from_config
    cut = cfg["cut"]
    return from_config(dict(cfg, n_routed_experts=cut["router_outputs"]),
                       layers=cut["layers_held"],
                       first_held=cut["first_expert"],
                       n_held=cfg["n_routed_experts"], name=cfg["name"],
                       dtype=DTYPES[cfg["dtype"]])


def build(cfg: dict, traffic: dict, inputs: dict, device: torch.device):
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import hybrid
    mcfg = model_config(cfg)
    params = hybrid.from_published(inputs["weights"], mcfg)
    lengths, turn = inputs["lengths"], inputs["turn"]
    # sized to the configuration's longest history, not this seed's: every
    # seed's decode reads the same padded slots
    cache = tf.init_cache(mcfg, len(lengths), inputs["capacity"],
                          device=device)
    prefill = tf.make_prefill(mcfg)
    hist, off = inputs["histories"], inputs["offsets"]
    for r, length in enumerate(lengths):
        prefill(params, hist[off[r]:off[r] + length][None], cache, [r])
    host = torch.zeros(turn, len(lengths), dtype=torch.long,
                       pin_memory=device.type == "cuda")
    return System(cfg=mcfg, params=params, cache=cache,
                  snap=hybrid.snapshot(cache, mcfg),
                  decode=tf.make_decode_step(mcfg), forced=inputs["forced"],
                  kept=torch.as_tensor(inputs["kept"], device=device),
                  host=host, turn=turn)


def describe(inputs: dict, system: System) -> str:
    from repro_torch.models.transformer import hybrid
    lengths = inputs["lengths"]
    cache = {name: hybrid.cache_bytes(entry)
             for name, entry in system.cache.items() if name != "t"}
    return (f"sessions={len(lengths)} history min/median/max="
            f"{min(lengths)}/{statistics.median(lengths)}/{max(lengths)} "
            f"turn={system.turn} layers={system.cfg.layers} "
            f"params={hybrid.count_params(system.cfg)} cache_bytes={cache} "
            f"kept={inputs['kept']}")


def request(system: System, cfg: dict, traffic: dict, draw,
            phase) -> Served:
    from repro_torch.models.transformer import hybrid
    kept, routes = [], []
    with phase("decode"):
        for step in range(system.turn):
            routes.append([])
            _, logits = system.decode(system.params, system.cache,
                                      system.forced[:, step], routes[-1])
            system.host[step].copy_(torch.argmax(logits, -1),
                                    non_blocking=True)
            kept.append(logits[system.kept])
        hybrid.rewind(system.cache, system.snap, system.turn)
        logits = torch.stack(kept, 1)
        if system.host.is_pinned():
            torch.cuda.current_stream(logits.device).synchronize()
    return Served(tokens=system.host.numpy().copy(), logits=logits,
                  routes=routes)


def complete(system: System, served: Served) -> Served:
    routes = torch.stack([torch.stack(step, 1) for step in served.routes],
                         1)                   # [sessions, turn, layers, k]
    return dataclasses.replace(
        served, logits=served.logits.double().cpu().numpy(),
        routes=routes[system.kept].cpu().numpy())


def iterations(system: System, served: Served) -> int:
    return system.turn


def step_weights(spec: dict, held: int, sessions: int) -> tuple[int, int]:
    """(bytes, model FLOPs a token) of the weights a decode step reads: every
    layer's attention and FFN weights (the held experts'), the routers,
    norms and sinks, the head, and the embedding's rows of the batch."""
    d, h = spec["hidden_size"], spec["num_attention_heads"]
    dk, dv = spec["head_dim"], spec["v_head_dim"]
    elem, f32 = 2, 4
    params = flops = 0
    for i in spec["layers"]:
        window = spec["hybrid_layer_pattern"][i] == 1
        kv = spec["swa_num_key_value_heads" if window else
                  "num_key_value_heads"]
        attn = d * h * dk + d * kv * (dk + dv) + h * dv * d
        params += attn + 2 * d
        flops += 2 * attn
        if spec["add_swa_attention_sink_bias" if window else
                "add_full_attention_sink_bias"]:
            params += h * f32 // elem
        if spec["moe_layer_freq"][i]:
            e, fe = spec["n_routed_experts"], spec["moe_intermediate_size"]
            params += held * 3 * d * fe + d * e + e * f32 // elem
            flops += 2 * d * e + 2 * 3 * d * fe * spec[
                "num_experts_per_tok"] * held / e
        else:
            params += 3 * d * spec["intermediate_size"]
            flops += 2 * 3 * d * spec["intermediate_size"]
    v = spec["vocab_size"]
    params += d * v + d + sessions * d
    flops += 2 * d * v
    return params * elem, flops


def turn_bytes(spec: dict, held: int, lengths, turn: int) -> int:
    """Least bytes of a turn: ``turn`` × the weights a step reads, each
    session's full-layer keys and values at its true context, the window
    rings (their slots in use), and the new keys and values written."""
    dk, dv, elem = spec["head_dim"], spec["v_head_dim"], 2
    weights, _ = step_weights(spec, held, len(lengths))
    total = turn * weights
    for i in spec["layers"]:
        window = spec["hybrid_layer_pattern"][i] == 1
        kv = spec["swa_num_key_value_heads" if window else
                  "num_key_value_heads"]
        per_slot = kv * (dk + dv) * elem
        for length in lengths:
            for j in range(turn):
                ctx = length + j + 1
                if window:
                    ctx = min(ctx, spec["sliding_window"])
                total += ctx * per_slot + per_slot     # read, new one written
    return total


def turn_flops(spec: dict, held: int, lengths, turn: int) -> float:
    """Model FLOPs of a turn: projections, the dense FFN, the routers, the
    head, the held experts' expected evaluations (top-k × held / experts a
    token) and attention over each context (2·H·(dk + dv) a key)."""
    h, dk, dv = (spec["num_attention_heads"], spec["head_dim"],
                 spec["v_head_dim"])
    _, per_token = step_weights(spec, held, len(lengths))
    total = per_token * len(lengths) * turn
    for i in spec["layers"]:
        window = spec["hybrid_layer_pattern"][i] == 1
        for length in lengths:
            for j in range(turn):
                ctx = length + j + 1
                if window:
                    ctx = min(ctx, spec["sliding_window"])
                total += 2 * h * (dk + dv) * ctx
    return float(total)


def work_bytes(cfg: dict, inputs: dict) -> dict:
    """A request's least bytes (``request``) and model FLOPs
    (``request_flops``), from the configuration and the histories."""
    spec, held = inputs["spec"], inputs["held"][1]
    return dict(request=turn_bytes(spec, held, inputs["lengths"],
                                   inputs["turn"]),
                request_flops=turn_flops(spec, held, inputs["lengths"],
                                         inputs["turn"]))


def reference(cfg: dict, inputs: dict, device: torch.device,
              precision: dict) -> list[dict]:
    """A kept session's ``logits`` f64[turn, V], ``pick`` i64[turn, layers,
    top_k] (the experts each routed layer picked), ``select`` f64[turn,
    layers, E] (its selection scores σ + b) and ``held`` (first, count):
    the plain reference's forward over its history and forced tokens at
    ``precision`` (``storage``; ``weights`` rounds the weights through a
    narrow float first)."""
    out = []
    fmt = precision.get("weights")
    for r in inputs["kept"]:
        off, length = inputs["offsets"][r], inputs["lengths"][r]
        seq = torch.cat([inputs["histories"][off:off + length],
                         inputs["forced"][r]]).to(device)
        routes: list = []
        logits = reference_forward(
            inputs["weights"], seq, inputs["spec"], inputs["held"],
            dtype=precision["storage"], last=inputs["turn"],
            round_to=None if fmt is None else getattr(torch, fmt),
            routes=routes)
        out.append(dict(
            logits=logits.double().cpu().numpy(),
            pick=torch.stack([p for p, _ in routes], 1).cpu().numpy(),
            select=torch.stack([s for _, s in routes], 1)
            .double().cpu().numpy(),
            held=tuple(inputs["held"])))
    return out


def as_served(ref: list, traffic: dict, draw) -> Served:
    logits = np.stack([r["logits"] for r in ref])
    return Served(tokens=np.argmax(logits, -1).T, logits=logits,
                  routes=np.stack([r["pick"] for r in ref]))


def rows(served: Served, ref: list) -> dict | None:
    """Each kept row's (a session's step) numbers, each [kept, turn]:
    ``rel``, the relative L2 error of its logits; ``linf``, max |Δ| over
    max |ref|; ``gap``, its token's routing gap at the first routed layer
    whose picks depart from the reference's (the
    :func:`~gpubench.reference.mimo.route_gap` of the program's picks in
    the reference's selection scores; the largest, ≤ 0, where none
    departs: after a departure the token's state is another one, so later
    layers' gaps say nothing of rounding); ``held``, whether a departure
    swapped a held expert in or out. None for an answer of the wrong
    shape or not finite."""
    want = np.stack([r["logits"] for r in ref])
    select = np.stack([r["select"] for r in ref])
    expect = np.stack([r["pick"] for r in ref])
    got = np.asarray(served.logits, np.float64)
    pick = np.asarray(served.routes)
    if got.shape != want.shape or not np.all(np.isfinite(got)) \
            or pick.shape != expect.shape \
            or pick.min() < 0 or pick.max() >= select.shape[-1]:
        return None
    diff = got - want
    gaps = route_gap(torch.from_numpy(select),
                     torch.from_numpy(pick)).numpy()     # [kept, turn, L]
    apart = gaps > 0
    first = np.take_along_axis(gaps, apart.argmax(-1)[..., None], -1)[..., 0]
    onehot = np.zeros(select.shape, bool)
    np.put_along_axis(onehot, pick, True, -1)
    theirs = np.zeros(select.shape, bool)
    np.put_along_axis(theirs, expect, True, -1)
    lo, count = ref[0]["held"]
    swapped = (onehot != theirs)[..., lo:lo + count].any(-1).any(-1)
    return dict(
        rel=np.linalg.norm(diff, axis=-1) / np.linalg.norm(want, axis=-1),
        linf=np.abs(diff).max(-1) / np.abs(want).max(-1),
        gap=np.where(apart.any(-1), first, gaps.max(-1)), held=swapped)


def numbers(served: Served, ref: list, traffic: dict, draw) -> dict:
    """Over the kept rows (:func:`rows`): ``logits_rel`` and
    ``logits_linf_rel``, the worst row but those whose token a routed layer
    sent to another held expert than the reference did; ``route_gap``, the
    largest routing gap of any row's token. A departure is a near tie of
    the reference's own selection scores that bf16 broke the other way
    (its gap bounded by ``route_gap``'s limit); where it swaps a held
    expert, that expert's part moves the row's logits far more than
    rounding does (elsewhere it moves only the held gates' sum), so that
    row alone is left out of the logits' worst. Every other row is held,
    so a fault that reaches one session or one step reads as it would in
    every row. ``inf`` for an answer of the wrong shape or not finite, or
    with no row left to hold."""
    got = rows(served, ref)
    if got is None or np.all(got["held"]):
        return dict(logits_rel=float("inf"), logits_linf_rel=float("inf"),
                    route_gap=float("inf"))
    kept = ~got["held"]
    return dict(logits_rel=float(got["rel"][kept].max()),
                logits_linf_rel=float(got["linf"][kept].max()),
                route_gap=float(max(got["gap"].max(), 0.0)))
