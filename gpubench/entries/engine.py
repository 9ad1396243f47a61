"""Entry: one solo ψ engine over one graph.

Set-up hands the generated graph and rates to
``repro_torch.core.make_engine(backend, graph=, activity=, dtype=, device=,
**engine)``, ``engine`` being the configuration's engine options. A request is
a cold solve ``engine.run(tol=)`` (s₀ = c) with its ψ epilogue, then the
ranked read ``RankingCache(result.psi).top_k(k)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench.compare import rel_max, top_rel
from gpubench.harness import DTYPES
from gpubench.reference.psi import psi_reference
from gpubench.roofline import step_bytes


@dataclasses.dataclass
class Served:
    psi: np.ndarray          # every user's ψ as the read holds it
    ids: np.ndarray          # the top-k read
    vals: np.ndarray
    iterations: int


def host_graph(inputs: dict):
    """The generated graph and rates as the program takes them."""
    from repro_torch.core import Activity
    from repro_torch.graphs.structure import Graph
    graph = Graph(inputs["n"], inputs["src"].cpu().numpy(),
                  inputs["dst"].cpu().numpy(), name="bench")
    act = Activity(inputs["lam"].cpu().numpy(), inputs["mu"].cpu().numpy())
    return graph, act


def build(cfg: dict, traffic: dict, inputs: dict, device: torch.device):
    from repro_torch.core import make_engine
    graph, act = host_graph(inputs)
    return make_engine(cfg["backend"], graph=graph, activity=act,
                       dtype=DTYPES[cfg["dtype"]], device=device,
                       **cfg["engine"])


def describe(inputs: dict, engine) -> str:
    return (f"n={inputs['n']} arcs={int(inputs['src'].numel())} "
            f"(sampled {inputs['sampled']} edges) backend={engine.name} "
            f"regime={engine.regime} tile={engine.tile} e1={engine.e1} "
            f"e2={engine.e2} format_builds={engine.format_builds}")


def request(engine, cfg: dict, traffic: dict, draw, phase) -> Served:
    from repro_torch.core import RankingCache
    with phase("solve"):
        res = engine.run(tol=float(cfg["tol"]),
                         max_iter=int(cfg["max_iter"]))
    with phase("read"):
        cache = RankingCache(res.psi)
        ids, vals = cache.top_k(int(traffic["top_k"]))
    return Served(psi=cache.psi, ids=ids, vals=vals,
                  iterations=int(res.iterations))


def iterations(engine, served: Served) -> int:
    return served.iterations


def work_bytes(cfg: dict, inputs: dict) -> dict:
    """Least bytes of one step, and of the epilogue (the same count,
    ``roofline``)."""
    elem = torch.finfo(DTYPES[cfg["dtype"]]).bits // 8
    step = step_bytes(inputs["n"], int(inputs["src"].numel()), elem)
    return dict(step=step, epilogue=step)


def reference(cfg: dict, inputs: dict, device: torch.device,
              precision: dict) -> list[np.ndarray]:
    """[ψ f64[n]] of the plain reference at ``precision`` (its storage and
    accumulate types)."""
    n = inputs["n"]
    psi, _ = psi_reference(
        inputs["src"].to(device, torch.int64),
        inputs["dst"].to(device, torch.int64),
        inputs["lam"].to(device), inputs["mu"].to(device),
        torch.full((n,), 1.0 / n, dtype=torch.float64, device=device),
        **precision)
    return [psi.double().cpu().numpy()]


def as_served(psi: list, traffic: dict, draw) -> Served:
    """What the read would serve from ``psi`` (a control in the program's
    place)."""
    psi = psi[0]
    k = int(traffic["top_k"])
    ids = np.argsort(-psi, kind="stable")[:k]
    return Served(psi=psi, ids=ids, vals=psi[ids], iterations=0)


def numbers(served: Served, ref: list[np.ndarray], traffic: dict,
            draw) -> dict:
    ref = ref[0]
    return dict(psi_rel_max=rel_max(served.psi, ref),
                top_rel=top_rel(served.ids, served.vals,
                                int(traffic["top_k"]), ref))
