"""Architecture registry: ``--arch <id>`` → config + shapes + family glue.

The JAX package's registry, every arch of it: the paper's ``psi-score``,
the GNN family (``pna``, ``equiformer-v2``, ``nequip``,
``graphsage-reddit``), the LM family (``tinyllama-1.1b``, ``yi-9b``,
``nemotron-4-340b``, ``mixtral-8x22b``, ``mixtral-8x7b``) and the recsys
family (``mind``). :data:`PORT_ARCHS` holds the archs the port serves
and the JAX package has no counterpart of (``mimo-v2-flash``);
:func:`get_arch` resolves both.
``reduced=True`` returns the CPU-smoke variant of the same family.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

__all__ = ["ShapeCfg", "ArchEntry", "get_arch", "ARCHS", "PORT_ARCHS"]


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str                  # train | prefill | decode | full_graph |
    #                            minibatch | molecule | serve | retrieval |
    #                            psi_iterate
    params: dict[str, Any]
    skip: str | None = None    # reason, if this (arch, shape) is skipped


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str                # lm | gnn | recsys | psi
    module: str                # configs module defining config(reduced)
    shapes: tuple[ShapeCfg, ...]

    def config(self, reduced: bool = False):
        mod = importlib.import_module(self.module)
        return mod.config(reduced=reduced)

    def shape(self, name: str) -> ShapeCfg:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}; have "
                       f"{[s.name for s in self.shapes]}")


def _lm_shapes(*, full_attention: bool) -> tuple[ShapeCfg, ...]:
    skip = ("pure full-attention arch: 500k dense decode excluded per "
            "assignment; sub-quadratic (SWA) archs run it"
            if full_attention else None)
    return (
        ShapeCfg("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        ShapeCfg("prefill_32k", "prefill",
                 dict(seq_len=32768, global_batch=32)),
        ShapeCfg("decode_32k", "decode",
                 dict(seq_len=32768, global_batch=128)),
        ShapeCfg("long_500k", "decode",
                 dict(seq_len=524288, global_batch=1), skip=skip),
    )


_GNN_SHAPES = (
    ShapeCfg("full_graph_sm", "full_graph",
             dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    ShapeCfg("minibatch_lg", "minibatch",
             dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                  fanout=(15, 10))),
    ShapeCfg("ogb_products", "full_graph",
             dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    ShapeCfg("molecule", "molecule",
             dict(n_nodes=30, n_edges=64, batch=128)),
)

_RECSYS_SHAPES = (
    ShapeCfg("train_batch", "train", dict(batch=65536)),
    ShapeCfg("serve_p99", "serve", dict(batch=512)),
    ShapeCfg("serve_bulk", "serve", dict(batch=262144)),
    ShapeCfg("retrieval_cand", "retrieval",
             dict(batch=1, n_candidates=1_000_000)),
)

_PSI_SHAPES = (
    ShapeCfg("twitter_scale", "psi_iterate", dict(dataset="twitter")),
    ShapeCfg("rmat24", "psi_iterate", dict(dataset="rmat24")),
)

ARCHS: dict[str, ArchEntry] = {
    e.arch_id: e for e in [
        ArchEntry("tinyllama-1.1b", "lm", "repro_torch.configs.tinyllama_1_1b",
                  _lm_shapes(full_attention=True)),
        ArchEntry("yi-9b", "lm", "repro_torch.configs.yi_9b",
                  _lm_shapes(full_attention=True)),
        ArchEntry("nemotron-4-340b", "lm",
                  "repro_torch.configs.nemotron_4_340b",
                  _lm_shapes(full_attention=True)),
        ArchEntry("mixtral-8x22b", "lm", "repro_torch.configs.mixtral_8x22b",
                  _lm_shapes(full_attention=False)),
        ArchEntry("mixtral-8x7b", "lm", "repro_torch.configs.mixtral_8x7b",
                  _lm_shapes(full_attention=False)),
        ArchEntry("pna", "gnn", "repro_torch.configs.pna", _GNN_SHAPES),
        ArchEntry("equiformer-v2", "gnn",
                  "repro_torch.configs.equiformer_v2", _GNN_SHAPES),
        ArchEntry("nequip", "gnn", "repro_torch.configs.nequip", _GNN_SHAPES),
        ArchEntry("graphsage-reddit", "gnn",
                  "repro_torch.configs.graphsage_reddit", _GNN_SHAPES),
        ArchEntry("mind", "recsys", "repro_torch.configs.mind",
                  _RECSYS_SHAPES),
        ArchEntry("psi-score", "psi", "repro_torch.configs.psi_score",
                  _PSI_SHAPES),
    ]
}


#: the port's own archs: no shape cells (the benchmark's ``gpubench/`` cuts
#: them to a card)
PORT_ARCHS: dict[str, ArchEntry] = {
    "mimo-v2-flash": ArchEntry("mimo-v2-flash", "lm",
                               "repro_torch.configs.mimo_v2_flash", ()),
}


def get_arch(arch_id: str) -> ArchEntry:
    entry = ARCHS.get(arch_id) or PORT_ARCHS.get(arch_id)
    if entry is None:
        raise KeyError(f"unknown arch {arch_id!r}; have "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")
    return entry
