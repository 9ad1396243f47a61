"""GNN family of the port: PNA, GraphSAGE, NequIP, EquiformerV2 (+ SO(3)
machinery and 2-D sharded message passing)."""
from .common import (GraphBatch, segment_agg, segment_softmax, graph_pool,
                     batch_from_graph, pad_graph_batch)
from . import so3, sage, pna, nequip, equiformer_v2, sharded_mp

__all__ = ["GraphBatch", "segment_agg", "segment_softmax", "graph_pool",
           "batch_from_graph", "pad_graph_batch", "so3", "sage", "pna",
           "nequip", "equiformer_v2", "sharded_mp"]
