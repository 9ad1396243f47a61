"""GNN family of the port: GraphSAGE on the shared substrate (the JAX
package's PNA, NequIP and EquiformerV2 are not ported yet)."""
from .common import (GraphBatch, segment_agg, segment_softmax, graph_pool,
                     batch_from_graph, pad_graph_batch)
from . import sage

__all__ = ["GraphBatch", "segment_agg", "segment_softmax", "graph_pool",
           "batch_from_graph", "pad_graph_batch", "sage"]
