"""Model zoo of the port: so far the GNN family's GraphSAGE."""
