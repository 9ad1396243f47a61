"""Model zoo of the port: the GNN, LM and recsys families."""
