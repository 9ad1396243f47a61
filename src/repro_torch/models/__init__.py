"""Model zoo of the port: the GNN family and the LM family."""
