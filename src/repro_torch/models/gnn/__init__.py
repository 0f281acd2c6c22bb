"""Graph neural networks: GCN, EGNN, NequIP and Equiformer-v2."""
