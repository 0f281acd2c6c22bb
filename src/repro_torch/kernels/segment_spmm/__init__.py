"""Segment sum of edge messages into receiver nodes (GNN aggregation)."""
