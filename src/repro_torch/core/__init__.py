"""WawPart partitioning: query features, workload clustering, placement."""
