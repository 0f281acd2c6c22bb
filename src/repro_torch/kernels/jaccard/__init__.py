"""Q x Q Jaccard distance matrix of a 0/1 query-feature membership matrix."""
