"""Merge-join candidate ranges and the expand-join compatibility matrix."""
