"""Entry points: the workload server and its CLI."""
