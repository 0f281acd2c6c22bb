"""Blocked flash attention with an online softmax (GQA/MQA, causal)."""
