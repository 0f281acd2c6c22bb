"""Embedding row gather (the xDeepFM lookup)."""
