"""Embedding row gather (the xDeepFM lookup) and weighted bag sum."""
