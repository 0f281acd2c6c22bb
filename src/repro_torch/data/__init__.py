"""Synthetic input streams (numpy, made from a seed)."""
