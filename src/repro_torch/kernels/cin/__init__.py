"""Fused xDeepFM CIN layer."""
