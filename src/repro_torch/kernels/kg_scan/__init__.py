"""Fused masked triple-pattern scan with its int32 prefix sum."""
