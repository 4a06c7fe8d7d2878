"""Deterministic synthetic data, pure numpy (identical in both packages)."""
