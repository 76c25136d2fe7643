"""Fused dense + normalization + activation (paper eqs 3-5): kernel B6."""
