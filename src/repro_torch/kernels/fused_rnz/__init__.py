"""Fused weighted contraction (paper eq 2): kernel B7."""
