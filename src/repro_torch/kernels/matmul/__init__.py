"""Blocked matmul: hand-written kernel B5 and its generated counterpart."""
