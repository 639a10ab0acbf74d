"""Tile helpers, blocked building blocks and the hand-written kernels."""
