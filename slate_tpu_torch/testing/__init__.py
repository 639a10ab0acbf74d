"""Test matrix generation."""

from .matgen import generate_matrix, random_spd  # noqa: F401
