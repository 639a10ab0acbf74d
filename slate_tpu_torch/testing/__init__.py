"""Test matrix generation."""

from .matgen import random_spd  # noqa: F401
