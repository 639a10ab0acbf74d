"""Errors (reference ``include/slate/Exception.hh``)."""

from __future__ import annotations


class SlateError(RuntimeError):
    """Reference ``slate::Exception``."""
