"""The one shared pow2 bucketing helper — the part of
``slate_tpu/perf/sweep.py`` (``pow2_bucket``, ``:84``) the port needs:
the batched autotune keys (:mod:`slate_tpu_torch.perf.autotune`) and the
serving queue's executable buckets (:mod:`slate_tpu_torch.serve.queue`)
both derive from it, so the two can never bucket one shape differently.
The offline sweep engine itself is not ported (ROADMAP.md, queue 1)."""

from __future__ import annotations


def pow2_bucket(d, floor: int = 8) -> int:
    """Next power of two ≥ d, with a floor."""
    return max(int(floor), 1 << (max(1, int(d)) - 1).bit_length())
