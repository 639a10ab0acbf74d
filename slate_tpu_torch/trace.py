"""Tracing — the port of ``slate_tpu/trace.py`` (reference
``include/slate/internal/Trace.hh``, ``trace::Block``; ``src/auxiliary/
Trace.cc``, the SVG timeline).

A :class:`Block` context manager (or decorator) records (name, start,
stop, lane) while tracing is on; :func:`finish` renders a standalone SVG
timeline and :func:`finish_perfetto` a Chrome-trace/Perfetto JSON.  Each
Block also opens a ``torch.profiler.record_function`` range, so its spans
line up with the card's kernels in a ``torch.profiler`` trace.  Host
timestamps measure enqueue unless the body synchronizes with the card
(PyTorch returns before CUDA work finishes).  The JAX package's Perfetto
export also merges the metrics registry's counter samples and the serving
telemetry's request spans; the port records neither yet, so its export
holds the Block spans.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from typing import List, NamedTuple, Optional

__all__ = ["Block", "Event", "clear", "current_lane", "events", "finish",
           "finish_perfetto", "is_on", "off", "on"]


class Event(NamedTuple):
    name: str
    start: float
    stop: float
    lane: str


_events: List[Event] = []
_lock = threading.Lock()
_enabled = False
_origin = 0.0

# one stable, distinct lane per thread: the first thread with a name keeps
# it, later threads with the same name get "name#2", "name#3", ...
_lane_by_ident: dict = {}
_lane_counts: dict = {}


def current_lane() -> str:
    """The calling thread's trace lane."""
    t = threading.current_thread()
    with _lock:
        hit = _lane_by_ident.get(t.ident)
        if hit is not None and hit[0] == t.name:
            return hit[1]
        k = _lane_counts.get(t.name, 0) + 1
        _lane_counts[t.name] = k
        lane = t.name if k == 1 else "%s#%d" % (t.name, k)
        _lane_by_ident[t.ident] = (t.name, lane)
        return lane


def on() -> None:
    """Enable tracing (reference ``Trace::on()``)."""
    global _enabled, _origin
    _enabled = True
    if not _origin:
        _origin = time.perf_counter()


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


def clear() -> None:
    global _origin
    with _lock:
        _events.clear()
    _origin = time.perf_counter()


class Block:
    """Trace scope (reference ``trace::Block``), as a context manager or a
    decorator::

        with trace.Block("potrf"):
            ...
    """

    def __init__(self, name: str, lane: Optional[str] = None):
        self.name = name[:30]          # the reference caps names at 30
        self._lane_arg = lane
        self.lane = lane or threading.current_thread().name
        self._rf = None
        self._t0 = 0.0

    def __enter__(self):
        if _enabled:
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
            if self._lane_arg is None:
                self.lane = current_lane()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if _enabled and self._t0:
            t1 = time.perf_counter()
            with _lock:
                _events.append(Event(self.name, self._t0 - _origin,
                                     t1 - _origin, self.lane))
            self._t0 = 0.0
        return False

    def __call__(self, fn):
        # the lane resolves at call time, on the thread that runs fn
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with Block(self.name, self._lane_arg):
                return fn(*a, **kw)
        return wrapper


_PALETTE = ["#4878d0", "#ee854a", "#6acc64", "#d65f5f", "#956cb4",
            "#8c613c", "#dc7ec0", "#797979", "#d5bb67", "#82c6e2"]


def events() -> List[Event]:
    with _lock:
        return list(_events)


def finish(path: Optional[str] = None) -> Optional[str]:
    """Render the events as a standalone SVG timeline (lanes × time,
    coloured by name) and reset (reference ``Trace::finish()``).  Returns
    the path (``trace_<epoch>.svg`` by default), None with no events."""
    evts = events()
    clear()
    if not evts:
        return None
    path = path or f"trace_{int(time.time())}.svg"
    lanes = sorted({e.lane for e in evts})
    names = sorted({e.name for e in evts})
    colors = {n: _PALETTE[i % len(_PALETTE)] for i, n in enumerate(names)}
    t0 = min(e.start for e in evts)
    t1 = max(e.stop for e in evts)
    span = max(t1 - t0, 1e-9)
    width, row_h, left = 1000.0, 24.0, 120.0
    height = row_h * len(lanes) + 60 + 16 * ((len(names) + 3) // 4)

    def x(t):
        return left + (t - t0) / span * (width - left - 10)

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" '
             f'height="{height:.0f}" font-family="monospace" font-size="11">']
    for li, lane in enumerate(lanes):
        y = 30 + li * row_h
        parts.append(f'<text x="4" y="{y + row_h * 0.7:.1f}">{lane[:14]}</text>')
        parts.append(f'<line x1="{left}" y1="{y + row_h:.1f}" x2="{width - 10}" '
                     f'y2="{y + row_h:.1f}" stroke="#ddd"/>')
    for e in evts:
        y = 30 + lanes.index(e.lane) * row_h
        w = max(x(e.stop) - x(e.start), 0.5)
        parts.append(
            f'<rect x="{x(e.start):.2f}" y="{y + 2:.1f}" width="{w:.2f}" '
            f'height="{row_h - 6:.1f}" fill="{colors[e.name]}">'
            f'<title>{e.name}: {(e.stop - e.start) * 1e3:.3f} ms</title></rect>')
    for k in range(6):
        t = t0 + span * k / 5
        parts.append(f'<line x1="{x(t):.1f}" y1="20" x2="{x(t):.1f}" '
                     f'y2="{30 + row_h * len(lanes):.1f}" stroke="#eee"/>')
        parts.append(f'<text x="{x(t) - 14:.1f}" y="16">'
                     f'{(t - t0) * 1e3:.1f}ms</text>')
    ly = 30 + row_h * len(lanes) + 18
    for i, n in enumerate(names):
        lx = 10 + (i % 4) * 240
        lyy = ly + (i // 4) * 16
        parts.append(f'<rect x="{lx}" y="{lyy - 9}" width="10" height="10" '
                     f'fill="{colors[n]}"/>')
        parts.append(f'<text x="{lx + 14}" y="{lyy}">{n}</text>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path


def finish_perfetto(path: Optional[str] = None) -> Optional[str]:
    """Export the events as Chrome-trace/Perfetto JSON (one complete event
    ``"ph": "X"`` a Block, one track a lane) and reset.  Returns the path
    (``trace_<epoch>.perfetto.json`` by default), None with no events."""
    evts = events()
    clear()
    if not evts:
        return None
    tids = {lane: i for i, lane in enumerate(sorted({e.lane for e in evts}))}
    out = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": lane}} for lane, tid in tids.items()]
    for e in evts:
        out.append({"name": e.name, "cat": "block", "ph": "X",
                    "ts": round(e.start * 1e6, 3),
                    "dur": round(max(e.stop - e.start, 0.0) * 1e6, 3),
                    "pid": 0, "tid": tids[e.lane]})
    path = path or f"trace_{int(time.time())}.perfetto.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
    return path
