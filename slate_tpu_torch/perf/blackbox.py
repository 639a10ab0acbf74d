"""Flight recorder: a bounded ring of decision events plus one-shot
forensic bundles — the port of ``slate_tpu/perf/blackbox.py``.

* **The ring.**  A process-wide, thread-safe, bounded ``deque`` of
  structured events recorded at the decision seams: health verdicts and
  safe-backend reruns (:mod:`slate_tpu_torch.resilience.health`), ABFT
  ladder rungs (:mod:`~slate_tpu_torch.resilience.abft`), checkpoint
  restores and chunks (:mod:`~slate_tpu_torch.resilience.checkpoint`),
  fault-plan firings (:mod:`~slate_tpu_torch.resilience.inject`) and the
  measured distributed timeline's steps
  (:func:`slate_tpu_torch.parallel.dist_util.run_timeline`).
* **Triggers.**  :func:`trigger` (a strict health failure, a device loss,
  the opt-in excepthook) records the trigger and writes ONE versioned
  bundle: the ring, ``metrics.snapshot()``, the knobs and config, a digest
  of the autotune decisions, the active fault plan's replay log and the
  host's versions.

Off by default: every recording entry point reads one attribute and
returns; importing this module starts no thread, opens no file and
installs no hook.

Environment knobs (all unset by default):

* ``SLATE_TPU_TORCH_BLACKBOX=1`` — enable the recorder;
* ``SLATE_TPU_TORCH_BLACKBOX_RING`` — ring capacity (default 512);
* ``SLATE_TPU_TORCH_BLACKBOX_DIR`` — bundle directory (default the
  temporary directory);
* ``SLATE_TPU_TORCH_BLACKBOX_MAX_DUMPS`` — bundles a process writes from
  triggers (default 8);
* ``SLATE_TPU_TORCH_BLACKBOX_EXCEPTHOOK=1`` — a bundle from an uncaught
  exception (hook installed at the first event or :func:`on`);
* ``SLATE_TPU_TORCH_DIST_TIMELINE=1`` — ``pgetrf``/``ppotrf`` run one
  step window at a time with each window's wall and broadcast bytes
  measured; ``SLATE_TPU_TORCH_DIST_TIMELINE_WINDOW`` — steps a window
  (default 1).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import sys
import threading
import time
from collections import deque

from . import metrics

__all__ = [
    "ENV_BLACKBOX", "ENV_DIR", "ENV_EXCEPTHOOK", "ENV_MAX_DUMPS",
    "ENV_RING", "ENV_TIMELINE", "ENV_TIMELINE_WINDOW", "SCHEMA",
    "dump", "enabled", "events", "install_excepthook", "last_bundle",
    "off", "on", "record", "reset", "ring_size", "timeline_wanted",
    "timeline_window", "trigger",
]

ENV_BLACKBOX = "SLATE_TPU_TORCH_BLACKBOX"
ENV_RING = "SLATE_TPU_TORCH_BLACKBOX_RING"
ENV_DIR = "SLATE_TPU_TORCH_BLACKBOX_DIR"
ENV_MAX_DUMPS = "SLATE_TPU_TORCH_BLACKBOX_MAX_DUMPS"
ENV_EXCEPTHOOK = "SLATE_TPU_TORCH_BLACKBOX_EXCEPTHOOK"
ENV_TIMELINE = "SLATE_TPU_TORCH_DIST_TIMELINE"
ENV_TIMELINE_WINDOW = "SLATE_TPU_TORCH_DIST_TIMELINE_WINDOW"

#: bundle schema identity
SCHEMA = "slate_tpu_torch.blackbox/1"

_DEFAULT_RING = 512
_DEFAULT_MAX_DUMPS = 8
_dump_seq = itertools.count()


def _env_int(name: str, default: int, lo: int = 1) -> int:
    try:
        return max(lo, int(os.environ.get(name, "").strip() or default))
    except ValueError:
        return default


class _Recorder:
    def __init__(self):
        self.enabled = metrics.env_flag(ENV_BLACKBOX)
        # reentrant: a dump from a signal frame may interrupt this thread
        # inside a critical section
        self.lock = threading.RLock()
        self.ring: deque = deque(maxlen=_env_int(ENV_RING, _DEFAULT_RING))
        self.dumps = 0
        self.last: dict | None = None


_rec = _Recorder()

_hook_wanted = [metrics.env_flag(ENV_EXCEPTHOOK)]
_prev_hook: list = [None]


def enabled() -> bool:
    return _rec.enabled


def on(ring: int | None = None) -> None:
    """Enable the recorder (optionally resizing the ring); installs the
    excepthook when ``SLATE_TPU_TORCH_BLACKBOX_EXCEPTHOOK`` asks."""
    rec = _rec
    if ring is not None and int(ring) != rec.ring.maxlen:
        with rec.lock:
            rec.ring = deque(rec.ring, maxlen=max(1, int(ring)))
    rec.enabled = True
    if _hook_wanted[0]:
        install_excepthook()


def off() -> None:
    _rec.enabled = False


def reset() -> None:
    """Drop every event and the dump bookkeeping (the enabled flag
    stays)."""
    rec = _rec
    with rec.lock:
        rec.ring.clear()
        rec.dumps = 0
        rec.last = None


def ring_size() -> int:
    return int(_rec.ring.maxlen or 0)


def record(kind: str, **fields) -> None:
    """Append one event to the ring; one attribute read while off."""
    rec = _rec
    if not rec.enabled:
        return
    if _hook_wanted[0]:
        install_excepthook()
    ev = {"t": time.time(), "kind": str(kind)}
    ev.update(fields)
    with rec.lock:
        rec.ring.append(ev)


def events() -> list:
    """A copy of the ring, oldest first."""
    with _rec.lock:
        return [dict(e) for e in _rec.ring]


def timeline_wanted() -> bool:
    """``SLATE_TPU_TORCH_DIST_TIMELINE=1``: run pgetrf/ppotrf one measured
    step window at a time (read per call)."""
    return metrics.env_flag(ENV_TIMELINE)


def timeline_window() -> int:
    """Steps a measured window (``SLATE_TPU_TORCH_DIST_TIMELINE_WINDOW``,
    default 1)."""
    return _env_int(ENV_TIMELINE_WINDOW, 1)


# ---------------------------------------------------------------------------
# Bundle assembly: each section guarded (a dump never raises out of a
# recovery path) and read off modules already loaded (a dump imports
# nothing).
# ---------------------------------------------------------------------------

def _host_info() -> dict:
    info = {"python": sys.version.split()[0], "platform": sys.platform,
            "pid": os.getpid(), "argv0": sys.argv[0] if sys.argv else ""}
    for mod in ("torch", "numpy"):
        m = sys.modules.get(mod)
        if m is not None:
            info[mod] = str(getattr(m, "__version__", "?"))
    t = sys.modules.get("torch")
    if t is not None:
        info["cuda"] = str(getattr(t.version, "cuda", None))
    return info


def _knob_state() -> dict:
    return dict(sorted((k, v) for k, v in os.environ.items()
                       if k.startswith("SLATE_TPU_TORCH_")))


def _config_state() -> dict:
    cfg = sys.modules.get("slate_tpu_torch.config")
    if cfg is None:
        return {}
    return {"use_kernels": cfg.use_kernels_mode(),
            "split_gemm": cfg.split_gemm_mode(),
            "f64_mxu": cfg.f64_mxu_mode(),
            "scattered_lu": bool(cfg.scattered_lu),
            "default_block_size": int(cfg.default_block_size)}


def _autotune_digest() -> dict:
    """Per-site decision counts and a hash of the live decision table
    (:func:`slate_tpu_torch.perf.autotune.decisions`).  The port's
    decisions are heuristics, so nothing is ever quarantined."""
    at = sys.modules.get("slate_tpu_torch.perf.autotune")
    if at is None:
        return {"decisions": 0}
    dec = at.decisions()
    sites: dict = {}
    lines = []
    for key in sorted(dec):
        site = key.split("|", 1)[0]
        sites[site] = sites.get(site, 0) + 1
        lines.append("%s=%s" % (key, dec[key]))
    sha = hashlib.sha1("\n".join(lines).encode()).hexdigest()[:12]
    return {"decisions": len(dec), "sites": sites, "sha1": sha,
            "quarantined": 0}


def _fault_plan_state() -> dict | None:
    inj = sys.modules.get("slate_tpu_torch.resilience.inject")
    if inj is None:
        return None
    plan = inj.get_plan()
    if plan is None:
        return None
    return {"seed": plan.seed,
            "specs": [{"site": s.site, "kind": s.kind, "rate": s.rate,
                       "count": s.count}
                      for s in plan.specs.values()],
            "fired": plan.fired(),
            "log": [{"site": s, "index": i, "kind": k}
                    for s, i, k in plan.log[-200:]]}


def _section(fn):
    try:
        return fn()
    except Exception as e:
        return {"error": "%s: %s" % (type(e).__name__, e)}


def _assemble(reason: str, detail: str) -> dict:
    return {
        "schema": SCHEMA,
        "created": time.time(),
        "trigger": {"reason": str(reason), "detail": str(detail)[:500],
                    "t": time.time()},
        "host": _section(_host_info),
        "knobs": _section(_knob_state),
        "config": _section(_config_state),
        "autotune": _section(_autotune_digest),
        "fault_plan": _section(_fault_plan_state),
        "metrics": _section(metrics.snapshot),
        "events": events(),
    }


def dump(reason: str, detail: str = "", path: str | None = None):
    """Write one bundle now (the per-process cap does not apply).  Returns
    ``{"path", "digest", "reason"}``, or None when the recorder is off or
    the write failed (``blackbox.dump_errors``)."""
    rec = _rec
    if not rec.enabled:
        return None
    try:
        text = json.dumps(_assemble(reason, detail), default=str)
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        if path is None:
            d = os.environ.get(ENV_DIR, "").strip()
            if not d:
                import tempfile

                d = tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, "slate_tpu_torch_blackbox_%d_%d_%d.json"
                % (int(time.time() * 1e3), os.getpid(), next(_dump_seq)))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except Exception:
        metrics.inc("blackbox.dump_errors")
        return None
    info = {"path": path, "digest": digest, "reason": str(reason)}
    with rec.lock:
        rec.dumps += 1
        rec.last = info
    metrics.inc("blackbox.dumps")
    return info


def trigger(reason: str, detail: str = ""):
    """Record the trigger and, under the per-process cap, write the bundle.
    Returns :func:`dump`'s info (None when off, capped or failed)."""
    rec = _rec
    if not rec.enabled:
        return None
    record("trigger", reason=str(reason), detail=str(detail)[:500])
    metrics.inc("blackbox.trigger." + str(reason).replace(" ", "_"))
    with rec.lock:
        capped = rec.dumps >= _env_int(ENV_MAX_DUMPS, _DEFAULT_MAX_DUMPS)
    if capped:
        return None
    return dump(reason, detail)


def last_bundle():
    """The latest bundle's ``{"path", "digest", "reason"}`` (None before
    the first)."""
    with _rec.lock:
        return dict(_rec.last) if _rec.last else None


def install_excepthook() -> None:
    """Chain a bundle dump into ``sys.excepthook`` (idempotent; the
    previous hook always runs)."""
    _hook_wanted[0] = False
    if _prev_hook[0] is not None:
        return
    prev = sys.excepthook
    _prev_hook[0] = prev

    def hook(tp, val, tb):
        try:
            trigger("excepthook", "%s: %s" % (tp.__name__, val))
        finally:
            prev(tp, val, tb)

    sys.excepthook = hook
