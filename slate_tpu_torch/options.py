"""Per-call option map (reference ``types.hh:32-61``, ``:170-205``): a
plain dict keyed by :class:`~slate_tpu_torch.enums.Option`, its name or
its value string."""

from __future__ import annotations

from typing import Any, Mapping, Optional

from .enums import Option, Target

Options = Mapping

_UNSET = object()

_DEFAULTS = {
    Option.Lookahead: 1,
    Option.InnerBlocking: 128,
    Option.MaxPanelThreads: 1,
    Option.Tolerance: None,
    Option.Target: Target.Devices,
    Option.HoldLocalWorkspace: False,
    Option.Depth: 2,
    Option.MaxIterations: 30,
    Option.UseFallbackSolver: True,
    Option.PivotThreshold: 1.0,
    Option.PrintVerbose: 4,
    Option.PrintEdgeItems: 16,
    Option.PrintWidth: 10,
    Option.PrintPrecision: 4,
}


def _canon(key) -> Option:
    if isinstance(key, Option):
        return key
    if isinstance(key, str):
        for opt in Option:
            if key == opt.value or key == opt.name:
                return opt
    raise KeyError(f"unknown option {key!r}")


def get_option(opts: Optional[Options], key, default: Any = _UNSET) -> Any:
    """Typed option lookup: explicit entry in ``opts`` → ``default`` →
    the framework default table.  ``Option.BlockSize`` has no table
    entry; the drivers resolve it (matrix nb → ``SLATE_TPU_TORCH_NB``)."""

    key = _canon(key)
    if opts:
        for k, v in opts.items():
            try:
                if _canon(k) is key:
                    return v
            except KeyError:
                continue
    if default is not _UNSET:
        return default
    return _DEFAULTS.get(key)
