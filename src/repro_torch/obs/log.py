"""Structured stdout logger — where the ad-hoc ``print()``s moved to.

One line per call, ``[component] message`` (or bare ``message`` with no
component), so the human-readable output is byte-identical to the old
prints at the default level — existing smoke greps keep working.  The
level comes from ``REPRO_LOG``:

    quiet   nothing
    info    the default — what the old prints showed
    debug   info + debug() lines (per-step serve timings etc.)

Unknown values fall back to ``info``.  The level is re-read per call so a
test (or an operator mid-run via a wrapper) can flip it without reloads.
This is deliberately not ``logging``: no handlers, no formatters, no
global mutable config a library import could clobber — serving smoke
output must stay exactly what it was.
"""

from __future__ import annotations

import os
from typing import Optional

_LEVELS = {"quiet": 0, "info": 1, "debug": 2}


def level() -> int:
    """Numeric level from ``REPRO_LOG`` (default info)."""
    return _LEVELS.get(os.environ.get("REPRO_LOG", "info"), 1)


def _emit(component: Optional[str], msg: str, **kw) -> None:
    if component:
        print(f"[{component}] {msg}", **kw)
    else:
        print(msg, **kw)


def info(component: Optional[str], msg: str, *, flush: bool = False) -> None:
    """Default-level line; shown unless ``REPRO_LOG=quiet``."""
    if level() >= 1:
        _emit(component, msg, flush=flush)


def debug(component: Optional[str], msg: str, *, flush: bool = False) -> None:
    """Verbose line; shown only under ``REPRO_LOG=debug``."""
    if level() >= 2:
        _emit(component, msg, flush=flush)
