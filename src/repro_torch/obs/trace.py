"""Nestable spans with Chrome-trace export — the tracing layer of repro_torch.obs.

Usage::

    from repro_torch import obs

    with obs.span("search.beam", spec="matmul"):
        with obs.span("search.enumerate"):
            ...

Spans nest through a thread-local stack; each completed span records one
Chrome-trace *complete* event (``ph: "X"``) with microsecond ``ts``/``dur``
relative to a process epoch, plus ``depth`` and ``parent`` args so tools
that flatten the event list can still reconstruct the nesting.  Export with
``trace_json()`` / ``trace_dump(path)`` — the output loads directly in
``chrome://tracing`` and https://ui.perfetto.dev.

With ``REPRO_OBS=0`` ``span()`` returns a shared no-op context manager and
nothing is recorded (the acquired-lock path is never reached).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: process epoch — all ts values are microseconds since this moment
_EPOCH = time.perf_counter()

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_tls = threading.local()


def _stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Span:
    """One timed region; records a Chrome-trace "X" event on exit."""

    __slots__ = ("name", "cat", "args", "_t0", "_depth", "_parent")

    def __init__(self, name: str, cat: str, args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._depth = 0
        self._parent: Optional[str] = None

    def __enter__(self) -> "_Span":
        st = _stack()
        self._depth = len(st)
        self._parent = st[-1] if st else None
        st.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        args = {"depth": self._depth}
        if self._parent is not None:
            args["parent"] = self._parent
        args.update(self.args)
        ev = {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self._t0 - _EPOCH) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with _lock:
            _events.append(ev)


class _NoopSpan:
    """Shared do-nothing span — what ``span()`` hands out when disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()


def span(name: str, cat: str = "repro", **args: Any):
    """Context manager timing one region; nests via a thread-local stack.

    ``args`` ride into the Chrome-trace event's ``args`` dict verbatim
    (keep them JSON-serializable).  Free when ``REPRO_OBS=0``.
    """
    from . import enabled

    if not enabled():
        return _NOOP
    return _Span(name, cat, args)


def complete_event(
    name: str,
    start_s: float,
    dur_s: float,
    cat: str = "repro",
    **args: Any,
) -> None:
    """Record a Chrome-trace complete event retroactively.

    For region timings that cannot be a ``with span(...)`` because their
    lifetimes overlap in one thread — e.g. a serving gateway's
    per-request spans, where dozens of requests are in flight at once and
    each spans arrival→finish.  ``start_s`` is a ``time.perf_counter()``
    reading; the event lands on the same process epoch as ``span``.
    Free when ``REPRO_OBS=0``.
    """
    from . import enabled

    if not enabled():
        return
    ev = {
        "name": name,
        "cat": cat,
        "ph": "X",
        "ts": (start_s - _EPOCH) * 1e6,
        "dur": dur_s * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": dict(args),
    }
    with _lock:
        _events.append(ev)


def trace_events() -> List[Dict[str, Any]]:
    """Snapshot of the completed-span events recorded so far."""
    with _lock:
        return list(_events)


def trace_json() -> Dict[str, Any]:
    """The Chrome-trace document: ``{"traceEvents": [...], ...}``."""
    return {
        "traceEvents": trace_events(),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs"},
    }


def trace_dump(path: str) -> str:
    """Write the Chrome-trace JSON to ``path``; returns the path."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace_json(), f, indent=1)
    return path


def trace_reset() -> None:
    """Drop every recorded event (tests; long-lived servers between dumps)."""
    with _lock:
        _events.clear()
