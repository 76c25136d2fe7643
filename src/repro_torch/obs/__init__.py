"""repro_torch.obs — zero-dependency observability: tracing and metrics.

A stdlib-only copy of the reference package's observability layer, so the
port's engine, caches and kernels report under the same span, counter and
histogram names:

* ``obs.trace`` — nestable spans (``with span("serve.prefill"): ...``)
  with a thread-local stack and Chrome-trace/Perfetto JSON export.
* ``obs.metrics`` — a process-global registry of counters, gauges and
  exact-value histograms (p50/p99): autotune/plan-DB hits and misses,
  ``codegen.memo.hit/miss``, per-request serve latency and TTFT.
* ``obs.log`` — the structured stdout logger; honors
  ``REPRO_LOG=quiet|info|debug``.

Everything is a strict no-op when ``REPRO_OBS=0`` (on by default): spans
cost one dict lookup and record nothing, metric handles are a shared
do-nothing singleton, and the registry stays empty.
"""

from __future__ import annotations

import os

__all__ = [
    "enabled",
    "span",
    "complete_event",
    "trace_events",
    "trace_json",
    "trace_dump",
    "trace_reset",
    "counter",
    "gauge",
    "histogram",
    "metrics_json",
    "metrics_dump",
    "metrics_reset",
    "registry",
]


def enabled() -> bool:
    """Observability master switch — ``REPRO_OBS=0`` turns it all off.

    Read from the environment on every call (it is one dict lookup) so
    tests can flip it per-case without reloading modules.
    """
    return os.environ.get("REPRO_OBS", "1") != "0"


from .metrics import (  # noqa: E402
    counter,
    gauge,
    histogram,
    metrics_dump,
    metrics_json,
    metrics_reset,
    registry,
)
from .trace import (  # noqa: E402
    complete_event,
    span,
    trace_dump,
    trace_events,
    trace_json,
    trace_reset,
)
