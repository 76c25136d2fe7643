"""Continuous-batching paged-KV serving tier.

Layers, bottom to top:

* :mod:`.paged` — physical KV pages: host free-list bookkeeping plus the
  gather/scatter that presents pages to the model as a dense cache view.
* :mod:`.scheduler` — FCFS admission under a page-budget watermark,
  immediate reclaim on finish, preempt-newest recompute when the pool
  runs dry.
* :mod:`.runners` — the prefill (compute-bound) and decode
  (bandwidth-bound, skinny-M) phases, each scoped with its serving phase.
* :mod:`.engine` — :class:`ContinuousEngine` (slot-free continuous
  batching) and :class:`FixedEngine` (the fixed-slot server, the only
  engine of the ssm, hybrid, encdec and vlm families).
* :mod:`.gateway` / :mod:`.trace` — drive a seeded multi-tenant Poisson
  trace through the engine with per-request observability.

``python -m repro_torch.launch.serve`` is the CLI entry point.
"""

from .engine import ContinuousEngine, FixedEngine
from .gateway import Gateway
from .paged import PagePool, pool_init
from .scheduler import Scheduler, ServeRequest
from .trace import synthetic_trace

__all__ = [
    "ContinuousEngine",
    "FixedEngine",
    "Gateway",
    "PagePool",
    "pool_init",
    "Scheduler",
    "ServeRequest",
    "synthetic_trace",
]
