"""Synthetic multi-tenant request traces for the serving gateway.

A trace is a list of :class:`ServeRequest` with Poisson inter-arrival
times and per-request prompt length / generation budget drawn from small
mixed sets — the shape of real serving traffic (a few tenants, short
chat turns mixed with long completions) at smoke-test scale.  Seeded, so
the differential tests and benches replay identical workloads.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .scheduler import ServeRequest


def synthetic_trace(
    n_requests: int,
    *,
    vocab: int,
    seed: int = 0,
    rate_hz: float = 200.0,
    tenants: Sequence[str] = ("tenant0", "tenant1"),
    prompt_lens: Sequence[int] = (4, 8, 16),
    max_news: Sequence[int] = (2, 4, 8),
) -> List[ServeRequest]:
    """Poisson arrivals at ``rate_hz``; lengths/budgets drawn uniformly
    from the given sets.  ``rate_hz=0`` puts every arrival at t=0 (a
    fully saturated queue — what the throughput bench wants)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs: List[ServeRequest] = []
    for i in range(n_requests):
        if rate_hz > 0:
            t += float(rng.exponential(1.0 / rate_hz))
        plen = int(rng.choice(list(prompt_lens)))
        reqs.append(ServeRequest(
            rid=i,
            prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
            max_new=int(rng.choice(list(max_news))),
            arrival_s=t,
            tenant=str(rng.choice(list(tenants))),
        ))
    return reqs
