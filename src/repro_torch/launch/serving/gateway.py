"""Gateway: drives a request trace through an engine and reports per-run
serving metrics.

The engine records the per-request observability itself (latency/TTFT
histograms, ``serve.request`` complete-events); the gateway adds the
run-level summary — p50/p99 latency, per-tenant token counts — and the
``--metrics-out`` / ``--trace-out`` artifact writing, so the CLI and the
bench share one code path.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ... import obs
from ...obs import log
from .scheduler import ServeRequest


class Gateway:
    """Thin front door over a serving engine (continuous or fixed)."""

    def __init__(self, engine):
        self.engine = engine

    def run(
        self, trace: List[ServeRequest], *, eos_id: Optional[int] = None
    ) -> Dict:
        with obs.span("serve.gateway", requests=len(trace)):
            stats = self.engine.run(trace, eos_id=eos_id)
        lat = [
            r.t_done - r.t_submit
            for r in trace
            if r.t_done is not None and r.t_submit is not None
        ]
        stats["p50_s"] = float(np.percentile(lat, 50)) if lat else 0.0
        stats["p99_s"] = float(np.percentile(lat, 99)) if lat else 0.0
        by_tenant: Dict[str, int] = {}
        for r in trace:
            by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + len(
                r.out_tokens
            )
        for tenant, toks in sorted(by_tenant.items()):
            obs.counter(f"serve.tenant_tokens.{tenant}").inc(toks)
        stats["tenant_tokens"] = by_tenant
        log.info(
            "serve",
            f"{stats['requests']} request(s), {stats['tokens']} token(s) "
            f"at {stats['tok_per_s']:.1f} decode tok/s, "
            f"p50 {stats['p50_s']*1e3:.1f} ms, "
            f"p99 {stats['p99_s']*1e3:.1f} ms, "
            f"{stats['preemptions']} preemption(s)",
        )
        return stats
