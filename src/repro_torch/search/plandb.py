"""Ranked plan database — the search pipeline's persistent output.

Where ``codegen.cache`` stores *one* tuned schedule per key, the plan DB
stores the search's whole ranked ladder (schedule + analytic score +
roofline bound + measured time + search stats) per (spec, dtype,
hardware[, mesh][, phase]) key, so ops can take the winner today and an
operator can inspect or re-rank the runners-up tomorrow without
re-searching.  ``ops.dense`` consults it first.  The file format and the
key derivation are the reference's, byte for byte, so a plan DB written by
the reference's sweep (e.g. ``tests/data/plan_db_golden.json``) resolves
through the port, and a rung the port writes (``entry_from``) is the
reference's JSON.  The one addition: a rung measured on the card may carry
a ``card`` field, the card plan it ran -- B1's tile plan (``{"body",
"tile_n", "splits"}``, ``codegen.cuda_gen.CardPlan``), the 8-bit ring's
(``{"kernel": "q8", "body", "ctas"}``, ``codegen.modes.Q8Plan``),
the chain's (``{"kernel": "chain", "assoc", "cluster"}``,
``codegen.modes.ChainPlan``) or a fused kernel's (``{"kernel", "body",
"block", "ctas"}``, ``codegen.fused_gen.FusedPlan``;
``fused_gen.plan_from_dict`` tells them apart by the ``kernel`` key, so a
DB written before these plans existed loads as it was) -- which
``ops._tuned_kernel`` hands to the compiled kernel; a rung without one is
the reference's.  A ladder measured under an epilogue lives under a key
qualified by it (``plan_key(epilogue=)``), which no reference key
carries.  A
card ladder lives under the card's hardware fingerprint
(``cuda/<device name>``), which no reference key carries.  Storage reuses
``codegen.cache.AutotuneCache`` (atomic JSON, concurrent-writer safe) in a
separate file:

    $REPRO_PLAN_DB if set, else ~/.cache/repro_torch/plans.json

Keys come from ``codegen.cache.cache_key`` with a ``search.plan`` marker, so
they are disjoint from autotune keys even if the files are merged by hand.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..codegen.cache import (
    AutotuneCache,
    cache_key,
    dtype_name,
    schedule_from_dict,
    schedule_to_dict,
    spec_signature,
)
from ..core.enumerate import ContractionSpec
from ..core.schedule import Schedule

#: bump when the ranked-entry layout changes.
#: v2 (mesh tier): keys gained a ``mesh`` qualifier (None for
#: single-device plans, '2x4'-style for sharded ones) and ranked entries
#: an optional ``collective`` field naming the finishing-reduction
#: lowering.  Every v1 key goes cold on upgrade — deliberate: v1 ladders
#: carry no mesh provenance, so a sharded fleet could have picked up a
#: single-device plan for a mesh-qualified lookup (or vice versa).
#: v3 (observability / plan-explain): entries carry their own identity
#: (``spec`` = ``spec_signature``, ``dtype``) so ``obs.explain`` can find
#: them by human selector instead of sha256 key, each rung an ``explain``
#: dict of the roofline terms the ranking was decided from (compute/HBM/
#: collective seconds, penalty, shards — ``beam.CostEstimate``), and the
#: entry a ``cuts`` sample of the sound bound cuts.  v2 keys go cold
#: (their ladders lack the provenance v3 readers expose); ``PlanDB.get``
#: counts such upgrades as ``plandb.version_miss`` in ``obs``.
#: The golden fixture ``tests/data/plan_db_golden.json`` pins this format.
PLAN_VERSION = 3


def plan_key(
    spec: ContractionSpec,
    dtype: Any,
    hardware: Optional[str] = None,
    mesh: Optional[str] = None,
    version: int = PLAN_VERSION,
    phase: Optional[str] = None,
    epilogue: Optional[str] = None,
) -> str:
    """Plan-DB key; ``mesh`` is a ``search.space.mesh_descriptor`` string
    ('2x4') qualifying sharded ladders — conceptually ``matmul@mesh=2x4``
    — so one fleet DB serves single-device and mesh plans side by side.
    ``phase`` ('prefill'/'decode') qualifies serving-phase ladders the
    same way — conceptually ``matmul@phase=decode`` — so the decode
    runner's skinny ``M=batch`` GEMMs rank their own ladder instead of
    inheriting the compute-bound prefill winner for the same shape.  A
    ``None`` phase is omitted from the hashed payload entirely, keeping
    every pre-phase key byte-identical (the golden fixtures pin this).
    ``epilogue`` (``codegen.Epilogue.kind``) qualifies a ladder measured
    under an epilogue on the card (the fused ring's or tc32's epilogue
    mode, a body of its own), which only a lookup under that epilogue
    finds; omitted when None, by the same rule.
    ``version`` is overridable only so ``PlanDB.get`` can probe whether a
    miss is really a stale-format entry (a *version* miss)."""
    extra: Dict[str, Any] = {"what": "search.plan", "v": version, "mesh": mesh}
    if phase is not None:
        extra["phase"] = phase
    if epilogue is not None:
        extra["epilogue"] = epilogue
    return cache_key(
        spec,
        dtype=dtype_name(dtype),
        hardware=hardware,
        extra=extra,
    )


#: the serving phase the *calling context* is executing under — consulted
#: by ``ops._tuned_kernel`` at dispatch time so the same GEMM shape resolves
#: to its phase-qualified ladder inside a prefill vs a decode runner.
#: contextvars (not a bare global) so threaded gateways each see their own
#: phase.
_ACTIVE_PHASE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "repro_torch_serving_phase", default=None
)


def active_phase() -> Optional[str]:
    """The serving phase tag of the current context, or None."""
    return _ACTIVE_PHASE.get()


@contextlib.contextmanager
def serving_phase(phase: Optional[str]) -> Iterator[None]:
    """Scope a serving phase ('prefill'/'decode') over kernel dispatch.

    Entered by the serving runners around their steps; while
    active, ``ops._tuned_kernel`` consults the phase-qualified plan key
    first and falls back to the unphased ladder on a miss.
    """
    tok = _ACTIVE_PHASE.set(phase)
    try:
        yield
    finally:
        _ACTIVE_PHASE.reset(tok)


def grad_plan_keys(
    spec: ContractionSpec,
    dtype: Any,
    hardware: Optional[str] = None,
    mesh: Optional[str] = None,
) -> Dict[str, str]:
    """Plan keys of a forward spec's derived backward specs.

    ``{operand -> key}`` for each cotangent GEMM (``grad.derive``): the
    keys ``ops``'s custom VJPs look up at training time, and the ones a
    ``--with-grads`` sweep fills.  Disjoint from the forward key because
    ``spec_signature`` includes the derived spec's name and structure.
    """
    from ..grad import derived_specs

    return {
        wrt: plan_key(d, dtype, hardware, mesh=mesh)
        for wrt, d in derived_specs(spec).items()
    }


class PlanDB:
    """Ranked schedules per (spec, dtype, hardware)."""

    def __init__(self, path: str):
        self._cache = AutotuneCache(path)
        self._cache.metrics_prefix = "plandb"  # obs: plandb.hit/.miss

    @property
    def path(self) -> str:
        return self._cache.path

    @property
    def lookup_hits(self) -> int:
        """Successful plan lookups so far — the supported counter for
        benches/tests asserting that ops consulted the DB."""
        return self._cache.hits

    def put(
        self,
        spec: ContractionSpec,
        dtype: Any,
        ranked: List[Dict[str, Any]],
        stats: Optional[Dict[str, int]] = None,
        hardware: Optional[str] = None,
        mesh: Optional[str] = None,
        cuts: Optional[List[Dict[str, Any]]] = None,
        phase: Optional[str] = None,
        epilogue: Optional[str] = None,
    ) -> str:
        """Store ranked entries (best first). Each entry must carry a
        ``schedule`` dict from ``schedule_to_dict``; score/measured_s/
        lower_bound/collective/source/explain ride along verbatim.
        ``mesh`` is the shape descriptor ('2x4') for a mesh-tier sweep,
        None for single-device ladders; ``phase`` tags a serving-phase
        ladder ('prefill'/'decode').  ``cuts`` is the bound-cut sample
        ``obs.explain`` shows as the why-not side of the table.  The
        entry records its own ``spec`` signature + ``dtype`` (since v3)
        so explain selectors can find it without recomputing keys;
        ``epilogue`` (``Epilogue.kind``) an epilogue ladder's, stored in
        the entry too."""
        key = plan_key(spec, dtype, hardware, mesh=mesh, phase=phase,
                       epilogue=epilogue)
        payload = {
            "v": PLAN_VERSION,
            "mesh": mesh,
            "spec": spec_signature(spec),
            "dtype": dtype_name(dtype),
            "ranked": ranked,
            "stats": stats or {},
            "cuts": cuts or [],
        }
        if phase is not None:
            payload["phase"] = phase
        if epilogue is not None:
            payload["epilogue"] = epilogue
        self._cache.put(key, payload)
        return key

    def get(
        self, spec: ContractionSpec, dtype: Any,
        hardware: Optional[str] = None,
        mesh: Optional[str] = None,
        phase: Optional[str] = None,
        epilogue: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        entry = self._cache.get(
            plan_key(spec, dtype, hardware, mesh=mesh, phase=phase,
                     epilogue=epilogue)
        )
        if entry is None and phase is None and epilogue is None:
            # classify the miss: an entry under an older PLAN_VERSION key
            # means the fleet DB predates a format bump (plans went cold
            # deliberately) rather than never having been swept — an
            # operator reading the metrics dump re-sweeps instead of
            # hunting a phantom sweep gap
            for old_v in range(1, PLAN_VERSION):
                if self._cache.contains(
                    plan_key(spec, dtype, hardware, mesh=mesh, version=old_v)
                ):
                    from ..obs import counter

                    counter("plandb.version_miss").inc()
                    break
        return entry

    def best_schedule(
        self, spec: ContractionSpec, dtype: Any,
        hardware: Optional[str] = None,
        mesh: Optional[str] = None,
        phase: Optional[str] = None,
    ) -> Optional[Schedule]:
        """The stored winner, deserialized and validated — or None.

        A corrupt or stale entry (e.g. an extent mismatch after a spec
        change) degrades to a miss, never an error: callers fall back to
        ``codegen.tune_schedule``.
        """
        sched, _ = self.best_entry(spec, dtype, hardware, mesh=mesh,
                                   phase=phase)
        return sched

    def best_entry(
        self, spec: ContractionSpec, dtype: Any,
        hardware: Optional[str] = None,
        mesh: Optional[str] = None,
        phase: Optional[str] = None,
        epilogue: Optional[str] = None,
    ) -> Tuple[Optional[Schedule], Dict[str, Any]]:
        """(winner schedule, its raw entry dict) — or (None, {}).

        The entry dict carries the plan metadata the schedule alone cannot
        (notably ``collective`` — the finishing-reduction strategy a
        mesh-sharded plan was measured with, for the mesh tier — and a
        card ladder's ``card``, the B1 or fused card plan
        ``ops._tuned_kernel`` compiles with).
        """
        entry = self.get(spec, dtype, hardware, mesh=mesh, phase=phase,
                         epilogue=epilogue)
        if not entry or not entry.get("ranked"):
            return None, {}
        try:
            rung = entry["ranked"][0]
            return schedule_from_dict(rung["schedule"], spec.root()), rung
        except Exception:
            return None, {}

    def best_sharded_entry(
        self, spec: ContractionSpec, dtype: Any,
        hardware: Optional[str] = None,
        mesh: Optional[str] = None,
    ) -> Tuple[Optional[Schedule], Dict[str, Any]]:
        """The best rung with ``mesh:*`` levels, or (None, {}).

        A mesh-qualified ladder keeps the single-rank plans as reference
        rungs (they often out-measure a sharded product, whose collective
        runs between launches), but a caller running *under a live mesh*
        wants the best plan that actually distributes.  This is the lookup
        ``ops._mesh_plan_kernel`` performs.
        """
        entry = self.get(spec, dtype, hardware, mesh=mesh)
        if not entry or not entry.get("ranked"):
            return None, {}
        from ..core.schedule import MESH_TIERS

        for rung in entry["ranked"]:
            try:
                sched = schedule_from_dict(rung["schedule"], spec.root())
            except Exception:
                continue
            if any(lvl.tier in MESH_TIERS for lvl in sched.levels):
                return sched, rung
        return None, {}

    def reload(self) -> None:
        """Re-read the DB file at the next lookup (another rank wrote
        it)."""
        self._cache.reload()

    def clear(self) -> None:
        self._cache.clear()


_default: Optional[PlanDB] = None


def default_plan_db() -> PlanDB:
    """Process-wide DB at $REPRO_PLAN_DB or ~/.cache/repro_torch/plans.json."""
    global _default
    path = os.environ.get("REPRO_PLAN_DB") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "plans.json"
    )
    if _default is None or _default.path != path:
        _default = PlanDB(path)
    return _default


def entry_from(
    schedule: Schedule,
    *,
    score: float,
    lower_bound: float,
    fits_vmem: bool,
    measured_s: Optional[float] = None,
    source: str = "search",
    collective: str = "",
    explain: Optional[Dict[str, Any]] = None,
    card: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One ranked rung.  ``explain`` carries the roofline terms the rank
    was decided from (``beam.CostEstimate``: compute_s/hbm_s/comm_s/
    penalty/seq_steps/shards).  ``card`` (``CardPlan.as_dict()``: body,
    tile_n, splits; or ``FusedPlan.as_dict()``: kernel, body, block,
    ctas) is the card plan a card ladder measured; it is written only
    when given, so a rung without one is the reference's JSON byte for
    byte."""
    out = {
        "schedule": schedule_to_dict(schedule),
        "score": float(score),
        "lower_bound": float(lower_bound),
        "fits_vmem": bool(fits_vmem),
        "measured_s": None if measured_s is None else float(measured_s),
        "source": source,
        "collective": collective,
        "explain": dict(explain or {}),
    }
    if card is not None:
        out["card"] = dict(card)
    return out
