"""Plan-DB lookup and serving-phase scoping (the search itself comes later).

``ops.dense`` asks ``default_plan_db()`` for a measured winner before it
falls back to the analytic tuner; the serving runners scope their steps
with ``serving_phase`` so the phase-qualified ladder is consulted first.
"""

from .plandb import (
    PLAN_VERSION,
    PlanDB,
    active_phase,
    default_plan_db,
    plan_key,
    serving_phase,
)

__all__ = [
    "PLAN_VERSION",
    "PlanDB",
    "active_phase",
    "default_plan_db",
    "plan_key",
    "serving_phase",
]
