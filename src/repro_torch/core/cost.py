"""Analytic cost models for HoF-nest variants — the paper's missing early-cut.

The paper enumerates variants and *measures* them all; its Future Work notes
an early-cut rule is needed for this to scale.  Two flavours, copied from
the reference:

* ``cpu_cost``  — a hierarchical cache-traffic model (classic reuse-level /
  working-set analysis) used to rank the paper's Table-1/2 permutations
  without running them;
* ``tpu_cost``  — a VMEM/HBM/MXU roofline flavour, with explicit penalties
  for MXU-misaligned innermost extents (multiples of (8, 128) wanted).

Both consume a ``ContractionSpec`` + loop order, i.e. they work on the same
objects the rewrite rules produce, so "enumerate -> cut -> lower" is a single
pipeline (see autotune.py).

They model the reference's machines, not the card this package runs on:
``CPU_HIERARCHY`` is the paper's laptop CPU and ``TPU`` the reference's
accelerator.  ``TPU`` is kept verbatim because ``codegen.tune._score`` still
ranks candidate schedules with it: the port must pick the same schedules
as the reference (``cache_key`` folds the dict's numeric items into every
autotune key, so the golden cache file only reads back if they are
byte-identical).  The CUDA kernels take their own CTA grid and ignore the
plan's blocking (``codegen.cuda_gen``).  A Hopper model beside them is
``ROADMAP.md`` queue A item 4b.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from .enumerate import ContractionSpec


@dataclasses.dataclass(frozen=True)
class CacheLevel:
    name: str
    capacity: int  # elements (we model in elements, not bytes)
    miss_cost: float  # relative cost per line fetched from beyond this level


#: a Core-i5-7300HQ-ish hierarchy, in 8-byte elements
CPU_HIERARCHY = (
    CacheLevel("L1", 32 * 1024 // 8, 1.0),
    CacheLevel("L2", 256 * 1024 // 8, 4.0),
    CacheLevel("L3", 3 * 1024 * 1024 // 8, 20.0),
    CacheLevel("DRAM", 1 << 62, 120.0),
)

LINE_ELEMS = 8  # 64-byte lines of float64


def _operand_views(spec: ContractionSpec) -> Dict[str, Tuple[str, ...]]:
    """Operands plus the output array 'OUT' (store traffic counts too)."""
    views = dict(spec.operands)
    views["OUT"] = spec.output
    return views


def _footprint(
    axes: Tuple[str, ...], resident: set, extents: Dict[str, int]
) -> int:
    return math.prod(extents[a] for a in axes if a in resident) or 1


def _lines(
    name: str,
    axes: Tuple[str, ...],
    resident: set,
    extents: Dict[str, int],
    canonical: Dict[str, Tuple[str, ...]],
    line: int,
) -> float:
    """Footprint in cache lines: contiguous innermost axis amortizes fetches."""
    fp = _footprint(axes, resident, extents)
    if not axes:
        return 1.0
    inner = canonical[name][-1]  # stride-1 axis in canonical storage
    if inner in resident:
        inner_e = min(extents[inner], fp)
        return fp / min(line, inner_e)
    return float(fp)


def cpu_cost(
    spec: ContractionSpec,
    order: Sequence[str],
    hierarchy: Sequence[CacheLevel] = CPU_HIERARCHY,
    line: int = LINE_ELEMS,
) -> float:
    """Total weighted line traffic across the cache hierarchy."""
    views = _operand_views(spec)
    canonical = dict(views)
    extents = spec.extents
    depth = {idx: k for k, idx in enumerate(order)}
    total = 0.0
    for lvl in hierarchy:
        # deepest loop level t such that the working set below t fits
        best_t = len(order)  # innermost only
        for t in range(len(order) + 1):
            resident = set(order[t:])
            ws = sum(
                _footprint(axes, resident, extents) for axes in views.values()
            )
            if ws <= lvl.capacity:
                best_t = t
                break
        resident = set(order[best_t:])
        miss_lines = 0.0
        for name, axes in views.items():
            trips = math.prod(
                extents[i]
                for i in order[:best_t]
                if i in axes
            ) or 1
            miss_lines += trips * _lines(
                name, axes, resident, extents, canonical, line
            )
        total += miss_lines * lvl.miss_cost
    return total


def rank_variants(
    spec: ContractionSpec,
    orders: Sequence[Sequence[str]],
    cost_fn=cpu_cost,
) -> List[Tuple[float, Tuple[str, ...]]]:
    scored = sorted(
        (cost_fn(spec, tuple(o)), tuple(o)) for o in orders
    )
    return scored


def early_cut(
    spec: ContractionSpec,
    orders: Sequence[Sequence[str]],
    keep: int = 4,
    cost_fn=cpu_cost,
) -> List[Tuple[str, ...]]:
    """The paper's future-work pruning rule: keep only the cheapest variants."""
    return [o for _, o in rank_variants(spec, orders, cost_fn)[:keep]]


# ---------------------------------------------------------------------------
# TPU flavour
# ---------------------------------------------------------------------------

#: the reference's v5e-like hardware model
TPU = dict(
    peak_flops=197e12,  # bf16
    hbm_bw=819e9,
    vmem_bytes=64 * 1024 * 1024,  # usable VMEM working budget
    ici_bw=50e9,  # per link
    mxu=(128, 128),
    sublane=8,
)


def tpu_cost(
    spec: ContractionSpec,
    order: Sequence[str],
    elem_bytes: int = 2,
    hw: dict = TPU,
) -> float:
    """Estimated step time (s): max(compute, HBM traffic) + alignment penalty.

    The resident set is the deepest loop suffix whose working set fits VMEM
    (the Pallas block); everything outside streams from HBM.
    """
    views = _operand_views(spec)
    extents = spec.extents
    cap = hw["vmem_bytes"] // elem_bytes
    best_t = len(order)
    for t in range(len(order) + 1):
        resident = set(order[t:])
        ws = sum(_footprint(a, resident, extents) for a in views.values())
        if ws <= cap:
            best_t = t
            break
    resident = set(order[best_t:])
    hbm_elems = 0.0
    for name, axes in views.items():
        trips = math.prod(e for i in order[:best_t] if i in axes for e in (extents[i],)) or 1
        hbm_elems += trips * _footprint(axes, resident, extents)
    hbm_time = hbm_elems * elem_bytes / hw["hbm_bw"]
    compute_time = spec.flops() / hw["peak_flops"]

    # alignment: the innermost map/rnz extents feed the MXU; penalize extents
    # that are not multiples of the (sublane, lane) tile.
    penalty = 1.0
    inner = [i for i in order[best_t:]]
    if inner:
        lane = extents[inner[-1]]
        if lane % hw["mxu"][1]:
            penalty *= 1.5
        if len(inner) >= 2 and extents[inner[-2]] % hw["sublane"]:
            penalty *= 1.2
    return max(compute_time, hbm_time) * penalty


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    chips: int,
    hw: dict = TPU,
) -> Dict[str, float]:
    """The three roofline terms (compute, memory, collective), in seconds."""
    return dict(
        compute_s=flops / (chips * hw["peak_flops"]),
        memory_s=hbm_bytes / (chips * hw["hbm_bw"]),
        collective_s=collective_bytes / (chips * hw["ici_bw"]),
    )
