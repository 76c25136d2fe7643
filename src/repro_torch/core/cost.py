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

Those two model the reference's machines: ``CPU_HIERARCHY`` is the
paper's laptop CPU and ``TPU`` the reference's accelerator.  ``TPU`` is
kept verbatim because ``codegen.tune._score`` and ``search.beam`` still
rank candidate schedules with it: the port must pick the same schedules as
the reference (``cache_key`` folds the dict's numeric items into every
autotune key, so the golden cache file only reads back if they are
byte-identical).

The card this package runs on has its own dict, ``H100``, and two models:

* ``h100_cost`` -- the counterpart of ``cpu_cost`` / ``tpu_cost`` for
  ``core.autotune.tune(cost_fn=...)``: a HoF variant run by
  ``core.execute`` costs its host einsum calls plus the device roofline;
* ``card_plan_cost`` -- one tile plan of B1's ring, narrow or tc32 body
  (``search.space.card_candidates``): waves of CTAs over the SMs, each
  CTA's share of the operations and operand bytes, and the split-K
  partials, with a lower bound beside the score as ``search.beam``'s
  ``CostEstimate`` has.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# H100 flavour
# ---------------------------------------------------------------------------

#: one H100 SXM (NVIDIA's data sheet: dense rates at the 700 W limit) and
#: one measured host constant
H100 = dict(
    sms=132,
    smem_per_block=232448,
    l2_bytes=50e6,
    hbm_bw=3.35e12,
    peak_bf16=989e12,
    peak_int8=1979e12,
    peak_fp8=1979e12,
    peak_tf32=495e12,
    #: f32 products in 3xTF32 (three TF32 products each), B1's tc32 body
    peak_3xtf32=495e12 / 3,
    #: the FMA pipes outside the tensor cores (f32); f64 takes the data
    #: sheet's f64 tensor-core rate, the same 67 TFLOP/s
    peak_f32=67e12,
    peak_f64=67e12,
    #: a 128-wide tile of B1's ring against a 256-wide one, the rate
    #: ``codegen.cuda_gen.ring_tiles`` counts it at (a model constant)
    ring_narrow_rate=0.85,
    #: host seconds of one ``core.execute`` einsum call on the card's
    #: machine: 48-60 us in Table 1's runs (``chip_smoke.py`` phase
    #: ``hof``; PERF.md section 6)
    host_call_s=60e-6,
)

#: peak rate key by element size in bytes (a HoF variant's operands)
_PEAK_BY_BYTES = {1: "peak_int8", 2: "peak_bf16", 4: "peak_f32",
                  8: "peak_f64"}


def einsum_calls(spec: ContractionSpec, order: Sequence[str],
                 vector_levels: int = 2) -> int:
    """Host einsum calls ``core.execute.execute_variant`` makes for
    ``order``: one a point of the loops above its ``vector_levels``
    innermost levels (every index lies on some operand, so each of those
    levels loops over its extent)."""
    cut = max(len(order) - vector_levels, 0)
    return math.prod(spec.extents[i] for i in order[:cut])


def h100_cost(
    spec: ContractionSpec,
    order: Sequence[str],
    elem_bytes: int = 8,
    hw: dict = H100,
) -> float:
    """Estimated seconds of a variant through ``core.execute`` on the card:
    ``einsum_calls`` x ``hw["host_call_s"]`` (the executor's loops run on
    the host, one launch an einsum) plus the device roofline, max(flops /
    peak, (operands + output) bytes / HBM rate), at the peak of
    ``elem_bytes``-byte elements (f64 by default: the paper's tables)."""
    views = _operand_views(spec)
    moved = sum(math.prod(spec.extents[i] for i in axes)
                for axes in views.values()) * elem_bytes
    peak = hw[_PEAK_BY_BYTES.get(elem_bytes, "peak_f32")]
    device = max(spec.flops() / peak, moved / hw["hbm_bw"])
    return einsum_calls(spec, order) * hw["host_call_s"] + device


#: B1's tile geometry by body: (rows of the product's M a CTA -- of N on
#: the narrow body --, K elements a step, CTAs resident on one SM).  They
#: are ``codegen.cuda_gen``'s ``RING_BM`` / ``RING_BK``, ``TC32_TILE`` /
#: ``TC32_BK`` and ``NARROW_PER_SM`` (``tests/test_torch_search.py``
#: holds them equal)
CARD_BODIES = {"ring": (128, 64, 1), "narrow": (128, 64, 2),
               "tc32": (128, 32, 1)}


class PlanCost(NamedTuple):
    """``card_plan_cost``'s answer, in seconds."""

    score: float
    lower_bound: float
    compute_s: float
    hbm_s: float
    waves: int


def card_plan_cost(body: str, plan, batch: int, m: int, n: int, k: int,
                   dtype: str = "bfloat16", hw: dict = H100) -> PlanCost:
    """Score one tile plan (``plan.tile_n``, ``plan.splits``) of B1's
    ``body`` for a (batch, M, K) @ (batch, K, N) product of ``dtype``
    ("bfloat16" or "float32") on the card.

    The grid is the body's tiles times the K splits; its CTAs run in
    waves over the card's slots (``sms`` x CTAs resident an SM).  Each CTA
    computes a full tile over its share of the K steps, padded tiles
    included, at a slot's share of the peak (a 128-wide ring tile at
    ``hw["ring_narrow_rate"]`` of it): the compute term is the waves times
    one CTA's time.  The bytes -- each operand read once (re-reads hit the
    L2), the output written once, and with a K split 4 bytes an output
    element a split written and read again
    (``codegen.cuda_gen.scratch_sizes``) -- stream at the HBM rate times
    the share of slots the grid fills (``ctas / (waves x slots)``): a grid
    of few CTAs cannot pull the card's bandwidth.  ``score`` = max(compute,
    bytes); ``lower_bound`` = max(compute, (operands + output) bytes / HBM
    rate) leaves out the fill and the partials, so it is never above the
    score, and never below the product's roofline."""
    rows, bk, per_sm = CARD_BODIES[body]
    elem = 4 if dtype == "float32" else 2
    peak = hw["peak_3xtf32"] if dtype == "float32" else hw["peak_bf16"]
    tile_n, splits = int(plan.tile_n), int(plan.splits)
    if body == "narrow":  # C^T = W^T x^T: 128 of N by tile_n tokens a CTA
        tiles = batch * -(-n // rows)
    elif body == "tc32":  # the same swap: 128 of N by tile_n of M a CTA
        tiles = batch * -(-m // tile_n) * -(-n // rows)
    else:
        tiles = batch * -(-m // rows) * -(-n // tile_n)
    nk = -(-k // bk)
    per = -(-nk // splits)
    ctas = tiles * splits
    slots = hw["sms"] * per_sm
    waves = -(-ctas // slots)
    rate = peak / slots
    if body == "ring" and tile_n == 128:
        rate *= hw["ring_narrow_rate"]
    compute_s = waves * (2.0 * rows * tile_n * per * bk) / rate
    moved = batch * (m * k + k * n + m * n) * elem
    split_bytes = 0 if splits == 1 else 2 * 4 * batch * m * n * splits
    fill = ctas / (waves * slots)
    hbm_s = (moved + split_bytes) / (hw["hbm_bw"] * fill)
    lower = max(compute_s, moved / hw["hbm_bw"])
    return PlanCost(max(compute_s, hbm_s), lower, compute_s, hbm_s, waves)
