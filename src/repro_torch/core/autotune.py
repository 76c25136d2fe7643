"""Autotuning: enumerate variants, early-cut with the cost model, pick one.

This is the paper's §4 pipeline made automatic:
  1. enumerate HoF orderings (SJT) and subdivision factors,
  2. rank with the analytic cost model (the early-cut rule the paper's
     Future Work calls for),
  3. (optionally) measure the survivors with ``execute.execute_variant``,
  4. return the survivors, best first.

The module also holds ``choose_matmul_blocks``, the block shapes of the
hand-written blocked kernels, scored over the port's copy of the
reference's ``TPU`` dict (``core.cost``), so it picks the reference's
blocks.  The hand-written CUDA kernels (``kernels/*``,
``codegen/csrc/baselines.cu``) check that the blocks divide the extents, as
the reference asserts, but tile by their own CTA tiles.

Both halves are the reference's.  ``tune`` measures on the operands'
device: with CUDA tensors in ``measure_with`` it synchronizes their device
before each timing starts and after each call, so the host clock covers
the work and not only its enqueue.  Its cache key (``_tune_cache_key``)
is the reference's payload with two differences: the cost function is
named by its own module path (``repro_torch.core.cost:cpu_cost``), and
``cache_key`` fingerprints the hardware as the port does (``cuda/<card>``
or ``cpu``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .cost import TPU, cpu_cost, rank_variants
from .enumerate import ContractionSpec, variant_orders
from .execute import execute_variant


@dataclasses.dataclass
class TunedVariant:
    order: Tuple[str, ...]
    spec: ContractionSpec
    predicted_cost: float
    measured_s: Optional[float] = None


def enumerate_subdivided(
    spec: ContractionSpec,
    subdiv_candidates: Dict[str, Sequence[int]],
) -> List[ContractionSpec]:
    """spec plus every single- and double-index subdivision combination."""
    specs = [spec]
    idxs = list(subdiv_candidates)
    for i, idx in enumerate(idxs):
        for b in subdiv_candidates[idx]:
            if spec.extents[idx] % b:
                continue
            s1 = spec.subdivide(idx, b)
            specs.append(s1)
            for idx2 in idxs[i + 1 :]:
                for b2 in subdiv_candidates[idx2]:
                    if s1.extents[idx2] % b2:
                        continue
                    specs.append(s1.subdivide(idx2, b2))
    return specs


def _tune_cache_key(spec, subdiv_candidates, cost_fn, keep, measure_with):
    """NB: cost_fn is identified by module+qualname — pass a NAMED function
    when caching; two lambdas defined at the same spot would collide."""
    from ..codegen.cache import cache_key, dtype_name

    return cache_key(
        spec,
        extra={
            "what": "tune.variants",
            "subdiv": {
                k: sorted(int(b) for b in v)
                for k, v in (subdiv_candidates or {}).items()
            },
            "cost_fn": (
                getattr(cost_fn, "__module__", "")
                + ":"
                + getattr(
                    cost_fn, "__qualname__",
                    getattr(cost_fn, "__name__", repr(cost_fn)),
                )
            ),
            "keep": keep,
            "measured": measure_with is not None
            and {
                k: [list(a.shape), dtype_name(a.dtype)]
                for k, a in measure_with.items()
            },
        },
    )


def _variants_to_json(survivors: List[TunedVariant]) -> list:
    return [
        {
            "order": list(tv.order),
            "splits": [[i, int(b)] for i, b in tv.spec.split_chain()],
            "predicted": float(tv.predicted_cost),
            "measured": tv.measured_s,
        }
        for tv in survivors
    ]


def _variants_from_json(data: list, root: ContractionSpec) -> List[TunedVariant]:
    out = []
    for d in data:
        s = root.root()
        for index, b in d["splits"]:
            s = s.subdivide(index, b)
        out.append(
            TunedVariant(
                tuple(d["order"]), s, d["predicted"], d.get("measured")
            )
        )
    return out


def _synchronizer(arrays: Dict[str, torch.Tensor]) -> Callable[[], None]:
    """Waits for the card that holds ``arrays``' CUDA tensors, if any."""
    devices = {a.device for a in arrays.values()
               if isinstance(a, torch.Tensor) and a.is_cuda}

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    return sync


def tune(
    spec: ContractionSpec,
    subdiv_candidates: Optional[Dict[str, Sequence[int]]] = None,
    cost_fn: Callable = cpu_cost,
    keep: int = 4,
    measure_with: Optional[Dict[str, torch.Tensor]] = None,
    repeats: int = 3,
    cache=None,
) -> List[TunedVariant]:
    """Full enumerate -> cut -> (measure) pipeline; best variant first.

    ``cache`` (a ``codegen.cache.AutotuneCache``) persists the survivor
    list keyed by spec + subdiv candidates + cost model + measurement
    shapes: a repeated call — in this process or any later one — returns
    the stored ranking without re-enumerating or re-measuring.
    """
    if cache is not None:
        key = _tune_cache_key(spec, subdiv_candidates, cost_fn, keep, measure_with)
        hit = cache.get(key)
        if hit is not None:
            return _variants_from_json(hit, spec)
    specs = (
        enumerate_subdivided(spec, subdiv_candidates)
        if subdiv_candidates
        else [spec]
    )
    pool: List[TunedVariant] = []
    for s in specs:
        for cost, order in rank_variants(s, variant_orders(s), cost_fn):
            pool.append(TunedVariant(order, s, cost))
    pool.sort(key=lambda tv: tv.predicted_cost)
    survivors = pool[:keep]
    if measure_with is not None:
        sync = _synchronizer(measure_with)
        for tv in survivors:
            best = math.inf
            for _ in range(repeats):
                sync()
                t0 = time.perf_counter()
                execute_variant(tv.spec, tv.order, measure_with)
                sync()
                best = min(best, time.perf_counter() - t0)
            tv.measured_s = best
        survivors.sort(key=lambda tv: tv.measured_s)
    if cache is not None:
        cache.put(key, _variants_to_json(survivors))
    return survivors


# ---------------------------------------------------------------------------
# block-shape selection for the hand-written blocked kernels
# ---------------------------------------------------------------------------


def choose_matmul_blocks(
    m: int,
    n: int,
    k: int,
    elem_bytes: int = 2,
    hw: dict = TPU,
    double_buffer: bool = True,
) -> Tuple[int, int, int]:
    """(block_m, block_n, block_k) minimizing HBM traffic under VMEM.

    Napkin model (the TPU analogue of the paper's cache reasoning):
      traffic = M*K * (N/bn)  +  K*N * (M/bm)  +  M*N
    so we maximize bm, bn subject to
      (bm*bk + bk*bn + bm*bn) * elem * (2 if double_buffer) <= VMEM
    with every extent a multiple of the MXU tile where possible.
    """
    budget = hw["vmem_bytes"] // (2 if double_buffer else 1) // elem_bytes

    def aligned(align: int, size: int, cap: int = 1024) -> List[int]:
        """Divisors of ``size`` that are pow2 multiples of ``align``."""
        outs, c = [], align
        while c <= min(size, cap):
            if size % c == 0:
                outs.append(c)
            c *= 2
        return outs or [size]

    best, best_score = None, None
    for bm in aligned(8, m):
        for bn in aligned(128, n):
            for bk in aligned(128, k):
                if bm * bk + bk * bn + bm * bn > budget:
                    continue
                traffic = m * k * (n / bn) + k * n * (m / bm) + m * n
                # prefer deeper k-blocks on ties (fewer grid steps)
                score = (traffic, -bk, -(bm * bn))
                if best is None or score < best_score:
                    best, best_score = (bm, bn, bk), score
    if best is None:  # tiny problem: single block
        best = (m, n, k)
    return best
