"""Schedule selection for generated kernels, with the persistent cache.

A copy of the reference tuner: enumerate per-index block candidates
(pow2 divisors), rank them with the reference's analytic traffic model
(``_score`` over ``core.cost.TPU``), and persist the winner keyed by
spec+shapes+dtype+hardware (``codegen.cache``).  The candidates, the
scores and the key payload are the reference's, so the port picks the
same schedule for the same spec (``tests/test_torch_foundation.py``).

The model scores a TPU-style kernel that keeps whole reduce axes resident
and often picks a one-block grid; the CUDA kernel therefore takes its own
CTA grid and only the plan's shapes, never its blocking
(``codegen.cuda_gen``).

``measure_with=`` (operand arrays) times candidates before the winner is
stored, as the reference's does, under a key of its own (``"measured":
True``, and the hardware it was measured on, ``cache.measured_on``), so an
analytic entry never satisfies a measured request, nor a host-timed one a
card request.  On CPU arrays the analytic top-``keep`` schedules run the
kernel's plain version on the host clock (the reference's interpreter
role).  On CUDA tensors the schedules would all launch the same kernel,
so the tuner defers to the search: ``search.search_schedule`` on the
card, at ``topk=keep``, into the default plan DB (where ``ops`` reads the
winner's B1 tile plan).  Its ladder measures B1's tile plans where the
spec is a plain product and the default once where not; the entry keeps
the analytic winner's schedule with the ladder winner's ``measured_s``
and, where it has one, its ``card``.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.cost import TPU
from ..core.enumerate import ContractionSpec
from ..core.schedule import Schedule
from .cache import (
    AutotuneCache,
    cache_key,
    default_cache,
    dtype_itemsize,
    dtype_name,
    measured_on,
    schedule_from_dict,
    schedule_to_dict,
)
from .schedules import default_schedule

#: bumped when candidate generation or scoring changes
TUNER_VERSION = 2


def _pow2_divisors(extent: int, cap: int = 512, limit: int = 6) -> List[int]:
    """Pow2 divisors of extent up to cap, largest first, plus extent itself."""
    out = [extent]
    c = 1
    while c <= min(extent, cap):
        if extent % c == 0 and c != extent:
            out.append(c)
        c *= 2
    out.sort(reverse=True)
    return out[:limit]


def _score(
    spec: ContractionSpec,
    blocks: Dict[str, int],
    elem_bytes: int,
    hw: dict,
) -> Optional[float]:
    """HBM traffic (elements) of the generated kernel, or None if > VMEM.

    Each operand is re-fetched once per grid block of every *output* index
    it does not carry; reduce (seq) axes are VMEM-resident at full extent
    in generated kernels, so they count fully toward the budget.
    """
    extents = spec.extents
    n_blocks = {
        i: extents[i] // blocks[i] for i in spec.output
    }
    vmem = 0
    traffic = 0.0
    for name, axes in spec.operands.items():
        block_elems = 1
        for a in axes:
            block_elems *= blocks[a] if a in spec.output else extents[a]
        vmem += block_elems
        elems = math.prod(extents[a] for a in axes)
        trips = math.prod(
            n_blocks[i] for i in spec.output if i not in axes
        )
        traffic += elems * trips
    out_block = math.prod(blocks[i] for i in spec.output)
    vmem += 2 * out_block  # out tile + f32 accumulator
    traffic += math.prod(extents[i] for i in spec.output)
    if vmem * elem_bytes > hw["vmem_bytes"]:
        return None
    # MXU alignment nudges: innermost output axis wants multiples of lanes
    penalty = 1.0
    last = spec.output[-1]
    if blocks[last] % hw["mxu"][1] and blocks[last] != extents[last]:
        penalty *= 1.25
    if len(spec.output) >= 2:
        sub = spec.output[-2]
        if blocks[sub] % hw["sublane"] and blocks[sub] != extents[sub]:
            penalty *= 1.1
    return traffic * penalty


def _reduce_chunk(extent: int, cap: int = 512) -> int:
    """Seq-loop chunk for a reduce axis: largest pow2 divisor <= cap.

    Reduce blocks don't change HBM traffic in the generated kernel (the
    axis is VMEM-resident either way), so they are not enumerated — one
    heuristic chunk bounds the per-dot depth; extent itself (no seq
    level) when it is small or has no pow2 divisor under the cap.
    """
    if extent <= cap:
        return extent
    best = 0
    c = 1
    while c <= cap:
        if extent % c == 0:
            best = c
        c *= 2
    return best or extent


def candidate_blocks(
    spec: ContractionSpec, hw: dict = TPU, per_index: int = 6
) -> List[Dict[str, int]]:
    """Cross-product of pow2 MAP-index block candidates; batch-like dims
    pinned near 1, reduce indices fixed to their heuristic chunk."""
    choices: List[Tuple[str, List[int]]] = []
    whole = getattr(spec.root(), "whole_indices", ())
    for i in spec.indices:
        e = spec.extents[i]
        if i in whole:
            cands = [e]  # fused families keep these axes unblocked
        elif i not in spec.output:
            cands = [_reduce_chunk(e)]
        elif e <= hw["sublane"]:
            cands = [1, e] if e > 1 else [1]  # batch-like tiny dims
        else:
            cands = _pow2_divisors(e, limit=per_index)
        choices.append((i, cands))
    out = []
    for combo in itertools.product(*(c for _, c in choices)):
        out.append({i: b for (i, _), b in zip(choices, combo)})
    return out


def tune_schedule(
    spec: ContractionSpec,
    *,
    dtype=np.float32,
    hw: dict = TPU,
    cache: Optional[AutotuneCache] = None,
    measure_with: Optional[Dict[str, np.ndarray]] = None,
    keep: int = 3,
    use_default_cache: bool = True,
) -> Schedule:
    """Pick (and persist) a Schedule for ``spec``.

    Cache hit -> deserialize, no enumeration, no measurement.  Miss ->
    analytic search; if ``measure_with`` provides operand arrays (numpy
    or tensors, by operand name) the candidates are timed before the
    winner is stored (see the module docstring).  ``dtype`` is a
    ``torch.dtype``, a numpy dtype or its name.
    """
    from ..obs import span

    spec = spec.root()
    if cache is None and use_default_cache:
        cache = default_cache()
    elem = dtype_itemsize(dtype)
    device = None if measure_with is None else _device_of(spec, measure_with)
    key = cache_key(
        spec,
        dtype=dtype_name(dtype),
        hardware=None if device is None else measured_on(device),
        extra={
            "tuner": TUNER_VERSION,
            "keep": keep,
            # custom cost-model dicts must not hit the default's entries
            "hw": sorted(
                (k, v) for k, v in hw.items()
                if isinstance(v, (int, float))
            ),
            # an analytic-only winner must not satisfy a measured request
            "measured": measure_with is not None,
        },
    )
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return schedule_from_dict(hit["schedule"], spec)

    measured = {}
    with span("codegen.tune", spec=spec.name,
              measured=measure_with is not None):
        scored = []
        for blocks in candidate_blocks(spec, hw):
            s = _score(spec, blocks, elem, hw)
            if s is not None:
                steps = sum(  # tie-break: fewer seq steps win
                    spec.extents[i] // blocks[i]
                    for i in spec.indices
                    if i not in spec.output
                )
                scored.append((s, steps, tuple(sorted(blocks.items()))))
        if not scored:  # nothing fits VMEM: fall back to smallest blocks
            blocks = {
                i: (1 if i in spec.output else spec.extents[i])
                for i in spec.indices
            }
            scored = [(math.inf, 0, tuple(sorted(blocks.items())))]
        scored.sort()
        top = [dict(b) for _, _, b in scored[:keep]]
        best = top[0]
        if measure_with is not None:
            best, measured = _measured_pick(spec, top, measure_with, dtype,
                                            keep, device)

    schedule = default_schedule(spec, best)
    if cache is not None:
        entry = {
            "schedule": schedule_to_dict(schedule),
            "blocks": {k: int(v) for k, v in best.items()},
            "measured": measure_with is not None,
        }
        entry.update(measured)
        cache.put(key, entry)
    return schedule


def _device_of(spec: ContractionSpec, measure_with) -> str:
    """"cuda" where the operands are CUDA tensors, else "cpu"."""
    import torch

    return "cuda" if any(
        isinstance(measure_with[n], torch.Tensor) and measure_with[n].is_cuda
        for n in spec.operands) else "cpu"


def _measured_pick(spec: ContractionSpec, top: List[Dict[str, int]],
                   measure_with, dtype, keep: int, device: str):
    """(blocks, the entry's measured fields): the fastest of the analytic
    ``top`` on CPU arrays; on CUDA tensors the analytic winner's blocks
    with the card search's winner (``measured_s``, and ``card`` where it
    has a plan)."""
    from ..search import default_plan_db, measure_schedules, search_schedule

    arrays = {n: measure_with[n] for n in spec.operands}
    if device == "cpu":
        if len(top) == 1:
            return top[0], {}
        ms = measure_schedules(
            spec, [default_schedule(spec, b) for b in top], arrays=arrays,
            dtype=dtype, repeats=1, check=False)
        return top[min(range(len(ms)), key=lambda i: ms[i].seconds)], {}
    win = search_schedule(spec, dtype=dtype, topk=keep, arrays=arrays,
                          device=device, plan_db=default_plan_db()).best
    if win.measured_s is None:
        raise RuntimeError(f"{spec.name}: the card search measured nothing")
    out = {"measured_s": float(win.measured_s)}
    if win.card is not None:
        out["card"] = win.card.as_dict()
    return top[0], out
