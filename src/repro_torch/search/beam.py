"""Cost-guided beam search over the candidate space — the analytic early-cut.

The paper measures every enumerated variant and its Future Work asks for an
analytic rule that cuts the space before measurement.  This module is that
rule, structured as a beam search:

  state     = (loop order, block choice for a prefix of the root indices)
  extension = pick the next index's block/chunk from ``space.block_choices``
  score     = pessimistic analytic step time (roofline max(compute, HBM
              traffic) x alignment/VMEM penalties) with unassigned indices
              defaulted to whole-extent blocks
  bound     = the same roofline WITHOUT penalties — a true lower bound on
              the score of every completion of the state, because leaving
              an index whole minimizes trips for every operand

Two prune mechanisms, kept separate because they have different guarantees:

  * **bound cut** (sound): a state is dropped when its lower bound already
    exceeds the best *complete* candidate's score — no completion can win.
    Every such cut is recorded in ``SearchStats.bound_log`` and the
    invariant (bound >= best-at-prune) is property-tested in
    ``tests/test_torch_search.py``.
  * **beam trim** (heuristic): surviving states are ranked by score and only
    the best ``beam_width`` continue.  This is the configurable-width knob;
    with width >= |space| the search is exhaustive.

States are deduplicated by ``Candidate.canonical_key`` — SJT neighbours that
the exchange rules map to the same generated kernel collapse to one state.

Observability (``repro_torch.obs``): ``search_schedule`` wraps the phases in
``search.enumerate``/``search.beam``/``search.measure`` trace spans and
surfaces ``SearchStats`` through the metrics registry
(``search.candidates``/``search.pruned_bound``/``search.pruned_beam``...);
each ``CostEstimate``'s terms are persisted per plan-DB rung — the cost
model's working is part of the search's output, not a side effect.

``estimate``, ``beam_search`` and ``_greedy_complete`` are the reference's,
copied: they rank TPU-shaped schedules with the reference's ``TPU`` model,
so the analytic ladder equals the reference's.  On the card B1 runs its
own tiles whatever the schedule's blocks, so ``card_beam`` ranks what it
does run: the tile plans of ``space.card_candidates``, each scored by
``core.cost.card_plan_cost``, with the same two cuts (the sound bound cut
against the best plan's score, then the width trim).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.cost import TPU
from ..core.enumerate import ContractionSpec
from .space import (
    Candidate,
    MeshVariant,
    block_choices,
    local_extents,
    make_candidate,
)
from .space import mesh_variants as enumerate_mesh_variants


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Analytic roofline estimate for one candidate (seconds, per device)."""

    score: float          # pessimistic proxy for measurement: bound * penalty
    lower_bound: float    # max(compute, HBM, comm) — no penalties
    compute_s: float
    hbm_s: float
    fits_vmem: bool
    penalty: float
    seq_steps: int        # tie-break: fewer fori_loop steps win
    comm_s: float = 0.0   # exposed collective time (mesh-sharded reductions)
    shards: int = 1       # devices the candidate spreads over


def estimate(
    spec: ContractionSpec,
    order: Sequence[str],
    blocks: Dict[str, int],
    *,
    elem_bytes: int = 4,
    hw: dict = TPU,
    assigned: Optional[frozenset] = None,
    mesh: Optional[Dict[str, Tuple[str, int]]] = None,
    collective: str = "",
) -> CostEstimate:
    """Roofline cost of a (possibly partial) candidate, per device.

    ``blocks`` must cover every index (callers default unassigned indices to
    their whole *local* extent — the traffic-minimal choice, which is what
    makes ``lower_bound`` sound for partial states).  ``assigned`` restricts
    the alignment penalties to decided indices so a partial state is never
    penalized for a choice it has not made yet.

    With ``mesh`` the estimate is the per-device roofline: compute and HBM
    terms shrink by the shard counts (each device owns a local slice), and
    a sharded *reduce* index adds the communication term — the exposed
    link time of the finishing collective under the interconnect model of
    ``roofline.analysis`` (``psum`` = fully exposed all-reduce; ``ring`` =
    reduce-scatter pipelined behind compute + exposed all-gather).  The
    mesh assignment and collective are decided before any block choice, so
    the comm term is constant across a state's completions and the bound
    cut stays sound.
    """
    spec = spec.root()
    mesh = dict(mesh or {})
    extents = local_extents(spec, mesh)  # per-shard view
    shards = 1
    for _, n in mesh.values():
        shards *= n
    n_blocks = {i: extents[i] // blocks[i] for i in spec.output}
    vmem = 0
    traffic = 0.0
    for name, axes in spec.operands.items():
        block_elems = 1
        for a in axes:
            # reduce axes are VMEM-resident at full extent in generated
            # kernels (codegen.plan); only map blocking shrinks the block
            block_elems *= blocks[a] if a in spec.output else extents[a]
        vmem += block_elems
        elems = math.prod(extents[a] for a in axes)
        trips = math.prod(
            n_blocks[i] for i in spec.output if i not in axes
        )
        traffic += elems * trips
    out_block = math.prod(blocks[i] for i in spec.output)
    out_elems = math.prod(extents[i] for i in spec.output)

    # quantized specs stream operands at storage precision (1 byte) but
    # write the 4-byte accumulator/dequantized output — the whole point of
    # the precision tier.  Non-quant keeps the caller's elem_bytes on both
    # sides (expressions unchanged so existing scores stay bit-identical).
    quant = getattr(spec, "quant", None)
    if quant is None:
        out_elem_bytes = elem_bytes
        vmem_bytes = (vmem + 2 * out_block) * elem_bytes
        hbm_s = (traffic + out_elems) * elem_bytes / hw["hbm_bw"]
    else:
        from ..roofline.analysis import quant_byte_model

        op_b, out_elem_bytes = quant_byte_model(quant, elem_bytes)
        vmem_bytes = vmem * op_b + 2 * out_block * out_elem_bytes
        hbm_s = (
            traffic * op_b + out_elems * out_elem_bytes
        ) / hw["hbm_bw"]
    compute_s = spec.flops() / shards / hw["peak_flops"]

    # fused-family terms.  Both stay sound for the bound cut: unassigned
    # indices default to whole extents, which minimizes the attention
    # rescale term (t_steps = 1), and the grouped ragged-tail factor only
    # applies once the row-tile choice is actually decided.
    kind = getattr(spec, "fused_kind", "")
    if kind == "attention":
        from ..roofline.analysis import attention_rescale_seconds

        compute_s += attention_rescale_seconds(
            extents["h"], extents["s"], extents["e"],
            extents["t"] // blocks["t"],
            peak=hw["peak_flops"],
        )
    elif kind == "grouped_matmul" and "n" in (
        assigned if assigned is not None else frozenset(spec.indices)
    ):
        from ..roofline.analysis import grouped_tail_factor

        compute_s *= grouped_tail_factor(spec.group_sizes, blocks["n"])

    # communication: a mesh-sharded reduce index leaves every device with a
    # partial local output that a collective must finish
    comm_s = 0.0
    reduce_shards = 1
    for i, (_, n) in mesh.items():
        if i not in spec.output:
            reduce_shards *= n
    if reduce_shards > 1:
        from ..roofline.analysis import sharded_reduce_seconds

        out_bytes = out_elems * out_elem_bytes
        comm_s = sharded_reduce_seconds(
            out_bytes,
            reduce_shards,
            collective=collective or "psum",
            compute_s=compute_s,
            hw_ici_bw=hw.get("ici_bw", 50e9),
        )

    lower = max(hbm_s, compute_s, comm_s)
    fits = vmem_bytes <= hw["vmem_bytes"]

    decided = assigned if assigned is not None else frozenset(spec.indices)
    penalty = 1.0
    last = spec.output[-1]
    if last in decided and blocks[last] % hw["mxu"][1] and blocks[last] != extents[last]:
        penalty *= 1.25
    if len(spec.output) >= 2:
        sub = spec.output[-2]
        if sub in decided and blocks[sub] % hw["sublane"] and blocks[sub] != extents[sub]:
            penalty *= 1.1
    # grid-dim order: the fastest-varying grid dim should be the output's
    # contiguous axis so successive blocks write adjacent HBM lines
    grid = [
        i for i in order
        if i in spec.output and i in decided and blocks[i] < extents[i]
    ]
    if grid and blocks.get(last, extents[last]) < extents[last] and grid[-1] != last:
        penalty *= 1.05
    if not fits and decided == frozenset(spec.indices):
        penalty *= 8.0  # would spill on real hardware
    seq_steps = sum(
        extents[i] // blocks[i] for i in spec.indices if i not in spec.output
    )
    return CostEstimate(
        score=lower * penalty,
        lower_bound=lower,
        compute_s=compute_s,
        hbm_s=hbm_s,
        fits_vmem=fits,
        penalty=penalty,
        seq_steps=seq_steps,
        comm_s=comm_s,
        shards=shards,
    )


@dataclasses.dataclass
class SearchStats:
    """What the search did — surfaced in benches and the sweep CLI."""

    considered: int = 0     # states scored (after dedup)
    deduped: int = 0        # states collapsed by canonical_key
    pruned_bound: int = 0   # sound roofline cuts
    pruned_beam: int = 0    # heuristic width trims
    measured: int = 0       # candidates actually lowered + timed
    mesh_variants: int = 0  # mesh subdivisions enumerated (0 = no mesh)
    #: (canonical_key, lower_bound, best_complete_score_at_prune)
    bound_log: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list
    )

    def as_dict(self) -> Dict[str, int]:
        return {
            "considered": self.considered,
            "deduped": self.deduped,
            "pruned_bound": self.pruned_bound,
            "pruned_beam": self.pruned_beam,
            "measured": self.measured,
            "mesh_variants": self.mesh_variants,
        }


@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    candidate: Candidate
    cost: CostEstimate

    def sort_key(self):
        c = self.cost
        return (not c.fits_vmem, c.score, c.seq_steps, self.candidate.canonical_key())


def _greedy_complete(
    spec: ContractionSpec,
    order: Tuple[str, ...],
    choices: Dict[str, List[int]],
    elem_bytes: int,
    hw: dict,
    variant: MeshVariant = MeshVariant(),
) -> ScoredCandidate:
    """Cheapest single-path completion — seeds the bound cut with a real
    complete candidate before the beam has finished any."""
    mesh = variant.as_dict()
    blocks: Dict[str, int] = {}
    defaults = local_extents(spec, mesh)
    for index in spec.indices:
        best_b, best_s = None, None
        for b in choices[index]:
            trial = {**defaults, **blocks, index: b}
            est = estimate(
                spec, order, trial, elem_bytes=elem_bytes, hw=hw,
                assigned=frozenset(blocks) | {index},
                mesh=mesh, collective=variant.collective,
            )
            key = (not est.fits_vmem, est.score, est.seq_steps, b)
            if best_s is None or key < best_s:
                best_b, best_s = b, key
        blocks[index] = best_b
    cand = make_candidate(
        spec, order, blocks, mesh=mesh, collective=variant.collective
    )
    return ScoredCandidate(
        cand,
        estimate(
            spec, order, blocks, elem_bytes=elem_bytes, hw=hw,
            mesh=mesh, collective=variant.collective,
        ),
    )


def beam_search(
    spec: ContractionSpec,
    *,
    beam_width: int = 8,
    topk: int = 4,
    elem_bytes: int = 4,
    hw: dict = TPU,
    orders: Optional[Sequence[Sequence[str]]] = None,
    choices: Optional[Dict[str, List[int]]] = None,
    max_orders: int = 24,
    bound_slack: float = 1.25,
    stats: Optional[SearchStats] = None,
    mesh_shape: Optional[Sequence[int]] = None,
    mesh_variants: Optional[Sequence[MeshVariant]] = None,
) -> Tuple[List[ScoredCandidate], SearchStats]:
    """Enumerate-and-cut: returns the analytic top-``topk`` candidates.

    The survivors are ranked best-first by (fits-VMEM, score, seq steps);
    measurement of the survivors is ``measure.measure_schedules``'s job.

    ``bound_slack`` widens the sound cut: a state is dropped only when its
    lower bound exceeds ``slack x`` the best complete score, so candidates
    the analytic model ranks within ``slack`` of the proxy still reach
    measurement — the model is a napkin, the clock is the judge.

    With ``mesh_shape`` (or an explicit ``mesh_variants`` list) the search
    is joint over the mesh tier: every legal mesh subdivision ×collective
    (``space.mesh_variants``) seeds its own states, all competing in the
    same beam under the communication-aware per-device roofline.  The
    unsharded variant stays in the space, so a mesh that does not pay for
    its collectives loses to single-device on merit, not by fiat.
    """
    spec = spec.root()
    stats = stats if stats is not None else SearchStats()
    if orders is None:
        from .. import obs
        from .space import candidate_orders_counted

        with obs.span("search.enumerate", spec=spec.name):
            orders, visited = candidate_orders_counted(spec, max_orders)
        stats.deduped += max(visited - len(orders), 0)
    orders = [tuple(o) for o in orders]
    if mesh_variants is None:
        mesh_variants = enumerate_mesh_variants(spec, mesh_shape)
    variants: List[MeshVariant] = list(mesh_variants) or [MeshVariant()]
    stats.mesh_variants += sum(1 for v in variants if v.assignment)
    # per-variant block choices (and whole-extent defaults) range over the
    # per-shard local extents
    var_choices: List[Dict[str, List[int]]] = []
    var_defaults: List[Dict[str, int]] = []
    for v in variants:
        if v.assignment:
            var_choices.append(
                block_choices(spec, hw, mesh=v.as_dict())
            )
            var_defaults.append(local_extents(spec, v.as_dict()))
        else:
            var_choices.append(choices or block_choices(spec, hw))
            var_defaults.append({i: spec.extents[i] for i in spec.indices})

    best_complete: Optional[ScoredCandidate] = None
    best_sharded: Optional[ScoredCandidate] = None
    for vi, v in enumerate(variants):
        for order in orders[: max(1, min(2, len(orders)))]:
            g = _greedy_complete(
                spec, order, var_choices[vi], elem_bytes, hw, v
            )
            if best_complete is None or g.sort_key() < best_complete.sort_key():
                best_complete = g
            if v.assignment and (
                best_sharded is None or g.sort_key() < best_sharded.sort_key()
            ):
                best_sharded = g

    # state = (order, blocks-so-far, variant); one decision stage per root
    # index.  States never need mid-stage dedup: initial (order, variant)
    # pairs are distinct and blocks-so-far distinguish the rest; states
    # that converge (an index left whole) collapse at the final dedup below.
    states: List[Tuple[Tuple[str, ...], Dict[str, int], int]] = [
        (o, {}, vi) for vi in range(len(variants)) for o in orders
    ]
    decision_seq = spec.indices
    final: List[ScoredCandidate] = []
    for stage, index in enumerate(decision_seq):
        extended: List[
            Tuple[ScoredCandidate, Tuple[str, ...], Dict[str, int], int]
        ] = []
        complete_stage = stage == len(decision_seq) - 1
        for order, blocks, vi in states:
            v = variants[vi]
            mesh = v.as_dict()
            for b in var_choices[vi][index]:
                nb = {**blocks, index: b}
                assigned = frozenset(nb)
                full = {**var_defaults[vi], **nb}
                cand = make_candidate(
                    spec, order, full, mesh=mesh, collective=v.collective
                )
                est = estimate(
                    spec, order, full,
                    elem_bytes=elem_bytes, hw=hw, assigned=assigned,
                    mesh=mesh, collective=v.collective,
                )
                stats.considered += 1
                sc = ScoredCandidate(cand, est)
                if (
                    best_complete is not None
                    and not complete_stage
                    and est.lower_bound >= best_complete.cost.score * bound_slack
                ):
                    # sound cut: no completion can beat the best proxy
                    stats.pruned_bound += 1
                    stats.bound_log.append(
                        (cand.canonical_key(), est.lower_bound,
                         best_complete.cost.score)
                    )
                    continue
                if complete_stage:
                    if (
                        best_complete is None
                        or sc.sort_key() < best_complete.sort_key()
                    ):
                        best_complete = sc
                    if v.assignment and (
                        best_sharded is None
                        or sc.sort_key() < best_sharded.sort_key()
                    ):
                        best_sharded = sc
                extended.append((sc, order, nb, vi))
        extended.sort(key=lambda t: t[0].sort_key())
        if len(extended) > beam_width:
            stats.pruned_beam += len(extended) - beam_width
            extended = extended[:beam_width]
        states = [(order, blocks, vi) for _, order, blocks, vi in extended]
        if complete_stage:
            final = [sc for sc, _, _, _ in extended]

    if best_complete is not None:
        # the greedy seed (or a completion the trim later dropped) is a real
        # candidate — keep it in the ranking; dedup collapses repeats
        final = list(final) + [best_complete]

    ranked: List[ScoredCandidate] = sorted(final, key=lambda s: s.sort_key())
    # dedup complete candidates by canonical key (orders can converge)
    out: List[ScoredCandidate] = []
    seen_keys = set()
    for sc in ranked:
        k = sc.candidate.canonical_key()
        if k in seen_keys:
            stats.deduped += 1
            continue
        seen_keys.add(k)
        out.append(sc)
        if len(out) >= topk:
            break
    # a mesh search must surface at least one sharded plan: if the beam's
    # topk is all-unsharded (tiny problems on the analytic model), the best
    # sharded complete candidate rides along so measurement and the plan DB
    # still cover the mesh tier
    if best_sharded is not None and not any(
        sc.candidate.mesh for sc in out
    ):
        key = best_sharded.candidate.canonical_key()
        if key not in seen_keys:
            out.append(best_sharded)
    return out, stats


def card_beam(
    plans: Sequence,
    batch: int,
    m: int,
    n: int,
    k: int,
    dtype: str = "bfloat16",
    *,
    beam_width: int = 8,
    topk: int = 4,
    bound_slack: float = 1.25,
    heuristic=None,
    stats: Optional[SearchStats] = None,
) -> Tuple[List[Tuple[object, object]], SearchStats]:
    """Rank B1 tile plans (``space.card_candidates``) for a (batch, M, K) @
    (batch, K, N) product of ``dtype`` by ``core.cost.card_plan_cost``.

    Returns ``[(CardPlan, PlanCost)]``, best first: the top ``topk`` of the
    plans that survive the bound cut (a plan whose lower bound is at least
    ``bound_slack`` x the best plan's score cannot win) and the width trim
    (the best ``beam_width`` by score), then ``heuristic`` (the launcher's
    own plan, the search's baseline) where it is not among them.  Ties
    fall to fewer splits, then the narrower tile."""
    from ..core.cost import card_plan_cost

    stats = stats if stats is not None else SearchStats()
    scored = [(p, card_plan_cost(p.body, p, batch, m, n, k, dtype))
              for p in plans]
    stats.considered += len(scored)
    if not scored:
        return [], stats
    best = min(c.score for _, c in scored)
    kept = []
    for p, c in scored:
        if c.lower_bound >= best * bound_slack:
            stats.pruned_bound += 1
            stats.bound_log.append((repr(tuple(p)), c.lower_bound, best))
        else:
            kept.append((p, c))
    kept.sort(key=lambda t: (t[1].score, t[0].splits, t[0].tile_n))
    if len(kept) > beam_width:
        stats.pruned_beam += len(kept) - beam_width
        kept = kept[:beam_width]
    out = kept[:topk]
    if heuristic is not None and all(p != heuristic for p, _ in out):
        out.append((heuristic, card_plan_cost(heuristic.body, heuristic,
                                              batch, m, n, k, dtype)))
    return out, stats
