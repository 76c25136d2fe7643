"""repro_torch.search — cost-guided variant search, rewrite rules to measured
kernels.

``search_schedule`` chains the pieces end to end, as the reference's does:

    ContractionSpec + shapes
      │  space.candidate_orders      SJT walk, deduped by lowering identity
      │  space.block_choices         subdivision choices per hierarchy tier
      ▼
    beam.beam_search                 analytic roofline prune (sound bound
      │                              cut + configurable-width beam trim)
      ▼
    measure.measure_schedules        top-K compiled via codegen, checked
      │                              against the f64 oracle and timed
      ▼
    plandb.PlanDB                    ranked plans persisted next to the
                                     autotune cache; ops.dense asks here
                                     before falling back to tune_schedule

On CPU tensors (``device="cpu"``, the default where no card is
visible) the ladder is the reference's: the ``TPU``-scored beam's schedules plus the default, timed
through the kernel's plain version on the host clock (the reference's
interpret-mode role), persisted with the same fields.

On the card (``device="cuda"``) B1 ignores a schedule's blocks, so timing
several schedules would time one kernel several times.  What a launch runs
is its body's tile plan (``codegen.cuda_gen.CardPlan``), so a card ladder
pairs the analytic winner's ``Schedule`` (kept for parity) with the top
``topk`` plans of ``space.card_candidates`` ranked by
``core.cost.card_plan_cost`` (``beam.card_beam``), plus the launcher's own
heuristic plan in the reference's ``source="default"`` role: the measured
winner is by construction never slower than the heuristic on the
measurement harness, and displaces it only by beating its median by more
than the larger of the two rungs' interquartile ranges (a smaller gap is
a tie, which keeps the heuristic), and then again in a second timing of
the two alone.  Every measured candidate differs in what B1
launches.  The fused families take their kernels' card plans
(``codegen.fused_gen.FusedPlan``): an attention spec B2's KV block and
the ring's persistent CTA count (or the 3xTF32 body's KV block), a
grouped spec's forward and ``.dX`` B3's M tile, its ``.dW`` B4's tile
width and CTA count -- the card's stand-ins for the reference's ``bt``,
``bm`` and ``bn`` (``space.fused_card_candidates``).  Their lists are
short (six at most), so the ladder pairs the analytic winner's
``Schedule`` with every one of them, no cost model ranking them first,
the launcher's own plan (``space.fused_heuristic_plan``) in the default
role, under the same rule.  The rungs carry their plan (``card``), and
``ops._tuned_kernel`` compiles the winner's.  B1's other modes rank
their own plans the same way: the weighted family's k-scale, multiplier
and row reduce over ``space.card_candidates`` as a plain product does; a
product under an epilogue (``search_schedule(epilogue=)``, the fused
ring's epilogue mode) likewise, into a ladder of its own key; the 8-bit
ring (the int8 and fp8 tiers, under the dequant epilogue
``ops.dense(quant=)`` launches them with, and the 8-bit weighted modes)
its grid (``codegen.modes.Q8Plan``, ``space.q8_card_candidates``);
the chain its association and cluster (``codegen.modes.ChainPlan``,
``space.chain_card_candidates``) -- those two lists short, every plan
measured.  The bodies without a plan (mma.sync, FMA, upcast) keep one
rung, their default, measured once.  A card ladder persists under
the card's hardware fingerprint (``cuda/<device name>``), a ladder timed
on the host of that machine under ``cpu`` (``codegen.cache.measured_on``).

``ops.dense`` & friends consult ``default_plan_db()`` first, so one offline
sweep (``python -m repro_torch.search.sweep``) or one ``serve
--search-gemms`` warmup upgrades every later call for the same
spec/shape/dtype.  With ``--with-grads`` (or ``search_schedule_with_grads``)
the sweep also covers the derived backward specs of ``repro_torch.grad``.
``mesh_shape`` ('2x4') extends a search to the mesh tier, as in the
reference: mesh subdivisions x collective strategies join the beam under
the communication-aware cost, a "mesh-naive" baseline rides through
measurement, and the ladder persists under the mesh-qualified key that
``ops._mesh_plan_kernel`` consults under an active mesh.  Sharded
candidates are measured through ``codegen.bind_mesh`` over the world's
ranks (``measure.mesh_for_schedules``); a process that cannot host the
mesh keeps them on their analytic rank behind the measured single-rank
plans.  In a world of several ranks every rank runs the same search: each
times every candidate, the ranks take each time's maximum over the world
(one ``all_reduce(MAX)``), so they rank the ladder alike, and only rank 0
writes the plan DB, behind a barrier after which the others re-read it.
A mesh ladder is measured on the host clock on the card too (the
collectives run between launches), and its rungs carry no B1 tile plan:
each rank's local product runs the launcher's own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core.cost import TPU
from ..core.enumerate import (
    ContractionSpec,
    attention_spec,
    batched_matmul_spec,
    chain_matmul_spec,
    matmul_spec,
    matvec_spec,
    transposed_matmul_spec,
    uniform_grouped_spec,
    weighted_matmul_spec,
)
from ..core.schedule import Schedule
from .beam import (
    CostEstimate,
    ScoredCandidate,
    SearchStats,
    beam_search,
    card_beam,
    estimate,
)
from .measure import (
    Measurement,
    einsum_reference,
    measure_schedules,
    mesh_for_schedules,
    reference_arrays,
    schedule_mesh_axes,
)
from .plandb import (
    PLAN_VERSION,
    PlanDB,
    active_phase,
    default_plan_db,
    entry_from,
    grad_plan_keys,
    plan_key,
    serving_phase,
)
from .space import (
    QUANT_TIERS,
    Candidate,
    MeshVariant,
    block_choices,
    candidate_orders,
    candidate_schedule,
    card_candidates,
    chain_card_candidates,
    dtype_tier_specs,
    fused_card_candidates,
    fused_heuristic_plan,
    make_candidate,
    mesh_descriptor,
    mesh_variants,
    parse_mesh_shape,
    q8_card_candidates,
    sweep_specs,
)

#: spec families the sweep CLI / serve warmup can name; value = (ctor, arity)
SPEC_FAMILIES = {
    "matmul": (matmul_spec, 3),
    "matvec": (matvec_spec, 2),
    "weighted_matmul": (weighted_matmul_spec, 3),
    "batched_matmul": (batched_matmul_spec, 4),
    "chain_matmul": (chain_matmul_spec, 4),
    "transposed_matmul": (transposed_matmul_spec, 3),
    # fused families: attention takes (heads, q_seq, kv_seq, head_dim);
    # grouped_matmul takes (groups, rows_per_group, k, f) — the CLI's
    # uniform-partition entry into the ragged GroupedSpec
    "attention": (attention_spec, 4),
    "grouped_matmul": (uniform_grouped_spec, 4),
}


def spec_from_name(name: str, shape: Sequence[int]) -> ContractionSpec:
    if name not in SPEC_FAMILIES:
        raise ValueError(
            f"unknown spec {name!r}; choose from {sorted(SPEC_FAMILIES)}"
        )
    ctor, arity = SPEC_FAMILIES[name]
    if len(shape) != arity:
        raise ValueError(f"{name} takes {arity} extents, got {list(shape)}")
    return ctor(*shape)


@dataclasses.dataclass
class RankedPlan:
    """One rung of the search output ladder."""

    schedule: Schedule
    score: float
    lower_bound: float
    fits_vmem: bool
    measured_s: Optional[float] = None
    max_err: Optional[float] = None
    #: the interquartile range of a card rung's timed launches (seconds;
    #: ``Measurement.spread_s``); not persisted
    spread_s: Optional[float] = None
    source: str = "search"  # "default"/"mesh-naive" for baseline entries
    collective: str = ""    # finishing-collective strategy of a mesh plan
    #: roofline terms the rank was decided from (beam.CostEstimate:
    #: compute_s/hbm_s/comm_s/penalty/seq_steps/shards; a card rung
    #: core.cost.PlanCost's) — persisted into the plan DB
    explain: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: the B1 tile plan of a card rung (codegen.cuda_gen.CardPlan)
    card: Optional[object] = None

    @property
    def sharded(self) -> bool:
        return bool(schedule_mesh_axes(self.schedule))


@dataclasses.dataclass
class SearchResult:
    spec: ContractionSpec
    dtype: str
    ranked: List[RankedPlan]  # best first
    stats: SearchStats
    db_key: Optional[str] = None
    mesh: Optional[str] = None  # mesh descriptor ('2x4') of a mesh search

    @property
    def best(self) -> RankedPlan:
        return self.ranked[0]

    def baseline(self) -> Optional[RankedPlan]:
        for p in self.ranked:
            if p.source == "default":
                return p
        return None

    def mesh_baseline(self) -> Optional[RankedPlan]:
        """The naive-psum lowering of the best sharded subdivision."""
        for p in self.ranked:
            if p.source == "mesh-naive":
                return p
        return None

    def best_sharded(self) -> Optional[RankedPlan]:
        for p in self.ranked:
            if p.sharded:
                return p
        return None


def _multi_rank() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _agree(measured: List["RankedPlan"]) -> None:
    """Every rank's measured times (and spreads) replaced, in place, by
    their maxima over the world, so that every rank ranks alike."""
    from ..codegen.collectives import world_max

    if not measured or not _multi_rank():
        return
    n = len(measured)
    vals = world_max([p.measured_s for p in measured]
                     + [p.spread_s or 0.0 for p in measured])
    for p, t, sp in zip(measured, vals[:n], vals[n:]):
        p.measured_s = t
        if p.spread_s is not None:
            p.spread_s = sp


def _persist_once(plan_db, write) -> None:
    """``write()`` on rank 0 only; in a world of several ranks the others
    wait at a barrier and then re-read the DB."""
    if not _multi_rank():
        write()
        return
    import torch.distributed as dist

    if dist.get_rank() == 0:
        write()
    dist.barrier()
    if dist.get_rank() != 0:
        plan_db.reload()


def _ladder_from(cached: dict, spec: ContractionSpec) -> List[RankedPlan]:
    from ..codegen.fused_gen import plan_from_dict

    ranked = []
    for e in cached["ranked"]:
        try:
            sched = _sched_from(e["schedule"], spec)
        except Exception:
            continue
        ranked.append(
            RankedPlan(
                schedule=sched,
                score=e.get("score", float("inf")),
                lower_bound=e.get("lower_bound", 0.0),
                fits_vmem=e.get("fits_vmem", True),
                measured_s=e.get("measured_s"),
                source=e.get("source", "search"),
                collective=e.get("collective", ""),
                explain=dict(e.get("explain") or {}),
                card=plan_from_dict(e.get("card")),
            )
        )
    return ranked


def _card_ladder(spec, survivors, arrays, dt, beam_width, topk, device,
                 epilogue=None):
    """The card ladder of a B1 spec or a fused one: (plans, stats,
    tensors), or None for a dtype no kernel of the spec takes.  ``arrays``
    (numpy, placed on ``device``, or tensors, kept as given) default to
    ``reference_arrays``.

    * a product of f32 / bf16 operands (plain, under ``epilogue``, or the
      weighted family's k-scale, multiplier or row reduce): the analytic
      winner's schedule with each plan of ``beam.card_beam`` over
      ``space.card_candidates`` and the heuristic's;
    * 8-bit operands on the 8-bit ring (the int8 and fp8 tiers, and the
      8-bit weighted modes ``eight_bit_route`` sends there): every plan of
      ``space.q8_card_candidates``;
    * a chain: every plan of ``space.chain_card_candidates``;
    * a fused spec: ``_fused_card_ladder``.

    A body that takes no plan (mma.sync, FMA, upcast) gives the one rung
    of the heuristic, card None."""
    import torch

    from ..codegen import cuda_gen
    from ..codegen.cache import dtype_name
    from ..codegen.modes import Q8_HEURISTIC
    from ..codegen.schedules import default_schedule

    tdt = getattr(torch, dtype_name(dt))
    if getattr(spec, "fused_kind", ""):
        return _fused_card_ladder(spec, survivors, arrays, dt, device)
    eight = tdt.itemsize == 1
    if not eight and (getattr(spec.root(), "quant", None) is not None
                      or tdt not in (torch.float32, torch.bfloat16)):
        return None
    fold = cuda_gen._classify(spec.root())
    tensors = _card_tensors(spec, arrays, tdt, device)
    ops = [tensors[n] for n in spec.operands]
    sched = (survivors[0].candidate.to_schedule() if survivors
             else default_schedule(spec))
    stats = SearchStats()
    if fold.kind == "chain" or eight:
        if fold.kind == "chain":
            plans = chain_card_candidates(spec, ops[0].dtype)
            r, p, q, c = (spec.root().extents[i]
                          for i in cuda_gen.chain_extents(spec.root(), fold))
            heur = cuda_gen.chain_plan(r, p, q, c, ops[0].dtype)
        else:
            sms = (cuda_gen._sm_count(ops[0].device) if ops[0].is_cuda
                   else cuda_gen.H100_SMS)
            plans = q8_card_candidates(spec, *ops, sms=sms)
            heur = Q8_HEURISTIC
        stats.considered = len(plans)
        return _listed_ladder(plans, heur, sched), stats, tensors
    views = cuda_gen.card_views(spec, *ops, out_dtype=tdt, epilogue=epilogue)
    a3, b3 = views[:2]
    batch, m, k = a3.shape
    n = b3.shape[2]
    plans = card_candidates(spec, a3, b3, epilogue=epilogue is not None)
    if not plans:  # the mma.sync / FMA body: no plan, one measurement
        return _listed_ladder([], None, sched), stats, tensors
    kscale = fold.kind == "vector" and views[2].axis == 3
    heur = cuda_gen.heuristic_plan(
        plans[0].body, batch, m, n, k, cuda_gen._sm_count(a3.device)
        if a3.is_cuda else cuda_gen.H100_SMS, kscale=kscale,
        row_reduce=fold.kind == "row_reduce",
        narrow_x=(fold.kind == "gemm" and epilogue is None
                  and cuda_gen.tma_operand(a3, 2, 4)))
    scored, stats = card_beam(plans, batch, m, n, k, dtype_name(tdt),
                              beam_width=beam_width, topk=topk,
                              heuristic=heur, stats=stats)
    ladder = [
        RankedPlan(
            schedule=sched, score=cost.score, lower_bound=cost.lower_bound,
            fits_vmem=True, source="default" if plan == heur else "search",
            explain={"compute_s": float(cost.compute_s),
                     "hbm_s": float(cost.hbm_s), "waves": int(cost.waves)},
            card=plan,
        )
        for plan, cost in scored
    ]
    return ladder, stats, tensors


def _listed_ladder(plans, heur, sched) -> List[RankedPlan]:
    """A ladder measuring every plan of ``plans`` (a short list: no cost
    model ranks them first), ``heur`` in the ``source="default"`` role; a
    body with no plan the one default rung, card None."""
    return [
        RankedPlan(schedule=sched, score=float("inf"), lower_bound=0.0,
                   fits_vmem=True,
                   source="default" if plan == heur else "search",
                   card=plan)
        for plan in plans
    ] or [RankedPlan(schedule=sched, score=float("inf"), lower_bound=0.0,
                     fits_vmem=True, source="default")]


def _card_tensors(spec, arrays, tdt, device):
    """The operands a card ladder measures on: ``arrays`` (numpy, placed
    on ``device`` in ``tdt``, or tensors, kept as given), by default
    ``reference_arrays``; an 8-bit product's operands laid out k-major (its
    reduced index unit-stride), as ``ops.dense(quant=)`` writes its W for
    the 8-bit ring, which reads only K-major operands."""
    import torch

    from ..codegen import cuda_gen

    if arrays is None:
        arrays = reference_arrays(spec, dtype=tdt)
    root = spec.root()
    kmajor = (tdt.itemsize == 1
              and cuda_gen._classify(root).kind == "gemm")
    out = {}
    for n, a in arrays.items():
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a)).to(device).to(tdt)
            axes = root.operands[n]
            if kmajor and len(axes) == 2 and axes[0] not in root.output:
                a = a.t().contiguous().t()
        out[n] = a
    return out


def _fused_card_ladder(spec, survivors, arrays, dt, device):
    """The card ladder of a fused spec (attention; the grouped forward, dX
    and dW): (plans, stats, tensors) -- the analytic winner's schedule
    with each plan of ``space.fused_card_candidates`` (a dozen at most,
    so every one is measured: no cost model ranks them first), the
    heuristic's in the ``source="default"`` role; None for a dtype the
    kernels do not take.  A body with no plan (mma.sync, FMA) gives the
    one rung of the heuristic, card None."""
    import torch

    from ..codegen import cuda_gen
    from ..codegen.cache import dtype_name
    from ..codegen.schedules import default_schedule

    tdt = getattr(torch, dtype_name(dt))
    if tdt not in (torch.float32, torch.bfloat16):
        return None
    tensors = _card_tensors(spec, arrays, tdt, device)
    ops = [tensors[n] for n in spec.operands]
    sched = (survivors[0].candidate.to_schedule() if survivors
             else default_schedule(spec))
    sms = (cuda_gen._sm_count(ops[0].device) if ops[0].is_cuda
           else cuda_gen.H100_SMS)
    plans = fused_card_candidates(spec, *ops, sms=sms)
    heur = fused_heuristic_plan(spec, *ops, sms=sms)
    stats = SearchStats(considered=len(plans))
    return _listed_ladder(plans, heur, sched), stats, tensors


def _keep_heuristic_within_spread(plans: List[RankedPlan],
                                  retime=None) -> None:
    """On the card, move the heuristic's rung back to the front of a
    measured ladder (in place) unless the fastest rung's median beats it
    by more than the larger of their spreads (interquartile ranges): a
    plan that wins by less than the timing's own scatter is a tie, and a
    tie keeps the launcher's choice.  Where ``retime`` is given, a rung
    that wins must win again: ``retime(best, base)`` times the two afresh,
    in turns, and returns ``((seconds, spread), (seconds, spread))``, and
    the same rule is applied to those.  One timing can favour a plan by a
    slow spell of the card that fell on its rival's launches more than on
    its own, and the plan DB would keep that plan for every later call.
    The rungs keep the first timing's numbers.  Host-timed ladders carry
    no spread and keep their order."""
    if not plans or plans[0].source == "default":
        return
    base = next((p for p in plans if p.source == "default"), None)
    best = plans[0]
    if (base is None or base.measured_s is None or best.spread_s is None
            or base.spread_s is None):
        return
    gap = base.measured_s - best.measured_s
    spread = max(best.spread_s, base.spread_s)
    if gap > spread and retime is not None:
        (win_s, win_sp), (base_s, base_sp) = retime(best, base)
        gap, spread = base_s - win_s, max(win_sp, base_sp)
        obs.counter("search.confirm." + ("kept" if gap > spread
                                         else "reverted")).inc()
    if gap <= spread:
        plans.remove(base)
        plans.insert(0, base)


def _default_device(device: Optional[str]) -> str:
    """``device``, or the card where one is visible, else "cpu"."""
    if device is not None:
        return str(device)
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def search_schedule(
    spec: ContractionSpec,
    *,
    dtype=np.float32,
    beam_width: int = 8,
    topk: int = 4,
    elem_bytes: Optional[int] = None,
    hw: dict = TPU,
    measure: bool = True,
    interpret: bool = True,
    repeats: int = 2,
    arrays: Optional[Dict[str, np.ndarray]] = None,
    include_default: bool = True,
    plan_db: Optional[PlanDB] = None,
    use_cached_plan: bool = True,
    mesh_shape=None,
    phase: Optional[str] = None,
    device: Optional[str] = None,
    epilogue=None,
) -> SearchResult:
    """The end-to-end pipeline: enumerate -> prune -> measure -> persist.

    Returns the ranked ladder best-first.  When ``measure`` is on, the
    ranking is by measured seconds and — because ``include_default`` puts
    the un-searched ``codegen.default_schedule`` (on the card: the
    launcher's heuristic plan) into the measured set — the winner is by
    construction never slower than the default on the measurement harness
    used.  ``device`` places the operands: "cpu" (the reference's ladder,
    the plain version timed on the host) or "cuda" (the card ladder, see
    the package docstring); by default the card where one is visible.
    The ladder is keyed by where it was measured
    (``codegen.cache.measured_on``): on a machine with a card, a ladder
    timed on the host goes under ``cpu`` and one timed on the card under
    the card's fingerprint, so neither answers a search of the other.

    ``plan_db`` (or pass ``default_plan_db()``) persists the ladder;
    ``use_cached_plan`` short-circuits a repeated search of the same
    spec/dtype/hardware from the DB, except that an analytic-only
    (``measure=False``) ladder never satisfies a measured request.
    ``phase`` ('prefill'/'decode') persists the ladder under the
    serving-phase-qualified key (``plandb.plan_key(phase=...)``), the one
    the serving runners consult via ``plandb.serving_phase``.

    ``mesh_shape`` ('2x4' or (2, 4)) extends the search to the mesh tier:
    legal mesh subdivisions x collective strategies join the beam under
    the communication-aware cost (``beam.estimate``), the ladder always
    surfaces at least one ``mesh:*`` plan, and a "mesh-naive" baseline
    (the plain-psum, unblocked lowering of the best sharded subdivision)
    rides through measurement, so the searched sharded winner is by
    construction never slower than it.  Sharded candidates are measured
    over the world's ranks (the package docstring); where the process
    cannot host the mesh they keep their analytic rank behind the
    measured single-rank plans.  The ladder persists under the
    mesh-qualified plan key.

    ``epilogue`` (a ``codegen.Epilogue``: ``ops.dense_act``'s) searches
    the product under it on the card: a launch under an epilogue runs
    another body (the fused ring, tc32's epilogue mode) than the plain
    product, so its plans are measured there, every candidate compiled
    with the epilogue and held against the f64 oracle with it applied,
    and the ladder persists under the epilogue-qualified key
    (``plandb.plan_key(epilogue=)``), which only a lookup under the same
    epilogue finds.  Measured on the card only (a ``ValueError``
    elsewhere, or with ``mesh_shape``).
    """
    from ..codegen.cache import dtype_itemsize, dtype_name, measured_on

    spec = spec.root()
    epi = None if epilogue is None else epilogue.kind
    if epi is not None and (_default_device(device) == "cpu" or mesh_shape
                            or not measure):
        raise ValueError("an epilogue ladder is measured on the card, one "
                         "rank, and nowhere else")
    if isinstance(mesh_shape, str):
        mesh_shape = parse_mesh_shape(mesh_shape)
    mesh_desc = mesh_descriptor(mesh_shape)
    if mesh_desc is None:
        mesh_shape = None
    device = _default_device(device)
    hardware = measured_on(device)
    dt = dtype
    if elem_bytes is None:
        elem_bytes = dtype_itemsize(dt)

    if plan_db is not None and use_cached_plan:
        cached = plan_db.get(spec, dt, hardware, mesh=mesh_desc,
                             phase=phase, epilogue=epi)
        if (
            cached
            and cached.get("ranked")
            and measure
            and cached["ranked"][0].get("measured_s") is None
        ):
            # an analytic-only (--no-measure) ladder must not satisfy a
            # measured request: fall through and run the full pipeline
            cached = None
        if cached and cached.get("ranked"):
            ranked = _ladder_from(cached, spec)
            if ranked:
                stats = SearchStats()
                for k, v in (cached.get("stats") or {}).items():
                    if hasattr(stats, k):
                        setattr(stats, k, v)
                return SearchResult(
                    spec=spec, dtype=dtype_name(dt), ranked=ranked,
                    stats=stats,
                    db_key=plan_key(spec, dt, hardware, mesh=mesh_desc,
                                    phase=phase, epilogue=epi),
                    mesh=mesh_desc,
                )

    with obs.span("search.beam", spec=spec.name, mesh=mesh_desc):
        survivors, stats = beam_search(
            spec, beam_width=beam_width, topk=topk,
            elem_bytes=elem_bytes, hw=hw, mesh_shape=mesh_shape,
        )
    obs.counter("search.candidates").inc(stats.considered)
    obs.counter("search.pruned_bound").inc(stats.pruned_bound)
    obs.counter("search.pruned_beam").inc(stats.pruned_beam)
    obs.counter("search.mesh_variants").inc(stats.mesh_variants)
    plans: List[RankedPlan] = [
        RankedPlan(
            schedule=sc.candidate.to_schedule(),
            score=sc.cost.score,
            lower_bound=sc.cost.lower_bound,
            fits_vmem=sc.cost.fits_vmem,
            collective=sc.candidate.collective,
            explain=_explain_of(sc.cost),
        )
        for sc in survivors
    ]
    if include_default:
        from ..codegen import default_schedule

        base_sched = default_schedule(spec)
        base_dict = _sched_dict(base_sched)
        if not any(_sched_dict(p.schedule) == base_dict for p in plans):
            est = estimate(
                spec, spec.indices,
                {i: spec.extents[i] for i in spec.indices},
                elem_bytes=elem_bytes, hw=hw,
            )
            plans.append(
                RankedPlan(
                    schedule=base_sched,
                    score=est.score,
                    lower_bound=est.lower_bound,
                    fits_vmem=est.fits_vmem,
                    source="default",
                    explain=_explain_of(est),
                )
            )
        else:
            for p in plans:
                if _sched_dict(p.schedule) == base_dict:
                    p.source = "default"

    # mesh searches also measure the NAIVE lowering of the best sharded
    # subdivision — same mesh assignment, plain psum, no inner blocking —
    # so "searched-sharded never slower than naive psum" holds by
    # construction on the measurement harness (the mesh analogue of the
    # include_default guarantee)
    if mesh_shape is not None:
        best_sharded_sc = next(
            (sc for sc in survivors if sc.candidate.mesh), None
        )
        if best_sharded_sc is not None:
            naive_sched = candidate_schedule(
                spec, spec.indices, {},
                mesh=best_sharded_sc.candidate.mesh_dict,
            )
            naive_dict = _sched_dict(naive_sched)
            naive_hit = [
                p for p in plans
                if _sched_dict(p.schedule) == naive_dict
                and (p.collective or "psum") == "psum"
            ]
            if naive_hit:
                for p in naive_hit:
                    p.source = "mesh-naive"
            else:
                from .space import local_extents

                naive_mesh = best_sharded_sc.candidate.mesh_dict
                est = estimate(
                    spec, spec.indices,
                    local_extents(spec, naive_mesh),
                    elem_bytes=elem_bytes, hw=hw,
                    mesh=naive_mesh, collective="psum",
                )
                plans.append(
                    RankedPlan(
                        schedule=naive_sched,
                        score=est.score,
                        lower_bound=est.lower_bound,
                        fits_vmem=est.fits_vmem,
                        source="mesh-naive",
                        collective="psum",
                        explain=_explain_of(est),
                    )
                )

    on_card = device != "cpu"
    measured: List[RankedPlan] = []
    tensors = arrays
    mesh = None
    if measure and on_card and mesh_shape is None:
        card = _card_ladder(spec, survivors, arrays, dt, beam_width, topk,
                            device, epilogue)
        if card is not None:
            plans, stats, tensors = card
            measured = list(plans)
        else:
            # no card plan to search: one measurement of the default
            measured = [p for p in plans if p.source == "default"][:1]
    elif measure:
        import torch

        sharded = [p for p in plans if p.sharded]
        mesh = mesh_for_schedules([p.schedule for p in sharded],
                                  device=torch.device(device).type)
        if mesh is None and sharded:
            # the process cannot host the mesh: measure the single-rank
            # candidates, keep sharded ones on their analytic rank
            measured = [p for p in plans if not p.sharded]
        else:
            measured = list(plans)
    if measured:
        with obs.span("search.measure", spec=spec.name, n=len(measured)):
            ms = measure_schedules(
                spec, [p.schedule for p in measured],
                arrays=tensors, dtype=dt, interpret=interpret,
                repeats=repeats, device=device, mesh=mesh,
                collectives=[p.collective for p in measured],
                cards=[p.card for p in measured], epilogue=epilogue,
            )
        for p, m in zip(measured, ms):
            p.measured_s = m.seconds
            p.max_err = m.max_err
            p.spread_s = m.spread_s
        _agree(measured)
        stats.measured += len(ms)
        obs.counter("search.measured").inc(len(ms))
    if measure:
        plans.sort(
            key=lambda p: (
                p.measured_s is None,
                p.measured_s if p.measured_s is not None else p.score,
                p.score,
            )
        )
        retime = None
        if measured and on_card and mesh is None:

            def retime(best, base):
                again = measure_schedules(
                    spec, [best.schedule, base.schedule], arrays=tensors,
                    dtype=dt, device=device, check=False,
                    cards=[best.card, base.card], epilogue=epilogue)
                vals = [m.seconds for m in again] + [m.spread_s or 0.0
                                                     for m in again]
                if _multi_rank():  # every rank must keep the same plan
                    from ..codegen.collectives import world_max

                    vals = world_max(vals)
                return (vals[0], vals[2]), (vals[1], vals[3])

        _keep_heuristic_within_spread(plans, retime)
    else:
        plans.sort(key=lambda p: (not p.fits_vmem, p.score))

    result = SearchResult(
        spec=spec, dtype=dtype_name(dt), ranked=plans, stats=stats,
        mesh=mesh_desc,
    )
    if mesh_desc is not None:
        sharded_best = result.best_sharded()
        if sharded_best is not None:
            # which finishing collective won the mesh tier — the
            # ring-vs-psum pick, surfaced through obs
            obs.counter(
                f"search.collective.{sharded_best.collective or 'psum'}"
            ).inc()
    if plan_db is not None and plans:
        result.db_key = plan_key(spec, dt, hardware, mesh=mesh_desc,
                                 phase=phase, epilogue=epi)
        with obs.span("search.persist", spec=spec.name, mesh=mesh_desc):
            _persist_once(plan_db, lambda: plan_db.put(
                spec, dt,
                [
                    entry_from(
                        p.schedule,
                        score=p.score,
                        lower_bound=p.lower_bound,
                        fits_vmem=p.fits_vmem,
                        measured_s=p.measured_s,
                        source=p.source,
                        collective=p.collective,
                        explain=p.explain,
                        card=None if p.card is None else p.card.as_dict(),
                    )
                    for p in plans
                ],
                stats=stats.as_dict(),
                hardware=hardware,
                mesh=mesh_desc,
                cuts=[
                    {"key": k, "lower_bound": lb, "best_score": bs}
                    for k, lb, bs in stats.bound_log[:_MAX_CUTS]
                ],
                phase=phase,
                epilogue=epi,
            ))
    return result


#: bound-cut sample size persisted per entry — enough for the explain
#: table's why-not side without bloating the fleet DB on big sweeps
_MAX_CUTS = 12


def _explain_of(est: CostEstimate) -> Dict[str, float]:
    """The CostEstimate terms a plan-DB rung keeps (``explain`` field)."""
    return {
        "compute_s": float(est.compute_s),
        "hbm_s": float(est.hbm_s),
        "comm_s": float(est.comm_s),
        "penalty": float(est.penalty),
        "seq_steps": int(est.seq_steps),
        "shards": int(est.shards),
    }


def _sched_dict(s: Schedule) -> str:
    import json

    from ..codegen.cache import schedule_to_dict

    return json.dumps(schedule_to_dict(s), sort_keys=True)


def _sched_from(d, root: ContractionSpec) -> Schedule:
    from ..codegen.cache import schedule_from_dict

    return schedule_from_dict(d, root)


def search_schedule_with_grads(
    spec: ContractionSpec, **kwargs
) -> Dict[str, SearchResult]:
    """Sweep a forward spec together with its derived backward specs.

    Runs the full ``search_schedule`` pipeline once per point of
    ``space.sweep_specs(spec, with_grads=True)`` — the forward contraction
    plus every cotangent GEMM from ``grad.derive`` (dA = g·Bᵀ etc.), each
    persisted under its own plan key.  Returns ``{label -> SearchResult}``
    with labels ``fwd``, ``dA``, ``dB``, ...  On the card the backward
    specs are measured on the layouts the backward passes them in (the
    cotangent and the saved operands as stored), so ``.dB``'s ring may
    read an m-major x^T where the forward's reads x k-major.
    """
    return {
        label: search_schedule(s, **kwargs)
        for label, s in sweep_specs(spec, with_grads=True)
    }


def search_dtype_ladder(
    spec: ContractionSpec,
    *,
    dtype=np.float32,
    tiers: Sequence[str] = QUANT_TIERS,
    **kwargs,
) -> Dict[str, SearchResult]:
    """Search the dtype axis: the baseline tier plus each quant tier.

    Runs the full ``search_schedule`` pipeline once per point of
    ``space.dtype_tier_specs`` — the caller's spec at its full/half
    precision, then the int8 and fp8 re-taggings at their 1-byte storage
    dtypes.  Every tier persists under its own dtype-qualified plan key,
    so ``ops.dense(quant=...)`` picks up the matching ladder; on the card
    a quant tier is measured under ``quant_tier_epilogue``'s dequant, the
    launch that op makes.  Returns ``{tier -> SearchResult}`` with
    ``"baseline"`` always present; rank tiers against each other with
    ``best_dtype_tier``.
    """
    epi = quant_tier_epilogue(spec, kwargs.get("device"),
                              kwargs.get("measure", True),
                              kwargs.get("mesh_shape"))
    return {
        tier: search_schedule(
            s, dtype=dt, **kwargs,
            **({} if tier == "baseline" or epi is None
               else {"epilogue": epi}))
        for tier, s, dt in dtype_tier_specs(spec, dtype=dtype, tiers=tiers)
    }


def quant_tier_epilogue(spec: ContractionSpec, device=None,
                        measure: bool = True, mesh_shape=None):
    """The epilogue the quant tier of ``spec`` is measured under: for a
    two-operand product on the card (measured, one rank)
    ``Epilogue(dequant=True)``, the launch ``ops.dense(quant=)`` makes, so
    the ladder lives under that epilogue's key and the op's lookup under it
    finds the plan measured there; otherwise None (the reference's
    unqualified key)."""
    from ..codegen.epilogue import Epilogue

    if (len(spec.root().operands) != 2 or not measure or mesh_shape
            or _default_device(device) == "cpu"):
        return None
    return Epilogue(dequant=True)


def best_dtype_tier(results: Dict[str, SearchResult]) -> str:
    """The precision tier the roofline ranks fastest for this shape.

    Compared on the *analytic* score of each tier's best plan — the
    quant-aware byte model is exactly what distinguishes tiers (operand
    traffic shrinks 4x at matched shapes).  Accuracy policy stays with
    the caller; this only says what the hardware model prefers.
    """
    if not results:
        raise ValueError("no tiers searched")
    return min(
        results,
        key=lambda t: (
            not results[t].best.fits_vmem,
            results[t].best.score,
            t,
        ),
    )


def search_gemm_plans(
    shapes: Sequence[Tuple[int, int, int]],
    *,
    dtype=np.float32,
    beam_width: int = 8,
    topk: int = 3,
    interpret: bool = True,
    measure: bool = True,
    plan_db: Optional[PlanDB] = None,
    with_grads: bool = False,
    mesh_shape=None,
    phase: Optional[str] = None,
    device: Optional[str] = None,
) -> int:
    """Search + persist plans for (m, k, n) GEMMs; returns #plans readied.

    The serving analogue of ``ops.warm_dense_cache``: where warmup fills
    the autotune cache with the analytic pick, this runs the full
    enumerate->prune->measure pipeline and stores the ranked ladder, so
    ``ops.dense`` serves the *searched* plan from then on.  With
    ``with_grads`` each GEMM's derived backward specs are swept too (the
    count then includes them).  With ``phase`` the ladders persist under
    the serving-phase-qualified keys — how the prefill/decode runners each
    sweep their own ladder for the same shape family.  With ``mesh_shape``
    ('2x4') every point is additionally swept at the mesh tier, persisting
    sharded ladders under the mesh-qualified keys that
    ``ops._tuned_kernel`` consults when a matching mesh is active (the
    count includes those sweeps).  ``device`` as in ``search_schedule``.
    """
    db = plan_db if plan_db is not None else default_plan_db()
    n = 0
    for m, k, nn in shapes:
        spec = matmul_spec(m, k, nn)
        kw = dict(
            dtype=dtype, beam_width=beam_width, topk=topk,
            interpret=interpret, measure=measure, plan_db=db,
            phase=phase, device=device,
        )
        meshes = [None] + ([mesh_shape] if mesh_shape is not None else [])
        for ms in meshes:
            if with_grads:
                n += len(
                    search_schedule_with_grads(spec, mesh_shape=ms, **kw)
                )
            else:
                search_schedule(spec, mesh_shape=ms, **kw)
                n += 1
    return n


__all__ = [
    "Candidate",
    "CostEstimate",
    "Measurement",
    "MeshVariant",
    "PLAN_VERSION",
    "PlanDB",
    "RankedPlan",
    "ScoredCandidate",
    "SearchResult",
    "SearchStats",
    "SPEC_FAMILIES",
    "QUANT_TIERS",
    "active_phase",
    "beam_search",
    "best_dtype_tier",
    "block_choices",
    "candidate_orders",
    "candidate_schedule",
    "card_beam",
    "card_candidates",
    "default_plan_db",
    "dtype_tier_specs",
    "einsum_reference",
    "entry_from",
    "estimate",
    "grad_plan_keys",
    "make_candidate",
    "measure_schedules",
    "mesh_descriptor",
    "mesh_for_schedules",
    "mesh_variants",
    "parse_mesh_shape",
    "plan_key",
    "quant_tier_epilogue",
    "reference_arrays",
    "schedule_mesh_axes",
    "search_dtype_ladder",
    "search_gemm_plans",
    "search_schedule",
    "search_schedule_with_grads",
    "serving_phase",
    "spec_from_name",
    "sweep_specs",
]
