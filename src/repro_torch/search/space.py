"""Search space: candidate variants for a ContractionSpec.

A *candidate* is a root-index loop order (one element of the rewrite-derived
SJT walk, ``core.enumerate.variant_orders``) plus one block/chunk choice per
root index — exactly the information a ``core.schedule.Schedule`` needs:

  * a map index blocked at ``b < extent``    -> ``grid`` level + ``mxu`` leaf
  * a map index left whole                   -> ``mxu`` level
  * a reduce index chunked at ``b < extent`` -> ``seq`` level + ``mxu`` leaf
  * a reduce index left whole                -> contracted in one dot

The **mesh tier** sits above all of that: a ``MeshVariant`` assigns each
axis of the active device mesh to (at most) one root index, sharding it
before the grid/seq/mxu blocking applies — the paper's subdivision rule
bound to "clusters and devices" instead of grid steps.  Sharding a *map*
index partitions operands and output; sharding a *reduce* index makes each
device compute a partial contraction finished by a collective, whose
lowering (``psum`` vs the ring-overlap form) is itself part of the variant
(``Candidate.collective``).  ``mesh_variants`` enumerates the legal
factorizations of a mesh shape over the root indices; block choices then
range over the per-shard *local* extents.

Many SJT orders realize the *same* generated kernel: only the relative order
of blocked map indices (the Pallas grid dims) and of chunked reduce indices
(the in-kernel fori_loop nest) survives lowering.  ``canonical_key`` projects
a candidate onto that quotient so the beam search deduplicates variants that
the exchange rules prove equivalent (see ``core.rules`` eq 36-43).

Everything above is the reference's, copied (pure Python): the port's beam
ranks the same candidates with the same scores.  A sharded schedule is
bound to a mesh of ranks by ``codegen.bind_mesh``.

On the card B1 ignores a schedule's blocking: what a launch runs is its
body and that body's tile plan (``codegen.cuda_gen.CardPlan``).
``card_candidates`` lists the legal plans of the body ``contract_body``
picks for a product's operand layouts -- the space the search measures on
the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.enumerate import ContractionSpec, variant_orders
from ..core.schedule import MESH_TIERS, Level, Schedule

#: outermost-first mesh axis names, matching ``core.schedule.MESH_TIERS``
MESH_AXIS_ORDER = tuple(t.split(":", 1)[1] for t in MESH_TIERS)

#: collective lowerings a sharded reduction can choose between
#: (``codegen.mesh_gen.bind_mesh(collective=...)``)
COLLECTIVES = ("psum", "ring")

#: assignment: sorted ``(root index, (mesh axis, shards))`` pairs
MeshAssignment = Tuple[Tuple[str, Tuple[str, int]], ...]


def mesh_axis_names(ndim: int) -> Tuple[str, ...]:
    """Axis-name convention for an ``ndim``-dimensional mesh shape.

    Matches ``launch.mesh``: 2-D meshes are (data, model), 3-D adds the
    leading pod axis; a 1-D mesh is a plain data ring.
    """
    if ndim == 1:
        return ("data",)
    if ndim == 2:
        return ("data", "model")
    if ndim == 3:
        return ("pod", "data", "model")
    raise ValueError(f"mesh shapes have 1-3 axes, got {ndim}")


def parse_mesh_shape(text: str) -> Tuple[int, ...]:
    """'2x4' -> (2, 4) — the ``--mesh`` CLI syntax."""
    try:
        shape = tuple(int(p) for p in str(text).lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh shape must look like '2x4', got {text!r}")
    if not shape or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape must be positive, got {text!r}")
    mesh_axis_names(len(shape))  # validates the rank
    return shape


def mesh_descriptor(shape: Optional[Sequence[int]]) -> Optional[str]:
    """Canonical plan-key qualifier: (2, 4) -> '2x4', None/all-1 -> None."""
    if shape is None:
        return None
    shape = tuple(int(s) for s in shape)
    if all(s == 1 for s in shape):
        return None
    return "x".join(str(s) for s in shape)


@dataclasses.dataclass(frozen=True)
class MeshVariant:
    """One legal mesh subdivision: axis->index assignment + collective.

    ``assignment`` is empty for the unsharded variant.  ``collective`` is
    ``""`` unless a reduce index is sharded, in which case it names the
    lowering of the finishing reduction (one of ``COLLECTIVES``).
    """

    assignment: MeshAssignment = ()
    collective: str = ""

    @property
    def shards(self) -> int:
        out = 1
        for _, (_, n) in self.assignment:
            out *= n
        return out

    def as_dict(self) -> Dict[str, Tuple[str, int]]:
        return dict(self.assignment)


def local_extents(
    spec: ContractionSpec, mesh: Optional[Dict[str, Tuple[str, int]]]
) -> Dict[str, int]:
    """Per-shard extents after the mesh subdivision (root extents sans mesh)."""
    spec = spec.root()
    mesh = mesh or {}
    out = {}
    for i in spec.indices:
        n = mesh[i][1] if i in mesh else 1
        out[i] = spec.extents[i] // n
    return out


def mesh_variants(
    spec: ContractionSpec,
    mesh_shape: Optional[Sequence[int]],
    *,
    include_unsharded: bool = True,
) -> List[MeshVariant]:
    """Enumerate legal mesh subdivisions of ``spec`` over ``mesh_shape``.

    Per mesh axis the options are: leave it unused (the computation is
    replicated over that axis) or shard any root index whose extent it
    divides; axes shard *distinct* indices (one mesh level per root index,
    the shape ``codegen.plan`` lowers).  Variants that shard a reduce
    index fan out once per collective lowering (``COLLECTIVES``) — the
    paper's "choose the variant" applied to the finishing collective
    itself.  Deduplication: assignments are canonical (sorted pairs), so
    distinct MeshVariants are distinct subdivisions.
    """
    spec = spec.root()
    if mesh_shape is None:
        return [MeshVariant()] if include_unsharded else []
    axes = [
        (name, int(size))
        for name, size in zip(mesh_axis_names(len(mesh_shape)), mesh_shape)
        if int(size) > 1
    ]
    if not axes:
        return [MeshVariant()] if include_unsharded else []
    per_axis: List[List[Optional[str]]] = [
        [None]
        + [i for i in spec.indices if spec.extents[i] % size == 0]
        for _, size in axes
    ]
    out: List[MeshVariant] = []
    for combo in itertools.product(*per_axis):
        chosen = [c for c in combo if c is not None]
        if len(set(chosen)) != len(chosen):  # two axes on one index
            continue
        if not chosen and not include_unsharded:
            continue
        assignment = tuple(sorted(
            (idx, (axes[a][0], axes[a][1]))
            for a, idx in enumerate(combo)
            if idx is not None
        ))
        if not assignment:
            out.append(MeshVariant())
            continue
        sharded_reduce = any(
            idx not in spec.output for idx, _ in assignment
        )
        if sharded_reduce:
            out.extend(
                MeshVariant(assignment, coll) for coll in COLLECTIVES
            )
        else:
            out.append(MeshVariant(assignment))
    return out


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space, in root-index terms.

    ``blocks`` maps every root index to its per-grid-step (map) or
    per-seq-step (reduce) extent **within the local shard**; an index
    mapped to its full local extent has no grid/seq level.  ``order`` is
    the loop nest outermost-first.  ``mesh`` is the mesh subdivision
    (empty = single-device) and ``collective`` the lowering of a sharded
    reduction, if any.
    """

    spec: ContractionSpec
    order: Tuple[str, ...]
    blocks: Tuple[Tuple[str, int], ...]  # sorted (index, block) pairs
    mesh: MeshAssignment = ()
    collective: str = ""

    @property
    def block_dict(self) -> Dict[str, int]:
        return dict(self.blocks)

    @property
    def mesh_dict(self) -> Dict[str, Tuple[str, int]]:
        return dict(self.mesh)

    def _local(self) -> Dict[str, int]:
        return local_extents(self.spec, self.mesh_dict)

    def grid_order(self) -> Tuple[str, ...]:
        b, loc = self.block_dict, self._local()
        return tuple(
            i for i in self.order
            if i in self.spec.output and b.get(i, loc[i]) < loc[i]
        )

    def seq_order(self) -> Tuple[str, ...]:
        b, loc = self.block_dict, self._local()
        return tuple(
            i for i in self.order
            if i not in self.spec.output and b.get(i, loc[i]) < loc[i]
        )

    def canonical_key(self) -> str:
        """Identity after lowering: mesh assignment + collective, grid
        order, seq order, block sizes."""
        return json.dumps(
            {
                "grid": list(self.grid_order()),
                "seq": list(self.seq_order()),
                "blocks": sorted(
                    (i, int(b)) for i, b in self.blocks
                ),
                "mesh": sorted(
                    (i, a, int(n)) for i, (a, n) in self.mesh
                ),
                "collective": self.collective,
            },
            sort_keys=True,
            separators=(",", ":"),
        )

    def to_schedule(self) -> Schedule:
        return candidate_schedule(
            self.spec, self.order, self.block_dict, mesh=self.mesh_dict
        )


def make_candidate(
    spec: ContractionSpec,
    order: Sequence[str],
    blocks: Dict[str, int],
    mesh: Optional[Dict[str, Tuple[str, int]]] = None,
    collective: str = "",
) -> Candidate:
    spec = spec.root()
    mesh = dict(mesh or {})
    loc = local_extents(spec, mesh)
    full = {i: int(blocks.get(i, loc[i])) for i in spec.indices}
    return Candidate(
        spec=spec,
        order=tuple(order),
        blocks=tuple(sorted(full.items())),
        mesh=tuple(sorted(mesh.items())),
        collective=collective,
    )


def candidate_schedule(
    spec: ContractionSpec,
    order: Sequence[str],
    blocks: Dict[str, int],
    mesh: Optional[Dict[str, Tuple[str, int]]] = None,
) -> Schedule:
    """Build the Schedule a candidate denotes.

    Same leaf structure as ``codegen.schedules.default_schedule`` but the
    grid and seq levels are emitted in loop-``order`` (default_schedule
    always uses ``spec.indices`` order), so the search can rank grid-dim
    and reduction-nest orders, not just block shapes.  ``mesh`` shards
    root indices over mesh axes *before* the inner blocking (the
    ``sharded_schedule`` shape); ``blocks`` then tile the per-shard local
    extents.
    """
    spec = spec.root()
    order = tuple(order)
    if set(order) != set(spec.indices):
        raise ValueError(f"order {order} != indices {spec.indices}")
    mesh = dict(mesh or {})
    rank = {a: r for r, a in enumerate(MESH_AXIS_ORDER)}
    s = spec
    mesh_levels: List[Level] = []
    renamed: Dict[str, str] = {}
    for index, (axis, n) in sorted(
        mesh.items(), key=lambda kv: rank.get(kv[1][0], len(rank))
    ):
        if axis not in MESH_AXIS_ORDER:
            raise ValueError(
                f"unknown mesh axis {axis!r} (want {MESH_AXIS_ORDER})"
            )
        extent = spec.extents[index]
        if n <= 0 or extent % n:
            raise ValueError(
                f"{n} shards do not divide extent {extent} of {index}"
            )
        if n == 1:
            continue
        s = s.subdivide(index, extent // n)
        mesh_levels.append(Level(index + "o", f"mesh:{axis}", n))
        renamed[index] = index + "i"
    loc = local_extents(spec, mesh)
    grid: List[Level] = []
    seq: List[Level] = []
    mxu: List[Level] = []
    for index in order:
        extent = loc[index]
        name = renamed.get(index, index)
        b = int(blocks.get(index, extent))
        if not 1 <= b <= extent or extent % b:
            raise ValueError(
                f"block {b} does not divide local extent {extent} of {index}"
            )
        if b == extent:
            mxu.append(Level(name, "mxu", extent))
            continue
        s = s.subdivide(name, b)
        outer = Level(
            name + "o",
            "grid" if index in spec.output else "seq",
            extent // b,
        )
        (grid if index in spec.output else seq).append(outer)
        mxu.append(Level(name + "i", "mxu", b))
    return Schedule(s, tuple(mesh_levels + grid + seq + mxu)).validate()


#: quantized precision tiers of the dtype axis (core.enumerate
#: QUANT_FORMATS keys); the baseline tier is whatever dtype the caller
#: searches at (bf16/f32)
QUANT_TIERS = ("int8", "fp8")


def dtype_tier_specs(
    spec: ContractionSpec,
    *,
    dtype="float32",
    tiers: Sequence[str] = QUANT_TIERS,
) -> List[Tuple[str, ContractionSpec, "object"]]:
    """The dtype axis of the search: (tier, spec, dtype) triples.

    The baseline tier keeps the caller's spec and dtype; each quant tier
    re-tags the root spec with its ``QuantMeta`` (so plans land under
    dtype-qualified keys) and searches at the 1-byte storage dtype.  Fused
    and already-quantized specs get only their baseline row — there is no
    quant lowering for them yet.  A tier whose storage dtype is not
    registered in this container (fp8 on old ml_dtypes) is skipped rather
    than crashing the sweep.
    """
    import torch

    from ..codegen.cache import dtype_name
    from ..core.enumerate import quantize_spec

    root = spec.root()
    out: List[Tuple[str, ContractionSpec, object]] = [
        ("baseline", root, getattr(torch, dtype_name(dtype)))
    ]
    if getattr(root, "fused_kind", "") or getattr(root, "quant", None):
        return out
    for tier in tiers:
        q = quantize_spec(root, fmt=tier)
        qdt = getattr(torch, q.quant.dtype, None)
        if qdt is None:
            continue
        out.append((tier, q, qdt))
    return out


def sweep_specs(
    spec: ContractionSpec, with_grads: bool = False
) -> List[Tuple[str, ContractionSpec]]:
    """(label, spec) points a sweep should cover for one forward spec.

    With ``with_grads`` the forward spec is joined by its derived backward
    specs (``grad.derive`` — dA, dB, ... by index calculus), so one sweep
    prepares ranked plans for both the primal and the cotangent GEMMs of
    training.  Every derived spec has its own name (``<spec>.d<op>``) and
    therefore its own plan-DB key.  Consumed by
    ``search.search_schedule_with_grads``, ``scripts/search_sweep.py
    --with-grads`` and ``serve --search-gemms``.
    """
    out: List[Tuple[str, ContractionSpec]] = [("fwd", spec.root())]
    if with_grads:
        from ..grad import derived_specs

        out.extend(
            (f"d{wrt}", d) for wrt, d in derived_specs(spec).items()
        )
    return out


# ---------------------------------------------------------------------------
# choice generators
# ---------------------------------------------------------------------------


def map_block_choices(
    extent: int, hw: dict, per_index: int = 6
) -> List[int]:
    """Pow2 divisor blocks for a map (output) index, largest first.

    Tiny batch-like extents offer {1, extent} so a batched dim can become
    one grid step per element (the ``default_schedule`` convention).
    """
    if extent <= hw["sublane"]:
        return [extent, 1] if extent > 1 else [1]
    out = [extent]
    c = 1
    while c <= min(extent, 1024):
        if extent % c == 0 and c != extent:
            out.append(c)
        c *= 2
    out.sort(reverse=True)
    return out[:per_index]


def seq_chunk_choices(extent: int, hw: dict, cap: int = 512) -> List[int]:
    """Chunk choices for a reduce index: whole axis, or pow2 chunks <= cap.

    Reduce chunking never changes HBM traffic in the generated kernels (the
    axis is VMEM-resident either way, see ``codegen.plan``), it only bounds
    the per-dot depth — so the fan-out here is deliberately small.
    """
    out = [extent]
    if extent > cap:
        best = 0
        c = 1
        while c <= cap:
            if extent % c == 0:
                best = c
            c *= 2
        if best:
            out.append(best)
    elif extent > hw["mxu"][0] and extent % 2 == 0:
        out.append(extent // 2)
    return out


def block_choices(
    spec: ContractionSpec,
    hw: dict,
    per_index: int = 6,
    mesh: Optional[Dict[str, Tuple[str, int]]] = None,
) -> Dict[str, List[int]]:
    """Per-root-index block choices; with ``mesh`` the choices range over
    the per-shard *local* extents (the extents the generated kernel sees
    inside ``shard_map``)."""
    spec = spec.root()
    loc = local_extents(spec, mesh)
    # fused families pin some axes whole: attention's head dims live
    # entirely inside one MXU pass, grouped's group/contraction axes are
    # realized by the group-offset grid, not by blocking
    whole = getattr(spec, "whole_indices", ())
    return {
        i: (
            [loc[i]]
            if i in whole
            else map_block_choices(loc[i], hw, per_index)
            if i in spec.output
            else seq_chunk_choices(loc[i], hw)
        )
        for i in spec.indices
    }


def candidate_orders(
    spec: ContractionSpec, limit: Optional[int] = None
) -> List[Tuple[str, ...]]:
    """Root loop orders from the SJT walk, deduplicated by lowering identity.

    Uses ``variant_orders`` (every order reachable by the exchange rules),
    then collapses orders whose map-index and reduce-index projections
    agree — those differ only by map/rnz exchanges that the generated
    kernel realizes identically.
    """
    return candidate_orders_counted(spec, limit)[0]


def candidate_orders_counted(
    spec: ContractionSpec, limit: Optional[int] = None
) -> Tuple[List[Tuple[str, ...]], int]:
    """(orders, visited) — one walk; ``visited - len(orders)`` = deduped."""
    spec = spec.root()
    seen = set()
    out: List[Tuple[str, ...]] = []
    visited = 0
    for order in variant_orders(spec, dedup_rnz=False):
        visited += 1
        key = (
            tuple(i for i in order if i in spec.output),
            tuple(i for i in order if i not in spec.output),
        )
        if key in seen:
            continue
        seen.add(key)
        out.append(order)
        if limit is not None and len(out) >= limit:
            break
    return out, visited


# ---------------------------------------------------------------------------
# B1's tile plans on the card
# ---------------------------------------------------------------------------

#: the most K splits a ring or tc32 tile is offered (the heuristics' cap)
CARD_MAX_SPLITS = 16


def _split_ok(nk: int, splits: int, batch: int) -> bool:
    """``contract.cu``'s ``split_ok`` / ``launch_tc32`` checks: every split
    at least one K step, a grid within its limits."""
    if splits < 1 or splits > nk:
        return False
    per = -(-nk // splits)
    return (splits - 1) * per < nk and batch * splits <= 65535


def card_candidates(spec: ContractionSpec, a, b, dtype=None, *,
                    sms: Optional[int] = None, epilogue: bool = False) -> list:
    """The legal tile plans (``codegen.cuda_gen.CardPlan``) of the B1 body
    that ``contract_body`` picks for ``spec``'s product a (batch, M, K) @ b
    (batch, K, N) -- ``cuda_gen.card_views`` gives a spec's views as the
    caller passes them; any device, the meta device too, since only
    dtypes, shapes, strides and alignment are read.  ``dtype`` (a torch
    dtype or its name) overrides the operands' dtype.  The spec's fold
    (``cuda_gen._classify``) names the mode: a plain product, the weighted
    family's k-scale (a vector on the reduced index) or multiplier, or the
    row reduce; ``epilogue`` a product under an epilogue (the fused ring's
    or tc32's epilogue mode, whose plans its own ladder measures).

    * ring: ``tile_n`` 128 or 256 (128 only in the k-scale and row-reduce
      modes), ``splits`` 1 to ``CARD_MAX_SPLITS`` (the row reduce's splits
      each a row block of its partial rows);
    * narrow: ``tile_n`` each of ``NARROW_WIDTHS`` holding the M tokens,
      ``splits`` 1 to ``NARROW_MAX_SPLITS``;
    * tc32: ``tile_n`` (x's tile width) 128 and, for a plain product at
      M < 64 whose x is k-contiguous, each narrower one of ``TC32_WIDTHS``
      holding M; ``splits`` 1 to ``CARD_MAX_SPLITS``, each split at least
      ``TC32_MIN_STEPS`` K steps.

    Only the plans ``contract.cu``'s checks accept are kept (no split
    without a K step, ``batch * splits`` <= 65535), and the heuristic's own
    plan (``cuda_gen.heuristic_plan``) is always among them.  The mma.sync
    and FMA bodies take no plan: their list is empty."""
    import torch

    from ..codegen import cuda_gen as cg
    from ..codegen.cache import dtype_name
    from ..codegen.modes import VecArg

    if dtype is not None:
        dt = getattr(torch, dtype_name(dtype))
        meta = lambda x: torch.empty_strided(  # noqa: E731
            x.shape, x.stride(), dtype=dt, device="meta")
        a, b = meta(a), meta(b)
    batch, m, k = a.shape
    n = b.shape[2]
    root = spec.root()
    fold = cg._classify(root)
    row_reduce = fold.kind == "row_reduce"
    kscale = fold.kind == "vector" and all(
        root.operands[fold.extra][0] in root.operands[x]
        for x in (fold.a, fold.b))
    vec = (VecArg(torch.empty(k, dtype=torch.float32, device="meta"), 3)
           if kscale else None)
    plain = fold.kind == "gemm" and not epilogue
    body = cg.contract_body(a, b, plain=plain, kscale=vec,
                            row_reduce=row_reduce)
    sms = sms or cg.H100_SMS
    narrow_x = plain and cg.tma_operand(a, 2, 4)
    heur = cg.heuristic_plan(body, batch, m, n, k, sms, kscale=kscale,
                             row_reduce=row_reduce, narrow_x=narrow_x)
    if heur is None:
        return []
    out = []
    if body == "ring":
        nk = -(-k // cg.RING_BK)
        widths = (128,) if kscale or row_reduce else (128, 256)
        out = [cg.CardPlan("ring", w, s) for w in widths
               for s in range(1, CARD_MAX_SPLITS + 1)
               if _split_ok(nk, s, batch)]
    elif body == "narrow":
        nk = -(-k // cg.RING_BK)
        out = [cg.CardPlan("narrow", w, s) for w in cg.NARROW_WIDTHS
               if w >= m for s in range(1, cg.NARROW_MAX_SPLITS + 1)
               if _split_ok(nk, s, batch)]
    elif body == "tc32":
        nk = -(-k // cg.TC32_BK)
        widths = [w for w in cg.TC32_WIDTHS
                  if w >= cg.tc32_width(m, narrow_x)]
        out = [cg.CardPlan("tc32", w, s) for w in widths
               for s in range(1, CARD_MAX_SPLITS + 1)
               if _split_ok(nk, s, batch)
               and (s == 1 or -(-nk // s) >= cg.TC32_MIN_STEPS)]
    if heur not in out:
        out.append(heur)
    return out


def q8_card_candidates(spec: ContractionSpec, *operands,
                       sms: Optional[int] = None) -> list:
    """The legal plans (``codegen.modes.Q8Plan``) of the 8-bit ring for
    ``spec`` on ``operands`` (in ``spec.operands`` order, as the caller
    passes them), or [] where the launch does not run the ring
    (``cuda_gen.launcher_of``: the upcast body, or fp8's k-scale on
    contract.cu; ``modes.q8_body``: the mma.sync body) -- those take no
    plan.  Any device, the meta device too.

    * one CTA a tile (``ctas`` 0, the heuristic's,
      ``modes.Q8_HEURISTIC``), and, where the tiles outnumber the SMs, one
      CTA an SM, each walking its tiles.

    The ring's tile is 128 x 128, so the reference's blocks have no knob
    here; the grid is the one axis that changes the launch, and it changes
    no value."""
    from ..codegen import cuda_gen as cg
    from ..codegen.modes import (CONTRACT_FP8, CONTRACT_INT8, Q8_HEURISTIC,
                                 Q8_RING_TILE, Q8Plan, q8_body)

    root = spec.root()
    a, b = cg.card_views(root, *operands)[:2]
    # the weighted family's modes take the ring alone on the tensor cores
    ring = cg.launcher_of(root, *operands) in (CONTRACT_INT8, CONTRACT_FP8)
    if not ring or (cg._classify(root).kind == "gemm"
                    and q8_body(a, b) != "ring"):
        return []
    batch, m, _ = a.shape
    n = b.shape[2]
    sms = sms or cg.H100_SMS
    tiles = batch * -(-m // Q8_RING_TILE) * -(-n // Q8_RING_TILE)
    return [Q8_HEURISTIC] + ([Q8Plan(sms)] if tiles > sms else [])


def chain_card_candidates(spec: ContractionSpec, dtype) -> list:
    """The plans (``codegen.modes.ChainPlan``) of the chain kernel for
    ``spec`` (a chain X(r,p) Y(p,q) Z(q,c) and its derived specs) on
    operands of ``dtype``: each association, (X.Y).Z (``"xy"``) and
    X.(Y.Z) (``"yz"``, the transposed chain, whose first reduction is q),
    by each cluster of 1, 2, 4 ... ``CHAIN_MAX_CLUSTER`` CTAs that leaves
    every CTA a step of that reduction (64 for bf16, 32 otherwise); the
    launch's own (``cuda_gen.chain_plan``) among them.  The reference's
    blocks of the two reductions are what the association and the cluster
    stand in for: both change the summation order only."""
    import torch

    from ..codegen import cuda_gen as cg
    from ..codegen.cache import dtype_name
    from ..codegen.modes import CHAIN_MAX_CLUSTER, ChainPlan

    root = spec.root()
    dt = getattr(torch, dtype_name(dtype))
    r, p, q, c = (root.extents[i]
                  for i in cg.chain_extents(root, cg._classify(root)))
    step = 64 if dt == torch.bfloat16 else 32
    out = []
    for assoc, first in (("xy", p), ("yz", q)):
        cs = 1
        while cs <= CHAIN_MAX_CLUSTER and (cs == 1 or cs <= -(-first // step)):
            out.append(ChainPlan(assoc, cs))
            cs *= 2
    heur = cg.chain_plan(r, p, q, c, dt)
    if heur not in out:
        out.append(heur)
    return out


def fused_cta_choices(tiles: int, sms: int) -> List[int]:
    """The persistent grids a fused ring's plan may take over ``tiles``
    tiles on a card of ``sms`` multiprocessors: one CTA an SM (the
    heuristic's), three quarters and half of that, each at most one a
    tile, widest first."""
    return sorted({max(1, min(tiles, c)) for c in (sms, 3 * sms // 4,
                                                  sms // 2)}, reverse=True)


def fused_heuristic_plan(spec: ContractionSpec, *tensors,
                         sms: Optional[int] = None):
    """The ``FusedPlan`` the fused kernel's launcher takes for ``spec`` on
    ``tensors`` without a searched one (``attention_plan``,
    ``grouped_plan``, ``grouped_dw_plan``), or None on a body with no
    plan."""
    from ..codegen import fused_gen as fg

    root = spec.root()
    if getattr(root, "fused_kind", "") == "attention":
        return fg.attention_plan(*tensors, sms)
    if "g" in root.output:
        return fg.grouped_dw_plan(*fg.dw_operands(root, tensors),
                                  len(root.group_sizes), sms)
    return fg.grouped_plan(*tensors, tuple(root.group_sizes),
                           fg.contracts_last(root))


def fused_card_candidates(spec: ContractionSpec, *tensors,
                          sms: Optional[int] = None) -> list:
    """The legal card plans (``codegen.fused_gen.FusedPlan``) of the fused
    kernel that runs ``spec`` (an attention or grouped spec) on
    ``tensors``, its operands in ``spec.operands`` order as the caller
    passes them -- any device, the meta device too, since only dtypes,
    shapes, strides and alignment are read.  The body is the one the
    launcher picks (``attention_body``, ``grouped_body``,
    ``grouped_dw_body``), and the heuristic's plan
    (``fused_heuristic_plan``) is always among them:

    * B2's ring: a KV block of ``ATTN_RING_BLOCKS`` columns (128, 64) by
      each of ``fused_cta_choices`` persistent CTAs;
    * B2's 3xTF32 body: a KV block of 32, and 64 where its tiles fit
      (``tc32_block_fits``: not at d = e = 128);
    * B3 (forward and dX): each M tile of ``GROUPED_TILES`` whose table
      the grid holds;
    * B4's ring: 256- and 128-column tiles by each of
      ``fused_cta_choices``.

    The mma.sync and FMA bodies take no plan: their list is empty.  The
    reference's plan axes that the card's knobs stand in for: the KV
    chunk ``bt`` of its attention grid is B2's KV block, the row block
    ``bm`` of its grouped row kernel B3's M tile, and the column block
    ``bn`` of its dW grid B4's tile width.  (The reference's ``bh`` and
    ``bs`` have no knob: B2 takes one head and 128 rows of s a tile.)"""
    from ..codegen import cuda_gen as cg
    from ..codegen import fused_gen as fg

    root = spec.root()
    if not getattr(root, "fused_kind", ""):
        raise ValueError(f"{root.name} is not a fused spec")
    sms = sms or cg.H100_SMS
    heur = fused_heuristic_plan(root, *tensors, sms=sms)
    if heur is None:
        return []
    if heur.kernel == "attention" and heur.body == "ring":
        q = tensors[0]
        tiles = fg.attention_ring_tiles(q.shape[0], q.shape[1])
        out = [fg.FusedPlan("attention", "ring", b, c)
               for b in fg.ATTN_RING_BLOCKS
               for c in fused_cta_choices(tiles, sms)]
    elif heur.kernel == "attention":
        d, e = tensors[0].shape[2], tensors[2].shape[2]
        out = [fg.FusedPlan("attention", "tc32", b, 0)
               for b in fg.ATTN_TC32_BLOCKS if fg.tc32_block_fits(d, e, b)]
    elif heur.kernel == "grouped_dw":
        lhs, rhs = fg.dw_operands(root, tensors)
        n_groups = len(root.group_sizes)
        out = []
        for w in fg.DW_RING_WIDTHS:
            tiles = fg.dw_ring_tiles(n_groups, lhs.shape[1], rhs.shape[1], w)
            if tiles < 2**31:
                out += [fg.FusedPlan("grouped_dw", "ring", w, c)
                        for c in fused_cta_choices(tiles, sms)]
    else:
        w = tensors[1]
        n = w.shape[1] if fg.contracts_last(root) else w.shape[2]
        out = []
        for t in fg.GROUPED_TILES:
            blocks = sum(-(-g // t) for g in root.group_sizes)
            if (blocks <= fg._MAX_GRID_Y if t <= 16
                    else blocks * -(-n // 128) < 2**31):
                out.append(fg.FusedPlan("grouped", "ring", t, 0))
    if heur not in out:
        out.append(heur)
    return out
