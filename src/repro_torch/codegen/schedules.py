"""Generic schedule construction for arbitrary contractions.

``core.schedule.matmul_schedule`` hand-builds the canonical matmul nest;
``default_schedule`` does the same for ANY ``ContractionSpec``:

  * a map index with a block b < extent  -> subdiv into (grid, mxu) leaves
  * a map index left unblocked           -> whole axis in the block (mxu),
    or, for batch-like dims (``block=1``), one grid step per element
  * a reduce index with a block b        -> subdiv into (seq, mxu) leaves
  * a reduce index left unblocked        -> contracted in one dot (mxu)

``sharded_schedule`` adds outer ``mesh:*`` tiers on top.  Level order is
mesh (pod/data/model) -> grid -> seq -> mxu, which is what
``Schedule.validate`` demands and what ``codegen.plan`` consumes.

The three scenario builders at the bottom are the workloads the repo could
not express before this subsystem existed: batched matmul, the A@B@C
chain, and the transposed-operand GEMM.

``default_schedule`` is the *un-searched* baseline: ``repro.search``
explores loop orders and per-tier blockings around it
(``search.space.candidate_schedule`` generalizes this builder to
arbitrary loop orders) and only keeps a variant if it measures faster —
``ops.dense`` asks the search's plan DB before falling back here.

Fused families reinterpret one tier rather than add new ones.  For
``AttentionSpec`` the ``seq`` tier over the KV axis ``t`` is the
**online-softmax** reduction (``codegen.fused_gen``): each ``t``-block
step computes a score tile, folds it into running row-max ``m`` and
row-sum ``l`` VMEM scratch, and *rescales* the f32 accumulator by
``exp(m_old - m_new)`` before adding the new ``P·V`` contribution — the
flash-attention recurrence, so blocking ``t`` changes arithmetic order
but never semantics.  That is why ``t`` is a legal chunk axis while the
head dims ``d``/``e`` are ``whole_indices`` (a blocked softmax over a
*partial* feature axis has no such rescaling identity, so the search
space pins them to full extent; same for grouped's ``g``/``k``).  A map
index left unblocked lowers exactly as in the plain path, so searched
attention schedules differ only in grid order and ``s``/``t`` blockings.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..core.enumerate import (
    ContractionSpec,
    batched_matmul_spec,
    chain_matmul_spec,
    transposed_matmul_spec,
)
from ..core.schedule import MESH_TIERS, Level, Schedule


def default_schedule(
    spec: ContractionSpec,
    blocks: Optional[Dict[str, int]] = None,
) -> Schedule:
    """Build a Schedule for the ROOT ``spec`` from per-index block sizes.

    ``blocks[i]`` is the per-grid-step (map) or per-seq-step (reduce) tile
    of root index ``i``; omitted indices keep their whole extent in-block.
    For mesh tiers use ``sharded_schedule``.
    """
    spec = spec.root()
    blocks = dict(blocks or {})
    unknown = set(blocks) - set(spec.indices)
    if unknown:
        raise ValueError(f"blocks name unknown indices {sorted(unknown)}")
    s = spec
    grid_levels, seq_levels, mxu_levels = [], [], []
    for index in spec.indices:
        extent = spec.extents[index]
        b = blocks.get(index, extent)
        if not 1 <= b <= extent or extent % b:
            raise ValueError(
                f"block {b} does not divide extent {extent} of {index}"
            )
        is_map = index in spec.output
        if b == extent:
            mxu_levels.append(Level(index, "mxu", extent))
            continue
        s = s.subdivide(index, b)
        outer = Level(index + "o", "grid" if is_map else "seq", extent // b)
        (grid_levels if is_map else seq_levels).append(outer)
        mxu_levels.append(Level(index + "i", "mxu", b))
    levels = tuple(grid_levels + seq_levels + mxu_levels)
    return Schedule(s, levels).validate()


def sharded_schedule(
    spec: ContractionSpec,
    blocks: Optional[Dict[str, int]] = None,
    mesh_shards: Optional[Dict[str, Tuple[str, int]]] = None,
) -> Schedule:
    """default_schedule plus outer mesh tiers.

    ``mesh_shards[i] = (axis, n)`` shards root index ``i`` over mesh axis
    ``axis`` (pod/data/model) in ``n`` pieces before the grid/seq/mxu
    blocking applies; ``blocks[i]`` then tiles the per-shard remainder.
    """
    spec = spec.root()
    mesh_shards = dict(mesh_shards or {})
    blocks = dict(blocks or {})
    s = spec
    mesh_levels = []
    renamed: Dict[str, str] = {}
    for index, (axis, n) in mesh_shards.items():
        tier = f"mesh:{axis}"
        if tier not in MESH_TIERS:
            raise ValueError(f"unknown mesh axis {axis!r} (want pod/data/model)")
        extent = spec.extents[index]
        if n <= 0 or extent % n:
            raise ValueError(f"{n} shards do not divide extent {extent} of {index}")
        if n == 1:
            continue
        s = s.subdivide(index, extent // n)
        mesh_levels.append(Level(index + "o", tier, n))
        renamed[index] = index + "i"
    inner_blocks = {renamed.get(i, i): b for i, b in blocks.items()}
    grid_levels, seq_levels, mxu_levels = [], [], []
    root_out = spec.output
    mesh_names = {l.index for l in mesh_levels}
    for index in s.indices:
        if index in mesh_names:
            continue
        extent = s.extents[index]
        base = index[:-1] if index in renamed.values() else index
        is_map = base in root_out
        b = inner_blocks.get(index, extent)
        if not 1 <= b <= extent or extent % b:
            raise ValueError(
                f"block {b} does not divide local extent {extent} of {index}"
            )
        if b == extent:
            mxu_levels.append(Level(index, "mxu", extent))
            continue
        s = s.subdivide(index, b)
        outer = Level(index + "o", "grid" if is_map else "seq", extent // b)
        (grid_levels if is_map else seq_levels).append(outer)
        mxu_levels.append(Level(index + "i", "mxu", b))
    rank = {t: i for i, t in enumerate(MESH_TIERS)}
    mesh_levels.sort(key=lambda l: rank[l.tier])
    levels = tuple(mesh_levels + grid_levels + seq_levels + mxu_levels)
    return Schedule(s, levels).validate()


# -- the three new scenarios --------------------------------------------------


def batched_matmul_schedule(
    b: int, m: int, k: int, n: int,
    *, block_m: int, block_n: int, block_k: int,
) -> Schedule:
    """out[b,i,k] = sum_j A[b,i,j] B[b,j,k]; batch dim = one grid step each."""
    spec = batched_matmul_spec(b, m, k, n)
    return default_schedule(
        spec,
        blocks={"b": 1, "i": block_m, "k": block_n, "j": block_k},
    )


def chain_matmul_schedule(
    m: int, k1: int, k2: int, n: int,
    *, block_m: int, block_n: int, block_k1: int, block_k2: int,
) -> Schedule:
    """out[i,l] = sum_{j,k} A[i,j] B[j,k] C[k,l] — both reductions seq-tiled."""
    spec = chain_matmul_spec(m, k1, k2, n)
    return default_schedule(
        spec,
        blocks={"i": block_m, "l": block_n, "j": block_k1, "k": block_k2},
    )


def transposed_matmul_schedule(
    m: int, k: int, n: int,
    *, block_m: int, block_n: int, block_k: int,
) -> Schedule:
    """out[i,k] = sum_j A[j,i] B[j,k] (A stored transposed)."""
    spec = transposed_matmul_spec(m, k, n)
    return default_schedule(
        spec, blocks={"i": block_m, "k": block_n, "j": block_k}
    )
