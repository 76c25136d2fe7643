"""Schedule -> KernelPlan: the pure (array-free) half of kernel generation.

A ``Schedule`` assigns every loop level of a (possibly subdivided)
``ContractionSpec`` to a hardware tier.  ``build_plan`` folds that leaf-level
view back onto the *root* indices so the Pallas layer can build BlockSpecs
over the original operand arrays:

  tier       root-axis realization
  ---------  -------------------------------------------------------------
  mesh:*     axis sharded over the mesh axis; everything below is per-shard
  grid       axis blocked; one parallel grid dim, block = product of the
             leaf extents *below* the grid leaf (Schedule.block_shape_for)
  seq        axis resident in VMEM at full (local) extent; the kernel
             fori_loops over chunks = product of leaves below the seq leaf
  mxu        axis fully inside the block, fed to lax.dot_general

Restrictions (checked, with clear errors):
  * every index of the scheduled spec appears in exactly one level;
  * per root index the leaf tiers are ordered mesh* -> (grid|seq)? -> mxu?;
  * grid leaves must be map (output) indices — reductions use seq tiers
    (the generated kernels keep the Pallas grid fully parallel; the
    hand-written ``kernels/matmul`` keeps the grid-streamed reduction as a
    verification baseline);
  * seq leaves must be reduce indices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..core.enumerate import ContractionSpec
from ..core.schedule import MESH_TIERS, Schedule


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    """How one ROOT index is realized across the hierarchy."""

    index: str                      # root index name
    extent: int                     # root extent
    mesh_axes: Tuple[str, ...]      # mesh axis names, outermost first
    shards: int                     # product of mesh shard counts
    grid_dim: Optional[int]         # position in the Pallas grid, or None
    num_blocks: int                 # grid blocks (per shard); 1 if no grid
    seq_steps: int                  # fori_loop steps; 1 if no seq leaf
    block: int                      # per-grid-step block extent (incl. seq)
    chunk: int                      # per-seq-step chunk extent (== block if
                                    # no seq leaf)

    @property
    def local_extent(self) -> int:
        return self.extent // self.shards


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Everything pallas_gen/mesh_gen need, in root-index terms."""

    spec: ContractionSpec                    # the ROOT spec
    axes: Dict[str, AxisPlan]                # root index -> plan
    grid: Tuple[str, ...]                    # root indices, grid order
    seq: Tuple[str, ...]                     # root indices, seq loop order

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return tuple(self.axes[i].num_blocks for i in self.grid)

    @property
    def seq_shape(self) -> Tuple[int, ...]:
        return tuple(self.axes[i].seq_steps for i in self.seq)

    def operand_block(self, name: str) -> Tuple[int, ...]:
        return tuple(self.axes[i].block for i in self.spec.operands[name])

    def out_block(self) -> Tuple[int, ...]:
        return tuple(self.axes[i].block for i in self.spec.output)

    def out_shape(self) -> Tuple[int, ...]:
        return tuple(self.axes[i].local_extent for i in self.spec.output)


def _leaf_tree(schedule: Schedule) -> Dict[str, List[str]]:
    """root index -> ordered leaf names (outermost split first)."""
    root = schedule.spec.root()
    tree: Dict[str, List[str]] = {i: [i] for i in root.indices}
    for index, _ in schedule.spec.split_chain():
        for leaves in tree.values():
            if index in leaves:
                p = leaves.index(index)
                leaves[p : p + 1] = [index + "o", index + "i"]
                break
        else:
            raise ValueError(f"split index {index} not found in leaf tree")
    return tree


def build_plan(schedule: Schedule) -> KernelPlan:
    spec = schedule.spec
    root = spec.root()
    tiers = {l.index: l for l in schedule.levels}
    missing = set(spec.indices) - set(tiers)
    if missing:
        raise ValueError(f"schedule assigns no tier to indices {sorted(missing)}")

    tree = _leaf_tree(schedule)
    grid_order = [l.index for l in schedule.levels if l.tier == "grid"]
    seq_order = [l.index for l in schedule.levels if l.tier == "seq"]

    axes: Dict[str, AxisPlan] = {}
    grid_roots: List[str] = [None] * len(grid_order)  # type: ignore
    seq_roots: List[str] = [None] * len(seq_order)  # type: ignore
    for r, leaves in tree.items():
        is_map = r in root.output
        seen_rank = -1
        rank = {**{t: 0 for t in MESH_TIERS}, "grid": 1, "seq": 1, "mxu": 2}
        mesh_axes: List[str] = []
        shards = 1
        grid_leaf = seq_leaf = None
        below_grid = below_seq = 1
        for pos, leaf in enumerate(leaves):
            lvl = tiers[leaf]
            if rank[lvl.tier] < seen_rank:
                raise ValueError(
                    f"index {r}: leaf {leaf} tier {lvl.tier} nests outside a "
                    f"deeper tier (leaves {leaves})"
                )
            seen_rank = rank[lvl.tier]
            if lvl.tier in MESH_TIERS:
                mesh_axes.append(lvl.tier.split(":", 1)[1])
                shards *= lvl.extent
            elif lvl.tier == "grid":
                if not is_map:
                    raise ValueError(
                        f"reduce index {r} on the grid tier; generated kernels "
                        f"keep the grid parallel — schedule it as seq"
                    )
                if grid_leaf is not None:
                    raise ValueError(f"index {r} has two grid leaves")
                grid_leaf = leaf
                below_grid = math.prod(
                    tiers[l].extent for l in leaves[pos + 1 :]
                )
            elif lvl.tier == "seq":
                if is_map:
                    raise ValueError(
                        f"map index {r} on the seq tier; only reductions are "
                        f"looped inside the kernel"
                    )
                if seq_leaf is not None:
                    raise ValueError(f"index {r} has two seq leaves")
                seq_leaf = leaf
                below_seq = math.prod(
                    tiers[l].extent for l in leaves[pos + 1 :]
                )
        extent = root.extents[r]
        local = extent // shards
        num_blocks = tiers[grid_leaf].extent if grid_leaf else 1
        seq_steps = tiers[seq_leaf].extent if seq_leaf else 1
        block = below_grid if grid_leaf else local
        chunk = below_seq if seq_leaf else block
        axes[r] = AxisPlan(
            index=r,
            extent=extent,
            mesh_axes=tuple(mesh_axes),
            shards=shards,
            grid_dim=grid_order.index(grid_leaf) if grid_leaf else None,
            num_blocks=num_blocks,
            seq_steps=seq_steps,
            block=block,
            chunk=chunk,
        )
        if grid_leaf:
            grid_roots[grid_order.index(grid_leaf)] = r
        if seq_leaf:
            seq_roots[seq_order.index(seq_leaf)] = r
        assert block * num_blocks == local and chunk * seq_steps == block, (
            r, axes[r],
        )
    return KernelPlan(
        spec=root,
        axes=axes,
        grid=tuple(grid_roots),
        seq=tuple(seq_roots),
    )
