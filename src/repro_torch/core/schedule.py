"""Schedules: binding subdivision levels to the hardware hierarchy.

The paper's closing claim is that its rewrite rules "are potentially capable
of distributing computations over the entire hierarchy of modern hardware,
from vector instructions to entire clusters".  A ``Schedule`` makes that
binding explicit for a contraction variant: every loop level produced by
``subdiv`` is assigned a *tier*:

    mesh:pod / mesh:data / mesh:model   -- GSPMD mesh axes (clusters/devices)
    grid                                -- Pallas grid dimension (HBM->VMEM)
    seq                                 -- sequential loop inside the kernel
    mxu                                 -- innermost tile fed to the MXU

The tier names and the format are the reference's, where the grid tiers
become the Pallas BlockSpec index maps and the mxu tier fixes the block
shapes.  In the port, ``codegen.plan.build_plan`` reads a Schedule for the
operand shapes and the memo key; the CUDA kernel picks its own CTA tiles
(``codegen/cuda_gen.py``).  Choosing between schedules is the paper's
variant enumeration with the reference's TPU cost model as the early-cut
(``codegen/tune.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from .enumerate import ContractionSpec

MESH_TIERS = ("mesh:pod", "mesh:data", "mesh:model")
TIERS = MESH_TIERS + ("grid", "seq", "mxu")


@dataclasses.dataclass(frozen=True)
class Level:
    index: str  # loop index name (possibly a split, e.g. "io")
    tier: str
    extent: int

    def __post_init__(self):
        assert self.tier in TIERS, self.tier


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An ordered (outermost-first) tier assignment for a variant."""

    spec: ContractionSpec
    levels: Tuple[Level, ...]

    @property
    def order(self) -> Tuple[str, ...]:
        return tuple(l.index for l in self.levels)

    def tier_levels(self, tier: str) -> Tuple[Level, ...]:
        return tuple(l for l in self.levels if l.tier == tier)

    def mesh_axes_for(self, operand: str) -> Dict[str, Optional[str]]:
        """index -> mesh axis name for the operand's mesh-tier dims."""
        out: Dict[str, Optional[str]] = {}
        axes = self.spec.operands[operand]
        for l in self.levels:
            if l.tier in MESH_TIERS and l.index in axes:
                out[l.index] = l.tier.split(":", 1)[1]
        return out

    def block_shape_for(self, operand: str) -> Tuple[int, ...]:
        """Pallas block shape: extents of grid/seq dims stay full-block."""
        shape = []
        for idx in self.spec.operands[operand]:
            lvl = next(l for l in self.levels if l.index == idx)
            shape.append(lvl.extent if lvl.tier in ("mxu",) else 1)
        return tuple(shape)

    def validate(self):
        """Tier order must respect the hierarchy (mesh ≥ grid ≥ seq ≥ mxu)."""
        rank = {t: i for i, t in enumerate(TIERS)}
        prev = -1
        for l in self.levels:
            r = rank[l.tier]
            if r < prev and not (l.tier == "seq" and prev == rank["grid"]):
                raise ValueError(
                    f"tier {l.tier} of {l.index} is outside a deeper tier"
                )
            prev = max(prev, r)
        return self


def matmul_schedule(
    m: int,
    n: int,
    k: int,
    *,
    block_m: int,
    block_n: int,
    block_k: int,
    data_shard: int = 1,
    model_shard: int = 1,
    pod_shard: int = 1,
    from_spec: Optional[ContractionSpec] = None,
) -> Schedule:
    """The canonical fully-hierarchical matmul schedule.

    Subdivisions (paper's subdiv, applied level by level):
      i: pods*data shards -> grid blocks of block_m -> mxu rows
      k(N dim): model shards -> grid blocks of block_n -> mxu cols
      j: seq loop of block_k chunks -> mxu depth
    """
    from .enumerate import matmul_spec

    spec = from_spec or matmul_spec(m, k, n)  # extents: i=m, j=k, k=n
    s = spec
    levels = []
    i_rem, n_rem, j_rem = m, n, k
    dp = pod_shard * data_shard
    if pod_shard > 1:
        s = s.subdivide("i", i_rem // pod_shard)
        levels.append(Level("io", "mesh:pod", pod_shard))
        i_name, i_rem = "ii", i_rem // pod_shard
    else:
        i_name = "i"
    if data_shard > 1:
        s = s.subdivide(i_name, i_rem // data_shard)
        levels.append(Level(i_name + "o", "mesh:data", data_shard))
        i_name, i_rem = i_name + "i", i_rem // data_shard
    k_name = "k"
    if model_shard > 1:
        s = s.subdivide(k_name, n_rem // model_shard)
        levels.append(Level(k_name + "o", "mesh:model", model_shard))
        k_name, n_rem = k_name + "i", n_rem // model_shard
    # grid tiers
    s = s.subdivide(i_name, block_m)
    levels.append(Level(i_name + "o", "grid", i_rem // block_m))
    s = s.subdivide(k_name, block_n)
    levels.append(Level(k_name + "o", "grid", n_rem // block_n))
    # sequential k-loop then MXU tile
    s = s.subdivide("j", block_k)
    levels.append(Level("jo", "seq", j_rem // block_k))
    levels.append(Level(i_name + "i", "mxu", block_m))
    levels.append(Level("ji", "mxu", block_k))
    levels.append(Level(k_name + "i", "mxu", block_n))
    return Schedule(s, tuple(levels)).validate()
