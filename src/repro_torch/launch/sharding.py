"""Logical-axis -> mesh-axis sharding rules (the distributed subdiv level).

A port of the reference's ``launch/sharding.py``.  A parameter annotated
``('embed', 'mlp')`` becomes, on the production mesh, the reference's
``PartitionSpec('data', 'model')`` -- FSDP over the data axis and tensor
parallelism over the model axis: ``subdiv`` applied at the outermost
hierarchy level, with the mesh axis bound to the new outer dimension.

Rules are *preference lists*; an axis is taken only if it divides the dim
(e.g. whisper's vocab 51865 is not divisible by 16 -> the unembed stays
replicated).  The chosen spec is therefore always valid on the target
mesh.

Each function returns ``codegen.mesh_gen.Placements``: one DTensor
placement per mesh dimension (what ``distribute_tensor`` takes), whose
``.spec`` keeps the reference's ``PartitionSpec`` entries, so the two
compare entry for entry.  A mesh is anything with ``axis_names`` and
``shape`` (axis -> size): a ``launch.mesh.Mesh``, a ``MeshShape``, or a
stand-in.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

from ..codegen.mesh_gen import Placements

#: logical axis -> ordered mesh-axis preferences (the default "tp" profile)
PARAM_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "vocab": (("model",),),
    "embed": (("data",),),          # FSDP
    "heads": (("model",),),         # TP over (flattened) attention heads
    "kv": (("model",),),
    "mlp": (("model",),),           # TP over FFN hidden
    "experts": (("model",), ("data",)),  # EP; kimi's 384 also splits on data
    "layers": (),                   # scan axis: never sharded
    "batch": (("pod", "data"), ("data",)),
    "seq": (("model",),),           # SP for sequence-sharded activations
    "seq_kv": (("model",), ("data",)),  # KV-cache sequence dim
}

#: "dp" profile -- no tensor parallelism: the model axis joins data
#: parallelism and weights are FSDP-sharded over both axes
DP_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "vocab": (("model",),),
    "embed": (("data",),),
    "heads": (),
    "kv": (),
    "mlp": (),
    "experts": (("model",), ("data",)),  # EP stays: MoE without EP can't fit
    "layers": (),
    "batch": (("pod", "data", "model"), ("data", "model"), ("data",)),
    "seq": (("model",),),
    "seq_kv": (("model",), ("data",)),
}

#: "zero1" profile -- params TP-sharded only (no per-layer FSDP gather);
#: 8-bit optimizer moments shard their flat blocks over the whole mesh
#: (``steps.opt_shardings``)
ZERO1_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = dict(
    PARAM_RULES, embed=(), vocab=(("model",), ("data",)),
)

PROFILES = {"tp": PARAM_RULES, "dp": DP_RULES, "zero1": ZERO1_RULES}


def active_rules() -> Dict[str, Tuple[Tuple[str, ...], ...]]:
    """Rules for the profile in ``$REPRO_SHARDING`` (default 'tp')."""
    return PROFILES[os.environ.get("REPRO_SHARDING", "tp")]


def _mesh_size(mesh, axes: Tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def spec_for(
    mesh,
    logical: Optional[Tuple[Optional[str], ...]],
    dims: Tuple[int, ...],
    rules: Optional[Dict] = None,
) -> Placements:
    """Placements for one tensor given its logical axes and shape."""
    if rules is None:
        rules = active_rules()
    if logical is None:
        return Placements((), mesh.axis_names)
    assert len(logical) == len(dims), (logical, dims)
    used: set = set()
    parts: list = [None] * len(dims)

    def try_assign(i, name, dim):
        for pref in rules.get(name, ()) if name else ():
            axes = tuple(a for a in pref if a in mesh.axis_names)
            if not axes or any(a in used for a in axes):
                continue
            if dim % _mesh_size(mesh, axes) == 0:
                parts[i] = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                return

    # the unembed fix: FSDP-sharding the unembed's contraction dim shards
    # the contraction itself (a replicated-token f32 logits partial plus a
    # large all-reduce); with REPRO_UNEMBED_FIX=1 it is sharded over vocab
    # only
    if (
        os.environ.get("REPRO_UNEMBED_FIX") == "1"
        and "vocab" in logical
        and "embed" in logical
    ):
        logical = tuple(
            None if name == "embed" else name for name in logical
        )

    # two passes: structural dims (heads/kv/experts/...) get first pick of
    # the mesh axes; sequence dims only take what is left
    fallback = {"seq", "seq_kv"}
    for i, (name, dim) in enumerate(zip(logical, dims)):
        if name not in fallback:
            try_assign(i, name, dim)
    for i, (name, dim) in enumerate(zip(logical, dims)):
        if name in fallback:
            try_assign(i, name, dim)
    # trailing Nones are implicit
    while parts and parts[-1] is None:
        parts.pop()
    return Placements(parts, mesh.axis_names)


def tree_shardings(mesh, shapes_tree, axes_tree, rules: Optional[Dict] = None):
    """A Placements tree for a tree of tensors (or anything with
    ``.shape``) and its logical-axes twin (nested dicts, leaves tuples or
    None)."""
    if rules is None:
        rules = active_rules()

    def walk(s, a):
        if isinstance(s, dict):
            return {k: walk(v, a[k]) for k, v in s.items()}
        return spec_for(mesh, a, tuple(s.shape), rules)

    return walk(shapes_tree, axes_tree)


def quantized_sharding(mesh, q_shapes):
    """Placements of a Quantized optimizer moment: the flat block axis
    sharded over every mesh axis that divides it (what lets kimi-k2's
    8-bit Adam states spread across the whole mesh)."""
    nblocks = q_shapes.q.shape[0]
    axes = [a for a in ("data", "model") if a in mesh.axis_names]
    good = tuple(
        a for a in axes if nblocks % _mesh_size(mesh, tuple(axes)) == 0
    )
    parts = (tuple(axes),) if good == tuple(axes) and axes else ()
    spec = Placements(parts, mesh.axis_names)
    return dict(q=spec, scale=spec)


def batch_spec_for(mesh, shape: Tuple[int, ...],
                   seq_axis: Optional[int] = None) -> Placements:
    """Inputs: shard dim 0 (batch) per the active profile's batch rule;
    fall back to sequence sharding (long_500k's batch=1)."""
    rules = active_rules()
    for pref in rules["batch"]:
        axes = tuple(a for a in pref if a in mesh.axis_names)
        if not axes:
            continue
        if shape[0] % _mesh_size(mesh, axes) == 0:
            return Placements((axes if len(axes) > 1 else axes[0],),
                              mesh.axis_names)
    if seq_axis is not None and len(shape) > seq_axis:
        if shape[seq_axis] % mesh.shape.get("model", 1) == 0:
            parts: list = [None] * (seq_axis + 1)
            parts[seq_axis] = "model"
            return Placements(parts, mesh.axis_names)
    return Placements((), mesh.axis_names)


__all__ = [
    "DP_RULES",
    "PARAM_RULES",
    "PROFILES",
    "ZERO1_RULES",
    "active_rules",
    "batch_spec_for",
    "quantized_sharding",
    "spec_for",
    "tree_shardings",
]
