"""Roofline model helpers the variant search scores with.

The reference's ``roofline/analysis.py`` has two halves.  This module is
the first: the interconnect byte model of a collective, the exposed time
of a mesh-sharded reduction, the online-softmax rescale term of fused
attention, the ragged-tail factor of a grouped matmul and the byte model
of the int8 / fp8 tiers, which ``search.beam.estimate`` adds to its
roofline.  They are pure arithmetic, copied so that the port's beam scores
every candidate exactly as the reference's does; the constants are the
reference's TPU (``core.cost.TPU`` keeps the same numbers), never the
card's (``core.cost.H100``).

The other half -- the table of the dry-run records (``param_counts``,
``model_flops``, ``analyze_cell``, ``load_results``, ``analyze_all``,
``markdown_table``, ``main``) -- reads ``launch/dryrun``'s output and
comes with it (``ROADMAP.md`` queue A, item 6d).
"""

from __future__ import annotations

import math

PEAK_FLOPS = 197e12   # bf16 / chip
HBM_BW = 819e9        # B/s / chip
ICI_BW = 50e9         # B/s / link

#: bytes a ring algorithm moves per device, as a multiple of the payload:
#: ring all-reduce sends the payload twice (reduce-scatter + all-gather),
#: the one-phase collectives once.  The (shards-1)/shards factor is applied
#: by ``collective_seconds``.
COLLECTIVE_BYTE_FACTOR = {
    "psum": 2.0,          # lax.psum lowers to an all-reduce
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
}


def collective_seconds(
    kind: str, nbytes: float, shards: int, hw_ici_bw: float = ICI_BW
) -> float:
    """Per-device link time of one collective over ``shards`` participants.

    Ring-algorithm byte model: a payload of ``nbytes`` costs
    ``factor * nbytes * (shards - 1) / shards`` bytes on the busiest link,
    where ``factor`` is 2 for all-reduce (reduce-scatter then all-gather)
    and 1 for the single-phase collectives.  This is the interconnect half
    of the roofline the mesh-tier search scores against (``search.beam``).
    """
    if shards <= 1:
        return 0.0
    factor = COLLECTIVE_BYTE_FACTOR[kind]
    return factor * nbytes * (shards - 1) / shards / hw_ici_bw


def sharded_reduce_seconds(
    nbytes: float,
    shards: int,
    *,
    collective: str = "psum",
    compute_s: float = 0.0,
    hw_ici_bw: float = ICI_BW,
) -> float:
    """Exposed communication time to finish a mesh-sharded reduction.

    ``psum``: a plain all-reduce of the per-device partial output — fully
    exposed (the kernel must finish before the collective starts).

    ``ring``: the ring-overlap lowering (``codegen.collectives.ring_psum``,
    promoted from ``launch.overlap``): the reduce-scatter phase pipelines
    behind the partial-product compute (each ppermute hop hides behind the
    next chunk's MXU work, Wang et al.-style), so only the part of it that
    exceeds ``compute_s`` plus the trailing all-gather is exposed.
    """
    if shards <= 1:
        return 0.0
    if collective == "ring":
        rs = collective_seconds("reduce-scatter", nbytes, shards, hw_ici_bw)
        ag = collective_seconds("all-gather", nbytes, shards, hw_ici_bw)
        return max(rs - compute_s, 0.0) + ag
    return collective_seconds("psum", nbytes, shards, hw_ici_bw)


def attention_rescale_seconds(
    h: int, s: int, e: int, t_steps: int, peak: float = PEAK_FLOPS
) -> float:
    """VPU time of the online-softmax running state per KV block.

    Every sequential KV step of the fused attention kernel rescales the
    (h, s) running max/sum and the (h, s, e) accumulator by
    ``alpha = exp(m_prev - m_next)`` — roughly ``e + 4`` elementwise ops
    per query row per step, work that a one-pass softmax (``t_steps == 1``)
    does not pay.  The beam adds this term so it can trade smaller KV
    chunks (less VMEM) against the extra rescale traffic; with ``t``
    defaulted to its whole extent the term is minimal, which keeps the
    bound cut sound for partial states.
    """
    return t_steps * h * s * (e + 4) / peak


def grouped_tail_factor(group_sizes, bm: int) -> float:
    """Occupancy loss of the ragged tails in a grouped matmul, >= 1.

    The group-offset kernel walks each group's rows in ``bm``-sized tiles,
    so a group of ``s_g`` rows issues ``ceil(s_g / bm)`` tiles and the
    MXU processes ``ceil(s_g / bm) * bm`` rows of work for ``s_g`` rows of
    output.  The factor is the issued/useful row ratio over all groups —
    1.0 when every group size divides ``bm``; empty groups cost nothing
    (their tile loop is skipped entirely).
    """
    useful = sum(group_sizes)
    if useful <= 0 or bm <= 0:
        return 1.0
    issued = sum(-(-s // bm) * bm for s in group_sizes if s > 0)
    return max(issued / useful, 1.0)


#: storage bytes per element of the quantized tiers (core.enumerate
#: QuantMeta dtypes plus CLI-format aliases)
QUANT_STORAGE_BYTES = {
    "int8": 1,
    "float8_e4m3fn": 1,
    "fp8": 1,
}

#: accumulator/output bytes per element (int32 / float32 both 4)
QUANT_ACCUM_BYTES = 4


def quant_byte_model(quant, elem_bytes: int):
    """(operand_bytes, out_bytes) per element for a maybe-quantized spec.

    ``quant`` is a ``core.enumerate.QuantMeta`` (or None).  Operands of a
    quantized contraction stream from HBM at storage precision (1 byte);
    the output leaves at accumulator precision (4 bytes — int32 for int8,
    f32 for fp8) since the dequant epilogue keeps real values.  Non-quant
    specs keep the caller's ``elem_bytes`` on both sides — this is the
    memory-bandwidth advantage the beam scores when it trades precision
    tiers (``search.beam.estimate``) and the bench gate checks
    (``scripts/bench_smoke.py --quant``).
    """
    if quant is None:
        return elem_bytes, elem_bytes
    return QUANT_STORAGE_BYTES[quant.dtype], QUANT_ACCUM_BYTES


def quant_hbm_bytes(spec, elem_bytes: int = 4) -> float:
    """One-pass HBM byte floor of a contraction: read every operand once,
    write the output once, at the spec's storage precisions."""
    root = spec.root()
    op_b, out_b = quant_byte_model(getattr(root, "quant", None), elem_bytes)
    read = sum(
        math.prod(root.extents[i] for i in axes) * op_b
        for axes in root.operands.values()
    )
    write = math.prod(root.extents[i] for i in root.output) * out_b
    return float(read + write)
