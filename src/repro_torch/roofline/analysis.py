"""Roofline helpers the variant search scores with, and the roofline
table of the dry-run records.

The reference's ``roofline/analysis.py`` has two halves, both here.

The first is the interconnect byte model of a collective, the exposed time
of a mesh-sharded reduction, the online-softmax rescale term of fused
attention, the ragged-tail factor of a grouped matmul and the byte model
of the int8 / fp8 tiers, which ``search.beam.estimate`` adds to its
roofline.  They are pure arithmetic, copied so that the port's beam scores
every candidate exactly as the reference's does; the constants are the
reference's TPU (``core.cost.TPU`` keeps the same numbers), never the
card's (``core.cost.H100``).

The second reads the per-cell records ``launch.dryrun`` writes and derives
three terms per (arch x shape):

    compute_s    = dot FLOPs / peak
    memory_s     = (dot bytes + other ops' output bytes) / HBM bandwidth
    collective_s = collective bytes / link bandwidth

A record of the port (``"hw": "h100"``) is priced at ``core.cost.H100``'s
bf16 peak and HBM rate (its collectives are 0 on one card); a record
without ``hw`` (the reference's) at the reference's TPU constants below,
so that both packages read the same numbers off the same record.
``param_counts`` reads the model's params off its ``init`` on the meta
device (never allocated).  ``MODEL_FLOPS`` is 6 N_active tokens for
training and 2 N_active tokens for inference.  These terms are analytic: the card's
times come from ``chip_smoke.py`` and ``scripts/chip_compare.py``.

Usage:  PYTHONPATH=src python -m repro_torch.roofline.analysis --results
results/
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import Dict, List, Optional

from ..core.cost import H100

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


# ---------------------------------------------------------------------------
# the roofline table of the dry-run records
# ---------------------------------------------------------------------------

#: (peak FLOP/s, HBM B/s, link B/s) by a record's ``hw``; None is the
#: reference's TPU.  The H100's link is NVLink 4's 450 GB/s a direction,
#: from the data sheet: a pod or multi-pod dry-run's per-device collective
#: bytes over it give the collective term.  A 16-wide mesh axis spans two
#: 8-card NVLink domains, whose slower inter-node links the term leaves
#: out, so it is a lower bound.
HW_TERMS = {
    None: (PEAK_FLOPS, HBM_BW, ICI_BW),
    "h100": (H100["peak_bf16"], H100["hbm_bw"], 450e9),
}

_SUGGEST = {
    "compute": "raise arithmetic efficiency: larger per-chip batch or less "
               "remat recompute (MODEL/HLO flops ratio shows the headroom)",
    "memory": "cut HBM traffic: fuse elementwise chains into the matmul "
              "epilogues (paper eq 27) and keep KV/activations in bf16",
    "collective": "re-shard to cheaper collectives: move the all-gather off "
                  "the critical path (overlapped collective matmul) or "
                  "shard the other operand dim (paper's flip exchange)",
}


def param_counts(arch: str, cfg=None) -> Dict[str, float]:
    """Total and active parameter counts of ``arch``'s params (or of
    ``cfg``, a cut of it), from the model's ``init`` on the meta device
    (no allocation); expert leaves (under ``moe``, not the shared expert
    or the router) count ``top_k / n_experts`` toward the active count."""
    import torch

    from ..configs import get_config
    from ..models.api import get_api
    from ..optim.adamw import leaves

    cfg = cfg or get_config(arch)
    params = get_api(cfg).init(cfg, None, torch.device("meta"))
    total = 0
    expert = 0
    for path, leaf in leaves(params):
        n = math.prod(leaf.shape)
        total += n
        keys = "/".join(path)
        if "moe" in keys and "shared" not in keys and "router" not in keys:
            expert += n
    active = total
    if cfg.moe is not None and expert:
        active = total - expert * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    return {"total": float(total), "active": float(active)}


def model_flops(arch: str, shape_name: str, counts: Dict[str, float]) -> float:
    from ..configs import SHAPES

    s = SHAPES[shape_name]
    n = counts["active"]
    if s.kind == "train":
        tokens = s.global_batch * s.seq_len
        return 6.0 * n * tokens
    if s.kind == "prefill":
        tokens = s.global_batch * s.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * s.global_batch


def analyze_cell(rec: Dict, counts: Optional[Dict] = None) -> Dict:
    if rec["status"] != "ok":
        return dict(rec)
    peak, hbm, link = HW_TERMS[rec.get("hw")]
    chips = rec["chips"]
    parsed = rec.get("parsed")
    if parsed:  # the op counts (the reference: trip-count-aware HLO)
        flops = parsed["dot_flops"]
        # memory: dot operand/output traffic + non-dot materialized
        # outputs; legacy records (no dot_bytes) fall back to the proxy
        if "dot_bytes" in parsed:
            mem_bytes = parsed["dot_bytes"] + parsed["out_bytes_proxy"]
        else:
            mem_bytes = parsed["out_bytes_proxy"]
        coll_bytes = parsed["collective_bytes"]
    else:  # legacy records: while bodies counted once (undercounts!)
        flops = rec["flops"]
        mem_bytes = rec["bytes_accessed"]
        coll_bytes = sum(
            v for k, v in rec["collectives"].items() if k != "count"
        )
    compute_s = flops / peak
    memory_s = mem_bytes / hbm
    collective_s = coll_bytes / link
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    out = dict(rec)
    out.update(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        collective_bytes=coll_bytes,
        dominant=dominant,
        suggestion=_SUGGEST[dominant],
    )
    if counts:
        mf = model_flops(rec["arch"], rec["shape"], counts)
        total_hlo = flops * chips
        out["model_flops"] = mf
        out["useful_ratio"] = mf / total_hlo if total_hlo else 0.0
        # roofline fraction: the time the chip must spend over the time
        # its bound says it spends; fused = the memory floor of the
        # products' traffic alone
        ideal = (mf / chips) / peak
        bound = max(compute_s, memory_s, collective_s)
        out["roofline_fraction"] = ideal / bound if bound else 0.0
        if parsed and "dot_bytes" in parsed:
            mem_fused_s = parsed["dot_bytes"] / hbm
            bound_fused = max(compute_s, mem_fused_s, collective_s)
            out["memory_fused_s"] = mem_fused_s
            out["roofline_fraction_fused"] = (
                ideal / bound_fused if bound_fused else 0.0
            )
            out["dominant_fused"] = max(
                ("compute", compute_s), ("memory", mem_fused_s),
                ("collective", collective_s),
                key=lambda kv: kv[1],
            )[0]
    return out


def load_results(results_dir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def analyze_all(results_dir: str, with_counts: bool = True) -> List[Dict]:
    cache: Dict[str, Dict] = {}
    rows = []
    for rec in load_results(results_dir):
        counts = None
        if with_counts and rec["status"] == "ok":
            if rec["arch"] not in cache:
                cache[rec["arch"]] = param_counts(rec["arch"])
            counts = cache[rec["arch"]]
        rows.append(analyze_cell(rec, counts))
    return rows


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def markdown_table(rows: List[Dict], mesh: Optional[str] = None) -> str:
    lines = [
        "| arch | shape | mesh | step | compute | memory(ub) | mem(fused) "
        "| collective | bound(fused) | MODEL/HLO | frac | frac(fused) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if mesh and r.get("mesh") != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r.get('mesh','-')} | — | "
                f"skipped | — | — | — | — | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r.get('mesh','-')} | — | "
                f"ERROR | — | — | — | — | — | — | — |"
            )
            continue
        lines.append(
            "| {arch} | {shape} | {mesh} | {step} | {c} | {m} | {mf} | {k} "
            "| {dom} | {ur:.2f} | {rf:.3f} | {rff:.3f} |".format(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                step=r["step"].replace("_step", ""),
                c=_fmt_s(r["compute_s"]), m=_fmt_s(r["memory_s"]),
                mf=_fmt_s(r.get("memory_fused_s", 0.0)),
                k=_fmt_s(r["collective_s"]),
                dom=r.get("dominant_fused", r["dominant"]),
                ur=r.get("useful_ratio", 0.0),
                rf=r.get("roofline_fraction", 0.0),
                rff=r.get("roofline_fraction_fused", 0.0),
            )
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    rows = analyze_all(args.results)
    print(markdown_table(rows, mesh=args.mesh))


if __name__ == "__main__":
    main()
