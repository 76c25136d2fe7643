"""Plan-explain: render WHY the search ranked a plan-DB ladder as it did.

A copy of the reference's ``obs/explain.py`` (the same selector grammar,
matching and text), plus the card's columns: a rung of a card ladder
carries a ``card`` record (``search.plandb.entry_from``: the B1 tile plan,
body x tile width x K split, or a fused kernel's plan, kernel, body, block
x CTAs, it was measured with), and its entry gains a table of each such
rung's plan, its measured milliseconds on the card (``measured_s``) and,
for B1, ``core.cost.card_plan_cost``'s prediction (the rung's ``score``)
with its wave count; a fused ladder is measured whole and predicts
nothing ("-").  A DB without card records renders as the reference
renders it.

``search_schedule`` persists, per rung, the roofline terms its decision
was made from (``explain``: compute/HBM/collective seconds, penalty,
shards — see ``search.beam.CostEstimate``) plus a sample of the sound
bound cuts (``cuts``: the candidates dropped because their lower bound
already exceeded the best complete score).  Since PLAN_VERSION 3 each
entry also carries its ``spec`` signature and ``dtype``, so a human
selector can find entries without recomputing sha256 keys:

    python -m repro_torch.obs.report --explain 'matmul@512x512x512'
    python -m repro_torch.obs.report --explain 'matmul.dA@mesh=2x4'
    python -m repro_torch.obs.report --explain 'matmul@512x512x512@dtype=f32'

Selector grammar (all parts after the name optional, any order):

    name[@MxKx...][@mesh=AxB][@dtype=NAME]

``MxKx...`` matches the spec's extents in declaration order (the order
``spec_signature`` serializes them).  Everything here is pure formatting
over the DB's JSON — no torch, no search imports — so the report stays
usable on machines that only hold the DB file.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple


def parse_selector(sel: str) -> Dict[str, Optional[str]]:
    """``'matmul@512x512x512@mesh=2x4@dtype=float32'`` -> parts dict."""
    parts = [p for p in sel.split("@") if p]
    if not parts:
        raise ValueError(f"empty selector {sel!r}")
    out: Dict[str, Optional[str]] = {
        "name": parts[0], "shape": None, "mesh": None, "dtype": None,
    }
    for p in parts[1:]:
        if p.startswith("mesh="):
            out["mesh"] = p[len("mesh="):]
        elif p.startswith("dtype="):
            out["dtype"] = p[len("dtype="):]
        elif all(tok.isdigit() for tok in p.split("x")):
            out["shape"] = p
        else:
            raise ValueError(
                f"unrecognized selector part {p!r} in {sel!r} "
                f"(want MxKx..., mesh=AxB or dtype=NAME)"
            )
    return out


def entry_shape(entry: Dict[str, Any]) -> Optional[str]:
    """'512x512x512'-style extents string of an entry's stored spec."""
    spec = entry.get("spec")
    if not spec or "extents" not in spec:
        return None
    return "x".join(str(v) for v in spec["extents"].values())


def match_entries(
    data: Dict[str, Any], selector: str
) -> List[Tuple[str, Dict[str, Any]]]:
    """All (key, entry) pairs of a plan-DB dict matching ``selector``.

    Entries predating PLAN_VERSION 3 carry no ``spec`` and can never
    match (their keys are opaque hashes) — re-sweep to upgrade them.
    """
    want = parse_selector(selector)
    out = []
    for key, entry in data.items():
        if not isinstance(entry, dict) or "ranked" not in entry:
            continue  # not a plan entry (autotune rows in a merged file)
        spec = entry.get("spec")
        if not spec:
            continue
        if spec.get("name") != want["name"]:
            continue
        if want["shape"] and entry_shape(entry) != want["shape"]:
            continue
        if want["mesh"] and (entry.get("mesh") or "") != want["mesh"]:
            continue
        if want["mesh"] is None and entry.get("mesh"):
            # unqualified selector: prefer the single-device ladder; ask
            # for @mesh=AxB explicitly to see the sharded one
            continue
        if want["dtype"] and entry.get("dtype") != want["dtype"]:
            continue
        out.append((key, entry))
    return sorted(out, key=lambda kv: kv[0])


def _fmt_s(v: Any) -> str:
    if v is None:
        return "-"
    return f"{float(v):.3g}"


def _card_plan(c: Dict[str, Any]) -> str:
    """A rung's card plan as text: B1's "body tile_nxsplits", the 8-bit
    ring's "q8 ring ctas", the chain's "chain assoc xcluster", a
    fused kernel's "kernel body blockxctas"."""
    if c.get("kernel") == "q8":
        return f"q8 ring {c.get('ctas', '?')}"
    if c.get("kernel") == "chain":
        return f"chain {c.get('assoc', '?')} x{c.get('cluster', '?')}"
    if "kernel" in c:
        return (f"{c['kernel']} {c.get('body', '?')} "
                f"{c.get('block', '?')}x{c.get('ctas', '?')}")
    return (f"{c.get('body', '?')} {c.get('tile_n', '?')}x"
            f"{c.get('splits', '?')}")


def format_entry(key: str, entry: Dict[str, Any]) -> str:
    """The ranked why-this-plan table for one plan-DB entry."""
    lines: List[str] = []
    spec = entry.get("spec") or {}
    head = spec.get("name", "?")
    shape = entry_shape(entry)
    if shape:
        head += f"@{shape}"
    if entry.get("mesh"):
        head += f"@mesh={entry['mesh']}"
    if entry.get("dtype"):
        head += f"@dtype={entry['dtype']}"
    lines.append(f"plan {head}")
    lines.append(f"  key {key}  (v{entry.get('v', '?')})")
    stats = entry.get("stats") or {}
    if stats:
        lines.append(
            "  search: "
            + ", ".join(f"{k}={v}" for k, v in sorted(stats.items()))
        )
    cols = (
        f"  {'#':>2} {'source':<10} {'coll':<5} {'measured_s':>10} "
        f"{'score':>9} {'bound':>9} {'compute_s':>9} {'hbm_s':>9} "
        f"{'comm_s':>9} {'penalty':>7} vmem"
    )
    lines.append(cols)
    for i, rung in enumerate(entry.get("ranked", [])):
        ex = rung.get("explain") or {}
        lines.append(
            f"  {i:>2} {rung.get('source', 'search'):<10} "
            f"{rung.get('collective') or '-':<5} "
            f"{_fmt_s(rung.get('measured_s')):>10} "
            f"{_fmt_s(rung.get('score')):>9} "
            f"{_fmt_s(rung.get('lower_bound')):>9} "
            f"{_fmt_s(ex.get('compute_s')):>9} "
            f"{_fmt_s(ex.get('hbm_s')):>9} "
            f"{_fmt_s(ex.get('comm_s')):>9} "
            f"{_fmt_s(ex.get('penalty')):>7} "
            f"{'ok' if rung.get('fits_vmem', True) else 'SPILL'}"
        )
    card_rows = [(i, r) for i, r in enumerate(entry.get("ranked", []))
                 if r.get("card")]
    if card_rows:
        plans = [_card_plan(r["card"]) for _, r in card_rows]
        width = max([14] + [len(p) for p in plans])
        lines.append(f"  card  {'#':>2} {'plan':<{width}} "
                     f"{'measured_ms':>11} {'predicted_ms':>12} "
                     f"{'waves':>5}")
        for (i, rung), plan in zip(card_rows, plans):
            ms = rung.get("measured_s")
            measured = "-" if ms is None else f"{float(ms) * 1e3:.4f}"
            score = float(rung.get("score", 0.0))
            predicted = ("-" if score == float("inf")
                         else f"{score * 1e3:.4f}")
            waves = (rung.get("explain") or {}).get("waves", "-")
            lines.append(f"        {i:>2} {plan:<{width}} {measured:>11} "
                         f"{predicted:>12} {waves:>5}")
    cuts = entry.get("cuts") or []
    if cuts:
        lines.append(f"  bound cuts (sample of {len(cuts)}):")
        for c in cuts:
            lines.append(
                f"    bound {_fmt_s(c.get('lower_bound'))} >= best "
                f"{_fmt_s(c.get('best_score'))}  {c.get('key', '?')}"
            )
    return "\n".join(lines)


def explain(db_path: str, selector: str) -> str:
    """Load a plan-DB file and render every entry matching ``selector``."""
    with open(db_path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{db_path}: not a plan-DB JSON object")
    matches = match_entries(data, selector)
    if not matches:
        names = sorted(
            {
                e["spec"]["name"]
                for e in data.values()
                if isinstance(e, dict) and e.get("spec")
            }
        )
        raise LookupError(
            f"no plan-DB entry matches {selector!r} in {db_path} "
            f"(spec names present: {names or 'none — pre-v3 DB? re-sweep'})"
        )
    return "\n\n".join(format_entry(k, e) for k, e in matches)
