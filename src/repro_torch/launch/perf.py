"""Perf harness: trace ONE cell under a named knob combination and report
the roofline-term deltas against the baseline record.

The reference's knobs (combinable via --knob a,b), as the port takes them:

  baseline     no overrides
  remat_dots   REPRO_REMAT_POLICY=dots  (save the products' outputs)
  causal_skip  REPRO_CAUSAL_SKIP=1      (skip fully masked key blocks)
  donate       accepted, changes nothing: the port's optimizer already
               updates params and moments in place (``optim.adamw``)
  dp, zero1, moe_constraint, unembed
               sharding knobs: they come with ROADMAP.md queue A item 6c
               (part 2) and raise

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-8b \\
      --shape train_4k --knob remat_dots --out results_perf

The baseline record is ``launch.dryrun``'s, ``--baseline-dir``
(``results``) ``/<arch>__<shape>__1.json``.
"""

from __future__ import annotations

import argparse
import json
import os

_KNOB_ENV = {
    "baseline": {},
    "remat_dots": {"REPRO_REMAT_POLICY": "dots"},
    "causal_skip": {"REPRO_CAUSAL_SKIP": "1"},
    "donate": {},
}

#: the reference's knobs that shard: the mesh tier's
MESH_KNOBS = ("dp", "zero1", "moe_constraint", "unembed")

DONATE_NOTE = ("donate changes nothing: the optimizer updates params and "
               "moments in place")


def run(arch: str, shape: str, knobs, device="cuda", out="results_perf",
        baseline_dir="results", cfg=None, shape_cfg=None) -> dict:
    """Trace the cell with ``knobs`` set, write its record and print its
    roofline terms and their deltas against the baseline record (returned
    under ``vs_baseline`` with the analyzed row).  ``cfg`` and
    ``shape_cfg`` stand in for the registry's, as in ``run_cell``."""
    for k in knobs:
        if k in MESH_KNOBS:
            raise NotImplementedError(
                f"knob {k!r} shards the step: it comes with ROADMAP.md "
                f"queue A item 6c (part 2)")
        if k not in _KNOB_ENV:
            raise ValueError(f"unknown knob {k!r}; have "
                             f"{sorted(_KNOB_ENV) + list(MESH_KNOBS)}")
    saved = {env: os.environ.get(env) for k in knobs for env in _KNOB_ENV[k]}
    for k in knobs:
        os.environ.update(_KNOB_ENV[k])
    try:
        from ..roofline.analysis import analyze_cell, param_counts
        from .dryrun import run_cell

        rec = run_cell(arch, shape, device=device, cfg=cfg, shape=shape_cfg)
    finally:
        for env, val in saved.items():
            if val is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = val
    rec["knobs"] = list(knobs)
    if "donate" in knobs:
        rec["donate"] = DONATE_NOTE
    os.makedirs(out, exist_ok=True)
    tag = f"{arch}__{shape}__1__{'+'.join(knobs)}"
    with open(os.path.join(out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)

    counts = param_counts(arch, cfg)
    row = analyze_cell(rec, counts)
    print(f"\n=== {tag}: {rec['status']} ===")
    if rec["status"] != "ok":
        print(rec.get("error", rec.get("reason")))
        return row
    if "donate" in knobs:
        print(f"  {DONATE_NOTE}")
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "useful_ratio", "roofline_fraction"):
        print(f"  {k:20s} {row[k]}")
    print(f"  peak_memory_GiB      "
          f"{rec['memory'].get('peak_memory_in_bytes', 0)/2**30:.2f}")

    base_path = os.path.join(baseline_dir, f"{arch}__{shape}__1.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = analyze_cell(json.load(f), counts)
        if base["status"] == "ok":
            print("  --- vs baseline ---")
            row["vs_baseline"] = {}
            for k in ("compute_s", "memory_s", "collective_s"):
                b, n = base[k], row[k]
                pct = (n / b - 1) * 100 if b else 0.0
                row["vs_baseline"][k] = (b, n)
                print(f"  {k:20s} {b:.4g} -> {n:.4g} ({pct:+.1f}%)")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["1", "pod", "multipod"], default="1")
    ap.add_argument("--knob", default="baseline",
                    help="comma-separated knob names")
    ap.add_argument("--out", default="results_perf")
    ap.add_argument("--baseline-dir", default="results")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1":
        from .dryrun import MESH_REFUSAL

        raise NotImplementedError(MESH_REFUSAL)
    run(args.arch, args.shape, args.knob.split(","), device=args.device,
        out=args.out, baseline_dir=args.baseline_dir)


if __name__ == "__main__":
    main()
