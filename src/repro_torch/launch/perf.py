"""Perf harness: trace ONE cell under a named knob combination and report
the roofline-term deltas against the baseline record.

The reference's knobs (combinable via --knob a,b), as the port takes them:

  baseline     no overrides
  remat_dots   REPRO_REMAT_POLICY=dots  (save the products' outputs)
  causal_skip  REPRO_CAUSAL_SKIP=1      (skip fully masked key blocks)
  donate       accepted, changes nothing: the port's optimizer already
               updates params and moments in place (``optim.adamw``)
  dp           REPRO_SHARDING=dp        (no tensor parallelism)
  zero1        REPRO_SHARDING=zero1 + REPRO_OPT_INT8=1 (TP-only params,
               int8 moments over the whole mesh)
  moe_constraint  REPRO_MOE_CONSTRAINT=1  (dispatched MoE tokens placed
               on P("model", None, None))
  unembed      REPRO_UNEMBED_FIX=1      (the unembedding over vocab only)

The four sharding knobs act on a sharded step: run them with ``--mesh
pod`` or ``multipod`` (one rank's share of the step over the production
mesh, ``launch.dryrun``), as the reference does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-8b \\
      --shape train_4k --knob remat_dots --out results_perf

The baseline record is ``launch.dryrun``'s, ``--baseline-dir``
(``results``) ``/<arch>__<shape>__<1|sp|mp>.json``.
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
    "dp": {"REPRO_SHARDING": "dp"},
    "zero1": {"REPRO_SHARDING": "zero1", "REPRO_OPT_INT8": "1"},
    "moe_constraint": {"REPRO_MOE_CONSTRAINT": "1"},
    "unembed": {"REPRO_UNEMBED_FIX": "1"},
}

#: the reference's knobs that shard: they act on a pod or multi-pod record
MESH_KNOBS = ("dp", "zero1", "moe_constraint", "unembed")

DONATE_NOTE = ("donate changes nothing: the optimizer updates params and "
               "moments in place")


def run(arch: str, shape: str, knobs, device="cuda", out="results_perf",
        baseline_dir="results", cfg=None, shape_cfg=None,
        mesh: str = "1") -> dict:
    """Trace the cell with ``knobs`` set on ``mesh`` (``"1"``, ``"pod"``,
    ``"multipod"``, as ``run_cell``), write its record and print its
    roofline terms and their deltas against the baseline record of the
    same mesh (returned under ``vs_baseline`` with the analyzed row).
    ``cfg`` and ``shape_cfg`` stand in for the registry's, as in
    ``run_cell``.  Every variable a knob sets is restored afterwards."""
    from .dryrun import MESHES

    for k in knobs:
        if k not in _KNOB_ENV:
            raise ValueError(f"unknown knob {k!r}; have {sorted(_KNOB_ENV)}")
        if k in MESH_KNOBS and mesh == "1":
            raise ValueError(f"knob {k!r} shards the step: run it with "
                             f"--mesh pod or multipod")
    saved = {env: os.environ.get(env) for k in knobs for env in _KNOB_ENV[k]}
    for k in knobs:
        os.environ.update(_KNOB_ENV[k])
    try:
        from ..roofline.analysis import analyze_cell, param_counts
        from .dryrun import run_cell

        rec = run_cell(arch, shape, device=device, cfg=cfg, shape=shape_cfg,
                       mesh=mesh)
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
    suffix = MESHES[mesh][2]
    tag = f"{arch}__{shape}__{suffix}__{'+'.join(knobs)}"
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

    base_path = os.path.join(baseline_dir, f"{arch}__{shape}__{suffix}.json")
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
    run(args.arch, args.shape, args.knob.split(","), device=args.device,
        out=args.out, baseline_dir=args.baseline_dir, mesh=args.mesh)


if __name__ == "__main__":
    main()
