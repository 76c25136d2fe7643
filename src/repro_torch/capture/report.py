"""Per-model capture-report artifact: sites harvested/dispatched/fallback.

The port's counterpart of the reference's ``scripts/capture_report.py``.
Harvests every demo config (dense / MoE / SSM — the conformance trio of
``capture.demo_configs``) plus any archs named on the command line, at
each trace point (train / prefill / decode), on fake tensors — no
parameter allocation, no kernel launch — and writes one JSON document per
model with the full per-site breakdown (spec name, extents, dtype,
dispatch status, fallback reason), and ``index.json`` with the counts.

    python -m repro_torch.capture.report --out capture-report \\
        [--arch qwen3-8b ...] [--smoke] [--batch 2] [--seq 64] \\
        [--device cpu]

Eligibility is classified with ``interpret=True`` on ``--device`` (the
CPU by default: the reference's 128-alignment gate; ``cuda``: every
non-empty dense product, as the card launches them).  The exit code is
non-zero if any demo config dispatches zero sites at the train trace
point (the conformance floor).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="capture-report artifact")
    ap.add_argument("--out", default="capture-report",
                    help="output directory for the per-model JSON files")
    ap.add_argument("--arch", action="append", default=[],
                    help="extra arch ids to harvest (repeatable)")
    ap.add_argument("--smoke", action="store_true",
                    help="use smoke() for the extra --arch configs")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default="cpu",
                    help="device of the fake tensors: eligibility is its")
    args = ap.parse_args(argv)

    from .. import capture
    from ..configs import get_config

    configs = dict(capture.demo_configs())
    for arch in args.arch:
        cfg = get_config(arch)
        configs[arch] = cfg.smoke() if args.smoke else cfg

    batch = args.batch or capture.DEMO_BATCH
    seq = args.seq or capture.DEMO_SEQ
    os.makedirs(args.out, exist_ok=True)

    failures = []
    index = {}
    for name, cfg in sorted(configs.items()):
        doc = {"config": name, "arch_id": cfg.arch_id, "kinds": {}}
        for kind in capture.KINDS:
            try:
                _, rep = capture.model_capture(
                    cfg, batch=batch, seq=seq, kind=kind, interpret=True,
                    device=args.device,
                )
            except Exception as e:  # noqa: BLE001 — report, don't die
                doc["kinds"][kind] = {"error": f"{type(e).__name__}: {e}"}
                continue
            doc["kinds"][kind] = rep.as_dict()
            print(f"[capture-report] {name}/{kind}: {rep.summary()}")
            if kind == "train" and name in ("dense", "moe", "ssm"):
                if rep.dispatched < 1:
                    failures.append(f"{name}/train dispatched 0 sites")
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        index[name] = {
            kind: {k: v for k, v in d.items()
                   if k in ("harvested", "dispatched", "fallback", "error")}
            for kind, d in doc["kinds"].items()
        }

    with open(os.path.join(args.out, "index.json"), "w") as f:
        json.dump(index, f, indent=2, sort_keys=True)
        f.write("\n")

    if failures:
        print("FAIL:\n  " + "\n  ".join(failures))
        return 1
    print(f"capture-report written to {args.out}/ ({len(configs)} model(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
