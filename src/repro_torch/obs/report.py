"""Render and schema-check the port's obs artifacts: plan explains,
traces, metrics.

The counterpart of the reference's ``scripts/obs_report.py``, run as
``python -m repro_torch.obs.report``.  Three modes (combinable; each
validates its input and exits non-zero on schema drift):

  --explain SELECTOR [--plan-db PATH]
      Print the ranked why-this-plan table for every plan-DB entry
      matching the selector (``name[@MxKx...][@mesh=AxB][@dtype=NAME]``,
      e.g. ``matmul@512x4096x1024``; ``obs.explain``), with the card's
      measured and predicted milliseconds where a rung carries a ``card``
      record.  The DB defaults to ``$REPRO_PLAN_DB`` /
      ``~/.cache/repro_torch/plans.json``, the resolution
      ``search.default_plan_db`` uses.
  --trace FILE
      Validate a Chrome-trace JSON (``serve --trace-out``, or any
      ``obs.trace_dump``) and print a per-span-name summary (count,
      total/mean/max duration).  The file must parse as
      ``{"traceEvents": [...]}`` with name/cat/ph/ts/pid/tid per event
      and ``dur`` on complete ("X") events.
  --metrics FILE
      Validate a metrics dump (``serve --metrics-out``, or any
      ``obs.metrics_dump``) and pretty-print counters, gauges and
      histogram summaries.  The file must carry the
      counters/gauges/histograms sections with the summary fields
      ``obs.metrics`` writes (count/sum and, when non-empty,
      min/max/p50/p99).

Pure stdlib and ``obs.explain``: usable on a machine that only holds the
artifact files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import explain as _explain


def _fail(msg: str) -> "NoReturn":  # noqa: F821
    print(f"obs.report: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def default_plan_db_path() -> str:
    return os.environ.get("REPRO_PLAN_DB") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "plans.json"
    )


def run_explain(selector: str, db_path: str) -> None:
    if not os.path.exists(db_path):
        _fail(f"plan DB not found at {db_path} (set --plan-db or "
              f"$REPRO_PLAN_DB; populate with python -m "
              f"repro_torch.search.sweep)")
    try:
        print(_explain.explain(db_path, selector))
    except (LookupError, ValueError) as e:
        _fail(str(e))


_EVENT_REQUIRED = ("name", "cat", "ph", "ts", "pid", "tid")


def run_trace(path: str) -> None:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        _fail(f"{path}: unreadable trace JSON ({e})")
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        _fail(f"{path}: not a Chrome-trace document "
              f"(want object with a traceEvents list)")
    events = doc["traceEvents"]
    per: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            _fail(f"{path}: traceEvents[{i}] is not an object")
        missing = [k for k in _EVENT_REQUIRED if k not in ev]
        if missing:
            _fail(f"{path}: traceEvents[{i}] missing {missing}")
        if ev["ph"] == "X" and "dur" not in ev:
            _fail(f"{path}: complete event traceEvents[{i}] has no dur")
        if ev["ph"] == "X":
            agg = per.setdefault(ev["name"], [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += float(ev["dur"])
            agg[2] = max(agg[2], float(ev["dur"]))
    print(f"trace {path}: {len(events)} event(s), "
          f"{len(per)} span name(s)")
    print(f"  {'span':<28} {'count':>6} {'total_ms':>10} "
          f"{'mean_ms':>9} {'max_ms':>9}")
    for name in sorted(per, key=lambda n: -per[n][1]):
        n, tot, mx = per[name]
        print(f"  {name:<28} {n:>6} {tot/1e3:>10.3f} "
              f"{tot/n/1e3:>9.3f} {mx/1e3:>9.3f}")


def run_metrics(path: str) -> None:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        _fail(f"{path}: unreadable metrics JSON ({e})")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(doc.get(section), dict):
            _fail(f"{path}: missing/invalid {section!r} section")
    for name, h in doc["histograms"].items():
        if not isinstance(h, dict) or "count" not in h or "sum" not in h:
            _fail(f"{path}: histogram {name!r} lacks count/sum")
        if h.get("count", 0) > 0:
            missing = [k for k in ("min", "max", "p50", "p99") if k not in h]
            if missing:
                _fail(f"{path}: non-empty histogram {name!r} "
                      f"missing {missing}")
    print(f"metrics {path}:")
    if doc["counters"]:
        print("  counters:")
        for name, v in sorted(doc["counters"].items()):
            print(f"    {name:<32} {v}")
    if doc["gauges"]:
        print("  gauges:")
        for name, v in sorted(doc["gauges"].items()):
            print(f"    {name:<32} {v:.6g}")
    if doc["histograms"]:
        print("  histograms:")
        for name, h in sorted(doc["histograms"].items()):
            if h["count"]:
                print(f"    {name:<32} count={h['count']} "
                      f"p50={h['p50']:.6g} p99={h['p99']:.6g} "
                      f"max={h['max']:.6g}")
            else:
                print(f"    {name:<32} count=0")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--explain", metavar="SELECTOR",
                    help="plan selector: name[@MxKx...][@mesh=AxB]"
                         "[@dtype=NAME]")
    ap.add_argument("--plan-db", default=None,
                    help="plan-DB JSON (default: $REPRO_PLAN_DB or "
                         "~/.cache/repro_torch/plans.json)")
    ap.add_argument("--trace", metavar="FILE",
                    help="Chrome-trace JSON to validate + summarize")
    ap.add_argument("--metrics", metavar="FILE",
                    help="metrics dump JSON to validate + pretty-print")
    args = ap.parse_args(argv)
    if not (args.explain or args.trace or args.metrics):
        ap.error("pick at least one of --explain / --trace / --metrics")
    if args.explain:
        run_explain(args.explain, args.plan_db or default_plan_db_path())
    if args.trace:
        run_trace(args.trace)
    if args.metrics:
        run_metrics(args.metrics)


if __name__ == "__main__":
    main()
