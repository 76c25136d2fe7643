"""Offline variant-search sweep: rewrite rules -> ranked, measured plans.

    python -m repro_torch.search.sweep --spec matmul \\
        --shapes "512,4096,4096;512,4096,1024" --dtype bfloat16 --with-grads

runs the full ``repro_torch.search`` pipeline for each spec/shape point
(and with ``--with-grads`` each point's derived backward specs), persists
the ranked ladders in the plan DB, prints each ladder, and checks that the
winner round-trips through the plan DB -- the same lookup ``ops.dense``
performs, the card plan included.  ``--device`` defaults to ``cuda``:
there the ladder ranks and measures B1's tile plans, or for ``attention``
and ``grouped_matmul`` the fused kernels' plans (B2's KV block and CTA
count, B3's M tile, B4's tile width and CTA count), on the card (the
package docstring of ``repro_torch.search``; ``--causal`` gives attention
its causal mask); ``--device cpu`` gives the
reference's ladder with the kernel's plain version timed on the host,
keyed ``cpu`` where a card is visible (``codegen.cache.measured_on``).
``--no-measure`` ranks analytically only.  ``--from-model ARCH``
harvests the points from a model instead of ``--spec`` / ``--shapes``:
``repro_torch.capture`` traces the arch's train, prefill and decode steps
on fake tensors (``--kinds``, at ``--batch`` x ``--seq``; ``--model-smoke``
for the reduced config) and sweeps every dispatched site's spec under the
model's own dtype, so the plan keys match the lookups ``ops`` performs.
``--mesh AxB`` also sweeps every point at the mesh tier (data x model, a
third leading axis a pod axis): mesh subdivisions x collective strategies
join the beam, the ladder persists under the mesh-qualified plan key, and
the sharded candidates are measured over a mesh of the world's ranks when
the process is one of a world that holds them (``torchrun``-style
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, which
``launch.mesh.init_world`` joins; every rank runs the same sweep, and
rank 0 writes the plan DB); otherwise they keep their analytic rank.
B1's other modes sweep the same way: ``--spec weighted_matmul`` (its
k-scale, and with ``--with-grads`` its ``.dA`` / ``.dB`` multiplier and
``.dg`` row reduce), ``--spec chain_matmul`` (the chain's association and
cluster), and ``--quant int8`` / ``--quant fp8`` any spec's 8-bit tier
(the 8-bit ring's grid, on the card under the dequant epilogue that
``ops.dense(quant=)`` launches with):

    python -m repro_torch.search.sweep --spec weighted_matmul \
        --shapes 2048,4096,12288 --dtype bfloat16 --with-grads
    python -m repro_torch.search.sweep --spec matmul \
        --shapes 2048,4096,12288 --quant int8

    torchrun --nproc-per-node 8 -m repro_torch.search.sweep \
        --spec matmul --shapes 128,128,128 --with-grads --mesh 2x4 --device cpu

    python -m repro_torch.search.sweep --from-model qwen3-8b \
        --model-smoke --with-grads --device cpu

The exit code is non-zero if any sweep point produces no plan or its
persisted winner does not round-trip.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

from ..launch.mesh import set_mesh, world_mesh


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="cost-guided variant search "
                                             "sweep")
    ap.add_argument("--spec", default=None,
                    help="spec family (matmul, matvec, weighted_matmul, "
                         "batched_matmul, chain_matmul, transposed_matmul, "
                         "attention, grouped_matmul); default matmul.  "
                         "Incompatible with --from-model")
    ap.add_argument("--shapes", default=None,
                    help="semicolon-separated extent tuples, e.g. "
                         "'512,4096,4096;4,4096,4096' (required unless "
                         "--from-model)")
    ap.add_argument("--from-model", default=None, metavar="ARCH",
                    help="harvest the sweep points from a model config: "
                         "repro_torch.capture traces its train, prefill "
                         "and decode steps on fake tensors and collects "
                         "every dispatched site's ContractionSpec")
    ap.add_argument("--model-smoke", action="store_true",
                    help="with --from-model, use the reduced smoke config")
    ap.add_argument("--model-batch", "--batch", dest="model_batch",
                    type=int, default=2,
                    help="batch size of the --from-model trace")
    ap.add_argument("--model-seq", "--seq", dest="model_seq", type=int,
                    default=64, help="sequence length of the --from-model "
                                     "trace")
    ap.add_argument("--model-kinds", "--kinds", dest="model_kinds",
                    default="train,prefill,decode",
                    help="comma-separated trace points for --from-model")
    ap.add_argument("--mesh", default=None, metavar="AxB",
                    help="also sweep every point at the mesh tier of the "
                         "given shape (data x model; a leading pod axis "
                         "for three): sharded ladders persist under the "
                         "mesh-qualified plan key, measured over the "
                         "world's ranks where the world holds the mesh"),
    ap.add_argument("--beam", type=int, default=8, help="beam width")
    ap.add_argument("--topk", type=int, default=4,
                    help="survivors compiled + measured")
    ap.add_argument("--dtype", default=None,
                    help="operand dtype: float32 (the default) or bfloat16 "
                         "(int8 / float8_e4m3fn for a quantized spec).  "
                         "Incompatible with --from-model, which sweeps "
                         "under the model's own dtype")
    ap.add_argument("--no-measure", action="store_true",
                    help="analytic ranking only, no compile or timing")
    ap.add_argument("--repeats", type=int, default=2,
                    help="timed runs a candidate (at least 5 on the card)")
    ap.add_argument("--plan-db", default=None,
                    help="plan DB path (default: $REPRO_PLAN_DB or "
                         "~/.cache/repro_torch/plans.json)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore previously stored plans for these keys")
    ap.add_argument("--with-grads", action="store_true",
                    help="also sweep each spec's derived backward specs "
                         "(grad.derive: dA, dB, ...)")
    ap.add_argument("--causal", action="store_true",
                    help="with --spec attention: the causal mask (the "
                         "serving and training paths' attention, a plan "
                         "key of its own)")
    ap.add_argument("--quant", default=None, choices=("int8", "fp8"),
                    help="sweep each point's int8 or fp8 tier (the spec "
                         "re-tagged by core.enumerate.quantize_spec, at "
                         "its 1-byte storage dtype): the ladder "
                         "ops.dense(quant=) reads; on the card the 8-bit "
                         "ring's plans")
    ap.add_argument("--device", default="cuda",
                    help="where candidates are measured; 'cpu' times the "
                         "plain versions on the host")
    return ap.parse_args(argv)


def _fmt_sched(sched) -> str:
    return " ".join(f"{l.index}:{l.tier}:{l.extent}" for l in sched.levels)


def run(argv=None) -> Tuple[int, List[tuple]]:
    """(exit code, [(label, spec, shape, SearchResult)]) of one sweep."""
    from ..device import resolve_device
    from . import parse_mesh_shape

    args = parse_args(argv)
    device = str(resolve_device(args.device).type)
    meshes = [None]
    active = None
    if args.mesh:
        mesh_shape = parse_mesh_shape(args.mesh)
        meshes.append(mesh_shape)
        active = world_mesh(mesh_shape, device=device, what="sweep")
    with set_mesh(active):
        return _sweep(args, device, meshes)


def _sweep(args, device, meshes) -> Tuple[int, List[tuple]]:
    import dataclasses
    import json

    from ..codegen.cache import measured_on, schedule_to_dict
    from ..core.enumerate import QUANT_FORMATS, quantize_spec
    from . import (PlanDB, default_plan_db, quant_tier_epilogue,
                   search_schedule, spec_from_name)
    from .space import sweep_specs

    db = PlanDB(args.plan_db) if args.plan_db else default_plan_db()
    if args.from_model:
        # harvested points carry their own specs and dtypes: a --spec,
        # --dtype or --shapes beside them would be silently ignored
        for flag, val in (("--spec", args.spec), ("--dtype", args.dtype),
                          ("--shapes", args.shapes)):
            if val is not None:
                raise SystemExit(f"sweep: {flag} cannot be combined with "
                                 f"--from-model (the harvest determines "
                                 f"specs and dtypes)")
        from ..capture import model_gemm_specs
        from ..configs import get_config

        cfg = get_config(args.from_model)
        if args.model_smoke:
            cfg = cfg.smoke()
        kinds = tuple(k.strip() for k in args.model_kinds.split(",")
                      if k.strip())
        harvested = model_gemm_specs(
            cfg, batch=args.model_batch, seq=args.model_seq, kinds=kinds,
            interpret=True, device=device)
        if not harvested:
            print(f"--from-model {args.from_model}: no dispatchable GEMM "
                  f"sites harvested")
            return 1, []
        points = [(f"{hlabel}/{label}", spec,
                   tuple(spec.extents[i] for i in spec.indices), dtype)
                  for hlabel, root, dtype in harvested
                  for label, spec in sweep_specs(
                      root, with_grads=args.with_grads)]
        family = f"{args.from_model}(captured)"
    else:
        if not args.shapes:
            raise SystemExit("sweep: --shapes is required unless "
                             "--from-model")
        family = args.spec or "matmul"
        dtype = args.dtype or "float32"
        if args.causal and family != "attention":
            raise SystemExit("sweep: --causal takes --spec attention")
        if args.quant and (args.dtype or args.with_grads):
            raise SystemExit("sweep: --quant sweeps its tier's storage dtype "
                             "and no backward specs (the 8-bit path has no "
                             "gradient)")
        shapes = [tuple(int(x) for x in part.split(","))
                  for part in args.shapes.split(";") if part.strip()]

        def root_of(shape):
            spec = spec_from_name(family, shape)
            if args.quant:
                return quantize_spec(spec, fmt=args.quant)
            return (dataclasses.replace(spec, causal=True) if args.causal
                    else spec)

        if args.quant:
            dtype = QUANT_FORMATS[args.quant].dtype

        points = [(label, spec, shape, dtype)
                  for shape in shapes
                  for label, spec in sweep_specs(
                      root_of(shape), with_grads=args.with_grads)]
    failures, results = 0, []
    for (label, spec, shape, dtype), mesh_shape in (
            (pt, ms) for pt in points for ms in meshes):
        at = (f" @mesh={'x'.join(map(str, mesh_shape))}"
              if mesh_shape else "")
        print(f"== {family} {'x'.join(map(str, shape))} [{label}]{at} "
              f"(beam={args.beam}, topk={args.topk}, dtype={dtype}, "
              f"device={device}) ==", flush=True)
        res = search_schedule(
            spec, dtype=dtype, beam_width=args.beam, topk=args.topk,
            measure=not args.no_measure, repeats=args.repeats, plan_db=db,
            use_cached_plan=not args.fresh, device=device,
            mesh_shape=mesh_shape,
            epilogue=(quant_tier_epilogue(spec, device,
                                          not args.no_measure, mesh_shape)
                      if args.quant else None),
        )
        results.append((label, spec, shape, res))
        s = res.stats
        print(f"   candidates considered={s.considered} "
              f"deduped={s.deduped} pruned(bound)={s.pruned_bound} "
              f"pruned(beam)={s.pruned_beam} measured={s.measured} "
              f"mesh_variants={s.mesh_variants}")
        for rank, p in enumerate(res.ranked):
            t = ("-" if p.measured_s is None
                 else f"{p.measured_s * 1e3:8.4f}ms")
            plan = "" if p.card is None else f" plan={tuple(p.card)}"
            coll = f" coll={p.collective}" if p.collective else ""
            print(f"   #{rank} [{p.source:10s}] measured={t} "
                  f"score={p.score:.3e} bound={p.lower_bound:.3e} "
                  f"vmem_ok={p.fits_vmem}{plan}{coll}")
            print(f"      {_fmt_sched(p.schedule)}")
        if not res.ranked:
            print("   FAIL: search produced no plan")
            failures += 1
            continue
        if mesh_shape is not None:
            if res.best_sharded() is None:
                print("   FAIL: mesh sweep surfaced no mesh:* plan")
                failures += 1
                continue
            stored, _ = db.best_sharded_entry(spec, dtype,
                                              measured_on(device),
                                              mesh=res.mesh)
            if stored is None:
                print("   FAIL: no sharded rung round-tripped through the "
                      "plan DB")
                failures += 1
                continue
            print(f"   mesh plan persisted & round-tripped (db={db.path})",
                  flush=True)
            continue
        # the lookup ops.dense performs must return the winner just stored
        stored, rung = db.best_entry(spec, dtype, measured_on(device))
        want = None if res.best.card is None else res.best.card.as_dict()
        if stored is None or rung.get("card") != want or (
            json.dumps(schedule_to_dict(stored), sort_keys=True)
            != json.dumps(schedule_to_dict(res.best.schedule),
                          sort_keys=True)
        ):
            print("   FAIL: winner did not round-trip through the plan DB")
            failures += 1
            continue
        print(f"   plan persisted & round-tripped (db={db.path})", flush=True)
    if failures:
        print(f"{failures} sweep point(s) failed")
        return 1, results
    print("sweep OK")
    return 0, results


def main(argv: Optional[list] = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
