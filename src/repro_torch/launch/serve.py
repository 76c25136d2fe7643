"""Serving CLI: the continuous-batching paged-KV engine on the card.

  python -m repro_torch.launch.serve --arch qwen3-8b --requests 4 \\
      --prompt-len 512 --max-new 16 --lanes 4 --page-size 128 --rate-hz 0

drives a seeded synthetic trace through :class:`ContinuousEngine` and
prints the engine's stats.  On the card every projection and MLP GEMM of
a prefill or decode step runs the hand-written contraction kernel, at any
shape; the line ``contract kernel launches`` says how many ran.  The MoE
family
(``--arch kimi-k2-1t-a32b``, ``llama4-maverick-400b-a17b``) serves too;
with ``REPRO_MOE_GROUPED=1`` in the environment its expert products run
the grouped kernel on every prefill and decode step (``grouped kernel
launches``).  ``run(cfg, args)`` serves a config the caller has cut (e.g.
to fewer layers) with the flags of ``parse_args``.

``--device`` defaults to ``cuda`` and the run fails without a card; pass
``--device cpu`` for the plain PyTorch versions.  ``--smoke`` serves the
reduced same-family config.  ``--quant int8`` serves weight-only int8:
the parameters are quantized once at load (block-wise int8 + per-block f32
scales) and expanded before every prefill and decode step, so the live
weights stay 8-bit; the projections still run the contraction kernel on
the expanded weights, as in the reference.  ``--search-gemms
"M,K,N;..."`` runs the variant search on those GEMMs before the first
request: the prefill runner ladders them (with their derived backward
specs unless ``--no-search-grads``), the decode runner ladders (lanes, K,
N), each under its phase key, and on the card each ladder ranks and
measures B1's tile plans, so the projections then launch with the
measured winner's plan; a restart finds the ladders in the plan DB.
``--warm-gemms`` pre-tunes schedules through the codegen cache
(``ops.warm_dense_cache``).  ``--engine fixed``, ``--capture`` and
``--mesh`` are later slices (ROADMAP.md queue A).  ``--metrics-out`` /
``--trace-out`` write the ``obs`` registry and the Chrome trace after the
run.
"""

from __future__ import annotations

import argparse

from .. import obs
from ..codegen import CONTRACT, GROUPED
from ..configs import get_config
from ..obs import log


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument(
        "--lanes", type=int, default=4,
        help="decode batch width: concurrent requests per decode step",
    )
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens")
    ap.add_argument(
        "--pages", type=int, default=0,
        help="physical KV pages in the pool; 0 sizes it so every lane "
             "can reach max context without preemption",
    )
    ap.add_argument(
        "--eos-id", type=int, default=None,
        help="token id that finishes a request early (default: none — "
             "requests run to max_new)",
    )
    ap.add_argument(
        "--rate-hz", type=float, default=200.0,
        help="Poisson arrival rate of the synthetic trace; 0 = all "
             "requests arrive at t=0 (saturated queue)",
    )
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (prompts, lengths, arrivals)")
    ap.add_argument(
        "--quant", choices=("none", "int8"), default="none",
        help="weight-only serving quantization: parameters are quantized "
             "once at load (block-wise int8 + per-block f32 scales, "
             "optim.quant.quantize_tree) and expanded before every prefill "
             "and decode step, so live weights stay 8-bit in device memory",
    )
    ap.add_argument(
        "--warm-gemms", default="",
        help="semicolon-separated M,K,N GEMM shapes to pre-tune through "
             "the codegen cache, e.g. '4096,4096,4096;128,4096,512'",
    )
    ap.add_argument(
        "--search-gemms", default="",
        help="semicolon-separated M,K,N GEMM shapes to run the variant "
             "search on (enumerate -> prune -> measure) and persist as "
             "ranked plans; ops.dense then serves the measured winner.  "
             "Derived backward specs are swept alongside each shape "
             "unless --no-search-grads",
    )
    ap.add_argument(
        "--no-search-grads", action="store_true",
        help="with --search-gemms, sweep only the forward specs",
    )
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the obs metrics registry as JSON")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the Chrome-trace span JSON")
    args = ap.parse_args(argv)
    args.warm_gemms = _parse_shapes(ap, "--warm-gemms", args.warm_gemms)
    args.search_gemms = _parse_shapes(ap, "--search-gemms",
                                      args.search_gemms)
    return args


def _parse_shapes(ap: argparse.ArgumentParser, flag: str, raw: str):
    """'M,K,N;M,K,N' -> ((M, K, N), ...), as the reference's CLI parses."""
    try:
        shapes = tuple(
            tuple(int(x) for x in part.split(","))
            for part in raw.split(";")
            if part.strip()
        )
        if any(len(t) != 3 for t in shapes):
            raise ValueError(shapes)
        return shapes
    except ValueError:
        ap.error(f"{flag} expects 'M,K,N[;M,K,N...]', got {raw!r}")


def _card_plan_counts():
    """``ops.card_plan.applied`` / ``.skipped`` so far (``obs``)."""
    counters = obs.metrics_json()["counters"]
    return {what: counters.get(f"ops.card_plan.{what}", 0)
            for what in ("applied", "skipped")}


def run(cfg, args: argparse.Namespace):
    """Serve ``cfg`` with the flags of ``parse_args``; returns (stats,
    trace, engine)."""
    from .serving import ContinuousEngine, Gateway, synthetic_trace

    trace = synthetic_trace(
        args.requests,
        vocab=cfg.vocab,
        seed=args.seed,
        rate_hz=args.rate_hz,
        prompt_lens=tuple(sorted({
            max(1, args.prompt_len // 4),
            max(1, args.prompt_len // 2),
            args.prompt_len,
        })),
        max_news=tuple(sorted({max(1, args.max_new // 4), args.max_new})),
    )
    max_ctx = args.prompt_len + args.max_new + 1
    pages_per_req = -(-max_ctx // args.page_size)
    if args.warm_gemms:
        from ..codegen import default_cache
        from ..ops import warm_dense_cache

        cache = default_cache()
        n = warm_dense_cache(args.warm_gemms)
        log.info("serve", f"warmed {n} GEMM schedule(s) (cache "
                 f"{cache.path}: {cache.hits} hit, {cache.misses} miss)")
    engine = ContinuousEngine(
        cfg,
        lanes=args.lanes,
        page_size=args.page_size,
        n_pages=args.pages or (1 + args.lanes * pages_per_req),
        max_ctx=max_ctx,
        device=args.device,
        quant=None if args.quant == "none" else args.quant,
        search_gemms=args.search_gemms,
        search_grads=not args.no_search_grads,
    )
    launches0, grouped0 = CONTRACT.launches, GROUPED.launches
    plans0 = _card_plan_counts()
    stats = Gateway(engine).run(trace, eos_id=args.eos_id)
    stats["kernel_launches"] = CONTRACT.launches - launches0
    stats["grouped_launches"] = GROUPED.launches - grouped0
    for what, n in _card_plan_counts().items():
        stats[f"card_plans_{what}"] = n - plans0[what]
    log.info(
        "serve",
        f"[continuous] prefill {stats['prefill_s']*1e3:.1f} ms over "
        f"{stats['prefills']} prefill(s), decode {stats['decode_s']*1e3:.1f} "
        f"ms over {stats['decode_steps']} step(s), {stats['tokens']} tokens "
        f"at {stats['tok_per_s']:.1f} decode tok/s on {engine.device}"
    )
    log.info("serve", f"contract kernel launches: {stats['kernel_launches']}")
    if stats["card_plans_applied"] or stats["card_plans_skipped"]:
        log.info("serve", f"searched B1 plans: applied to "
                 f"{stats['card_plans_applied']} launch(es), skipped by "
                 f"{stats['card_plans_skipped']} (another body ran)")
    if cfg.family == "moe":
        log.info("serve", f"grouped kernel launches: "
                 f"{stats['grouped_launches']}")
    if args.metrics_out:
        log.info("serve", f"metrics -> {obs.metrics_dump(args.metrics_out)}")
    if args.trace_out:
        log.info("serve", f"trace -> {obs.trace_dump(args.trace_out)}")
    return stats, trace, engine


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    return run(cfg, args)


if __name__ == "__main__":
    main()
