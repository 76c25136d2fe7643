"""Serving CLI: the continuous-batching paged-KV engine on the card.

  python -m repro_torch.launch.serve --arch qwen3-8b --requests 4 \\
      --prompt-len 512 --max-new 16 --lanes 4 --page-size 128 --rate-hz 0

drives a seeded synthetic trace through :class:`ContinuousEngine` and
prints the engine's stats.  Every 128-aligned prefill GEMM runs the
hand-written contraction kernel; the line ``contract kernel launches``
says how many ran.  The default flags (``--prompt-len 16 --page-size 16``)
give no 128-aligned GEMM, so they launch no contraction kernel, exactly as
the reference's defaults reach no Pallas kernel.  The MoE family
(``--arch kimi-k2-1t-a32b``, ``llama4-maverick-400b-a17b``) serves too;
with ``REPRO_MOE_GROUPED=1`` in the environment its expert products run
the grouped kernel on every prefill and decode step (``grouped kernel
launches``).  ``run(cfg, args)`` serves a config the caller has cut (e.g.
to fewer layers) with the flags of ``parse_args``.

``--device`` defaults to ``cuda`` and the run fails without a card; pass
``--device cpu`` for the plain PyTorch versions.  ``--smoke`` serves the
reduced same-family config.  ``--engine fixed``, ``--capture``,
``--quant``, ``--mesh``, ``--search-gemms`` and ``--warm-gemms`` are later
slices (ROADMAP.md queue A).  ``--metrics-out`` / ``--trace-out`` write the
``obs`` registry and the Chrome trace after the run.
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
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the obs metrics registry as JSON")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the Chrome-trace span JSON")
    return ap.parse_args(argv)


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
    engine = ContinuousEngine(
        cfg,
        lanes=args.lanes,
        page_size=args.page_size,
        n_pages=args.pages or (1 + args.lanes * pages_per_req),
        max_ctx=max_ctx,
        device=args.device,
    )
    launches0, grouped0 = CONTRACT.launches, GROUPED.launches
    stats = Gateway(engine).run(trace, eos_id=args.eos_id)
    stats["kernel_launches"] = CONTRACT.launches - launches0
    stats["grouped_launches"] = GROUPED.launches - grouped0
    log.info(
        "serve",
        f"[continuous] prefill {stats['prefill_s']*1e3:.1f} ms over "
        f"{stats['prefills']} prefill(s), decode {stats['decode_s']*1e3:.1f} "
        f"ms over {stats['decode_steps']} step(s), {stats['tokens']} tokens "
        f"at {stats['tok_per_s']:.1f} decode tok/s on {engine.device}"
    )
    log.info("serve", f"contract kernel launches: {stats['kernel_launches']}")
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
