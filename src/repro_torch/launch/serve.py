"""Serving CLI: the continuous-batching paged-KV engine and the fixed-slot
server on the card.

  python -m repro_torch.launch.serve --arch qwen3-8b --requests 4 \\
      --prompt-len 512 --max-new 16 --lanes 4 --page-size 128 --rate-hz 0

drives a seeded synthetic trace through an engine and prints its stats.
``--engine continuous`` (the default) is :class:`ContinuousEngine`;
``--engine fixed`` is this module's :class:`BatchServer` behind
``FixedEngine``: requests packed FCFS into groups of ``--lanes`` slots,
each group prefilled together and decoded until its last member
finishes.  The families whose state cannot be paged (ssm, hybrid, encdec,
vlm) always serve fixed-slot: ``continuous`` switches to ``fixed`` for
them with a log line, as in the reference.  encdec and vlm also need the
embeddings of their stubbed frontends (``frames``, ``patches``), which the
CLI does not make: their prefill raises a ``ValueError`` naming the
input, and they are served from Python through ``FixedEngine(...,
extra_batch=...)``.

On the card every projection and MLP GEMM of a prefill or decode step
runs the hand-written contraction kernel, at any shape; the line
``contract kernel launches`` says how many ran.  The MoE family
(``--arch kimi-k2-1t-a32b``, ``llama4-maverick-400b-a17b``) serves too;
with ``REPRO_MOE_GROUPED=1`` in the environment its expert products run
the grouped kernel on every prefill and decode step (``grouped kernel
launches``).  ``run(cfg, args)`` serves a config the caller has cut (e.g.
to fewer layers) with the flags of ``parse_args``.

``--device`` defaults to ``cuda`` and the run fails without a card; pass
``--device cpu`` for the plain PyTorch versions.  ``--smoke`` serves the
reduced same-family config.  ``--quant int8`` serves weight-only int8:
the parameters are quantized once at load (block-wise int8 + per-block f32
scales) and expanded for every prefill and decode step, the stacked
layers one at a time inside the layer loop, so the live weights stay
8-bit; the projections still run the contraction kernel on the expanded
weights, as in the reference.  ``--search-gemms "M,K,N;..."`` runs the
variant search on those GEMMs before the first request (the continuous
engine's prefill runner ladders them with their derived backward specs
unless ``--no-search-grads``, its decode runner ladders (lanes, K, N),
each under its phase key; the fixed server ladders them unphased, as the
reference's does), and on the card each ladder ranks and measures B1's
tile plans, so the projections then launch with the measured winner's
plan; a restart finds the ladders in the plan DB.  ``--warm-gemms``
pre-tunes schedules through the codegen cache
(``ops.warm_dense_cache``).  ``--capture`` (both engines) harvests the
prefill and decode steps on fake tensors, sweeps their specs into the
plan DB and serves through ``capture.optimize``d steps: on the card the
single-block prefill attention launches B2 and the f32 unembedding B1
(``attention kernel launches``); a prefill with no padded row drops its
lengths mask, which masks nothing, so that it takes the single-block
path.  ``--mesh AxB`` (data x model) sweeps the ``--search-gemms`` shapes
at the mesh tier too (mesh-qualified ladders), and where the process is
one of a world that holds the mesh's ranks (``torchrun``-style variables,
or a caller that joined the process group first) both engines serve under
the mesh: a GEMM with a mesh-qualified plan runs as a mesh-bound kernel,
each rank launching B1 on its shard, and every rank serves the same trace;
otherwise the CLI logs and serves single-rank, as the reference does.
``--mesh-transport host`` stages collectives through pinned host memory
(gloo between ranks that share a card).  ``--capture`` with ``--mesh``
sweeps the harvested specs at the mesh tier too, and the captured steps'
``ops`` sites then find the mesh plans as uncaptured serving does.
``--metrics-out`` / ``--trace-out`` write the ``obs`` registry and the
Chrome trace after the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import obs
from ..codegen import ATTENTION, CONTRACT, GROUPED
from ..configs import get_config
from ..device import resolve_device
from ..models.api import get_api
from ..obs import log
from .mesh import set_mesh
from .serving.runners import (_deq_fn, capture_warmup, model_step,
                              prefill_lengths, quantize_params)


def _warm(shapes) -> None:
    """Pre-tune the schedules of (m, k, n) GEMMs through the codegen cache
    (``ops.warm_dense_cache``), as a serving replica does at start."""
    from ..codegen import default_cache
    from ..ops import warm_dense_cache

    cache = default_cache()
    n = warm_dense_cache(shapes)
    log.info("serve", f"warmed {n} GEMM schedule(s) (cache {cache.path}: "
             f"{cache.hits} hit, {cache.misses} miss)")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,)
    max_new: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchServer:
    """Fixed-slot batch server (the slot count is the serving batch size).

    A port of the reference's ``BatchServer``: ``run`` packs up to
    ``batch_size`` requests into one slot matrix (``_pack``), prefills them
    together into caches of ``max_len`` positions, and decodes every slot
    until the last request finishes.  ``extra_batch`` holds the inputs a
    family needs beside the tokens (encdec ``frames``, vlm ``patches``),
    one row per slot.  ``params`` shares an existing parameter tree
    instead of drawing seeded ones; with ``quant="int8"`` it is quantized
    once here (a tree already quantized passes as it is) and expanded for
    each call, the stacked layers one at a time (``runners._deq_fn``).
    ``mesh_shape`` sweeps ``search_gemms`` at the mesh tier too and, where
    the world holds the mesh's ranks, runs every call under the mesh
    (``engine._mesh_of``, over ``mesh_transport``).
    The run is under ``torch.inference_mode()`` on ``device`` ("cuda" by
    default, raising without a card), with TF32 and reduced-precision
    bf16 reductions off, since the reference accumulates in f32.
    """

    def __init__(self, cfg, *, batch_size: int, max_len: int,
                 extra_batch=None, warm_gemms=(), search_gemms=(),
                 search_grads: bool = True, capture: bool = False,
                 mesh_shape=None, quant: Optional[str] = None, params=None,
                 device="cuda", mesh_transport: str = "device"):
        from .serving.engine import _mesh_of

        self.device = resolve_device(device)
        self.mesh = _mesh_of(mesh_shape, mesh_transport,
                             self.device)
        self.mesh_shape = None
        if mesh_shape:
            from ..search import parse_mesh_shape

            self.mesh_shape = (parse_mesh_shape(mesh_shape)
                               if isinstance(mesh_shape, str)
                               else tuple(mesh_shape))
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
                False
            )
        self.cfg = cfg
        self.api = get_api(cfg)
        self.batch_size = batch_size
        self.max_len = max_len
        self.extra_batch = {k: torch.as_tensor(v).to(self.device)
                            for k, v in (extra_batch or {}).items()}
        self.quant = quant
        # whole-model capture: harvest prefill + decode on fake tensors,
        # sweep their specs, and serve through the captured steps below
        self.capture = capture
        self.capture_stats = None
        if capture:
            # on this mesh's ranks and transport, as the --search-gemms
            # sweep below
            with set_mesh(self.mesh):
                self.capture_stats = capture_warmup(
                    cfg, {"prefill": (batch_size, max_len),
                          "decode": (batch_size, max_len)},
                    search_grads=search_grads, quant=quant,
                    device=self.device, mesh_shape=mesh_shape)
        if warm_gemms:
            _warm(warm_gemms)
        if search_gemms:
            from ..search import default_plan_db, search_gemm_plans

            # bf16, the dtype ops.dense derives the serving plan keys from;
            # unphased, as the reference's fixed server sweeps
            db = default_plan_db()
            with set_mesh(self.mesh):
                n = search_gemm_plans(
                    search_gemms, dtype=torch.bfloat16, plan_db=db,
                    with_grads=search_grads, device=self.device.type,
                    mesh_shape=self.mesh_shape,
                )
            what = "fwd + derived bwd" if search_grads else "fwd only"
            at = (f" + mesh={'x'.join(map(str, self.mesh_shape))}"
                  if self.mesh_shape else "")
            log.info("serve", f"searched {n} GEMM plan(s) ({what}{at}) -> "
                     f"{db.path}")
        # pre-register so a metrics dump always carries the cache counters
        for name in ("plandb.hit", "plandb.miss", "autotune.hit",
                     "autotune.miss"):
            obs.counter(name).inc(0)
        with torch.inference_mode():
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(0)
                params = self.api.init(cfg, gen, self.device)
            if quant:
                params = quantize_params(params, quant)
        self.params = params
        self._deq = _deq_fn(quant)
        api, deq = self.api, self._deq
        self._prefill_step = model_step(
            lambda p, b, n: api.prefill(deq(p), cfg, b, n), capture,
            f"{cfg.arch_id}:prefill", quant)
        self._decode_step = model_step(
            lambda p, c, t: api.decode_step(deq(p), cfg, c, t), capture,
            f"{cfg.arch_id}:decode", quant)

    def _sync(self) -> None:
        # host clocks below time device work: wait for it to finish
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, tokens: np.ndarray, lengths=None):
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.long)
                 .to(self.device), **self.extra_batch}
        if lengths is not None:
            lengths = prefill_lengths(lengths, tokens.shape[1], self.capture)
        if lengths is not None:
            batch["lengths"] = torch.as_tensor(
                lengths, dtype=torch.long).to(self.device)
        return self._prefill_step(self.params, batch, self.max_len)

    def _pack(self, requests: List[Request]):
        """Pack prompts into the slot matrix; returns (tokens, lengths).

        Attention families right-pad and carry per-row true lengths, so
        prefill masks the pads out and a short prompt decodes identically
        batched or solo.  SSM and hybrid recurrences fold every input token
        into their state (no attention mask can clean it), so those keep
        the left pad (lengths=None) and want equal-length prompts.
        """
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.batch_size, plen), np.int32)
        if self.cfg.family in ("ssm", "hybrid"):
            for i, r in enumerate(requests):
                toks[i, plen - len(r.prompt):] = r.prompt
            return toks, None
        lengths = np.ones((self.batch_size,), np.int32)
        for i, r in enumerate(requests):
            toks[i, :len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
        return toks, lengths

    def run(self, requests: List[Request], *, eos_id: Optional[int] = None):
        if len(requests) > self.batch_size:
            raise ValueError(f"{len(requests)} requests for "
                             f"{self.batch_size} slots")
        with torch.inference_mode(), set_mesh(self.mesh):
            return self._run(requests, eos_id)

    def _run(self, requests: List[Request], eos_id: Optional[int]):
        latency = obs.histogram("serve.request_latency_s")
        t0 = time.perf_counter()

        def finish(r: Request):
            r.done = True
            # request latency = arrival (run entry) to last token, or to
            # prefill completion for max_new=0, which still counts as a
            # served request
            latency.observe(time.perf_counter() - t0)
            obs.counter("serve.requests").inc()

        def emit(next_host: np.ndarray):
            """Append one token per live request; finish on max_new/EOS."""
            for i, r in enumerate(requests):
                if r.done:
                    continue
                tok = int(next_host[i])
                r.out_tokens.append(tok)
                if (len(r.out_tokens) >= r.max_new
                        or (eos_id is not None and tok == eos_id)):
                    finish(r)

        toks, lengths = self._pack(requests)
        with obs.span("serve.prefill", batch=len(requests),
                      prompt_len=toks.shape[1]):
            logits, caches = self._prefill(toks, lengths)
            next_tok = torch.argmax(logits[:, -1], dim=-1)
            self._sync()
        prefill_s = time.perf_counter() - t0

        # max_new=0 requests are complete the moment prefill returns:
        # nothing to emit, but latency and the served count still see them
        for r in requests:
            if not r.done and r.max_new <= 0:
                finish(r)
        # each request's first token comes from the *prefill* logits: emit
        # it before the decode clock starts so tok/s is pure decode
        if not all(r.done for r in requests):
            emit(next_tok.cpu().numpy())
        n_prefill_tokens = sum(len(r.out_tokens) for r in requests)

        t1 = time.perf_counter()
        steps = 0
        with obs.span("serve.decode", batch=len(requests)):
            # while-before-dispatch: when emit() finishes the last request
            # the loop exits without a wasted trailing decode dispatch
            while not all(r.done for r in requests):
                with obs.span("serve.decode.step", step=steps):
                    logits, caches = self._decode_step(
                        self.params, caches, next_tok[:, None])
                    next_tok = torch.argmax(logits[:, -1], dim=-1)
                    next_host = next_tok.cpu().numpy()
                steps += 1
                emit(next_host)
        decode_s = time.perf_counter() - t1
        n_tokens = sum(len(r.out_tokens) for r in requests)
        n_decode_tokens = n_tokens - n_prefill_tokens
        tok_per_s = n_decode_tokens / max(decode_s, 1e-9)
        obs.counter("serve.tokens").inc(n_tokens)
        obs.gauge("serve.tok_per_s").set(tok_per_s)
        return dict(
            prefill_s=prefill_s,
            decode_s=decode_s,
            decode_steps=steps,
            tokens=n_tokens,
            decode_tokens=n_decode_tokens,
            tok_per_s=tok_per_s,
        )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument(
        "--engine", choices=("continuous", "fixed"), default="continuous",
        help="'continuous': slot-free continuous batching over the paged "
             "KV pool; 'fixed': the fixed-slot BatchServer.  The families "
             "with unpageable state (ssm, hybrid, encdec, vlm) always "
             "serve fixed",
    )
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument(
        "--lanes", type=int, default=4,
        help="decode batch width: concurrent requests per decode step "
             "(continuous) / slots per group (fixed)",
    )
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens (continuous engine)")
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
    ap.add_argument(
        "--capture", action="store_true",
        help="whole-model capture (repro_torch.capture): harvest the "
             "prefill and decode steps' products on fake tensors, sweep "
             "their specs (with the derived backward specs unless "
             "--no-search-grads) into the ranked plan DB, and serve "
             "through the captured steps, so the remaining plain "
             "products (the attention motif, the unembedding) launch "
             "kernels too; with --quant the dispatched dense sites take "
             "the 8-bit tier")
    ap.add_argument(
        "--mesh", default=None, metavar="AxB",
        help="mesh shape ('2x4' = data x model) for the distributed "
             "schedule tier: --search-gemms sweeps also persist "
             "mesh-qualified sharded ladders, and where the process is one "
             "of a world that holds the mesh's ranks the engines serve "
             "under it, so eligible GEMMs run as mesh-bound kernels")
    ap.add_argument(
        "--mesh-transport", default="device", choices=("device", "host"),
        help="how a collective's payload travels between ranks: 'device' "
             "as the backend takes it, 'host' staged through pinned host "
             "memory (gloo between ranks that share a card)")
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


def _mesh_counts():
    """(mesh-bound GEMM calls, bytes staged through host memory) so far
    (``obs``'s ``mesh.calls.*``, ``mesh.host_staged_bytes``)."""
    counters = obs.metrics_json()["counters"]
    return (sum(v for k, v in counters.items()
                if k.startswith("mesh.calls.")),
            counters.get("mesh.host_staged_bytes", 0))


def _card_plan_counts():
    """``ops.card_plan.applied`` / ``.skipped`` so far (``obs``)."""
    counters = obs.metrics_json()["counters"]
    return {what: counters.get(f"ops.card_plan.{what}", 0)
            for what in ("applied", "skipped")}


def run(cfg, args: argparse.Namespace, params=None):
    """Serve ``cfg`` with the flags of ``parse_args``; returns (stats,
    trace, engine).  ``params`` serves an existing parameter tree instead
    of the seeded one."""
    from .serving import (ContinuousEngine, FixedEngine, Gateway,
                          synthetic_trace)

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
    quant = None if args.quant == "none" else args.quant
    engine_kind = args.engine
    if engine_kind == "continuous" and cfg.family not in ("dense", "moe"):
        log.info("serve", f"family {cfg.family!r} has unpageable state — "
                 "serving fixed-slot")
        engine_kind = "fixed"
    if engine_kind == "continuous":
        if args.warm_gemms:
            _warm(args.warm_gemms)
        pages_per_req = -(-max_ctx // args.page_size)
        engine = ContinuousEngine(
            cfg,
            lanes=args.lanes,
            page_size=args.page_size,
            n_pages=args.pages or (1 + args.lanes * pages_per_req),
            max_ctx=max_ctx,
            device=args.device,
            quant=quant,
            search_gemms=args.search_gemms,
            search_grads=not args.no_search_grads,
            capture=args.capture,
            mesh_shape=args.mesh,
            mesh_transport=args.mesh_transport,
            params=params,
        )
    else:
        engine = FixedEngine(
            cfg,
            lanes=args.lanes,
            max_ctx=max_ctx,
            device=args.device,
            quant=quant,
            warm_gemms=args.warm_gemms,
            search_gemms=args.search_gemms,
            search_grads=not args.no_search_grads,
            capture=args.capture,
            mesh_shape=args.mesh,
            mesh_transport=args.mesh_transport,
            params=params,
        )
    launches0, grouped0 = CONTRACT.launches, GROUPED.launches
    attention0 = ATTENTION.launches
    plans0 = _card_plan_counts()
    mesh0 = _mesh_counts()
    stats = Gateway(engine).run(trace, eos_id=args.eos_id)
    mesh1 = _mesh_counts()
    stats["mesh_calls"] = mesh1[0] - mesh0[0]
    stats["host_staged_bytes"] = mesh1[1] - mesh0[1]
    stats["kernel_launches"] = CONTRACT.launches - launches0
    stats["grouped_launches"] = GROUPED.launches - grouped0
    stats["attention_launches"] = ATTENTION.launches - attention0
    for what, n in _card_plan_counts().items():
        stats[f"card_plans_{what}"] = n - plans0[what]
    log.info(
        "serve",
        f"[{engine_kind}] prefill {stats['prefill_s']*1e3:.1f} ms over "
        f"{stats['prefills']} prefill(s), decode {stats['decode_s']*1e3:.1f} "
        f"ms over {stats['decode_steps']} step(s), {stats['tokens']} tokens "
        f"at {stats['tok_per_s']:.1f} decode tok/s on {engine.device}"
    )
    log.info("serve", f"contract kernel launches: {stats['kernel_launches']}")
    if args.mesh:
        log.info("serve", f"mesh {args.mesh}: {stats['mesh_calls']} "
                 f"mesh-bound GEMM call(s), {stats['host_staged_bytes']} "
                 f"byte(s) staged through host memory")
    if args.capture:
        log.info("serve", f"attention kernel launches: "
                 f"{stats['attention_launches']}")
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
