#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without the final result line:

1. device — the card's name, the device count, and ``nvidia-smi``'s name
   and power limit;
2. build — ``nvcc`` builds ``codegen/csrc/contract.cu`` for sm_90a from the
   checkout (first use); prints ptxas's registers, shared memory, spills;
3. kernel — the contraction kernel's wrapper against its plain PyTorch
   version (``contract_ref``) at the serving GEMM shapes, M in {128, 512}
   x (K, N) in {(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)}
   in bfloat16, plus one float32 case; tolerances are the reference's on
   outputs scaled by max|ref|: float32 (1e-4, 1e-4), bfloat16 (6e-2, 6e-2).
   Each case is timed with CUDA events (L2 flushed before every launch)
   for the kernel, the plain version and ``torch.matmul`` (the library
   yardstick, used nowhere in the port), beside its bound on an H100 SXM:
   max(operations / peak rate, bytes / 3.35 TB/s), bf16 at 989 TFLOP/s,
   f32 at 67 TFLOP/s;
4. small model — a 2-layer, 128-aligned qwen3-8b variant in float32 served
   on the card (kernel path) and on the CPU (plain path) from the same
   seeded weights: prefill/decode logits agree and greedy tokens are equal;
5. serve — the main path: ``python -m repro_torch.launch.serve`` (its
   ``main``) on qwen3-8b at full width and depth (36 layers, d_model 4096,
   bf16, about 16.4 GB of seeded random weights) with ``--requests 4
   --prompt-len 512 --max-new 16 --lanes 4 --page-size 128 --rate-hz 0
   --seed 0``; every prefill is 128-aligned, so the kernel's launch count
   must equal 7 x 36 x prefills (q, k, v, o, gate, up, down), with every
   request complete and every token in the vocab;
6. profile — outside the counted run, request 0's prefill again (finite
   logits that give the engine's first token) and one batch-1 decode step,
   each on the host clock and then under ``torch.profiler``: device busy
   time and device time by kernel; the traces land in
   ``$CHIP_SMOKE_OUT/profile_{prefill,decode}.json``;
7. the ``kernels`` JSON line, then the card's line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Everything the script measures also goes to ``$CHIP_SMOKE_OUT/report.json``
(default ``smoke_out/`` beside this script).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
#: where the report and the profiler traces go (listed in .gitignore)
OUT = os.path.abspath(os.environ.get("CHIP_SMOKE_OUT",
                                     os.path.join(HERE, "smoke_out")))

PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": (6e-2, 6e-2), "float32": (1e-4, 1e-4)}
SERVE_ARGS = ["--arch", "qwen3-8b", "--requests", "4", "--prompt-len", "512",
              "--max-new", "16", "--lanes", "4", "--page-size", "128",
              "--rate-hz", "0", "--seed", "0", "--device", "cuda"]
#: GEMMs of one layer, (K, N) -> how many of q, k, v, o, gate, up, down
LAYER_GEMMS = {(4096, 4096): 2, (4096, 1024): 2, (4096, 12288): 2,
               (12288, 4096): 1}


def _timed(fn, flush, reps=10, warmup=2):
    """Mean device ms of ``fn()`` over ``reps`` launches, L2 flushed
    before each (the serving GEMMs find their weights cold)."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    return name, smi


def phase_build():
    from repro_torch.codegen import build

    t0 = time.perf_counter()
    build.load("contract")
    took = time.perf_counter() - t0
    report = build.ptxas_report("contract")
    print(f"[build] contract.cu -> {os.path.relpath(build.library_path('contract'), HERE)}"
          f" in {took:.1f} s", flush=True)
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)


def phase_kernel():
    import torch

    from repro_torch.codegen import CONTRACT, contract_ref
    from repro_torch.core.enumerate import matmul_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = [(m, k, n, "bfloat16") for m in (128, 512)
             for (k, n) in LAYER_GEMMS]
    cases.append((128, 4096, 4096, "float32"))
    rows = []
    for m, k, n, dt_name in cases:
        dt = getattr(torch, dt_name)
        a = torch.randn(m, k, generator=gen, device=dev).to(dt)
        b = torch.randn(k, n, generator=gen, device=dev).to(dt)
        spec = matmul_spec(m, k, n)
        got = CONTRACT(a[None], b[None], dt)[0]
        want = contract_ref(spec, a, b, out_dtype=dt)
        torch.cuda.synchronize()
        rtol, atol = TOL[dt_name]
        scale = want.float().abs().max()
        diff = (got.float() - want.float()).abs()
        limit = atol + rtol * want.float().abs() / scale
        scaled_err = (diff / scale).max().item()
        if not bool((diff / scale <= limit).all()):
            raise AssertionError(
                f"contract kernel disagrees with its plain version at "
                f"M={m} K={k} N={n} {dt_name}: scaled error {scaled_err}"
            )
        ms = _timed(lambda: CONTRACT(a[None], b[None], dt), flush)
        plain_ms = _timed(lambda: contract_ref(spec, a, b, out_dtype=dt),
                          flush)
        library_ms = _timed(lambda: torch.matmul(a, b), flush)
        ops = 2.0 * m * n * k
        nbytes = (m * k + k * n + m * n) * a.element_size()
        ops_ms = ops / PEAK_OPS[dt_name] * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = dict(M=m, K=k, N=n, dtype=dt_name,
                   max_abs_err=diff.max().item(), scaled_err=scaled_err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                   bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   tflops=ops / ms / 1e9)
        rows.append(row)
        print(f"[kernel] M={m} K={k} N={n} {dt_name}: scaled err "
              f"{scaled_err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"torch.matmul {library_ms:.4f}, bound {row['bound_ms']:.4f} "
              f"by {row['bound_by']}), {row['tflops']:.1f} TFLOP/s",
              flush=True)
    return rows


def phase_small_model():
    """The port on the card (kernel path) against the port on the CPU
    (plain path, which the CPU tests hold to the JAX reference)."""
    import torch

    from repro_torch.codegen import CONTRACT
    from repro_torch.configs import get_config
    from repro_torch.launch.serving import ContinuousEngine, synthetic_trace
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(
        get_config("qwen3-8b"), n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab=512, dtype="float32",
    )
    cpu_params = T.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    gpu_params = T._tree_map(lambda t: t.to("cuda"), cpu_params)
    rng = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=rng)
    lengths = torch.tensor([128, 71])
    before = CONTRACT.launches
    with torch.inference_mode():
        lc, cc = T.prefill(cpu_params, cfg, tokens, 131, lengths=lengths)
        lg, cg = T.prefill(gpu_params, cfg, tokens.cuda(), 131,
                           lengths=lengths.cuda())
        worst = (lg.cpu() - lc).abs().max().item() / lc.abs().max().item()
        for _ in range(2):
            nxt = torch.randint(0, cfg.vocab, (2, 1), generator=rng)
            lc, cc = T.decode_step(cpu_params, cfg, cc, nxt)
            lg, cg = T.decode_step(gpu_params, cfg, cg, nxt.cuda())
            worst = max(worst, (lg.cpu() - lc).abs().max().item()
                        / lc.abs().max().item())
    if CONTRACT.launches - before != 7 * cfg.n_layers:
        raise AssertionError("small-model prefill did not run the kernel "
                             "for all 7 x n_layers GEMMs")
    if not worst <= 1e-4:
        raise AssertionError(f"small model: card and CPU logits differ by "
                             f"{worst} (scaled)")
    outs = {}
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        trace = synthetic_trace(3, vocab=cfg.vocab, seed=5, rate_hz=0.0,
                                prompt_lens=(60, 128), max_news=(4, 6))
        ContinuousEngine(cfg, lanes=2, page_size=128, n_pages=5,
                         max_ctx=256, params=params, device=device).run(trace)
        outs[device] = [r.out_tokens for r in trace]
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"small model: greedy tokens differ, card "
                             f"{outs['cuda']} vs CPU {outs['cpu']}")
    print(f"[small] 2-layer f32 model: card vs CPU logits scaled diff "
          f"{worst:.3g}, greedy tokens equal {outs['cuda']}", flush=True)


def phase_serve():
    import torch

    from repro_torch.codegen import CONTRACT
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    CONTRACT.launches = 0
    t0 = time.perf_counter()
    stats, trace, engine = serve.main(SERVE_ARGS)
    took = time.perf_counter() - t0
    launches = CONTRACT.launches
    cfg = engine.cfg
    for r in trace:
        if len(r.out_tokens) != r.max_new or r.state != "finished":
            raise AssertionError(f"request {r.rid} ended with "
                                 f"{len(r.out_tokens)}/{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocab")
    want = 7 * cfg.n_layers * stats["prefills"]
    if launches != want:
        raise AssertionError(f"contract kernel launched {launches} times, "
                             f"expected 7 x {cfg.n_layers} x "
                             f"{stats['prefills']} = {want}")
    peak = torch.cuda.max_memory_allocated()
    summary = {k: v for k, v in stats.items() if k != "tenant_tokens"}
    print(f"[serve] {cfg.arch_id} {cfg.n_layers} layers d_model "
          f"{cfg.d_model} d_ff {cfg.d_ff} vocab {cfg.vocab} {cfg.dtype} on "
          f"{torch.cuda.get_device_name(0)}: {json.dumps(summary)}",
          flush=True)
    print(f"[serve] prompts {[len(r.prompt) for r in trace]}, max_new "
          f"{[r.max_new for r in trace]}, kernel launches {launches} = 7 x "
          f"{cfg.n_layers} x {stats['prefills']} prefills, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB, wall {took:.1f} s",
          flush=True)
    return launches, stats, peak, trace, engine


def _device_time(path):
    """(busy ms, device events, {name: [ms, count]}) over the device
    events of a Chrome trace; busy time is the union of their intervals."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            row = by_name.setdefault(e["name"], [0.0, 0])
            row[0] += e["dur"] / 1e3
            row[1] += 1
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy / 1e3, len(spans), by_name


def phase_profile(engine, first):
    """Outside the counted run: request 0's prefill again (its logits must
    be finite and give the engine's first token) and one batch-1 decode
    step after it, each timed on the host clock to a synchronize, then
    once more under ``torch.profiler`` for device busy time and device
    time by kernel (the breakdown ``PERF.md`` reads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = engine.cfg
    plen = len(first.prompt)
    padded = -(-plen // engine.page_size) * engine.page_size
    toks = torch.zeros((1, padded), dtype=torch.long)
    toks[0, :plen] = torch.as_tensor(first.prompt, dtype=torch.long)
    dev = engine.device
    batch = {"tokens": toks.to(dev),
             "lengths": torch.tensor([plen], device=dev)}
    nxt = torch.tensor([[first.out_tokens[0]]], device=dev)
    steps = {
        "prefill": lambda: engine.api.prefill(engine.params, cfg, batch,
                                              padded + engine.page_size),
        "decode": lambda: engine.api.decode_step(engine.params, cfg,
                                                 caches, nxt),
    }
    out = {}
    with torch.inference_mode():
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, new_caches = step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite logits from the served "
                                     f"model's {name}")
            if name == "prefill":
                if int(torch.argmax(logits[0, -1])) != first.out_tokens[0]:
                    raise AssertionError("re-run prefill disagrees with the "
                                         "engine's first token")
                caches = new_caches  # the decode step reads these
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            path = os.path.join(OUT, f"profile_{name}.json")
            prof.export_chrome_trace(path)
            busy, events, by_name = _device_time(path)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            contract = [v for k, v in by_name.items() if "contract" in k]
            row = dict(wall_ms=wall, device_busy_ms=busy, device_events=events,
                       contract_ms=sum(v[0] for v in contract),
                       contract_launches=sum(v[1] for v in contract),
                       top=[(k[:60], v[0], v[1]) for k, v in top])
            out[name] = row
            busy_txt = (f"device busy {busy:.3f} ms over {events} device "
                        f"events under the profiler"
                        if by_name else "device time not measured (the "
                        "profiler saw no device events)")
            what = (f"{padded} tokens" if name == "prefill"
                    else f"1 token after {plen}")
            print(f"[profile] {name} ({what}, batch 1): wall "
                  f"{wall:.3f} ms, {busy_txt}; contract kernel "
                  f"{row['contract_ms']:.3f} ms over "
                  f"{row['contract_launches']} launches", flush=True)
            for k, (ms, n) in top:
                print(f"[profile]   {ms:9.3f} ms {n:6d}x {k[:100]}",
                      flush=True)
    return out


def kernels_line(rows, launches):
    """One entry per kernel of the path.  B1's numbers are the sum over the
    seven GEMMs of one layer of a 512-token prefill (the main path's
    largest prefill), each measured above."""
    layer = [(r, LAYER_GEMMS[(r["K"], r["N"])]) for r in rows
             if r["M"] == 512 and r["dtype"] == "bfloat16"]
    total = lambda key: sum(r[key] * c for r, c in layer)  # noqa: E731
    ops_ms, bytes_ms = total("ops_ms"), total("bytes_ms")
    return {"kernels": [{
        "name": "contract",
        "route": "cuda",
        "source": "src/repro_torch/codegen/csrc/contract.cu",
        "replaces": "src/repro/codegen/pallas_gen.py:263",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": total("library_ms"),
    }]}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit("chip_smoke: run from the root of a checkout "
                         "(src/repro_torch not found)")
    sys.path.insert(0, SRC)
    import torch

    name, smi = phase_device()
    os.makedirs(OUT, exist_ok=True)
    os.environ.setdefault("REPRO_AUTOTUNE_CACHE",
                          os.path.join(OUT, "autotune.json"))
    os.environ.setdefault("REPRO_PLAN_DB", os.path.join(OUT, "plans.json"))
    phase_build()
    rows = phase_kernel()
    phase_small_model()
    launches, stats, peak, trace, engine = phase_serve()
    profiled = phase_profile(engine, trace[0])
    line = kernels_line(rows, launches)
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "cases": rows,
                   "serve": {k: v for k, v in stats.items()},
                   "profile": profiled,
                   "max_memory_allocated": peak, **line}, f, indent=1)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
