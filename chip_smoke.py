#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without the final result line:

1. device — the card's name, the device count, and ``nvidia-smi``'s name
   and power limit;
2. build — ``nvcc`` builds ``codegen/csrc/contract.cu`` (B1) and
   ``codegen/csrc/grouped.cu`` (B3) for sm_90a from the checkout, one
   ``nvcc`` per source, all started together; prints ptxas's registers,
   shared memory, spills;
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
4. grouped — the grouped MoE kernel's wrapper against its plain version
   (``grouped_ref``) at kimi-k2's expert shapes, bf16: gate/up
   (384 x C, 7168) @ (384, 7168, 2048) and down (384 x C, 2048) @
   (384, 2048, 7168) for C in {16, 8, 4}, one ragged partition with empty,
   size-1 and multi-pass groups, the dX orientation (w's contract axis
   last), and one float32 case, at the same tolerances; timed as above,
   with ``torch.bmm`` over the uniform (E, C, K) layout as the library
   yardstick and the bound counting the expert slabs that hold rows;
5. small model — a 2-layer, 128-aligned qwen3-8b variant in float32 served
   on the card (kernel path) and on the CPU (plain path) from the same
   seeded weights: prefill/decode logits agree and greedy tokens are equal;
6. small MoE model — the same check for a 2-layer, 128-aligned kimi-k2
   variant (one dense layer, one MoE layer of 8 experts top-2) under
   ``REPRO_MOE_GROUPED=1``; the grouped kernel must launch 3 times per MoE
   layer and forward;
7. serve — the main path: ``python -m repro_torch.launch.serve`` (its
   ``main``) on qwen3-8b at full width and depth (36 layers, d_model 4096,
   bf16, about 16.4 GB of seeded random weights) with ``--requests 4
   --prompt-len 512 --max-new 16 --lanes 4 --page-size 128 --rate-hz 0
   --seed 0``; every prefill is 128-aligned, so the kernel's launch count
   must equal 7 x 36 x prefills (q, k, v, o, gate, up, down), with every
   request complete and every token in the vocab;
8. profile — outside the counted run, request 0's prefill again (finite
   logits that give the engine's first token) and one batch-1 decode step,
   each on the host clock and then under ``torch.profiler``: device busy
   time and device time by kernel; the traces land in
   ``$CHIP_SMOKE_OUT/profile_{prefill,decode}.json``;
9. MoE serve — the MoE path: ``serve.run`` on kimi-k2-1t-a32b at full width
   (d_model 7168, 64 heads of 112, 384 experts top-8, expert_ff 2048, a
   shared expert, dense_ff 18432, vocab 163840, bf16) cut to 2 layers (one
   dense, one MoE: about 39.9 GB of seeded random weights), with the same
   flags as phase 7 and ``REPRO_MOE_GROUPED=1``; the grouped kernel must
   launch 3 x (prefills + decode steps) times and the contraction kernel
   the count derived from the segment plan (7 per dense layer, 4 + 3 per
   MoE layer with a shared expert) x prefills; phase 7's engine is freed
   first;
10. MoE profile — phase 8 for the kimi-k2 model
    (``$CHIP_SMOKE_OUT/profile_moe_{prefill,decode}.json``);
11. the ``kernels`` JSON line, then the card's line, then the result line
    ``{"ok": true, "device": {...}}`` last.

Everything the script measures also goes to ``$CHIP_SMOKE_OUT/report.json``
(default ``smoke_out/`` beside this script).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
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
KERNELS = ("contract", "grouped")
MOE_ARCH = "kimi-k2-1t-a32b"
MOE_LAYERS = 2  # the one cut: depth (one dense layer, one MoE layer)
MOE_SERVE_ARGS = ["--arch", MOE_ARCH] + SERVE_ARGS[2:]
#: kimi-k2's expert products, (K, N): gate/up and down
GROUPED_GATE, GROUPED_DOWN = (7168, 2048), (2048, 7168)
N_EXPERTS = 384


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

    def one(name):
        t0 = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        took = dict(zip(KERNELS, pool.map(one, KERNELS)))
    for name in KERNELS:
        build.load(name)
        print(f"[build] {name}.cu -> "
              f"{os.path.relpath(build.library_path(name), HERE)} in "
              f"{took[name]:.1f} s", flush=True)
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


def _check_close(got, want, dt_name, what):
    """Scaled error of ``got`` against ``want`` within ``TOL``; raises."""
    rtol, atol = TOL[dt_name]
    scale = want.float().abs().max()
    diff = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs() / scale
    scaled_err = (diff / scale).max().item()
    if not bool((diff / scale <= limit).all()):
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"scaled error {scaled_err}")
    return diff.max().item(), scaled_err


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
        max_abs, scaled_err = _check_close(
            got, want, dt_name, f"contract kernel at M={m} K={k} N={n} "
            f"{dt_name}"
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
                   max_abs_err=max_abs, scaled_err=scaled_err,
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


def phase_grouped():
    """Kernel B3 against ``grouped_ref`` at kimi-k2's expert shapes."""
    import numpy as np
    import torch

    from repro_torch import codegen
    from repro_torch.core.enumerate import GroupedSpec, grouped_matmul_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    E = N_EXPERTS
    slabs = {
        shape: torch.randn((E, *shape), generator=gen, device=dev,
                           dtype=torch.bfloat16)
        for shape in (GROUPED_GATE, GROUPED_DOWN)
    }
    rng = np.random.default_rng(0)
    ragged = rng.integers(0, 33, E)
    ragged[::7], ragged[3::11], ragged[5] = 0, 1, 100
    cases = [(name, (c,) * E, shape, "bfloat16", False)
             for c in (16, 8, 4)
             for name, shape in (("gate/up", GROUPED_GATE),
                                 ("down", GROUPED_DOWN))]
    cases += [
        ("ragged", tuple(int(v) for v in ragged), GROUPED_GATE, "bfloat16",
         False),
        ("dX of gate/up", (16,) * E, GROUPED_GATE, "bfloat16", True),
        ("f32", (4,) * E, (1024, 1024), "float32", False),
    ]
    rows = []
    for name, sizes, (k, n), dt_name, contract_last in cases:
        dt = getattr(torch, dt_name)
        if dt_name == "bfloat16":
            w = slabs[(k, n)]
        else:
            w = torch.randn((E, k, n), generator=gen, device=dev, dtype=dt)
        kx, nx = (n, k) if contract_last else (k, n)  # the product's K, N
        x = torch.randn((sum(sizes), kx), generator=gen, device=dev).to(dt)
        if contract_last:  # grouped_matmul.dX: dout (n, f) . w (g, k, f)
            spec = GroupedSpec(
                name="grouped_matmul.dX",
                operands={"dout": ("n", "f"), "W": ("g", "k", "f")},
                output=("n", "k"),
                extents={"n": sum(sizes), "k": k, "f": n, "g": E},
                group_sizes=sizes,
            )
        else:
            spec = grouped_matmul_spec(sizes, k, n)
        kern = codegen.compile(spec, codegen.default_schedule(spec))
        got = kern(x, w)
        want = codegen.grouped_ref(x, w, sizes, out_dtype=dt,
                                   contract_last=contract_last)
        torch.cuda.synchronize()
        max_abs, scaled_err = _check_close(
            got, want, dt_name, f"grouped kernel ({name}, {dt_name})"
        )
        ms = _timed(lambda: kern(x, w), flush)
        plain_ms = _timed(lambda: codegen.grouped_ref(
            x, w, sizes, out_dtype=dt, contract_last=contract_last), flush)
        library_ms = None
        if len(set(sizes)) == 1:  # one bmm over the (E, C, K) layout
            xb = x.view(E, sizes[0], kx)
            wb = w.transpose(1, 2) if contract_last else w
            library_ms = _timed(lambda: torch.bmm(xb, wb), flush)
        live = sum(1 for v in sizes if v)
        n_rows = sum(sizes)
        ops = 2.0 * n_rows * kx * nx
        nbytes = (n_rows * kx + live * kx * nx + n_rows * nx) * x.element_size()
        ops_ms = ops / PEAK_OPS[dt_name] * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = dict(case=name, C=sizes[0] if len(set(sizes)) == 1 else None,
                   rows=n_rows, groups=live, K=kx, N=nx, dtype=dt_name,
                   max_abs_err=max_abs, scaled_err=scaled_err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                   bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   gbps=nbytes / ms / 1e6)
        rows.append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"[grouped] {name} rows={n_rows} groups={live} K={kx} N={nx} "
              f"{dt_name}: scaled err {scaled_err:.3g}, {ms:.4f} ms (plain "
              f"{plain_ms:.4f}, torch.bmm {lib}, bound {row['bound_ms']:.4f} "
              f"by {row['bound_by']}), {row['gbps']:.0f} GB/s", flush=True)
    del slabs, w, x, got, want, flush
    gc.collect()
    torch.cuda.empty_cache()
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


def _small_moe_config():
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512, dtype="float32",
        moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                expert_ff=256, shared_expert_ff=256,
                                dense_ff=512, first_dense=1),
    )


def _moe_layers(cfg):
    from repro_torch.models.transformer import segment_plan

    return sum(pattern.count("moe") * count
               for pattern, count in segment_plan(cfg))


def phase_small_moe():
    """The MoE model on the card (B1 and B3) against the CPU (plain
    versions), under ``REPRO_MOE_GROUPED=1``."""
    import torch

    from repro_torch.codegen import CONTRACT, GROUPED
    from repro_torch.launch.serving import ContinuousEngine, synthetic_trace
    from repro_torch.models import transformer as T

    cfg = _small_moe_config()
    n_moe = _moe_layers(cfg)
    cpu_params = T.init(cfg, torch.Generator().manual_seed(6), device="cpu")
    gpu_params = T._tree_map(lambda t: t.to("cuda"), cpu_params)
    rng = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=rng)
    lengths = torch.tensor([128, 71])
    c0, g0 = CONTRACT.launches, GROUPED.launches
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
    if GROUPED.launches - g0 != 3 * n_moe * 3:
        raise AssertionError(f"small MoE model: grouped kernel launched "
                             f"{GROUPED.launches - g0} times over 3 "
                             f"forwards, expected {3 * n_moe * 3}")
    want = len(_prefill_gemms(cfg))
    if CONTRACT.launches - c0 != want:
        raise AssertionError(f"small MoE model: contraction kernel launched "
                             f"{CONTRACT.launches - c0} times in a prefill, "
                             f"expected {want}")
    if not worst <= 1e-4:
        raise AssertionError(f"small MoE model: card and CPU logits differ "
                             f"by {worst} (scaled)")
    outs, launched = {}, 0
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        trace = synthetic_trace(3, vocab=cfg.vocab, seed=5, rate_hz=0.0,
                                prompt_lens=(60, 128), max_news=(4, 6))
        g0 = GROUPED.launches
        stats = ContinuousEngine(cfg, lanes=2, page_size=128, n_pages=5,
                                 max_ctx=256, params=params,
                                 device=device).run(trace)
        launched = GROUPED.launches - g0
        want = 3 * n_moe * (stats["prefills"] + stats["decode_steps"])
        if device == "cuda" and launched != want:
            raise AssertionError(f"small MoE engine: grouped kernel launched "
                                 f"{launched} times, expected {want}")
        outs[device] = [r.out_tokens for r in trace]
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"small MoE model: greedy tokens differ, card "
                             f"{outs['cuda']} vs CPU {outs['cpu']}")
    print(f"[small-moe] 2-layer f32 kimi-k2 variant ({cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k}): card vs CPU logits scaled diff "
          f"{worst:.3g}, greedy tokens equal {outs['cuda']}, grouped kernel "
          f"launches in the engine run {launched}", flush=True)


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


def _prefill_gemms(cfg):
    """(K, N) of every ``ops.dense`` a prefill runs, from the segment plan:
    q, k, v, o and the MLP's gate, up, down in a dense layer (``dense_ff``
    in an MoE config); q, k, v, o and the shared expert's three in an MoE
    layer.  All must be 128-aligned, so a 128-aligned prefill launches
    the contraction kernel once for each."""
    from repro_torch.models.transformer import segment_plan

    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    attn = [(d, hq), (d, hkv), (d, hkv), (hq, d)]
    m = cfg.moe
    mlp = lambda f: [(d, f), (d, f), (f, d)] if f else []  # noqa: E731
    per_kind = {
        "dense": attn + mlp(m.dense_ff if m is not None and m.dense_ff
                            else cfg.d_ff),
        "moe": attn + mlp(m.shared_expert_ff if m is not None else 0),
    }
    gemms = [g for pattern, count in segment_plan(cfg)
             for kind in pattern for g in per_kind[kind] * count]
    if any(k % 128 or n % 128 for k, n in gemms):
        raise AssertionError(f"{cfg.arch_id}: a prefill GEMM is not "
                             f"128-aligned: {sorted(set(gemms))}")
    return gemms


def phase_moe_serve():
    """kimi-k2 at full width, cut to 2 layers, through ``serve.run``."""
    import torch

    from repro_torch.codegen import CONTRACT, GROUPED
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    n_moe = _moe_layers(cfg)
    args = serve.parse_args(MOE_SERVE_ARGS)
    if args.page_size % 128:  # prefills are padded to whole pages
        raise AssertionError("MoE serve: prefills must be 128-aligned")
    print(f"[moe-serve] reduced: n_layers {full.n_layers} -> {cfg.n_layers} "
          f"(first_dense {cfg.moe.first_dense} + {n_moe} MoE layer); every "
          f"width as published", flush=True)
    torch.cuda.reset_peak_memory_stats()
    CONTRACT.launches = 0
    GROUPED.launches = 0
    t0 = time.perf_counter()
    stats, trace, engine = serve.run(cfg, args)
    took = time.perf_counter() - t0
    launches = {"contract": CONTRACT.launches, "grouped": GROUPED.launches}
    for r in trace:
        if len(r.out_tokens) != r.max_new or r.state != "finished":
            raise AssertionError(f"request {r.rid} ended with "
                                 f"{len(r.out_tokens)}/{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocab")
    forwards = stats["prefills"] + stats["decode_steps"]
    want = {"grouped": 3 * n_moe * forwards,
            "contract": len(_prefill_gemms(cfg)) * stats["prefills"]}
    if launches != want:
        raise AssertionError(f"MoE serve: kernel launches {launches}, "
                             f"expected {want} (3 x {n_moe} MoE layer x "
                             f"{forwards} forwards; "
                             f"{len(_prefill_gemms(cfg))} GEMMs x "
                             f"{stats['prefills']} prefills)")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if peak >= total:
        raise AssertionError(f"MoE serve: peak memory {peak} B is not under "
                             f"the card's {total} B")
    summary = {k: v for k, v in stats.items() if k != "tenant_tokens"}
    print(f"[moe-serve] {cfg.arch_id} {cfg.n_layers} layers d_model "
          f"{cfg.d_model} experts {cfg.moe.n_experts} top-{cfg.moe.top_k} "
          f"expert_ff {cfg.moe.expert_ff} vocab {cfg.vocab} {cfg.dtype} on "
          f"{torch.cuda.get_device_name(0)}: {json.dumps(summary)}",
          flush=True)
    print(f"[moe-serve] prefill {stats['prefill_s'] * 1e3:.1f} ms over "
          f"{stats['prefills']} prefills, decode {stats['tok_per_s']:.3f} "
          f"tok/s over {stats['decode_steps']} steps, p50 "
          f"{stats['p50_s'] * 1e3:.1f} ms, p99 {stats['p99_s'] * 1e3:.1f} ms",
          flush=True)
    print(f"[moe-serve] prompts {[len(r.prompt) for r in trace]}, kernel "
          f"launches {launches} = grouped 3 x {n_moe} x {forwards} forwards, "
          f"contract {len(_prefill_gemms(cfg))} x {stats['prefills']} "
          f"prefills; max_memory_allocated {peak / 2**30:.2f} GiB of "
          f"{total / 2**30:.2f}, wall {took:.1f} s", flush=True)
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


def phase_profile(engine, first, tag=""):
    """Outside the counted run: request 0's prefill again (its logits must
    be finite and give the engine's first token) and one batch-1 decode
    step after it, each timed on the host clock to a synchronize, then
    once more under ``torch.profiler`` for device busy time and device
    time by kernel (the breakdown ``PERF.md`` reads).  ``tag`` prefixes
    the trace files and the printed lines."""
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
            path = os.path.join(OUT, f"profile_{tag}{name}.json")
            prof.export_chrome_trace(path)
            busy, events, by_name = _device_time(path)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            row = dict(wall_ms=wall, device_busy_ms=busy, device_events=events,
                       top=[(k[:60], v[0], v[1]) for k, v in top])
            for kernel in KERNELS:
                hits = [v for k, v in by_name.items() if f"{kernel}_" in k]
                row[f"{kernel}_ms"] = sum(v[0] for v in hits)
                row[f"{kernel}_launches"] = sum(v[1] for v in hits)
            out[name] = row
            busy_txt = (f"device busy {busy:.3f} ms over {events} device "
                        f"events under the profiler"
                        if by_name else "device time not measured (the "
                        "profiler saw no device events)")
            what = (f"{padded} tokens" if name == "prefill"
                    else f"1 token after {plen}")
            kernels = "; ".join(
                f"{kernel} kernel {row[f'{kernel}_ms']:.3f} ms over "
                f"{row[f'{kernel}_launches']} launches ("
                f"{100 * row[f'{kernel}_ms'] / max(busy, 1e-9):.1f} % of "
                f"device busy)" for kernel in KERNELS
            )
            print(f"[{tag}profile] {name} ({what}, batch 1): wall "
                  f"{wall:.3f} ms, {busy_txt}; {kernels}", flush=True)
            for k, (ms, n) in top:
                print(f"[{tag}profile]   {ms:9.3f} ms {n:6d}x {k[:100]}",
                      flush=True)
    return out


def kernels_line(rows, launches, grows, glaunches):
    """One entry per kernel of the paths.  B1's numbers are the sum over the
    seven GEMMs of one layer of a 512-token prefill (the qwen3-8b path's
    largest prefill), its launches those of the qwen3-8b serve run; B3's
    are the sum over the three expert products of one MoE layer of a
    512-token kimi-k2 prefill (gate, up, down at C = 16), its launches
    those of the kimi-k2 serve run.  Each number is measured above."""
    layer = [(r, LAYER_GEMMS[(r["K"], r["N"])]) for r in rows
             if r["M"] == 512 and r["dtype"] == "bfloat16"]
    moe = [(r, 2 if r["case"] == "gate/up" else 1) for r in grows
           if r["C"] == 16 and r["case"] in ("gate/up", "down")]

    def entry(name, source, replaces, parts, launches, errs):
        total = lambda key: sum(r[key] * c for r, c in parts)  # noqa: E731
        ops_ms, bytes_ms = total("ops_ms"), total("bytes_ms")
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in errs),
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": total("library_ms"),
        }

    return {"kernels": [
        entry("contract", "src/repro_torch/codegen/csrc/contract.cu",
              "src/repro/codegen/pallas_gen.py:263", layer, launches, rows),
        entry("grouped", "src/repro_torch/codegen/csrc/grouped.cu",
              "src/repro/codegen/fused_gen.py:243", moe, glaunches, grows),
    ]}


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
    grows = phase_grouped()
    phase_small_model()
    os.environ["REPRO_MOE_GROUPED"] = "1"
    phase_small_moe()
    launches, stats, peak, trace, engine = phase_serve()
    profiled = phase_profile(engine, trace[0])
    del trace, engine  # free qwen3-8b's 16.4 GB before kimi-k2's 39.9 GB
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, moe_stats, moe_peak, moe_trace, moe_engine = (
        phase_moe_serve()
    )
    moe_profiled = phase_profile(moe_engine, moe_trace[0], tag="moe_")
    line = kernels_line(rows, launches, grows, moe_launches["grouped"])
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "cases": rows,
                   "grouped_cases": grows,
                   "serve": {k: v for k, v in stats.items()},
                   "profile": profiled,
                   "max_memory_allocated": peak,
                   "moe_serve": {k: v for k, v in moe_stats.items()},
                   "moe_launches": moe_launches,
                   "moe_profile": moe_profiled,
                   "moe_max_memory_allocated": moe_peak, **line}, f,
                  indent=1)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
