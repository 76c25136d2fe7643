#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing its own line(s) and its wall seconds; any failure
raises and the script exits non-zero without the final result line:

1. device — the card's name, the device count, and ``nvidia-smi``'s name
   and power limit;
2. build — ``nvcc`` builds ``codegen/csrc/contract.cu`` (B1),
   ``codegen/csrc/grouped.cu`` (B3) and ``codegen/csrc/grouped_dw.cu``
   (B4) for sm_90a from the checkout, one ``nvcc`` per source, all
   started together; prints ptxas's registers, shared memory, spills;
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
4. b1-train — B1 at one qwen3-8b layer's training GEMMs at M = 2048 (4 x
   512 tokens): each forward product and its derived backward specs
   ``matmul.dA`` and ``matmul.dB`` as the backward launches them, timed
   as phase 3, with per-layer sums;
5. grouped — the grouped MoE kernel's wrapper against its plain version
   (``grouped_ref``) at kimi-k2's expert shapes, bf16: gate/up
   (384 x C, 7168) @ (384, 7168, 2048) and down (384 x C, 2048) @
   (384, 2048, 7168) for C in {16, 8, 4}, one ragged partition with empty,
   size-1 and multi-pass groups, the dX orientation (w's contract axis
   last), one float32 case, and the MoE training path's shapes (32
   experts of C = 320: gate/up and down, forward and dX), at the same
   tolerances; timed as above, with ``torch.bmm`` over the uniform
   (E, C, K) layout as the library yardstick and the bound counting the
   expert slabs that hold rows;
6. grouped-dw — kernel B4 against ``grouped_dw_ref``: kimi-k2's full
   expert shapes (384 groups of C = 28: gate/up 7168 x 2048 and down
   2048 x 7168, an 11.27 GB output each), the training path's (32 groups
   of C = 320), a ragged partition with empty and size-1 groups (whose
   slabs must be exact zeros), one float32 case; timed as above with
   ``torch.bmm`` of x^T and dout over the (E, C, K) layout;
7. small model — a 2-layer, 128-aligned qwen3-8b variant in float32 served
   on the card (kernel path) and on the CPU (plain path) from the same
   seeded weights: prefill/decode logits agree and greedy tokens are equal;
8. small MoE model — the same check for a 2-layer, 128-aligned kimi-k2
   variant (one dense layer, one MoE layer of 8 experts top-2) under
   ``REPRO_MOE_GROUPED=1``; the grouped kernel must launch 3 times per MoE
   layer and forward;
9. small train — one train step of both small variants on the card and
   on the CPU from the same weights and optimizer state: every parameter
   gets a finite non-zero gradient on the card; gradients, loss, grad norm
   and updated parameters agree at the reference's f32 TOL (2e-4, 2e-4);
   B1 launches 28 times per layer, B3 9 and B4 3 times per MoE layer;
10. train — the slice's main path: ``launch.train``'s ``parse_args``,
    ``run_from_args`` and ``train()`` on qwen3-8b at full width (d_model
    4096, 32 heads, 8 KV heads, d_ff 12288, vocab 151936, bf16) cut to 8
    of 36 layers, batch 4 x 512, 5 steps, f32 moments, peak lr 3e-4,
    data seed 0:
    finite losses and grad norms, B1 launched 28 x 8 x 5 times; step time,
    tokens/s and peak memory;
11. train profile — one more step on the host clock, then under
    ``torch.profiler``: device busy, idle share, the kernels' time split
    into forward and backward launches
    (``$CHIP_SMOKE_OUT/profile_train.json``); the model is freed after;
12. MoE train — the same for kimi-k2 at full per-expert width (d_model
    7168, 64 heads of 112, expert_ff 2048, shared expert 2048, dense_ff
    18432, vocab 163840, bf16) cut to 2 layers (one dense, one MoE) and 32
    of 384 experts, top-8, batch 2 x 512 (C = 320), 3 steps, int8
    moments, peak lr 3e-4, under ``REPRO_MOE_GROUPED=1``: B1 28 x 2, B3 9
    and B4 3 launches per step; then its profile
    (``profile_moe-train.json``);
13. serve — the serving path: ``python -m repro_torch.launch.serve`` (its
    ``main``) on qwen3-8b at full width and depth (36 layers, d_model 4096,
    bf16, about 16.4 GB of seeded random weights) with ``--requests 4
    --prompt-len 512 --max-new 16 --lanes 4 --page-size 128 --rate-hz 0
    --seed 0``; every prefill is 128-aligned, so the kernel's launch count
    must equal 7 x 36 x prefills (q, k, v, o, gate, up, down), with every
    request complete and every token in the vocab;
14. profile — outside the counted run, request 0's prefill again (finite
    logits that give the engine's first token) and one batch-1 decode step,
    each on the host clock and then under ``torch.profiler``: device busy
    time and device time by kernel; the traces land in
    ``$CHIP_SMOKE_OUT/profile_{prefill,decode}.json``;
15. MoE serve — the MoE path: ``serve.run`` on kimi-k2-1t-a32b at full width
    (d_model 7168, 64 heads of 112, 384 experts top-8, expert_ff 2048, a
    shared expert, dense_ff 18432, vocab 163840, bf16) cut to 2 layers (one
    dense, one MoE: about 39.9 GB of seeded random weights), with the same
    flags as phase 13 and ``REPRO_MOE_GROUPED=1``; the grouped kernel must
    launch 3 x (prefills + decode steps) times and the contraction kernel
    the count derived from the segment plan (7 per dense layer, 4 + 3 per
    MoE layer with a shared expert) x prefills; phase 13's engine is freed
    first;
16. MoE profile — phase 14 for the kimi-k2 model
    (``$CHIP_SMOKE_OUT/profile_moe_{prefill,decode}.json``);
17. the phases' seconds, the ``kernels`` JSON line (contract, grouped,
    grouped_dw), then the card's line, then the result line
    ``{"ok": true, "device": {...}}`` last.

Every launch count is read from counters set to 0 just before the run it
counts.  Everything the script measures also goes to
``$CHIP_SMOKE_OUT/report.json`` (default ``smoke_out/`` beside this
script).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import math
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
KERNELS = ("contract", "grouped", "grouped_dw")
MOE_ARCH = "kimi-k2-1t-a32b"
MOE_LAYERS = 2  # the one cut: depth (one dense layer, one MoE layer)
MOE_SERVE_ARGS = ["--arch", MOE_ARCH] + SERVE_ARGS[2:]
#: kimi-k2's expert products, (K, N): gate/up and down
GROUPED_GATE, GROUPED_DOWN = (7168, 2048), (2048, 7168)
N_EXPERTS = 384
#: the dense training path: qwen3-8b at full width cut to 8 of 36 layers,
#: batch 4 x 512 tokens, f32 moments, 5 steps, data seed 0, peak lr 3e-4
#: (AdamWConfig's default; the CLI's 3e-3 is sized for the smoke configs
#: and makes the loss of a 4096-wide model rise within 5 steps)
TRAIN_LAYERS = 8
TRAIN_FLAGS = ["--arch", "qwen3-8b", "--steps", "5", "--batch", "4",
               "--seq", "512", "--moments", "float32", "--lr", "3e-4",
               "--device", "cuda"]
TRAIN_M = 4 * 512
#: the MoE training path: kimi-k2 at full per-expert width cut to 2 layers
#: and 32 of 384 experts (top-8 kept), batch 2 x 512 (C = 320), int8
#: moments, 3 steps
MOE_TRAIN_EXPERTS = 32
MOE_TRAIN_FLAGS = ["--arch", MOE_ARCH, "--steps", "3", "--batch", "2",
                   "--seq", "512", "--moments", "int8", "--lr", "3e-4",
                   "--device", "cuda"]
MOE_TRAIN_C = 320  # capacity: 1.25 x 1024 tokens x top-8 / 32 experts
#: the B1 launches of one layer of a train step: 7 eligible GEMMs, each run
#: forward, again in the remat recompute, and twice in the backward (dA, dB)
B1_PER_LAYER_STEP = 7 * 4
#: B3 per MoE layer and step: gate, up, down forward and recompute, 3 dX;
#: B4: the 3 dW
B3_PER_MOE_STEP, B4_PER_MOE_STEP = 9, 3
SECONDS = {}  # phase -> wall seconds


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


def _check_close(got, want, dt_name, what, tol=None):
    """Scaled error of ``got`` against ``want`` within ``TOL`` (or
    ``tol``); raises.  Works in slices along the first axis, so an 11 GB
    output needs no f32 copy of itself."""
    rtol, atol = tol or TOL[dt_name]
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    if got.dim() == 0:
        got, want = got[None], want[None]
    step = max(1, 2**28 // max(1, want[0].numel()))
    parts = range(0, want.shape[0], step)
    scale = max(want[i:i + step].float().abs().max().item() for i in parts)
    scale = scale or 1.0
    max_abs = scaled_err = 0.0
    ok = True
    for i in parts:
        w = want[i:i + step].float()
        diff = (got[i:i + step].float() - w).abs()
        ok &= bool((diff / scale <= atol + rtol * w.abs() / scale).all())
        max_abs = max(max_abs, diff.max().item())
        scaled_err = max(scaled_err, (diff / scale).max().item())
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"scaled error {scaled_err}")
    return max_abs, scaled_err


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
    # the MoE training path: 32 experts of C = 320, forward and dX
    train = (MOE_TRAIN_C,) * MOE_TRAIN_EXPERTS
    cases += [
        ("train gate/up", train, GROUPED_GATE, "bfloat16", False),
        ("train down", train, GROUPED_DOWN, "bfloat16", False),
        ("train dX of gate/up", train, GROUPED_GATE, "bfloat16", True),
        ("train dX of down", train, GROUPED_DOWN, "bfloat16", True),
    ]
    rows = []
    for name, sizes, (k, n), dt_name, contract_last in cases:
        dt = getattr(torch, dt_name)
        G = len(sizes)
        if dt_name == "bfloat16":
            w = slabs[(k, n)][:G]
        else:
            w = torch.randn((G, k, n), generator=gen, device=dev, dtype=dt)
        kx, nx = (n, k) if contract_last else (k, n)  # the product's K, N
        x = torch.randn((sum(sizes), kx), generator=gen, device=dev).to(dt)
        if contract_last:  # grouped_matmul.dX: dout (n, f) . w (g, k, f)
            spec = GroupedSpec(
                name="grouped_matmul.dX",
                operands={"dout": ("n", "f"), "W": ("g", "k", "f")},
                output=("n", "k"),
                extents={"n": sum(sizes), "k": k, "f": n, "g": G},
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
            xb = x.view(G, sizes[0], kx)
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


def phase_b1_train():
    """B1 at one qwen3-8b layer's training GEMMs, M = 2048 tokens (batch 4
    x 512): each forward product and its derived backward specs
    ``matmul.dA`` (dout . W^T) and ``matmul.dB`` (x^T . dout), compiled
    through ``ops._tuned_kernel`` and called with the operands the
    backward hands them, against ``contract_ref``; timed as phase 3, with
    ``torch.matmul`` of the same product as the library yardstick."""
    import torch

    from repro_torch import ops
    from repro_torch.codegen import contract_ref
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.grad import derived_specs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    dt, dt_name = torch.bfloat16, "bfloat16"
    m = TRAIN_M
    rows = []
    for k, n in LAYER_GEMMS:
        x = torch.randn(m, k, generator=gen, device=dev).to(dt)
        w = torch.randn(k, n, generator=gen, device=dev).to(dt)
        dout = torch.randn(m, n, generator=gen, device=dev).to(dt)
        spec = matmul_spec(m, k, n)
        dsp = derived_specs(spec)
        cases = (
            ("fwd", spec, (x, w), lambda: torch.matmul(x, w)),
            ("dA", dsp["A"], (dout, w), lambda: torch.matmul(dout, w.T)),
            ("dB", dsp["B"], (dout, x), lambda: torch.matmul(x.T, dout)),
        )
        for what, sp, args, library in cases:
            kern = ops._tuned_kernel(sp, dt)
            got = kern(*args)
            want = contract_ref(sp, *args, out_dtype=dt)
            torch.cuda.synchronize()
            max_abs, scaled_err = _check_close(
                got, want, dt_name, f"contract kernel {sp.name} at M={m} "
                f"K={k} N={n}")
            ms = _timed(lambda: kern(*args), flush)
            plain_ms = _timed(lambda: contract_ref(sp, *args, out_dtype=dt),
                              flush)
            library_ms = _timed(library, flush)
            ops_ = 2.0 * m * n * k
            out_elems = got.numel()
            in_elems = sum(a.numel() for a in args)
            nbytes = (in_elems + out_elems) * 2
            ops_ms = ops_ / PEAK_OPS[dt_name] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            row = dict(gemm=what, spec=sp.name, M=m, K=k, N=n, dtype=dt_name,
                       max_abs_err=max_abs, scaled_err=scaled_err, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                       bytes_ms=bytes_ms,
                       bound_by="operations" if ops_ms >= bytes_ms
                       else "bytes",
                       tflops=ops_ / ms / 1e9)
            rows.append(row)
            print(f"[b1-train] {sp.name} M={m} K={k} N={n}: scaled err "
                  f"{scaled_err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f}, "
                  f"torch.matmul {library_ms:.4f}, bound "
                  f"{row['bound_ms']:.4f} by {row['bound_by']}), "
                  f"{row['tflops']:.1f} TFLOP/s", flush=True)
    for what in ("fwd", "dA", "dB"):
        part = [(r, LAYER_GEMMS[(r["K"], r["N"])]) for r in rows
                if r["gemm"] == what]
        tot = {key: sum(r[key] * c for r, c in part)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"[b1-train] per layer, {what} (7 GEMMs): {tot['ms']:.4f} ms "
              f"(plain {tot['plain_ms']:.4f}, torch.matmul "
              f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f})",
              flush=True)
    del x, w, dout, got, want, flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_grouped_dw():
    """Kernel B4 against ``grouped_dw_ref``: kimi-k2's full expert shapes
    (384 groups of C = 28, a 1024-token step), the MoE training path's
    (32 groups of C = 320), a ragged partition with empty and size-1
    groups, and one float32 case.  Timed as phase 4, with ``torch.bmm``
    over the uniform (E, C, K) layout as the library yardstick; the bound
    counts x, dout and the output once each."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.codegen import grouped_dw_ref
    from repro_torch.core.enumerate import GroupedSpec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(1)
    ragged = rng.integers(0, 57, N_EXPERTS)
    ragged[::7], ragged[3::11] = 0, 1
    full = (28,) * N_EXPERTS
    train = (MOE_TRAIN_C,) * MOE_TRAIN_EXPERTS
    cases = [
        ("gate/up", full, GROUPED_GATE, "bfloat16"),
        ("down", full, GROUPED_DOWN, "bfloat16"),
        ("train gate/up", train, GROUPED_GATE, "bfloat16"),
        ("train down", train, GROUPED_DOWN, "bfloat16"),
        ("ragged", tuple(int(v) for v in ragged), GROUPED_GATE, "bfloat16"),
        ("f32", (0, 1) + (16,) * 62, (1024, 1024), "float32"),
    ]
    rows = []
    for name, sizes, (k1, k2), dt_name in cases:
        dt = getattr(torch, dt_name)
        G, n_rows = len(sizes), sum(sizes)
        x = torch.randn((n_rows, k1), generator=gen, device=dev).to(dt)
        dout = torch.randn((n_rows, k2), generator=gen, device=dev).to(dt)
        # grouped_matmul.dW as the backward builds it: out[g, k, f]
        spec = GroupedSpec(
            name="grouped_matmul.dW",
            operands={"dout": ("n", "f"), "X": ("n", "k")},
            output=("g", "k", "f"),
            extents={"n": n_rows, "k": k1, "f": k2, "g": G},
            group_sizes=sizes,
        )
        kern = ops._tuned_kernel(spec, dt)
        got = kern(dout, x)
        want = grouped_dw_ref(x, dout, sizes, out_dtype=dt)
        torch.cuda.synchronize()
        max_abs, scaled_err = _check_close(
            got, want, dt_name, f"grouped dW kernel ({name}, {dt_name})")
        empty = [g for g, v in enumerate(sizes) if not v]
        if empty and not all(bool((got[g] == 0).all()) for g in empty):
            raise AssertionError(f"grouped dW kernel ({name}): an empty "
                                 f"group's slab is not exact zeros")
        del got, want
        torch.cuda.empty_cache()
        ms = _timed(lambda: kern(dout, x), flush)
        plain_ms = _timed(lambda: grouped_dw_ref(x, dout, sizes,
                                                 out_dtype=dt), flush)
        library_ms = None
        if len(set(sizes)) == 1:
            xb = x.view(G, sizes[0], k1).transpose(1, 2)
            db = dout.view(G, sizes[0], k2)
            library_ms = _timed(lambda: torch.bmm(xb, db), flush)
        ops_ = 2.0 * n_rows * k1 * k2
        nbytes = (n_rows * (k1 + k2) + G * k1 * k2) * x.element_size()
        ops_ms = ops_ / PEAK_OPS[dt_name] * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = dict(case=name, C=sizes[0] if len(set(sizes)) == 1 else None,
                   rows=n_rows, groups=G,
                   empty_groups=len(empty), K1=k1, K2=k2, dtype=dt_name,
                   max_abs_err=max_abs, scaled_err=scaled_err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                   bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   gbps=nbytes / ms / 1e6)
        rows.append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"[grouped-dw] {name} rows={n_rows} groups={G} (empty "
              f"{len(empty)}) K1={k1} K2={k2} {dt_name}: scaled err "
              f"{scaled_err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"torch.bmm {lib}, bound {row['bound_ms']:.4f} by "
              f"{row['bound_by']}), {row['gbps']:.0f} GB/s", flush=True)
        del x, dout
        torch.cuda.empty_cache()
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _small_dense_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("qwen3-8b"), n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab=512, dtype="float32",
    )


def phase_small_model():
    """The port on the card (kernel path) against the port on the CPU
    (plain path, which the CPU tests hold to the JAX reference)."""
    import torch

    from repro_torch.codegen import CONTRACT
    from repro_torch.launch.serving import ContinuousEngine, synthetic_trace
    from repro_torch.models import transformer as T

    cfg = _small_dense_config()
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


def _launch_counts():
    from repro_torch.codegen import CONTRACT, GROUPED, GROUPED_DW

    return {"contract": CONTRACT.launches, "grouped": GROUPED.launches,
            "grouped_dw": GROUPED_DW.launches}


def _zero_launch_counts():
    from repro_torch.codegen import CONTRACT, GROUPED, GROUPED_DW

    CONTRACT.launches = GROUPED.launches = GROUPED_DW.launches = 0


def _warm_state(params, opt_cfg, seed):
    """An AdamW state with seeded moments (|m| ~ 1e-3, v >= 1e-6) at step
    10, so one update is continuous in the gradient (from a zero state the
    first update is sign(g) and a gradient at roundoff level could flip)."""
    import torch

    from repro_torch.optim import init
    from repro_torch.optim.adamw import leaves

    state = init(params, opt_cfg)
    gen = torch.Generator().manual_seed(seed)
    for (_, m), (_, v) in zip(leaves(state.m), leaves(state.v)):
        m.copy_(torch.randn(m.shape, generator=gen) * 1e-3)
        v.copy_(torch.rand(v.shape, generator=gen) * 1e-3 + 1e-6)
    return state._replace(step=torch.tensor(10, dtype=torch.int32))


def phase_small_train():
    """One train step on the card (kernel paths and their
    ``autograd.Function``s) against the CPU (plain versions, which the CPU
    tests hold to the JAX reference), from the same weights and optimizer
    state: the 2-layer 128-aligned qwen3-8b variant and the small kimi-k2
    variant under ``REPRO_MOE_GROUPED=1`` (f32, batch 2 x 128).  Every
    parameter must receive a finite, non-zero gradient on the card, the
    gradients, loss, grad norm and updated parameters must agree at the
    reference's f32 TOL (2e-4, 2e-4, scaled by max|CPU value|), and the
    step must launch B1 28 times per layer, B3 9 and B4 3 times per MoE
    layer."""
    import torch

    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves, tree_map

    grad_tol = (2e-4, 2e-4)
    out = {}
    for tag, cfg, seed in (("dense", _small_dense_config(), 8),
                           ("moe", _small_moe_config(), 9)):
        api = get_api(cfg)
        n_moe = _moe_layers(cfg)
        opt_cfg = AdamWConfig(lr=3e-3)
        cpu_params = T.init(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
        gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
        cpu_state = _warm_state(cpu_params, opt_cfg, seed)
        gpu_state = cpu_state._replace(
            step=cpu_state.step.cuda(),
            m=tree_map(lambda t: t.to("cuda"), cpu_state.m),
            v=tree_map(lambda t: t.to("cuda"), cpu_state.v))
        gen = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, cfg.vocab, (2, 129), generator=gen)
        cpu_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        gpu_batch = {k: v.cuda() for k, v in cpu_batch.items()}

        def loss_fn(p, b):
            return api.loss(p, cfg, b)

        lc, gcpu = value_and_grad(loss_fn, cpu_params, cpu_batch)
        lg, ggpu = value_and_grad(loss_fn, gpu_params, gpu_batch)
        worst = 0.0
        for (path, g), (_, want) in zip(leaves(ggpu), leaves(gcpu)):
            name = "/".join(path)
            if not bool(torch.isfinite(g).all()) or not bool(
                (g != 0).any()
            ):
                raise AssertionError(f"small train ({tag}): parameter {name} "
                                     f"got no finite gradient on the card")
            _, err = _check_close(g.cpu(), want, "float32",
                                  f"small train ({tag}) grad of {name}",
                                  tol=grad_tol)
            worst = max(worst, err)
        del gcpu, ggpu
        step = make_train_step(cfg, opt_cfg)
        cpu_params, cpu_state, mc = step(cpu_params, cpu_state, cpu_batch)
        _zero_launch_counts()
        gpu_params, gpu_state, mg = step(gpu_params, gpu_state, gpu_batch)
        torch.cuda.synchronize()
        launches = _launch_counts()
        want = {"contract": B1_PER_LAYER_STEP * cfg.n_layers,
                "grouped": B3_PER_MOE_STEP * n_moe,
                "grouped_dw": B4_PER_MOE_STEP * n_moe}
        if launches != want:
            raise AssertionError(f"small train ({tag}): kernel launches "
                                 f"{launches}, expected {want}")
        for key in ("loss", "grad_norm"):
            _check_close(mg[key].cpu(), mc[key], "float32",
                         f"small train ({tag}) {key}", tol=grad_tol)
        for (path, p), (_, want_p) in zip(leaves(gpu_params),
                                          leaves(cpu_params)):
            _, err = _check_close(p.detach().cpu(), want_p.detach(),
                                  "float32", f"small train ({tag}) updated "
                                  f"{'/'.join(path)}", tol=grad_tol)
            worst = max(worst, err)
        out[tag] = dict(loss_card=float(mg["loss"]), loss_cpu=float(mc["loss"]),
                        grad_norm_card=float(mg["grad_norm"]),
                        grad_norm_cpu=float(mc["grad_norm"]),
                        worst_scaled_err=worst, launches=launches)
        print(f"[small-train] {tag} ({cfg.n_layers} layers, {n_moe} MoE): "
              f"loss card {float(mg['loss']):.6f} vs CPU "
              f"{float(mc['loss']):.6f}, grad norm "
              f"{float(mg['grad_norm']):.6f} vs {float(mc['grad_norm']):.6f}, "
              f"grads and updated params within scaled {worst:.3g}; "
              f"launches {launches}", flush=True)
        del cpu_params, gpu_params, cpu_state, gpu_state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train(tag, arch, flags, cut):
    """A training path through ``launch.train``'s own entry points: the
    flags through ``parse_args``, the config cut by ``cut`` (depth, and
    experts for the MoE path; every width as published), ``train()`` from
    seed 0.  Checks finite losses and grad norms and the launch counts
    derived from the segment plan; prints the step time (host clock to
    the loss's synchronize), tokens/s and peak memory.  Returns the
    summary and the trained state for the profile."""
    import statistics

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.adamw import leaves

    full = get_config(arch)
    cfg = cut(full)
    args = train_mod.parse_args(flags)
    run = train_mod.run_from_args(cfg, args)
    n_moe = _moe_layers(cfg)
    tokens = args.batch * args.seq
    print(f"[{tag}] {arch}: n_layers {full.n_layers} -> {cfg.n_layers}"
          + (f", experts {full.moe.n_experts} -> {cfg.moe.n_experts} "
             f"(top-{cfg.moe.top_k})" if cfg.moe else "")
          + f"; d_model {cfg.d_model}, {cfg.n_heads} x {cfg.hd} heads, "
          f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; batch {args.batch} x {args.seq}, {args.steps} "
          f"steps, {args.moments} moments", flush=True)
    obs.metrics_reset()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    (params, opt_state), losses, report = train_mod.train(run, verbose=False)
    took = time.perf_counter() - t0
    launches = _launch_counts()
    grad_norms = list(obs.histogram("train.grad_norm").values)
    if len(losses) != args.steps or len(grad_norms) != args.steps:
        raise AssertionError(f"{tag}: {len(losses)} losses and "
                             f"{len(grad_norms)} grad norms for "
                             f"{args.steps} steps")
    if not all(map(math.isfinite, losses + grad_norms)):
        raise AssertionError(f"{tag}: non-finite loss or grad norm: "
                             f"{losses}, {grad_norms}")
    want = {"contract": B1_PER_LAYER_STEP * cfg.n_layers * args.steps,
            "grouped": B3_PER_MOE_STEP * n_moe * args.steps,
            "grouped_dw": B4_PER_MOE_STEP * n_moe * args.steps}
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{want} (B1 {B1_PER_LAYER_STEP} x "
                             f"{cfg.n_layers} layers, B3 {B3_PER_MOE_STEP} "
                             f"and B4 {B4_PER_MOE_STEP} x {n_moe} MoE "
                             f"layers, x {args.steps} steps)")
    peak = torch.cuda.max_memory_allocated()
    steps_s = list(report.step_times)
    steady = statistics.median(steps_s[1:]) if len(steps_s) > 1 else steps_s[0]
    n_params = sum(t.numel() for _, t in leaves(params))
    summary = dict(arch=arch, n_layers=cfg.n_layers,
                   n_experts=cfg.moe.n_experts if cfg.moe else None,
                   batch=args.batch, seq=args.seq, steps=args.steps,
                   moments=args.moments, params=n_params, losses=losses,
                   grad_norms=grad_norms, step_s=steps_s,
                   steady_step_s=steady, tokens_per_s=tokens / steady,
                   wall_s=took, max_memory_allocated=peak,
                   launches=launches)
    print(f"[{tag}] {n_params / 1e9:.3f} B parameters; losses "
          f"{[round(v, 4) for v in losses]}, grad norms "
          f"{[round(v, 3) for v in grad_norms]}", flush=True)
    print(f"[{tag}] step times (host clock to the loss's synchronize) "
          f"{[round(v * 1e3, 1) for v in steps_s]} ms; steady "
          f"{steady * 1e3:.1f} ms = {tokens / steady:.0f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches} = expected; wall {took:.1f} s", flush=True)
    return summary, cfg, run, params, opt_state


def _kernel_of(name):
    """The port's kernel a device-kernel name belongs to, or None."""
    import re

    hit = re.search(r"\b(grouped_dw|grouped|contract)_(bf16_mma|f32)_kernel",
                    name)
    return hit.group(1) if hit else None


def _category(name):
    """A device kernel's kind: one of the port's kernels, a cuBLAS product,
    or PyTorch's element-wise, copy, reduction and other kernels."""
    kernel = _kernel_of(name)
    if kernel:
        return kernel
    for key, words in (("cublas", ("gemm", "gemv", "cutlass", "nvjet")),
                       ("copy", ("copy",)), ("reduce", ("reduce_kernel",)),
                       ("elementwise", ("elementwise",))):
        if any(w in name for w in words):
            return key
    return "other"


def _trace_breakdown(path):
    """Device time of a train step's Chrome trace by where each kernel was
    launched.  A launch whose runtime call lies inside a ``grad.*.backward``
    range (the ``autograd.Function`` backwards open one around their GEMMs)
    is a backward GEMM of the port's kernels; the autograd engine's thread
    (the one holding those ranges) also runs the remat recompute and every
    other backward op; ``optim.update`` marks the optimizer; the rest is the
    forward.  Returns ({"<kernel>/<forward|backward>": [ms, launches]},
    {"<phase>/<category>": [ms, launches]}), or None without backward
    ranges in the trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges = {"backward": {}, "optimizer": {}}
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        name = e["name"]
        side = ("backward" if name.startswith("grad.")
                and name.endswith(".backward") else
                "optimizer" if name == "optim.update" else None)
        if side:
            ranges[side].setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    if not ranges["backward"]:
        return None
    launch = {}  # correlation -> (in a backward range, phase)
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        key = (e["pid"], e["tid"])
        inside = {side: any(a <= e["ts"] <= b for a, b in by.get(key, ()))
                  for side, by in ranges.items()}
        phase = ("optimizer" if inside["optimizer"] else
                 "backward" if key in ranges["backward"] else "forward")
        launch[e.get("args", {}).get("correlation")] = (inside["backward"],
                                                        phase)
    kernels, phases = {}, {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        in_bwd, phase = launch.get(e.get("args", {}).get("correlation"),
                                   (False, "forward"))
        kernel = _kernel_of(e["name"])
        rows = [phases.setdefault(f"{phase}/{_category(e['name'])}",
                                  [0.0, 0])]
        if kernel:
            rows.append(kernels.setdefault(
                f"{kernel}/{'backward' if in_bwd else 'forward'}", [0.0, 0]))
        for row in rows:
            row[0] += e["dur"] / 1e3
            row[1] += 1
    return kernels, phases


def phase_train_profile(tag, cfg, run, params, opt_state):
    """Outside the counted run: one more train step timed on the host
    clock to a synchronize, then one under ``torch.profiler``: device busy
    time, idle share of the step's wall time, B1, B3 and B4 time split
    into forward (forward and remat recompute) and backward launches, and
    device time by phase (forward, backward, optimizer) and kind of kernel
    (``_trace_breakdown``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step

    step = make_train_step(cfg, run.opt_cfg)
    device = torch.device("cuda")
    batch = train_mod._batch(run, run.steps, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, m = step(params, opt_state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"{tag} profile: non-finite loss")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
    path = os.path.join(OUT, f"profile_{tag}.json")
    prof.export_chrome_trace(path)
    busy, events, by_name = _device_time(path)
    if not by_name:
        print(f"[{tag}-profile] device time not measured (the profiler saw "
              f"no device events); step wall {wall:.1f} ms", flush=True)
        return dict(wall_ms=wall, device_busy_ms=None)
    split = _trace_breakdown(path)
    if split is None:
        raise AssertionError(f"{tag} profile: no grad.*.backward range in "
                             f"the trace")
    kernels, phases = split
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row = dict(wall_ms=wall, device_busy_ms=busy, device_events=events,
               idle_share=1 - busy / wall,
               kernels={k: {"ms": v[0], "launches": v[1]}
                        for k, v in sorted(kernels.items())},
               phases={k: {"ms": v[0], "launches": v[1]}
                       for k, v in sorted(phases.items())},
               top=[(k[:60], v[0], v[1]) for k, v in top])
    kern = "; ".join(
        f"{k} {v[0]:.3f} ms over {v[1]} launches ({100 * v[0] / busy:.1f} % "
        f"of device busy)" for k, v in sorted(kernels.items()))
    print(f"[{tag}-profile] one step: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms over {events} device events, idle "
          f"{100 * row['idle_share']:.1f} % of the wall; {kern}", flush=True)
    for phase in ("forward", "backward", "optimizer"):
        parts = sorted(((k.split("/")[1], v) for k, v in phases.items()
                        if k.startswith(phase + "/")), key=lambda kv: -kv[1][0])
        total = sum(v[0] for _, v in parts)
        print(f"[{tag}-profile] {phase}: {total:.3f} ms device ("
              + ", ".join(f"{c} {v[0]:.3f} ms over {v[1]}" for c, v in parts)
              + ")", flush=True)
    for k, (ms, n) in top:
        print(f"[{tag}-profile]   {ms:9.3f} ms {n:6d}x {k[:100]}", flush=True)
    return row


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


def kernels_line(k_rows, b1_rows, g_rows, dw_rows, launches):
    """One entry per kernel of the paths, each summed over one layer of one
    training step at the path's shapes (the remat recompute aside): B1 the
    7 forward GEMMs and their 14 derived backward GEMMs of a qwen3-8b
    layer at M = 2048; B3 the gate, up and down forward products and
    their 3 dX of a kimi-k2 MoE layer at 32 experts of C = 320; B4 the 3
    dW of that layer.  ``launches`` are those of the dense training run
    (B1) and of the MoE training run (B3, B4).  Each number is measured
    above; ``max_abs_err`` is the worst over every case of the kernel."""
    mult = {"gate/up": 2, "down": 1}
    b1 = [(r, LAYER_GEMMS[(r["K"], r["N"])]) for r in b1_rows]
    b3 = [(r, mult[r["case"].split()[-1]]) for r in g_rows
          if r["case"].startswith("train")]
    b4 = [(r, mult[r["case"].split()[-1]]) for r in dw_rows
          if r["case"].startswith("train")]

    def entry(name, source, replaces, parts, errs):
        total = lambda key: sum(r[key] * c for r, c in parts)  # noqa: E731
        ops_ms, bytes_ms = total("ops_ms"), total("bytes_ms")
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in errs),
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": total("library_ms"),
        }

    return {"kernels": [
        entry("contract", "src/repro_torch/codegen/csrc/contract.cu",
              "src/repro/codegen/pallas_gen.py:263", b1, b1_rows + k_rows),
        entry("grouped", "src/repro_torch/codegen/csrc/grouped.cu",
              "src/repro/codegen/fused_gen.py:243", b3, g_rows),
        entry("grouped_dw", "src/repro_torch/codegen/csrc/grouped_dw.cu",
              "src/repro/codegen/fused_gen.py:309", b4, dw_rows),
    ]}


def _phase(name, fn, *args, **kwargs):
    """Run one phase; print and keep its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    SECONDS[name] = time.perf_counter() - t0
    print(f"[time] {name}: {SECONDS[name]:.1f} s", flush=True)
    return out


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit("chip_smoke: run from the root of a checkout "
                         "(src/repro_torch not found)")
    sys.path.insert(0, SRC)
    import torch

    t_start = time.perf_counter()
    name, smi = phase_device()
    os.makedirs(OUT, exist_ok=True)
    os.environ.setdefault("REPRO_AUTOTUNE_CACHE",
                          os.path.join(OUT, "autotune.json"))
    os.environ.setdefault("REPRO_PLAN_DB", os.path.join(OUT, "plans.json"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _phase("build", phase_build)
    rows = _phase("kernel", phase_kernel)
    b1_rows = _phase("b1-train", phase_b1_train)
    grows = _phase("grouped", phase_grouped)
    dw_rows = _phase("grouped-dw", phase_grouped_dw)
    _phase("small", phase_small_model)
    os.environ["REPRO_MOE_GROUPED"] = "1"
    _phase("small-moe", phase_small_moe)
    small_train = _phase("small-train", phase_small_train)

    # the slice's main path: dense training, then MoE training
    train, cfg, run, params, state = _phase(
        "train", phase_train, "train", "qwen3-8b", TRAIN_FLAGS,
        lambda c: dataclasses.replace(c, n_layers=TRAIN_LAYERS))
    train_profile = _phase("train-profile", phase_train_profile, "train",
                           cfg, run, params, state)
    del params, state  # free the 8-layer qwen3-8b and its moments
    _free()
    moe_train, cfg, run, params, state = _phase(
        "moe-train", phase_train, "moe-train", MOE_ARCH, MOE_TRAIN_FLAGS,
        lambda c: dataclasses.replace(
            c, n_layers=MOE_LAYERS,
            moe=dataclasses.replace(c.moe, n_experts=MOE_TRAIN_EXPERTS)))
    moe_train_profile = _phase("moe-train-profile", phase_train_profile,
                               "moe-train", cfg, run, params, state)
    del params, state
    _free()
    launches = {"contract": train["launches"]["contract"],
                "grouped": moe_train["launches"]["grouped"],
                "grouped_dw": moe_train["launches"]["grouped_dw"]}

    # the serving paths of the earlier slices
    serve_launches, stats, peak, trace, engine = _phase("serve", phase_serve)
    profiled = _phase("profile", phase_profile, engine, trace[0])
    del trace, engine  # free qwen3-8b's 16.4 GB before kimi-k2's 39.9 GB
    _free()
    moe_launches, moe_stats, moe_peak, moe_trace, moe_engine = _phase(
        "moe-serve", phase_moe_serve)
    moe_profiled = _phase("moe-profile", phase_profile, moe_engine,
                          moe_trace[0], tag="moe_")
    del moe_trace, moe_engine
    _free()

    line = kernels_line(rows, b1_rows, grows, dw_rows, launches)
    SECONDS["total"] = time.perf_counter() - t_start
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "cases": rows,
                   "b1_train_cases": b1_rows,
                   "grouped_cases": grows,
                   "grouped_dw_cases": dw_rows,
                   "small_train": small_train,
                   "train": train, "train_profile": train_profile,
                   "moe_train": moe_train,
                   "moe_train_profile": moe_train_profile,
                   "serve": {k: v for k, v in stats.items()},
                   "serve_launches": serve_launches,
                   "profile": profiled,
                   "max_memory_allocated": peak,
                   "moe_serve": {k: v for k, v in moe_stats.items()},
                   "moe_launches": moe_launches,
                   "moe_profile": moe_profiled,
                   "moe_max_memory_allocated": moe_peak,
                   "seconds": SECONDS, **line}, f, indent=1)
    print(f"[time] phases {json.dumps({k: round(v, 1) for k, v in SECONDS.items()})}",
          flush=True)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
