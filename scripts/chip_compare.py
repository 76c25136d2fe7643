#!/usr/bin/env python3
"""One tree against another, in turns on one card.

    python3 scripts/chip_compare.py \
        [--serve | --kernels | --moe-serve | --quant | --modes |
         --attention | --baselines | --f32 | --dw | --capture-serve]
        OLD_CHECKOUT NEW_CHECKOUT

Runs, in a fresh process per turn and in the order old, new, new, old,
phases of each checkout's own ``chip_smoke.py``, after building the
checkout's sources that they run.  By default: ``kernel`` (B1 at the serving
GEMMs), ``b1-train`` (B1 at one qwen3-8b layer's training GEMMs, forward
and backward) and ``train`` (qwen3-8b at full width cut to 8 layers, 5
steps); each turn prints one line ``COMPARE {...}``: the tree, B1's time
per serve layer (the 7 GEMMs at M = 512), per decode layer (M = 4), per
train layer (the 7 forward and 14 backward GEMMs at M = 2048), each also
as profiler device ms where the tree's smoke records it, the decode
layer's device ms (B1's kernels, whatever body) timed first by the turn
itself, and the steady train step.  With
``--serve``: ``serve`` (qwen3-8b at full width and depth, the smoke's
serving flags) and ``profile`` (request 0's prefill and one batch-1 decode
step on the host clock and under ``torch.profiler``); each turn prints the
tree, decode tok/s, prefill ms, p50, B1's launches over the serving run,
the profiled decode step's wall ms, device busy ms and B1 launches and
ms, and the host ms an ``ops.dense`` call takes at a decode layer's GEMMs
(4 tokens; 20 layers' calls enqueued back to back, the host clock over
them divided by the calls: the card is idle while the host enqueues).
With ``--modes``: B1's fused modes at the fused path's shape (M = 2048, D
= 4096, F = 12288, bf16), each epilogue variant and the weighted family
(``weighted_matmul``, ``.dA``, ``.dB``, ``.dg``), built as ``b1-modes``
builds them; each turn prints the tree and every case's profiler device
ms, B1's kernels whatever body.  With ``--kernels``: ``grouped`` (B3 at every case of the phase) and
``chain`` (``ops.chain_dense`` and the chain kernel at each spec of
CHAIN_SHAPE, f32 and bf16), plus the int8 and fp8 chain at CHAIN_SHAPE
through ``codegen.compile``; each turn prints the tree, every case's
kernel ms, B3's train entry (a kimi-k2 MoE layer's 3 forward and 3 dX
products) and serve sum (gate, up and down at C = 16), and the chain's
bf16 entry (its four specs) and the profiled device ms of the chain
kernel over ``chain_dense``'s forward and backward.  With ``--moe-serve``: ``moe-serve``
(kimi-k2 at full width cut to 2 layers, the smoke's serving flags, under
``REPRO_MOE_GROUPED=1``); each turn prints the tree, every request's greedy
tokens, prefill ms, decode tok/s and the B3 launches.  With ``--quant``:
``b1-quant`` (B1's int8 and fp8 modes at qwen3-8b's MLP products, up and
down at M = 2048, W k-major, the ragged, batched and transposed folds,
the 8-bit weighted family and chain through ``codegen.compile``, and the
upcast body's remaining calls);
each turn prints the tree, the MLP rows' event-timed ms and (where the
tree's smoke records it) their profiler device ms, every other row's ms,
and, timed first on the device by the turn itself, the cases that stay
on ``q8_mma_kernel`` (the ragged product, the batched and transposed
folds).  With ``--attention``: B2 through its launcher at the attn-path
rows (a) (128 heads, S = T = 512, d = 128, causal, bf16), (b) (the same
with the serve trace's prompt lengths), (d) (f32 at 32 heads) and (e) (a
4096-token prompt at 32 heads); each turn prints the tree, every row's
profiler device ms and event-timed ms (L2 flushed before each launch),
and the body that ran where the tree records it.  With ``--baselines``:
the hand-written baselines B5 (``matmul``), B6 (``fused_dense_act``,
gelu) and B7 (``fused_rnz``) through their launchers at the fused path's
shape (M = 2048, K = 4096, N = 12288, bf16); each turn prints the tree,
each kernel's profiler device ms and event-timed ms (L2 flushed before
each launch), and its body where the tree records it.  With ``--f32``:
B1's f32 products through ``ops`` at the fused path's shape (M = 2048, K
= 4096, N = 12288): the plain product and the ten epilogue variants of
``b1-modes``, phase ``kernel``'s f32 case (M = 128, K = N = 4096)
through the launcher, and qwen3-8b's f32 unembedding (K = 4096, N =
151936) as phase ``capture`` launches it: the forward, ``.dA`` and ``.dB``
at M = 2048 and M = 4; each turn prints the tree, every row's profiler
device ms of B1's f32 kernels (whatever body) and event-timed ms, and the
body that ran.  With ``--dw``: B4 through ``ops`` at the MoE training
path's shapes (32 groups of C = 320, gate/up and down) and kimi-k2's full
expert shapes (384 groups of C = 28); each turn prints the tree, every
row's profiler device ms and event-timed ms, the body where the tree
records it, and the training step's three dW calls of a MoE layer
summed.  With ``--capture-serve``: qwen3-8b served at full width and depth
with ``--capture --no-search-grads`` and the smoke's serving flags, on a
plan DB and autotune cache of the turn's own (empty at its start), B1 and
B2 built before the run; each turn prints the tree, the capture warm-up
sweep's seconds, points and specs, the B2 launches by the plan they ran
(``last_plan`` where the tree's launcher records one, else "none"), the
sweep's apart from the serving's, the serving's B1 and B2 launches,
prefill ms, decode tok/s and the run's wall seconds.  Needs one NVIDIA
card;
compare two versions only within one run of this script.
"""

from __future__ import annotations

import os
import subprocess
import sys

#: device ms of the kernels whose names hold ``word`` in one ``run()``:
#: ``reps`` calls under torch.profiler, L2 flushed before each (the same
#: code in both trees, so bodies a tree's smoke does not time on the
#: device are held side by side)
DEVICE_MS = r"""
def device_ms(run, word, reps=10):
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    run()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that lost launches is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                run()
            torch.cuda.synchronize()
        path = os.path.join(cs.OUT, "profile_turn.json")
        prof.export_chrome_trace(path)
        _, _, by_name = cs._device_time(path)
        mine = [v for k, v in by_name.items() if word in k]
        count = sum(v[1] for v in mine)
        if count >= reps and count % reps == 0:
            return sum(v[0] for v in mine) / reps
    return float("nan")
"""

TURN = r"""
import dataclasses, json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cs.OUT, "autotune.json")
os.environ["REPRO_PLAN_DB"] = os.path.join(cs.OUT, "plans.json")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
from repro_torch.codegen import CONTRACT, build
build.build("contract")
build.load("contract")
""" + DEVICE_MS + r"""
# decode's GEMMs (M = 4): their device time first, whatever body runs them
gen = torch.Generator(device="cuda").manual_seed(9)
decode_device = 0.0
for (k, n), count in cs.LAYER_GEMMS.items():
    a = torch.randn(1, 4, k, generator=gen, device="cuda").bfloat16()
    b = torch.randn(1, k, n, generator=gen, device="cuda").bfloat16()
    decode_device += count * device_ms(
        lambda: CONTRACT(a, b, torch.bfloat16), "contract_bf16_")
rows = cs.phase_kernel()
b1 = cs.phase_b1_train()
train, *_ = cs.phase_train(
    "train", "qwen3-8b", cs.TRAIN_FLAGS,
    lambda c: dataclasses.replace(c, n_layers=cs.TRAIN_LAYERS))
def per_layer(rows, key):
    if any(key not in r for r in rows):  # a tree that does not record it
        return None
    return sum(r[key] * cs.LAYER_GEMMS[(r["K"], r["N"])] for r in rows)
serve = [r for r in rows if r["M"] == 512 and r["dtype"] == "bfloat16"]
decode = [r for r in rows if r["M"] == 4]
print("COMPARE " + json.dumps({
    "tree": sys.argv[1], "serve_layer_ms": per_layer(serve, "ms"),
    "serve_layer_device_ms": per_layer(serve, "device_ms"),
    "decode_layer_ms": per_layer(decode, "ms"),
    "decode_layer_turn_device_ms": decode_device,
    "train_layer_ms": per_layer(b1, "ms"),
    "train_layer_device_ms": per_layer(b1, "device_ms"),
    "steady_step_ms": train["steady_step_s"] * 1e3,
    "step_ms": [s * 1e3 for s in train["step_s"]]}), flush=True)
"""

SERVE_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cs.OUT, "autotune.json")
os.environ["REPRO_PLAN_DB"] = os.path.join(cs.OUT, "plans.json")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
import time
from repro_torch import ops
from repro_torch.codegen import build
build.build("contract")
build.load("contract")
# the host's ms an ops.dense call takes at a decode layer's GEMMs
gen = torch.Generator(device="cuda").manual_seed(9)
hs = {k: torch.randn(4, k, generator=gen, device="cuda").bfloat16()
      for k in (4096, 12288)}
ws = [torch.randn(k, n, generator=gen, device="cuda").bfloat16()
      for (k, n), c in cs.LAYER_GEMMS.items() for _ in range(c)]
for w in ws:
    ops.dense(hs[w.shape[0]], w)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(20):
    for w in ws:
        ops.dense(hs[w.shape[0]], w)
dense_host_ms = (time.perf_counter() - t0) * 1e3 / (20 * len(ws))
torch.cuda.synchronize()
del hs, ws
launches, stats, peak, trace, engine = cs.phase_serve()
prof = cs.phase_profile(engine, trace[0])
dec = prof["decode"]
print("COMPARE " + json.dumps({
    "dense_host_ms": dense_host_ms,
    "decode_step_fills": dec.get("fills"),
    "decode_step_copies": dec.get("copies"),
    "tree": sys.argv[1], "decode_tok_s": stats["tok_per_s"],
    "prefill_ms": stats["prefill_s"] * 1e3, "p50_ms": stats["p50_s"] * 1e3,
    "decode_steps": stats["decode_steps"], "contract_launches": launches,
    "decode_step_wall_ms": dec["wall_ms"],
    "decode_step_busy_ms": dec["device_busy_ms"],
    "decode_step_contract_ms": dec["contract_ms"],
    "decode_step_contract_launches": dec["contract_launches"]}), flush=True)
"""


KERNELS_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cs.OUT, "autotune.json")
os.environ["REPRO_PLAN_DB"] = os.path.join(cs.OUT, "plans.json")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
from repro_torch import codegen
from repro_torch.codegen import build
from repro_torch.core import enumerate as E
for name in ("grouped", "contract_chain"):
    build.build(name)
    build.load(name)
grouped = cs.phase_grouped()
chain = cs.phase_chain()
gen = torch.Generator(device="cuda").manual_seed(3)
flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
quant = {}
for fmt in ("int8", "fp8"):
    spec = E.quantize_spec(E.chain_matmul_spec(*cs.CHAIN_SHAPE), fmt=fmt)
    args = [cs._q_operand([spec.extents[i] for i in ax], fmt, gen)
            for ax in spec.operands.values()]
    kern = codegen.compile(spec, codegen.default_schedule(spec))
    quant[fmt] = cs._timed(lambda: kern(*args), flush)
mult = {"gate/up": 2, "down": 1}
by = {r["case"]: r["ms"] for r in grouped}
print("COMPARE " + json.dumps({
    "tree": sys.argv[1], "grouped": by,
    "grouped_train_ms": sum(r["ms"] * mult[r["case"].split()[-1]]
                            for r in grouped
                            if r["case"].startswith("train")),
    "grouped_serve_ms": sum(r["ms"] * mult[r["case"]] for r in grouped
                            if r["case"] in mult and r["C"] == 16),
    "chain": {f"{r['spec']} {r['dtype']}": r["ms"] for r in chain["rows"]},
    "chain_bf16_ms": sum(r["ms"] for r in chain["rows"]
                         if r["dtype"] == "bfloat16"),
    "chain_path_kernel_ms": {dt: v["chain_kernel_ms"]
                             for dt, v in chain["paths"].items()},
    "chain_quant_ms": quant}), flush=True)
"""


MOE_SERVE_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cs.OUT, "autotune.json")
os.environ["REPRO_PLAN_DB"] = os.path.join(cs.OUT, "plans.json")
os.environ["REPRO_MOE_GROUPED"] = "1"
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
from repro_torch.codegen import build
for name in ("contract", "grouped"):
    build.build(name)
    build.load(name)
launches, stats, peak, trace, engine = cs.phase_moe_serve()
print("COMPARE " + json.dumps({
    "tree": sys.argv[1], "tokens": [list(r.out_tokens) for r in trace],
    "prefill_ms": stats["prefill_s"] * 1e3, "decode_tok_s": stats["tok_per_s"],
    "grouped_launches": launches["grouped"]}), flush=True)
"""

QUANT_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cs.OUT, "autotune.json")
os.environ["REPRO_PLAN_DB"] = os.path.join(cs.OUT, "plans.json")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
from repro_torch import codegen
from repro_torch.codegen import build, modes
from repro_torch.core import enumerate as E
for name in ("contract", "contract_q8", "contract_chain"):
    build.build(name)
    build.load(name)
""" + DEVICE_MS + r"""
# the cases that stay on q8_mma_kernel, on the device, before anything runs
gen = torch.Generator(device="cuda").manual_seed(51)
mma_device = {}
for fmt in ("int8", "fp8"):
    launcher = modes.CONTRACT_INT8 if fmt == "int8" else modes.CONTRACT_FP8
    out_dt = torch.int32 if fmt == "int8" else torch.float32
    a = cs._q_operand((1000, 999), fmt, gen)
    b = cs._q_operand((999, 1001), fmt, gen)
    mma_device[f"ragged {fmt}"] = device_ms(
        lambda: launcher(a[None], b[None], out_dt, int_acc=fmt == "int8"),
        "q8_mma_kernel")
    for spec in (E.batched_matmul_spec(8, 512, 1024, 512),
                 E.transposed_matmul_spec(1024, 2048, 1024)):
        spec = E.quantize_spec(spec, fmt=fmt)
        args = [cs._q_operand([spec.extents[i] for i in ax], fmt, gen)
                for ax in spec.operands.values()]
        kern = codegen.compile(spec, codegen.default_schedule(spec))
        mma_device[f"{spec.name} {fmt}"] = device_ms(lambda: kern(*args),
                                                     "q8_mma_kernel")
quant = cs.phase_b1_quant()
key = lambda r: f"{r['case']} {r['dtype']}"
mlp = [r for r in quant["rows"] if r["shape"].startswith("mlp")]
print("COMPARE " + json.dumps({
    "tree": sys.argv[1], "mlp_ms": {key(r): r["ms"] for r in mlp},
    "mlp_device_ms": {key(r): r.get("device_ms") for r in mlp},
    "mma_device_ms": mma_device,
    "other_ms": {key(r): r["ms"] for r in quant["rows"]
                 + quant.get("compiled", []) + quant["upcast"]
                 if r not in mlp}}), flush=True)
"""

MODES_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cs.OUT, "autotune.json")
os.environ["REPRO_PLAN_DB"] = os.path.join(cs.OUT, "plans.json")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
from repro_torch import codegen, ops
from repro_torch.codegen import build
from repro_torch.core.enumerate import matmul_spec, weighted_matmul_spec
from repro_torch.grad import derived_specs
build.build("contract")
build.load("contract")
""" + DEVICE_MS + r"""
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(30)
m, d, f = cs.FUSED_M, cs.FUSED_D, cs.FUSED_F
dt = torch.bfloat16
vec = {"scale": torch.randn(f, generator=gen, device=dev),
       "bias": torch.randn(f, generator=gen, device=dev),
       "mean": torch.randn(f, generator=gen, device=dev) * 0.1,
       "var": torch.rand(f, generator=gen, device=dev) + 0.5}
x = (torch.randn(m, d, generator=gen, device=dev) / 8).to(dt)
w = (torch.randn(d, f, generator=gen, device=dev) / 8).to(dt)
g = torch.randn(d, generator=gen, device=dev).to(dt)
dout = (torch.randn(m, f, generator=gen, device=dev) / 8).to(dt)
out = {}
spec = matmul_spec(m, d, f)
for norm in (False, True):
    for act in cs.ACTS:
        epi = codegen.Epilogue(act=act, bias=True, scale=not norm, norm=norm)
        vs = {k: vec[k] for k in epi.vector_names}
        kern = ops._tuned_kernel(spec, dt, epilogue=epi)
        out[f"epilogue {act} {'norm' if norm else 'scale'}"] = device_ms(
            lambda: kern(x, w, **vs), "contract_bf16")
wspec = weighted_matmul_spec(m, d, f)
dsp = derived_specs(wspec)
for what, sp, args in (("weighted_matmul", wspec, (x, w, g)),
                       ("weighted_matmul.dA", dsp["A"], (dout, w, g)),
                       ("weighted_matmul.dB", dsp["B"], (dout, x, g)),
                       ("weighted_matmul.dg", dsp["g"], (dout, x, w))):
    kern = ops._tuned_kernel(sp, dt)
    out[what] = device_ms(lambda: kern(*args), "contract_bf16")
print("COMPARE " + json.dumps({"tree": sys.argv[1],
                               "modes_device_ms": out}), flush=True)
"""

ATTENTION_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
from repro_torch.codegen import ATTENTION, build
build.build("attention")
build.load("attention")
""" + DEVICE_MS + r"""
gen = torch.Generator(device="cuda").manual_seed(61)
flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
bf16, f32 = torch.bfloat16, torch.float32
def qkv(h, s, dt):
    return [torch.randn(h, s, cs.ATTN_DIM, generator=gen,
                        device="cuda").to(dt) for _ in range(3)]
lengths = torch.tensor([n for n in cs.ATTN_PROMPTS for _ in range(32)],
                       dtype=torch.int32, device="cuda")
x_a = qkv(cs.ATTN_HEADS, cs.ATTN_SEQ, bf16)
rows = {"a": (x_a, None), "b": (x_a, lengths),
        "d": (qkv(32, cs.ATTN_SEQ, f32), None),
        "e": (qkv(cs.ATTN_LONG_HEADS, cs.ATTN_LONG_SEQ, bf16), None)}
device, event, body = {}, {}, {}
for tag, ((q, k, v), lens) in rows.items():
    run = lambda: ATTENTION(q, k, v, True, lens, q.dtype)
    device[tag] = device_ms(run, "attn_")
    event[tag] = cs._timed(run, flush)
    body[tag] = getattr(ATTENTION, "last_body", None)
print("COMPARE " + json.dumps({"tree": sys.argv[1],
                               "attention_device_ms": device,
                               "attention_ms": event, "body": body}),
      flush=True)
"""

BASELINES_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
from repro_torch.codegen import build
build.build("baselines")
build.load("baselines")
from repro_torch.kernels import _baselines as B
""" + DEVICE_MS + r"""
gen = torch.Generator(device="cuda").manual_seed(62)
flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
m, k, n = cs.FUSED_M, cs.FUSED_D, cs.FUSED_F
a = (torch.randn(m, k, generator=gen, device="cuda") / 8).bfloat16()
b = (torch.randn(k, n, generator=gen, device="cuda") / 8).bfloat16()
g = torch.randn(k, generator=gen, device="cuda").bfloat16()
beta, mean = torch.randn(n, device="cuda"), torch.randn(n, device="cuda") * .1
var = torch.rand(n, device="cuda") + 0.5
bf16 = torch.bfloat16
rows = {"matmul": (B.MATMUL, lambda: B.MATMUL(a, b, bf16)),
        "fused_dense_act": (B.FUSED_DENSE_ACT, lambda: B.FUSED_DENSE_ACT(
            a, b, bf16, beta=beta, mean=mean, var=var, act="gelu")),
        "fused_rnz": (B.FUSED_RNZ, lambda: B.FUSED_RNZ(a, b, bf16, g=g))}
device, event, body = {}, {}, {}
for name, (launcher, run) in rows.items():
    device[name] = device_ms(run, "baseline_")
    event[name] = cs._timed(run, flush)
    body[name] = getattr(launcher, "last_body", None)
print("COMPARE " + json.dumps({"tree": sys.argv[1],
                               "baselines_device_ms": device,
                               "baselines_ms": event, "body": body}),
      flush=True)
"""

F32_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cs.OUT, "autotune.json")
os.environ["REPRO_PLAN_DB"] = os.path.join(cs.OUT, "plans.json")
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch import codegen, ops
from repro_torch.codegen import CONTRACT, build
from repro_torch.core.enumerate import matmul_spec
build.build("contract")
build.load("contract")
""" + DEVICE_MS + r"""
gen = torch.Generator(device="cuda").manual_seed(31)
flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
m, d, f = cs.FUSED_M, cs.FUSED_D, cs.FUSED_F
f32 = torch.float32
x = torch.randn(m, d, generator=gen, device="cuda") / 8
w = torch.randn(d, f, generator=gen, device="cuda") / 8
vec = {"scale": torch.randn(f, generator=gen, device="cuda"),
       "bias": torch.randn(f, generator=gen, device="cuda"),
       "mean": torch.randn(f, generator=gen, device="cuda") * 0.1,
       "var": torch.rand(f, generator=gen, device="cuda") + 0.5}
spec = matmul_spec(m, d, f)
plain = ops._tuned_kernel(spec, f32)
runs = {"plain": lambda: plain(x, w)}
for norm in (False, True):
    for act in cs.ACTS:
        epi = codegen.Epilogue(act=act, bias=True, scale=not norm, norm=norm)
        vs = {key: vec[key] for key in epi.vector_names}
        kern = ops._tuned_kernel(spec, f32, epilogue=epi)
        runs[f"epilogue {act} {'norm' if norm else 'scale'}"] = (
            lambda kern=kern, vs=vs: kern(x, w, **vs))
a = torch.randn(1, 128, 4096, generator=gen, device="cuda")
b = torch.randn(1, 4096, 4096, generator=gen, device="cuda")
runs["kernel M=128 K=4096 N=4096"] = lambda: CONTRACT(a, b, f32)
device, event, body = {}, {}, {}
for name, run in runs.items():
    device[name] = device_ms(run, "contract_f32")
    event[name] = cs._timed(run, flush)
    body[name] = CONTRACT.last_body
del x, w, a, b
# qwen3-8b's f32 unembedding on B1 (phase capture's rows): the forward and
# the two derived specs of its backward at train's M = 2048 and decode's 4
from repro_torch.configs import get_config
from repro_torch.grad import COTANGENT, derived_specs
from repro_torch.grad.vjp import apply_spec
cfg = get_config("qwen3-8b")
w = torch.randn(cfg.d_model, cfg.vocab, generator=gen, device="cuda")
for m in (cs.TRAIN_M, 4):
    x = torch.randn(m, cfg.d_model, generator=gen, device="cuda")
    g = torch.randn(m, cfg.vocab, generator=gen, device="cuda")
    dsp = derived_specs(matmul_spec(m, cfg.d_model, cfg.vocab))
    calls = {
        "fwd": lambda: ops.dense(x, w, differentiable=False),
        ".dA": lambda: apply_spec(dsp["A"], {COTANGENT: g, "B": w},
                                  out_dtype=f32, use_kernel=True),
        ".dB": lambda: apply_spec(dsp["B"], {COTANGENT: g, "A": x},
                                  out_dtype=f32, use_kernel=True)}
    with torch.no_grad():
        for what, run in calls.items():
            name = f"unembedding M={m} {what}"
            device[name] = device_ms(run, "contract_f32", reps=3)
            event[name] = cs._timed(run, flush, reps=3, warmup=1)
            body[name] = CONTRACT.last_body
            torch.cuda.empty_cache()
    del x, g
print("COMPARE " + json.dumps({"tree": sys.argv[1], "f32_device_ms": device,
                               "f32_ms": event, "body": body}), flush=True)
"""

DW_TURN = r"""
import json, os, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cs.OUT, "autotune.json")
os.environ["REPRO_PLAN_DB"] = os.path.join(cs.OUT, "plans.json")
from repro_torch import ops
from repro_torch.codegen import GROUPED_DW, build
from repro_torch.core.enumerate import GroupedSpec
build.build("grouped_dw")
build.load("grouped_dw")
""" + DEVICE_MS + r"""
gen = torch.Generator(device="cuda").manual_seed(32)
flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
train = (cs.MOE_TRAIN_C,) * cs.MOE_TRAIN_EXPERTS
full = (28,) * cs.N_EXPERTS
cases = {"train gate/up": (train, cs.GROUPED_GATE),
         "train down": (train, cs.GROUPED_DOWN),
         "gate/up": (full, cs.GROUPED_GATE), "down": (full, cs.GROUPED_DOWN)}
device, event, body = {}, {}, {}
for name, (sizes, (k1, k2)) in cases.items():
    n = sum(sizes)
    x = torch.randn(n, k1, generator=gen, device="cuda").bfloat16()
    dout = torch.randn(n, k2, generator=gen, device="cuda").bfloat16()
    spec = GroupedSpec(name="grouped_matmul.dW",
                       operands={"dout": ("n", "f"), "X": ("n", "k")},
                       output=("g", "k", "f"),
                       extents={"n": n, "k": k1, "f": k2, "g": len(sizes)},
                       group_sizes=sizes)
    kern = ops._tuned_kernel(spec, torch.bfloat16)
    run = lambda: kern(dout, x)
    device[name] = device_ms(run, "grouped_dw_")
    event[name] = cs._timed(run, flush)
    body[name] = getattr(GROUPED_DW, "last_body", None)
    del x, dout
    torch.cuda.empty_cache()
# the MoE train step's three dW calls of one layer: gate, up, down
three = lambda by: 2 * by["train gate/up"] + by["train down"]
print("COMPARE " + json.dumps({"tree": sys.argv[1], "dw_device_ms": device,
                               "dw_ms": event, "body": body,
                               "train_three_device_ms": three(device),
                               "train_three_ms": three(event)}), flush=True)
"""

CAPTURE_SERVE_TURN = r"""
import collections, json, os, sys, time
sys.path.insert(0, "src")
import chip_smoke as cs
import torch

os.makedirs(cs.OUT, exist_ok=True)
for var, name in (("REPRO_AUTOTUNE_CACHE", "autotune"),
                  ("REPRO_PLAN_DB", "plans")):
    path = os.path.join(cs.OUT, f"{name}_capture_{os.getpid()}.json")
    if os.path.exists(path):
        os.remove(path)
    os.environ[var] = path
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
from repro_torch.codegen import build, fused_gen
from repro_torch.launch import serve
for name in ("contract", "attention"):
    build.build(name)
    build.load(name)
launcher = fused_gen.ATTENTION
real, plans = type(launcher).__call__, []
def call(self, *a, **kw):
    n0 = self.launches
    out = real(self, *a, **kw)
    if self.launches > n0:
        p = getattr(self, "last_plan", None)
        plans.append("none" if p is None else
                     f"{p.body} {p.block}x{p.ctas}")
    return out
type(launcher).__call__ = call
t0 = time.perf_counter()
stats, trace, engine = serve.main(cs.SERVE_ARGS + ["--capture",
                                                   "--no-search-grads"])
wall = time.perf_counter() - t0
cap = engine.capture_stats
served = stats["attention_launches"]
print("COMPARE " + json.dumps({
    "tree": sys.argv[1], "sweep_s": cap["sweep_s"], "points": cap["points"],
    "specs": cap["specs"],
    "b2_sweep": collections.Counter(plans[:len(plans) - served]),
    "b2_served": collections.Counter(plans[len(plans) - served:]),
    "b1": stats["kernel_launches"], "b2": served,
    "prefill_ms": stats["prefill_s"] * 1e3,
    "decode_tok_s": stats["tok_per_s"], "wall_s": wall}), flush=True)
"""

TURNS = {"--serve": SERVE_TURN, "--kernels": KERNELS_TURN,
         "--moe-serve": MOE_SERVE_TURN, "--quant": QUANT_TURN,
         "--modes": MODES_TURN, "--attention": ATTENTION_TURN,
         "--baselines": BASELINES_TURN, "--f32": F32_TURN,
         "--dw": DW_TURN, "--capture-serve": CAPTURE_SERVE_TURN}


def main(argv) -> int:
    turn = TURN
    if len(argv) == 4 and argv[1] in TURNS:
        turn = TURNS[argv[1]]
        argv = argv[:1] + argv[2:]
    if len(argv) != 3:
        raise SystemExit(__doc__)
    old, new = (os.path.abspath(p) for p in argv[1:])
    for tree in (old, new, new, old):
        out = subprocess.run([sys.executable, "-c", turn, tree], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"chip_compare: the turn in {tree} failed "
                             f"(exit {out.returncode})")
        print([ln for ln in out.stdout.splitlines()
               if ln.startswith("COMPARE ")][-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
