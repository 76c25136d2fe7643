#!/usr/bin/env python3
"""One tree against another, in turns on one card.

    python3 scripts/chip_compare.py [--serve | --kernels | --moe-serve] \
        OLD_CHECKOUT NEW_CHECKOUT

Runs, in a fresh process per turn and in the order old, new, new, old,
phases of each checkout's own ``chip_smoke.py``, after building the
checkout's sources that they run.  By default: ``kernel`` (B1 at the serving
GEMMs), ``b1-train`` (B1 at one qwen3-8b layer's training GEMMs, forward
and backward) and ``train`` (qwen3-8b at full width cut to 8 layers, 5
steps); each turn prints one line ``COMPARE {...}``: the tree, B1's time
per serve layer (the 7 GEMMs at M = 512), per train layer (the 7 forward
and 14 backward GEMMs at M = 2048) and the steady train step.  With
``--serve``: ``serve`` (qwen3-8b at full width and depth, the smoke's
serving flags) and ``profile`` (request 0's prefill and one batch-1 decode
step on the host clock and under ``torch.profiler``); each turn prints the
tree, decode tok/s, prefill ms, p50, B1's launches over the serving run,
and the profiled decode step's wall ms, device busy ms and B1 launches and
ms.  With ``--kernels``: ``grouped`` (B3 at every case of the phase) and
``chain`` (``ops.chain_dense`` and the chain kernel at each spec of
CHAIN_SHAPE, f32 and bf16), plus the int8 and fp8 chain at CHAIN_SHAPE
through ``codegen.compile``; each turn prints the tree, every case's
kernel ms, B3's train entry (a kimi-k2 MoE layer's 3 forward and 3 dX
products) and serve sum (gate, up and down at C = 16), and the chain's
bf16 entry (its four specs) and the profiled device ms of the chain
kernel over ``chain_dense``'s forward and backward.  With ``--moe-serve``: ``moe-serve``
(kimi-k2 at full width cut to 2 layers, the smoke's serving flags, under
``REPRO_MOE_GROUPED=1``); each turn prints the tree, every request's greedy
tokens, prefill ms, decode tok/s and the B3 launches.  Needs one NVIDIA
card; compare two versions only within one run of this script.
"""

from __future__ import annotations

import os
import subprocess
import sys

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
from repro_torch.codegen import build
build.build("contract")
build.load("contract")
rows = cs.phase_kernel()
b1 = cs.phase_b1_train()
train, *_ = cs.phase_train(
    "train", "qwen3-8b", cs.TRAIN_FLAGS,
    lambda c: dataclasses.replace(c, n_layers=cs.TRAIN_LAYERS))
serve = sum(r["ms"] * cs.LAYER_GEMMS[(r["K"], r["N"])] for r in rows
            if r["M"] == 512 and r["dtype"] == "bfloat16")
layer = sum(r["ms"] * cs.LAYER_GEMMS[(r["K"], r["N"])] for r in b1)
print("COMPARE " + json.dumps({
    "tree": sys.argv[1], "serve_layer_ms": serve, "train_layer_ms": layer,
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
from repro_torch.codegen import build
build.build("contract")
build.load("contract")
launches, stats, peak, trace, engine = cs.phase_serve()
prof = cs.phase_profile(engine, trace[0])
dec = prof["decode"]
print("COMPARE " + json.dumps({
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

TURNS = {"--serve": SERVE_TURN, "--kernels": KERNELS_TURN,
         "--moe-serve": MOE_SERVE_TURN}


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
