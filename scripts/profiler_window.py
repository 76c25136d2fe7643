"""How many device records a short ``torch.profiler`` session keeps.

``chip_smoke.py`` counts a kernel's launches from the device records of a
profiler session (``_alone``, ``_launch_witness``, the serving profile).
This probe takes sessions of three calls, after one warm-up call outside
the session, and prints the records each session kept, for four kinds of
call:

* ``spin``: ``torch.cuda._sleep`` for 0.5 ms (a PyTorch kernel);
* ``b2``: one B2 launch (``codegen.ATTENTION``, 4 heads, S = T = 512,
  d = 128, causal, bf16: the ring body);
* ``b1``: one B1 launch (``codegen.CONTRACT``, a 1024 x 1024 x 1024 bf16
  product: the ring body);
* ``b5``: one B5 launch (``kernels._baselines.MATMUL``, the same product:
  its ring body);

each in three sessions (``--kinds`` picks the kinds and their order):
``bare`` (the calls alone), ``pad`` (a host pause
of ``--pad`` ms after the session opens and before it closes) and
``marker`` (32 float64 fills first, as ``chip_smoke._marker_records``
opens; the line says how many marker records each session kept at its
start: ``chip_smoke._judge_take`` counts a take only where one was kept).

Run on the card from the repo's root (it builds ``contract.cu``,
``attention.cu`` and ``baselines.cu`` when they are not built):
``python3 scripts/profiler_window.py [--sessions 12] [--pad 20]``.
Writes its traces under ``smoke_out/profiler_window/``.
"""
import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

OUT = os.path.join("smoke_out", "profiler_window")
WORD = {"spin": "spin_kernel", "b2": "attn_", "b1": "contract_",
        "b5": "baseline_"}
MARKER = "FillFunctor<double>"
MARKERS = 32  # chip_smoke.MARKERS


def _records(prof, word):
    """(records of the call's kernel, other device records, the marker's
    records at the start) in the trace."""
    path = os.path.join(OUT, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X" and e.get(
        "cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    lead = 0
    while lead < len(names) and MARKER in names[lead]:
        lead += 1
    mine = sum(word in n for n in names)
    return mine, len(names) - mine - lead, lead


def session(call, word, variant, pad_s):
    marker = torch.zeros(1, dtype=torch.float64, device="cuda")
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if variant == "pad":
            time.sleep(pad_s)
        if variant == "marker":
            for _ in range(MARKERS):
                marker.fill_(1.0)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        if variant == "pad":
            time.sleep(pad_s)
    return _records(prof, word)


def calls():
    from repro_torch.codegen import ATTENTION, CONTRACT
    from repro_torch.kernels._baselines import MATMUL

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 512, 128, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    a, b = (torch.randn(1024, 1024, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    cycles = _cycles_per_us() * 500
    return {
        "spin": lambda: torch.cuda._sleep(int(cycles)),
        "b2": lambda: ATTENTION(q, k, v, True, None, torch.bfloat16),
        "b1": lambda: CONTRACT(a[None], b[None], torch.bfloat16),
        "b5": lambda: MATMUL(a, b, torch.bfloat16),
    }


def _cycles_per_us():
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / (start.elapsed_time(end) * 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=12)
    ap.add_argument("--pad", type=float, default=20.0)
    ap.add_argument("--kinds", default="spin,b2,b1,b5",
                    help="the kinds of call, in the order they are taken")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    table = calls()
    for kind in args.kinds.split(","):
        call = table[kind]
        for variant in ("bare", "pad", "marker"):
            kept = [session(call, WORD[kind], variant, args.pad / 1e3)
                    for _ in range(args.sessions)]
            marker = (f", marker records kept at the start "
                      f"{[k for _, _, k in kept]}"
                      if variant == "marker" else "")
            print(f"{kind} {variant}: records of 3 calls kept "
                  f"{[m for m, _, _ in kept]}, other records "
                  f"{[o for _, o, _ in kept]}{marker}", flush=True)
    with open("/proc/self/maps") as f:
        runtimes = sorted({line.split()[-1] for line in f
                           if "libcudart" in line})
    print(f"CUDA runtimes mapped: {runtimes}", flush=True)


if __name__ == "__main__":
    main()
