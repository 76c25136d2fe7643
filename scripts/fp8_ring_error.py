#!/usr/bin/env python3
"""Worst error of B1's fp8 ring body against the exact product, by K.

    python3 scripts/fp8_ring_error.py

On one NVIDIA card: for each K from 16 to 12288, seeded e4m3 operands
(normals times 4, 1 and 0.05, three (M, N) shapes, six seeds) go through
``CONTRACT_FP8`` forced onto the ring (wgmma) and onto the mma.sync body;
each output is held against the float64 product of the same operands,
its largest error divided by max |ref| (how the f32 TOL of 1e-4 scales
it).  Prints the worst scaled error of each body per K, and the card's
name and power limit.  ``modes.FP8_RING_MIN_K`` is chosen from it.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

KS = (16, 32, 64, 128, 192, 256, 320, 384, 512, 1024, 4096, 12288)
SHAPES = ((64, 64), (128, 128), (256, 384))
SCALES = (4.0, 1.0, 0.05)


def main() -> int:
    import torch

    from repro_torch.codegen import modes

    if not torch.cuda.is_available():
        raise SystemExit("fp8_ring_error: needs an NVIDIA card")
    dev = torch.device("cuda")
    worst = {}
    for seed in range(6):
        gen = torch.Generator(device=dev).manual_seed(200 + seed)
        for k in KS:
            for m, n in SHAPES:
                for scale in SCALES:
                    a, bt = ((torch.randn(r, k, generator=gen, device=dev)
                              * scale).to(torch.float8_e4m3fn)
                             for r in (m, n))
                    ref = a.double() @ bt.t().double()
                    top = ref.abs().max().item() or 1.0
                    row = worst.setdefault(k, {"ring": (0.0, None),
                                               "mma": (0.0, None)})
                    for body in ("ring", "mma"):
                        got = modes.CONTRACT_FP8(
                            a[None], bt.t()[None], torch.float32,
                            int_acc=False, body=body)[0]
                        err = (got.double() - ref).abs().max().item() / top
                        if err > row[body][0]:
                            row[body] = (err, (m, n, scale, seed))
    for k in KS:
        (ring, at), (mma, _) = worst[k]["ring"], worst[k]["mma"]
        print(f"fp8 K={k}: ring worst scaled err {ring:.3g} at (M, N, "
              f"scale, seed) {at}; mma.sync {mma:.3g}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
