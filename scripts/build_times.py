#!/usr/bin/env python3
"""Time the port's CUDA builds: each source alone, then all at once.

    python3 scripts/build_times.py

Compiles every source that ``chip_smoke.py`` builds (``chip_smoke.SOURCES``)
with ``codegen.build``'s nvcc command into a temporary directory, first one
after another and then all in parallel, one process each, as
``chip_smoke.py``'s build phase starts them.  Prints one line ``BUILD {...}``:
each source's seconds alone and in parallel and its kernel count, and the
parallel wall.  The gap between the two columns is the machine's cores
shared out among the compiles.  Needs nvcc; no card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

from chip_smoke import SOURCES  # noqa: E402
from repro_torch.codegen import build  # noqa: E402


def main() -> int:
    out = tempfile.mkdtemp()
    alone, kernels = {}, {}
    for name in SOURCES:
        t0 = time.perf_counter()
        proc = subprocess.run(build.nvcc_command(name, os.path.join(
            out, f"{name}-alone.so")), capture_output=True, text=True)
        alone[name] = round(time.perf_counter() - t0, 1)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return 1
        kernels[name] = (proc.stdout + proc.stderr).count("registers")
    t0 = time.perf_counter()
    procs = {name: (time.perf_counter(), subprocess.Popen(
        build.nvcc_command(name, os.path.join(out, f"{name}.so")),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        for name in SOURCES}
    together = {}
    pending = dict(procs)
    while pending:
        for name, (start, proc) in list(pending.items()):
            if proc.poll() is not None:
                if proc.returncode != 0:
                    return 1
                together[name] = round(time.perf_counter() - start, 1)
                del pending[name]
        time.sleep(0.05)
    wall = round(time.perf_counter() - t0, 1)
    print("BUILD " + json.dumps({
        "alone_s": alone, "parallel_s": together, "kernels": kernels,
        "alone_sum_s": round(sum(alone.values()), 1),
        "parallel_wall_s": wall, "cpus": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
