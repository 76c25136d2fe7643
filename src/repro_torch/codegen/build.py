"""Build the port's CUDA sources with ``nvcc`` at first use, load with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, so it compiles in seconds
without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

The library lands in ``codegen/_build/`` (listed in ``.gitignore``), named by
a hash of its source and of the ``csrc/`` headers it includes (``#include
"hopper.cuh"``: the TMA, mbarrier and wgmma helpers of B1's ring bodies),
so an edited kernel or header is rebuilt and an unchanged one is loaded as
it is.  No source links libcuda: the one libcuda call the rings need,
``cuTensorMapEncodeTiled``, is reached through the runtime's entry-point
query (``cudaGetDriverEntryPoint``, ``csrc/hopper.cuh``).  ``ptxas``'s report
(registers, shared memory, spills per kernel) is kept beside it as
``<name>-<hash>.ptxas.txt``.  There is no fallback: without ``nvcc`` or a
card the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
            "port's CUDA kernels are built from source at first use"
        )
    return path


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes with
    quotes, transitively, in the order first met."""
    out, todo = [], [os.path.join(CSRC, f"{name}.cu")]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        with open(path) as f:
            todo += [os.path.join(CSRC, inc) for inc in
                     re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M)]
    return out


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is (or will be) built: named by a hash of
    the source, the headers it includes and the arch flags."""
    digest = hashlib.sha256()
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the build of ``csrc/<name>.cu``."""
    path = library_path(name)[: -len(".so")] + ".ptxas.txt"
    with open(path) as f:
        return f.read()


def nvcc_command(name: str, out: str) -> list:
    """The nvcc command that compiles ``csrc/<name>.cu`` into ``out``."""
    return [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", out, os.path.join(CSRC, f"{name}.cu"),
    ]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the path.

    The compile writes to a temporary name and is renamed into place, so a
    concurrent builder or an interrupted build never leaves a torn library.
    """
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(name, tmp), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        with open(out[: -len(".so")] + ".ptxas.txt", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (first use) and load ``csrc/<name>.cu``; one handle per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib
