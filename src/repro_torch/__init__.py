"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

It mirrors the reference's subpackages (``core``, ``codegen``, ``search``,
``ops``, ``configs``, ``models``, ``launch.serving``, ``obs``) and imports
torch and numpy, never jax and nothing of ``repro``.  The reference's one
TPU kernel on the serving path, the generated contraction kernel, is
``codegen/csrc/contract.cu``, a hand-written Hopper kernel built by
``nvcc`` at first use.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""
