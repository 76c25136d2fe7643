"""Hand-written Hopper kernels for the paper's compute hot-spots.

The port of the reference's ``repro.kernels``: each kernel directory holds

  <name>.py  -- the wrapper of the hand-written CUDA kernel (on a CUDA
                tensor it launches, on a CPU tensor it runs ``ref.py``)
  ops.py     -- the public entry: the generated contraction kernel (B1,
                ``codegen``) by default, the hand-written kernel with
                ``use_generated=False`` or pinned blocks, as the reference
                routes
  ref.py     -- the plain PyTorch version, the tests' oracle

All three kernels (B5 ``matmul``, B6 ``fused_dense_act``, B7
``weighted_matmul``) are one templated CUDA body,
``codegen/csrc/baselines.cu``, built by ``codegen.build`` at first use;
``_baselines`` is its ctypes wrapper, with one launch counter per kernel.
None of them carries state between calls.
"""
