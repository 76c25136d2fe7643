"""Block-shape selection for the hand-written blocked kernels.

The reference's ``core/autotune.py`` holds two halves: the variant tuner
(enumerate HoF orderings, early-cut with the cost model, measure) and
``choose_matmul_blocks``, the block shapes of the hand-written matmul
kernels.  The port has only the second so far (the tuner half comes with
the search slice, ROADMAP.md queue A item 4).  It is a copy, scored over
the port's copy of the reference's ``TPU`` dict (``core.cost``), so it
picks the reference's blocks.  The hand-written CUDA kernels
(``kernels/*``, ``codegen/csrc/baselines.cu``) check that the blocks
divide the extents, as the reference asserts, but tile by their own CTA
tiles.
"""

from __future__ import annotations

from typing import List, Tuple

from .cost import TPU


def choose_matmul_blocks(
    m: int,
    n: int,
    k: int,
    elem_bytes: int = 2,
    hw: dict = TPU,
    double_buffer: bool = True,
) -> Tuple[int, int, int]:
    """(block_m, block_n, block_k) minimizing HBM traffic under VMEM.

    Napkin model (the TPU analogue of the paper's cache reasoning):
      traffic = M*K * (N/bn)  +  K*N * (M/bm)  +  M*N
    so we maximize bm, bn subject to
      (bm*bk + bk*bn + bm*bn) * elem * (2 if double_buffer) <= VMEM
    with every extent a multiple of the MXU tile where possible.
    """
    budget = hw["vmem_bytes"] // (2 if double_buffer else 1) // elem_bytes

    def aligned(align: int, size: int, cap: int = 1024) -> List[int]:
        """Divisors of ``size`` that are pow2 multiples of ``align``."""
        outs, c = [], align
        while c <= min(size, cap):
            if size % c == 0:
                outs.append(c)
            c *= 2
        return outs or [size]

    best, best_score = None, None
    for bm in aligned(8, m):
        for bn in aligned(128, n):
            for bk in aligned(128, k):
                if bm * bk + bk * bn + bm * bn > budget:
                    continue
                traffic = m * k * (n / bn) + k * n * (m / bm) + m * n
                # prefer deeper k-blocks on ties (fewer grid steps)
                score = (traffic, -bk, -(bm * bn))
                if best is None or score < best_score:
                    best, best_score = (bm, bn, bk), score
    if best is None:  # tiny problem: single block
        best = (m, n, k)
    return best
