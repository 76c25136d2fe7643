"""Compute/communication overlap: a re-export of the ring collectives.

As in the reference, the ring (point-to-point pipelined) collective
machinery lives in ``repro_torch.codegen.collectives``, where generated
mesh-tier kernels choose it as a per-plan collective strategy
(``bind_mesh(collective="ring")``); the launch layer imports from here.
"""

from __future__ import annotations

from ..codegen.collectives import (  # noqa: F401
    naive_gather_matmul,
    ring_gather_matmul,
    ring_psum,
)

__all__ = ["naive_gather_matmul", "ring_gather_matmul", "ring_psum"]
