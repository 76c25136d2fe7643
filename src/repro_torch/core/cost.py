"""The tuner's analytic scoring model, copied from the reference.

``TPU`` is the reference's hardware dict, kept verbatim because
``codegen.tune._score`` still ranks candidate schedules with it: the port
must pick the same schedules as the reference (``cache_key`` folds the
dict's numeric items into every autotune key, so the golden cache file
only reads back if they are byte-identical).  It describes the
reference's target, not the card this package runs on; the CUDA kernel
takes its own CTA grid and ignores the plan's blocking
(``codegen.cuda_gen``).  A Hopper-aware tuner is a later slice.
"""

from __future__ import annotations

TPU = dict(
    peak_flops=197e12,
    hbm_bw=819e9,
    vmem_bytes=64 * 1024 * 1024,
    ici_bw=50e9,
    mxu=(128, 128),
    sublane=8,
)
