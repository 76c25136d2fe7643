"""repro_torch.capture — whole-model GEMM capture into the plan-DB pipeline.

A port of the reference's ``capture`` package.  A call site wired to
``repro_torch.ops`` gets cost-guided search, ranked plans, tuning and
derived-spec backward kernels; the models' other products (attention's
einsums, the unembedding, the MoE experts' batched einsums) are plain
PyTorch.  This package closes that gap at the graph level:

    from repro_torch import capture

    loss_c = capture.optimize(loss_fn)        # trace-once wrapper
    loss_c(params, batch)                     # eligible GEMMs -> ops/plan DB
    loss_c(params, batch).backward()          # bwd GEMMs: derived specs
    loss_c.report_for(params, batch).summary()
    # "capture[loss_fn]: 9 site(s) harvested, 9 dispatched, 0 fallback"

Layers:

  ``harvest``   trace a function into an aten graph (``make_fx`` on fake
                tensors), recording its torch-level products and layer
                bodies; classify each product into a ``ContractionSpec``
                named by ``core.enumerate`` — so each site owns the same
                plan-DB/autotune keys a hand-wired op would — and report
                dispatched vs fallback per site, with reasons.
  ``rewrite``   ``optimize(fn)``: replay the graph with eligible sites
                dispatched through ``repro_torch.ops`` (differentiable via
                ``repro_torch.grad``), everything else run as traced.
  ``sweep``     model-level harvest on fake tensors (no allocation) +
                offline sweep of the harvested GEMM set, fwd+bwd, into the
                ranked plan DB.
  ``report``    ``python -m repro_torch.capture.report``: the per-model
                capture-report artifact.

Integration points: ``launch.steps.make_train_step(capture=True)`` /
``launch.train --capture`` (training through captured losses),
``launch.serve --capture`` (harvest, sweep and serve through the captured
steps, both engines) and ``python -m repro_torch.search.sweep
--from-model`` (offline sweeps).
"""

from .harvest import (
    SUPPORTED_DTYPES,
    CaptureReport,
    CaptureSite,
    classify_dot_general,
    einsum_dot,
    harvest_graph,
    matmul_dot,
    spec_key,
    trace,
)
from .rewrite import CapturedFunction, capture_report, optimize
from .sweep import (
    DEMO_BATCH,
    DEMO_SEQ,
    KINDS,
    demo_configs,
    model_capture,
    model_gemm_specs,
    sweep_captured,
)

__all__ = [
    "CaptureReport",
    "CaptureSite",
    "CapturedFunction",
    "DEMO_BATCH",
    "DEMO_SEQ",
    "KINDS",
    "SUPPORTED_DTYPES",
    "capture_report",
    "classify_dot_general",
    "demo_configs",
    "einsum_dot",
    "harvest_graph",
    "matmul_dot",
    "model_capture",
    "model_gemm_specs",
    "optimize",
    "spec_key",
    "sweep_captured",
    "trace",
]
