"""Model-level harvest + offline sweep: a config's full GEMM set in one pass.

A port of the reference's ``capture/sweep.py``.  It bridges ``capture`` to
the search pipeline: trace a model's train loss / prefill / decode step
on fake tensors (``FakeTensorMode``: no parameter is allocated, so
harvesting a 400B config costs only a trace), collect the dispatched
sites' ContractionSpecs, and run each through ``search.search_schedule``
— with ``with_grads`` the derived backward specs (``grad.derive``) are
swept alongside, so one offline pass readies ranked plans for the model's
forward *and* backward GEMM traffic.

Consumers: ``python -m repro_torch.search.sweep --from-model``, ``serve
--capture`` and ``python -m repro_torch.capture.report``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..configs.base import ModelConfig
from .harvest import CaptureReport, spec_key
from .rewrite import CapturedFunction

#: trace points a model exposes to the harvester
KINDS = ("train", "prefill", "decode")


def _fake_params(cfg: ModelConfig, api, device):
    """The params of ``cfg`` as fake tensors on ``device`` (the model's
    own ``init`` on the meta device: shapes and dtypes, no draw)."""
    from ..optim.adamw import tree_map

    shapes = api.init(cfg, None, torch.device("meta"))
    return tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), shapes)


def model_capture(
    cfg: ModelConfig,
    *,
    batch: int,
    seq: int,
    kind: str = "train",
    interpret: Optional[bool] = None,
    dispatch: bool = True,
    device="cpu",
) -> Tuple[CapturedFunction, CaptureReport]:
    """Capture one model entry point on fake tensors; returns (fn, report).

    ``kind``: ``train`` traces the loss (the GEMM set training runs
    forward; with ``with_grads`` sweeps, its derived specs cover the
    backward), ``prefill``/``decode`` trace the serving steps.  ``device``
    places the fake tensors: eligibility is the device's (every non-empty
    dense product on "cuda"; the reference's 128-alignment gate on the CPU
    with ``interpret``).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs.base import ShapeConfig
    from ..models.api import batch_spec, get_api

    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    api = get_api(cfg)
    shape = ShapeConfig(f"capture_{kind}", seq, batch,
                        "train" if kind == "train" else "prefill")
    with FakeTensorMode(allow_non_fake_inputs=True):
        p = _fake_params(cfg, api, device)
        b = {name: torch.zeros(shp, dtype=dt, device=device)
             for name, (shp, dt) in batch_spec(cfg, shape).items()}
        if kind == "train":
            fn = lambda params, bt: api.loss(params, cfg, bt)  # noqa: E731
            args = (p, b)
        elif kind == "prefill":
            fn = lambda params, bt: api.prefill(  # noqa: E731
                params, cfg, bt, seq)
            args = (p, b)
        else:
            caches = api.cache_init(cfg, batch, seq, device=device)
            toks = torch.zeros((batch, 1), dtype=torch.int32, device=device)
            fn = lambda params, c, t: api.decode_step(  # noqa: E731
                params, cfg, c, t
            )
            args = (p, caches, toks)
        captured = CapturedFunction(
            fn, interpret=interpret, dispatch=dispatch,
            label=f"{cfg.arch_id}:{kind}",
        )
        report = captured.report_for(*args)
    return captured, report


def model_gemm_specs(
    cfg: ModelConfig,
    *,
    batch: int,
    seq: int,
    kinds: Sequence[str] = ("train",),
    interpret: Optional[bool] = None,
    device="cpu",
) -> List[Tuple[str, object, str]]:
    """Deduplicated ``(label, spec, dtype)`` GEMM set across trace points."""
    seen: Dict[Tuple, Tuple[str, object, str]] = {}
    for kind in kinds:
        _, report = model_capture(
            cfg, batch=batch, seq=seq, kind=kind, interpret=interpret,
            device=device,
        )
        for spec, dtype in report.unique_specs():
            seen.setdefault(
                spec_key(spec, dtype), (f"{kind}:{spec.name}", spec, dtype)
            )
    return list(seen.values())


def sweep_captured(
    points: Sequence[Tuple[str, object, str]],
    *,
    with_grads: bool = True,
    plan_db=None,
    beam_width: int = 4,
    topk: int = 2,
    interpret: bool = True,
    measure: bool = True,
    repeats: int = 1,
    verbose: bool = False,
    mesh_shape=None,
    quant=None,
    device: Optional[str] = None,
) -> int:
    """Search + persist ranked plans for every harvested GEMM point.

    Each point expands through ``search.space.sweep_specs`` (fwd plus the
    derived dA/dB/... specs when ``with_grads``), so the plan DB ends up
    covering the captured model's full fwd+bwd GEMM traffic.  With
    ``mesh_shape`` ('2x4') every sweep point is *additionally* swept at
    the mesh tier, persisting sharded ladders under the mesh-qualified
    keys, as the reference does: a captured model then serves and trains
    through mesh-bound kernels whenever a matching mesh is active
    (``ops._mesh_plan_kernel``); a fused-family point (attention, the
    grouped products) has no mesh tier and is swept at mesh=None only.  With ``quant`` ('int8' | 'fp8') every
    *forward* sweep point also gets a quantized leg — the spec re-searched
    at the low-precision tier under its dtype-qualified plan key, at
    mesh=None only — skipping the fused and derived specs that refuse
    quantization.  ``device`` is where candidates are measured
    (``search.search_schedule``; by default the card where one is
    visible).  Returns the number of (spec, dtype, mesh) sweep points
    persisted.
    """
    from ..core.enumerate import QUANT_FORMATS, quantize_spec
    from ..search import default_plan_db, search_schedule, sweep_specs

    db = plan_db if plan_db is not None else default_plan_db()
    if quant is not None and quant not in QUANT_FORMATS:
        raise ValueError(
            f"quant must be one of {sorted(QUANT_FORMATS)}, got {quant!r}"
        )
    n = 0
    meshes = [None] + ([mesh_shape] if mesh_shape is not None else [])
    for label, spec, dtype in points:
        for sub_label, sub in sweep_specs(spec, with_grads=with_grads):
            # the fused families have no mesh tier (``compile_fused``)
            fused = getattr(sub.root(), "fused_kind", "")
            legs = [(sub_label, sub, str(dtype), [None] if fused else meshes)]
            if quant is not None and sub_label == "fwd":
                try:
                    qspec = quantize_spec(sub, fmt=quant)
                    qdt = QUANT_FORMATS[quant].dtype
                except (NotImplementedError, ValueError, TypeError):
                    qspec = None  # fused family
                if qspec is not None:
                    legs.append((f"{sub_label}@{quant}", qspec, qdt, [None]))
            for leg_label, leg_spec, leg_dt, leg_meshes in legs:
                for ms in leg_meshes:
                    res = search_schedule(
                        leg_spec, dtype=leg_dt, beam_width=beam_width,
                        topk=topk, interpret=interpret, measure=measure,
                        repeats=repeats, plan_db=db, device=device,
                        mesh_shape=ms,
                    )
                    n += 1
                    if verbose:
                        from ..obs import log

                        best = res.best
                        t = ("-" if best.measured_s is None
                             else f"{best.measured_s * 1e3:.2f}ms")
                        at = f"@mesh={res.mesh}" if res.mesh else ""
                        log.info("capture-sweep",
                                 f"{label}/{leg_label}{at} dtype={leg_dt} "
                                 f"best={t} (db={db.path})")
    return n


# ---------------------------------------------------------------------------
# demo configs — the capture conformance trio
# ---------------------------------------------------------------------------


def demo_configs() -> Dict[str, ModelConfig]:
    """Three tiny, 128-aligned configs (dense / MoE / SSM): the
    reference's, field for field, from the port's configs.

    Derived from the real arch smokes but with extents snapped to the
    dense kernel's 128-alignment so the 2-D projection sites dispatch in
    interpret mode (the point of the conformance run); ``float32`` keeps
    the fwd/bwd comparison tolerances tight.
    """
    from ..configs import get_config

    dense = dataclasses.replace(
        get_config("qwen3-8b").smoke(),
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
        d_ff=128, vocab=256, dtype="float32",
    )
    moe_base = get_config("kimi-k2-1t-a32b").smoke()
    moe = dataclasses.replace(
        moe_base,
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
        d_ff=128, vocab=256, dtype="float32",
        moe=dataclasses.replace(
            moe_base.moe, n_experts=4, top_k=2, expert_ff=64,
            first_dense=1, dense_ff=128, shared_expert_ff=0,
        ),
    )
    ssm_base = get_config("mamba2-130m").smoke()
    ssm = dataclasses.replace(
        ssm_base,
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=0, head_dim=64,
        d_ff=128, vocab=256, dtype="float32",
    )
    return {"dense": dense, "moe": moe, "ssm": ssm}


#: (batch, seq) used with the demo configs: batch*seq = 128 keeps the
#: flattened token dim aligned for the dense-kernel dispatch predicate
DEMO_BATCH, DEMO_SEQ = 2, 64
