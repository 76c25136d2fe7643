"""Prefill and decode runners — the two compute phases of serving.

Prefill is compute-bound (square-ish GEMMs over the whole prompt); decode
is bandwidth-bound (skinny M = lanes GEMMs).  Each runner scopes its work
with ``search.serving_phase(...)``, so ``ops._tuned_kernel`` consults the
phase-qualified plan-DB entry first, and ``sweep`` searches and persists
those phase ladders (``serve --search-gemms``).  On the card every
prefill and decode GEMM (M = lanes in decode) runs the contraction kernel,
whatever its shape, on the tile plan its ladder names.  PyTorch runs
eagerly: there is nothing to trace.

With ``quant`` (weight-only ``--quant int8``) the runners take the
quantized tree, as the reference's jitted closures do, and the weights
are expanded for the call only: the embedding and final norm before it,
each stacked layer inside the model's layer loop, so at most one layer
is live at full precision beside the 8-bit tree.  The values are those
of ``dequantize_tree``.

With ``capture`` (``serve --capture``) each runner's model step is
``capture.optimize``d: on the card the prefill's single-block attention
runs B2 and the unembedding B1, beside the projections' own launches.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ... import obs
from ...configs.base import ModelConfig
from ...models.api import ModelAPI
from ...search import serving_phase
from . import paged


def _sweep(phase: str, shapes, *, with_grads: bool,
           device: torch.device, mesh_shape=None) -> int:
    """Search (``search.search_gemm_plans``) and persist the ``phase``
    ladders of (m, k, n) GEMMs in bf16, the dtype ``ops.dense`` derives
    the serving plan keys from (as the reference sweeps), measured on
    ``device``: the card's tile plans there, the plain version on the
    CPU; with ``mesh_shape`` also at the mesh tier."""
    from ...obs import log
    from ...search import default_plan_db, search_gemm_plans

    db = default_plan_db()
    n = search_gemm_plans(
        shapes, dtype=torch.bfloat16, plan_db=db, with_grads=with_grads,
        phase=phase, device=device.type, mesh_shape=mesh_shape,
    )
    log.info("serve", f"searched {n} {phase}-phase GEMM plan(s) -> "
             f"{db.path}")
    return n


#: the parameter trees' stacked layer groups besides the ``seg*`` segments
#: of the decoder-only LM: the SSM stack (ssm, hybrid) and the encoder and
#: decoder stacks (encdec)
STACKED = ("ssm_layers", "enc_layers", "dec_layers")


def _stacked(key: str) -> bool:
    return key.startswith("seg") or key in STACKED


def _deq_fn(quant: Optional[str]):
    """The parameter expansion of the weight-only tier: identity at full
    precision.  Under ``--quant`` the unstacked parts (the embedding,
    final norms, the hybrid's shared block, the VLM's projector) are
    expanded for the call (``optim.quant.dequantize_tree``); the stacked
    layers (``seg*``, ``ssm_layers``, ``enc_layers``, ``dec_layers``)
    stay quantized and the model expands them one layer at a time inside
    its layer loop (``models.transformer._unstack``)."""
    if not quant:
        return lambda p: p
    from ...optim.quant import dequantize_tree

    return lambda p: {k: v if _stacked(k) else dequantize_tree(v)
                      for k, v in p.items()}


def quantize_params(params, quant: str):
    """The weight-only tier at load: ``params`` quantized once
    (``optim.quant.quantize_tree``; a tree already quantized passes as it
    is), the ``serve.quant_bytes`` gauge set to what it holds."""
    from ...obs import log
    from ...optim.quant import quantize_tree, tree_quant_bytes

    params = quantize_tree(params, fmt=quant)
    qb = tree_quant_bytes(params)
    obs.gauge("serve.quant_bytes").set(qb)
    log.info("serve", f"weight-only {quant}: {qb / 2**20:.2f} MiB held as "
             f"quantized leaves")
    return params


def model_step(fn, capture: bool, label: str, quant: Optional[str]):
    """A serving engine's model step: ``fn`` itself, or under ``capture``
    (``serve --capture``) ``capture.optimize(fn)``, traced once per input
    signature and replayed with its eligible products on the kernels;
    ``quant`` sends its dispatched dense sites to the 8-bit tier, as the
    reference's fixed server does."""
    if not capture:
        return fn
    from ...capture import optimize

    return optimize(fn, label=label, quant=quant)


def prefill_lengths(lengths, width: int, capture: bool):
    """A prefill's ``lengths`` (host values, one a row), or None under
    ``capture`` where no row of the ``width``-wide prefill is padded: the
    mask would mask nothing, and without it the prefill takes the
    unmasked single-block attention that ``capture`` fuses into one
    ``ops.attention`` launch."""
    if capture and min(int(n) for n in lengths) >= width:
        return None
    return lengths


def capture_warmup(cfg, points, *, search_grads: bool, quant, device,
                   mesh_shape=None):
    """``serve --capture``'s warm-up, as the reference's: harvest each
    serving entry point on fake tensors (``points``: kind -> (batch,
    seq); no allocation), log each report's summary, and sweep the union
    of their dispatched specs into the ranked plan DB (with the derived
    backward specs when ``search_grads``, so a co-located training fleet
    finds them too; with ``quant``, each forward spec's quantized leg).
    The harvest runs on fake tensors of ``device`` (a ``torch.device``)
    with ``interpret=True``, as the reference's does: on the CPU the
    aligned sites are eligible, on the card every non-empty one; the
    sweep measures its candidates there, and with ``mesh_shape`` sweeps
    each point at the mesh tier too.  Returns the reports by kind and the
    sweep's points and seconds."""
    from ... import capture as _capture
    from ...obs import log
    from ...search import default_plan_db

    reports, specs = {}, {}
    for kind, (batch, seq) in points.items():
        _, rep = _capture.model_capture(
            cfg, batch=batch, seq=seq, kind=kind, interpret=True,
            device=device.type)
        log.info("serve", rep.summary())
        reports[kind] = rep
        for spec, dt in rep.unique_specs():
            specs.setdefault(_capture.spec_key(spec, dt),
                             (f"{kind}:{spec.name}", spec, dt))
    db = default_plan_db()
    t0 = time.perf_counter()
    n = _capture.sweep_captured(
        list(specs.values()), with_grads=search_grads, plan_db=db,
        interpret=device.type != "cuda", quant=quant, device=device.type,
        mesh_shape=mesh_shape)
    took = time.perf_counter() - t0
    log.info("serve", f"capture swept {n} plan point(s) ({len(specs)} "
             f"unique GEMM spec(s)) in {took:.1f} s -> {db.path}")
    return {"reports": reports, "points": n, "specs": len(specs),
            "sweep_s": took}


class PrefillRunner:
    """Batch-1 bucketed prefill: pads the context to a page multiple,
    masks the pads via ``lengths``, and copies the resulting cache pages
    into the physical pool."""

    phase = "prefill"

    def __init__(self, cfg: ModelConfig, api: ModelAPI, page_size: int,
                 device: torch.device, quant: Optional[str] = None,
                 capture: bool = False):
        self.cfg = cfg
        self.api = api
        self.page_size = page_size
        self.device = device
        self.deq = _deq_fn(quant)
        self.capture = capture
        self.step = model_step(
            lambda p, b, n: api.prefill(self.deq(p), cfg, b, n),
            capture, f"{cfg.arch_id}:prefill", quant)

    def sweep(self, shapes, *, with_grads: bool = True,
              mesh_shape=None) -> int:
        """Search the prefill ladders of (m, k, n) GEMMs (with their
        derived backward specs unless ``with_grads`` is off; at the mesh
        tier too with ``mesh_shape``)."""
        return _sweep(self.phase, shapes, with_grads=with_grads,
                      device=self.device, mesh_shape=mesh_shape)

    def __call__(self, params, pools: Dict, context: Sequence[int],
                 pages: Sequence[int]) -> Tuple[int, Dict]:
        """Prefill one request's context and store it into ``pages``.
        Returns (first generated token, the pools, updated in place)."""
        plen = len(context)
        padded = len(pages) * self.page_size
        if padded < plen:
            raise ValueError(f"{len(pages)} page(s) cannot hold {plen} tokens")
        toks = torch.zeros((1, padded), dtype=torch.long)
        toks[0, :plen] = torch.as_tensor(context, dtype=torch.long)
        toks = toks.to(self.device)
        batch = {"tokens": toks}
        if prefill_lengths([plen], padded, self.capture) is not None:
            batch["lengths"] = torch.full((1,), plen, dtype=torch.long,
                                          device=self.device)
        with serving_phase(self.phase):
            with obs.span("serve.prefill", tokens=plen, padded=padded):
                logits, caches = self.step(params, batch, padded)
                tok = int(torch.argmax(logits[0, -1]))
                pools = paged.store_prefill(
                    pools, caches,
                    torch.as_tensor(pages, dtype=torch.long,
                                    device=self.device),
                    self.page_size,
                )
        return tok, pools


class DecodeRunner:
    """One continuous-batching decode step over all lanes: gather the
    block-table pages into the dense cache view, run the model's
    ``decode_step``, write the appended KV row back to its page."""

    phase = "decode"

    def __init__(self, cfg: ModelConfig, api: ModelAPI, page_size: int,
                 lanes: int, max_pages: int, device: torch.device,
                 quant: Optional[str] = None, capture: bool = False):
        self.cfg = cfg
        self.api = api
        self.page_size = page_size
        self.lanes = lanes
        self.max_pages = max_pages
        self.device = device
        self.deq = _deq_fn(quant)
        self.step = model_step(
            lambda p, c, t: api.decode_step(self.deq(p), cfg, c, t),
            capture, f"{cfg.arch_id}:decode", quant)

    def sweep(self, shapes, *, with_grads: bool = False,
              mesh_shape=None) -> int:
        """Search the decode ladders: decode dispatches M = lanes
        activations whatever the fleet swept for training or prefill, so
        each (m, k, n) is laddered as (lanes, k, n)."""
        skinny = tuple((self.lanes, k, n) for (_, k, n) in shapes)
        return _sweep(self.phase, skinny, with_grads=with_grads,
                      device=self.device, mesh_shape=mesh_shape)

    def __call__(self, params, pools, block_table, lens, tokens):
        """Returns (next token per lane as a host int64 tensor, the pools,
        updated in place)."""
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.long
        ).to(self.device)
        bt, lens, toks = as_dev(block_table), as_dev(lens), as_dev(tokens)
        with serving_phase(self.phase):
            caches = paged.paged_view(pools, bt, lens, self.page_size)
            logits, new_caches = self.step(params, caches, toks[:, None])
            pools = paged.scatter_token(
                pools, new_caches, bt, lens, self.page_size
            )
            tok = torch.argmax(logits[:, -1], dim=-1)
        return tok.cpu(), pools
