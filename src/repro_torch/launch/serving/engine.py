"""Serving engines: continuous batching over paged KV, and fixed slots.

:class:`ContinuousEngine` is slot-free.  Each loop iteration:

1. moves arrived requests into the scheduler (fast-forwarding the clock
   when everything is idle, so a sparse trace doesn't busy-wait),
2. admits FCFS from the queue head into free decode lanes — each
   admission prefills its context batch-1 (phase ``prefill``) straight
   into freshly allocated pages and emits its first token,
3. grows every running request's block table for the position its next
   decode writes, preempting the newest admission when the pool is dry,
4. runs ONE decode step across all lanes (phase ``decode``) and emits one
   token per live request.

The stats dict is the reference's (``tok_per_s`` counts *decode* tokens
over decode seconds only — prefill-produced first tokens are accounted to
prefill).  Under greedy decoding the per-request tokens equal the
reference engine's on the same weights and trace
(``tests/test_torch_serving.py``).

The engine runs on ``device`` ("cuda" by default, and it raises when no
card is visible); the whole run is under ``torch.inference_mode()``, with
TF32 and reduced-precision bf16 reductions off, since the reference
accumulates every product in f32.  ``quant="int8"`` is the weight-only
tier (``serve --quant int8``): the parameter tree is quantized once at load
(``optim.quant.quantize_tree``, block-wise int8 + f32 scales, the
reference's bits), the ``serve.quant_bytes`` gauge records what it holds,
and every prefill and decode step expands it one layer at a time
(``runners``).  ``search_gemms`` ((m, k, n) shapes, ``serve
--search-gemms``) has each runner search and persist its phase's ladders
before the first request (the prefill runner with the derived backward
specs when ``search_grads``); a restart finds them in the plan DB.
``capture`` (``serve --capture``) harvests both steps on fake tensors,
sweeps their specs (at the mesh tier too with ``mesh_shape``) and runs
the runners through captured steps (``capture.optimize``).  ``mesh_shape`` (``serve --mesh``) has each
runner sweep its phase's ladders at the mesh tier too, and where the world
holds the mesh's ranks (``launch.mesh.world_mesh``, over
``mesh_transport``) the engine runs under the mesh, so a GEMM with a
mesh-qualified plan (``ops._mesh_plan_kernel``) runs as a mesh-bound
kernel; every rank then runs the same engine on the same trace.

:class:`FixedEngine` is the fixed-slot ``launch.serve.BatchServer``
behind the same ``run()``: requests chunked FCFS into groups of ``lanes``,
each prefilled together and decoded until its last member finishes (every
group rounds up to its longest request).  It is the only engine of the
families whose state cannot be paged (ssm, hybrid, encdec, vlm), and
the continuous engine's differential baseline: under greedy decoding both
give the same tokens per request.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ... import obs
from ...configs.base import ModelConfig
from ...device import resolve_device
from ...models.api import get_api
from . import paged
from .runners import (DecodeRunner, PrefillRunner, capture_warmup,
                      quantize_params)
from .scheduler import Scheduler, ServeRequest
from ..mesh import world_mesh, set_mesh


def _mesh_of(mesh_shape, transport: str, device):
    """The engine's serving mesh (``launch.mesh.world_mesh``) or None."""
    if not mesh_shape:
        return None
    from ...search import parse_mesh_shape

    if isinstance(mesh_shape, str):
        mesh_shape = parse_mesh_shape(mesh_shape)
    return world_mesh(mesh_shape, transport=transport, device=device.type)


class ContinuousEngine:
    """Continuous-batching serving engine over a paged KV pool."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        lanes: int = 4,
        page_size: int = 16,
        n_pages: int = 64,
        max_ctx: Optional[int] = None,
        watermark: Optional[int] = None,
        params=None,
        device="cuda",
        quant: Optional[str] = None,
        search_gemms=(),
        search_grads: bool = False,
        capture: bool = False,
        mesh_shape=None,
        mesh_transport: str = "device",
    ):
        self.device = resolve_device(device)
        self.mesh = _mesh_of(mesh_shape, mesh_transport,
                             self.device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
                False
            )
        self.cfg = cfg
        self.api = get_api(cfg)
        self.lanes = lanes
        self.page_size = page_size
        if max_ctx is None:
            # default per-request ceiling: an even share of the pool
            max_ctx = page_size * max(1, (n_pages - 1) // max(1, lanes))
        self.max_pages = -(-max_ctx // page_size)
        self.max_ctx = self.max_pages * page_size
        self.pool = paged.PagePool(n_pages, page_size)
        self.sched = Scheduler(
            self.pool, lanes,
            watermark=lanes if watermark is None else watermark,
        )
        with torch.inference_mode():
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(0)
                params = self.api.init(cfg, gen, self.device)
            # --quant int8: the weight-only tier, quantized once here and
            # expanded layer by layer inside each model call
            self.quant = quant
            if quant:
                params = quantize_params(params, quant)
            self.params = params
            self.pools = paged.pool_init(cfg, n_pages, page_size,
                                         device=self.device)
        # whole-model capture (serve --capture): harvest both steps on fake
        # tensors (prefill batch-1, decode at the lanes), sweep their specs,
        # and run both runners through captured steps
        self.capture_stats = None
        if capture:
            # on this mesh's ranks and transport, as the runners' sweeps
            with set_mesh(self.mesh):
                self.capture_stats = capture_warmup(
                    cfg, {"prefill": (1, self.max_ctx),
                          "decode": (lanes, self.max_ctx)},
                    search_grads=search_grads, quant=quant,
                    device=self.device, mesh_shape=mesh_shape)
        self.prefill = PrefillRunner(cfg, self.api, page_size, self.device,
                                     quant=quant, capture=capture)
        self.decode = DecodeRunner(cfg, self.api, page_size, lanes,
                                   self.max_pages, self.device, quant=quant,
                                   capture=capture)
        if search_gemms:
            # each runner ladders the shapes it runs, under its phase key
            with set_mesh(self.mesh):
                self.prefill.sweep(search_gemms, with_grads=search_grads,
                                   mesh_shape=mesh_shape)
                self.decode.sweep(search_gemms, mesh_shape=mesh_shape)
        # pre-register so a metrics dump always carries the cache counters
        for name in ("plandb.hit", "plandb.miss",
                     "autotune.hit", "autotune.miss"):
            obs.counter(name).inc(0)

    def run(
        self, requests: List[ServeRequest], *, eos_id: Optional[int] = None
    ) -> Dict:
        with torch.inference_mode(), set_mesh(self.mesh):
            return self._run(requests, eos_id)

    def _sync(self) -> None:
        # host clocks below time device work: wait for it to finish
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, requests: List[ServeRequest],
             eos_id: Optional[int]) -> Dict:
        latency = obs.histogram("serve.request_latency_s")
        ttft = obs.histogram("serve.ttft_s")
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        )
        t0 = time.perf_counter()
        st = dict(prefill_s=0.0, decode_s=0.0, decode_steps=0,
                  prefill_tokens=0, decode_tokens=0, preemptions=0,
                  prefills=0)

        def finish(req: ServeRequest) -> None:
            req.t_done = time.perf_counter()
            if req.state == "running":
                self.sched.finish(req)       # pages freed this very step
            else:
                req.state = "finished"
            latency.observe(req.t_done - req.t_submit)
            obs.counter("serve.requests").inc()
            obs.complete_event(
                "serve.request", req.t_submit, req.t_done - req.t_submit,
                rid=req.rid, tenant=req.tenant, prompt_len=len(req.prompt),
                new_tokens=len(req.out_tokens), preemptions=req.preemptions,
            )

        def emit(req: ServeRequest, tok: int, *, from_prefill: bool) -> None:
            req.out_tokens.append(tok)
            if req.t_first is None:
                req.t_first = time.perf_counter()
                ttft.observe(req.t_first - req.t_submit)
            st["prefill_tokens" if from_prefill else "decode_tokens"] += 1
            obs.counter("serve.tokens").inc()
            if (len(req.out_tokens) >= req.max_new
                    or (eos_id is not None and tok == eos_id)):
                finish(req)

        def submit_next() -> None:
            req = pending.popleft()
            req.t_submit = time.perf_counter()
            if req.max_new <= 0:
                # nothing to generate: complete at admission, but the
                # request still counts and its latency is still observed
                finish(req)
                return
            self.sched.submit(req)

        with obs.span("serve.engine", engine="continuous",
                      requests=len(requests)):
            while pending or self.sched.queue or self.sched.running:
                now = time.perf_counter() - t0
                while pending and pending[0].arrival_s <= now:
                    submit_next()
                if pending and not self.sched.queue and not self.sched.running:
                    submit_next()   # idle: fast-forward to the next arrival

                for req in self.sched.admit():
                    tp = time.perf_counter()
                    tok, self.pools = self.prefill(
                        self.params, self.pools, req.context_tokens,
                        req.pages,
                    )
                    self._sync()
                    st["prefill_s"] += time.perf_counter() - tp
                    st["prefills"] += 1
                    emit(req, tok, from_prefill=True)

                if not self.sched.running:
                    continue
                pre = self.sched.grow()
                st["preemptions"] += len(pre)
                for _ in pre:
                    obs.counter("serve.preempted").inc()
                if not self.sched.running:
                    continue

                bt = np.zeros((self.lanes, self.max_pages), np.int64)
                lens = np.zeros((self.lanes,), np.int64)
                toks = np.zeros((self.lanes,), np.int64)
                for lane, req in self.sched.running.items():
                    bt[lane, :len(req.pages)] = req.pages
                    # the last emitted token's KV is not cached yet — the
                    # step about to run writes it at position ctx_len - 1
                    lens[lane] = req.ctx_len - 1
                    toks[lane] = req.out_tokens[-1]
                td = time.perf_counter()
                with obs.span("serve.decode.step", step=st["decode_steps"],
                              live=len(self.sched.running)):
                    next_tok, self.pools = self.decode(
                        self.params, self.pools, bt, lens, toks
                    )
                st["decode_s"] += time.perf_counter() - td
                st["decode_steps"] += 1
                for lane, req in list(self.sched.running.items()):
                    emit(req, int(next_tok[lane]), from_prefill=False)

        st["tokens"] = st["prefill_tokens"] + st["decode_tokens"]
        st["tok_per_s"] = st["decode_tokens"] / max(st["decode_s"], 1e-9)
        st["requests"] = len(requests)
        obs.gauge("serve.tok_per_s").set(st["tok_per_s"])
        return st


class FixedEngine:
    """The fixed-slot ``BatchServer`` behind the continuous engine's
    ``run()`` interface.

    ``server_kw`` goes to ``BatchServer`` (``device``, ``quant``,
    ``extra_batch``, ``warm_gemms``, ``search_gemms``, ``search_grads``);
    ``params`` shares an existing parameter tree, as in the reference,
    and is handed to the server, so a tree already on the card is not
    drawn a second time."""

    def __init__(self, cfg: ModelConfig, *, lanes: int = 4,
                 max_ctx: int = 128, params=None, **server_kw):
        from ..serve import BatchServer

        self.lanes = lanes
        self.server = BatchServer(cfg, batch_size=lanes, max_len=max_ctx,
                                  params=params, **server_kw)
        self.cfg = cfg
        self.device = self.server.device

    @property
    def params(self):
        return self.server.params

    def run(
        self, requests: List[ServeRequest], *, eos_id: Optional[int] = None
    ) -> Dict:
        from ..serve import Request

        ordered = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        st = dict(prefill_s=0.0, decode_s=0.0, decode_steps=0,
                  prefill_tokens=0, decode_tokens=0, preemptions=0,
                  prefills=0)
        with obs.span("serve.engine", engine="fixed",
                      requests=len(requests)):
            for i in range(0, len(ordered), self.lanes):
                group = ordered[i:i + self.lanes]
                batch = [
                    Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                    for r in group
                ]
                t_sub = time.perf_counter()
                for r in group:
                    r.t_submit = t_sub
                s = self.server.run(batch, eos_id=eos_id)
                done = time.perf_counter()
                for r, b in zip(group, batch):
                    r.out_tokens = list(b.out_tokens)
                    r.state = "finished"
                    r.t_done = done
                st["prefill_s"] += s["prefill_s"]
                st["decode_s"] += s["decode_s"]
                st["decode_steps"] += s["decode_steps"]
                st["decode_tokens"] += s["decode_tokens"]
                st["prefill_tokens"] += s["tokens"] - s["decode_tokens"]
                st["prefills"] += 1
        st["tokens"] = st["prefill_tokens"] + st["decode_tokens"]
        st["tok_per_s"] = st["decode_tokens"] / max(st["decode_s"], 1e-9)
        st["requests"] = len(requests)
        return st
