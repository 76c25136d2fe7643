"""Continuous-batching scheduler: FCFS admission, immediate reclaim,
recompute-style preemption.

Policy, in order of application every engine step:

* **finish** — a request that hit max_new/EOS frees its pages the same
  step (the engine calls :meth:`Scheduler.finish` as it emits), so the
  next admission sees the memory immediately.
* **grow** — every running request must own a page for the position its
  next decode writes.  When the pool is dry, the *newest* admitted
  request is preempted: pages freed, generated tokens folded into its
  recompute prefix, requeued at the queue head (FCFS order preserved).
  Under greedy decoding recompute is exact — re-prefilling
  ``prompt + generated`` yields the same continuation it would have
  produced uninterrupted.
* **admit** — FCFS from the queue head into free decode lanes, while the
  pool keeps ``watermark`` pages spare *after* the admission (headroom so
  the requests just admitted can grow a few steps without immediately
  preempting each other).  Head-of-line blocking is deliberate: skipping
  a big request to admit small ones behind it would starve it forever.

The scheduler is pure host-side bookkeeping — it never touches a tensor.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np

from .paged import PagePool


@dataclasses.dataclass
class ServeRequest:
    """One generation request flowing through the serving tier."""

    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32, immutable
    max_new: int
    arrival_s: float = 0.0             # offset into the trace
    tenant: str = "tenant0"
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"              # queued | running | finished
    lane: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    # perf_counter stamps the engine fills in (None until they happen)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    _admit_seq: int = -1               # admission order, for preempt-newest

    @property
    def ctx_len(self) -> int:
        """Logical context length: prompt plus everything generated."""
        return len(self.prompt) + len(self.out_tokens)

    @property
    def context_tokens(self) -> np.ndarray:
        """The recompute prefix: prompt + generated-so-far.  Prefilling
        this after a preemption reproduces the uninterrupted state."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)]
        )


class Scheduler:
    """FCFS continuous-batching policy over a :class:`PagePool`."""

    def __init__(self, pool: PagePool, lanes: int, watermark: int = 0):
        if lanes < 1:
            raise ValueError("need >= 1 decode lane")
        self.pool = pool
        self.lanes = lanes
        self.watermark = watermark
        self.queue: Deque[ServeRequest] = collections.deque()
        self.running: Dict[int, ServeRequest] = {}   # lane -> request
        self._admit_counter = 0

    # -- queue -------------------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        need = self.pool.pages_for(len(req.prompt) + req.max_new)
        if need > self.pool.capacity:
            raise ValueError(
                f"request {req.rid} needs {need} pages at full length but "
                f"the pool only has {self.pool.capacity}"
            )
        req.state = "queued"
        self.queue.append(req)

    def _free_lane(self) -> Optional[int]:
        for lane in range(self.lanes):
            if lane not in self.running:
                return lane
        return None

    # -- admission ---------------------------------------------------------

    def admit(self) -> List[ServeRequest]:
        """Admit FCFS from the queue head; returns the newly running
        requests (the engine prefills them).  Pages for the full current
        context (recompute prefix included) are allocated here."""
        admitted: List[ServeRequest] = []
        while self.queue:
            req = self.queue[0]
            lane = self._free_lane()
            if lane is None:
                break
            need = self.pool.pages_for(req.ctx_len)
            below_mark = self.pool.free_count - need < self.watermark
            # progress guarantee: with nothing running the watermark is
            # moot — admit the head as long as the pages physically fit
            if below_mark and (self.running or admitted):
                break
            if below_mark and self.pool.free_count < need:
                raise RuntimeError(
                    f"request {req.rid} needs {need} pages, pool has "
                    f"{self.pool.free_count} free and nothing left to evict"
                )
            pages = self.pool.alloc(need)
            assert pages is not None
            self.queue.popleft()
            req.pages = pages
            req.lane = lane
            req.state = "running"
            req._admit_seq = self._admit_counter
            self._admit_counter += 1
            self.running[lane] = req
            admitted.append(req)
        return admitted

    # -- growth / preemption ----------------------------------------------

    def grow(self) -> List[ServeRequest]:
        """Give every running request the pages its context now needs,
        preempting the newest admissions when the pool runs dry.  Returns
        the preempted requests (already requeued)."""
        preempted: List[ServeRequest] = []
        # oldest admissions grow first, so eviction pressure lands on the
        # newest — the one with the least sunk prefill work
        for req in sorted(self.running.values(), key=lambda r: r._admit_seq):
            if req.lane not in self.running:    # preempted earlier this pass
                continue
            while len(req.pages) < self.pool.pages_for(req.ctx_len):
                got = self.pool.alloc(1)
                if got is not None:
                    req.pages.extend(got)
                    continue
                victim = max(
                    self.running.values(), key=lambda r: r._admit_seq
                )
                self.preempt(victim)
                preempted.append(victim)
                if victim is req:
                    break
        return preempted

    def preempt(self, req: ServeRequest) -> None:
        """Recompute-style eviction: drop the pages, requeue at the head.

        The generated tokens stay on the request (``context_tokens`` folds
        them into the next prefill), so no work is lost beyond the
        recompute itself."""
        self.pool.free(req.pages)
        req.pages = []
        del self.running[req.lane]
        req.lane = -1
        req.preemptions += 1
        req.state = "queued"
        self.queue.appendleft(req)

    # -- completion --------------------------------------------------------

    def finish(self, req: ServeRequest) -> None:
        """Release the request's lane and pages immediately."""
        self.pool.free(req.pages)
        req.pages = []
        del self.running[req.lane]
        req.lane = -1
        req.state = "finished"
