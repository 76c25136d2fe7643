"""Block-table paged KV cache — the storage layer of the serving tier.

KV memory is one physical pool per attention-cache leaf, carved into
fixed-size pages:

    pool["segN"][kind]["k"] : (layers, n_pages, page_size, kv_heads, hd)

A request owns an ordered list of page ids (its *block table*); logical
cache position ``p`` lives at page ``pages[p // page_size]``, offset
``p % page_size``.  Allocation and release are O(pages) free-list moves on
the host (:class:`PagePool`).

Before each decode step the lanes' pages are gathered into the dense
stacked-cache tree ``models.api`` consumes (:func:`paged_view`), and the
single KV row the step appends is written back to its physical page
(:func:`scatter_token`).  Unlike the reference, which rebuilds the pools
functionally, :func:`scatter_token` and :func:`store_prefill` write the
pools IN PLACE: at full width the pools are hundreds of MB.

Physical page 0 is reserved as the *sink*: idle decode lanes point their
block tables at it, and the garbage KV their dispatches produce lands there
instead of in live pages.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...configs.base import ModelConfig
from ...models import transformer

#: block-table entry for slots past a request's last page (and for every
#: slot of an idle lane) — all of them alias the sink page
SINK_PAGE = 0


class PagePool:
    """Host-side free-list over physical page ids (page 0 = sink)."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the sink)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO so recently-freed (cache-warm) pages are reused first
        self._free = list(range(n_pages - 1, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        """Usable pages (the sink is never allocatable)."""
        return self.n_pages - 1

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache positions (>= 1)."""
        return max(1, -(-n_tokens // self.page_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages, or None (and no change) if the pool is short."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"bad page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


def pool_init(cfg: ModelConfig, n_pages: int, page_size: int,
              device="cpu") -> Dict:
    """Physical KV pools mirroring ``transformer.cache_init``'s structure
    (one {"k", "v"} leaf pair per segment x layer-kind, layers stacked)."""
    kv, hd, dt = cfg.n_kv_heads, cfg.hd, cfg.param_dtype
    shape = lambda count: (count, n_pages, page_size, kv, hd)  # noqa: E731
    pools: Dict = {}
    for si, (pattern, count) in enumerate(transformer.segment_plan(cfg)):
        pools[f"seg{si}"] = {
            kind: {
                "k": torch.zeros(shape(count), dtype=dt, device=device),
                "v": torch.zeros(shape(count), dtype=dt, device=device),
            }
            for kind in pattern
        }
    return pools


def paged_view(pools: Dict, block_table: torch.Tensor, lens: torch.Tensor,
               page_size: int) -> Dict:
    """Gather each lane's pages into the dense stacked-cache tree.

    block_table (lanes, max_pages) and lens (lanes,) are int64 tensors on
    the pools' device; lens = number of KV rows present per lane.  The
    view is a copy; its tail positions (>= lens) hold whatever the sink or
    unwritten pages contain, and ``decode_attention`` masks them.
    """
    lanes, max_pages = block_table.shape

    def view(p):
        g = p[:, block_table]  # (L, lanes, max_pages, page, kv, hd)
        return g.reshape(
            p.shape[0], lanes, max_pages * page_size, p.shape[3], p.shape[4]
        )

    caches: Dict = {}
    for seg, kinds in pools.items():
        caches[seg] = {}
        for kind, pv in kinds.items():
            n_layers = pv["k"].shape[0]
            caches[seg][kind] = {
                "k": view(pv["k"]),
                "v": view(pv["v"]),
                "len": lens[None, :].expand(n_layers, lanes).clone(),
            }
    return caches


def scatter_token(pools: Dict, new_caches: Dict, block_table: torch.Tensor,
                  lens: torch.Tensor, page_size: int) -> Dict:
    """Write the KV row each lane's decode step appended back to its page,
    in place; returns ``pools``.

    The step wrote at view position ``lens`` (the pre-step cache length),
    which physically lives at page ``block_table[lane, lens // page_size]``
    offset ``lens % page_size``.  Idle lanes (lens=0, all-sink tables)
    scatter their garbage onto the sink page; nothing reads the sink.
    """
    lane = torch.arange(block_table.shape[0], device=block_table.device)
    page_of = block_table[lane, lens // page_size]  # (lanes,)
    off = lens % page_size
    for seg, kinds in pools.items():
        for kind, pv in kinds.items():
            nc = new_caches[seg][kind]
            for leaf in ("k", "v"):
                # (L, lanes, ctx, kv, hd) -> row at lens: (L, lanes, kv, hd)
                pv[leaf][:, page_of, off] = nc[leaf][:, lane, lens]
    return pools


def store_prefill(pools: Dict, caches: Dict, page_ids: torch.Tensor,
                  page_size: int) -> Dict:
    """Copy a batch-1 prefill cache into physical pages, in place.

    ``caches`` is the dense cache a ``max_len = len(page_ids) * page_size``
    prefill produced; page ``j`` of it (positions ``[j*ps, (j+1)*ps)``)
    lands on physical page ``page_ids[j]``.  Positions past the prompt's
    true length hold pad KV — harmless, because a position is only ever
    attended once ``cache_len`` exceeds it, and decode overwrites it with
    the real token's KV before that happens.
    """
    n = page_ids.shape[0]
    for seg, kinds in pools.items():
        for kind, pv in kinds.items():
            c = caches[seg][kind]
            for leaf in ("k", "v"):
                src = c[leaf][:, 0, : n * page_size]  # (L, n*ps, kv, hd)
                pv[leaf][:, page_ids] = src.reshape(
                    src.shape[0], n, page_size, *src.shape[2:]
                )
    return pools
