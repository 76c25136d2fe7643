"""The port's serving tier against the reference.

* ``PagePool`` and ``Scheduler`` invariants — the reference's own cases
  (``tests/test_serving.py``), run against the port's classes;
* ``paged_view`` / ``scatter_token`` / ``store_prefill`` addressing equal
  to the reference's on the same numpy pools;
* the port's ``ContinuousEngine(device="cpu")`` and the reference's
  ``ContinuousEngine``, on the same converted weights and the same
  ``synthetic_trace``, give identical greedy tokens per request, with
  128-token prefills.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serving import ContinuousEngine as RefEngine
from repro.launch.serving import paged as ref_paged
from repro.launch.serving import synthetic_trace as ref_trace
from repro_torch import obs
from repro_torch.launch.serving import (
    ContinuousEngine,
    Gateway,
    PagePool,
    Scheduler,
    ServeRequest,
    synthetic_trace,
)
from repro_torch.launch.serving import paged
from repro_torch.models import transformer as PT

from test_torch_model import reference_params, small_configs


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    obs.metrics_reset()
    yield
    obs.metrics_reset()


# --------------------------------------------------------------------------
# page pool + scheduler (the reference's cases, against the port)
# --------------------------------------------------------------------------


class TestPagePool:
    def test_alloc_free_roundtrip(self):
        pool = PagePool(8, page_size=4)
        assert pool.capacity == 7
        got = pool.alloc(3)
        assert len(got) == 3 and paged.SINK_PAGE not in got
        assert pool.free_count == 4
        assert pool.alloc(5) is None and pool.free_count == 4
        pool.free(got)
        assert pool.free_count == 7

    def test_double_free_rejected(self):
        pool = PagePool(4, page_size=2)
        got = pool.alloc(1)
        pool.free(got)
        with pytest.raises(ValueError, match="double free"):
            pool.free(got)

    def test_sink_page_never_allocated(self):
        pool = PagePool(4, page_size=2)
        assert paged.SINK_PAGE not in pool.alloc(3)

    def test_pages_for(self):
        pool = PagePool(4, page_size=4)
        assert pool.pages_for(0) == 1
        assert pool.pages_for(4) == 1
        assert pool.pages_for(5) == 2


def _sreq(rid, plen, max_new):
    return ServeRequest(
        rid=rid, prompt=np.zeros(plen, np.int32), max_new=max_new
    )


class TestScheduler:
    def test_fcfs_admission_respects_watermark(self):
        sched = Scheduler(PagePool(10, 2), lanes=4, watermark=4)
        for i in range(3):
            sched.submit(_sreq(i, plen=4, max_new=2))
        admitted = sched.admit()
        assert [r.rid for r in admitted] == [0, 1]
        assert [r.rid for r in sched.queue] == [2]

    def test_progress_guarantee_overrides_watermark_when_idle(self):
        sched = Scheduler(PagePool(4, 2), lanes=1, watermark=100)
        sched.submit(_sreq(0, plen=4, max_new=1))
        assert [r.rid for r in sched.admit()] == [0]

    def test_grow_preempts_newest_and_requeues_at_head(self):
        pool = PagePool(4, 2)
        sched = Scheduler(pool, lanes=2, watermark=0)
        sched.submit(_sreq(0, plen=2, max_new=4))
        sched.submit(_sreq(1, plen=2, max_new=4))
        old, new = sched.admit()
        for r in (old, new):
            r.out_tokens = [1, 2]
        preempted = sched.grow()
        assert preempted == [new]
        assert new.state == "queued" and new.pages == [] and new.lane == -1
        assert new.preemptions == 1
        assert sched.queue[0] is new
        assert len(old.pages) == 2

    def test_finish_releases_lane_and_pages_immediately(self):
        pool = PagePool(4, 2)
        sched = Scheduler(pool, lanes=1, watermark=0)
        sched.submit(_sreq(0, plen=2, max_new=1))
        (req,) = sched.admit()
        before = pool.free_count
        sched.finish(req)
        assert pool.free_count == before + 1
        assert req.state == "finished" and not sched.running

    def test_oversized_request_rejected_at_submit(self):
        sched = Scheduler(PagePool(3, 2), lanes=1)
        with pytest.raises(ValueError, match="pages"):
            sched.submit(_sreq(0, plen=8, max_new=8))


# --------------------------------------------------------------------------
# paged addressing, against the reference on the same numpy pools
# --------------------------------------------------------------------------


def _numpy_pools(ref_cfg, n_pages, page_size, seed):
    rng = np.random.default_rng(seed)
    pools = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        ref_paged.pool_init(ref_cfg, n_pages, page_size),
    )
    return pools


def _to_port(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_trees_equal(port_tree, ref_tree):
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    for path, r in flat_ref:
        node = port_tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(r),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def cfgs():
    return small_configs()


def test_paged_view_and_scatter_match_reference(cfgs):
    ref_cfg, _ = cfgs
    ps = 4
    pools = _numpy_pools(ref_cfg, n_pages=7, page_size=ps, seed=0)
    bt = np.array([[3, 1, 5], [2, 0, 0], [0, 0, 0]], np.int64)
    lens = np.array([9, 4, 0], np.int64)

    r_view = ref_paged.paged_view(jax.tree.map(jnp.asarray, pools),
                                  jnp.asarray(bt, jnp.int32),
                                  jnp.asarray(lens, jnp.int32), ps)
    p_pools = _to_port(pools)
    p_view = paged.paged_view(p_pools, torch.from_numpy(bt),
                              torch.from_numpy(lens), ps)
    _assert_trees_equal(p_view, r_view)

    # a decode step's appended rows, then the write-back
    rng = np.random.default_rng(1)
    marked = jax.tree.map(np.asarray, r_view)
    for kinds in marked.values():
        for c in kinds.values():
            for leaf in ("k", "v"):
                c[leaf] = c[leaf].copy()
                c[leaf][:, np.arange(3), lens] = rng.standard_normal(
                    c[leaf][:, np.arange(3), lens].shape
                ).astype(np.float32)
    r_out = ref_paged.scatter_token(
        jax.tree.map(jnp.asarray, pools), jax.tree.map(jnp.asarray, marked),
        jnp.asarray(bt, jnp.int32), jnp.asarray(lens, jnp.int32), ps,
    )
    p_out = paged.scatter_token(p_pools, _to_port(marked),
                                torch.from_numpy(bt),
                                torch.from_numpy(lens), ps)
    assert p_out is p_pools  # written in place
    # the sink page (0) takes the idle lane's garbage: compare live pages
    for seg in p_out:
        for kind in p_out[seg]:
            for leaf in ("k", "v"):
                np.testing.assert_array_equal(
                    p_out[seg][kind][leaf][:, 1:].numpy(),
                    np.asarray(r_out[seg][kind][leaf])[:, 1:],
                )


def test_store_prefill_matches_reference(cfgs):
    ref_cfg, _ = cfgs
    ps = 4
    pools = _numpy_pools(ref_cfg, n_pages=6, page_size=ps, seed=2)
    rng = np.random.default_rng(3)
    L, kv, hd = ref_cfg.n_layers, ref_cfg.n_kv_heads, ref_cfg.hd
    caches = {"seg0": {"dense": {
        leaf: rng.standard_normal((L, 1, 3 * ps, kv, hd)).astype(np.float32)
        for leaf in ("k", "v")
    }}}
    page_ids = np.array([4, 2, 5], np.int64)
    r_out = ref_paged.store_prefill(
        jax.tree.map(jnp.asarray, pools), jax.tree.map(jnp.asarray, caches),
        jnp.asarray(page_ids, jnp.int32), ps,
    )
    p_out = paged.store_prefill(_to_port(pools), _to_port(caches),
                                torch.from_numpy(page_ids), ps)
    _assert_trees_equal(p_out, r_out)


# --------------------------------------------------------------------------
# engine differential: port == reference, greedy tokens per request
# --------------------------------------------------------------------------


def _traces(vocab):
    kw = dict(vocab=vocab, seed=11, rate_hz=0.0, prompt_lens=(40, 100, 128),
              max_news=(3, 6))
    return ref_trace(4, **kw), synthetic_trace(4, **kw)


def test_engine_tokens_match_reference(cfgs):
    ref_cfg, port_cfg = cfgs
    ref_params, np_params = reference_params(ref_cfg, seed=1)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    r_trace, p_trace = _traces(ref_cfg.vocab)
    for a, b in zip(r_trace, p_trace):
        assert np.array_equal(a.prompt, b.prompt) and a.max_new == b.max_new

    kw = dict(lanes=2, page_size=128, n_pages=5, max_ctx=256)
    RefEngine(ref_cfg, params=ref_params, **kw).run(r_trace)
    eng = ContinuousEngine(port_cfg, params=port_params, device="cpu", **kw)
    stats = Gateway(eng).run(p_trace)

    assert stats["prefills"] >= len(p_trace)  # each padded to 128 tokens
    for a, b in zip(r_trace, p_trace):
        assert len(b.out_tokens) == b.max_new
        assert b.out_tokens == a.out_tokens, (
            f"request {b.rid}: port {b.out_tokens} != reference "
            f"{a.out_tokens}"
        )
    assert stats["tokens"] == sum(r.max_new for r in p_trace)
    assert stats["prefill_tokens"] == len(p_trace)
    assert eng.pool.free_count == eng.pool.capacity
    j = obs.metrics_json()
    assert j["counters"]["serve.requests"] == len(p_trace)
    assert j["histograms"]["serve.request_latency_s"]["count"] == len(p_trace)


def test_preemption_recompute_is_deterministic(cfgs):
    _, port_cfg = cfgs
    cfg = port_cfg.smoke()

    def mk():
        rng = np.random.default_rng(7)
        return [
            ServeRequest(rid=i, prompt=rng.integers(0, cfg.vocab, size=4)
                         .astype(np.int32), max_new=8)
            for i in range(3)
        ]

    params = PT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    starved, roomy = mk(), mk()
    st = ContinuousEngine(cfg, lanes=3, page_size=2, n_pages=10, max_ctx=12,
                          watermark=0, params=params, device="cpu").run(starved)
    assert st["preemptions"] > 0, "pool was sized to force preemption"
    ContinuousEngine(cfg, lanes=3, page_size=2, n_pages=40, max_ctx=12,
                     params=params, device="cpu").run(roomy)
    for a, b in zip(starved, roomy):
        assert a.out_tokens == b.out_tokens


def test_max_new_zero_and_eos(cfgs):
    _, port_cfg = cfgs
    cfg = port_cfg.smoke()
    params = PT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    eng = ContinuousEngine(cfg, lanes=2, page_size=4, n_pages=9, max_ctx=16,
                           params=params, device="cpu")
    reqs = [
        ServeRequest(rid=0, prompt=rng.integers(0, cfg.vocab, size=3)
                     .astype(np.int32), max_new=0),
        ServeRequest(rid=1, prompt=rng.integers(0, cfg.vocab, size=3)
                     .astype(np.int32), max_new=6),
    ]
    eng.run(reqs)
    assert reqs[0].state == "finished" and reqs[0].out_tokens == []
    free_run = list(reqs[1].out_tokens)
    assert len(free_run) == 6
    assert eng.pool.free_count == eng.pool.capacity

    eos = free_run[2]
    again = ServeRequest(rid=2, prompt=reqs[1].prompt, max_new=6)
    stats = eng.run([again], eos_id=eos)
    assert again.out_tokens == free_run[: free_run.index(eos) + 1]
    assert stats["tokens"] == len(again.out_tokens)


def test_synthetic_trace_matches_reference():
    a = ref_trace(8, vocab=50, seed=9, rate_hz=100.0)
    b = synthetic_trace(8, vocab=50, seed=9, rate_hz=100.0)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.arrival_s, x.tenant) == (
            y.max_new, y.arrival_s, y.tenant
        )
