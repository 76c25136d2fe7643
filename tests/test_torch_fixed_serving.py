"""The port's fixed-slot server (``BatchServer``, ``FixedEngine``, ``serve
--engine fixed``) against the reference.

* the port's ``FixedEngine(device="cpu")`` and the reference's
  ``FixedEngine``, on the same weights and the same ``synthetic_trace``,
  give identical greedy tokens per request: dense (mixed prompt lengths),
  ssm, hybrid, encdec (seeded ``frames`` in ``extra_batch``) and vlm
  (seeded ``patches``), and under ``quant="int8"`` for dense and hybrid;
* the reference's ``tests/test_serving.py`` contracts, run on the port:
  continuous equals fixed equals solo, batched mixed lengths equal solo,
  ``max_new=0``, EOS, and throughput counting decode tokens only;
* the CLI: ``--engine fixed``, the switch to fixed for a family whose
  state cannot be paged, the named ``ValueError`` of encdec and vlm, and
  the refusal of ``--mesh`` (``--capture`` serves:
  ``tests/test_torch_capture_launch.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch.serving import FixedEngine as RefFixed
from repro.launch.serving import synthetic_trace as ref_trace
from repro.models import api as RA
from repro.optim import quant as RQ
from repro_torch import configs as PC
from repro_torch import obs
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.launch.serving import (
    ContinuousEngine,
    FixedEngine,
    Gateway,
    ServeRequest,
    synthetic_trace,
)
from repro_torch.models import api as PA
from repro_torch.models import transformer as PT
from repro_torch.optim.quant import Quantized, tree_quant_bytes


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    obs.metrics_reset()
    yield
    obs.metrics_reset()


# --------------------------------------------------------------------------
# port == reference, greedy tokens per request
# --------------------------------------------------------------------------

#: arch -> (prompt lengths, max_news) of the differential trace; the ssm
#: and hybrid groups are left-padded to their longest prompt, as in the
#: reference
CASES = {
    "qwen3-8b": ((3, 5, 9), (2, 5)),
    "mamba2-130m": ((4, 6, 9), (2, 5)),
    "zamba2-2.7b": ((4, 6, 9), (2, 5)),
    "whisper-base": ((3, 5, 9), (2, 5)),
    "internvl2-1b": ((3, 5, 9), (2, 5)),
}
LANES, N_REQ, S_ENC = 2, 5, 12


def _extra(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (LANES, S_ENC, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (LANES, RA.N_PATCHES, 1024)).astype(np.float32)}
    return {}


def _max_ctx(cfg, prompt_lens, max_news):
    return (max(prompt_lens) + max(max_news) + 1
            + (RA.N_PATCHES if cfg.family == "vlm" else 0))


def _differential(arch, quant=None, seed=1):
    ref_cfg = RC.get_config(arch).smoke()
    port_cfg = PC.get_config(arch).smoke()
    ref_params, _ = RA.get_api(ref_cfg).init(ref_cfg, jax.random.key(seed))
    port_params = PT.params_from_reference(
        port_cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    prompt_lens, max_news = CASES[arch]
    kw = dict(vocab=ref_cfg.vocab, seed=3, rate_hz=0.0,
              prompt_lens=prompt_lens, max_news=max_news)
    r_trace, p_trace = ref_trace(N_REQ, **kw), synthetic_trace(N_REQ, **kw)
    extra = _extra(ref_cfg, seed=7)
    max_ctx = _max_ctx(ref_cfg, prompt_lens, max_news)
    # the reference's FixedEngine serves ``params`` as given: an int8 run
    # hands it the quantized tree, the port quantizes at load
    RefFixed(ref_cfg, lanes=LANES, max_ctx=max_ctx, quant=quant,
             params=(RQ.quantize_tree(ref_params) if quant else ref_params),
             extra_batch={k: jnp.asarray(v) for k, v in extra.items()}
             ).run(r_trace)
    eng = FixedEngine(port_cfg, lanes=LANES, max_ctx=max_ctx, quant=quant,
                      params=port_params, extra_batch=extra, device="cpu")
    stats = Gateway(eng).run(p_trace)
    for a, b in zip(r_trace, p_trace):
        assert np.array_equal(a.prompt, b.prompt)
        assert b.state == "finished" and len(b.out_tokens) == b.max_new
        assert b.out_tokens == a.out_tokens, (
            f"{arch} request {b.rid}: port {b.out_tokens} != reference "
            f"{a.out_tokens}")
    assert stats["tokens"] == sum(r.max_new for r in p_trace)
    assert stats["prefill_tokens"] == len(p_trace)
    assert stats["prefills"] == -(-N_REQ // LANES)
    return eng


@pytest.mark.parametrize("arch", sorted(CASES))
def test_fixed_engine_tokens_match_reference(arch):
    _differential(arch)


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-2.7b"])
def test_int8_fixed_engine_tokens_match_reference(arch):
    eng = _differential(arch, quant="int8")
    params = eng.params
    assert tree_quant_bytes(params) > 0
    stacked = params["seg0"] if arch == "qwen3-8b" else params["ssm_layers"]
    assert any(isinstance(v, Quantized) for v in _leaves(stacked))
    assert obs.metrics_json()["gauges"]["serve.quant_bytes"] == (
        tree_quant_bytes(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_int8_expansion_keeps_every_stacked_group_quantized():
    """``runners._deq_fn`` expands the unstacked parts for the call and
    keeps ``seg*``, ``ssm_layers``, ``enc_layers`` and ``dec_layers``
    8-bit (the model expands them one layer at a time)."""
    from repro_torch.launch.serving.runners import _deq_fn
    from repro_torch.optim.quant import quantize_tree

    for arch in ("zamba2-2.7b", "whisper-base", "internvl2-1b"):
        cfg = dataclasses.replace(PC.get_config(arch).smoke(), d_model=128,
                                  n_heads=4, head_dim=32)
        params = PA.get_api(cfg).init(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
        q = quantize_tree(params)
        out = _deq_fn("int8")(q)
        for key, sub in out.items():
            has_q = any(isinstance(v, Quantized) for v in _leaves(sub))
            stacked = key.startswith("seg") or key.endswith("_layers")
            assert has_q == stacked, (arch, key)


# --------------------------------------------------------------------------
# the reference's serving contracts, on the port
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    cfg = PC.get_config("qwen3-8b").smoke()
    params = PT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _server(small, batch_size, max_len=16):
    cfg, params = small
    return BatchServer(cfg, batch_size=batch_size, max_len=max_len,
                       params=params, device="cpu")


def _prompt(rng, n, vocab):
    return rng.integers(0, vocab, size=n).astype(np.int32)


def _solo(small, prompt, max_new, eos_id=None):
    req = Request(rid=0, prompt=prompt, max_new=max_new)
    _server(small, 1).run([req], eos_id=eos_id)
    return req.out_tokens


def test_batched_mixed_lengths_equals_solo(small):
    cfg, _ = small
    rng = np.random.default_rng(0)
    prompts = [_prompt(rng, n, cfg.vocab) for n in (3, 9, 5)]
    batch = [Request(rid=i, prompt=p, max_new=4)
             for i, p in enumerate(prompts)]
    _server(small, 3).run(batch)
    for i, p in enumerate(prompts):
        assert batch[i].out_tokens == _solo(small, p, 4), (
            f"request {i} (prompt len {len(p)}) decoded differently batched "
            "with longer prompts than solo")


def test_continuous_equals_fixed_equals_solo(small):
    cfg, params = small
    kw = dict(vocab=cfg.vocab, seed=3, rate_hz=0.0, prompt_lens=(3, 5, 9),
              max_news=(2, 5))
    t_cont, t_fixed = synthetic_trace(5, **kw), synthetic_trace(5, **kw)
    st = Gateway(ContinuousEngine(cfg, lanes=2, page_size=4, n_pages=13,
                                  max_ctx=16, params=params, device="cpu")
                 ).run(t_cont)
    fst = FixedEngine(cfg, lanes=2, max_ctx=16, params=params,
                      device="cpu").run(t_fixed)
    for a, b in zip(t_cont, t_fixed):
        assert a.out_tokens == b.out_tokens, (
            f"request {a.rid}: continuous {a.out_tokens} != fixed "
            f"{b.out_tokens}")
        assert a.out_tokens == _solo(small, a.prompt, a.max_new)
    assert st["tokens"] == sum(r.max_new for r in t_cont)
    assert fst["tokens"] == st["tokens"]
    assert st["prefill_tokens"] == fst["prefill_tokens"] == len(t_cont)


def test_throughput_counts_decode_tokens_only(small):
    cfg, _ = small
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=_prompt(rng, 4, cfg.vocab), max_new=5)
            for i in range(2)]
    stats = _server(small, 2).run(reqs)
    assert stats["tokens"] == 10
    # the first token per request came from the prefill logits
    assert stats["decode_tokens"] == 8
    # 4 decode dispatches give tokens 2..5: no 5th, wasted, dispatch
    assert stats["decode_steps"] == 4
    assert stats["tok_per_s"] == pytest.approx(
        stats["decode_tokens"] / stats["decode_s"])
    assert set(stats) == {"prefill_s", "decode_s", "decode_steps", "tokens",
                          "decode_tokens", "tok_per_s"}
    j = obs.metrics_json()
    assert j["counters"]["serve.tokens"] == 10
    assert j["counters"]["serve.requests"] == 2
    assert j["gauges"]["serve.tok_per_s"] == pytest.approx(stats["tok_per_s"])
    assert j["histograms"]["serve.request_latency_s"]["count"] == 2
    for name in ("plandb.hit", "plandb.miss", "autotune.hit",
                 "autotune.miss"):
        assert name in j["counters"], name


def test_max_new_zero_fixed_server(small):
    cfg, _ = small
    rng = np.random.default_rng(3)
    server = _server(small, 2, max_len=8)
    reqs = [Request(rid=0, prompt=_prompt(rng, 3, cfg.vocab), max_new=0),
            Request(rid=1, prompt=_prompt(rng, 3, cfg.vocab), max_new=2)]
    stats = server.run(reqs)
    assert reqs[0].done and reqs[0].out_tokens == []
    assert reqs[1].done and len(reqs[1].out_tokens) == 2
    j = obs.metrics_json()
    assert j["counters"]["serve.requests"] == 2
    assert j["histograms"]["serve.request_latency_s"]["count"] == 2
    assert stats["tokens"] == 2

    # an all-zero batch: not a single decode dispatch
    obs.metrics_reset()
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, cfg.vocab), max_new=0)
            for i in range(2)]
    stats = server.run(reqs)
    assert stats["decode_steps"] == 0 and stats["tokens"] == 0
    assert obs.metrics_json()["counters"]["serve.requests"] == 2


def test_eos_finishes_both_engines_early(small):
    cfg, params = small
    rng = np.random.default_rng(5)
    prompt = _prompt(rng, 4, cfg.vocab)
    free_run = _solo(small, prompt, 6)
    assert len(free_run) == 6
    eos = free_run[2]
    expected = free_run[: free_run.index(eos) + 1]
    assert _solo(small, prompt, 6, eos_id=eos) == expected
    req = ServeRequest(rid=0, prompt=prompt, max_new=6)
    stats = FixedEngine(cfg, lanes=1, max_ctx=16, params=params,
                        device="cpu").run([req], eos_id=eos)
    assert req.out_tokens == expected
    assert stats["tokens"] == len(expected)
    req = ServeRequest(rid=0, prompt=prompt, max_new=6)
    ContinuousEngine(cfg, lanes=1, page_size=4, n_pages=5, max_ctx=16,
                     params=params, device="cpu").run([req], eos_id=eos)
    assert req.out_tokens == expected


def test_batch_server_spans(small, monkeypatch):
    monkeypatch.setenv("REPRO_OBS", "1")
    cfg, _ = small
    rng = np.random.default_rng(6)
    reqs = [Request(rid=0, prompt=_prompt(rng, 4, cfg.vocab), max_new=3)]
    _server(small, 1).run(reqs)
    names = {e["name"] for e in obs.trace_json()["traceEvents"]}
    assert {"serve.prefill", "serve.decode", "serve.decode.step"} <= names


def test_too_many_requests_for_the_slots(small):
    cfg, _ = small
    reqs = [Request(rid=i, prompt=np.zeros(3, np.int32), max_new=1)
            for i in range(3)]
    with pytest.raises(ValueError, match="slots"):
        _server(small, 2).run(reqs)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--requests", "3", "--prompt-len", "8",
       "--max-new", "4", "--lanes", "2", "--rate-hz", "0"]


def test_cli_engine_fixed():
    stats, trace, engine = serve.main(["--arch", "qwen3-8b", "--engine",
                                       "fixed"] + CLI)
    assert isinstance(engine, FixedEngine)
    assert all(r.state == "finished" and len(r.out_tokens) == r.max_new
               for r in trace)
    assert stats["prefills"] == 2 and stats["kernel_launches"] == 0
    assert stats["grouped_launches"] == 0


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_cli_switches_unpageable_families_to_fixed(arch, capsys):
    stats, trace, engine = serve.main(["--arch", arch] + CLI)
    assert isinstance(engine, FixedEngine)
    out = capsys.readouterr()
    assert "unpageable state" in out.out + out.err
    assert stats["tokens"] == sum(r.max_new for r in trace)


@pytest.mark.parametrize("arch,key", [("whisper-base", "frames"),
                                      ("internvl2-1b", "patches")])
def test_cli_names_the_missing_frontend_input(arch, key):
    with pytest.raises(ValueError, match=f"batch\\['{key}'\\]"):
        serve.main(["--arch", arch] + CLI)


@pytest.mark.parametrize("flags,item", [(["--mesh", "2x4"], "6c")])
@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_cli_refuses_capture_and_mesh(flags, item, engine, capsys):
    # --capture serves since the capture slice
    # (tests/test_torch_capture_launch.py), and --mesh since the mesh tier
    # (item 6c): a world of one rank cannot host 2x4, so the CLI logs and
    # serves single-rank, as the reference does
    stats, trace, eng = serve.main(["--arch", "qwen3-8b", "--engine",
                                    engine] + CLI + flags)
    assert stats["tokens"] == sum(r.max_new for r in trace)
    assert all(r.state == "finished" for r in trace)
    assert getattr(eng, "server", eng).mesh is None
    assert "serving single-rank" in capsys.readouterr().out, item


def test_batch_server_refuses_capture_and_mesh(small):
    cfg, params = small
    # a mesh the world cannot host serves single-rank, captured too
    server = BatchServer(cfg, batch_size=1, max_len=8, params=params,
                         device="cpu", mesh_shape="2x4")
    assert server.mesh is None and server.mesh_shape == (2, 4)
    captured = BatchServer(cfg, batch_size=1, max_len=8, params=params,
                           device="cpu", mesh_shape="2x4", capture=True)
    assert captured.mesh is None and captured.mesh_shape == (2, 4)
    assert captured.capture and captured.capture_stats["points"] > 0
