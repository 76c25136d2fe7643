"""The port's remat policies and causal skip against the reference.

``REPRO_REMAT_POLICY`` = ``nothing`` / ``dots`` / ``dots_no_batch``
(``models.layers.remat``) and ``REPRO_CAUSAL_SKIP`` (``layers.
blockwise_attention``), on the CPU at smoke sizes.  Inputs come from the
reference's seeded init, carried across by ``params_from_reference``, and
the reference's data pipeline.

* Loss and gradients under each policy against ``jax.value_and_grad``
  under the same policy (``tests/test_grad.py``'s f32 TOL, scaled), and
  equal bit for bit to the port's ``nothing``.
* The products a layer runs in a train step, counted by op: 27 / 21 / 21
  ``aten.mm`` under the three policies on the CPU (7 forward, 14 backward
  and the recompute of all but the last: a non-reentrant checkpoint stops
  recomputing once it holds every saved tensor, and ``aten.mm`` saves its
  inputs before it runs); ``dots_no_batch`` recomputes attention's two
  batched einsums and nothing else that ``dots`` saves.
* A checkpointed block of two kernel products (``ops.dense`` with
  ``interpret=True``, which calls the ``repro_torch::contract`` op whose
  CPU implementation is B1's plain version): 8 op calls under
  ``nothing``, 6 under either ``dots`` policy.
* Causal skip: the reference's ``blockwise_attention`` under
  ``REPRO_CAUSAL_SKIP=1`` (f32 rtol 1e-4 / atol 1e-5) and the port's own
  without the knob (bit for bit).

On fake CUDA tensors the ``repro_torch`` product ops of a train step (28
/ 21 / 21 a layer) are counted on the card's machine
(``tests/test_torch_gpu.py``): autograd's engine on a CPU-only build of
PyTorch refuses CUDA tensors, fake ones too.
"""

from __future__ import annotations

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.data import pipeline as ref_data
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.api import get_api as ref_get_api
from repro_torch import ops
from repro_torch.configs import get_config as port_get_config
from repro_torch.launch import steps as port_steps
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.api import get_api as port_get_api
from repro_torch.optim import adamw as port_adamw

TOL = (2e-4, 2e-4)  # f32, tests/test_grad.py
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
POLICIES = ("nothing", "dots", "dots_no_batch")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.delenv("REPRO_MOE_GROUPED", raising=False)
    monkeypatch.delenv("REPRO_CAUSAL_SKIP", raising=False)
    monkeypatch.setenv("REPRO_LOG", "quiet")


class _OpCount(TorchDispatchMode):
    """Counts the ops dispatched beneath it, by name."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _models(arch, seed, n_layers=None):
    ref_cfg = ref_get_config(arch).smoke()
    port_cfg = port_get_config(arch).smoke()
    if n_layers:
        ref_cfg = dataclasses.replace(ref_cfg, n_layers=n_layers)
        port_cfg = dataclasses.replace(port_cfg, n_layers=n_layers)
    ref_params, _ = RT.init(ref_cfg, jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, ref_params)
    return ref_cfg, port_cfg, ref_params, np_params


def _batch(cfg, batch=2, seq=16):
    data = ref_data.DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch)
    b = ref_data.batch_at(data, 0)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v.copy()) for k, v in b.items()})


def _port_grads(port_cfg, np_params, pb):
    params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    return port_steps.value_and_grad(
        lambda p, b: port_get_api(port_cfg).loss(p, port_cfg, b), params, pb)


def _assert_close(got, want, what):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=TOL[0],
                               atol=TOL[1], err_msg=what)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_match_reference(arch, policy, monkeypatch):
    ref_cfg, port_cfg, ref_params, np_params = _models(arch, seed=3)
    assert port_cfg.remat and ref_cfg.remat
    rb, pb = _batch(ref_cfg)
    monkeypatch.setenv("REPRO_REMAT_POLICY", "nothing")
    base_loss, base = _port_grads(port_cfg, np_params, pb)
    monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    rloss, rgrads = jax.value_and_grad(
        lambda p: ref_get_api(ref_cfg).loss(p, ref_cfg, rb))(ref_params)
    ploss, pgrads = _port_grads(port_cfg, np_params, pb)
    _assert_close(ploss, rloss, "loss")
    assert torch.equal(ploss, base_loss)
    for path, g in port_adamw.leaves(pgrads):
        _assert_close(g, _leaf(rgrads, path), "/".join(path))
        assert torch.equal(g, port_adamw.at_path(base, path)), path


def _products(port_cfg, np_params, pb):
    with _OpCount() as c:
        _port_grads(port_cfg, np_params, pb)
    return c.n


@pytest.mark.parametrize("policy,mm,bmm", [
    ("nothing", 27, 8), ("dots", 21, 6), ("dots_no_batch", 21, 8),
])
def test_products_per_layer_on_the_cpu(policy, mm, bmm, monkeypatch):
    """Per layer (the difference of a 3- and a 2-layer model): the seven
    projections' ``aten.mm`` and attention's two batched einsums
    (``aten.bmm``: forward 2, backward 4, recompute 2 unless saved)."""
    monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    counts = []
    for n_layers in (2, 3):
        _, port_cfg, _, np_params = _models("qwen3-8b", 4, n_layers)
        _, pb = _batch(port_cfg)
        counts.append(_products(port_cfg, np_params, pb))
    assert counts[1]["aten.mm"] - counts[0]["aten.mm"] == mm
    assert counts[1]["aten.bmm"] - counts[0]["aten.bmm"] == bmm


def test_dots_no_batch_recomputes_only_the_batched_einsums(monkeypatch):
    _, port_cfg, _, np_params = _models("qwen3-8b", 5)
    _, pb = _batch(port_cfg)
    got = {}
    for policy in ("dots", "dots_no_batch"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        got[policy] = _products(port_cfg, np_params, pb)
    # the policy's own bookkeeping: it detaches each output it saves
    diff = {k: got["dots_no_batch"][k] - got["dots"][k]
            for k in set(got["dots"]) | set(got["dots_no_batch"])
            if got["dots_no_batch"][k] != got["dots"][k]
            and k != "aten.detach"}
    # 2 einsums a layer; every other op alike
    assert diff == {"aten.bmm": 2 * port_cfg.n_layers}


def _block(x, w1, w2):
    h = torch.tanh(ops.dense(x, w1, interpret=True))
    return ops.dense(h, w2, interpret=True)


@pytest.mark.parametrize("policy,want", [
    ("nothing", 8), ("dots", 6), ("dots_no_batch", 6),
])
def test_policy_saves_the_kernel_ops(policy, want, monkeypatch):
    """Two kernel products in a checkpointed block: forward 2, backward 4
    (dA, dB each), and the recompute 2 only under ``nothing``."""
    monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    rng = np.random.default_rng(0)
    x, w1, w2 = (torch.tensor(rng.standard_normal((128, 128)) / 12,
                              dtype=torch.float32, requires_grad=True)
                 for _ in range(3))
    with _OpCount() as c:
        out = PL.remat(_block)(x, w1, w2)
        grads = torch.autograd.grad(out.square().sum(), (x, w1, w2))
    assert c.n["repro_torch.contract"] == want
    monkeypatch.setenv("REPRO_REMAT_POLICY", "nothing")
    out0 = PL.remat(_block)(x, w1, w2)
    want_grads = torch.autograd.grad(out0.square().sum(), (x, w1, w2))
    for g, g0 in zip(grads, want_grads):
        assert torch.equal(g, g0)


def test_unknown_policy_raises(monkeypatch):
    monkeypatch.setenv("REPRO_REMAT_POLICY", "everything")
    with pytest.raises(ValueError, match="REPRO_REMAT_POLICY"):
        PL.remat(_block)


@pytest.mark.parametrize("s,q_block,k_block,lengths", [
    (64, 16, 16, None), (64, 16, 8, None), (64, 8, 32, None),
    (48, 16, 24, None), (64, 16, 16, (40, 64)), (32, 8, 8, (1, 17)),
])
def test_causal_skip_matches_reference_and_unskipped(s, q_block, k_block,
                                                     lengths, monkeypatch):
    rng = np.random.default_rng(s + q_block + k_block)
    q = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 8)).astype(np.float32)
    kw = dict(q_block=q_block, k_block=k_block)
    lens = None if lengths is None else np.array(lengths, np.int32)
    plain = PL.blockwise_attention(
        *map(torch.tensor, (q, k, v)), **kw,
        kv_lengths=None if lens is None else torch.tensor(lens))
    monkeypatch.setenv("REPRO_CAUSAL_SKIP", "1")
    want = RL.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), **kw,
        kv_lengths=None if lens is None else jnp.asarray(lens))
    got = PL.blockwise_attention(
        *map(torch.tensor, (q, k, v)), **kw,
        kv_lengths=None if lens is None else torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    assert torch.equal(got, plain)


def test_causal_skip_cuts_the_traced_products(monkeypatch):
    """A 512-token prefill in blocks of 64 on fake tensors: the skip runs
    the key blocks each query block's frontier reaches, (8 * 9 / 2) of
    64 block pairs, so the attention's product flops fall to 36 / 64."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell

    cfg = dataclasses.replace(port_get_config("qwen3-8b").smoke(),
                              n_layers=1)
    shape = ShapeConfig("prefill", 512, 1, "prefill")
    flops = {}
    for skip in ("0", "1"):
        monkeypatch.setenv("REPRO_CAUSAL_SKIP", skip)
        with monkeypatch.context() as m:
            m.setattr(PL, "blockwise_attention",
                      _blocks_of(PL.blockwise_attention, 64))
            flops[skip] = run_cell("qwen3-8b", "prefill", device="cpu",
                                   cfg=cfg, shape=shape)["flops"]
    # the layer's projections and the unembedding do not change
    h, hd, s = cfg.n_heads, cfg.hd, 512
    attn = 2 * 2 * h * s * s * hd
    assert flops["0"] - flops["1"] == attn * (64 - 36) // 64


def _blocks_of(fn, block):
    def wrapped(*args, **kwargs):
        kwargs.update(q_block=block, k_block=block)
        return fn(*args, **kwargs)
    return wrapped
