"""The four kernel ops on DTensor operands: each op's sharding rule
(``ops.library``: the strategies for one mesh dim, expanded over the
mesh, the cheapest layout taken) on a 2x2 mesh of gloo ranks on the CPU.

* Every strategy pair of B1 (plain in f32 and bf16, the epilogue of
  bias / norm / gelu, the weighted and the transposed modes), B2 (heads),
  B3 and B4 (rows with their groups, contracted and free indices) runs on
  DTensors placed as the pair says: the gathered output equals the
  unsharded plain version and the reference's function on the same seeded
  numpy inputs at f32 (1e-4, 1e-4) and bf16 (6e-2, 6e-2), scaled.
* Each call goes through the op's rule once a rank (``ops.dtensor.*``),
  at the local extents wherever a pair shards (``ops.local.*``), and a
  non-identity epilogue is never left ``Partial``.
* In-process, on a fake world: each rule's strategy list for a sample of
  specs, and the layout the rule takes for a few placements.
* The host staging of DTensor's functional collectives
  (``codegen.collectives.stage_functional_collectives``), installed for
  one mesh's groups on 2 gloo ranks: that mesh's collectives run staged,
  another mesh's run the stock kernels, both equal to their oracles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro_torch.codegen import Epilogue, contract_ref
from repro_torch.codegen.fused_gen import grouped_dw_ref, grouped_ref
from repro_torch.core.enumerate import (attention_spec, chain_matmul_spec,
                                        grouped_matmul_spec, matmul_spec,
                                        quantized_matmul_spec,
                                        transposed_matmul_spec,
                                        weighted_matmul_spec)
from repro_torch.grad.derive import derived_specs
from repro_torch.kernels.fused_dense_act.ref import fused_dense_act_ref
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.ops import library

import _sharded_ranks as R

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 6e-2)}


def _inputs():
    rng = np.random.default_rng(0)
    m, k, n = R.B1_SHAPE
    h, s, d = R.ATTN_SHAPE
    rows = sum(R.GROUPS)
    f = np.float32
    return dict(
        x=rng.standard_normal((m, k)).astype(f),
        w=rng.standard_normal((k, n)).astype(f),
        beta=rng.standard_normal(n).astype(f),
        mean=rng.standard_normal(n).astype(f),
        var=(rng.random(n) + 0.5).astype(f),
        g=rng.standard_normal(k).astype(f),
        q=rng.standard_normal((h, s, d)).astype(f),
        k=rng.standard_normal((h, s, d)).astype(f),
        v=rng.standard_normal((h, s, d)).astype(f),
        xg=rng.standard_normal((rows, R.GROUP_K)).astype(f),
        wg=rng.standard_normal((len(R.GROUPS), R.GROUP_K,
                                R.GROUP_F)).astype(f),
        cot=rng.standard_normal((rows, R.GROUP_F)).astype(f),
    )


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtensor_ops")
    a = _inputs()
    path = str(root / "inputs.npz")
    np.savez(path, **a)
    ranks = spawn_ranks(R.ops_cases, 4, (path,), store_dir=str(root),
                        threads=1, timeout_s=300)
    return a, ranks


def _close(got, want, dt_name):
    rtol, atol = TOL[dt_name]
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want, np.float32) / scale,
                               rtol=rtol, atol=atol)


def _t(a, dt=torch.float32):
    return torch.tensor(a).to(dt)


def _bf16(a):
    return _t(a, torch.bfloat16).float().numpy()


def _wants(a):
    """op -> (dtype name, [(plain version, reference)])."""
    m, k, n = R.B1_SHAPE
    x, w = a["x"], a["w"]
    xb, wb = _bf16(x), _bf16(w)
    dense = {}
    for dt_name, xx, ww in (("float32", x, w), ("bfloat16", xb, wb)):
        dt = getattr(torch, dt_name)
        plain = contract_ref(matmul_spec(m, k, n), _t(xx, dt), _t(ww, dt),
                             out_dtype=dt).float().numpy()
        ref = np.asarray(ref_ops.dense(jnp.asarray(xx, dt_name),
                                       jnp.asarray(ww, dt_name)),
                         np.float32)
        dense[f"dense_{dt_name}"] = (dt_name, plain, ref)
    vecs = [_t(a[v]) for v in ("beta", "mean", "var")]
    plain = fused_dense_act_ref(_t(x), _t(w), *vecs, act="gelu",
                                eps=1e-5).numpy()
    ref = np.asarray(ref_ops.dense_act(
        jnp.asarray(x), jnp.asarray(w), *(jnp.asarray(a[v]) for v in
                                          ("beta", "mean", "var")),
        act="gelu", eps=1e-5))
    dense["dense_act"] = ("float32", plain, ref)
    plain = contract_ref(weighted_matmul_spec(m, k, n), _t(x), _t(w),
                         _t(a["g"]), out_dtype=torch.float32).numpy()
    ref = np.asarray(ref_ops.weighted_dense(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(a["g"])))
    dense["weighted"] = ("float32", plain, ref)
    plain = contract_ref(transposed_matmul_spec(m, k, n), _t(x.T.copy()),
                         _t(w), out_dtype=torch.float32).numpy()
    ref = np.asarray(ref_ops.dense_transposed(jnp.asarray(x.T.copy()),
                                              jnp.asarray(w)))
    dense["transposed"] = ("float32", plain, ref)
    from repro_torch.codegen import attention_ref

    plain = attention_ref(_t(a["q"]), _t(a["k"]), _t(a["v"]), causal=True,
                          kv_lengths=None, out_dtype=torch.float32).numpy()
    ref = np.asarray(ref_ops.attention(jnp.asarray(a["q"]),
                                       jnp.asarray(a["k"]),
                                       jnp.asarray(a["v"]), causal=True))
    dense["attention"] = ("float32", plain, ref)
    plain = grouped_ref(_t(a["xg"]), _t(a["wg"]), R.GROUPS,
                        out_dtype=torch.float32).numpy()
    ref = np.asarray(ref_ops.grouped_dense(jnp.asarray(a["xg"]),
                                           jnp.asarray(a["wg"]), R.GROUPS))
    dense["grouped"] = ("float32", plain, ref)
    plain = grouped_dw_ref(_t(a["xg"]), _t(a["cot"]), R.GROUPS,
                           out_dtype=torch.float32).numpy()

    def loss(wg):
        return jnp.sum(ref_ops.grouped_dense(jnp.asarray(a["xg"]), wg,
                                             R.GROUPS) * a["cot"])

    ref = np.asarray(jax.grad(loss)(jnp.asarray(a["wg"])))
    dense["grouped_dw"] = ("float32", plain, ref)
    return dense


OPS = ("dense_float32", "dense_bfloat16", "dense_act", "weighted",
       "transposed", "attention", "grouped", "grouped_dw")
@pytest.mark.parametrize("op", OPS)
def test_each_strategy_matches_plain_and_reference(cases, op):
    a, ranks = cases
    dt_name, plain, ref = _wants(a)[op]
    for out in ranks:
        rows = out[op]
        assert len(rows) >= 4  # every pair of at least two strategies
        for row in rows:
            _close(row["value"], plain, dt_name)
            _close(row["value"], ref, dt_name)
    for i, row in enumerate(ranks[0][op]):  # the ranks agree
        for other in ranks[1:]:
            np.testing.assert_array_equal(row["value"], other[op][i]["value"])


@pytest.mark.parametrize("op", OPS)
def test_one_call_through_the_rule_at_local_extents(cases, op):
    _, ranks = cases
    for out in ranks:
        for row in out[op]:
            assert row["ruled"] == 1, row
            if row["sharded"] and op not in ("attention",):
                # a sharded layout launches the kernel's local twin
                assert row["local"] >= 1, row


def test_a_non_identity_epilogue_is_never_left_partial(cases):
    _, ranks = cases
    for out in ranks:
        assert not any(row["partial"] for row in out["dense_act"])
        # the identity epilogue does take Partial outputs
        assert any(row["partial"] for row in out["dense_float32"])


def test_grouped_dw_operand_order(cases):
    _, ranks = cases
    assert ranks[0]["dw_order"] == list(derived_specs(grouped_matmul_spec(
        R.GROUPS, R.GROUP_K, R.GROUP_F))["W"].operands)


# -- the rules themselves, in-process -----------------------------------------


def _short(p):
    if p.is_partial():
        return "P"
    return f"S{p.dim}" if p.is_shard() else "R"


def _names(rules):
    return [(_short(out[0]), tuple(_short(p) for p in ins))
            for out, ins in rules]


def _kernel(spec, dtype=torch.float32, **kw):
    from repro_torch import ops

    return ops._tuned_kernel(spec, dtype, sharded=True, **kw)


def test_contract_strategies_follow_the_index_sets():
    got = _names(library.contract_strategies(
        _kernel(matmul_spec(16, 32, 24)), 0))
    assert got[0] == ("R", ("R", "R"))
    assert set(got[1:]) == {
        ("S0", ("S0", "R")),   # rows
        ("S1", ("R", "S1")),   # columns
        ("P", ("S1", "S0")),   # contracted
    }
    # an epilogue: its vectors follow the columns, no Partial output
    epi = Epilogue(act="gelu", bias=True, norm=True, eps=1e-5)
    got = _names(library.contract_strategies(
        _kernel(matmul_spec(16, 32, 24), epilogue=epi), 3))
    assert ("S1", ("R", "S1") + ("S0",) * 3) in got
    assert not any(out == "P" for out, _ in got)
    # the chain mode shards no contracted index
    got = _names(library.contract_strategies(
        _kernel(chain_matmul_spec(8, 16, 8, 16)), 0))
    assert not any(out == "P" for out, _ in got) and len(got) == 3
    # int8 with its dequant epilogue: free indices only
    got = _names(library.contract_strategies(
        _kernel(quantized_matmul_spec(16, 32, 24, "int8"), torch.int8,
                epilogue=Epilogue(dequant=True), out_dtype=torch.float32), 1))
    assert not any(out == "P" for out, _ in got)


def test_grouped_strategies_and_their_validity():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import fake_world, make_debug_mesh

    spec = grouped_matmul_spec((4,) * 4, 16, 8)
    k = _kernel(spec)
    got = _names(library.grouped_strategies(k))
    assert ("S0", ("S0", "S0")) in got  # groups
    assert ("P", ("S1", "S1")) in got  # K
    assert ("S1", ("R", "S2")) in got   # F
    ragged = _kernel(grouped_matmul_spec((3, 5), 16, 8))
    assert ("S0", ("S0", "S0")) not in _names(
        library.grouped_strategies(ragged))
    dw = _kernel(derived_specs(spec)["W"])
    assert ("S0", ("S0", "S0")) in _names(
        library.grouped_strategies(dw))
    with fake_world(8):
        mesh = make_debug_mesh((2, 4), ("data", "model")).device_mesh
        # 4 groups split over 4 ranks, or over 2; not over 8
        assert library.grouped_valid(k, mesh, [Replicate(), Shard(0)])
        assert library.grouped_valid(k, mesh, [Shard(0), Replicate()])
        assert not library.grouped_valid(k, mesh, [Shard(0), Shard(0)])
    assert _names(library.attention_strategies(4))[1] == (
        "S0", ("S0",) * 4)


def test_the_rule_takes_the_layout_that_moves_least():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import fake_world, make_debug_mesh

    rules = library.contract_strategies(_kernel(matmul_spec(16, 32, 24)), 0)
    with fake_world(4):
        dm = make_debug_mesh((2, 2), ("data", "model")).device_mesh

        def placed(t, pl):
            return distribute_tensor(t, dm, pl, src_data_rank=None)

        x, w = torch.ones(16, 32), torch.ones(32, 24)
        # rows on data, columns on model: already the layout, no move
        out, ins = library.choose_layout(
            [placed(x, [Shard(0), Replicate()]),
             placed(w, [Replicate(), Shard(1)])], rules, 16 * 24 * 4)
        assert [_short(p) for p in out] == ["S0", "S1"]
        # a contracted index sharded on both: a Partial sum, not a gather
        out, ins = library.choose_layout(
            [placed(x, [Shard(1), Replicate()]),
             placed(w, [Shard(0), Replicate()])], rules, 16 * 24 * 4)
        assert out[0].is_partial() and out[1].is_replicate()
        # replicated operands: sharded without a move, and no Partial
        out, _ = library.choose_layout(
            [placed(x, [Replicate()] * 2), placed(w, [Replicate()] * 2)],
            rules, 16 * 24 * 4)
        assert not any(p.is_partial() for p in out)


def test_attention_spec_for_the_b2_case():
    h, s, d = R.ATTN_SHAPE
    assert attention_spec(h, s, s, d).output == ("h", "s", "e")


def test_staging_covers_only_the_host_meshs_groups(tmp_path):
    ranks = spawn_ranks(R.staged_collectives, 2, (), store_dir=str(tmp_path),
                        threads=1, timeout_s=120)
    xs = [np.arange(4, dtype=np.float32) + 10 * r for r in range(2)]
    for rank, out in enumerate(ranks):
        # 5 functional calls and 2 DTensor redistributions, each once
        assert out["host"]["staged"] == 7, out["host"]["staged"]
        assert out["device"]["staged"] == 0, out["device"]["staged"]
        for got in (out["host"], out["device"]):
            np.testing.assert_array_equal(got["input"], xs[rank])
            np.testing.assert_array_equal(got["all_reduce"], xs[0] + xs[1])
            np.testing.assert_array_equal(got["all_gather"],
                                          np.concatenate(xs))
            np.testing.assert_array_equal(got["reduce_scatter"],
                                          (xs[0] + xs[1])[2 * rank:
                                                          2 * rank + 2])
            np.testing.assert_array_equal(
                got["all_to_all"], np.concatenate([x[2 * rank: 2 * rank + 2]
                                                   for x in xs]))
            np.testing.assert_array_equal(got["broadcast"], xs[1])
            np.testing.assert_array_equal(got["dtensor_gather"],
                                          np.concatenate(xs))
            np.testing.assert_array_equal(got["dtensor_sum"], xs[0] + xs[1])
