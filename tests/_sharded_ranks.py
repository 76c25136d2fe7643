"""Rank bodies of the sharded-step tests: each runs on every rank of a
world that ``launch.mesh.spawn_ranks`` starts (gloo on the CPU, a
``FileStore``) and returns numpy results the test compares in its own
process.

This module imports only torch, numpy and the port (a spawned rank imports
it by name), so that a rank does not pay for importing jax.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

#: the op cases of ``ops_cases``: B1 (16, 32, 24), B2 (4 heads, 8, 16),
#: B3 / B4 four groups of 4 rows, 16 -> 8
B1_SHAPE = (16, 32, 24)
ATTN_SHAPE = (4, 8, 16)
GROUPS, GROUP_K, GROUP_F = (4, 4, 4, 4), 16, 8


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _pairs(rules):
    return [(a, b) for a in rules for b in rules]


def _run_pairs(mesh, call, inputs, rules, name):
    """Each (data, model) pair of an op's single-dimension strategies: the
    inputs placed as it says, ``call`` on them; per pair the gathered
    output, its placements and the op's calls through its rule."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import obs

    out = []
    for data, model in _pairs(rules):
        pls = [list(p) for p in zip(data[1], model[1])]
        args = [distribute_tensor(x, mesh.device_mesh, pl, src_data_rank=None)
                for x, pl in zip(inputs, pls)]
        obs.metrics_reset()
        got = call(*args)
        counters = obs.metrics_json()["counters"]
        out.append(dict(
            placements=[str(p) for p in got.placements],
            partial=any(p.is_partial() for p in got.placements),
            value=_np(got.full_tensor()),
            ruled=counters.get(f"ops.dtensor.{name}", 0),
            local=sum(v for k, v in counters.items()
                      if k.startswith("ops.local.")),
            sharded=any(p.is_shard() for pl in pls for p in pl)))
    return out


def ops_cases(rank, path):
    """Every strategy pair of the four ops on DTensors over a 2x2 mesh, on
    the seeded inputs in ``path``."""
    from repro_torch import ops
    from repro_torch.codegen import Epilogue
    from repro_torch.core.enumerate import (grouped_matmul_spec, matmul_spec,
                                            transposed_matmul_spec,
                                            weighted_matmul_spec)
    from repro_torch.grad.derive import derived_specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.ops import library

    mesh = make_debug_mesh((2, 2), ("data", "model"))
    with np.load(path) as z:
        a = {k: z[k] for k in z.files}
    m, k, n = B1_SHAPE
    out = {}

    def kern(spec, dt, **kw):
        return ops._tuned_kernel(spec, dt, sharded=True, **kw)

    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        x, w = _t(a["x"], dt), _t(a["w"], dt)
        rules = library.contract_strategies(kern(matmul_spec(m, k, n), dt), 0)
        out[f"dense_{dt_name}"] = _run_pairs(
            mesh, lambda p, q: ops.dense(p, q, differentiable=False), (x, w),
            rules, "contract")
    x, w = _t(a["x"]), _t(a["w"])
    vecs = [_t(a[v]) for v in ("beta", "mean", "var")]
    epi = Epilogue(act="gelu", bias=True, norm=True, eps=1e-5)
    out["dense_act"] = _run_pairs(
        mesh, lambda *p: ops.dense_act(*p, act="gelu", differentiable=False),
        (x, w, *vecs), library.contract_strategies(
            kern(matmul_spec(m, k, n), torch.float32, epilogue=epi), 3),
        "contract")
    g = _t(a["g"])
    out["weighted"] = _run_pairs(
        mesh, lambda p, q, r: ops.weighted_dense(p, q, r,
                                                 differentiable=False),
        (x, w, g), library.contract_strategies(
            kern(weighted_matmul_spec(m, k, n), torch.float32), 0),
        "contract")
    xt = _t(a["x"].T.copy())
    out["transposed"] = _run_pairs(
        mesh, lambda p, q: ops.dense_transposed(p, q, differentiable=False),
        (xt, w), library.contract_strategies(
            kern(transposed_matmul_spec(m, k, n), torch.float32), 0),
        "contract")
    q, kk, v = (_t(a[s]) for s in ("q", "k", "v"))
    out["attention"] = _run_pairs(
        mesh, lambda p, r, s: ops.attention(p, r, s, causal=True,
                                            differentiable=False),
        (q, kk, v), library.attention_strategies(3), "attention")
    xg, wg = _t(a["xg"]), _t(a["wg"])
    spec = grouped_matmul_spec(GROUPS, GROUP_K, GROUP_F)
    gk = kern(spec, torch.float32)
    out["grouped"] = _run_pairs(
        mesh, lambda p, r: ops.grouped_dense(p, r, GROUPS,
                                             differentiable=False),
        (xg, wg), library.grouped_strategies(gk), "grouped")
    dw_spec = derived_specs(spec)["W"]
    dwk = kern(dw_spec, torch.float32)
    cot = _t(a["cot"])
    by = {nm: (cot if "f" in dw_spec.operands[nm] else xg)
          for nm in dw_spec.operands}
    out["grouped_dw"] = _run_pairs(
        mesh, lambda p, r: dwk(p, r), [by[nm] for nm in dw_spec.operands],
        library.grouped_strategies(dwk), "grouped_dw")
    out["dw_order"] = list(dw_spec.operands)
    return out


def _load_tree(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _batches(cfg, steps, seq=32, batch=8):
    from repro_torch.data.pipeline import DataConfig, batch_at

    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    return [{k: torch.as_tensor(np.asarray(v)) for k, v in
             batch_at(dc, i).items()} for i in range(steps)]


def _placed_batch(mesh, b):
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import shard_tree

    return shard_tree(mesh, b, {k: shd.batch_spec_for(
        mesh, tuple(v.shape), seq_axis=1) for k, v in b.items()})


def _train(cfg, mesh, params, steps, lr=1e-2, sharded=True):
    from repro_torch.dtensor import local
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim

    ocfg = AdamWConfig(lr=lr, moments_dtype="float32")
    state = optim.init(params, ocfg)
    step = make_train_step(cfg, ocfg, mesh=mesh)
    losses = []
    norms = []  # (grad_norm, clip_scale) a step
    for b in _batches(cfg, steps):
        if sharded:
            b = _placed_batch(mesh, b)
        params, state, m = step(params, state, b)
        losses.append(float(local(m["loss"])))
        norms.append([float(local(m[k])) for k in ("grad_norm",
                                                     "clip_scale")])
    _train.norms = norms
    return params, state, losses


def sharded_train(rank, ref_params_path, steps):
    """deepseek-7b smoke on a 2x2 mesh under each sharding profile, from
    the reference's weights: the losses, each leaf's local shape, the
    placements of the outputs against the bundle's, and the replicated
    mesh step's first losses (the mesh-bound kernels' path)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (check_placements, opt_shardings,
                                          param_shardings, shard_tree)
    from repro_torch.models import transformer as PT
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim

    cfg = get_config("deepseek-7b").smoke()
    api = get_api(cfg)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    tree = _load_tree(ref_params_path)
    out = {}
    for profile in ("tp", "dp", "zero1"):
        os.environ["REPRO_SHARDING"] = profile
        try:
            shapes, _, p_shard = param_shardings(mesh, cfg, api)
            params = shard_tree(mesh, PT.params_from_reference(
                cfg, tree, device="cpu"), p_shard)
            n = steps if profile == "tp" else 3
            params, state, losses = _train(cfg, mesh, params, n)
            check_placements(params, p_shard, "params")
            check_placements(state, opt_shardings(
                mesh, optim.init(shapes, AdamWConfig()), p_shard), "state")
            out[profile] = dict(
                losses=losses, norms=_train.norms[:3],
                local_shapes={"/".join(p): tuple(t.to_local().shape)
                              for p, t in optim.leaves(params)})
        finally:
            os.environ.pop("REPRO_SHARDING", None)
    params = PT.params_from_reference(cfg, tree, device="cpu")
    out["replicated"] = _train(cfg, mesh, params, 3, sharded=False)[2]
    return out


def sharded_moe(rank, ref_params_path, constraint):
    """kimi-k2 smoke on a 2x2 mesh, ``REPRO_MOE_GROUPED=1`` (and
    ``REPRO_MOE_CONSTRAINT`` as given), 3 steps from the reference's
    weights: the losses and the grouped ops' calls through their rules."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import param_shardings, shard_tree
    from repro_torch.models import transformer as PT
    from repro_torch.models.api import get_api

    os.environ["REPRO_MOE_GROUPED"] = "1"
    if constraint:
        os.environ["REPRO_MOE_CONSTRAINT"] = "1"
    cfg = get_config("kimi-k2-1t-a32b").smoke()
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    params = shard_tree(mesh, PT.params_from_reference(
        cfg, _load_tree(ref_params_path), device="cpu"),
        param_shardings(mesh, cfg, get_api(cfg))[2])
    obs.metrics_reset()
    _, _, losses = _train(cfg, mesh, params, 3)
    counters = obs.metrics_json()["counters"]
    return dict(losses=losses,
                grouped=counters.get("ops.dtensor.grouped", 0),
                grouped_dw=counters.get("ops.dtensor.grouped_dw", 0))


#: the one-layer stand-in of the recorder check: extents a 2x2 mesh
#: divides, batch 4 x 8
RECORD_CFG = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, d_ff=128, vocab=256, remat=False)
RECORD_SHAPE = (8, 4)


def record_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen3-8b").smoke(), **RECORD_CFG)


def recorded_step(rank):
    """One sharded train step of ``record_cfg()`` on a real 2x2 world, its
    collectives recorded (``dryrun.collective_bytes``), its arguments
    placed as the train bundle places its own."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim

    cfg = record_cfg()
    api = get_api(cfg)
    seq, batch = RECORD_SHAPE
    shape = ShapeConfig("train", seq, batch, "train")
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    params = S.shard_tree(mesh, api.init(cfg, torch.Generator().manual_seed(0),
                                         "cpu"),
                          S.param_shardings(mesh, cfg, api)[2])
    batch_ = S.shard_tree(mesh, S._batch(cfg, shape, "cpu"),
                          S.batch_shardings(mesh, cfg, shape))
    state = optim.init(params, AdamWConfig())
    step = S.make_train_step(cfg, AdamWConfig(), mesh=mesh)
    return collective_bytes(step, params, state, batch_)


def elastic_save(rank, ckpt_dir, steps):
    """The smoke qwen3-8b on 2x2: steps 0 and 1, a checkpoint at step 2,
    then ``steps`` - 2 more steps uninterrupted; the parameters' bytes at
    the checkpoint and every loss."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import param_shardings, shard_tree
    from repro_torch.models.api import get_api

    cfg = get_config("qwen3-8b").smoke()
    api = get_api(cfg)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    params = shard_tree(mesh, api.init(cfg, torch.Generator().manual_seed(0),
                                       "cpu"),
                        param_shardings(mesh, cfg, api)[2])
    losses, saved = _elastic_steps(cfg, mesh, params, ckpt_dir, steps)
    return dict(losses=losses, saved=saved)


def _full_bytes(tree):
    from repro_torch.dtensor import is_dtensor
    from repro_torch.optim import adamw as optim

    out = {}
    for path, t in optim.leaves(tree):
        full = (t.full_tensor() if is_dtensor(t) else t).detach()
        out["/".join(path)] = full.view(
            torch.int16 if full.dtype == torch.bfloat16 else torch.uint8
        ).numpy().tobytes()
    return out


def _elastic_steps(cfg, mesh, params, ckpt_dir, steps):
    from repro_torch import checkpoint as ckpt
    from repro_torch.dtensor import local
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim

    ocfg = AdamWConfig(lr=1e-2)
    state = (params, optim.init(params, ocfg))
    step = make_train_step(cfg, ocfg, mesh=mesh)
    losses, saved = [], None
    for i, b in enumerate(_batches(cfg, steps)):
        if i == 2:
            ckpt.save(ckpt_dir, 2, state)
            saved = _full_bytes(state[0])
        p, o, m = step(state[0], state[1], _placed_batch(mesh, b))
        state = (p, o)
        losses.append(float(local(m["loss"])))
    return losses, saved


def elastic_restore(rank, ckpt_dir, shape, fail):
    """The checkpoint of ``elastic_save`` restored on a ``shape`` mesh with
    its shardings; with ``fail``, step 2 through a fault loop whose first
    attempt raises ``StepFailure``."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.dtensor import local
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (_meta_params, make_train_step,
                                          opt_shardings, param_shardings)
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim
    from repro_torch.runtime.fault import (FaultTolerantLoop, LoopConfig,
                                           StepFailure)

    cfg = get_config("qwen3-8b").smoke()
    api = get_api(cfg)
    mesh = make_debug_mesh(shape, ("data", "model"))
    ocfg = AdamWConfig(lr=1e-2)
    p_shard = param_shardings(mesh, cfg, api)[2]
    meta = _meta_params(cfg, api)
    shardings = (p_shard, opt_shardings(mesh, optim.init(meta, ocfg),
                                        p_shard))
    template = (meta, optim.init(meta, ocfg))

    def restore():
        tree, manifest = ckpt.restore(ckpt_dir, template,
                                      shardings=shardings, mesh=mesh)
        return manifest["step"], tree

    start, state = restore()
    out = dict(start=start, restored=_full_bytes(state[0]),
               local_shapes={"/".join(p): tuple(t.to_local().shape)
                             for p, t in optim.leaves(state[0])})
    if not fail:
        return out
    step = make_train_step(cfg, ocfg, mesh=mesh)
    batches = _batches(cfg, 3)
    losses, failed = {}, []

    def one(i, st):
        if not failed:
            failed.append(i)
            raise StepFailure(f"injected at step {i}")
        p, o, m = step(st[0], st[1], _placed_batch(mesh, batches[i]))
        losses[i] = float(local(m["loss"]))
        return (p, o)

    loop = FaultTolerantLoop(step_fn=one, save_fn=lambda s, st: None,
                             restore_fn=restore,
                             config=LoopConfig(checkpoint_every=1000))
    loop.run(state, start, 1)
    out.update(losses=losses, restores=loop.report.restores,
               failures=loop.report.failures)
    return out


def train_cli(rank, ckpt_dir, shape, steps):
    """``launch.train.train`` on a ``shape`` mesh (every rank), from a
    checkpoint in ``ckpt_dir`` where there is one; the losses."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import TrainRun, train
    from repro_torch.optim import AdamWConfig

    cfg = get_config("deepseek-7b").smoke()
    mesh = make_debug_mesh(shape, ("data", "model"))
    run = TrainRun(cfg=cfg, opt_cfg=AdamWConfig(lr=1e-2),
                   data_cfg=DataConfig(vocab=cfg.vocab, seq_len=32,
                                       global_batch=8),
                   steps=steps, ckpt_dir=ckpt_dir, ckpt_every=2,
                   device="cpu", mesh=mesh)
    _, losses, report = train(run, verbose=False)
    return dict(losses=losses, restores=report.restores)


def serve_capture(rank, db_path, flags):
    """``serve.main(flags)`` on every rank (``--capture --mesh`` or not);
    each request's tokens."""
    os.environ["REPRO_PLAN_DB"] = db_path
    os.environ["REPRO_INTERPRET"] = "1"
    from repro_torch.launch import serve

    _, trace, engine = serve.main(flags)
    server = getattr(engine, "server", engine)
    return dict(tokens={r.rid: list(r.out_tokens) for r in trace},
                meshed=server.mesh is not None)


def sweep_captured_mesh(rank, db_path):
    """``capture.sweep_captured(mesh_shape="1x2")`` on a world that hosts
    the mesh, over two plain GEMM points and a fused one; the ranked
    ladders' presence by (label, mesh)."""
    from repro_torch import capture
    from repro_torch.core.enumerate import attention_spec, matmul_spec
    from repro_torch.launch.mesh import make_debug_mesh, set_mesh
    from repro_torch.search import PlanDB

    db = PlanDB(db_path)
    mesh = make_debug_mesh((1, 2), ("data", "model"))
    points = [("train:a", matmul_spec(16, 32, 32), "float32"),
              ("train:b", matmul_spec(32, 32, 16), "float32"),
              ("prefill:attention", attention_spec(2, 8, 8, 16), "float32")]
    with set_mesh(mesh):
        n = capture.sweep_captured(points, with_grads=False, plan_db=db,
                                   measure=True, mesh_shape="1x2",
                                   device="cpu", repeats=1)
    found = {}
    for label, spec, dt in points:
        for ms in (None, "1x2"):
            if ms is None:
                found[(label, ms)] = db.best_schedule(spec, dt) is not None
            else:
                found[(label, ms)] = db.best_sharded_entry(
                    spec, dt, mesh=ms)[0] is not None
    return dict(n=n, found={f"{k[0]}@{k[1]}": v for k, v in found.items()})


def restore_world_of_one(rank, ckpt_dir):
    """``restore(shardings=)`` of a flat {a, b} tree on a 1x1 mesh (a world
    of one): each leaf's values."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.codegen.mesh_gen import Placements
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh((1, 1), ("data", "model"))
    template = {"a": torch.zeros(4, 6), "b": torch.zeros(5)}
    shardings = {k: Placements((), mesh.axis_names) for k in template}
    tree, _ = ckpt.restore(ckpt_dir, template, shardings=shardings, mesh=mesh)
    return {k: v.full_tensor().double().numpy().tolist()
            for k, v in tree.items()}


def sharded_serving(rank):
    """qwen3-8b smoke, prefill of 4 x 16 tokens into a 24-deep cache and
    2 decode steps, with DTensor parameters, caches and tokens on a 2x2
    mesh and with plain ones: the largest difference of the logits and
    the caches' placements."""
    from repro_torch.configs import get_config
    from repro_torch.dtensor import is_dtensor
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import param_shardings, shard_tree
    from repro_torch.models import transformer as PT
    from repro_torch.models.api import get_api

    cfg = get_config("qwen3-8b").smoke()
    api = get_api(cfg)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    sharded = shard_tree(mesh, params, param_shardings(mesh, cfg, api)[2])
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                           dtype=torch.int32)
    placed = shard_tree(mesh, tokens, shd.batch_spec_for(mesh, (4, 16)))
    diffs = []
    with torch.no_grad():
        want, caches = PT.prefill(params, cfg, tokens, 24)
        got, s_caches = PT.prefill(sharded, cfg, placed, 24)
        diffs.append(float((got.full_tensor() - want).abs().max()))
        nxt = torch.argmax(want[:, -1:], dim=-1).to(torch.int32)
        for _ in range(2):
            want, caches = PT.decode_step(params, cfg, caches, nxt)
            got, s_caches = PT.decode_step(
                sharded, cfg, s_caches,
                shard_tree(mesh, nxt, shd.batch_spec_for(mesh, (4, 1))))
            diffs.append(float((got.full_tensor() - want).abs().max()))
            nxt = torch.argmax(want[:, -1:], dim=-1).to(torch.int32)
    k = s_caches["seg0"]["dense"]["k"]
    return dict(diffs=diffs, scale=float(want.abs().max()),
                cache_sharded=is_dtensor(k),
                cache_placements=[str(p) for p in k.placements])


def staged_collectives(rank):
    """Functional collectives on a 2-rank world after the host staging is
    installed for one mesh's groups (on the CPU dispatch key, where the
    test can run it): that mesh's collectives go through the staged
    kernels, another mesh's through the stock ones, all equal to their
    sums and gathers."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch import obs
    from repro_torch.codegen.collectives import stage_functional_collectives
    from repro_torch.dtensor import from_local
    from repro_torch.launch.mesh import make_debug_mesh

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    host = make_debug_mesh((1, 2), ("data", "model"), transport="host")
    stage_functional_collectives([host.group(a) for a in host.axis_names],
                                 key="CPU")
    # a group of the same ranks made after the staging: a device mesh's
    group = dist.new_group([0, 1])
    dev = DeviceMesh.from_group(group, "cpu", mesh_dim_names=("model",))
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    out = {}
    for name, mesh, group in (
            ("host", host.device_mesh, host.group("model")),
            ("device", dev, group)):
        axes = mesh.mesh_dim_names
        obs.metrics_reset()
        got = dict(
            all_reduce=funcol.all_reduce(x, "sum", group),
            all_gather=funcol.all_gather_tensor(x, 0, group),
            reduce_scatter=funcol.reduce_scatter_tensor(x, "sum", 0, group),
            all_to_all=funcol.all_to_all_single(x, None, None, group),
            broadcast=funcol.broadcast(x, 1, group))
        pl = [Shard(0) if a == "model" else Replicate() for a in axes]
        part = [Partial() if a == "model" else Replicate() for a in axes]
        got["dtensor_gather"] = from_local(x, mesh, pl, (8,)).full_tensor()
        got["dtensor_sum"] = from_local(x, mesh, part, (4,)).full_tensor()
        out[name] = {k: _np(funcol.wait_tensor(v) if hasattr(v, "wait")
                            else v) for k, v in got.items()}
        out[name]["input"] = _np(x)
        out[name]["staged"] = obs.metrics_json()["counters"].get(
            "mesh.staged_calls", 0)
    return out
