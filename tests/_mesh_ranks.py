"""Rank bodies of the mesh tests: each runs on every rank of a world that
``launch.mesh.spawn_ranks`` starts (gloo on the CPU, a ``FileStore``), and
returns numpy results the test compares in its own process.

This module imports only torch, numpy and the port (a spawned rank imports
it by name), so that a rank does not pay for importing jax.
"""

from __future__ import annotations

import os

import numpy as np
import torch

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 6e-2)}

#: family -> (ctor name, extents, seed offset), as the reference's matrix
FAMILIES = [
    ("matmul", "matmul_spec", (8, 4, 8), 1000),
    ("weighted_matmul", "weighted_matmul_spec", (4, 8, 4), 3000),
    ("transposed_matmul", "transposed_matmul_spec", (8, 8, 4), 5000),
]


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def collectives(rank, seed):
    """ring_psum / all_reduce / ring_gather_matmul / naive_gather_matmul
    for p in {1, 2, 4, 8} (a (8 / p) x p mesh, the collectives over its
    p-rank axis), hierarchical_psum on (pod 2, data 4) and a 4-stage
    pipeline on (data 2, pipe 4)."""
    from repro_torch.codegen import collectives as C
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.optim.compress import hierarchical_psum

    out = {"cases": []}
    for p in (1, 2, 4, 8):
        mesh = make_debug_mesh((8 // p, p), ("data", "model"))
        c = mesh.coordinate("model")
        rng = np.random.default_rng(seed + p)
        for case in range(3):
            m_loc = int(rng.integers(1, 5))
            k, n = int(rng.integers(1, 9)), int(rng.integers(1, 9))
            x = rng.standard_normal((p * m_loc, k)).astype(np.float32)
            w = rng.standard_normal((k, n)).astype(np.float32)
            xs = _t(x[c * m_loc:(c + 1) * m_loc])
            ring = C.ring_gather_matmul(xs, _t(w), "model", mesh)
            naive = C.naive_gather_matmul(xs, _t(w), "model", mesh)
            # rows * cols rarely divides p: the remainder chunk
            rows, cols = int(rng.integers(1, 7)), int(rng.integers(1, 11))
            y = rng.standard_normal((p, rows, cols)).astype(np.float32)
            mine = _t(y[c])
            out["cases"].append(dict(
                p=p, matmul_oracle=x @ w, ring=ring.numpy(),
                naive=naive.numpy(), sum_oracle=y.sum(0),
                ring_psum=C.ring_psum(mine, "model", mesh).numpy(),
                psum=C.all_reduce(mine, ("model",), "psum", mesh).numpy(),
                ring_all_reduce=C.all_reduce(mine, ("model",), "ring",
                                             mesh).numpy(),
                mine_after=mine.numpy(), mine_before=y[c],
            ))
    mesh = make_debug_mesh((2, 4), ("pod", "data"))
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    shard = _t(x[C.axis_index(("pod", "data"), mesh)][None])
    out["hier"] = hierarchical_psum(shard, pod_axis="pod", inner_axis="data",
                                    compress=True, mesh=mesh).numpy()
    out["hier_exact"] = hierarchical_psum(
        shard, pod_axis="pod", inner_axis="data", compress=False,
        mesh=mesh).numpy()
    mesh = make_debug_mesh((2, 4), ("data", "pipe"))
    stages, m, mb, d = 4, 6, 3, 8
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((stages, d, d)) * 0.5).astype(np.float32)
    xs = rng.standard_normal((m, mb, d)).astype(np.float32)
    s = mesh.coordinate("pipe")
    out["pipe"] = pipeline_apply(lambda w, v: torch.tanh(v @ w),
                                 _t(ws[s:s + 1]), _t(xs), "pipe",
                                 mesh).numpy()
    out["bubble"] = bubble_fraction(4, 6)
    return out


def _case_schedules(spec, v, devices, vi, offset, fam):
    """The reference matrix's schedules of one variant: a seeded order and
    blocking, plus the whole-extent one for the matmul family."""
    from repro_torch.search.space import local_extents, make_candidate

    rng = np.random.default_rng(offset + 37 * devices + vi)
    mesh_asgn = v.as_dict()
    loc = local_extents(spec, mesh_asgn)
    order = list(spec.indices)
    rng.shuffle(order)
    blocks = {
        i: int(rng.choice(
            [d for d in range(1, loc[i] + 1) if loc[i] % d == 0]))
        for i in spec.indices
    }
    cases = [(tuple(order), blocks)]
    if fam == "matmul":
        cases.append((tuple(spec.indices), {}))
    return [(o, b, make_candidate(spec, o, b, mesh=mesh_asgn,
                                  collective=v.collective).to_schedule())
            for o, b in cases]


def bind_matrix(rank, devices, shape):
    """Every mesh variant x collective of ``mesh_variants`` on the
    conventional mesh, f32 everywhere and bf16 on every third variant,
    through ``cached_compile(mesh=)``: each result against the f64 einsum
    oracle and ``core.interp`` (``evaluate_variant``)."""
    from repro_torch.codegen import CONTRACT, cached_compile
    from repro_torch.core import enumerate as E
    from repro_torch.search import (einsum_reference, mesh_for_schedules,
                                    reference_arrays, schedule_mesh_axes)
    from repro_torch.search.space import mesh_variants

    rows = []
    for fam, ctor, extents, offset in FAMILIES:
        spec = getattr(E, ctor)(*extents)
        for vi, v in enumerate(mesh_variants(spec, shape)):
            dtypes = ["float32"] if vi % 3 else ["float32", "bfloat16"]
            for ci, (order, _, sched) in enumerate(
                    _case_schedules(spec, v, devices, vi, offset, fam)):
                sharded = bool(schedule_mesh_axes(sched))
                mesh = mesh_for_schedules([sched]) if sharded else None
                assert (mesh is not None) == sharded, (fam, vi)
                arrays = reference_arrays(spec, dtype=np.float32,
                                          seed=offset + vi)
                ref = einsum_reference(spec, arrays)
                interp = E.evaluate_variant(spec, order, arrays)
                kern = cached_compile(spec, sched, interpret=True, mesh=mesh,
                                      collective=v.collective or "psum")
                for dt in (dtypes if ci == 0 else ["float32"]):
                    args = [_t(arrays[n], getattr(torch, dt))
                            for n in spec.operands]
                    n0 = CONTRACT.launches
                    got = kern(*args).double().numpy()
                    rows.append(dict(
                        fam=fam, vi=vi, ci=ci, dtype=dt, sharded=sharded,
                        assignment=str(v.assignment),
                        collective=v.collective, got=got, ref=ref,
                        interp=np.asarray(interp, np.float64),
                        launches=CONTRACT.launches - n0,
                        bound=type(kern).__name__))
    return rows


def epilogue_and_dtensor(rank):
    """On a 1x2 mesh: a reduce-sharded matmul with a bias + gelu epilogue
    (the epilogue must see the full sum, act(psum(partial) + bias)), and a
    map-sharded one called on DTensors (``local_map``)."""
    from repro_torch.codegen import Epilogue, cached_compile
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.search.space import make_candidate

    mesh = make_debug_mesh((1, 2), ("data", "model"))
    spec = matmul_spec(8, 16, 8)
    epi = Epilogue(act="gelu", bias=True)
    out = {}
    for coll in ("psum", "ring"):
        sched = make_candidate(spec, spec.indices, {},
                               mesh={"j": ("model", 2)},
                               collective=coll).to_schedule()
        kern = cached_compile(spec, sched, epilogue=epi, mesh=mesh,
                              collective=coll)
        rng = np.random.default_rng(7)
        a = _t(rng.standard_normal((8, 16)))
        b = _t(rng.standard_normal((16, 8)))
        bias = _t(rng.standard_normal(8))
        out[coll] = kern(a, b, bias=bias).numpy()
        out["inputs"] = (a.numpy(), b.numpy(), bias.numpy())
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor

    sched = make_candidate(spec, spec.indices, {},
                           mesh={"k": ("model", 2)}).to_schedule()
    kern = cached_compile(spec, sched, mesh=mesh)
    a, b, _ = (_t(x) for x in out["inputs"])
    da = distribute_tensor(a, mesh.device_mesh, [Replicate(), Replicate()])
    db = distribute_tensor(b, mesh.device_mesh, [Replicate(), Shard(1)])
    got = kern(da, db)
    out["dtensor"] = dict(is_dtensor=isinstance(got, DTensor),
                          placements=[str(p) for p in got.placements],
                          local=tuple(got.to_local().shape),
                          full=got.full_tensor().numpy())
    out["plain"] = kern(a, b).numpy()
    return out


def acceptance(rank, db_path):
    """The 2x4 acceptance path: a mesh sweep with grads, then ``ops.dense``
    under the mesh forward and backward against the unsharded run."""
    os.environ["REPRO_PLAN_DB"] = db_path
    from repro_torch import obs, ops
    from repro_torch.codegen import MeshBoundKernel
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.launch.mesh import make_debug_mesh, set_mesh
    from repro_torch.search import default_plan_db, search_schedule_with_grads

    m = d = f = 128  # the dense predicate's 128-alignment floor
    spec = matmul_spec(m, d, f)
    res = search_schedule_with_grads(
        spec, beam_width=4, topk=2, interpret=True, repeats=1,
        plan_db=default_plan_db(), mesh_shape=(2, 4), device="cpu")
    ladders = {label: [(p.source, p.collective, p.sharded,
                        p.measured_s is not None, repr(p.schedule.levels))
                       for p in r.ranked] for label, r in res.items()}
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((m, d)))
    w = _t(rng.standard_normal((d, f)))
    with set_mesh(mesh):
        kern = ops._mesh_plan_kernel(spec, torch.float32, interpret=True)

    def loss_and_grads():
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        loss = (ops.dense(a, b, interpret=True) ** 2).mean()
        loss.backward()
        return float(loss.detach()), a.grad.numpy(), b.grad.numpy()

    base = loss_and_grads()
    obs.metrics_reset()
    with set_mesh(mesh):
        sharded = loss_and_grads()
    calls = {k: v for k, v in obs.metrics_json()["counters"].items()
             if k.startswith("mesh.calls.")}
    return dict(ladders=ladders, kernel=type(kern).__name__,
                is_bound=isinstance(kern, MeshBoundKernel),
                mesh_levels=[lvl.tier for lvl in kern.schedule.levels
                             if lvl.tier.startswith("mesh:")],
                base=base, sharded=sharded, calls=calls)


def _load_tree(path):
    """A parameter tree saved as an npz of '/'-joined key paths."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def train(rank, ref_params_path, steps):
    """``make_train_step(mesh=)`` on a 2x2 mesh: deepseek-7b smoke, lr
    1e-2, ``steps`` steps from the reference's weights; the losses and a
    digest of the parameters after the last step."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as PT
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim

    cfg = get_config("deepseek-7b").smoke()
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    params = PT.params_from_reference(cfg, _load_tree(ref_params_path),
                                      device="cpu")
    ocfg = AdamWConfig(lr=1e-2, moments_dtype="float32")
    state = optim.init(params, ocfg)
    step = make_train_step(cfg, ocfg, mesh=mesh)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    losses = []
    for i in range(steps):
        b = {k: torch.as_tensor(np.asarray(v)) for k, v in
             batch_at(dc, i).items()}
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    digest = {"/".join(p): float(t.double().sum())
              for p, t in optim.leaves(params)}
    return dict(losses=losses, digest=digest)


def serve_cli(rank, db_path, flags):
    """``serve.main(flags)`` on every rank; each request's tokens and the
    mesh counters."""
    os.environ["REPRO_PLAN_DB"] = db_path
    from repro_torch import obs
    from repro_torch.launch import serve

    obs.metrics_reset()
    stats, trace, engine = serve.main(flags)
    server = getattr(engine, "server", engine)
    counters = obs.metrics_json()["counters"]
    return dict(tokens={r.rid: list(r.out_tokens) for r in trace},
                meshed=server.mesh is not None,
                calls=sum(v for k, v in counters.items()
                          if k.startswith("mesh.calls.")))


def serve_reference_weights(rank, db_path, params_path, flags):
    """``serve.run`` of the CLI ``flags`` (``--smoke``) on the
    reference's weights: greedy tokens per request."""
    os.environ["REPRO_PLAN_DB"] = db_path
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as PT

    args = serve.parse_args(flags)
    cfg = get_config(args.arch).smoke()
    params = PT.params_from_reference(cfg, _load_tree(params_path),
                                      device="cpu")
    _, trace, engine = serve.run(cfg, args, params=params)
    server = getattr(engine, "server", engine)
    return dict(tokens={r.rid: list(r.out_tokens) for r in trace},
                meshed=server.mesh is not None)
