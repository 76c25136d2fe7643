"""The port's sharding rules, logical axes and bundle shardings against
the reference's, with no processes.

* ``launch.sharding.spec_for`` / ``batch_spec_for`` / ``quantized_sharding``
  give, entry for entry (``Placements.spec``), the reference's
  ``PartitionSpec`` for every leaf of all ten configs' parameter and cache
  axes trees, on stand-in meshes 2x2, 16x16 and 2x16x16 (the reference's
  functions read only ``axis_names`` and ``shape``), under the ``tp``,
  ``dp`` and ``zero1`` profiles, with and without ``REPRO_UNEMBED_FIX``;
* each ``Placements`` is the DTensor placement list its spec implies;
* ``api.param_axes(cfg)`` equals the reference's ``api.init(cfg, key)[1]``
  and ``api.cache_axes(cfg)`` the reference's, for every config;
* the train, prefill and serve bundles' ``out_shardings`` equal the
  reference's leaf for leaf (the reference's built on a
  ``jax.sharding.AbstractMesh``, the port's on a ``MeshShape``).
"""

from __future__ import annotations

import functools
import types

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import sharding as RS
from repro.launch import steps as RSteps
from repro.models.api import get_api as ref_api
from repro_torch.codegen.mesh_gen import Placements
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import sharding as PS
from repro_torch.launch import steps as PSteps
from repro_torch.launch.mesh import (MeshShape, make_production_mesh,
                                     mesh_shape_descriptor)
from repro_torch.models.api import get_api
from repro_torch.optim.quant import BLOCK

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
PROFILES = ("tp", "dp", "zero1")


class StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """(path -> shape, path -> logical axes) of the reference's full
    config, abstractly (``jax.eval_shape``, nothing allocated)."""
    rc = ref_config(arch)
    shapes, axes = RSteps.eval_params(rc, ref_api(rc))
    return ({p: tuple(s.shape) for p, s in _flat(shapes)},
            dict(_flat(axes)))


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, batch=8, max_len=64):
    rc = ref_config(arch)
    api = ref_api(rc)
    shapes = jax.eval_shape(lambda: api.cache_init(rc, batch, max_len))
    return {p: tuple(s.shape) for p, s in _flat(shapes)}


def _same(port: Placements, ref, what):
    """The port's placements against the reference's ``PartitionSpec`` (or
    a ``NamedSharding``'s)."""
    assert isinstance(port, Placements), what
    ref = getattr(ref, "spec", ref)
    assert port.spec == tuple(ref), (what, port.spec, tuple(ref))


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_equals_the_reference_on_every_leaf(arch, profile,
                                                     monkeypatch):
    shapes, axes = _ref_params(arch)
    port_shapes = {p: tuple(t.shape) for p, t in _flat(
        get_api(get_config(arch)).init(get_config(arch), None,
                                       torch.device("meta")))}
    assert port_shapes == shapes
    cache = {p: tuple(t.shape) for p, t in _flat(
        get_api(get_config(arch)).cache_init(get_config(arch), 8, 64,
                                              device="meta"))}
    assert cache == _ref_cache(arch)
    cache_axes = dict(_flat(ref_api(ref_config(arch)).cache_axes(
        ref_config(arch))))
    monkeypatch.setenv("REPRO_SHARDING", profile)
    for fix in ("0", "1"):
        monkeypatch.setenv("REPRO_UNEMBED_FIX", fix)
        for name, (shape, names) in MESHES.items():
            mesh, ref_mesh = StandIn(shape, names), AbstractMesh(shape, names)
            for path, dims in shapes.items():
                what = (arch, profile, fix, name, path)
                _same(PS.spec_for(mesh, axes[path], dims),
                      RS.spec_for(mesh, axes[path], dims), what)
                # an int8 moment of the leaf: its flat block axis
                nblocks = -(-int(torch.tensor(dims).prod()) // BLOCK)
                q = types.SimpleNamespace(
                    q=types.SimpleNamespace(shape=(nblocks, BLOCK)))
                got, want = (PS.quantized_sharding(mesh, q),
                             RS.quantized_sharding(ref_mesh, q))
                assert set(got) == set(want) == {"q", "scale"}
                for k in got:
                    _same(got[k], want[k], what + (k,))
            for path, dims in cache.items():
                ax = _cache_axes_of(cache_axes, path)
                _same(PS.spec_for(mesh, ax, dims),
                      RS.spec_for(mesh, ax, dims), (arch, path, name))


def _cache_axes_of(axes, path):
    """The reference's cache-axes entry for a cache leaf (the trees share
    their structure; ``steps._map_axes_over`` walks them so)."""
    for n in range(len(path), -1, -1):
        if path[:n] in axes:
            return axes[path[:n]]
    raise KeyError(path)


@pytest.mark.parametrize("profile", PROFILES)
def test_batch_spec_for_equals_the_reference(profile, monkeypatch):
    monkeypatch.setenv("REPRO_SHARDING", profile)
    shapes = [(256, 4096), (8, 1), (1, 524288), (3, 32768, 16), (32,),
              (2, 4096, 151936), (16, 4097)]
    for name, (shape, names) in MESHES.items():
        mesh = StandIn(shape, names)
        for shp in shapes:
            for seq_axis in (None, 1):
                _same(PS.batch_spec_for(mesh, shp, seq_axis=seq_axis),
                      RS.batch_spec_for(mesh, shp, seq_axis=seq_axis),
                      (name, shp, seq_axis))


def test_placements_are_the_spec_per_mesh_dimension():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StandIn((2, 16, 16), ("pod", "data", "model"))
    p = PS.spec_for(mesh, ("embed", "mlp"), (4096, 11008))
    assert p.spec == ("data", "model")
    assert list(p) == [Replicate(), Shard(0), Shard(1)]
    q = PS.batch_spec_for(mesh, (64, 128))
    assert q.spec == (("pod", "data"),)
    assert list(q) == [Shard(0), Shard(0), Replicate()]
    assert list(PS.spec_for(mesh, None, (3,))) == [Replicate()] * 3
    with pytest.raises(ValueError, match="lacks"):
        Placements(("expert",), ("data", "model"))


def test_production_meshes_are_shapes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (single.axis_names, dict(single.shape), single.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)
    assert mesh_shape_descriptor(multi) == "2x16x16"
    assert mesh_shape_descriptor(MeshShape((1, 2), ("data", "model"))) == \
        "1x2"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_the_references(arch):
    """``param_axes`` is the twin of the reference's init on the smoke
    config (a real draw) and of the full config (abstract); ``cache_axes``
    equals the reference's."""
    rc, pc = ref_config(arch).smoke(), get_config(arch).smoke()
    _, ref_axes = ref_api(rc).init(rc, jax.random.key(0))
    assert dict(_flat(get_api(pc).param_axes(pc))) == dict(_flat(ref_axes))
    assert dict(_flat(get_api(get_config(arch)).param_axes(
        get_config(arch)))) == _ref_params(arch)[1]
    for c, r in ((pc, rc), (get_config(arch), ref_config(arch))):
        assert get_api(c).cache_axes(c) == ref_api(r).cache_axes(r)


def _specs(x):
    """Placements / NamedSharding leaves as spec tuples, in a plain tree."""
    if isinstance(x, Placements):
        return x.spec
    if isinstance(x, dict):
        return {k: _specs(v) for k, v in x.items()}
    if hasattr(x, "q") and hasattr(x, "scale"):
        return {"q": _specs(x.q), "scale": _specs(x.scale)}
    if isinstance(x, tuple) and not hasattr(x, "spec"):
        return [_specs(v) for v in x]
    return tuple(x.spec)


BUNDLE_CASES = [
    ("qwen3-8b", "train", 32, 8, "0"),
    ("qwen3-8b", "train", 32, 8, "1"),
    ("kimi-k2-1t-a32b", "train", 32, 8, "1"),
    ("qwen3-8b", "prefill", 32, 8, "0"),
    ("granite-34b", "decode", 64, 8, "0"),
    ("zamba2-2.7b", "decode", 64, 8, "0"),
    ("whisper-base", "prefill", 64, 8, "0"),
]


@pytest.mark.parametrize("arch,kind,seq,batch,int8", BUNDLE_CASES)
def test_bundle_out_shardings_equal_the_references(arch, kind, seq, batch,
                                                   int8, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setenv("REPRO_OPT_INT8", int8)
    rc, pc = ref_config(arch).smoke(), get_config(arch).smoke()
    ref_mesh = AbstractMesh((2, 2), ("data", "model"))
    port_mesh = MeshShape((2, 2), ("data", "model"))
    build = {"train": (RSteps.train_bundle, PSteps.train_bundle),
             "prefill": (RSteps.prefill_bundle, PSteps.prefill_bundle),
             "decode": (RSteps.serve_bundle, PSteps.serve_bundle)}[kind]
    ref = build[0](ref_mesh, rc, RefShape("t", seq, batch, kind))
    with FakeTensorMode():
        port = build[1](pc, ShapeConfig("t", seq, batch, kind),
                        device="cpu", mesh=port_mesh)
    assert port.static_name == ref.static_name
    assert _specs(port.out_shardings) == _specs(ref.out_shardings)
    for name, spec in PSteps.batch_shardings(
            port_mesh, pc, ShapeConfig("t", seq, batch, kind)).items():
        assert spec.spec == tuple(RS.batch_spec_for(
            ref_mesh, dict(RSteps.batch_spec(
                rc, RefShape("t", seq, batch, kind)))[name][0],
            seq_axis=1)), name
