"""The kernels' launches as ``torch.library`` custom ops.

A compiled kernel (``codegen.CompiledKernel``: B1 in every mode, plain,
epilogue, weighted, 8-bit, upcast and chain; ``codegen.FusedKernel``: B2
attention, B3 grouped rows, B4 grouped dW) launches through one of four
ops of the ``repro_torch`` namespace:

* ``repro_torch::contract(key, arrays, vectors, out_dtype)``
* ``repro_torch::attention(key, q, k, v, kv_lengths, out_dtype)``
* ``repro_torch::grouped(key, x, w, out_dtype)``
* ``repro_torch::grouped_dw(key, x, w, out_dtype)``

so that a dispatch mode sees each launch as one op (``through_op``: with
no dispatch mode active the kernel is called directly, the same launch
without the op's host time).  That is what lets

* a selective-checkpoint policy save a kernel's output
  (``models.layers.remat``: ``REPRO_REMAT_POLICY=dots`` /
  ``dots_no_batch``, ``torch.utils.checkpoint``'s
  ``create_selective_checkpoint_contexts`` is a dispatch mode), and
* a dry-run trace a whole step on fake CUDA tensors
  (``FakeTensorMode``, ``roofline.op_count``, ``launch.dryrun``): each op
  has a fake implementation and a flop formula
  (``torch.utils.flop_counter``).

An op takes tensors and scalars only, so the kernel object (its spec,
plan, epilogue and searched ``CardPlan``) stays out of the signature:
``key_of(kernel)`` registers the kernel under an integer key the first
time it launches, and the implementation looks it up (``kernel_of``).

A launch on DTensor operands is laid out by the op's sharding rule and
runs the op on each rank's local shards (``sharded_launch``, at the end of
this module).

The implementation is the kernel's own device rule: on CUDA tensors it
launches the kernel exactly as before (the same launcher, checks and
refusals, the per-stream scratch, the launch counts); on CPU tensors it
runs the kernel's plain version (``contract_ref``, ``attention_ref``,
``grouped_ref``, ``grouped_dw_ref``).  The fake implementation checks the
operands as the launcher does (device, dtype, rank and extents) and
returns an empty output of the launch's shape and dtype: it builds,
loads and launches nothing, and allocates nothing on a device.  Every
output is a fresh, contiguous tensor, never an input.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from ..dtensor import is_dtensor
from ..obs import counter

#: every kernel that has launched through an op, by key
_KERNELS: list = []

#: operand dtypes each op's kernel takes
_WIDE = (torch.float32, torch.bfloat16)
_B1_IN = _WIDE + (torch.int8, torch.float8_e4m3fn, torch.int32)
_B1_OUT = _WIDE + (torch.int32,)


def through_op(tensors) -> bool:
    """Whether a launch on ``tensors`` goes through its op (a launch on
    DTensors has been laid out by the op's sharding rule before,
    ``sharded_launch``, and asks this of its local shards): only while a
    dispatch mode is active (a selective-checkpoint policy, a
    ``FakeTensorMode``, a ``FlopCounterMode``, ``roofline.op_count``), the
    callers that need to see it as one op.  Otherwise the kernel's
    ``run`` is called directly: the same launch, without the op's host
    time (about 50 us a call on the card's host, which cost batch-1 decode
    13 % of its tokens/s; PERF.md section 6, PR 27).  A CPU call that
    autograd records through always runs the plain version directly,
    which autograd differentiates natively."""
    if not torch._C._len_torch_dispatch_stack():
        return False
    return not (torch.is_grad_enabled() and any(
        x.requires_grad and x.device.type == "cpu" for x in tensors))


def key_of(kernel) -> int:
    """The op key of a compiled kernel (``CompiledKernel`` or
    ``FusedKernel``), registered on first use."""
    key = getattr(kernel, "op_key", None)
    if key is None:
        key = len(_KERNELS)
        _KERNELS.append(kernel)
        kernel.op_key = key
    return key


def kernel_of(key: int):
    """The kernel registered under ``key``."""
    return _KERNELS[key]


# -- launches at a rank's local extents ----------------------------------------
#
# An op called on DTensors runs its implementation on each rank's local
# shards (``sharded_launch``), whose extents are not the registered
# kernel's: B1 folds its operands by its spec's extents and B3 / B4 walk
# their spec's group table.  ``local_kernel`` gives the kernel's *twin* at
# the local extents -- the root spec re-extented, its plan looked up at
# those extents (``ops._tuned_kernel``), as ``codegen.bind_mesh`` compiles
# a rank's local spec -- memoized by key and local shapes.  B2 reads its
# extents off the operands and needs none.

#: (key, local shapes) -> the re-extented root spec, or None where the
#: shapes are the spec's own
_LOCAL_SPECS: dict = {}
#: (key, local shapes, cache generation) -> twin kernel
_TWINS: dict = {}


def _shape_key(tensors) -> tuple:
    return tuple(tuple(int(d) for d in getattr(x, "shape", x))
                 for x in tensors)


def local_spec(kernel, tensors):
    """``kernel``'s root spec at the extents of ``tensors`` (its operands
    in spec order, or their shapes): the root itself where they are its
    own.  A grouped spec keeps its group sizes where its groups are
    whole, and otherwise splits into equal groups (the only layout
    ``sharded_launch`` shards rows by)."""
    shapes = _shape_key(tensors)
    key = (kernel.op_key if getattr(kernel, "op_key", None) is not None
           else id(kernel), shapes)
    if key in _LOCAL_SPECS:
        return _LOCAL_SPECS[key] or kernel.spec.root()
    root = kernel.spec.root()
    ext = dict(root.extents)
    for name, shape in zip(root.operands, shapes):
        for i, n in zip(root.operands[name], shape):
            ext[i] = n
    sizes = tuple(getattr(root, "group_sizes", ()))
    extra = {}
    if sizes:
        rows = ext["n"]
        if rows != sum(sizes):
            if len(set(sizes)) != 1 or rows % sizes[0]:
                raise ValueError(
                    f"{root.name}: {rows} local rows do not split the "
                    f"groups {sizes} into whole equal groups")
            sizes = (sizes[0],) * (rows // sizes[0])
        ext["g"] = len(sizes)
        extra["group_sizes"] = sizes
    if ext == root.extents:
        _LOCAL_SPECS[key] = None
        return root
    spec = dataclasses.replace(root, parent=None, split=None, extents=ext,
                               **extra)
    _LOCAL_SPECS[key] = spec
    return spec


def local_kernel(key: int, tensors):
    """The kernel registered under ``key``, or its twin at the local
    extents of ``tensors`` (see above); ``obs`` counts each launch at
    local extents under ``ops.local.<spec name>``."""
    from ..codegen.cache import generation

    kernel = kernel_of(key)
    spec = local_spec(kernel, tensors)
    if spec is kernel.spec.root():
        return kernel
    counter(f"ops.local.{spec.name}").inc()
    memo = (key, _shape_key(tensors), generation())
    twin = _TWINS.get(memo)
    if twin is None:
        from .. import ops

        twin = ops._tuned_kernel(
            spec, tensors[0].dtype, epilogue=getattr(kernel, "epilogue", None),
            out_dtype=kernel.out_dtype, interpret=kernel.interpret,
            sharded=True)
        _TWINS[memo] = twin
    return twin


def _check_devices(what: str, tensors) -> None:
    dev = tensors[0].device
    if any(x.device != dev for x in tensors):
        raise ValueError(f"{what} takes tensors on one device, got "
                         f"{[str(x.device) for x in tensors]}")


def _check_extents(what: str, tensors) -> None:
    for x in tensors:
        if x.dim() and (min(x.stride()) < 0
                        or max(*x.shape, *x.stride()) >= 2**31):
            raise ValueError(f"{what} takes non-negative strides and extents "
                             f"and strides below 2**31")


def _out_shape(kernel) -> List[int]:
    spec = kernel.spec
    return [spec.extents[i] for i in spec.output]


# -- B1: every mode of the contraction kernel ---------------------------------


@torch.library.custom_op("repro_torch::contract", mutates_args=())
def contract(key: int, arrays: List[torch.Tensor],
             vectors: List[torch.Tensor],
             out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of B1 (``codegen.CompiledKernel``) on ``arrays`` (the
    spec's operands) and ``vectors`` (its epilogue's, in
    ``Epilogue.vector_names`` order)."""
    return local_kernel(key, arrays).run(arrays, vectors,
                                         out_dtype).contiguous()


@contract.register_fake
def _contract_fake(key, arrays, vectors, out_dtype):
    kernel = local_kernel(key, arrays)
    what = f"contract kernel ({kernel.spec.name})"
    _check_devices(what, arrays + vectors)
    if any(x.dtype not in _B1_IN for x in arrays):
        raise TypeError(f"{what} takes float32, bfloat16, int8, fp8 or "
                        f"int32 operands, got {[x.dtype for x in arrays]}")
    if out_dtype not in _B1_OUT:
        raise TypeError(f"{what} writes float32, bfloat16 or int32, not "
                        f"{out_dtype}")
    _check_extents(what, arrays)
    return arrays[0].new_empty(_out_shape(kernel), dtype=out_dtype)


def contract_flops(spec) -> int:
    """2 x the multiply-adds of one launch of ``spec`` (a root
    ContractionSpec) as B1 folds it: ``2 * batch * M * N * K`` for a
    product (plain, epilogue, weighted, row reduce); for a chain of three
    operands, the two products of its left association."""
    ext = spec.extents
    ops = list(spec.operands.values())
    size = lambda idx: math.prod(ext[i] for i in idx)  # noqa: E731
    if len(ops) == 3 and all(len(o) == 2 for o in ops) and len(
        set(ops[0]) | set(ops[1]) | set(ops[2])
    ) == 4:
        first = set(ops[0]) | set(ops[1])
        dropped = (set(ops[0]) & set(ops[1])) - set(ops[2]) - set(
            spec.output)
        second = (first - dropped) | set(ops[2])
        return 2 * (size(first) + size(second))
    a, b = sorted(ops, key=len, reverse=True)[:2]
    return 2 * size(set(a) | set(b))


@register_flop_formula(torch.ops.repro_torch.contract)
def _contract_flop_formula(key, arrays, vectors, out_dtype, *args,
                           out_shape=None, **kwargs) -> int:
    return contract_flops(local_spec(kernel_of(key), arrays))


# -- B2: attention -------------------------------------------------------------


@torch.library.custom_op("repro_torch::attention", mutates_args=())
def attention(key: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_lengths: Optional[torch.Tensor],
              out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of B2 (``codegen.FusedKernel`` of an attention spec)."""
    # B2 reads its extents off the operands: a shard launches as it is
    return kernel_of(key).run_attention(q, k, v, kv_lengths,
                                        out_dtype).contiguous()


@attention.register_fake
def _attention_fake(key, q, k, v, kv_lengths, out_dtype):
    from ..codegen.fused_gen import ATTN_MAX_HEAD

    what = "attention kernel"
    tensors = [q, k, v] + ([] if kv_lengths is None else [kv_lengths])
    _check_devices(what, tensors)
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _WIDE or (
        out_dtype not in _WIDE
    ):
        raise TypeError(f"{what} takes and writes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype} -> {out_dtype}")
    h, s, d = q.shape
    t, e = k.shape[1], v.shape[2]
    if k.shape[0] != h or v.shape[0] != h or k.shape[2] != d or (
        v.shape[1] != t
    ):
        raise ValueError(f"{what} takes q (H, S, D), k (H, T, D) and v (H, "
                         f"T, E), got {tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if max(d, e) > ATTN_MAX_HEAD:
        raise ValueError(f"{what} takes d and e up to {ATTN_MAX_HEAD}, got "
                         f"d {d}, e {e}")
    if kv_lengths is not None and (kv_lengths.dtype != torch.int32
                                   or tuple(kv_lengths.shape) != (h,)):
        raise ValueError(f"{what} takes kv_lengths as an int32 ({h},) "
                         f"tensor")
    _check_extents(what, [q, k, v])
    return q.new_empty((h, s, e), dtype=out_dtype)


@register_flop_formula(torch.ops.repro_torch.attention)
def _attention_flop_formula(key, q, k, v, kv_lengths, out_dtype, *args,
                            out_shape=None, **kwargs) -> int:
    h, s, d = q
    t, e = k[1], v[2]
    return 2 * h * s * t * d + 2 * h * s * t * e  # QK^T and PV


# -- B3 and B4: the grouped products ---------------------------------------


def _check_grouped(what, x, w, out_dtype):
    _check_devices(what, [x, w])
    if x.dtype != w.dtype or x.dtype not in _WIDE or out_dtype not in _WIDE:
        raise TypeError(f"{what} takes two float32 or two bfloat16 operands "
                        f"and writes either, got {x.dtype}, {w.dtype} -> "
                        f"{out_dtype}")
    _check_extents(what, [x, w])


@torch.library.custom_op("repro_torch::grouped", mutates_args=())
def grouped(key: int, x: torch.Tensor, w: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of B3 (the grouped rows of ``codegen.FusedKernel``)."""
    return local_kernel(key, [x, w]).run_grouped(x, w,
                                                 out_dtype).contiguous()


@grouped.register_fake
def _grouped_fake(key, x, w, out_dtype):
    kernel = local_kernel(key, [x, w])
    _check_grouped("grouped kernel", x, w, out_dtype)
    k_ax = 2 if kernel.contract_last else 1
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[k_ax]:
        raise ValueError(f"grouped kernel takes x (rows, K) and w with K on "
                         f"axis {k_ax}, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    return x.new_empty(_out_shape(kernel), dtype=out_dtype)


@torch.library.custom_op("repro_torch::grouped_dw", mutates_args=())
def grouped_dw(key: int, x: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of B4 (the dW mode of ``codegen.FusedKernel``): ``x`` and
    ``w`` are the spec's two operands in its order."""
    return local_kernel(key, [x, w]).run_grouped(x, w,
                                                 out_dtype).contiguous()


@grouped_dw.register_fake
def _grouped_dw_fake(key, x, w, out_dtype):
    kernel = local_kernel(key, [x, w])
    _check_grouped("grouped dW kernel", x, w, out_dtype)
    if x.dim() != 2 or w.dim() != 2 or x.shape[0] != w.shape[0]:
        raise ValueError(f"grouped dW kernel takes two (N, K) operands, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    return x.new_empty(_out_shape(kernel), dtype=out_dtype)


@register_flop_formula([torch.ops.repro_torch.grouped,
                        torch.ops.repro_torch.grouped_dw])
def _grouped_flop_formula(key, x, w, out_dtype, *args, out_shape=None,
                          **kwargs) -> int:
    # each of the sum(group_sizes) rows meets one group's slab
    spec = local_spec(kernel_of(key), [x, w])
    return 2 * sum(spec.group_sizes) * math.prod(
        v for i, v in spec.extents.items() if i not in ("n", "g"))


# -- autograd: a launch replayed from a traced graph ------------------------
#
# A launch inside an ``ops`` entry point is differentiated by the
# ``grad.vjp`` wrapper around it, never through the op.  A graph traced
# below autograd (``capture``: ``make_fx``) holds the launch itself, so
# replaying it needs the op's own formula: the same cotangents as the
# wrapper (``launch_cotangents``, ``attention_cotangents``,
# ``grouped_cotangents``), on the same kernels.


def _contract_setup(ctx, inputs, output):
    key, arrays, vectors, _ = inputs
    ctx.key, ctx.n_vectors = key, len(vectors)
    ctx.wanted = [x.requires_grad for x in arrays]
    ctx.save_for_backward(*arrays)


def _contract_backward(ctx, grad):
    from ..grad.vjp import launch_cotangents

    cots = launch_cotangents(kernel_of(ctx.key), grad,
                             list(ctx.saved_tensors), ctx.wanted)
    return None, cots, [None] * ctx.n_vectors, None


def _attention_setup(ctx, inputs, output):
    key, q, k, v, kv_lengths, _ = inputs
    ctx.key, ctx.kv_lengths = key, kv_lengths
    ctx.need = (q.requires_grad, k.requires_grad, v.requires_grad)
    ctx.save_for_backward(q, k, v)


def _attention_backward(ctx, grad):
    from ..grad.vjp import attention_cotangents

    kernel = kernel_of(ctx.key)
    q, k, v = ctx.saved_tensors
    dq, dk, dv = attention_cotangents(
        q, k, v, grad, ctx.kv_lengths, causal=bool(kernel.spec.root().causal),
        interpret=kernel.interpret, use_kernel=True, need=ctx.need)
    return None, dq, dk, dv, None, None


def _grouped_setup(ctx, inputs, output):
    key, x, w, _ = inputs
    ctx.key, ctx.need = key, (x.requires_grad, w.requires_grad)
    ctx.save_for_backward(x, w)


def _grouped_backward(ctx, grad):
    from ..grad.vjp import grouped_cotangents

    kernel = kernel_of(ctx.key)
    if kernel.contract_last:
        raise RuntimeError("a grouped dX launch has no gradient rule of its "
                           "own; differentiate through ops.grouped_dense")
    x, w = ctx.saved_tensors
    dx, dw = grouped_cotangents(
        x, w, grad, tuple(kernel.spec.root().group_sizes),
        interpret=kernel.interpret, use_kernel=True, need=ctx.need)
    return None, dx, dw, None


torch.library.register_autograd("repro_torch::contract", _contract_backward,
                                setup_context=_contract_setup)
torch.library.register_autograd("repro_torch::attention",
                                _attention_backward,
                                setup_context=_attention_setup)
torch.library.register_autograd("repro_torch::grouped", _grouped_backward,
                                setup_context=_grouped_setup)


# -- what a checkpoint policy reads --------------------------------------------

#: the op overloads the kernels call
CONTRACT_OP = torch.ops.repro_torch.contract.default
ATTENTION_OP = torch.ops.repro_torch.attention.default
GROUPED_OP = torch.ops.repro_torch.grouped.default
GROUPED_DW_OP = torch.ops.repro_torch.grouped_dw.default

#: the ops of this module, each a product
PRODUCT_OPS = (CONTRACT_OP, ATTENTION_OP, GROUPED_OP, GROUPED_DW_OP)


def product_batched(func, args) -> Optional[bool]:
    """Whether the op ``func`` called on ``args`` is a product with batch
    dimensions (True), one without (False), or no product (None).

    The products are this module's ops and ``aten.mm``, ``addmm``,
    ``bmm`` and ``baddbmm`` (what ``torch.matmul`` and ``torch.einsum``
    lower to).  A B1 launch has batch dimensions where its spec folds a
    batch group (``batched_dense``, attention's backward products);
    attention (B2) has its heads; the grouped products (B3, B4) have
    none, as the reference's ragged GEMM.  A ``bmm`` of batch 1 (an
    einsum over no batch index) has none.
    """
    aten = torch.ops.aten
    packet = getattr(func, "overloadpacket", None)
    if packet in (aten.mm, aten.addmm):
        return False
    if packet in (aten.bmm, aten.baddbmm):
        a = args[1] if packet is aten.baddbmm else args[0]
        return a.shape[0] > 1
    if func is CONTRACT_OP:
        from ..codegen.cuda_gen import _classify, _fold

        spec = kernel_of(args[0]).spec.root()
        fold = _classify(spec)
        if fold.kind == "chain":
            return False
        batch = _fold(spec.operands[fold.a], spec.operands[fold.b],
                      fold.target)[0]
        return math.prod(spec.extents[i] for i in batch) > 1
    if func is ATTENTION_OP:
        return True
    if func in (GROUPED_OP, GROUPED_DW_OP):
        return False
    return None


# -- DTensor sharding rules ------------------------------------------------------
#
# A launch on DTensor operands runs on each rank's shards, laid out by the
# op's sharding rule: the op's strategies for ONE mesh dimension (an output
# placement and one placement per tensor operand, flattened: ``contract``'s
# arrays, then its vectors), expanded over every dimension of the mesh.
# They are derived from the spec's index sets, as ``codegen.mesh_gen``'s
# partition specs are:
#
# * replicate everything;
# * shard an output index on every operand that carries it and on the
#   output (epilogue vectors follow the last output axis they index);
# * shard a contracted index on every operand that carries it: the output
#   is then ``Partial`` (summed where a later op needs it), offered only
#   for an identity epilogue -- a bias or an activation must see the whole
#   sum, the reference's ``act(psum(partial) + bias)``;
#
# chain mode offers no contracted index (its intermediate is rounded
# inside the kernel); B2 shards its heads only (the causal mask reads
# absolute rows); B3 / B4 shard their rows with the groups only where the
# groups are equal and the ranks that split them divide G
# (``grouped_valid``), and otherwise treat the row and group axes as
# whole.  ``sharded_launch`` takes the layout that moves the fewest bytes
# to reach (the operands' redistribution, and the sum a ``Partial`` output
# will need), redistributes the operands to it -- whatever a strategy
# does not offer is redistributed, never computed on a wrong layout --
# runs the op on the local shards (its kernel's twin at the local
# extents, ``local_kernel``) and returns a DTensor of the layout's output
# placements.  The kernels apply the rule themselves rather than through
# DTensor's ``register_sharding``: DTensor's dispatch finds an op's mesh
# in its first argument, here the kernel key (PyTorch 2.11).


def as_dtensors(tensors):
    """``tensors`` with each plain tensor made a replicated DTensor on
    the mesh of the first DTensor among them (a plain operand beside
    sharded ones is taken as replicated, as ``mesh_gen`` takes it)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next(x.device_mesh for x in tensors if is_dtensor(x))
    return [x if x is None or is_dtensor(x) else DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for x in tensors]


def _index_strategies(spec, names, n_vectors, *, partial: bool,
                      skip=()):
    from torch.distributed.tensor import Partial, Replicate, Shard

    R = Replicate()
    out = spec.output
    rules = [([R], [R] * (len(names) + n_vectors))]
    for i in spec.indices:
        if i in skip or not any(i in spec.operands[n] for n in names):
            continue
        arrays = [Shard(spec.operands[n].index(i)) if i in spec.operands[n]
                  else R for n in names]
        if i in out:
            vec = Shard(0) if i == out[-1] else R
            rules.append(([Shard(out.index(i))], arrays + [vec] * n_vectors))
        elif partial:
            rules.append(([Partial()], arrays + [R] * n_vectors))
    return rules


def contract_strategies(kernel, n_vectors: int):
    """B1's single-dimension strategies for ``kernel``."""
    from ..codegen.cuda_gen import _classify

    spec = kernel.spec.root()
    epi = kernel.epilogue
    chain = _classify(spec).kind == "chain"
    identity = epi is None or epi.is_identity
    return _index_strategies(spec, tuple(spec.operands), n_vectors,
                             partial=identity and not chain)


def attention_strategies(n_tensors: int):
    """B2's single-dimension strategies: replicated, or heads (dim 0 of q,
    k, v, ``kv_lengths`` and the output)."""
    from torch.distributed.tensor import Replicate, Shard

    R, S = Replicate(), Shard(0)
    return [([R], [R] * n_tensors), ([S], [S] * n_tensors)]


def grouped_strategies(kernel):
    """B3's and B4's single-dimension strategies for ``kernel``: the
    contracted and free indices as B1's, plus the rows sharded with their
    groups (``Shard(0)`` on the rows and on the group axis, wherever that
    sits) where the groups are equal, ``(C,) * G`` (``grouped_valid``
    keeps the layouts that split G evenly)."""
    from torch.distributed.tensor import Shard

    spec = kernel.spec.root()
    names = tuple(spec.operands)
    rules = _index_strategies(spec, names, 0, partial=True, skip=("n", "g"))
    if len(set(spec.group_sizes)) == 1:
        arrays = [Shard(spec.operands[n].index("n" if "n" in spec.operands[n]
                                               else "g")) for n in names]
        out = spec.output
        rules.append(([Shard(out.index("n" if "n" in out else "g"))],
                      arrays))
    return rules


def grouped_valid(kernel, mesh, out_placements) -> bool:
    """Whether a grouped layout keeps whole groups on every rank: the
    ranks that split the output's row (or group) axis divide G."""
    spec = kernel.spec.root()
    d = spec.output.index("n" if "n" in spec.output else "g")
    ranks = math.prod(mesh.size(i) for i, p in enumerate(out_placements)
                      if p.is_shard(d))
    return len(spec.group_sizes) % ranks == 0


def _move_bytes(x, have, want) -> int:
    """Bytes a rank sees move to bring ``x`` from placement ``have`` to
    ``want`` on one mesh dim: nothing to stay or to slice a replicated
    tensor, the whole tensor to gather, re-shard or sum it."""
    if have == want or (have.is_replicate() and want.is_shard()):
        return 0
    return x.numel() * x.element_size()


def choose_layout(tensors, rules, out_bytes: int, valid=None):
    """(output placements, each operand's placements): the expansion of
    the single-dimension ``rules`` over the operands' mesh that moves the
    fewest bytes (a ``Partial`` output counts the sum it will need), ties
    going to the earlier, less partial layout; ``valid(placements)``
    filters the output layouts."""
    mesh = tensors[0].device_mesh
    best = None
    for combo in itertools.product(range(len(rules)), repeat=mesh.ndim):
        out_pl = [rules[r][0][0] for r in combo]
        if valid is not None and not valid(out_pl):
            continue
        cost = 0
        for d, r in enumerate(combo):
            cost += sum(_move_bytes(x, x.placements[d], want)
                        for x, want in zip(tensors, rules[r][1]))
            if out_pl[d].is_partial():
                cost += out_bytes
        rank = (cost, sum(p.is_partial() for p in out_pl), combo)
        if best is None or rank < best[0]:
            best = (rank, out_pl, [[rules[r][1][i] for r in combo]
                                   for i in range(len(tensors))])
    if best is None:
        raise ValueError("no layout of the op's sharding rule fits this "
                         "mesh")
    return best[1], best[2]


def sharded_launch(name: str, tensors, rules, out_shape, out_dtype, run,
                   valid=None):
    """One launch of op ``name`` on DTensor (or plain, taken as
    replicated) ``tensors`` by its sharding rule: the layout
    ``choose_layout`` picks, the operands redistributed to it, ``run`` on
    the local shards (the op, or its kernel directly), and the output as
    a DTensor of ``out_shape`` on the layout's output placements.  ``obs``
    counts each call under ``ops.dtensor.<name>``."""
    from ..dtensor import from_local

    present = [x for x in tensors if x is not None]
    placed = as_dtensors(present)
    mesh = placed[0].device_mesh
    nbytes = math.prod(out_shape) * torch.empty((), dtype=out_dtype
                                                ).element_size()
    out_pl, in_pl = choose_layout(placed, rules, nbytes, valid)
    local = iter([x.redistribute(mesh, pl).to_local().contiguous()
                  for x, pl in zip(placed, in_pl)])
    counter(f"ops.dtensor.{name}").inc()
    out = run([None if x is None else next(local) for x in tensors])
    out = from_local(out, mesh, out_pl, out_shape)
    if torch._C._current_autograd_node() is not None and any(
            p.is_partial() for p in out_pl):
        # a launch in a backward pass (a derived spec's) sums its Partial
        # output at once: autograd adds the gradients of a tensor used
        # twice, and DTensor cannot add a Partial to a sharded one
        from torch.distributed.tensor import Replicate

        out = out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in out_pl])
    return out


def sharded_contract(kernel, arrays, vectors, out_dtype):
    """B1 on DTensor operands (``CompiledKernel.__call__``)."""
    key, n = key_of(kernel), len(arrays)

    def run(local):
        a, v = local[:n], local[n:]
        if through_op(local):
            return CONTRACT_OP(key, a, v, out_dtype)
        return local_kernel(key, a).run(a, v, out_dtype)

    return sharded_launch("contract", list(arrays) + list(vectors),
                          contract_strategies(kernel, len(vectors)),
                          _out_shape(kernel), out_dtype, run)


def sharded_attention(kernel, q, k, v, lengths, out_dtype):
    """B2 on DTensor operands (``FusedKernel.__call__``)."""
    key = key_of(kernel)

    def run(local):
        if through_op([x for x in local if x is not None]):
            return ATTENTION_OP(key, *local, out_dtype)
        return kernel.run_attention(*local, out_dtype)

    tensors = [q, k, v, lengths]
    return sharded_launch(
        "attention", tensors, attention_strategies(3 + (lengths is not None)),
        (q.shape[0], q.shape[1], v.shape[2]), out_dtype, run)


def sharded_grouped(kernel, x, w, out_dtype):
    """B3 or B4 on DTensor operands (``FusedKernel.__call__``)."""
    key = key_of(kernel)
    op = GROUPED_DW_OP if kernel.dw else GROUPED_OP

    def run(local):
        if through_op(local):
            return op(key, *local, out_dtype)
        return local_kernel(key, local).run_grouped(*local, out_dtype)

    return sharded_launch(
        "grouped_dw" if kernel.dw else "grouped", [x, w],
        grouped_strategies(kernel), _out_shape(kernel), out_dtype, run,
        valid=lambda pl: grouped_valid(kernel, x.device_mesh
                                       if is_dtensor(x) else w.device_mesh,
                                       pl))
