"""KernelPlan -> CUDA contraction kernel: the port's ``pallas_gen``.

The reference lowers a (spec, schedule) pair to a Pallas kernel whose grid
and blocks follow the ``KernelPlan``.  The port lowers every product-reduce
spec onto hand-written Hopper kernels, B1's modes; f32 and bf16 operands
run ``csrc/contract.cu``, the strided batched contraction

    C[b, m, n] = sum_k A[b, m, k] * B[b, k, n]      (f32 accumulation)

by folding two operands' indices into four groups:

    batch  indices in A, B and the output
    m      output indices of A only
    n      output indices of B only
    k      reduce indices shared by A and B

A reduce index held by one operand only is summed out first (in the
accumulator's type, as the reference's ``_contract`` sums it), the
operands are passed as permuted views with their strides (a copy only where a group of indices cannot be
flattened into one stride), and the (batch, m, n) result is permuted back
to ``spec.output`` order.  Matmul, transposed, batched and tensor
contractions all run on the same kernel.  A bf16 product at M >= 64
whose operands TMA can read runs the ring body, plain or with its fused
modes (``contract_body``: each operand with unit stride on one of its two
axes, so the backward's transposed operands go as the views they are); a
plain one at M < 64 (decode) the narrow body, C^T = W^T x^T on the same
ring (``narrow_tiles``); an f32 product whose x is k- or m-contiguous the
tc32 body (3xTF32 on wgmma, the same swap; an m-contiguous x, such as
``matmul.dB``'s x^T, is transposed in shared memory as it is split; a
plain one at M < 64 with x k-contiguous takes a narrow x tile,
``tc32_tiles``; the k-scale prologue and the row reduce keep the FMA
pipes); on the mma.sync body (unaligned operands, the fused modes at M <
64) an operand whose innermost folded axis is not unit-stride is copied
contiguous first, so that body takes its 16-byte loads.

Three-operand specs are classified by their index sets, not their names
(``_classify``), into the kernel's extra modes, one launch each:

    vector      a 1-D operand whose index lies in a group of the other two's
                product: on k it scales the A tile as it is staged (in f32,
                rounded once to the operand type: the weighted spec
                A_ij B_jk g_j -> ik, paper eq 2); on batch, m or n it
                multiplies the accumulator in the epilogue (the derived
                ``weighted_matmul.dA`` and ``.dB``);
    row reduce  a third operand T holding the product's (m, n) indices and
                an output that is n alone: C[n] = sum_m (A.B)[m, n] T[m, n]
                (the derived ``weighted_matmul.dg``,
                dg_j = sum_i A_ij (dout . B^T)_ij), summed deterministically
                (per-CTA partial rows, then the last CTA of each column
                block adds them in order; no float atomics);
    chain       three matrices X(r,p), Y(p,q), Z(q,c) into (r, c), two
                reductions: ``chain_matmul`` A@B@C and its derived ``.dA``,
                ``.dB``, ``.dC`` (``csrc/contract_chain.cu``; the
                intermediate X.Y never reaches device memory).  Of the two
                associations the kernel runs the one that recomputes less,
                the counterpart of the reference's smallest intermediate
                first.

Int8 and fp8 specs (``QuantMeta``) accumulate as the reference's do
(``pallas_gen.py:219-226``): int32 for int8, exact; f32 for fp8.  A
product of two 8-bit operands runs on the tensor cores
(``csrc/contract_q8.cu``, ``CONTRACT_INT8`` / ``CONTRACT_FP8``), and so
do their vector and row-reduce modes (the weighted family) where every
operand is 8-bit of the spec's format and the ring takes the operands
after K-major copies (``eight_bit_route``); fp8's k-scale runs on
contract.cu's bf16 k-scale ring over exact bf16 upcasts; the rest upcasts
on the CUDA cores (``CONTRACT_UPCAST``); the quantized chain runs the
chain kernel's CUDA-core body.  The launchers are in ``codegen.modes``.

The ``Epilogue`` (``codegen.epilogue``: dequant, scale, bias,
normalization, activation) runs on the accumulator, converted to f32,
before the one store; its vectors run along ``spec.output[-1]``, which the
kernel finds in whichever folded group (batch, m or n) holds it.
``CompiledKernel.__call__`` takes them by keyword, as the reference's
does.  The output dtype follows the reference's rule
(``pallas_gen.py:246-261``): ``out_dtype`` when given; else for an int8
spec int32 and for an fp8 spec f32, or f32 under a dequant epilogue; else
the first operand's.

The plan still decides shapes (operand checks, the memo key), but not the
kernel's grid: the reference tuner scores a TPU and often picks a single
block, while the CUDA kernels tile the output into their own CTAs (128 x
128 or 128 x 256 on the ring, ``ring_tiles``; 128 of N by 8 to 64 tokens
on the narrow body, ``narrow_tiles``; 64 x 128 on the mma.sync body; 128
of N by 8 to 128 of M on the tc32 body, ``tc32_tiles``; 128 x 64 on the
FMA pipes for f32).
A searched ``CardPlan`` (the plan DB's ``card`` field, ``search``) takes
the place of the ring's, the narrow body's or tc32's heuristic tile width
and K split where a launch runs its body; a fused spec's plan is a
``fused_gen.FusedPlan``, which ``compile_fused`` hands to its kernel.

Devices: on a CUDA tensor the call launches a kernel (or raises); on a
CPU tensor it runs ``contract_ref``, the plain PyTorch version.  Nothing
falls back from one to the other.  Fused specs (``fused_kind`` set) go to
``fused_gen.compile_fused`` (flash attention, kernel B2; the grouped
matmul, kernels B3 and B4).  ``compile(..., mesh=)`` binds the kernel to a
mesh (``mesh_gen.bind_mesh``): a ``MeshBoundKernel`` that runs B1 on each
rank's shards and sums over the reduced mesh axes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.enumerate import ContractionSpec, einsum_formula
from ..core.schedule import Schedule
from .cache import dtype_name
from .epilogue import Epilogue
from .modes import (
    CONTRACT_CHAIN,
    CONTRACT_FP8,
    CONTRACT_INT8,
    CONTRACT_UPCAST,
    ChainPlan,
    Q8Plan,
    VecArg,
    _Vec,
    chain_cluster,
    chain_tile_n,
    q8_ring_refusal,
    set_epilogue,
    set_vec,
    tma_operand,
)
from .plan import KernelPlan, build_plan

#: operand / output dtypes the kernel takes, with its dtype codes
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: vector dtypes contract.cu reads as they are (no cast kernel before a
#: launch)
_VEC_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype_name(dtype))


def _int_accum(spec: ContractionSpec) -> bool:
    quant = getattr(spec.root(), "quant", None)
    return quant is not None and quant.accum == "int32"


def _greedy_fold(spec: ContractionSpec, arrays: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """The reference's ``_contract`` fold (``pallas_gen.py:42-108``):
    operands are contracted pairwise, the pair with the smallest result
    first; an index shared with a later operand or the output stays."""
    letters = {i: chr(ord("a") + n) for n, i in enumerate(spec.root().indices)}
    sub = lambda axes: "".join(letters[i] for i in axes)  # noqa: E731
    out = spec.output
    terms = [(arrays[n], list(spec.operands[n])) for n in spec.operands]
    while len(terms) > 1:
        best = None
        for x in range(len(terms)):
            for y in range(x + 1, len(terms)):
                (a, ax), (b, bx) = terms[x], terms[y]
                rest = {i for z, (_, axs) in enumerate(terms)
                        if z not in (x, y) for i in axs}
                shared = [i for i in ax if i in bx]
                batch = [i for i in shared if i in out or i in rest]
                res = (batch + [i for i in ax if i not in shared]
                       + [i for i in bx if i not in shared])
                sizes = {**dict(zip(bx, b.shape)), **dict(zip(ax, a.shape))}
                elems = math.prod(sizes[i] for i in res)
                if best is None or elems < best[0]:
                    best = (elems, x, y, res)
        _, x, y, res = best
        (a, ax), (b, bx) = terms[x], terms[y]
        val = torch.einsum(f"{sub(ax)},{sub(bx)}->{sub(res)}", a, b)
        terms = [t for z, t in enumerate(terms) if z not in (x, y)]
        terms.insert(0, (val, res))
    val, axes = terms[0]
    extra = [i for i in axes if i not in out]
    if extra:  # reduce axes touched by a single operand
        val = val.sum(dim=[axes.index(i) for i in extra])
        axes = [i for i in axes if i not in extra]
    return val.permute([axes.index(i) for i in out])


def _accumulate(spec: ContractionSpec, operands) -> torch.Tensor:
    """The spec's product-sum in its accumulator: f32 over f32 upcasts, or
    int32 for an int8 spec.  Int32 sums are exact here (int64 on the CPU;
    float64 on the card, which has no integer matmul, exact below 2**53),
    then wrap to int32 as the kernel's and the reference's do.  A
    three-operand spec folds as the reference's ``_contract`` does, never
    through an (i, j, k) intermediate: a vector multiplies the operand
    that holds its index; a row reduce forms the product of the other two
    on T's indices, then multiplies by T and sums; the chain contracts the
    pair with the smaller intermediate first."""
    dev = operands[0].device
    wide = torch.float32
    if _int_accum(spec):
        wide = torch.int64 if dev.type == "cpu" else torch.float64
    arrays = {name: o.to(wide) for name, o in zip(spec.operands, operands)}
    if len(arrays) <= 2:
        acc = torch.einsum(einsum_formula(spec), *arrays.values())
    else:
        acc = _fold_three(spec, arrays)
    if wide is not torch.float32:
        acc = acc.to(torch.int64).to(torch.int32)
    return acc


def _fold_three(spec: ContractionSpec, arrays) -> torch.Tensor:
    fold = _classify(spec)
    if fold.kind == "chain":
        return _greedy_fold(spec, arrays)
    ops = spec.operands
    letters = {i: chr(ord("a") + n) for n, i in enumerate(spec.root().indices)}
    sub = lambda axes: "".join(letters[i] for i in axes)  # noqa: E731
    extra = arrays.pop(fold.extra)
    if fold.kind == "vector":
        (j,) = ops[fold.extra]
        x = fold.a if j in ops[fold.a] else fold.b
        arrays[x] = arrays[x] * extra.reshape(
            [spec.extents[j] if i == j else 1 for i in ops[x]])
    a, b = arrays[fold.a], arrays[fold.b]
    ia, ib = sub(ops[fold.a]), sub(ops[fold.b])
    if fold.kind == "vector":
        return torch.einsum(f"{ia},{ib}->{sub(spec.output)}", a, b)
    it = sub(fold.target)
    prod = torch.einsum(f"{ia},{ib}->{it}", a, b)
    return torch.einsum(f"{it},{it}->{sub(spec.output)}", prod, extra)


def contract_ref(spec: ContractionSpec, *operands: torch.Tensor,
                 out_dtype, epilogue: Optional[Epilogue] = None,
                 vectors: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """The plain PyTorch version: the product-sum in the spec's
    accumulator (``_accumulate``), then the epilogue with its vectors
    along the last output axis (on the accumulator converted to f32),
    then the cast."""
    acc = _accumulate(spec, operands)
    if epilogue is not None and not epilogue.is_identity:
        lead = (1,) * (len(spec.output) - 1)
        acc = epilogue.apply(acc.float(), {
            name: vectors[name].float().reshape(lead + (-1,))
            for name in epilogue.vector_names
        })
    return acc.to(_torch_dtype(out_dtype))


class _Params(ctypes.Structure):
    """``struct ContractParams`` of contract.cu, field for field."""

    _fields_ = (
        [("A", ctypes.c_void_p), ("B", ctypes.c_void_p),
         ("C", ctypes.c_void_p)]
        + [(f, ctypes.c_longlong) for f in (
            "batch", "M", "N", "K", "sAb", "sAm", "sAk", "sBb", "sBk", "sBn",
            "sCb", "sCm", "sCn")]
        + [(f, _Vec) for f in ("kscale", "mul", "scale", "bias", "mean",
                               "var")]
        + [("T", ctypes.c_void_p), ("sTm", ctypes.c_longlong),
           ("sTn", ctypes.c_longlong), ("partial", ctypes.c_void_p),
           ("counter", ctypes.c_void_p), ("eps", ctypes.c_float),
           ("act", ctypes.c_int), ("in_dtype", ctypes.c_int),
           ("out_dtype", ctypes.c_int), ("body", ctypes.c_int),
           ("tile_n", ctypes.c_int), ("splits", ctypes.c_int),
           ("pad", ctypes.c_int)]
    )


#: the ring body's CTA rows (checked against contract.cu's R_BM at load;
#: the narrow body's columns of N a CTA) and K step (R_BK; the kernel
#: refuses a split that leaves a CTA no step)
RING_BM, RING_BK = 128, 64
#: the fused ring's tile width in its k-scale and row-reduce modes
#: (contract.cu's R_FUSED_BN, checked at load)
RING_FUSED_BN = 128
#: an H100 SXM's streaming multiprocessors (the ring's grid is sized
#: against the card's own count at launch)
H100_SMS = 132
#: the narrow body's token widths (wgmma m64nBNk16's B), its CTAs resident
#: on one SM (two 104 KB rings), the fewest K steps a split takes and the
#: most splits a tile
NARROW_WIDTHS = (8, 16, 32, 64)
NARROW_PER_SM, NARROW_MIN_STEPS, NARROW_MAX_SPLITS = 2, 2, 32
#: the bodies a launch may be forced onto: bf16 ``ring``, ``narrow`` and
#: ``mma``; f32 ``tc32`` and ``fma``
BODIES = ("ring", "narrow", "mma", "tc32", "fma")
#: ``ContractParams.body``'s code of each body (0: mma.sync for bf16 and
#: the FMA pipes for f32, by the operands' dtype)
BODY_CODES = {"ring": 1, "narrow": 2, "mma": 0, "tc32": 3, "fma": 0}


def contract_body(a: torch.Tensor, b: torch.Tensor, *,
                  plain: bool = True, kscale: Optional[VecArg] = None,
                  row_reduce: bool = False) -> str:
    """Which body of ``contract.cu`` takes a (batch, M, K) @ b (batch, K,
    N).  Two f32 operands: ``"tc32"`` (3xTF32 on wgmma, C^T = W^T x^T)
    for a product with no ``kscale`` vector and no ``row_reduce`` (plain,
    or the epilogue and multiplier modes) whose A (x) TMA reads k- or
    m-contiguous (``matmul.dB``'s x^T, transposed in shared memory as it
    is split) and whose B (W) TMA reads n- or k-contiguous, at any M, N, K
    >= 1; else ``"fma"`` (the k-scale prologue and the row reduce stay on
    the FMA pipes, as do unaligned bases and element strides).  Two bf16
    operands:
    ``"ring"`` (TMA and wgmma) at M >= 64 where
    TMA reads both layouts as they lie -- each operand with unit stride
    on one of its two axes (A on k or m, B on k or n), every other stride
    of an axis longer than 1 a positive multiple of 8 elements, 16-byte
    aligned data -- for a ``plain`` product or the fused modes (epilogue,
    vector, row reduce; a ``kscale`` vector only with A k-contiguous and
    the vector as its TMA map reads it: element k at index k, K elements,
    16-byte aligned); ``"narrow"`` (decode's C^T = W^T x^T on the ring)
    for a ``plain`` product at 1 <= M < 64 whose A (x) is k-contiguous and
    whose B (W) is k- or n-contiguous, as TMA reads them; else ``"mma"``
    (the mma.sync body: unaligned or element-strided operands, the fused
    modes at M < 64).  A pure function of the tensors' dtypes, shapes,
    strides and addresses; ``contract.cu``'s ``launch_ring`` /
    ``launch_narrow`` / ``launch_tc32`` check the same rules and refuse
    what fails them."""
    _, m, k = a.shape
    n = b.shape[2]
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        takes = kscale is None and not row_reduce and min(m, k, n) >= 1 and (
            tma_operand(a, 2, 4) or tma_operand(a, 1, 4)) and (
                tma_operand(b, 2, 4) or tma_operand(b, 1, 4))
        return "tc32" if takes else "fma"
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        return "mma"
    if m < 1 or k < 1 or n < 1:
        return "mma"
    b_ok = tma_operand(b, 1, 2) or tma_operand(b, 2, 2)
    if m < 64:
        return "narrow" if plain and b_ok and tma_operand(a, 2, 2) else "mma"
    if kscale is not None:
        v = kscale.tensor
        a_ok = tma_operand(a, 2, 2) and kscale.div == 1 and (
            v.numel() == k and v.data_ptr() % 16 == 0)
    else:
        a_ok = tma_operand(a, 2, 2) or tma_operand(a, 1, 2)
    return "ring" if a_ok and b_ok else "mma"


class RingPlan(NamedTuple):
    """The ring body's tile: ``tile_n`` columns (128 or 256) by 128 rows,
    the K steps split across ``splits`` CTAs per output tile."""

    tile_n: int
    splits: int


def ring_tiles(batch: int, m: int, n: int, k: int,
               sms: int = H100_SMS, narrow_tile: bool = False) -> RingPlan:
    """The ring's tile for a (batch, M, K) @ (batch, K, N) product on a card
    of ``sms`` multiprocessors (one CTA each).  ``tile_n`` 256 where there
    are at least ``sms`` such tiles and their waves cost less than those of
    128-wide tiles, counting a 128-wide tile at 85 % of the wider one's
    rate; else 128, and always 128 where ``narrow_tile`` (the fused ring's
    k-scale and row-reduce modes).  Where the
    output has fewer tiles than ``sms / 2``, the K steps are split over up
    to 16 CTAs a tile (at least 4 steps each) so the grid fills the card,
    evened out so no split is empty."""
    nk = -(-k // RING_BK)
    rows = batch * -(-m // RING_BM)

    def tiles(bn):
        return rows * -(-n // bn)

    def waves(bn):
        return -(-tiles(bn) // sms)

    bn = 128
    if not narrow_tile and n > 128 and tiles(256) >= sms and (
        waves(256) * 256 * 0.85 < waves(128) * 128
    ):
        bn = 256
    splits = 1
    if tiles(bn) < sms // 2:
        splits = max(1, min(sms // tiles(bn), nk // 4, 16,
                            _MAX_GRID_YZ // batch))
        per = -(-nk // splits)
        splits = -(-nk // per)
    return RingPlan(bn, splits)


#: the tc32 body's tile (128 of N by 128 of M at the widest), its K step
#: (32 f32) and the fewest K steps a split of it takes (contract.cu's T_BN,
#: T_BM, T_BK)
TC32_TILE, TC32_BK, TC32_MIN_STEPS = 128, 32, 8
#: the tc32 body's x tile widths (its M a CTA, wgmma's n): the narrow ones
#: for a plain product at M < 64 whose x is k-contiguous, else 128
TC32_WIDTHS = (8, 16, 32, 64, TC32_TILE)


def tc32_width(m: int, narrow_x: bool = False) -> int:
    """The tc32 body's x tile width for M = ``m``: where ``narrow_x`` (a
    plain product whose x is k-contiguous, as TMA reads it) and M < 64, M
    rounded up to 8, 16, 32 or 64; else 128 (the fused modes' staged tile
    and the transposing split of an m-contiguous x are 128 wide)."""
    if narrow_x and m < 64:
        return next(w for w in TC32_WIDTHS if w >= m)
    return TC32_TILE


def tc32_tiles(batch: int, m: int, n: int, k: int,
               sms: int = H100_SMS, *, narrow_x: bool = False) -> RingPlan:
    """The tc32 body's tile for a (batch, M, K) @ (batch, K, N) f32 product
    on a card of ``sms`` multiprocessors (one CTA each): ``tile_n`` the x
    tile's width (``tc32_width``: the product's M a CTA) by 128 of N, and
    where the output has fewer tiles than ``sms / 2`` (phase ``kernel``'s
    M = 128: 32 tiles) the K steps split over up to 16 CTAs a tile, at
    least ``TC32_MIN_STEPS`` steps each, so the grid fills the card,
    evened out so no split is empty."""
    width = tc32_width(m, narrow_x)
    nk = -(-k // TC32_BK)
    tiles = batch * -(-m // width) * -(-n // TC32_TILE)
    splits = 1
    if tiles < sms // 2:
        splits = max(1, min(sms // tiles, nk // TC32_MIN_STEPS, 16,
                            _MAX_GRID_YZ // batch))
        per = -(-nk // splits)
        splits = -(-nk // per)
    return RingPlan(width, splits)


class NarrowPlan(NamedTuple):
    """The narrow body's tile: ``rows`` of the product's N a CTA by
    ``tile_n`` token columns, the K steps split across ``splits`` CTAs."""

    tile_n: int
    rows: int
    splits: int


def narrow_tiles(m: int, n: int, k: int, sms: int = H100_SMS,
                 batch: int = 1) -> NarrowPlan:
    """The narrow body's tile for a decode product of ``m`` tokens, (batch,
    m, K) @ (batch, K, N), on a card of ``sms`` multiprocessors:
    ``tile_n`` the narrowest of ``NARROW_WIDTHS`` that holds the M tokens
    (64 past it; the kernel refuses M > tile_n), 128 of N a CTA, and the
    K steps split so the grid holds as many CTAs as fit on the card at
    once (``NARROW_PER_SM`` an SM) without a second wave, each split at
    least ``NARROW_MIN_STEPS`` steps and at most ``NARROW_MAX_SPLITS``,
    evened out so no split is empty.  The weights' bytes bound a decode
    product, so what counts is a full card of CTAs each with its ring of
    TMA loads in flight."""
    tile_n = next((w for w in NARROW_WIDTHS if w >= m), NARROW_WIDTHS[-1])
    nk = -(-k // RING_BK)
    tiles = batch * -(-n // RING_BM)
    splits = max(1, min(NARROW_PER_SM * sms // tiles,
                        nk // NARROW_MIN_STEPS, NARROW_MAX_SPLITS,
                        _MAX_GRID_YZ // batch))
    per = -(-nk // splits)
    return NarrowPlan(tile_n, RING_BM, -(-nk // per))


def scratch_sizes(body: str, batch: int, m: int, n: int, plan=None, *,
                  row_reduce: bool = False,
                  tile: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """(f32 partials, int counters) a launch of ``body`` needs: the row
    reduce one partial row per row block of the body's CTA tile (the
    ring's 128 x ``RING_FUSED_BN``, a row block a K split of each; else
    ``tile``, the mma.sync or FMA body's (rows, columns)) and a counter per
    column block; a K split
    (``plan.splits`` > 1) one partial tile per split of every output tile
    and a counter per tile (the ring's 128 x ``plan.tile_n`` tiles, the
    tc32 body's ``plan.tile_n`` of M by 128 of N; the narrow body's 128 of
    N by ``plan.tile_n`` tokens); else none."""
    if row_reduce:
        tm, tn = (RING_BM, RING_FUSED_BN) if body == "ring" else tile
        splits = plan.splits if body == "ring" and plan is not None else 1
        return -(-m // tm) * splits * n, -(-n // tn)
    if plan is None or plan.splits == 1:
        return 0, 0
    if body == "narrow":
        tiles = batch * -(-n // RING_BM)
    elif body == "tc32":
        tiles = batch * -(-m // plan.tile_n) * -(-n // TC32_TILE)
    else:
        tiles = batch * -(-m // RING_BM) * -(-n // plan.tile_n)
    return tiles * plan.splits * RING_BM * plan.tile_n, tiles


class CardPlan(NamedTuple):
    """One tile plan of B1 as the search ranks it and the plan DB keeps it
    (a rung's ``card`` field): the ``body`` (``"ring"``, ``"narrow"``,
    ``"tc32"``; ``"mma"`` / ``"fma"`` with ``tile_n`` 0 where a body takes
    no plan), its ``tile_n`` (the ring's 128 or 256 columns, the narrow
    body's token width, tc32's x width: 128, or 8 to 64 at decode) and its
    K ``splits``."""

    body: str
    tile_n: int
    splits: int

    def as_dict(self) -> Dict[str, object]:
        return {"body": self.body, "tile_n": int(self.tile_n),
                "splits": int(self.splits)}

    @classmethod
    def from_dict(cls, d) -> Optional["CardPlan"]:
        """The plan of a rung's ``card`` field, or None without one."""
        if not d:
            return None
        return cls(str(d["body"]), int(d["tile_n"]), int(d["splits"]))


#: the bodies that take a tile plan
PLAN_BODIES = ("ring", "narrow", "tc32")


def _heuristic_tiles(body: str, batch: int, m: int, n: int, k: int,
                     sms: int, kscale: bool, row_reduce: bool,
                     narrow_x: bool = False):
    """The launcher's ``RingPlan`` / ``NarrowPlan`` for ``body`` without a
    searched plan: ``ring_tiles`` (the fused ring's 128 x 128, unsplit,
    for the row reduce), ``narrow_tiles`` or ``tc32_tiles`` (a narrow x
    tile where ``narrow_x``: a plain product with x k-contiguous); None for
    a body with no plan."""
    if body == "ring":
        return (RingPlan(RING_FUSED_BN, 1) if row_reduce else
                ring_tiles(batch, m, n, k, sms, narrow_tile=kscale))
    if body == "narrow":
        return narrow_tiles(m, n, k, sms, batch=batch)
    if body == "tc32":
        return tc32_tiles(batch, m, n, k, sms, narrow_x=narrow_x)
    return None


def heuristic_plan(body: str, batch: int, m: int, n: int, k: int,
                   sms: int = H100_SMS, *, kscale: bool = False,
                   row_reduce: bool = False,
                   narrow_x: bool = False) -> Optional[CardPlan]:
    """The ``CardPlan`` the launcher takes for ``body`` without a searched
    one (``_heuristic_tiles``); None for a body with no plan."""
    tiles = _heuristic_tiles(body, batch, m, n, k, sms, kscale, row_reduce,
                             narrow_x)
    return None if tiles is None else card_of(body, tiles)


def _tiles_of(card: CardPlan):
    """The launcher's ``RingPlan`` / ``NarrowPlan`` of a ``CardPlan``."""
    if card.body == "narrow":
        return NarrowPlan(card.tile_n, RING_BM, card.splits)
    if card.body == "tc32" and card.tile_n not in TC32_WIDTHS:
        raise ValueError(f"tc32 plan {card}: the tc32 body's x tile is one "
                         f"of {TC32_WIDTHS} wide")
    return RingPlan(card.tile_n, card.splits)


def launch_plan(body: str, plan: Optional[CardPlan], batch: int, m: int,
                n: int, k: int, sms: int = H100_SMS, *, kscale: bool = False,
                row_reduce: bool = False, narrow_x: bool = False):
    """(the launch's ``RingPlan`` / ``NarrowPlan`` or None, what became of
    the searched ``plan``: "applied", "skipped" or None without one): the
    plan's tile and split where the launch runs ``plan.body``, else the
    body's heuristic plan (``_heuristic_tiles``)."""
    if plan is not None and plan.body == body:
        return _tiles_of(plan), "applied"
    return (_heuristic_tiles(body, batch, m, n, k, sms, kscale, row_reduce,
                             narrow_x),
            None if plan is None else "skipped")


def card_of(body: str, plan) -> CardPlan:
    """The ``CardPlan`` a launch ran: its body and ``RingPlan`` /
    ``NarrowPlan`` (tile_n 0, splits 1 on a body with no plan)."""
    if plan is None:
        return CardPlan(body, 0, 1)
    return CardPlan(body, plan.tile_n, plan.splits)


_SM_COUNT: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


class _Scratch:
    """B1's split and row-reduce scratch (and B2's ring tile counter), one
    pair of buffers per (device, stream), grown and reused.  The partials are written before they are
    read; the counters are zeroed once, when a buffer is allocated, and
    every launch sets those it used back to 0, so a launch fills nothing
    (no ``torch.zeros`` kernel before every split GEMM).  Launches on one
    stream run in order, so they share a pair safely.  A launch that fails
    may leave its counters set: the launcher drops the stream's pair
    (``drop``), and the next launch there gets a freshly zeroed one."""

    def __init__(self):
        self._bufs: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def get(self, device: torch.device, stream: int, floats: int,
            ints: int) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (device, stream)
        part, count = self._bufs.get(key, (None, None))
        if part is None or part.numel() < floats:
            have = 0 if part is None else part.numel()
            part = torch.empty(max(floats, 2 * have), dtype=torch.float32,
                               device=device)
        if count is None or count.numel() < ints:
            have = 0 if count is None else count.numel()
            count = torch.zeros(max(ints, 2 * have, 1024), dtype=torch.int32,
                                device=device)
        self._bufs[key] = (part, count)
        return part, count

    def drop(self, device: torch.device, stream: int) -> None:
        """Forget the (device, stream) pair (after a failed launch)."""
        self._bufs.pop((device, stream), None)


class ContractLauncher:
    """The ctypes wrapper of ``contract_launch``; counts its launches.

    ``launches`` goes up by one for every kernel launch and for nothing
    else, so a run can show that its GEMMs went through the kernel.
    ``last_body`` names the body of the latest launch (``"ring"``,
    ``"narrow"``, ``"mma"``, ``"tc32"`` or ``"fma"``, ``contract_body``'s
    words) and ``last_plan`` its ``RingPlan`` (the ring's; the tc32
    body's, whose ``tile_n`` is x's tile width) or ``NarrowPlan`` (None on
    the mma.sync and FMA bodies);
    ``last_card`` is the two as a ``CardPlan``.
    Split and row-reduce scratch comes from a pool that grows and is
    reused (``_Scratch``), so a launch allocates nothing in the common
    case and launches no other kernel.
    """

    def __init__(self):
        self.launches = 0
        self.last_body = None
        self.last_plan = None
        self._lib = None
        self._tiles = {}  # dtype code -> (CTA rows, CTA columns)
        self._scratch = _Scratch()

    def _fn(self):
        if self._lib is None:
            from .build import load

            lib = load("contract")
            lib.contract_launch.argtypes = [ctypes.POINTER(_Params),
                                            ctypes.c_void_p]
            lib.contract_launch.restype = ctypes.c_int
            for fn in (lib.contract_tile_m, lib.contract_tile_n):
                fn.argtypes = [ctypes.c_int]
                fn.restype = ctypes.c_int
            lib.contract_params_size.restype = ctypes.c_int
            if lib.contract_params_size() != ctypes.sizeof(_Params):
                raise RuntimeError(
                    f"contract.cu's ContractParams is "
                    f"{lib.contract_params_size()} bytes, its ctypes mirror "
                    f"{ctypes.sizeof(_Params)}"
                )
            for fn, want, what in (
                (lib.contract_ring_tile_m, RING_BM, "RING_BM"),
                (lib.contract_ring_fused_tile_n, RING_FUSED_BN,
                 "RING_FUSED_BN"),
            ):
                fn.restype = ctypes.c_int
                if fn() != want:
                    raise RuntimeError(f"contract.cu's {fn.__name__}() is "
                                       f"{fn()}, {what} says {want}")
            self._lib = lib
        return self._lib

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype, *, kscale: Optional[VecArg] = None,
                 mul: Optional[VecArg] = None,
                 epilogue: Optional[Epilogue] = None,
                 vectors: Optional[Dict[str, VecArg]] = None,
                 t: Optional[torch.Tensor] = None,
                 body: Optional[str] = None,
                 plan: Optional[CardPlan] = None) -> torch.Tensor:
        """a (batch, M, K) @ b (batch, K, N) -> new (batch, M, N) tensor.

        ``kscale`` scales A along k as it is staged; ``mul`` and the
        ``epilogue`` with its ``vectors`` act on the accumulator before the
        store.  With ``t`` (M, N) (batch 1) the result is instead the (N,)
        vector ``sum_m (a @ b)[m, n] * t[m, n]``.  ``body`` forces a body
        (``BODIES``, of the operands' dtype); by default ``contract_body``
        picks it.  The kernel refuses a forced ring, narrow or tc32 body
        it cannot take, and this raises.  ``plan`` (a searched
        ``CardPlan``) takes the place of the body's heuristic plan
        (``heuristic_plan``) where the launch runs the plan's body
        (``obs`` counts ``ops.card_plan.applied``); on another body the
        heuristic's stays (``ops.card_plan.skipped``).  A plan the kernel
        refuses raises, as a refused body does.
        """
        if a.device.type != "cuda" or b.device != a.device:
            raise ValueError(
                f"contract kernel takes CUDA tensors on one device, got "
                f"{a.device} and {b.device}"
            )
        if a.dtype != b.dtype or a.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"contract kernel takes two float32 or two bfloat16 "
                f"operands, got {a.dtype} and {b.dtype}"
            )
        if out_dtype not in _KERNEL_DTYPES:
            raise TypeError(f"contract kernel writes float32 or bfloat16, "
                            f"not {out_dtype}")
        if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or (
            a.shape[2] != b.shape[1]
        ):
            raise ValueError(f"contract kernel takes (batch, M, K) and "
                             f"(batch, K, N), got {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
        if min(a.stride()) < 0 or min(b.stride()) < 0:
            raise ValueError("contract kernel takes non-negative strides")
        batch, m, k = a.shape
        n = b.shape[2]
        code = _KERNEL_DTYPES[a.dtype]
        lib = self._fn()
        if code not in self._tiles:
            self._tiles[code] = (lib.contract_tile_m(code),
                                 lib.contract_tile_n(code))
        tile_m = self._tiles[code][0]
        if batch > _MAX_GRID_YZ or -(-m // tile_m) > _MAX_GRID_YZ:
            raise ValueError(f"contract kernel grid too large for batch "
                             f"{batch}, M {m}")
        if max(batch, m, n, k, *a.stride(), *b.stride()) >= 2**31:
            raise ValueError("contract kernel takes extents and strides "
                             "below 2**31")
        plain = kscale is None and mul is None and t is None and (
            epilogue is None or epilogue.is_identity)
        if body is None:
            body = contract_body(a, b, plain=plain, kscale=kscale,
                                 row_reduce=t is not None)
        elif body not in BODIES:
            raise ValueError(f"contract kernel body {body!r}: one of "
                             f"{BODIES}")
        elif BODY_CODES[body] == 0 and body != (
            "fma" if a.dtype == torch.float32 else "mma"
        ):
            # body code 0 is mma.sync or FMA by the operands' dtype, so the
            # kernel cannot tell a forced one of the other dtype (the ring,
            # narrow and tc32 bodies refuse the wrong dtype themselves)
            raise ValueError(f"contract kernel body {body!r} does not take "
                             f"{a.dtype} operands")
        p = _Params(A=a.data_ptr(), B=b.data_ptr(), batch=batch, M=m, N=n,
                    K=k, in_dtype=code, out_dtype=_KERNEL_DTYPES[out_dtype],
                    body=BODY_CODES[body], tile_n=0, splits=1)
        p.sAb, p.sAm, p.sAk = a.stride()
        p.sBb, p.sBk, p.sBn = b.stride()
        extents = (batch, m, n, k)
        if kscale is not None:
            set_vec(p, "kscale", kscale, a.device, _VEC_DTYPES, (3,),
                    extents)
        if mul is not None:
            set_vec(p, "mul", mul, a.device, _VEC_DTYPES, (0, 1, 2),
                    extents)
        set_epilogue(p, epilogue, vectors, a.device, (0, 1, 2), extents,
                     _VEC_DTYPES)
        if t is not None:
            if batch != 1 or tuple(t.shape) != (m, n) or t.dtype != a.dtype or (
                t.device != a.device or min(t.stride()) < 0
            ):
                raise ValueError(f"contract kernel: row reduce takes batch 1 "
                                 f"and t ({m}, {n}) {a.dtype} on {a.device}, "
                                 f"got batch {batch}, t {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device}")
            if epilogue is not None or mul is not None or kscale is not None:
                raise ValueError("contract kernel: row reduce takes no "
                                 "epilogue and no vector")
            c = torch.empty((n,), dtype=out_dtype, device=a.device)
            if n == 0:
                return c
            if m == 0:  # no row blocks: an empty sum
                return c.zero_()
            p.T = t.data_ptr()
            p.sTm, p.sTn = t.stride()
            p.sCn = c.stride(0)
        else:
            c = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
            if c.numel() == 0:
                return c
            p.sCb, p.sCm, p.sCn = c.stride()
        plan, taken = launch_plan(body, plan, batch, m, n, k,
                                  _sm_count(a.device),
                                  kscale=kscale is not None,
                                  row_reduce=t is not None,
                                  narrow_x=plain and tma_operand(a, 2, 4))
        if taken:
            from ..obs import counter

            counter(f"ops.card_plan.{taken}").inc()
        if plan is not None:
            p.tile_n, p.splits = plan.tile_n, plan.splits
        stream = torch.cuda.current_stream(a.device).cuda_stream
        floats, ints = scratch_sizes(body, batch, m, n, plan,
                                     row_reduce=t is not None,
                                     tile=self._tiles[code])
        if floats or ints:
            partial, counter = self._scratch.get(a.device, stream, floats,
                                                 ints)
            p.partial, p.counter = partial.data_ptr(), counter.data_ptr()
        p.C = c.data_ptr()
        rc = lib.contract_launch(ctypes.byref(p), stream)
        if rc != 0:
            self._scratch.drop(a.device, stream)
            raise RuntimeError(f"contract kernel launch failed ({body} "
                               f"body): cudaGetLastError() = {rc}")
        self.launches += 1
        self.last_body, self.last_plan = body, plan
        return c

    @property
    def last_card(self) -> Optional[CardPlan]:
        """The latest launch's body and plan as a ``CardPlan``."""
        if self.last_body is None:
            return None
        return card_of(self.last_body, self.last_plan)


#: the process's one launcher; ``CONTRACT.launches`` is the launch count
CONTRACT = ContractLauncher()


def _fold(ia, ib, out):
    """(batch, m, n, k) index groups of the product of operands with
    indices ``ia`` and ``ib`` into ``out``."""
    batch = [i for i in out if i in ia and i in ib]
    m = [i for i in out if i in ia and i not in ib]
    n = [i for i in out if i in ib and i not in ia]
    k = [i for i in ia if i in ib and i not in out]
    return batch, m, n, k


def _two_sided(ia, ib, out) -> bool:
    """Every reduce index of the pair is shared by both, and every ``out``
    index comes from one of them."""
    return (all(i in ib or i in out for i in ia)
            and all(i in ia or i in out for i in ib)
            and all(i in ia or i in ib for i in out))


@dataclasses.dataclass(frozen=True)
class Fold:
    """How a spec reaches the kernel: ``a`` and ``b`` are the GEMM's
    operands, folded into ``target`` (the spec's output, or T's indices
    for a row reduce); ``extra`` is the vector or T.  A chain is X(r,p)
    = ``a``, Y(p,q) = ``b``, Z(q,c) = ``extra``."""

    kind: str                   # "gemm" | "vector" | "row_reduce" | "chain"
    a: str
    b: str
    target: Tuple[str, ...]
    extra: Optional[str] = None


def _classify(spec: ContractionSpec) -> Fold:
    """Map a root spec onto one of the kernel's modes by its index sets."""
    ops, out = spec.operands, spec.output
    names = list(ops)
    if len(names) == 2:
        return Fold("gemm", names[0], names[1], out)
    if len(names) == 3:
        for z in names:  # a 1-D operand on a group of the others' product
            x, y = [name for name in names if name != z]
            if len(ops[z]) == 1 and _two_sided(ops[x], ops[y], out) and (
                ops[z][0] in ops[x] or ops[z][0] in ops[y]
            ):
                return Fold("vector", x, y, out, z)
        for t in names:  # T holds the product's indices; out is one side
            x, y = [name for name in names if name != t]
            it = ops[t]
            if not set(out) <= set(it) or not _two_sided(ops[x], ops[y], it):
                continue
            batch, m, n, _ = _fold(ops[x], ops[y], it)
            if batch:
                continue
            if tuple(n) == tuple(out):
                return Fold("row_reduce", x, y, it, t)
            if tuple(m) == tuple(out):
                return Fold("row_reduce", y, x, it, t)
        chain = _chain_fold(ops, out)
        if chain is not None:
            return chain
    raise NotImplementedError(
        f"{spec.name}: {len(names)} operands {dict(ops)} -> {out} fit none "
        f"of the kernel's modes (a product of two, a vector on one side, a "
        f"row reduce, a chain of three matrices)"
    )


def _chain_fold(ops, out) -> Optional[Fold]:
    """Three matrices X(r,p), Y(p,q), Z(q,c) into (r, c), with p, q, r and c
    distinct: the chain and its derived specs, whatever each operand's
    orientation."""
    if len(out) != 2 or any(len(ix) != 2 for ix in ops.values()):
        return None
    r, c = out
    holds = lambda i: [n for n, ix in ops.items() if i in ix]  # noqa: E731
    if len(holds(r)) != 1 or len(holds(c)) != 1:
        return None
    (x,), (z,) = holds(r), holds(c)
    if x == z:
        return None
    (y,) = [n for n in ops if n not in (x, z)]
    (p,) = [i for i in ops[x] if i != r]
    (q,) = [i for i in ops[z] if i != c]
    if len({r, c, p, q}) != 4 or set(ops[y]) != {p, q}:
        return None
    return Fold("chain", x, y, out, z)


def _group_of(index, batch, m, n, k, ext) -> Tuple[int, int]:
    """(axis code, div) of ``index`` within the folded groups."""
    for axis, group in enumerate((batch, m, n, k)):
        if index in group:
            pos = group.index(index)
            return axis, math.prod(ext[i] for i in group[pos + 1:])
    raise AssertionError(f"index {index} in no folded group")


def _chain_cost(r, p, q, c, dtype) -> int:
    """Multiply-adds of the chain kernel on X(r,p) Y(p,q) Z(q,c) of
    ``dtype``: the CTAs of one cluster split the p reduction of their rows
    of T = X.Y and share the sum, so T is formed once per cluster of column
    blocks (``chain_cluster`` CTAs of ``chain_tile_n`` columns)."""
    blocks = -(-c // chain_tile_n(dtype))
    return r * p * q * -(-blocks // chain_cluster(dtype, p)) + r * q * c


def chain_extents(spec: ContractionSpec, fold: Fold) -> Tuple[str, ...]:
    """The chain's indices (r, p, q, c): X(r, p), Y(p, q), Z(q, c)."""
    ops = spec.operands
    r, c = spec.output
    (p,) = [i for i in ops[fold.a] if i != r]
    (q,) = [i for i in ops[fold.extra] if i != c]
    return r, p, q, c


def chain_plan(r: int, p: int, q: int, c: int,
               dtype: torch.dtype) -> ChainPlan:
    """The chain's launch without a searched plan, for X(r,p) Y(p,q) Z(q,c)
    of ``dtype``: the association that recomputes less (``_chain_cost``;
    X.(Y.Z) runs the transposed chain, whose first reduction is q) and
    ``chain_cluster``'s cluster for that first reduction."""
    right = _chain_cost(c, q, p, r, dtype) < _chain_cost(r, p, q, c, dtype)
    return ChainPlan("yz" if right else "xy",
                     chain_cluster(dtype, q if right else p))


def _launch_chain(spec: ContractionSpec, fold: Fold, operands, out_dtype,
                  epilogue, vectors, plan: Optional[ChainPlan] = None
                  ) -> torch.Tensor:
    """One launch of the chain kernel on ``plan`` (a searched
    ``ChainPlan``, counted ``ops.card_plan.applied``), else ``chain_plan``'s:
    (X.Y).Z as written, or X.(Y.Z) as the transposed chain Z^T Y^T X^T
    written into C^T.  Operands go as (transposed) views with their
    strides: no copies."""
    arrays = dict(zip(spec.operands, operands))
    ops = spec.operands
    r, p, q, c = chain_extents(spec, fold)
    mat = lambda name, rows: (arrays[name] if ops[name][0] == rows  # noqa
                              else arrays[name].t())
    x, y, z = mat(fold.a, r), mat(fold.b, p), mat(fold.extra, q)
    if len({x.dtype, y.dtype, z.dtype}) != 1:
        dt = torch.promote_types(torch.promote_types(x.dtype, y.dtype),
                                 z.dtype)
        x, y, z = x.to(dt), y.to(dt), z.to(dt)
    ext = spec.extents
    if plan is not None:
        if plan.assoc not in ("xy", "yz"):
            raise ValueError(f"chain plan {tuple(plan)}: the association is "
                             f"'xy' or 'yz'")
        from ..obs import counter

        counter("ops.card_plan.applied").inc()
    else:
        plan = chain_plan(ext[r], ext[p], ext[q], ext[c], x.dtype)
    right = plan.assoc == "yz"
    kw = {}
    if epilogue is not None and not epilogue.is_identity:
        vecs = {}
        for name in epilogue.vector_names:
            v = vectors[name].float().reshape(-1).contiguous()
            if v.numel() != ext[c]:
                raise ValueError(f"epilogue vector {name}: {v.numel()} "
                                 f"elements for output axis {c!r} of extent "
                                 f"{ext[c]}")
            vecs[name] = VecArg(v, 1 if right else 2)
        kw.update(epilogue=epilogue, vectors=vecs)
    out = torch.empty((ext[r], ext[c]), dtype=out_dtype, device=x.device)
    if right:
        CONTRACT_CHAIN(z.t(), y.t(), x.t(), out_dtype, out=out.t(),
                       plan=plan, **kw)
    else:
        CONTRACT_CHAIN(x, y, z, out_dtype, out=out, plan=plan, **kw)
    return out


def _kmajor(x: torch.Tensor, unit: int, meta: bool = False
            ) -> torch.Tensor:
    """``x`` (batch, rows, cols), with axis ``unit`` (1 rows, 2 cols) the
    unit-stride one as TMA reads it: ``x`` itself where it already is
    (``tma_operand``), else a copy laid out (batch, other axis, ``unit``),
    viewed back in ``x``'s axis order.  ``meta``: the same layout on the
    meta device, which moves no data (the route's rule reads it)."""
    if tma_operand(x, unit, x.element_size()):
        return x
    if meta:
        x = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                device="meta")
    order = (0, 3 - unit, unit)  # its own inverse
    return x.permute(order).contiguous().permute(order)


def eight_bit_route(kind: str, a3: torch.Tensor, b3: torch.Tensor,
                    extra: Optional[torch.Tensor] = None,
                    kscale: Optional[VecArg] = None, *, int_acc: bool,
                    out_dtype: torch.dtype = torch.float32) -> str:
    """Which launcher takes the folded product a3 (batch, M, K) @ b3
    (batch, K, N) of an 8-bit spec of fold ``kind``, with its vector or
    T ``extra`` (``kscale``: the vector when it lies on k).  A rule on
    the operands' dtypes, shapes and strides; nothing is retried.

    ``"tensor cores"`` (``CONTRACT_INT8`` / ``CONTRACT_FP8``): a product
    of two 8-bit operands of one format, as before; and the vector and
    row-reduce modes where g or T is 8-bit of that format too and
    ``q8_ring_refusal`` finds nothing once A and B are K-major (``_kmajor``
    copies a transposed operand; int8's k-scale makes A's two byte planes,
    contiguous, at batch 1): M >= 64, and for fp8 K >= FP8_RING_MIN_K.
    ``"bf16"`` (``CONTRACT``): fp8's k-scale, where ``contract_body``
    gives its k-scale ring to the bf16 upcasts (exact: an e4m3 x e4m3
    product has at most 8 significant bits) and the output is f32 or
    bf16.  ``"upcast"`` (``CONTRACT_UPCAST``): everything else -- a mixed
    or int32 operand (a one-sided reduce's int32 sum, an int32 g), M <
    64, a short fp8 K, a layout the ring cannot take."""
    dt = a3.dtype
    if b3.dtype != dt or dt not in (torch.int8, torch.float8_e4m3fn) or (
        int_acc != (dt == torch.int8)
    ):
        return "upcast"
    if kind == "gemm":
        return "tensor cores"
    if extra is None or extra.dtype != dt:
        return "upcast"
    meta = lambda x, dtype=None: torch.empty_strided(  # noqa: E731
        x.shape, x.stride(), dtype=dtype or x.dtype, device="meta")
    if kscale is not None and dt == torch.float8_e4m3fn:
        if out_dtype not in _KERNEL_DTYPES:
            return "upcast"
        g = VecArg(meta(kscale.tensor, torch.bfloat16), 3, kscale.div)
        return "bf16" if contract_body(
            meta(a3, torch.bfloat16), meta(b3, torch.bfloat16),
            plain=False, kscale=g) == "ring" else "upcast"
    # int8's k-scale reads A as its byte planes, made by the launcher
    a = a3 if kscale is not None else _kmajor(a3, 2, meta=True)
    return ("tensor cores" if q8_ring_refusal(
        a, _kmajor(b3, 1, meta=True), kscale) is None else "upcast")


def _product_views(spec: ContractionSpec, fold: Fold, arrays, int_acc: bool):
    """(a3 (batch, M, K), b3 (batch, K, N), (batch, m, n, k) index groups)
    of the product ``fold`` makes of ``arrays``: the operands as permuted
    views with their strides (a copy only where a group of indices cannot
    be flattened), a reduce index held by one operand summed out first in
    the accumulator's type, mixed f32 / bf16 promoted, and the product
    taken the other way round where that lands in the output's order.
    ``_launch_cuda`` launches on these views; ``card_views`` gives them
    to the search, so what it measures is the body the caller runs."""
    ext = spec.extents
    a, b = arrays[fold.a], arrays[fold.b]
    ia, ib = spec.operands[fold.a], spec.operands[fold.b]
    target = fold.target
    if fold.kind == "gemm":
        a_only = [i for i in ia if i not in ib and i not in target]
        b_only = [i for i in ib if i not in ia and i not in target]
        if a_only or b_only:
            # summed out first in the accumulator's type, like the
            # reference's single-operand sum
            def side_sum(x, axes, dims):
                if not dims:
                    return x
                if int_acc:
                    return x.to(torch.int64).sum(
                        dim=[axes.index(i) for i in dims]).to(torch.int32)
                return x.float().sum(dim=[axes.index(i) for i in dims])

            a, b = side_sum(a, ia, a_only), side_sum(b, ib, b_only)
            ia = tuple(i for i in ia if i not in a_only)
            ib = tuple(i for i in ib if i not in b_only)
    wide = {torch.float32, torch.bfloat16}
    if a.dtype in wide and b.dtype in wide and a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    batch, m, n, k = _fold(ia, ib, target)
    if fold.kind in ("gemm", "vector") and batch + m + n != list(
        target
    ) and batch + n + m == list(target):
        # the product the other way round lands in the output's order: no
        # transposing copy of the result (matmul.dB: A = x^T, B = dout;
        # weighted_matmul.dB likewise, g then on the rows)
        a, b, ia, ib = b, a, ib, ia
        batch, m, n, k = _fold(ia, ib, target)
    size = lambda idx: math.prod(ext[i] for i in idx)  # noqa: E731
    a3 = a.permute([ia.index(i) for i in batch + m + k]).reshape(
        size(batch), size(m), size(k)
    )
    b3 = b.permute([ib.index(i) for i in batch + k + n]).reshape(
        size(batch), size(k), size(n)
    )
    return a3, b3, (batch, m, n, k)


def _as_vec(x: torch.Tensor, plain: bool, int_acc: bool) -> torch.Tensor:
    """A vector operand as its launcher reads it: contract.cu (``plain``)
    f32 and bf16 as they are; the 8-bit kernels int32 (``int_acc``) or
    f32."""
    if not (plain and x.dtype in _VEC_DTYPES):
        x = x.to(torch.int32 if int_acc else torch.float32)
    return x.reshape(-1).contiguous()


def _mode_views(spec: ContractionSpec, fold: Fold, arrays, int_acc: bool,
                out_dtype: torch.dtype, epilogue: Optional[Epilogue] = None):
    """What ``_launch_cuda`` launches on for ``fold`` of ``arrays`` (under
    ``epilogue``): (a3, b3, (batch, m, n, k) groups, the vector as a
    ``VecArg`` or None, the 8-bit route or None, whether the launch is
    ``CONTRACT``'s).  The product views (``_product_views``); the 8-bit
    route's operands (``eight_bit_route``: fp8's k-scale upcast to bf16,
    K-major copies for the ring's weighted modes); the vector in the type
    its launcher reads; and, where the bf16 launch runs the mma.sync body,
    operands copied to the layout its 16-byte loads take."""
    a3, b3, groups = _product_views(spec, fold, arrays, int_acc)
    wide = {torch.float32, torch.bfloat16}
    plain = a3.dtype in wide and b3.dtype in wide
    vec = None
    if fold.kind == "vector":
        (j,) = spec.operands[fold.extra]
        vec = VecArg(arrays[fold.extra].reshape(-1).contiguous(),
                     *_group_of(j, *groups, spec.extents))
    route = None
    if not plain:
        route = eight_bit_route(
            fold.kind, a3, b3, arrays.get(fold.extra),
            vec if vec is not None and vec.axis == 3 else None,
            int_acc=int_acc, out_dtype=out_dtype)
        if route == "bf16":
            # fp8's k-scale on contract.cu's bf16 ring: a * g and the
            # upcast B are exact in bf16, the sums f32 as the reference's
            a3, b3, plain = a3.bfloat16(), b3.bfloat16(), True
            vec = vec._replace(tensor=vec.tensor.bfloat16())
        elif route == "tensor cores" and fold.kind != "gemm":
            if vec is None or vec.axis != 3:  # int8's planes are K-major
                a3 = _kmajor(a3, 2)
            b3 = _kmajor(b3, 1)
    if vec is not None and not (route == "tensor cores" and vec.axis == 3):
        # int8's byte planes take g as it is (int8)
        vec = vec._replace(tensor=_as_vec(vec.tensor, plain, int_acc))
    if plain and a3.dtype == torch.bfloat16 and contract_body(
        a3, b3, plain=fold.kind == "gemm" and (
            epilogue is None or epilogue.is_identity),
            kscale=vec if vec is not None and vec.axis == 3 else None
    ) == "mma":
        # the ring and narrow bodies read their layouts as they lie; the
        # mma.sync body loads 16 bytes at a time only where A is k-major
        # and B n-major, so there a transposed operand is copied so once
        # instead of loaded element by element
        if a3.stride(2) != 1:
            a3 = a3.contiguous()
        if b3.stride(2) != 1:
            b3 = b3.contiguous()
    return a3, b3, groups, vec, route, plain


def _row_reduce_t(spec: ContractionSpec, fold: Fold, arrays, groups,
                  dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The row reduce's T as the (M, N) view of its indices (``dtype``:
    the launch's operand type on ``CONTRACT``, else T's own)."""
    _, m, n, _ = groups
    it = spec.operands[fold.extra]
    t = arrays[fold.extra]
    if dtype is not None:
        t = t.to(dtype)
    size = lambda idx: math.prod(spec.extents[i] for i in idx)  # noqa: E731
    return t.permute([it.index(i) for i in m + n]).reshape(size(m), size(n))


def card_views(spec: ContractionSpec, *operands: torch.Tensor,
               out_dtype: torch.dtype = torch.float32,
               epilogue: Optional[Epilogue] = None) -> tuple:
    """The views B1 launches on for ``spec`` of ``operands``, given in
    ``spec.operands`` order as the caller passes them (``ops.dense``'s
    folded x; the backward's cotangent and saved operands for ``.dA`` /
    ``.dB``): the layouts ``contract_body``, ``modes.q8_body`` and the
    search's ``card_candidates`` read.  (a3 (batch, M, K), b3 (batch, K,
    N)) for a two-operand spec; for a three-operand one also its vector
    (a ``VecArg``: the k-scale on axis 3, a multiplier on another) or the
    row reduce's T as an (M, N) view.  8-bit operands go as their route
    launches them (``eight_bit_route``; ``out_dtype`` the launch's, f32 as
    the search measures), and under ``epilogue`` as that launch takes
    them.  Raises for the chain, which has plans of its own
    (``modes.ChainPlan``) and no product views."""
    spec = spec.root()
    fold = _classify(spec)
    if fold.kind == "chain":
        raise ValueError(f"{spec.name}: the chain has no product views; its "
                         f"plans are modes.ChainPlan")
    arrays = dict(zip(spec.operands, operands))
    a3, b3, groups, vec, _, plain = _mode_views(
        spec, fold, arrays, _int_accum(spec), out_dtype, epilogue)
    if fold.kind == "gemm":
        return a3, b3
    if fold.kind == "vector":
        return a3, b3, vec
    return a3, b3, _row_reduce_t(spec, fold, arrays, groups,
                                 a3.dtype if plain else None)


def _launcher(a3: torch.Tensor, route: Optional[str], plain: bool):
    """(the launcher of a launch on ``_mode_views``' a3, route and
    ``plain``, the plan kind it takes or None)."""
    if plain:
        return CONTRACT, CardPlan
    if route == "tensor cores":
        return (CONTRACT_INT8 if a3.dtype == torch.int8
                else CONTRACT_FP8), Q8Plan
    return CONTRACT_UPCAST, None


def launcher_of(spec: ContractionSpec, *operands: torch.Tensor,
                out_dtype: torch.dtype = torch.float32,
                epilogue: Optional[Epilogue] = None):
    """The launcher whose one launch a call of ``spec`` on ``operands``
    (under ``epilogue``, writing ``out_dtype``) makes: ``CONTRACT_CHAIN``
    for a chain, else as ``_launch_cuda`` picks it."""
    spec = spec.root()
    fold = _classify(spec)
    if fold.kind == "chain":
        return CONTRACT_CHAIN
    a3, _, _, _, route, plain = _mode_views(
        spec, fold, dict(zip(spec.operands, operands)), _int_accum(spec),
        out_dtype, epilogue)
    return _launcher(a3, route, plain)[0]


def _launch_cuda(spec: ContractionSpec, *operands: torch.Tensor,
                 out_dtype: torch.dtype, epilogue: Optional[Epilogue] = None,
                 vectors: Optional[Dict[str, torch.Tensor]] = None,
                 fold: Optional[Fold] = None,
                 card=None) -> torch.Tensor:
    """Fold the spec onto a kernel (``fold``: ``_classify``'s, computed
    here when not given), launch it once and unfold the result.  ``card``
    (a searched plan) goes to the launcher that takes its kind, which
    applies it where the launch runs its body: a ``CardPlan`` to
    ``CONTRACT``, a ``modes.Q8Plan`` to ``CONTRACT_INT8`` /
    ``CONTRACT_FP8``, a ``modes.ChainPlan`` to ``CONTRACT_CHAIN``; a plan
    of another kind is counted ``ops.card_plan.skipped``.

    Launcher by operands: a chain runs ``CONTRACT_CHAIN``; f32 and bf16
    ``CONTRACT``; 8-bit or integer operands as ``eight_bit_route`` says:
    ``CONTRACT_INT8`` / ``CONTRACT_FP8`` (a product of two 8-bit operands
    of one format; the weighted family's modes on the ring, after K-major
    copies of a transposed operand), ``CONTRACT`` (fp8's k-scale over
    bf16 upcasts) or ``CONTRACT_UPCAST``."""
    from ..obs import counter

    fold = fold or _classify(spec)
    if fold.kind == "chain":
        if card is not None and not isinstance(card, ChainPlan):
            counter("ops.card_plan.skipped").inc()
            card = None
        return _launch_chain(spec, fold, operands, out_dtype, epilogue,
                             vectors, plan=card)
    int_acc = _int_accum(spec)
    arrays = dict(zip(spec.operands, operands))
    ext = spec.extents
    a3, b3, groups, vec, route, plain = _mode_views(
        spec, fold, arrays, int_acc, out_dtype, epilogue)
    batch, m, n, k = groups
    launcher, kind = _launcher(a3, route, plain)
    kw = {} if plain else {"int_acc": int_acc}
    if card is not None:
        if kind is not None and isinstance(card, kind):
            kw["plan"] = card
        else:
            counter("ops.card_plan.skipped").inc()
    if fold.kind == "row_reduce":
        t2 = _row_reduce_t(spec, fold, arrays, groups,
                           a3.dtype if plain else None)
        return launcher(a3, b3, out_dtype, t=t2, **kw).reshape(
            [ext[i] for i in spec.output])
    if vec is not None:
        kw["kscale" if vec.axis == 3 else "mul"] = vec
    if epilogue is not None and not epilogue.is_identity:
        last = spec.output[-1]
        axis, div = _group_of(last, *groups, ext)
        vecs = {}
        for name in epilogue.vector_names:
            v = (_as_vec(vectors[name], plain, int_acc) if plain
                 else vectors[name].float().reshape(-1).contiguous())
            if v.numel() != ext[last]:
                raise ValueError(f"epilogue vector {name}: {v.numel()} "
                                 f"elements for output axis {last!r} of "
                                 f"extent {ext[last]}")
            vecs[name] = VecArg(v, axis, div)
        if plain and epilogue.dequant:
            # contract.cu has no qscale stage: its multiplier vector comes
            # first in its epilogue, exactly where dequant does
            if "mul" in kw:
                raise NotImplementedError(
                    f"{spec.name}: a dequant epilogue on the weighted "
                    f"family's multiplier mode of f32/bf16 operands")
            kw["mul"] = vecs.pop("qscale")
            epilogue = dataclasses.replace(epilogue, dequant=False)
            if epilogue.is_identity:
                epilogue, vecs = None, None
        if epilogue is not None:
            kw.update(epilogue=epilogue, vectors=vecs)
    c = launcher(a3, b3, out_dtype, **kw).reshape(
        [ext[i] for i in batch + m + n])
    produced = batch + m + n
    perm = [produced.index(i) for i in spec.output]
    if perm != list(range(len(perm))):
        c = c.permute(perm).contiguous()
    return c


def _default_out_dtype(spec: ContractionSpec, epilogue: Optional[Epilogue],
                       first: torch.dtype) -> torch.dtype:
    """The reference's rule (``pallas_gen.py:246-261``) without an explicit
    ``out_dtype``: an int8 spec writes its int32 accumulator and an fp8
    spec its f32 one, unless a dequant epilogue rescaled it to real values
    (f32); any other spec writes its first operand's dtype."""
    quant = getattr(spec.root(), "quant", None)
    if quant is None:
        return first
    if epilogue is not None and epilogue.dequant:
        return torch.float32
    return torch.int32 if quant.accum == "int32" else torch.float32


@dataclasses.dataclass
class CompiledKernel:
    """A contraction bound to one (spec, schedule) pair.

    Call with the operand tensors in ``spec.operands`` order, shaped as the
    plan's local extents; epilogue vectors (scale/bias/mean/var) go by
    keyword.  CUDA tensors launch ``csrc/contract.cu``; CPU tensors run
    ``contract_ref``.
    """

    spec: ContractionSpec
    schedule: Schedule
    plan: KernelPlan
    out_dtype: Optional[torch.dtype]
    interpret: bool
    epilogue: Optional[Epilogue] = None
    fold: Optional[Fold] = None
    #: the searched tile plan of B1 (a plan-DB rung's ``card``), or None
    card: Optional[CardPlan] = None

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.spec.operands)

    def __call__(self, *arrays: torch.Tensor, **vectors) -> torch.Tensor:
        names = self.names
        if len(arrays) != len(names):
            raise TypeError(
                f"{self.spec.name} takes {len(names)} operands "
                f"{names}, got {len(arrays)}"
            )
        for name, arr in zip(names, arrays):
            want = tuple(
                self.plan.axes[i].local_extent
                for i in self.spec.operands[name]
            )
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"operand {name}: expected local shape {want}, "
                    f"got {tuple(arr.shape)}"
                )
        vec_names = self.epilogue.vector_names if self.epilogue else ()
        missing = set(vec_names) - set(vectors)
        if missing:
            raise TypeError(f"epilogue vectors missing: {sorted(missing)}")
        extra = set(vectors) - set(vec_names)
        if extra:
            raise TypeError(f"unexpected epilogue vectors {sorted(extra)} "
                            f"(the epilogue takes {list(vec_names)})")
        out_dtype = self.out_dtype or _default_out_dtype(
            self.spec, self.epilogue, arrays[0].dtype)
        vecs = [vectors[v] for v in vec_names]
        tensors: List[torch.Tensor] = list(arrays) + vecs
        devices = {x.device.type for x in tensors}
        if devices not in ({"cpu"}, {"cuda"}):
            raise ValueError(f"{self.spec.name}: operands on "
                             f"{sorted(devices)}; all CPU (plain version) "
                             f"or all CUDA (kernel)")
        from ..ops import library

        if any(library.is_dtensor(x) for x in tensors):
            # the op's sharding rule places the operands (a plain one is
            # taken as replicated) and each rank runs its shard
            return library.sharded_contract(self, arrays, vecs, out_dtype)
        if library.through_op(tensors):
            return library.CONTRACT_OP(library.key_of(self), list(arrays),
                                       vecs, out_dtype)
        return self.run(arrays, vecs, out_dtype)

    def run(self, arrays, vectors, out_dtype: torch.dtype) -> torch.Tensor:
        """The launch, called directly or as ``repro_torch::contract``
        (``ops.library.through_op``): CUDA tensors launch B1
        (``_launch_cuda``), CPU tensors run its plain version
        (``contract_ref``).  ``vectors`` are the epilogue's, in
        ``Epilogue.vector_names`` order."""
        names = self.epilogue.vector_names if self.epilogue else ()
        vecs = dict(zip(names, vectors))
        if arrays[0].device.type == "cpu":
            return contract_ref(self.spec, *arrays, out_dtype=out_dtype,
                                epilogue=self.epilogue, vectors=vecs)
        return _launch_cuda(self.spec, *arrays, out_dtype=out_dtype,
                            epilogue=self.epilogue, vectors=vecs,
                            fold=self.fold, card=self.card)


def compile_kernel(
    spec: ContractionSpec,
    schedule: Schedule,
    *,
    epilogue: Optional[Epilogue] = None,
    out_dtype=None,
    interpret: bool = False,
    mesh=None,
    collective: str = "psum",
    card=None,
):
    """Compile a ContractionSpec + Schedule into a kernel.

    ``spec`` may be the root spec or the schedule's own (subdivided) spec;
    they must share a root.  ``interpret`` keeps its reference meaning at
    the ``ops`` level (eligibility off the device rule); the kernel itself
    is chosen by the operands' device.  ``card`` is a searched tile plan,
    which the launches take where they run its body: B1's ``CardPlan``,
    or for a fused spec ``fused_gen.FusedPlan``.  With ``mesh`` (a ``launch.mesh.Mesh``)
    the kernel is bound to it (``mesh_gen.bind_mesh``): a
    ``MeshBoundKernel`` called on global tensors, whose mesh-sharded
    reduce indices ``collective`` ("psum" or "ring") finishes.
    """
    root = spec.root()
    if root is not schedule.spec.root() and (
        root.operands != schedule.spec.root().operands
        or root.extents != schedule.spec.root().extents
    ):
        raise ValueError("spec and schedule disagree on the root contraction")
    if getattr(root, "fused_kind", ""):
        from .fused_gen import compile_fused

        if isinstance(card, CardPlan):
            raise ValueError(f"{root.name}: the fused kernels take no B1 "
                             f"tile plan, got {card}")
        return compile_fused(spec, schedule, epilogue=epilogue,
                             out_dtype=out_dtype, interpret=interpret,
                             mesh=mesh, card=card)
    if epilogue is not None and not isinstance(epilogue, Epilogue):
        raise TypeError(f"epilogue must be a codegen.Epilogue, got "
                        f"{type(epilogue).__name__}")
    if root.reducer != "+":
        raise NotImplementedError(f"reducer {root.reducer!r}: the kernel "
                                  f"is a product-sum")
    fold = _classify(root)
    if fold.kind == "row_reduce" and epilogue is not None and (
        not epilogue.is_identity
    ):
        raise NotImplementedError(
            f"{root.name}: the row-reduce mode sums across CTAs after the "
            f"product and takes no epilogue"
        )
    from ..obs import span

    with span("codegen.compile", spec=root.name, sharded=mesh is not None):
        plan = build_plan(schedule)
        kernel = CompiledKernel(
            spec=plan.spec,
            schedule=schedule,
            plan=plan,
            out_dtype=None if out_dtype is None else _torch_dtype(out_dtype),
            interpret=interpret,
            epilogue=epilogue,
            fold=fold,
            card=card,
        )
        if mesh is not None:
            from .mesh_gen import bind_mesh

            return bind_mesh(kernel, mesh, collective=collective)
        return kernel


_KERNEL_MEMO: Dict[tuple, CompiledKernel] = {}


def cached_compile(
    spec: ContractionSpec,
    schedule: Schedule,
    *,
    epilogue: Optional[Epilogue] = None,
    out_dtype=None,
    interpret: bool = False,
    mesh=None,
    collective: str = "psum",
    card=None,
):
    """compile_kernel memoized on (spec, schedule, epilogue, dtype,
    interpret, mesh identity, collective, card plan: a ``CardPlan`` or a
    fused spec's ``FusedPlan``).

    Hot-path entry for ``ops``: repeated calls with the same contraction
    reuse one kernel; feeds ``codegen.memo.hit/miss``.  Mesh-bound kernels
    key on the mesh's axis names, shape and global ranks, so two distinct
    meshes of the same shape get distinct bindings.
    """
    from ..obs import counter
    from .cache import schedule_to_dict, spec_signature

    mesh_key = None
    if mesh is not None:
        mesh_key = (
            tuple(mesh.axis_names),
            tuple(int(s) for s in mesh.devices.shape),
            tuple(int(r) for r in mesh.devices.flat),
            mesh.transport,
        )
    key = (
        json.dumps(spec_signature(spec), sort_keys=True),
        json.dumps(schedule_to_dict(schedule), sort_keys=True),
        epilogue,
        dtype_name(out_dtype) if out_dtype is not None else None,
        interpret,
        mesh_key,
        collective if mesh is not None else None,
        card,
    )
    kern = _KERNEL_MEMO.get(key)
    counter(f"codegen.memo.{'miss' if kern is None else 'hit'}").inc()
    if kern is None:
        kern = compile_kernel(spec, schedule, epilogue=epilogue,
                              out_dtype=out_dtype, interpret=interpret,
                              mesh=mesh, collective=collective, card=card)
        _KERNEL_MEMO[key] = kern
    return kern
