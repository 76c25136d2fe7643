"""Fused-family lowering: flash attention (B2) and the ragged grouped (MoE)
matmul (B3, B4).

The reference's ``codegen/fused_gen.py`` lowers the two fused spec
families (``core.enumerate.AttentionSpec`` / ``GroupedSpec``) to Pallas
kernels.  The port lowers them onto three hand-written CUDA kernels.

Attention, ``out = softmax_t(Q.K^T / sqrt(d) + mask) . V`` over folded
heads (Q (h, s, d), K (h, t, d), V (h, t, e)), runs ``csrc/attention.cu``
(B2): one CTA per (head, block of rows of s) walks the KV axis, carrying
the running max, sum and f32 accumulator in registers (the reference's
sequential third grid axis and its VMEM scratch).  ``attention_body``
picks its body: bf16 on a TMA ring feeding wgmma (``"ring"``) or on
mma.sync (``"mma"``), f32 in 3xTF32 on the tensor cores (``"tc32"``) or on
the FMA pipes (``"fma"``).  Masked scores take the finite ``MASK_VALUE``
and masked probabilities are re-zeroed, so a fully masked block adds
nothing to the running sum; rows with no valid column store exact zeros.
``kv_lengths`` (int32, one per folded head) reaches the kernel as a device
vector each CTA reads itself.  A CPU tensor runs ``attention_ref``, the
plain version of the kernel's semantics.

The grouped family's three modes run two kernels.  The row mode, the
forward

    out[n, f] = x[n, :] @ w[group(n), :, f]

and its dX orientation (``grouped_matmul.dX``: the shared axis is w's LAST
trailing axis, ``out[n, k] = dout[n, :] @ w[group(n), k, :]``), run
``csrc/grouped.cu`` (B3): one CTA per (row block, 128-column block of the
output), the block's rows read from a device table (``group_table``: each
non-empty group cut into blocks of at most the body's M tile,
``grouped_tile_m``), K streamed through shared memory and the accumulator
kept in f32.  The dX orientation is the same kernel with w's two trailing
strides swapped; it keeps its W tiles k-contiguous as they lie.  The dW
mode (``grouped_matmul.dW``, a spec whose output is ``(g, ., .)``)

    out[g, k1, k2] = sum_{n in group g} lhs[n, k1] * rhs[n, k2]

runs ``csrc/grouped_dw.cu`` (B4) over a table of every group, empty ones
included, whose tiles store exact zeros: bf16 operands TMA reads on a
persistent TMA / wgmma ring of 128 x 256 tiles with staged TMA stores
(``grouped_dw_body``), others on mma.sync or the FMA pipes, one CTA per
(group, K1 block, K2 block).  As in the reference, either operand may
come first in the spec.

Devices decide, as for ``cuda_gen``: CUDA tensors launch the kernel (or
raise), CPU tensors run the plain version (``grouped_ref``, the per-group
loop that upcasts to f32 and stores in the kernel's dtype, or
``grouped_dw_ref``).  Group offsets are static: they live on the spec
(``group_sizes``), so the table is built once per compiled kernel, device
and M tile.  The ``KernelPlan`` fixes the operand shapes and the memo key;
the schedule's blocks are the TPU's and do not reach the card.  What a
launch runs on the card is its body's card plan (``FusedPlan``): B2's KV
block and persistent CTA count (the ring) or KV block (tc32), B3's M tile
and B4's tile width and CTA count.  Without one each launcher takes its
heuristic (``attention_plan``, ``grouped_plan``, ``grouped_dw_plan``:
``RG_BN``, ``TC_BC``, ``grouped_tile_m``, 256-column tiles, one ring CTA
an SM) and launches exactly what it did before plans existed; a searched
plan (the plan DB's ``card`` field, ``search``) reaches ``FusedKernel``
through ``compile_fused(card=)`` and takes the heuristic's place where a
launch runs its body (``ops.card_plan.applied``; ``.skipped`` on another
body).  The mma.sync and FMA bodies take no plan.  On CPU tensors a plan
is ignored: the plain versions have no tiles.

``compile_fused`` keeps the reference's refusals of an epilogue and a mesh,
with its messages.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.enumerate import ContractionSpec
from ..core.schedule import Schedule
from .cuda_gen import H100_SMS, CardPlan, _Scratch, _sm_count, _torch_dtype
from .modes import ChainPlan, Q8Plan, tma_operand
from .plan import KernelPlan, build_plan

#: operand / output dtypes the kernel takes, with its dtype codes
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
#: B3's M tiles (rows of a CTA); a table's blocks hold at most the largest
#: (checked against ``grouped_max_rows`` of grouped.cu at load)
GROUPED_TILES = (16, 32, 64, 128)
GROUPED_MAX_ROWS = GROUPED_TILES[-1]

#: large-but-finite score for masked positions: exp(MASK - m) underflows to
#: 0 while exp(-inf - (-inf)) would be NaN (the reference's value)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: B2's widest head: d and e up to this many elements
ATTN_MAX_HEAD = 256
#: B2's bodies, in ``attention_launch``'s codes (0 .. 3)
ATTENTION_BODIES = ("ring", "mma", "tc32", "fma")
#: the widest d and e of the bf16 ring and of the 3xTF32 body
#: (attention.cu's RG_MAX_HEAD and TC_MAX_HEAD)
ATTN_RING_MAX_HEAD = ATTN_TC32_MAX_HEAD = 128
#: B2's KV blocks a plan may name, the heuristic's first: the ring's
#: (attention.cu's RG_BN, RG_BN_NARROW) and the 3xTF32 body's (TC_BC,
#: TC_BC_WIDE; the wider only where its tiles fit, ``tc32_block_fits``)
ATTN_RING_BLOCKS = (128, 64)
ATTN_TC32_BLOCKS = (32, 64)
#: B2's ring and B4's ring: rows of s a tile (RG_BM), K1 rows of a tile
#: (W_BM)
ATTN_RING_BM = DW_RING_BM = 128
#: B4's ring tile widths (K2 columns) a plan may name, the heuristic's
#: first (grouped_dw.cu's W_BN, W_BN_NARROW)
DW_RING_WIDTHS = (256, 128)
#: an H100 block's shared memory (attention.cu's SMEM_MAX)
_SMEM_MAX = 232448


class FusedPlan(NamedTuple):
    """One card plan of a fused kernel as the search ranks it and the plan
    DB keeps it (a rung's ``card`` field, beside B1's
    ``cuda_gen.CardPlan``): the ``kernel`` (``"attention"`` (B2),
    ``"grouped"`` (B3) or ``"grouped_dw"`` (B4)), the ``body`` that takes
    it (B2's ``"ring"`` or ``"tc32"``, B3's and B4's ``"ring"``), its
    ``block`` (B2: the KV block's columns, ``ATTN_RING_BLOCKS`` /
    ``ATTN_TC32_BLOCKS``; B3: the M tile, one of ``GROUPED_TILES``; B4: the
    tile's K2 columns, ``DW_RING_WIDTHS``) and the persistent grid's
    ``ctas`` (B2's and B4's rings; 0 where the grid is one CTA a tile)."""

    kernel: str
    body: str
    block: int
    ctas: int

    def as_dict(self) -> Dict[str, object]:
        return {"kernel": self.kernel, "body": self.body,
                "block": int(self.block), "ctas": int(self.ctas)}

    @classmethod
    def from_dict(cls, d) -> Optional["FusedPlan"]:
        """The plan of a rung's ``card`` field, or None without one."""
        if not d:
            return None
        return cls(str(d["kernel"]), str(d["body"]), int(d["block"]),
                   int(d["ctas"]))


def plan_from_dict(d):
    """The card plan of a rung's ``card`` field: by the ``kernel`` it names,
    the 8-bit ring's ``modes.Q8Plan`` ("q8"), the chain's
    ``modes.ChainPlan`` ("chain") or a fused kernel's ``FusedPlan``; with
    no ``kernel``, B1's ``cuda_gen.CardPlan`` (every plan DB written before
    fused plans existed); or None without one."""
    if d and "kernel" in d:
        kinds = {"q8": Q8Plan, "chain": ChainPlan}
        return kinds.get(d["kernel"], FusedPlan).from_dict(d)
    return CardPlan.from_dict(d)


def _plan_state(plan, kernel: str, body: str) -> Optional[FusedPlan]:
    """The plan where a launch of ``kernel``'s ``body`` takes it, else None;
    ``obs`` counts a given plan under ``ops.card_plan.applied`` or
    ``.skipped``."""
    if plan is None:
        return None
    taken = isinstance(plan, FusedPlan) and (plan.kernel, plan.body) == (
        kernel, body)
    from ..obs import counter

    counter(f"ops.card_plan.{'applied' if taken else 'skipped'}").inc()
    return plan if taken else None


def _knobs(plan: Optional[FusedPlan]) -> Tuple[int, int]:
    """The plan arguments of a kernel's launch entry: (block, ctas), (0, 0)
    for a body that takes no plan."""
    return (0, 0) if plan is None else (plan.block, plan.ctas)


def _on(plan: Optional[FusedPlan]) -> str:
    return "" if plan is None else f" on {tuple(plan)}"


def attention_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which body of ``attention.cu`` takes q (H, S, D), k (H, T, D), v (H,
    T, E).  bf16 q, k and v: ``"ring"`` (TMA and wgmma) where d and e are
    multiples of 8 up to 128, T >= 1, and TMA reads each as it lies (unit
    stride along d or e, every other stride of an axis longer than 1 a
    positive multiple of 8 elements, 16-byte aligned data), else ``"mma"``
    (the mma.sync body: wide or unaligned heads, element strides).  f32:
    ``"tc32"`` (3xTF32 on the tensor cores) where d and e are at most 128,
    else ``"fma"``.  Mixed dtypes name the body of q's dtype (the launcher
    refuses them).  A pure function of the tensors' dtypes, shapes,
    strides and addresses; ``attention_launch_plan`` checks the same rules
    and refuses a body they exclude."""
    d, e = q.shape[2], v.shape[2]
    if q.dtype == k.dtype == v.dtype == torch.float32:
        return "tc32" if max(d, e) <= ATTN_TC32_MAX_HEAD else "fma"
    if q.dtype != torch.bfloat16:
        return "fma"
    ring = (k.dtype == v.dtype == torch.bfloat16 and d % 8 == 0
            and e % 8 == 0 and max(d, e) <= ATTN_RING_MAX_HEAD
            and k.shape[1] >= 1
            and all(tma_operand(x, 2, 2) for x in (q, k, v)))
    return "ring" if ring else "mma"


def attention_ring_tiles(h: int, s: int) -> int:
    """The ring's tiles: (head, 128 rows of s) pairs."""
    return h * -(-s // ATTN_RING_BM)


def tc32_block_fits(d: int, e: int, block: int) -> bool:
    """Whether the 3xTF32 body's tiles (attention.cu's TcLayout) fit a
    block's shared memory at d, e (padded to 64 or 128) and a KV block of
    ``block`` columns."""
    dp, ep = (64 if x <= 64 else 128 for x in (d, e))
    floats = (128 * (dp + 8) + block * dp + block * ep
              + 4 * block * (dp // 2 + 4) + 4 * (block // 2) * (ep + 2))
    return floats * 4 <= _SMEM_MAX


def attention_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sms: Optional[int] = None) -> Optional[FusedPlan]:
    """B2's launch without a searched plan, as a ``FusedPlan``: the ring's
    KV block of 128 columns on one persistent CTA an SM (``sms``, the
    card's count; an H100's 132 by default), at most one a tile; the
    3xTF32 body's KV block of 32; None for the mma.sync and FMA bodies,
    which take no plan.  Reads only dtypes, shapes, strides and
    addresses."""
    return _attention_plan_of(attention_body(q, k, v), q.shape[0],
                              q.shape[1], sms)


def _attention_plan_of(body: str, h: int, s: int,
                       sms: Optional[int]) -> Optional[FusedPlan]:
    """``attention_plan`` of a body already picked, at h heads of s rows."""
    if body == "ring":
        return FusedPlan("attention", "ring", ATTN_RING_BLOCKS[0],
                         min(attention_ring_tiles(h, s), sms or H100_SMS))
    if body == "tc32":
        return FusedPlan("attention", "tc32", ATTN_TC32_BLOCKS[0], 0)
    return None


def attention_mask(h: int, s: int, t: int, *, causal: bool,
                   kv_lengths: Optional[torch.Tensor],
                   device) -> torch.Tensor:
    """Bool (1 or h, s, t): True where row s sees column t -- ``causal``:
    column <= row; ``kv_lengths`` (one per head): column < length."""
    col = torch.arange(t, device=device)
    valid = torch.ones((1, s, t), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (col[None, :] <= torch.arange(s, device=device)
                         [:, None])
    if kv_lengths is not None:
        valid = valid & (col < kv_lengths.to(device).reshape(h, 1, 1))
    return valid


def attention_probs(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                    kv_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 probabilities (h, s, t) of kernel B2's semantics.

    Scores ``q.k^T * d^-0.5``; masked ones (``causal``: column after the
    row; ``kv_lengths``: column at or past the head's length) take the
    finite ``MASK_VALUE``, probabilities are re-zeroed where masked, and a
    row with no visible column is all zeros -- the reference kernel's
    arithmetic without its blocking.  Natively differentiable; the
    attention backward recomputes P through it.
    """
    h, s, d = q.shape
    t = k.shape[1]
    sc = torch.matmul(q.float(), k.float().transpose(1, 2)) * float(d) ** -0.5
    valid = attention_mask(h, s, t, causal=causal, kv_lengths=kv_lengths,
                           device=q.device)
    sc = torch.where(valid, sc, MASK_VALUE)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True).detach())
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.where(l == 0.0, 1.0, l)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, kv_lengths: Optional[torch.Tensor],
                  out_dtype) -> torch.Tensor:
    """The plain PyTorch version of kernel B2: ``attention_probs`` times v
    in f32; rows with no visible column store exact zeros."""
    p = attention_probs(q, k, causal=causal, kv_lengths=kv_lengths)
    return torch.matmul(p, v.float()).to(out_dtype)


class AttentionLauncher:
    """The ctypes wrapper of ``attention_launch_plan`` (kernel B2); counts
    its launches, one per call, and nothing else.  ``last_body`` names the
    body of the latest launch (``attention_body``'s), ``last_plan`` the
    ``FusedPlan`` it ran (the searched one, else ``attention_plan``'s;
    None on a body with no plan).  The ring's tile counter
    (two ints, which each launch leaves at zero) comes from a pool kept per
    (device, stream), as B1's scratch (``cuda_gen._Scratch``): launches on
    one stream run in order, so they share it safely."""

    def __init__(self):
        self.launches = 0
        self.last_body = None
        self.last_plan: Optional[FusedPlan] = None
        self._lib = None
        self._scratch = _Scratch()

    def _fn(self):
        if self._lib is None:
            from .build import load

            lib = load("attention")
            args = ([ctypes.c_int] * 4
                    + [ctypes.c_void_p] * 6
                    + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 8
                    + [ctypes.c_void_p])
            # a named body on its heuristic plan, for callers with no plan
            lib.attention_launch.argtypes = args
            lib.attention_launch.restype = ctypes.c_int
            # (block, ctas, ...): the plan first
            lib.attention_launch_plan.argtypes = [ctypes.c_int] * 2 + args
            lib.attention_launch_plan.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, kv_lengths: Optional[torch.Tensor],
                 out_dtype: torch.dtype,
                 plan: Optional[FusedPlan] = None) -> torch.Tensor:
        """q (H, S, D), k (H, T, D), v (H, T, E) -> new (H, S, E) tensor;
        ``kv_lengths`` is None or an int32 (H,) tensor on q's device.
        ``attention_body`` picks the body.  The launch runs ``plan`` (a
        searched ``FusedPlan``) where it names that body, else the body's
        heuristic (``attention_plan``); a plan the kernel refuses
        raises."""
        tensors = (q, k, v) + (() if kv_lengths is None else (kv_lengths,))
        if q.device.type != "cuda" or any(x.device != q.device
                                          for x in tensors):
            raise ValueError(
                f"attention kernel takes CUDA tensors on one device, got "
                f"{[str(x.device) for x in tensors]}"
            )
        if not q.dtype == k.dtype == v.dtype or q.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"attention kernel takes float32 or bfloat16 q, k and v of "
                f"one dtype, got {q.dtype}, {k.dtype} and {v.dtype}"
            )
        if out_dtype not in _KERNEL_DTYPES:
            raise TypeError(f"attention kernel writes float32 or bfloat16, "
                            f"not {out_dtype}")
        if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or (
            k.shape[0] != q.shape[0] or v.shape[0] != q.shape[0]
            or k.shape[2] != q.shape[2] or v.shape[1] != k.shape[1]
        ):
            raise ValueError(f"attention kernel takes q (H, S, D), k (H, T, "
                             f"D) and v (H, T, E), got {tuple(q.shape)}, "
                             f"{tuple(k.shape)} and {tuple(v.shape)}")
        h, s, d = q.shape
        t, e = k.shape[1], v.shape[2]
        if max(d, e) > ATTN_MAX_HEAD:
            raise ValueError(f"attention kernel takes d and e up to "
                             f"{ATTN_MAX_HEAD}, got d {d}, e {e}")
        if kv_lengths is not None and (
            kv_lengths.dtype != torch.int32 or tuple(kv_lengths.shape) != (h,)
            or not kv_lengths.is_contiguous()
        ):
            raise ValueError(f"attention kernel takes kv_lengths as a "
                             f"contiguous int32 ({h},) tensor")
        # rows must be unit-stride along d / e; heads and rows any stride
        q, k, v = (x if x.stride(2) == 1 or x.shape[2] == 1 else
                   x.contiguous() for x in (q, k, v))
        if min(min(x.stride()) for x in (q, k, v)) < 0:
            raise ValueError("attention kernel takes non-negative strides")
        if h > _MAX_GRID_Y:
            raise ValueError(f"attention kernel grid too large: {h} heads")
        if max(s, t, *q.stride(), *k.stride(), *v.stride()) >= 2**31:
            raise ValueError("attention kernel takes extents and strides "
                             "below 2**31")
        body = attention_body(q, k, v)
        out = torch.empty((h, s, e), dtype=out_dtype, device=q.device)
        if out.numel() == 0:
            return out
        plan = _plan_state(plan, "attention", body) or _attention_plan_of(
            body, h, s, _sm_count(q.device))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _, sched = self._scratch.get(q.device, stream, 0, 2)
        lib = self._fn()
        args = (
            _KERNEL_DTYPES[q.dtype], _KERNEL_DTYPES[out_dtype], int(causal),
            ATTENTION_BODIES.index(body),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if kv_lengths is None else kv_lengths.data_ptr(),
            sched.data_ptr(), h, s, t, d, e,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1), stream,
        )
        rc = lib.attention_launch_plan(*_knobs(plan), *args)
        if rc != 0:
            self._scratch.drop(q.device, stream)
            raise RuntimeError(f"attention kernel launch failed ({body} "
                               f"body{_on(plan)}): cudaGetLastError() = {rc}")
        self.launches += 1
        self.last_body = body
        self.last_plan = plan
        return out


#: the process's one B2 launcher; ``ATTENTION.launches`` is its count
ATTENTION = AttentionLauncher()


def _group_offsets(group_sizes: Tuple[int, ...]) -> List[int]:
    offs, o = [], 0
    for s in group_sizes:
        offs.append(o)
        o += s
    return offs


def grouped_ref(x: torch.Tensor, w: torch.Tensor,
                group_sizes: Tuple[int, ...], *, out_dtype,
                contract_last: bool = False) -> torch.Tensor:
    """The plain PyTorch version: a per-group loop over f32 upcasts.

    ``x[rows of g] @ w[g]`` (``w[g].T`` with ``contract_last``, the dX
    orientation) for every non-empty group, accumulated in f32 and cast
    once to ``out_dtype``; rows of no group stay zero (there are none when
    the sizes sum to the row count).
    """
    n_out = w.shape[1] if contract_last else w.shape[2]
    out = torch.zeros((x.shape[0], n_out), dtype=torch.float32,
                      device=x.device)
    for g, (o, s) in enumerate(zip(_group_offsets(group_sizes),
                                   group_sizes)):
        if s:
            wg = w[g].float()
            out[o:o + s] = x[o:o + s].float() @ (wg.T if contract_last
                                                 else wg)
    return out.to(out_dtype)


def grouped_dw_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: Tuple[int, ...], *,
                   out_dtype) -> torch.Tensor:
    """The plain PyTorch version of the dW mode: a per-group loop.

    ``out[g] = lhs[rows of g].T @ rhs[rows of g]`` over f32 upcasts, cast
    once to ``out_dtype``; an empty group's slab is exact zeros.
    """
    out = torch.zeros((len(group_sizes), lhs.shape[1], rhs.shape[1]),
                      dtype=torch.float32, device=lhs.device)
    for g, (o, s) in enumerate(zip(_group_offsets(group_sizes),
                                   group_sizes)):
        if s:
            out[g] = lhs[o:o + s].float().T @ rhs[o:o + s].float()
    return out.to(out_dtype)


#: B3's bodies: the M tiles' bodies on 16-byte copies (bf16 operands as
#: ``grouped_body`` reads them; the only ones that take a plan), the
#: element-wise mma.sync body (other bf16 operands), the FMA pipes (f32)
GROUPED_BODIES = ("ring", "mma", "fma")


def grouped_body(x: torch.Tensor, w: torch.Tensor,
                 contract_last: bool = False) -> str:
    """Which body of ``grouped.cu`` takes x (rows, K) and w (G, K, N)
    (``(G, N, K)`` with ``contract_last``): ``"fma"`` for f32; for bf16
    ``"ring"`` (the 16-, 32-, 64-row mma.sync bodies, the serving body and
    the 128-row wgmma body, picked by the M tile, all fed by 16-byte
    cp.async copies) where ``grouped.cu``'s ``bf16_vec`` holds -- x
    k-contiguous, K a multiple of 8, w's unit-stride axis k (then n's
    stride a multiple of 8) or n (then k's stride and N multiples of 8),
    the row and group strides multiples of 8 elements, both bases 16-byte
    aligned -- else ``"mma"`` (element-wise copies into one 128-row
    mma.sync body).  A pure function of dtypes, shapes, strides and
    addresses."""
    if x.dtype != torch.bfloat16:
        return "fma"
    k_ax, n_ax = (2, 1) if contract_last else (1, 2)
    k, n = x.shape[1], w.shape[n_ax]
    s_wg, s_wk, s_wn = w.stride(0), w.stride(k_ax), w.stride(n_ax)
    wnk = s_wk == 1 and s_wn != 1
    w_vec = (s_wn % 8 == 0 and k % 8 == 0) if wnk else (
        s_wn == 1 and s_wk % 8 == 0 and n % 8 == 0)
    vec = (w_vec and x.stride(1) == 1 and k % 8 == 0
           and x.stride(0) % 8 == 0 and s_wg % 8 == 0
           and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    return "ring" if vec else "mma"


def _tile_of(max_rows: int) -> int:
    """The M tile the launcher runs without a searched plan for blocks of
    up to ``max_rows`` rows: the smallest of ``GROUPED_TILES`` that holds
    them."""
    return next(t for t in GROUPED_TILES if max_rows <= t)


class GroupedLauncher:
    """The ctypes wrapper of ``grouped_launch_plan``; counts its launches.

    ``launches`` goes up by one for every kernel launch and for nothing
    else, so a run can show that its expert products went through B3.
    ``last_body`` names the body of the latest launch (``grouped_body``'s),
    ``last_plan`` the ``FusedPlan`` it ran (its M tile: the searched
    plan's, else the one ``max_rows`` picks; None on a body with no
    plan).
    """

    def __init__(self):
        self.launches = 0
        self.last_body: Optional[str] = None
        self.last_plan: Optional[FusedPlan] = None
        self._lib = None

    def _fn(self):
        if self._lib is None:
            from .build import load

            lib = load("grouped")
            # (tile_m, dtypes, pointers, n_blocks, band, N, K, strides)
            lib.grouped_launch_plan.argtypes = (
                [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 7
                + [ctypes.c_void_p])
            lib.grouped_launch_plan.restype = ctypes.c_int
            lib.grouped_max_rows.restype = ctypes.c_int
            if lib.grouped_max_rows() != GROUPED_MAX_ROWS:
                raise RuntimeError(f"grouped.cu takes row blocks of up to "
                                   f"{lib.grouped_max_rows()} rows, "
                                   f"GROUPED_MAX_ROWS says "
                                   f"{GROUPED_MAX_ROWS}")
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
                 max_rows: int, out_dtype: torch.dtype,
                 contract_last: bool = False, band: int = 1,
                 plan: Optional[FusedPlan] = None) -> torch.Tensor:
        """x (rows, K) and w (G, K, N) (``(G, N, K)`` with
        ``contract_last``) -> new (rows, N) tensor.  ``table`` is the int32
        (n_blocks, 3) table of row blocks (group id, first row, rows; no
        block across two groups, ``group_table``) on x's device;
        ``max_rows`` its largest row count (at most ``GROUPED_MAX_ROWS``),
        which picks the M tile; ``band`` the row blocks rasterized side by
        side (the most any group has).  ``plan`` (a searched
        ``FusedPlan``) names the M tile instead where the launch runs its
        body (its blocks must hold at most that many rows); a plan the
        kernel refuses raises."""
        if x.device.type != "cuda" or w.device != x.device or (
            table.device != x.device
        ):
            raise ValueError(
                f"grouped kernel takes CUDA tensors on one device, got "
                f"{x.device}, {w.device} and table on {table.device}"
            )
        if x.dtype != w.dtype or x.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"grouped kernel takes two float32 or two bfloat16 "
                f"operands, got {x.dtype} and {w.dtype}"
            )
        if out_dtype not in _KERNEL_DTYPES:
            raise TypeError(f"grouped kernel writes float32 or bfloat16, "
                            f"not {out_dtype}")
        k_ax, n_ax = (2, 1) if contract_last else (1, 2)
        if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[k_ax]:
            raise ValueError(f"grouped kernel takes x (rows, K) and w with K "
                             f"on axis {k_ax}, got {tuple(x.shape)} and "
                             f"{tuple(w.shape)}")
        if table.dtype != torch.int32 or table.dim() != 2 or (
            table.shape[1] != 3 or not table.is_contiguous()
        ):
            raise ValueError("grouped kernel takes a contiguous int32 "
                             "(n_live, 3) group table")
        if min(x.stride()) < 0 or min(w.stride()) < 0:
            raise ValueError("grouped kernel takes non-negative strides")
        if not 1 <= max_rows <= GROUPED_MAX_ROWS or band < 1:
            raise ValueError(f"grouped kernel takes row blocks of 1 to "
                             f"{GROUPED_MAX_ROWS} rows and a band of 1 or "
                             f"more, got {max_rows} and {band}")
        body = grouped_body(x, w, contract_last)
        plan = _plan_state(plan, "grouped", body)
        if plan is not None and max_rows > plan.block:
            raise ValueError(f"grouped kernel: plan {tuple(plan)} takes "
                             f"blocks of up to {plan.block} rows, the table "
                             f"holds {max_rows}")
        if plan is None and body == "ring":
            plan = FusedPlan("grouped", "ring", _tile_of(max_rows), 0)
        rows, k = x.shape
        n = w.shape[n_ax]
        n_live = table.shape[0]
        # the f32 and the 16-row serving bodies put the blocks on grid y
        if (n_live > _MAX_GRID_Y if x.dtype == torch.float32 or (
                plan is not None and plan.block <= 16)
                else n_live * -(-n // 128) >= 2**31):
            raise ValueError(f"grouped kernel grid too large: {n_live} "
                             f"row blocks")
        if max(rows, n, k, *x.stride(), *w.stride()) >= 2**31:
            raise ValueError("grouped kernel takes extents and strides "
                             "below 2**31")
        out = torch.zeros((rows, n), dtype=out_dtype, device=x.device)
        if n_live == 0 or n == 0:
            return out
        lib = self._fn()
        dtypes = (_KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[out_dtype])
        ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), table.data_ptr())
        tail = (n, k, *x.stride(), w.stride(0), w.stride(k_ax),
                w.stride(n_ax), *out.stride(),
                torch.cuda.current_stream(x.device).cuda_stream)
        rc = lib.grouped_launch_plan(_knobs(plan)[0], *dtypes, *ptrs, n_live,
                                     band, *tail)
        if rc != 0:
            raise RuntimeError(f"grouped kernel launch failed ({body} "
                               f"body{_on(plan)}): cudaGetLastError() = {rc}")
        self.launches += 1
        self.last_body = body
        self.last_plan = plan
        return out


#: the process's one launcher; ``GROUPED.launches`` is the launch count
GROUPED = GroupedLauncher()


#: B4's bodies: the TMA / wgmma ring and mma.sync (bf16 operands), the FMA
#: pipes (f32)
DW_BODIES = ("ring", "mma", "fma")


def grouped_dw_body(lhs: torch.Tensor, rhs: torch.Tensor) -> str:
    """Which body of ``grouped_dw.cu`` takes lhs (N, K1) and rhs (N, K2):
    ``"ring"`` for two bf16 operands TMA reads as they lie -- unit stride
    along K1 and K2, K1 and K2 multiples of 8, row strides positive
    multiples of 8 elements (16 bytes) where N > 1, 16-byte aligned data,
    at least one row; ``"mma"`` for other bf16 operands; ``"fma"`` for
    f32.  A pure function of the tensors' dtypes, shapes, strides and
    addresses; ``grouped_dw.cu``'s ``ring_ok`` checks the same (and the
    output the launcher allocates, contiguous) and refuses what fails
    it."""
    if lhs.dtype == torch.float32:
        return "fma"

    def ok(x):
        n, k = x.shape
        return (k % 8 == 0 and x.stride(1) == 1 and n >= 1 and (
            n == 1 or (x.stride(0) > 0 and x.stride(0) % 8 == 0))
            and x.data_ptr() % 16 == 0)

    both = lhs.dtype == rhs.dtype == torch.bfloat16
    return "ring" if both and ok(lhs) and ok(rhs) else "mma"


def dw_ring_tiles(n_groups: int, k1: int, k2: int, width: int) -> int:
    """B4's ring tiles: (group, 128 rows of K1, ``width`` columns of K2)."""
    return n_groups * -(-k1 // DW_RING_BM) * -(-k2 // width)


def grouped_dw_plan(lhs: torch.Tensor, rhs: torch.Tensor, n_groups: int,
                    sms: Optional[int] = None) -> Optional[FusedPlan]:
    """B4's launch without a searched plan, as a ``FusedPlan``: the ring's
    256-column tiles on one persistent CTA an SM (``sms``, the card's
    count; an H100's 132 by default), at most one a tile; None for the
    mma.sync and FMA bodies, which take no plan."""
    return _dw_plan_of(grouped_dw_body(lhs, rhs), n_groups, lhs.shape[1],
                       rhs.shape[1], sms)


def _dw_plan_of(body: str, n_groups: int, k1: int, k2: int,
                sms: Optional[int]) -> Optional[FusedPlan]:
    """``grouped_dw_plan`` of a body already picked."""
    if body != "ring":
        return None
    width = DW_RING_WIDTHS[0]
    tiles = dw_ring_tiles(n_groups, k1, k2, width)
    return FusedPlan("grouped_dw", "ring", width, min(tiles, sms or H100_SMS))


class GroupedDwLauncher:
    """The ctypes wrapper of ``grouped_dw_launch_plan`` (kernel B4); counts
    its launches, one per call, and nothing else.  ``last_body`` names the
    body of the latest launch (``DW_BODIES``), ``last_plan`` the
    ``FusedPlan`` it ran (the searched one, else ``grouped_dw_plan``'s;
    None on a body with no plan)."""

    def __init__(self):
        self.launches = 0
        self.last_body: Optional[str] = None
        self.last_plan: Optional[FusedPlan] = None
        self._lib = None

    def _fn(self):
        if self._lib is None:
            from .build import load

            lib = load("grouped_dw")
            # (tile_n, ctas, dtypes, pointers, n_rows, n_groups, K1, K2,
            # strides, stream)
            lib.grouped_dw_launch_plan.argtypes = (
                [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 7
                + [ctypes.c_void_p])
            lib.grouped_dw_launch_plan.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, lhs: torch.Tensor, rhs: torch.Tensor,
                 table: torch.Tensor, out_dtype: torch.dtype, *,
                 body: Optional[str] = None,
                 plan: Optional[FusedPlan] = None) -> torch.Tensor:
        """lhs (N, K1) and rhs (N, K2) -> new (G, K1, K2) tensor, G the
        rows of ``table``: the int32 (G, 3) table of every group (id,
        first row, rows), in row order, on lhs's device.  ``body`` forces
        a body (``DW_BODIES``; default ``grouped_dw_body``'s choice); one
        the operands cannot take raises.  The ring runs ``plan`` (a
        searched ``FusedPlan``) where one is given, else its heuristic
        (``grouped_dw_plan``); a plan the kernel refuses raises."""
        if lhs.device.type != "cuda" or rhs.device != lhs.device or (
            table.device != lhs.device
        ):
            raise ValueError(
                f"grouped dW kernel takes CUDA tensors on one device, got "
                f"{lhs.device}, {rhs.device} and table on {table.device}"
            )
        if lhs.dtype != rhs.dtype or lhs.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"grouped dW kernel takes two float32 or two bfloat16 "
                f"operands, got {lhs.dtype} and {rhs.dtype}"
            )
        if out_dtype not in _KERNEL_DTYPES:
            raise TypeError(f"grouped dW kernel writes float32 or bfloat16, "
                            f"not {out_dtype}")
        if lhs.dim() != 2 or rhs.dim() != 2 or lhs.shape[0] != rhs.shape[0]:
            raise ValueError(f"grouped dW kernel takes lhs (N, K1) and rhs "
                             f"(N, K2), got {tuple(lhs.shape)} and "
                             f"{tuple(rhs.shape)}")
        if table.dtype != torch.int32 or table.dim() != 2 or (
            table.shape[1] != 3 or not table.is_contiguous()
        ):
            raise ValueError("grouped dW kernel takes a contiguous int32 "
                             "(G, 3) group table")
        if min(lhs.stride()) < 0 or min(rhs.stride()) < 0:
            raise ValueError("grouped dW kernel takes non-negative strides")
        chosen = grouped_dw_body(lhs, rhs)
        if body is None:
            body = chosen
        elif body not in DW_BODIES:
            raise ValueError(f"grouped dW kernel: unknown body {body!r}; "
                             f"have {DW_BODIES}")
        elif body == "ring" and chosen != "ring":
            raise ValueError(f"grouped dW kernel: the ring body cannot take "
                             f"{lhs.dtype} operands of shapes "
                             f"{tuple(lhs.shape)}, {tuple(rhs.shape)} and "
                             f"strides {lhs.stride()}, {rhs.stride()}")
        elif body != "ring" and body != (
            "fma" if lhs.dtype == torch.float32 else "mma"
        ):
            raise ValueError(f"grouped dW kernel: the {body} body does not "
                             f"take {lhs.dtype} operands")
        n_groups = table.shape[0]
        n_rows, k1, k2 = lhs.shape[0], lhs.shape[1], rhs.shape[1]
        if body != "ring" and (n_groups > _MAX_GRID_Y
                               or -(-k1 // 64) > _MAX_GRID_Y):
            raise ValueError(f"grouped dW kernel grid too large: {n_groups} "
                             f"groups, K1 {k1}")
        if max(n_rows, n_groups, k1, k2, *lhs.stride(),
               *rhs.stride()) >= 2**31:
            raise ValueError("grouped dW kernel takes extents and strides "
                             "below 2**31")
        out = torch.empty((n_groups, k1, k2), dtype=out_dtype,
                          device=lhs.device)
        if out.numel() == 0:
            return out
        plan = _plan_state(plan, "grouped_dw", body) or _dw_plan_of(
            body, n_groups, k1, k2, _sm_count(lhs.device))
        lib = self._fn()
        args = (
            _KERNEL_DTYPES[lhs.dtype], _KERNEL_DTYPES[out_dtype],
            lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), table.data_ptr(),
            n_rows, n_groups, k1, k2, *lhs.stride(), *rhs.stride(),
            *out.stride(),
            torch.cuda.current_stream(lhs.device).cuda_stream,
        )
        rc = lib.grouped_dw_launch_plan(*_knobs(plan), *args)
        if rc != 0:
            raise RuntimeError(f"grouped dW kernel launch failed ({body} "
                               f"body{_on(plan)}): cudaGetLastError() = {rc}")
        self.launches += 1
        self.last_body = body
        self.last_plan = plan
        return out


#: the process's one B4 launcher; ``GROUPED_DW.launches`` is its count
GROUPED_DW = GroupedDwLauncher()


def grouped_tile_m(group_sizes: Tuple[int, ...]) -> int:
    """B3's M tile for these group sizes: the smallest of ``GROUPED_TILES``
    that holds the largest group, and at most 64 rows unless the non-empty
    groups average more than 64 (training's C = 320), where the 128-row
    body pays; a few large groups among small ones (ragged serving) take
    more 64-row blocks instead."""
    live = [s for s in group_sizes if s]
    cap = GROUPED_MAX_ROWS if live and sum(live) > 64 * len(live) else 64
    return next(t for t in GROUPED_TILES if min(max(live, default=0), cap)
                <= t)


def contracts_last(spec: ContractionSpec) -> bool:
    """Whether a grouped row-mode spec is the dX orientation: the shared
    axis is w's last (w's trailing strides are passed swapped)."""
    root = spec.root()
    xname, wname = root.operands
    return root.operands[wname].index(root.operands[xname][1]) == 2


def dw_operands(spec: ContractionSpec, arrays) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(lhs (n, o1), rhs (n, o2)) of a dW-mode spec, output (g, o1, o2),
    from ``arrays`` in spec order, whichever order the spec lists them in,
    as the reference's ``order``."""
    root = spec.root()
    _, o1, o2 = root.output
    by_name = dict(zip(root.operands, arrays))
    return tuple(by_name[next(n for n in root.operands
                              if o in root.operands[n])] for o in (o1, o2))


def grouped_plan(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: Tuple[int, ...],
                 contract_last: bool = False) -> Optional[FusedPlan]:
    """B3's launch without a searched plan, as a ``FusedPlan``: the M tile
    ``grouped_tile_m`` picks (the tile the launcher runs for its
    table); None for the element-wise mma.sync and FMA bodies, which take
    no plan (``grouped_body``)."""
    if grouped_body(x, w, contract_last) != "ring":
        return None
    return FusedPlan("grouped", "ring", grouped_tile_m(group_sizes), 0)


def group_table(group_sizes: Tuple[int, ...],
                tile_m: Optional[int] = None) -> List[Tuple[int, int, int]]:
    """(group id, first row, rows) of every row block, in order: each
    non-empty group cut into blocks of ``tile_m`` rows (default
    ``grouped_tile_m``'s; a plan's M tile) and a ragged tail, so no block
    spans two groups and empty groups have none."""
    if tile_m is None:
        tile_m = grouped_tile_m(group_sizes)
    return [(g, o + r, min(tile_m, s - r)) for g, (o, s) in
            enumerate(zip(_group_offsets(group_sizes), group_sizes))
            for r in range(0, s, tile_m)]


@dataclasses.dataclass
class FusedKernel:
    """A fused kernel bound to one (spec, schedule) pair.

    Call with the operand tensors in ``spec.operands`` order, shaped as the
    plan's local extents; attention also takes ``kv_lengths=`` (one int32
    per folded head).  CUDA tensors launch ``csrc/attention.cu``,
    ``csrc/grouped.cu`` (row mode) or ``csrc/grouped_dw.cu`` (dW mode),
    on ``card`` (a searched ``FusedPlan``) where the launch runs its body,
    else on the launcher's heuristic; CPU tensors run ``attention_ref``,
    ``grouped_ref`` or ``grouped_dw_ref``.
    """

    spec: ContractionSpec
    schedule: Schedule
    plan: KernelPlan
    out_dtype: Optional[torch.dtype]
    interpret: bool
    kind: str
    card: Optional[FusedPlan] = None
    _tables: Dict[tuple, Tuple[torch.Tensor, int, int]] = (
        dataclasses.field(repr=False, default_factory=dict))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.spec.operands)

    @property
    def dw(self) -> bool:
        """True for the dW mode: the output carries the group axis."""
        return "g" in self.spec.output

    @property
    def contract_last(self) -> bool:
        """True for the dX orientation: the shared axis is w's last."""
        return contracts_last(self.spec)

    def _dw_operands(self, arrays) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lhs (n, o1), rhs (n, o2)): ``dw_operands`` of the spec."""
        return dw_operands(self.spec, arrays)

    def _table(self, device: torch.device, tile_m: Optional[int] = None
               ) -> Tuple[torch.Tensor, int, int]:
        """(the device table, its largest row count, the band): every group
        for the dW mode (an empty one's CTAs store zeros), else
        ``group_table``'s row blocks at the M tile ``tile_m`` (default
        ``grouped_tile_m``'s)."""
        entry = self._tables.get((device, tile_m))
        if entry is None:
            sizes = tuple(self.spec.root().group_sizes)
            if self.dw:
                rows = [(g, o, s) for g, (o, s) in
                        enumerate(zip(_group_offsets(sizes), sizes))]
                band = 1
            else:
                tile = tile_m or grouped_tile_m(sizes)
                rows = group_table(sizes, tile)
                band = max(1, -(-max(sizes) // tile))
            table = torch.tensor(rows, dtype=torch.int32,
                                 device=device).reshape(-1, 3)
            entry = (table, max((r[2] for r in rows), default=0), band)
            self._tables[(device, tile_m)] = entry
        return entry

    def __call__(self, *arrays: torch.Tensor, kv_lengths=None):
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
        devices = {arr.device.type for arr in arrays}
        if devices not in ({"cpu"}, {"cuda"}):
            raise ValueError(f"{self.spec.name}: operands on "
                             f"{sorted(devices)}; all CPU (plain version) "
                             f"or all CUDA (kernel)")
        from ..ops import library

        direct = not library.through_op(arrays)
        # on DTensors the op's sharding rule places the operands (a plain
        # one is taken as replicated) and each rank runs its shard
        sharded = any(library.is_dtensor(x) for x in arrays)

        if self.kind == "attention":
            q = arrays[0]
            lengths = None
            if kv_lengths is not None:
                lengths = torch.as_tensor(kv_lengths, device=q.device).to(
                    torch.int32).reshape(-1).contiguous()
                h = self.spec.extents["h"]
                if lengths.shape[0] != h:
                    raise ValueError(f"kv_lengths: expected {h} entries, "
                                     f"got {lengths.shape[0]}")
            out_dtype = self.out_dtype or q.dtype
            if sharded:
                return library.sharded_attention(self, *arrays, lengths,
                                                 out_dtype)
            if direct:
                return self.run_attention(*arrays, lengths, out_dtype)
            return library.ATTENTION_OP(library.key_of(self), *arrays,
                                        lengths, out_dtype)
        if kv_lengths is not None:
            raise TypeError("kv_lengths only applies to attention kernels")
        out_dtype = self.out_dtype or arrays[0].dtype
        if sharded:
            return library.sharded_grouped(self, *arrays, out_dtype)
        if direct:
            return self.run_grouped(*arrays, out_dtype)
        op = library.GROUPED_DW_OP if self.dw else library.GROUPED_OP
        return op(library.key_of(self), *arrays, out_dtype)

    def run_grouped(self, x: torch.Tensor, w: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
        """The launch, called directly or as ``repro_torch::grouped`` /
        ``::grouped_dw`` (``ops.library.through_op``; ``x`` and ``w`` the
        spec's operands in its order): CUDA tensors launch B3 or B4, CPU
        tensors run ``grouped_ref`` / ``grouped_dw_ref``."""
        sizes = tuple(self.spec.root().group_sizes)
        cpu = x.device.type == "cpu"
        if self.dw:
            lhs, rhs = self._dw_operands((x, w))
            if cpu:
                return grouped_dw_ref(lhs, rhs, sizes, out_dtype=out_dtype)
            return GROUPED_DW(lhs, rhs, self._table(x.device)[0], out_dtype,
                              plan=self.card)
        if cpu:
            return grouped_ref(x, w, sizes, out_dtype=out_dtype,
                               contract_last=self.contract_last)
        # the plan's M tile cuts the table where the launch takes it
        card = self.card
        tile = (card.block if isinstance(card, FusedPlan)
                and (card.kernel, card.body) == (
                    "grouped", grouped_body(x, w, self.contract_last))
                else None)
        table, max_rows, band = self._table(x.device, tile)
        return GROUPED(x, w, table, max(max_rows, 1), out_dtype,
                       contract_last=self.contract_last, band=band,
                       plan=card)

    def run_attention(self, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, lengths: Optional[torch.Tensor],
                      out_dtype: torch.dtype) -> torch.Tensor:
        """The launch, called directly or as ``repro_torch::attention``
        (``ops.library.through_op``): CUDA tensors launch B2, CPU tensors
        run ``attention_ref``."""
        causal = bool(self.spec.root().causal)
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal, kv_lengths=lengths,
                                 out_dtype=out_dtype)
        return ATTENTION(q, k, v, causal, lengths, out_dtype, plan=self.card)


def compile_fused(
    spec: ContractionSpec,
    schedule: Schedule,
    *,
    epilogue=None,
    out_dtype=None,
    interpret: bool = False,
    mesh=None,
    card: Optional[FusedPlan] = None,
) -> FusedKernel:
    """Lower a fused-family spec + Schedule; ``cuda_gen.compile_kernel``
    dispatches here whenever ``spec.root().fused_kind`` is set.  ``card``
    is a searched ``FusedPlan``, which the kernel's launches take where
    they run its body."""
    root = spec.root()
    kind = getattr(root, "fused_kind", "")
    if not kind:
        raise ValueError(f"{root.name} is not a fused spec")
    if epilogue is not None and not getattr(epilogue, "is_identity", False):
        raise NotImplementedError("fused kernels take no epilogue")
    if mesh is not None:
        raise NotImplementedError("fused families have no mesh tier yet")
    if card is not None and not isinstance(card, FusedPlan):
        raise ValueError(f"{root.name}: the fused kernels take a FusedPlan, "
                         f"got {card!r}")
    from ..obs import span

    with span("codegen.compile_fused", spec=root.name, kind=kind):
        plan = build_plan(schedule)
        return FusedKernel(
            spec=plan.spec,
            schedule=schedule,
            plan=plan,
            out_dtype=None if out_dtype is None else _torch_dtype(out_dtype),
            interpret=interpret,
            kind=kind,
            card=card,
        )
