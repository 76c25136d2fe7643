"""ctypes launchers of B1's 8-bit and chain modes.

``csrc/contract_q8.cu`` holds the int8 / fp8 (e4m3) tensor-core
contraction and the CUDA-core upcast body; ``csrc/contract_chain.cu`` the
chain ``C = (X @ Y) @ Z`` with two reductions in one launch.  Each is built
by ``build.load`` at first use, like ``contract.cu``.  One launcher object
per mode, each with its own ``launches`` count, which goes up by one for
every kernel launch and for nothing else:

    CONTRACT_INT8    two int8 operands on the tensor cores (int32 sums)
    CONTRACT_FP8     two fp8 e4m3 operands on the tensor cores (f32 sums);
                     both on the TMA / wgmma ring where ``q8_body`` says
                     so, else on the mma.sync body; the ring also takes
                     the multiplier and the row reduce, and int8 a k-scale
                     (as two byte planes of A, ``int8_planes``)
    CONTRACT_UPCAST  operands of any type the kernel names, upcast on the
                     CUDA cores (int32 or f32 sums), with contract.cu's
                     k-scale, multiplier and row-reduce modes
    CONTRACT_CHAIN   the chain: bf16 on the tensor cores, f32 / int8 /
                     fp8 / int32 operands on the CUDA cores; the CTAs of a
                     cluster split the first reduction (``chain_cluster``)

``codegen.cuda_gen`` folds a spec onto them; ``cuda_gen.contract_ref`` is
the plain version of every mode.  Each launcher takes CUDA tensors, checks
what its kernel takes and raises otherwise; it allocates its output (or
writes into ``out``) and launches once on the current stream.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from .epilogue import ACT_CODES, Epilogue

#: the kernels' dtype codes (operands; outputs take 0, 1 and 4)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3, torch.int32: 4}
OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 4}
_MAX_GRID_YZ = 65535


class _Vec(ctypes.Structure):
    """``struct Vec`` of contract.cu and contract_q8.cu, ``struct
    ChainVec`` of contract_chain.cu: one layout.  ``bf16`` marks a bf16
    vector, which only contract.cu reads (the others' ``pad``, 0)."""

    _fields_ = [("p", ctypes.c_void_p), ("div", ctypes.c_longlong),
                ("len", ctypes.c_longlong), ("axis", ctypes.c_int),
                ("bf16", ctypes.c_int)]


class _Q8Params(ctypes.Structure):
    """``struct Q8Params`` of contract_q8.cu, field for field."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("A", "B", "C", "T")]
        + [(f, ctypes.c_longlong) for f in (
            "batch", "M", "N", "K", "sAb", "sAm", "sAk", "sBb", "sBk", "sBn",
            "sCb", "sCm", "sCn", "sTm", "sTn")]
        + [(f, _Vec) for f in ("kscale", "mul", "qscale", "scale", "bias",
                               "mean", "var")]
        + [("partial", ctypes.c_void_p), ("counter", ctypes.c_void_p),
           ("eps", ctypes.c_float), ("act", ctypes.c_int)]
        + [(f, ctypes.c_int) for f in ("a_dtype", "b_dtype", "t_dtype",
                                       "out_dtype", "acc_int", "body",
                                       "planes")]
    )


class _ChainParams(ctypes.Structure):
    """``struct ChainParams`` of contract_chain.cu, field for field."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("X", "Y", "Z", "C")]
        + [(f, ctypes.c_longlong) for f in (
            "R", "P", "Q", "N", "sXr", "sXp", "sYp", "sYq", "sZq", "sZn",
            "sCr", "sCn")]
        + [(f, _Vec) for f in ("qscale", "scale", "bias", "mean", "var")]
        + [("eps", ctypes.c_float), ("act", ctypes.c_int),
           ("in_dtype", ctypes.c_int), ("out_dtype", ctypes.c_int),
           ("cluster", ctypes.c_int)]
    )


class Q8Plan(NamedTuple):
    """One plan of the 8-bit ring (``q8_ring_kernel``) as the search ranks
    it and the plan DB keeps it (a rung's ``card`` field, beside B1's
    ``cuda_gen.CardPlan``): ``ctas`` the persistent grid's CTAs, each
    walking its tiles (0: one CTA a tile, the launch before plans).  The
    grid changes no value: every tile sums its K in the same order."""

    ctas: int

    def as_dict(self) -> Dict[str, object]:
        return {"kernel": "q8", "body": "ring", "ctas": int(self.ctas)}

    @classmethod
    def from_dict(cls, d) -> "Q8Plan":
        return cls(int(d["ctas"]))


#: the 8-bit ring's launch without a searched plan: one CTA a tile
Q8_HEURISTIC = Q8Plan(0)


class ChainPlan(NamedTuple):
    """One plan of the chain kernel: the association ``assoc`` (``"xy"``:
    (X.Y).Z as written; ``"yz"``: X.(Y.Z), run as the transposed chain
    Z^T Y^T X^T into C^T) and the CTAs a cluster ``cluster`` that split
    the chain's first reduction (1, 2, 4 or 8).  Both change the summation
    order, not the products summed."""

    assoc: str
    cluster: int

    def as_dict(self) -> Dict[str, object]:
        return {"kernel": "chain", "assoc": self.assoc,
                "cluster": int(self.cluster)}

    @classmethod
    def from_dict(cls, d) -> "ChainPlan":
        return cls(str(d["assoc"]), int(d["cluster"]))


def _count_plan(taken: bool) -> None:
    from ..obs import counter

    counter(f"ops.card_plan.{'applied' if taken else 'skipped'}").inc()


class VecArg(NamedTuple):
    """A vector operand: element ``(coord // div) % len`` of ``tensor``
    (contiguous, 1-D, on the card) at folded coordinate ``coord`` of
    ``axis`` (0 batch, 1 m / row, 2 n / column, 3 k)."""

    tensor: torch.Tensor
    axis: int
    div: int = 1


def tma_operand(x: torch.Tensor, unit: int, elem: int) -> bool:
    """Can TMA read the (batch, rows, cols) operand ``x`` of ``elem``-byte
    elements with axis ``unit`` (1 rows, 2 cols) as its contiguous one:
    unit stride there (or extent 1), every other stride of an axis longer
    than 1 a positive multiple of 16 bytes, and 16-byte aligned data
    (``hopper.cuh``'s ``tma_ok``; the rings of ``contract.cu`` and
    ``contract_q8.cu`` refuse what fails it)."""
    other = 3 - unit
    ok = lambda ext, st: ext == 1 or (  # noqa: E731
        st > 0 and st * elem % 16 == 0)
    return ((x.stride(unit) == 1 or x.shape[unit] == 1)
            and ok(x.shape[other], x.stride(other))
            and ok(x.shape[0], x.stride(0)) and x.data_ptr() % 16 == 0)


#: the shortest K an fp8 product takes the ring at.  The ring's e4m3
#: wgmma sums each k32 step with fewer bits than f32 (mma.sync keeps
#: f32's), so its error against the exact product, scaled by max |ref| as
#: the f32 TOL (1e-4) scales it, reaches 1.1e-4 to 1.35e-4 at K <= 64,
#: 7.8e-5 to 8.5e-5 at K = 128..320, and 6.4e-5 or less from K = 384 up
#: to 12288 (an H100, ``scripts/fp8_ring_error.py``; PERF.md).  int8 is
#: exact at any K.
FP8_RING_MIN_K = 384


def q8_body(a: torch.Tensor, b: torch.Tensor) -> str:
    """Which body of ``contract_q8.cu`` takes the tensor-core product of two
    int8 or two fp8 operands a (batch, M, K) @ b (batch, K, N): ``"ring"``
    (TMA and wgmma, which takes only K-major operands) at M >= 64 with A
    and B both k-contiguous as TMA reads them (``tma_operand``: B as
    ``ops.dense(quant=)`` writes its W, ``quantize_channels_kmajor``), and
    for fp8 at K >= ``FP8_RING_MIN_K``; else ``"mma"`` (the n-major B of
    the ragged case, the transposed fold, unaligned operands, decode's
    M < 64, a short fp8 K).  The ring's launch checks the layout rules
    and refuses what fails them."""
    _, m, k = a.shape
    n = b.shape[2]
    if a.dtype != b.dtype or a.dtype not in (torch.int8,
                                             torch.float8_e4m3fn):
        return "mma"
    min_k = FP8_RING_MIN_K if a.dtype == torch.float8_e4m3fn else 1
    if m < 64 or k < min_k or n < 1:
        return "mma"
    return ("ring" if tma_operand(a, 2, 1) and tma_operand(b, 1, 1)
            else "mma")


def q8_ring_refusal(a: torch.Tensor, b: torch.Tensor,
                    kscale: Optional[VecArg] = None) -> Optional[str]:
    """Why the 8-bit ring cannot take a (batch, M, K) @ b (batch, K, N)
    with a k-scale, a multiplier or a row reduce (the modes only the ring
    takes on the tensor cores), or None where it can: ``q8_body`` gives
    the ring for A as the kernel reads it.  A ``kscale`` must be an int8
    vector of K elements on k (div 1) at batch 1 over int8 operands; A is
    then read as its two byte planes (``int8_planes``: contiguous,
    K-major).  Takes meta tensors (``cuda_gen.eight_bit_route``'s K-major
    copies); the ring's launch checks the layout rules again and refuses
    what fails them."""
    batch, m, k = a.shape
    if kscale is not None:
        v = kscale.tensor
        if a.dtype != torch.int8 or v.dtype != torch.int8 or (
            kscale.axis != 3 or kscale.div != 1 or v.dim() != 1
            or v.numel() != k or batch != 1
        ):
            return (f"a k-scale goes in as int8 planes: an int8 vector of "
                    f"{k} elements on k (div 1) at batch 1, int8 operands; "
                    f"got {a.dtype} operands, g {v.dtype} {tuple(v.shape)} "
                    f"on axis {kscale.axis} (div {kscale.div}), batch "
                    f"{batch}")
        a = torch.empty((1, m, k), dtype=torch.int8, device="meta")
    body = q8_body(a, b)
    return None if body == "ring" else f"q8_body gives the {body} body"


#: the 8-bit ring's square CTA tile (contract_q8.cu's QR_BM, checked at
#: load): the row reduce's partial rows and counters are per 128 x 128 tile
Q8_RING_TILE = 128


def int8_planes(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The two int8 byte planes (H, L) of ``a * g`` (a (..., K) and g (K,)
    int8, the weighted spec's k-scale), stacked as a new (2, ..., K)
    int8 tensor: x = a g lies in [-16256, 16384], so h = (x + 128) >> 8
    (in [-63, 64]) and l = x - 256 h (in [-128, 127]) are both int8 and
    256 h + l == x exactly.  A product over k then splits as C = 256 H.B
    + L.B, which the 8-bit ring sums modulo 2^32 as the reference's int32
    sums of a g b.  Plain PyTorch elementwise ops, on whatever device
    ``a`` lies (the pre-pass of ``CONTRACT_INT8``'s k-scale)."""
    if a.dtype != torch.int8 or g.dtype != torch.int8:
        raise TypeError(f"int8_planes takes int8 a and g, got {a.dtype} and "
                        f"{g.dtype}")
    x = a.to(torch.int16) * g.to(torch.int16)
    h = torch.bitwise_right_shift(x + 128, 8)
    out = torch.empty((2,) + tuple(a.shape), dtype=torch.int8,
                      device=a.device)
    out[0] = h
    out[1] = x - h * 256
    return out


def _load(source: str, params, entries):
    from .build import load

    lib = load(source)
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    size = getattr(lib, f"{source.split('_')[-1]}_params_size")
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(params):
        raise RuntimeError(f"{source}.cu's parameter struct is {size()} "
                           f"bytes, its ctypes mirror "
                           f"{ctypes.sizeof(params)}")
    return lib


def set_vec(p, field: str, vec: VecArg, device, dtype, axes, extents):
    """Check ``vec`` against the launch and write it into ``p.<field>``
    (``extents``: the folded (batch, m, n, k) sizes the axes index;
    ``dtype``: the vector's dtype, or a tuple of those the kernel reads)."""
    x = vec.tensor
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if x.device != device or x.dtype not in dtypes or x.dim() != 1 or (
        not x.is_contiguous()
    ):
        raise ValueError(f"vector {field} must be a contiguous 1-D "
                         f"{' or '.join(map(str, dtypes))} tensor on "
                         f"{device}")
    if vec.axis not in axes or vec.div < 1 or x.numel() < 1 or (
        x.numel() * vec.div > max(extents[vec.axis], 1)
    ):
        raise ValueError(f"vector {field} of {x.numel()} elements (div "
                         f"{vec.div}) does not fit axis {vec.axis}")
    setattr(p, field, _Vec(p=x.data_ptr(), div=vec.div, len=x.numel(),
                           axis=vec.axis,
                           bf16=int(x.dtype == torch.bfloat16)))


def set_epilogue(p, epilogue: Optional[Epilogue],
                 vectors: Optional[Dict[str, VecArg]], device, axes,
                 extents, dtype=torch.float32):
    """Write the epilogue's stages and vectors (``dtype``, as ``set_vec``
    takes it: f32 unless the kernel reads others) into ``p``."""
    if epilogue is None:
        if vectors:
            raise TypeError(f"epilogue vectors {sorted(vectors)} without an "
                            f"epilogue")
        return
    want = set(epilogue.vector_names)
    if want != set(vectors or {}):
        raise TypeError(f"epilogue vectors {sorted(vectors or {})}, "
                        f"expected {sorted(want)}")
    for name, vec in (vectors or {}).items():
        set_vec(p, name, vec, device, dtype, axes, extents)
    p.act = ACT_CODES[epilogue.act]
    p.eps = epilogue.eps


def _check_strides(*tensors):
    for x in tensors:
        if min(x.stride(), default=0) < 0:
            raise ValueError("the kernel takes non-negative strides")
        if max((*x.shape, *x.stride()), default=0) >= 2**31:
            raise ValueError("the kernel takes extents and strides below "
                             "2**31")


def _launch(lib, entry: str, p, device, *args):
    rc = getattr(lib, entry)(ctypes.byref(p), *args,
                             torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaGetLastError() = {rc}")


class Contract8Launcher:
    """``contract_q8.cu``: ``entry`` ``"q8_launch"`` (two operands of
    ``dtype``, int8 or fp8, on the tensor cores: the ring or the mma.sync
    body, ``q8_body``) or ``"upcast_launch"`` (any operand types, CUDA
    cores).  ``last_body`` names the body of the latest launch and
    ``last_card`` the ``Q8Plan`` a ring launch ran (None on the mma.sync
    and upcast bodies, which take no plan)."""

    def __init__(self, entry: str, dtype: Optional[torch.dtype] = None):
        self.entry = entry
        self.dtype = dtype
        self.launches = 0
        self.last_body = None
        self.last_card = None
        self._lib = None

    def _fn(self):
        if self._lib is None:
            lib = _load("contract_q8", _Q8Params,
                        ("q8_launch", "upcast_launch"))
            for name in ("q8_tile_m", "q8_tile_n", "upcast_tile_m",
                         "upcast_tile_n", "q8_ring_tile"):
                getattr(lib, name).restype = ctypes.c_int
            lib.q8_plan_launch.argtypes = [ctypes.POINTER(_Q8Params),
                                           ctypes.c_int, ctypes.c_void_p]
            lib.q8_plan_launch.restype = ctypes.c_int
            if lib.q8_ring_tile() != Q8_RING_TILE:
                raise RuntimeError(f"contract_q8.cu's ring tile is "
                                   f"{lib.q8_ring_tile()}, Q8_RING_TILE "
                                   f"says {Q8_RING_TILE}")
            self._lib = lib
        return self._lib

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype, *, int_acc: bool,
                 kscale: Optional[VecArg] = None,
                 mul: Optional[VecArg] = None,
                 epilogue: Optional[Epilogue] = None,
                 vectors: Optional[Dict[str, VecArg]] = None,
                 t: Optional[torch.Tensor] = None,
                 body: Optional[str] = None,
                 plan: Optional[Q8Plan] = None) -> torch.Tensor:
        """a (batch, M, K) @ b (batch, K, N) -> new (batch, M, N) tensor,
        accumulated in int32 (``int_acc``) or f32.  ``kscale`` scales A
        along k, ``mul`` multiplies the accumulator (both in the
        accumulator's type; on the tensor cores ``kscale`` is an int8
        vector of K elements, batch 1, which becomes A's two byte planes,
        ``int8_planes``); the ``epilogue`` runs on it in f32.  With ``t``
        (M, N) (batch 1) the result is the (N,) vector ``sum_m (a @
        b)[m, n] * t[m, n]``.  ``body`` forces the tensor-core mode's body
        (``"ring"`` or ``"mma"``; ``q8_body`` by default); the kernel
        refuses a forced ring it cannot take, and this raises.  On the
        tensor cores only the ring takes ``kscale``, ``mul`` or ``t``: a
        call with one that ``q8_body`` sends to the mma.sync body raises.
        ``plan`` (a searched ``Q8Plan``) takes the place of the ring's
        ``Q8_HEURISTIC`` where the launch runs the ring (``obs`` counts
        ``ops.card_plan.applied``); on the mma.sync and upcast bodies it is
        counted ``.skipped``.  A plan the ring refuses raises."""
        tc = self.entry == "q8_launch"
        if a.device.type != "cuda" or b.device != a.device:
            raise ValueError(f"the 8-bit kernels take CUDA tensors on one "
                             f"device, got {a.device} and {b.device}")
        codes = [DTYPE_CODES.get(x.dtype) for x in (a, b)]
        if None in codes or out_dtype not in OUT_CODES:
            raise TypeError(f"the 8-bit kernels take {list(DTYPE_CODES)} "
                            f"and write {list(OUT_CODES)}; got {a.dtype}, "
                            f"{b.dtype} -> {out_dtype}")
        if tc and (a.dtype != self.dtype or b.dtype != self.dtype):
            raise TypeError(f"{self.entry} ({self.dtype}) takes two "
                            f"{self.dtype} operands, got {a.dtype} and "
                            f"{b.dtype}")
        if tc and int_acc != (self.dtype == torch.int8):
            acc = "int32" if self.dtype == torch.int8 else "f32"
            raise TypeError(f"{self.dtype} accumulates in {acc}")
        if int_acc and any(x.dtype not in (torch.int8, torch.int32)
                           for x in (a, b)):
            raise TypeError("int32 accumulation takes int8 or int32 "
                            "operands")
        if body is not None and (not tc or body not in ("ring", "mma")):
            raise ValueError(f"body {body!r}: the tensor-core mode's 'ring' "
                             f"or 'mma'")
        if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or (
            a.shape[2] != b.shape[1]
        ):
            raise ValueError(f"the 8-bit kernels take (batch, M, K) and "
                             f"(batch, K, N), got {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
        _check_strides(a, b)
        batch, m, k = a.shape
        n = b.shape[2]
        fused = kscale is not None or mul is not None or t is not None
        if tc and fused:
            why = ("the mma body is forced" if body == "mma"
                   else q8_ring_refusal(a, b, kscale))
            if why is not None:
                raise ValueError(f"the tensor-core mode takes a k-scale, "
                                 f"multiplier or row reduce on the ring "
                                 f"only: {why}")
            if kscale is not None and kscale.tensor.device != a.device:
                raise ValueError(f"k-scale on {kscale.tensor.device}, "
                                 f"operands on {a.device}")
            body = "ring"
        lib = self._fn()
        tile_m = lib.q8_tile_m() if tc else lib.upcast_tile_m()
        tile_n = lib.q8_tile_n() if tc else lib.upcast_tile_n()
        if batch > _MAX_GRID_YZ or -(-m // tile_m) > _MAX_GRID_YZ:
            raise ValueError(f"grid too large for batch {batch}, M {m}")
        acc_dtype = torch.int32 if int_acc else torch.float32
        if tc and body is None:
            body = q8_body(a, b)
        if fused and tc:
            tile_m = tile_n = Q8_RING_TILE
        ring = tc and body == "ring"
        if plan is not None:
            _count_plan(ring)
        ran = (plan or Q8_HEURISTIC) if ring else None
        p = _Q8Params(A=a.data_ptr(), B=b.data_ptr(), batch=batch, M=m, N=n,
                      K=k, a_dtype=codes[0], b_dtype=codes[1],
                      out_dtype=OUT_CODES[out_dtype], acc_int=int(int_acc),
                      body=int(ring), planes=1)
        p.sAb, p.sAm, p.sAk = a.stride()
        p.sBb, p.sBk, p.sBn = b.stride()
        planes = None  # int8's k-scale on the ring: A's byte planes
        if tc and kscale is not None:
            planes = int8_planes(a[0], kscale.tensor)
            p.A, p.planes = planes.data_ptr(), 2
            p.sAb, p.sAm, p.sAk = planes.stride()
        extents = (batch, m, n, k)
        if kscale is not None and planes is None:
            set_vec(p, "kscale", kscale, a.device, acc_dtype, (3,), extents)
        if mul is not None:
            set_vec(p, "mul", mul, a.device, acc_dtype, (0, 1, 2), extents)
        set_epilogue(p, epilogue, vectors, a.device, (0, 1, 2), extents)
        if t is not None:
            if batch != 1 or tuple(t.shape) != (m, n) or (
                t.device != a.device or t.dtype not in DTYPE_CODES
            ):
                raise ValueError(f"row reduce takes batch 1 and t ({m}, {n}) "
                                 f"on {a.device}, got batch {batch}, t "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
            if epilogue is not None or mul is not None or kscale is not None:
                raise ValueError("row reduce takes no epilogue and no vector")
            _check_strides(t)
            c = torch.empty((n,), dtype=out_dtype, device=a.device)
            if n == 0:
                return c
            if m == 0:  # no row blocks: an empty sum
                return c.zero_()
            partial = torch.empty((-(-m // tile_m), n), dtype=acc_dtype,
                                  device=a.device)
            counter = torch.zeros(-(-n // tile_n), dtype=torch.int32,
                                  device=a.device)
            p.T, p.partial, p.counter = (t.data_ptr(), partial.data_ptr(),
                                         counter.data_ptr())
            p.sTm, p.sTn = t.stride()
            p.t_dtype = DTYPE_CODES[t.dtype]
            p.sCn = c.stride(0)
        else:
            c = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
            if c.numel() == 0:
                return c
            p.sCb, p.sCm, p.sCn = c.stride()
        p.C = c.data_ptr()
        if ring and ran.ctas:  # the persistent grid
            _launch(lib, "q8_plan_launch", p, a.device, ran.ctas)
        else:
            _launch(lib, self.entry, p, a.device)
        self.launches += 1
        self.last_body = body if tc else "upcast"
        self.last_card = ran
        return c


class ChainLauncher:
    """``contract_chain.cu``: C = (X @ Y) @ Z in one launch.  ``last_plan``
    is the ``ChainPlan`` of the latest launch."""

    def __init__(self):
        self.launches = 0
        self.last_plan = None
        self._lib = None

    def _fn(self):
        if self._lib is None:
            lib = _load("contract_chain", _ChainParams, ("chain_launch",))
            for name in ("chain_tile_m", "chain_tile_n"):
                getattr(lib, name).argtypes = [ctypes.c_int]
                getattr(lib, name).restype = ctypes.c_int
            lib.chain_cluster.argtypes = [ctypes.c_int, ctypes.c_longlong]
            lib.chain_cluster.restype = ctypes.c_int
            for dt, code in DTYPE_CODES.items():
                if lib.chain_tile_n(code) != chain_tile_n(dt):
                    raise RuntimeError(f"contract_chain.cu's tile for {dt} "
                                       f"is {lib.chain_tile_n(code)}, "
                                       f"chain_tile_n says "
                                       f"{chain_tile_n(dt)}")
                for p in (1, 100, 128, 255, 256, 300, 1000, 4096, 10**6):
                    if lib.chain_cluster(code, p) != chain_cluster(dt, p):
                        raise RuntimeError(
                            f"contract_chain.cu's cluster for {dt} at P "
                            f"{p} is {lib.chain_cluster(code, p)}, "
                            f"chain_cluster says {chain_cluster(dt, p)}")
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                 out_dtype: torch.dtype, *,
                 epilogue: Optional[Epilogue] = None,
                 vectors: Optional[Dict[str, VecArg]] = None,
                 out: Optional[torch.Tensor] = None,
                 plan: Optional[ChainPlan] = None) -> torch.Tensor:
        """x (R, P) @ y (P, Q) @ z (Q, N) -> (R, N), into ``out`` when
        given (any strides, e.g. the transposed view of a (N, R) tensor).
        Epilogue vectors run along axis 1 (rows) or 2 (columns).  ``plan``
        is the ``ChainPlan`` the caller runs (its association is how the
        caller oriented x, y and z): its cluster size takes the place of
        ``chain_cluster``'s, and the kernel refuses one that is not a power
        of two up to ``CHAIN_MAX_CLUSTER``.  Without one the launch is
        (X.Y).Z on ``chain_cluster``'s cluster."""
        ts = (x, y, z)
        if any(t.device.type != "cuda" or t.device != x.device for t in ts):
            raise ValueError("the chain kernel takes CUDA tensors on one "
                             "device")
        if len({t.dtype for t in ts}) != 1 or x.dtype not in DTYPE_CODES:
            raise TypeError(f"the chain kernel takes three operands of one "
                            f"of {list(DTYPE_CODES)}, got "
                            f"{[t.dtype for t in ts]}")
        if out_dtype not in OUT_CODES:
            raise TypeError(f"the chain kernel writes {list(OUT_CODES)}, "
                            f"not {out_dtype}")
        if any(t.dim() != 2 for t in ts) or x.shape[1] != y.shape[0] or (
            y.shape[1] != z.shape[0]
        ):
            raise ValueError(f"the chain kernel takes (R, P), (P, Q), (Q, N), "
                             f"got {[tuple(t.shape) for t in ts]}")
        r, pdim = x.shape
        q, n = z.shape
        if out is None:
            out = torch.empty((r, n), dtype=out_dtype, device=x.device)
        elif tuple(out.shape) != (r, n) or out.dtype != out_dtype or (
            out.device != x.device
        ):
            raise ValueError(f"out must be ({r}, {n}) {out_dtype} on "
                             f"{x.device}")
        _check_strides(*ts, out)
        code = DTYPE_CODES[x.dtype]
        lib = self._fn()
        if -(-r // lib.chain_tile_m(code)) > _MAX_GRID_YZ:
            raise ValueError(f"chain kernel grid too large for R {r}")
        if out.numel() == 0:
            return out
        if plan is None:
            plan = ChainPlan("xy", chain_cluster(x.dtype, pdim))
        p = _ChainParams(X=x.data_ptr(), Y=y.data_ptr(), Z=z.data_ptr(),
                         C=out.data_ptr(), R=r, P=pdim, Q=q, N=n,
                         in_dtype=code, out_dtype=OUT_CODES[out_dtype],
                         cluster=plan.cluster)
        p.sXr, p.sXp = x.stride()
        p.sYp, p.sYq = y.stride()
        p.sZq, p.sZn = z.stride()
        p.sCr, p.sCn = out.stride()
        set_epilogue(p, epilogue, vectors, x.device, (1, 2), (0, r, n, 0))
        _launch(lib, "chain_launch", p, x.device)
        self.launches += 1
        self.last_plan = plan
        return out


def chain_tile_n(dtype: torch.dtype) -> int:
    """CTA columns of the chain body that takes ``dtype`` operands (the
    association choice reads it; checked against ``chain_tile_n`` of
    contract_chain.cu at load)."""
    return 128 if dtype == torch.bfloat16 else 64


#: the chain's largest thread-block cluster
CHAIN_MAX_CLUSTER = 8


def chain_cluster(dtype: torch.dtype, p: int) -> int:
    """CTAs of one cluster of the chain body for ``dtype`` at a p reduction
    of extent ``p``: they split p and share T, so T is formed once per
    cluster of column blocks.  The largest power of two up to
    ``CHAIN_MAX_CLUSTER`` that leaves each CTA two p steps (64 for bf16,
    32 otherwise) or more.  contract_chain.cu's ``cluster_for`` owns the
    rule; this copy exists because the association choice
    (``cuda_gen._chain_cost``) runs on the CPU too, where there is no
    library to ask, and the launcher checks the two agree at load."""
    steps = -(-p // (64 if dtype == torch.bfloat16 else 32))
    cs = 1
    while cs < CHAIN_MAX_CLUSTER and steps >= 4 * cs:
        cs *= 2
    return cs


CONTRACT_INT8 = Contract8Launcher("q8_launch", torch.int8)
CONTRACT_FP8 = Contract8Launcher("q8_launch", torch.float8_e4m3fn)
CONTRACT_UPCAST = Contract8Launcher("upcast_launch")
CONTRACT_CHAIN = ChainLauncher()
