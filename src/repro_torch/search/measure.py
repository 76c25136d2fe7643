"""Measure surviving candidates through the kernel generator.

The paper measures *every* variant; after the analytic cut only the beam's
top-K reach this stage.  Each survivor is compiled with
``codegen.cached_compile`` (the path ``ops.dense`` takes) and timed with
the same operand data, after a check against the f64 einsum oracle: a
candidate that computes a wrong answer raises and is never ranked.

The operands' device decides what is timed, as everywhere in the port:

* CPU tensors (numpy arrays by default) run the kernel's plain version
  (``contract_ref``) on the host clock, min over ``repeats`` after a
  warm-up -- the reference's interpret-mode role: it closes the loop on a
  machine without a card and says nothing about speed;
* CUDA tensors launch the kernel.  Each candidate is timed between CUDA
  events: a warm-up launch (which is also the checked one), then the
  median of at least ``CARD_REPEATS`` launches, taken in rounds that time
  every candidate once in turn (``Measurement.spread_s`` their
  interquartile range), the 50 MB L2 flushed before each (a
  serving step meets its weights cold; the flush also keeps the device
  busy while the host enqueues the launch).  Candidates
  carry their card plan (``cards``: B1's ``codegen.cuda_gen.CardPlan``,
  a fused spec's ``codegen.fused_gen.FusedPlan``), since on the card the
  kernels ignore a schedule's blocks; every timed call of a plain
  product must be one B1 launch, run on the requested plan
  (``CONTRACT.last_card``), and every timed call of a fused spec one
  launch of its kernel (B2, B3 or B4), on the requested plan where one
  is given (the launcher's ``last_plan``).  The operands go as the views
  the caller passes (``ops.dense``'s folded x, the backward's cotangent
  and saved operands for ``.dA`` / ``.dB``), so the measured body is the
  served one.  The f64 oracle of a fused spec runs on the operands'
  device there (``fused_oracle``): numpy's loops would take minutes at a
  full-width attention.

Schedules with ``mesh:*`` levels are compiled through
``codegen.bind_mesh`` over a mesh of the world's ranks
(``launch.mesh``): on the card, ranks of one process each; on the CPU,
gloo ranks (``tests/test_torch_mesh_gen.py``).  ``mesh_for_schedules``
builds the mesh the candidate set needs when the world holds its ranks,
and returns None otherwise -- in which case sharded candidates keep their
analytic score and only the single-rank ones are timed.  Measuring on a
mesh times every candidate on every rank on the host clock (each call
synchronized on the card, since the collectives run between launches),
min over ``repeats`` after a warm-up, and the ranks agree on each time by
taking its maximum over the world (``collectives.world_max``): every rank
then ranks the ladder alike, as it must, or a later collective would pair
different kernels.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.enumerate import ContractionSpec
from ..core.schedule import MESH_TIERS, Schedule

#: the fewest rounds of event-timed launches a candidate's median is
#: taken over (each round times every candidate once, in turns)
CARD_REPEATS = 31
#: bytes zeroed before each timed launch: twenty times the card's 50 MB
#: L2, and long enough (about 0.3 ms at the HBM rate) that the host has
#: enqueued the launch before the device reaches it, so the events time
#: the kernel and not the host's path to it (which is the same for every
#: plan of a ladder)
FLUSH_BYTES = 2**30
#: storage dtypes numpy has no plain type for: drawn in f64 and rounded
#: to storage through torch (the reference draws them with ml_dtypes)
_TORCH_ONLY = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


@dataclasses.dataclass
class Measurement:
    schedule: Schedule
    seconds: float
    max_err: Optional[float]  # vs einsum reference; None when skipped
    #: the B1 tile plan the timed launches ran (card path), or None
    card: Optional[object] = None
    #: the interquartile range of the event-timed launches (card path),
    #: or None
    spread_s: Optional[float] = None


def schedule_mesh_axes(schedule: Schedule) -> Dict[str, int]:
    """{mesh axis -> size} a schedule's mesh levels require (may be {})."""
    out: Dict[str, int] = {}
    for l in schedule.levels:
        if l.tier in MESH_TIERS:
            axis = l.tier.split(":", 1)[1]
            out[axis] = out.get(axis, 1) * l.extent
    return out


def mesh_for_schedules(schedules: Sequence[Schedule], *, transport=None,
                       device=None):
    """The mesh hosting every sharded schedule, or None.

    Every schedule that uses a mesh axis must use the whole axis (that is
    what ``space.mesh_variants`` emits), so conflicting sizes for one axis
    are a caller bug and raise.  The mesh takes the needed axes in the
    canonical order (pod, data, model) over the ranks of the world
    (``launch.mesh.make_debug_mesh``); where they number fewer than the
    world, the rest of the world becomes a leading replica axis named
    after the first canonical axis no schedule uses (the schedules leave
    it replicated).  The active mesh (``launch.mesh.set_mesh``) serves
    as it is where it spans the world and has every needed axis at its
    size.  Returns None when no schedule has mesh levels or the world
    cannot host them (fewer ranks, or a count they do not divide).
    ``transport`` and ``device`` are the mesh's (default: the active
    mesh's, else "device" and the CPU).
    """
    need: Dict[str, int] = {}
    for s in schedules:
        for axis, size in schedule_mesh_axes(s).items():
            if need.setdefault(axis, size) != size:
                raise ValueError(
                    f"schedules disagree on mesh axis {axis!r} size: "
                    f"{need[axis]} vs {size}"
                )
    if not need:
        return None
    import math

    from ..codegen.collectives import current_mesh
    from ..launch.mesh import make_debug_mesh, world_size

    order = [t.split(":", 1)[1] for t in MESH_TIERS]
    axes = [a for a in order if a in need]
    shape = [need[a] for a in axes]
    world = world_size()
    active = current_mesh()
    if active is not None and active.size == world and all(
            active.shape.get(a) == n for a, n in need.items()):
        return active
    if world % math.prod(shape):
        return None
    if world > math.prod(shape):
        spare = next((a for a in order if a not in need), None)
        if spare is None:
            return None
        axes.insert(0, spare)
        shape.insert(0, world // math.prod(shape))
    if transport is None:
        transport = getattr(active, "transport", "device")
    if device is None:
        device = getattr(active, "device", None)
    return make_debug_mesh(tuple(shape), tuple(axes), transport=transport,
                           device=device)


def reference_arrays(
    spec: ContractionSpec, dtype=np.float32, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Standard-normal operand arrays in ``spec.operands`` order.

    Integer dtypes (the int8 quant tier) draw small ints instead — every
    product and partial sum is then exactly representable, so the f64
    einsum oracle doubles as the *dequantized* oracle.  bf16 and fp8 draw
    the same f64 normals and round them to storage precision, which
    charges input quantization to the data, not to the kernel under test;
    numpy has no plain type for them, so their arrays are float32 holding
    the storage values exactly (``measure_schedules`` casts them back).
    ``dtype`` is a numpy or torch dtype or its name.
    """
    from ..codegen.cache import dtype_name

    rng = np.random.default_rng(seed)
    spec = spec.root()
    name = dtype_name(dtype)

    def draw(shape):
        if name in _TORCH_ONLY:
            import torch

            x = torch.from_numpy(rng.standard_normal(shape))
            return x.to(getattr(torch, name)).float().numpy()
        dt = np.dtype(name)
        if dt.kind in ("i", "u"):
            return rng.integers(-4, 5, size=shape).astype(dt)
        return rng.standard_normal(shape).astype(dt)

    return {
        name_: draw(tuple(spec.extents[i] for i in axes))
        for name_, axes in spec.operands.items()
    }


def einsum_reference(
    spec: ContractionSpec, arrays: Dict[str, np.ndarray]
) -> np.ndarray:
    """np.einsum oracle for a root spec (f64 accumulation).

    Fused families are not single einsums — attention gets a stable f64
    softmax oracle, grouped_matmul a per-group f64 loop.
    """
    from ..core.enumerate import einsum_formula

    spec = spec.root()
    kind = getattr(spec, "fused_kind", "")
    if kind == "attention":
        q, k, v = (
            np.asarray(arrays[n], np.float64) for n in ("Q", "K", "V")
        )
        s = np.einsum("hsd,htd->hst", q, k) * spec.extents["d"] ** -0.5
        if spec.causal:
            t_ids = np.arange(spec.extents["t"])[None, None, :]
            s_ids = np.arange(spec.extents["s"])[None, :, None]
            s = np.where(t_ids <= s_ids, s, -np.inf)
        p = np.exp(s - s.max(axis=-1, keepdims=True))
        p = p / p.sum(axis=-1, keepdims=True)
        return np.einsum("hst,hte->hse", p, v)
    if kind == "grouped_matmul":
        names = tuple(spec.operands)
        vals = {n: np.asarray(arrays[n], np.float64) for n in names}
        sizes = spec.group_sizes
        if "g" in spec.output:  # dW orientation: out[g,o1,o2]
            _, o1, o2 = spec.output
            lhs = next(n for n in names if o1 in spec.operands[n])
            rhs = next(n for n in names if o2 in spec.operands[n])
            out = np.zeros(
                tuple(spec.extents[i] for i in spec.output), np.float64
            )
            o = 0
            for g, s_g in enumerate(sizes):
                out[g] = vals[lhs][o : o + s_g].T @ vals[rhs][o : o + s_g]
                o += s_g
            return out
        # row orientation (fwd / dX): out[n, oc]
        xname, wname = names
        oc = spec.output[1]
        c = spec.operands[xname][1]
        w_axes = spec.operands[wname]
        out = np.zeros(
            tuple(spec.extents[i] for i in spec.output), np.float64
        )
        o = 0
        for g, s_g in enumerate(sizes):
            wg = vals[wname][g]
            if w_axes.index(c) == 2:  # shared axis last -> transpose
                wg = wg.T
            out[o : o + s_g] = vals[xname][o : o + s_g] @ wg
            o += s_g
        return out
    return np.einsum(
        einsum_formula(spec),
        *(np.asarray(arrays[n], np.float64) for n in spec.operands),
    )


def fused_oracle(spec: ContractionSpec, tensors):
    """``einsum_reference`` of a fused spec in torch, in f64 on the
    tensors' device: attention's stable softmax (masked columns -inf, as
    the reference's oracle), a head at a time; the grouped row and dW
    modes a group at a time."""
    import torch

    from ..codegen import fused_gen

    spec = spec.root()
    vals = [t.double() for t in tensors]
    if spec.fused_kind == "attention":
        q, k, v = vals
        s_len, t_len = q.shape[1], k.shape[1]
        scale = spec.extents["d"] ** -0.5
        keep = (torch.arange(t_len, device=q.device)[None, :]
                <= torch.arange(s_len, device=q.device)[:, None])
        out = torch.empty(q.shape[0], s_len, v.shape[2],
                          dtype=torch.float64, device=q.device)
        for h in range(q.shape[0]):
            sc = (q[h] @ k[h].T) * scale
            if spec.causal:
                sc = sc.masked_fill(~keep, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            out[h] = p @ v[h]
        return out
    out = torch.zeros(tuple(spec.extents[i] for i in spec.output),
                      dtype=torch.float64, device=vals[0].device)
    o = 0
    if "g" in spec.output:
        lhs, rhs = fused_gen.dw_operands(spec, vals)
        for g, s_g in enumerate(spec.group_sizes):
            out[g] = lhs[o:o + s_g].T @ rhs[o:o + s_g]
            o += s_g
        return out
    x, w = vals
    last = fused_gen.contracts_last(spec)
    for g, s_g in enumerate(spec.group_sizes):
        out[o:o + s_g] = x[o:o + s_g] @ (w[g].T if last else w[g])
        o += s_g
    return out


def pairwise_f64(spec: ContractionSpec, tensors):
    """``spec`` (a root of three operands) of ``tensors`` in f64, read
    from the spec's own indices alone and folded pairwise: first the pair
    whose intermediate (the indices the third operand or the output still
    needs) is smallest, then that with the third operand, each fold one
    two-operand ``torch.einsum`` -- never the (i, j, k) intermediate an
    einsum of three may form.  It shares nothing with the kernels' fold
    (``cuda_gen._classify``), so a misread fold cannot agree with it."""
    import math

    import torch

    letters = {i: chr(ord("a") + n) for n, i in enumerate(spec.indices)}
    sub = lambda axes: "".join(letters[i] for i in axes)  # noqa: E731
    axes = [tuple(a) for a in spec.operands.values()]
    vals = [t.double() for t in tensors]

    def keep(x, y):
        z = 3 - x - y
        return [i for i in dict.fromkeys(axes[x] + axes[y])
                if i in axes[z] or i in spec.output]

    x, y = min(((0, 1), (0, 2), (1, 2)), key=lambda xy: math.prod(
        spec.extents[i] for i in keep(*xy)))
    z, mid = 3 - x - y, keep(x, y)
    inner = torch.einsum(f"{sub(axes[x])},{sub(axes[y])}->{sub(mid)}",
                         vals[x], vals[y])
    return torch.einsum(f"{sub(mid)},{sub(axes[z])}->{sub(spec.output)}",
                        inner, vals[z])


def _oracle(spec: ContractionSpec, tensors):
    """The f64 oracle of ``tensors`` on their device: ``torch.einsum`` in
    f64 for a plain contraction (on the card a full-width product takes
    milliseconds there, minutes in numpy's loops), ``pairwise_f64`` for
    one of three operands; for a fused family ``einsum_reference`` on CPU
    tensors, ``fused_oracle`` on the card."""
    import torch

    from ..core.enumerate import einsum_formula

    spec = spec.root()
    if getattr(spec, "fused_kind", ""):
        if tensors[0].is_cuda:
            return fused_oracle(spec, tensors)
        host = {n: t.double().cpu().numpy()
                for n, t in zip(spec.operands, tensors)}
        return torch.from_numpy(einsum_reference(spec, host)).to(
            tensors[0].device)
    if len(spec.operands) == 3:
        return pairwise_f64(spec, tensors)
    return torch.einsum(einsum_formula(spec), *(t.double() for t in tensors))


def measure_schedules(
    spec: ContractionSpec,
    schedules: Sequence[Schedule],
    *,
    arrays: Optional[Dict[str, object]] = None,
    dtype=np.float32,
    interpret: bool = True,
    repeats: int = 2,
    check: bool = True,
    tol: Optional[float] = None,
    mesh=None,
    collectives: Optional[Sequence[str]] = None,
    device: Optional[str] = None,
    cards: Optional[Sequence[object]] = None,
    epilogue=None,
) -> List[Measurement]:
    """Compile + time each schedule; same operand data for every candidate.

    With ``check=True`` every measured kernel is verified against the
    einsum oracle and a mismatch raises — a schedule that computes the
    wrong answer must never win the search.  The default tolerance is
    dtype-appropriate: 1e-3 relative for >= 32-bit floats and 8-bit
    operands, 5e-2 for half-precision (bf16 rounds the *stored* output
    even though the kernels accumulate in f32), of the oracle's largest
    magnitude, or of each row's for attention (``_scale``).

    ``arrays`` maps operand names to numpy arrays (default:
    ``reference_arrays``), placed on ``device`` ("cpu" unless given), or
    to tensors, whose device and layout are kept.  On CUDA tensors each
    schedule's ``cards`` entry (a ``CardPlan``, ``FusedPlan``, ``Q8Plan``
    or ``ChainPlan``, or None) is the plan its launches must run; see the
    module docstring for the timing.  ``epilogue`` (a ``codegen.Epilogue``)
    compiles every candidate under it, with its vectors drawn from a seed
    (``epilogue_vectors``), and the oracle applies it in f64.
    ``interpret`` is the reference's flag and changes nothing here: the
    device decides.

    Schedules with ``mesh:*`` levels compile through ``codegen.bind_mesh``
    over ``mesh`` (default: ``mesh_for_schedules`` over the world's ranks,
    on the operands' device; a sharded schedule with no hostable mesh
    raises).  ``collectives`` optionally names the finishing-collective
    lowering per schedule ("psum" / "ring", ignored for unsharded
    entries); the operands stay global tensors either way, so the oracle
    check is identical for sharded and single-rank candidates.  With a
    mesh every candidate is timed on the host clock on every rank and the
    times are the world's maxima (module docstring).
    """
    import torch

    from ..codegen import cached_compile
    from ..codegen.cache import dtype_name

    spec = spec.root()
    tdt = getattr(torch, dtype_name(dtype))
    quantized = tdt.itemsize == 1
    if tol is None:
        # quantized operands (itemsize 1) are exactly representable by
        # construction (reference_arrays), so the kernel only differs from
        # the f64 oracle by f32 accumulation order — full-precision tol
        tol = 1e-3 if tdt.itemsize >= 4 or quantized else 5e-2
    if arrays is None:
        arrays = reference_arrays(spec, dtype=tdt)
    tensors = []
    for n in spec.operands:
        a = arrays[n]
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a)).to(
                device or "cpu").to(tdt)
        tensors.append(a)
    card = tensors[0].is_cuda
    if card and not torch.cuda.is_available():
        raise RuntimeError("measuring on CUDA tensors needs a card")
    cards = list(cards) if cards is not None else [None] * len(schedules)
    launcher = (_launcher_of(spec, tensors[0].dtype, tensors, epilogue)
                if card else None)
    vecs = ({} if epilogue is None else
            epilogue_vectors(spec, epilogue, tensors[0].device))
    ref = None
    if check:
        ref = _oracle(spec, tensors)
        if epilogue is not None:
            lead = (1,) * (len(spec.output) - 1)
            ref = epilogue.apply(ref, {n: v.double().reshape(lead + (-1,))
                                       for n, v in vecs.items()})
    scale = _scale(spec, ref) if check else None
    sharded = [bool(schedule_mesh_axes(s)) for s in schedules]
    if mesh is None and any(sharded):
        mesh = mesh_for_schedules(
            [s for s, sh in zip(schedules, sharded) if sh],
            device=tensors[0].device.type)
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                         device=tensors[0].device)
             if card and mesh is None else None)

    checked = []
    for pos, (sched, plan) in enumerate(zip(schedules, cards)):
        if sharded[pos] and mesh is None:
            raise ValueError(
                f"schedule {sched.levels} needs a mesh of ranks but the "
                f"world cannot host one")
        coll = (collectives[pos] if collectives else "") or "psum"
        kern = cached_compile(
            spec, sched, interpret=interpret, epilogue=epilogue,
            # 1-byte operands must not round-trip the accumulator through
            # int8/fp8 storage on the way out — measure the f32 result
            out_dtype=torch.float32 if quantized else None,
            mesh=mesh if sharded[pos] else None, collective=coll,
            card=plan,
        )
        what = f"schedule {sched.levels}" + (f", plan {tuple(plan)}"
                                             if plan is not None else "")
        result = _call(kern, tensors, launcher, plan, what, vecs)  # warm-up
        err = None
        if check:
            err = float(((result.double() - ref).abs() / scale).max())
            if not err <= tol:
                raise AssertionError(
                    f"{what} produced wrong output (rel err {err:.3g} > "
                    f"{tol}) — refusing to rank it")
        checked.append((sched, plan, kern, what, err))
    if not card or mesh is not None:
        times = []
        for _, plan, kern, what, _ in checked:
            seconds = float("inf")
            for _ in range(max(repeats, 1)):
                t0 = time.perf_counter()
                _call(kern, tensors, launcher, plan, what, vecs)
                if card:
                    torch.cuda.synchronize(tensors[0].device)
                seconds = min(seconds, time.perf_counter() - t0)
            times.append(seconds)
        if mesh is not None:
            from ..codegen.collectives import world_max

            times = world_max(times)
        return [Measurement(schedule=sched, seconds=t, max_err=err,
                            card=plan)
                for t, (sched, plan, _, _, err) in zip(times, checked)]
    # the candidates in turns, a round at a time, so that a slow spell of
    # the card falls on every candidate alike
    times = [[] for _ in checked]
    for _ in range(max(repeats, CARD_REPEATS)):
        for row, (_, plan, kern, what, _) in zip(times, checked):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _call(kern, tensors, launcher, plan, what, vecs)
            end.record()
            end.synchronize()
            row.append(start.elapsed_time(end) * 1e-3)
    out = []
    for row, (sched, plan, _, _, err) in zip(times, checked):
        q1, _, q3 = statistics.quantiles(row, n=4)
        out.append(Measurement(schedule=sched, seconds=statistics.median(row),
                               max_err=err, card=plan, spread_s=q3 - q1))
    return out


def epilogue_vectors(spec: ContractionSpec, epilogue, device, seed: int = 1):
    """The f32 vectors of ``epilogue`` a measurement calls ``spec`` with,
    one element a coordinate of the last output axis, from ``seed``:
    standard normals, ``var`` drawn from [0.5, 1.5) and ``qscale`` from
    [0.01, 0.02) (positive, as the quantizers' scales are)."""
    import torch

    spec = spec.root()
    rng = np.random.default_rng(seed)
    n = spec.extents[spec.output[-1]]
    lows = {"var": (0.5, 1.5), "qscale": (0.01, 0.02)}
    out = {}
    for name in epilogue.vector_names:
        v = (rng.uniform(*lows[name], n) if name in lows
             else rng.standard_normal(n))
        out[name] = torch.from_numpy(v.astype(np.float32)).to(device)
    return out


def _scale(spec: ContractionSpec, ref):
    """What a candidate's error is divided by: the oracle's largest
    magnitude; for attention each row's own (1 for an all-zero row), so
    that late causal rows, whose values are small, are held as tightly as
    row 0."""
    if getattr(spec, "fused_kind", "") == "attention":
        rows = ref.abs().amax(dim=-1, keepdim=True)
        return rows.masked_fill(rows == 0, 1.0)
    return max(float(ref.abs().max()), 1e-30)


def _launcher_of(spec: ContractionSpec, dtype, tensors=None,
                 epilogue=None):
    """The launcher whose one launch a timed call on the card must be: B2's,
    B3's or B4's for a fused spec; B1's ``CONTRACT`` for a product of f32 /
    bf16 operands, the weighted family's modes and a product under an
    ``epilogue`` included; the chain's for a chain; for 8-bit operands the
    one their route takes (``cuda_gen.launcher_of`` on ``tensors``: the
    8-bit ring's, the upcast body's, or ``CONTRACT`` for fp8's k-scale),
    None without ``tensors``."""
    import torch

    from ..codegen import CONTRACT, cuda_gen
    from ..codegen import fused_gen

    root = spec.root()
    kind = getattr(root, "fused_kind", "")
    if kind == "attention":
        return fused_gen.ATTENTION
    if kind:
        return (fused_gen.GROUPED_DW if "g" in root.output
                else fused_gen.GROUPED)
    if cuda_gen._classify(root).kind == "chain":
        return cuda_gen.CONTRACT_CHAIN
    if getattr(root, "quant", None) is None and dtype in (torch.float32,
                                                          torch.bfloat16):
        return CONTRACT
    if tensors is None:
        return None
    return cuda_gen.launcher_of(root, *tensors, epilogue=epilogue)


def _ran(launcher):
    """The plan a launcher's latest launch ran: B1's ``last_card``, a
    fused launcher's ``last_plan``."""
    return (launcher.last_card if hasattr(launcher, "last_card")
            else launcher.last_plan)


def _call(kern, tensors, launcher, plan, what: str, vectors=None):
    """One call of ``kern`` (its epilogue's ``vectors`` by keyword); where
    ``launcher`` is given, exactly one of its launches, on ``plan`` where
    one is given (else raises)."""
    vectors = vectors or {}
    if launcher is None:
        return kern(*tensors, **vectors)
    n0 = launcher.launches
    out = kern(*tensors, **vectors)
    if launcher.launches - n0 != 1 or (plan is not None
                                       and _ran(launcher) != plan):
        raise AssertionError(f"{what}: {launcher.launches - n0} launches "
                             f"in a call, the last on {_ran(launcher)}")
    return out
