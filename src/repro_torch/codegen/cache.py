"""Disk-backed autotune cache: pay tuning cost once per fleet, not per run.

The ROADMAP "serve heavy traffic" requirement implies tuning cannot happen
per-process: a serving replica must pick up the fleet's tuned schedules at
startup.  This cache is a JSON file (human-inspectable, mergeable) mapping

    key = sha256(spec signature, shapes, dtype, hardware, tuner version)

to a serialized winner — either a full ``Schedule`` (split chain + tier
levels, see ``schedule_to_dict``) or an arbitrary small JSON value such as
``choose_matmul_blocks`` output or measured variant rankings.

Concurrency: reads are lazy; writes are atomic (tmp file + ``os.replace``)
and hold an exclusive inter-process file lock (``<path>.lock``, flock)
around the read-merge-write, so concurrent writers — e.g. two sweep
processes persisting fwd+bwd plans for the same shape — never corrupt the
file *and* never lose each other's entries.  The lock is POSIX-only
(flock); where ``fcntl`` is unavailable writes stay atomic and
thread-safe but a concurrent *process* can still drop another's entry.
A corrupt/alien file degrades to an empty cache rather than an error.

Location: ``$REPRO_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json``.

The key format is the reference's, byte for byte: the same JSON payload
hashed the same way, with dtypes named as numpy names them ("float32",
"bfloat16") whether the caller passes a ``torch.dtype`` or a numpy one,
so ``tests/data/autotune_cache_golden.json`` reads back through the port.
Only the hardware fingerprint differs: ``cuda/<device name>`` on a card,
``cpu`` without one.

Observability: lookups feed ``repro_torch.obs`` counters (``autotune.hit`` /
``autotune.miss`` for the default cache, ``plandb.*`` for the plan DB —
see ``metrics_prefix``) in addition to the in-process ``hits``/``misses``
attributes, so a fleet dashboard or ``serve --metrics-out`` dump shows
cache effectiveness without poking cache objects.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional

try:
    import fcntl
except ImportError:  # non-posix: fall back to thread-lock-only writes
    fcntl = None  # type: ignore[assignment]

from ..core.enumerate import ContractionSpec
from ..core.schedule import Level, Schedule

#: bump when the serialized schedule format or tuner logic changes
CACHE_VERSION = 1


def spec_signature(spec: ContractionSpec) -> Dict[str, Any]:
    """Stable JSON identity of a ROOT contraction (shapes included)."""
    root = spec.root()
    sig = {
        "name": root.name,
        "operands": {k: list(v) for k, v in root.operands.items()},
        "output": list(root.output),
        "extents": {k: int(v) for k, v in root.extents.items()},
        "reducer": root.reducer,
    }
    # fused families (attention/grouped_matmul) carry semantics the plain
    # fields cannot express (causal flag, ragged group sizes) — fold them
    # in ONLY when present so every existing key stays byte-identical
    kind = getattr(root, "fused_kind", None)
    if kind:
        sig["fused"] = {"kind": kind, **root.fused_meta()}
    # low-precision storage (core.enumerate.QuantMeta) changes the lowered
    # kernel (operand dtype, accumulator, dequant epilogue) — same
    # only-when-present rule keeps every existing key byte-identical
    q = getattr(root, "quant", None)
    if q is not None:
        sig["quant"] = {"dtype": q.dtype, "accum": q.accum, "scale": q.scale}
    return sig


def hardware_fingerprint() -> str:
    """``cuda/<device name>`` when a card is visible, else ``cpu``."""
    import torch

    if torch.cuda.is_available():
        return f"cuda/{torch.cuda.get_device_name(0)}"
    return "cpu"


def measured_on(device: str) -> str:
    """The ``hardware`` key part of an entry measured on ``device``
    ("cpu", "cuda", "cuda:0"): the fingerprint, except that a measurement
    on the host of a machine with a card is keyed ``cpu``, so that a
    ladder timed on the host never stands in for one timed on the card
    (nor the other way round)."""
    fp = hardware_fingerprint()
    if str(device).startswith("cuda") or not fp.startswith("cuda/"):
        return fp
    return "cpu"


def dtype_name(dtype: Any) -> str:
    """numpy's name for a dtype given as ``torch.dtype``, numpy dtype or str.

    The reference hashes ``str(np.dtype(dtype))``; bfloat16 has no plain
    numpy dtype, so torch dtypes are named by their own spelling, which
    matches numpy's for every dtype this package uses.
    """
    import numpy as np
    import torch

    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str):
        return dtype
    return str(np.dtype(dtype))


def dtype_itemsize(dtype: Any) -> int:
    """Bytes per element of a dtype named as ``dtype_name`` accepts."""
    import torch

    return getattr(torch, dtype_name(dtype)).itemsize


def cache_key(
    spec: ContractionSpec,
    *,
    dtype: Any = None,
    hardware: Optional[str] = None,
    extra: Any = None,
) -> str:
    payload = {
        "v": CACHE_VERSION,
        "spec": spec_signature(spec),
        "dtype": dtype_name(dtype) if dtype is not None else None,
        "hw": hardware if hardware is not None else hardware_fingerprint(),
        "extra": extra,
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


@contextlib.contextmanager
def _file_lock(path: str):
    """Exclusive inter-process lock for read-merge-write on ``path``.

    Uses a sibling ``<path>.lock`` file so the lock survives the atomic
    ``os.replace`` of the data file itself (locking the data fd would be
    useless: replace swaps the inode out from under the lock).  The
    thread-level lock in ``AutotuneCache`` still guards in-process use;
    this one makes two *processes* — e.g. concurrent fwd+bwd plan sweeps —
    linearize their writes instead of losing them (tests/test_plandb_concurrency.py).
    """
    if fcntl is None:
        yield
        return
    with open(path + ".lock", "a") as lf:
        fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf.fileno(), fcntl.LOCK_UN)


def schedule_to_dict(schedule: Schedule) -> Dict[str, Any]:
    return {
        "splits": [[i, int(b)] for i, b in schedule.spec.split_chain()],
        "levels": [
            [l.index, l.tier, int(l.extent)] for l in schedule.levels
        ],
    }


def schedule_from_dict(d: Dict[str, Any], root: ContractionSpec) -> Schedule:
    spec = root.root()
    for index, b in d["splits"]:
        spec = spec.subdivide(index, b)
    levels = tuple(Level(i, t, e) for i, t, e in d["levels"])
    return Schedule(spec, levels).validate()


#: bumped whenever an ``AutotuneCache`` (the tuner's, or a ``PlanDB``'s)
#: is opened, written or cleared: ``ops._tuned_kernel``'s process memo
#: keeps an answer only while this is unchanged, so it returns what a
#: lookup would
_GENERATION = 0


def generation() -> int:
    """The caches' change count (``_GENERATION``)."""
    return _GENERATION


def _changed() -> None:
    global _GENERATION
    _GENERATION += 1


class AutotuneCache:
    """get/put JSON values keyed by ``cache_key`` strings."""

    def __init__(self, path: str):
        _changed()
        self.path = path
        self._lock = threading.Lock()
        self._data: Optional[Dict[str, Any]] = None
        # -- stats, for tests and ops dashboards ----------------------------
        # instance state, updated under self._lock: concurrent readers
        # previously raced the unsynchronized ``self.hits += 1`` (a
        # read-modify-write) and lost counts, so the attributes could
        # disagree with the obs counters
        self.hits: int = 0
        self.misses: int = 0

    #: when set ("autotune"/"plandb"), lookups also feed the repro_torch.obs
    #: counters ``<prefix>.hit`` / ``<prefix>.miss`` — bare instances used
    #: as scratch storage in tests stay silent
    metrics_prefix: Optional[str] = None

    def _load(self) -> Dict[str, Any]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    raw = json.load(f)
                self._data = raw if isinstance(raw, dict) else {}
            except (OSError, ValueError):
                self._data = {}
        return self._data

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            val = self._load().get(key)
            # accounting stays under the lock: the attribute bump and the
            # obs counter must move together or a concurrent reader can
            # observe them disagreeing (and lose attribute increments)
            if val is None:
                self.misses += 1
            else:
                self.hits += 1
            if self.metrics_prefix:
                from ..obs import counter

                counter(
                    f"{self.metrics_prefix}."
                    f"{'miss' if val is None else 'hit'}"
                ).inc()
        return val

    def contains(self, key: str) -> bool:
        """Presence probe that does NOT count as a hit or a miss — used by
        ``PlanDB`` to classify a miss as a version miss (an entry exists
        under an older PLAN_VERSION key)."""
        with self._lock:
            return key in self._load()

    def put(self, key: str, value: Any) -> None:
        _changed()
        with self._lock:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # the flock spans reload -> merge -> replace, so a concurrent
            # process's put cannot interleave and drop this write
            with _file_lock(self.path):
                self._data = None  # merge with concurrent writers
                data = dict(self._load())
                data[key] = value
                self._data = data
                fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
                try:
                    with os.fdopen(fd, "w") as f:
                        json.dump(data, f, indent=1, sort_keys=True)
                    os.replace(tmp, self.path)
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise

    def reload(self) -> None:
        """Drop the in-memory copy: the next lookup reads the file, which
        another process may have written since."""
        _changed()
        with self._lock:
            self._data = None

    def clear(self) -> None:
        _changed()
        with self._lock:
            self._data = {}
            for p in (self.path, self.path + ".lock"):
                try:
                    os.unlink(p)
                except OSError:
                    pass


_default: Optional[AutotuneCache] = None


def default_cache() -> AutotuneCache:
    """Process-wide cache at $REPRO_AUTOTUNE_CACHE or ~/.cache/repro_torch."""
    global _default
    path = os.environ.get("REPRO_AUTOTUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json"
    )
    if _default is None or _default.path != path:
        _default = AutotuneCache(path)
        _default.metrics_prefix = "autotune"
    return _default
