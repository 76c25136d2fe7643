"""Paper Table 1: the six permutations of naive matmul.

The paper's C++14 codegen measured (1024x1024 doubles, on a laptop CPU, an
i5-7300HQ):

    mapA rnz  mapB   0.45 s     <- best: B read row-wise innermost
    rnz  mapA mapB   1.41 s
    mapA mapB rnz    4.67 s     (the textbook form)
    mapB mapA rnz    6.05 s
    rnz  mapB mapA  13.8  s
    mapB rnz  mapA  15.6  s     <- worst: both column-wise

HoF order maps to loop indices: mapA = i (rows of A), mapB = k (cols of B),
rnz = j.  Every ordering runs through the chosen executor (``execute``:
outer loops real, the innermost two one einsum over strided views;
``lower``: the vmapped nest), is held against ``torch.matmul``, and the
measured ordering is ranked against the paper's and the analytic cost
model's.

    python -m repro_torch.paper.table1 [--device cpu] [--executor lower] [--n 384]
"""

from __future__ import annotations

from ..core.cost import cpu_cost
from ..core.enumerate import matmul_spec, variant_orders
from ..device import resolve_device
from .common import (emit, emit_yardstick, measure, operands, parse_args,
                     spearman, yardstick)

HOF_NAMES = {"i": "mapA", "j": "rnz", "k": "mapB"}

#: the paper's measured ordering, best -> worst
PAPER_ORDER = [
    ("mapA", "rnz", "mapB"),
    ("rnz", "mapA", "mapB"),
    ("mapA", "mapB", "rnz"),
    ("mapB", "mapA", "rnz"),
    ("rnz", "mapB", "mapA"),
    ("mapB", "rnz", "mapA"),
]


def run(n: int = 384, device="cuda", executor: str = "execute",
        repeats: int = 3) -> dict:
    dev = resolve_device(device)
    spec = matmul_spec(n, n, n)
    arrays = operands({"A": (n, n), "B": (n, n)}, 0, dev)
    ref = arrays["A"] @ arrays["B"]
    rows = []
    for order in variant_orders(spec, dedup_rnz=False):
        t, calls = measure(spec, order, arrays, ref, executor, dev, repeats)
        label = "/".join(HOF_NAMES[i] for i in order)
        cost = cpu_cost(spec, order)
        rows.append(dict(label=label, order=order, s=t, cost=cost,
                         einsums=calls))
        emit(f"table1.{label}", t, f"model_cost={cost:.3g};einsums={calls}")

    measured = {r["label"]: r["s"] for r in rows}
    paper_rank = ["/".join(p) for p in PAPER_ORDER]
    rho_paper = spearman([measured[l] for l in paper_rank], list(range(6)))
    rho_model = spearman([r["s"] for r in rows], [r["cost"] for r in rows])
    emit("table1.rank_corr_vs_paper", 0.0, f"spearman={rho_paper:.2f}")
    emit("table1.rank_corr_vs_costmodel", 0.0, f"spearman={rho_model:.2f}")
    y = yardstick(arrays["A"], arrays["B"], dev)
    emit_yardstick("table1", y)
    return dict(n=n, executor=executor, rows=rows, rho_paper=rho_paper,
                rho_model=rho_model, **y)


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0], n=384)
    run(args.n, args.device, args.executor)
