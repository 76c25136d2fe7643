"""Paper Table 2: twelve orderings of the rnz-subdivided matmul (b=16).

The paper's best case (186 ms against 4.9 s for naive C, on its laptop
CPU) nests ``rnz mapA mapB rnz``: outer reduction blocks, output tile
resident, inner reduction innermost — the blocked GEMM.  The 12-case
enumeration runs through the chosen executor, each case is held against
``torch.matmul``, timed, and ranked against the cost model; the paper
records only its best case, so that case's measured rank is reported.

    python -m repro_torch.paper.table2 [--device cpu] [--executor lower] [--n 384] [--b 16]
"""

from __future__ import annotations

from ..core.cost import cpu_cost
from ..core.enumerate import matmul_spec, variant_orders
from ..device import resolve_device
from .common import (emit, emit_yardstick, measure, operands, parse_args,
                     spearman, yardstick)

HOF = {"i": "mapA", "jo": "rnz", "ji": "rnz", "k": "mapB"}

#: the paper's best case, the one ordering of Table 2 it ranks
PAPER_BEST = "rnz/mapA/mapB/rnz"


def run(n: int = 384, b: int = 16, device="cuda",
        executor: str = "execute", repeats: int = 3) -> dict:
    dev = resolve_device(device)
    spec = matmul_spec(n, n, n).subdivide("j", b)
    arrays = operands({"A": (n, n), "B": (n, n)}, 1, dev)
    ref = arrays["A"] @ arrays["B"]
    orders = variant_orders(spec)
    assert len(orders) == 12, len(orders)
    rows = []
    for order in orders:
        t, calls = measure(spec, order, arrays, ref, executor, dev, repeats)
        label = "/".join(HOF[i] for i in order)
        cost = cpu_cost(spec, order)
        rows.append(dict(label=label, order=order, s=t, cost=cost,
                         einsums=calls))
        emit(f"table2.{label}", t, f"model_cost={cost:.3g};einsums={calls}")
    rho = spearman([r["s"] for r in rows], [r["cost"] for r in rows])
    best_measured = min(rows, key=lambda r: r["s"])
    best_model = min(rows, key=lambda r: r["cost"])
    by_time = sorted(rows, key=lambda r: r["s"])
    paper_best_rank = 1 + [r["label"] for r in by_time].index(PAPER_BEST)
    emit("table2.rank_corr_vs_costmodel", 0.0, f"spearman={rho:.2f}")
    emit(
        "table2.best", best_measured["s"],
        f"measured={best_measured['label']};model_pick={best_model['label']}",
    )
    emit("table2.paper_best_rank", 0.0,
         f"{PAPER_BEST}={paper_best_rank}/{len(rows)}")
    y = yardstick(arrays["A"], arrays["B"], dev)
    emit_yardstick("table2", y)
    return dict(n=n, b=b, executor=executor, rows=rows, rho_model=rho,
                best_measured=best_measured["label"],
                model_pick=best_model["label"],
                paper_best_rank=paper_best_rank, **y)


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0], n=384, b=16)
    run(args.n, args.b, args.device, args.executor)
