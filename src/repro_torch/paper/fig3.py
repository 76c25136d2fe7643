"""Paper Fig 3: the six rearrangements of the subdivided matrix-vector
product (1a/1b/1c subdivide the vector; 2a/2b/2c subdivide the map).

Each runs through the chosen executor, is held against ``torch.matmul``,
timed, and ranked against the cost model (the paper gives no measured
order for the figure).

    python -m repro_torch.paper.fig3 [--device cpu] [--executor lower] [--n 1024] [--b 64]
"""

from __future__ import annotations

from ..core.cost import cpu_cost
from ..core.enumerate import paper_fig3_variants
from ..device import resolve_device
from .common import (emit, emit_yardstick, measure, operands, parse_args,
                     spearman, yardstick)


def run(n: int = 1024, b: int = 64, device="cuda",
        executor: str = "execute", repeats: int = 3) -> dict:
    dev = resolve_device(device)
    arrays = operands({"A": (n, n), "u": (n,)}, 2, dev)
    ref = arrays["A"] @ arrays["u"]
    rows = []
    for label, order, spec in paper_fig3_variants(n, n, b):
        t, calls = measure(spec, order, arrays, ref, executor, dev, repeats)
        cost = cpu_cost(spec, order)
        rows.append(dict(label=label, order=order, s=t, cost=cost,
                         einsums=calls))
        emit(f"fig3.{label}", t, f"model_cost={cost:.3g};einsums={calls}")
    rho = spearman([r["s"] for r in rows], [r["cost"] for r in rows])
    emit("fig3.rank_corr_vs_costmodel", 0.0, f"spearman={rho:.2f}")
    y = yardstick(arrays["A"], arrays["u"], dev)
    emit_yardstick("fig3", y)
    return dict(n=n, b=b, executor=executor, rows=rows, rho_model=rho, **y)


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0], n=1024, b=64)
    run(args.n, args.b, args.device, args.executor)
