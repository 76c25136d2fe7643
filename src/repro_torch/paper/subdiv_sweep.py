"""Paper Figs 4-6 analogue: which subdivision strategy pays off.

The paper's findings: subdividing the two maps does NOT beat the naive
best; subdividing the rnz (once or twice) does; subdividing everything adds
nothing over rnz-only.  The best ordering under each strategy is timed,
among the cost model's top ``limit`` candidates (the early cut).  Through
``execute`` the all-subdivided strategy makes 10^5-10^6 einsum calls a
variant.

    python -m repro_torch.paper.subdiv_sweep [--device cpu] [--executor lower] [--n 512] [--b 16]
"""

from __future__ import annotations

from ..core.cost import rank_variants
from ..core.enumerate import matmul_spec, variant_orders
from ..device import resolve_device
from .common import emit, measure, operands, parse_args


def best_time(spec, arrays, ref, executor, dev, limit=8):
    orders = variant_orders(spec)
    # early-cut with the cost model (paper future-work realized): measure
    # only the model's top candidates
    ranked = rank_variants(spec, orders)[:limit]
    best, best_order, best_calls = float("inf"), None, 0
    for _, order in ranked:
        t, calls = measure(spec, order, arrays, ref, executor, dev,
                           repeats=2)
        if t < best:
            best, best_order, best_calls = t, order, calls
    return best, best_order, best_calls


def run(n: int = 512, b: int = 16, device="cuda",
        executor: str = "execute") -> dict:
    dev = resolve_device(device)
    arrays = operands({"A": (n, n), "B": (n, n)}, 3, dev)
    ref = arrays["A"] @ arrays["B"]
    base = matmul_spec(n, n, n)
    strategies = {
        "naive": base,
        "maps_subdiv": base.subdivide("i", b).subdivide("k", b),
        "rnz_subdiv": base.subdivide("j", b),
        "rnz_subdiv_twice": base.subdivide("j", b * b).subdivide(
            "ji", b
        ),
        "all_subdiv": base.subdivide("j", b).subdivide("i", b).subdivide(
            "k", b
        ),
    }
    results = {}
    for name, spec in strategies.items():
        t, order, calls = best_time(spec, arrays, ref, executor, dev)
        results[name] = dict(s=t, order=order, einsums=calls)
        emit(f"subdiv.{name}", t,
             f"best_order={'/'.join(order)};einsums={calls}")
    # the paper's qualitative claims, as derived checks:
    emit(
        "subdiv.claim_rnz_beats_maps", 0.0,
        f"ok={results['rnz_subdiv']['s'] < results['maps_subdiv']['s']}",
    )
    return results


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0], n=512, b=16)
    run(args.n, args.b, args.device, args.executor)
