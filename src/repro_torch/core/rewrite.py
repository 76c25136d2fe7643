"""Rewrite engine: applies the rules of ``rules.py`` over expression trees.

The paper implements pattern-match-and-replace with structured recursion
schemes (catamorphisms / paramorphisms); the Python equivalent is an explicit
bottom-up traversal with path-indexed node replacement.  Two modes:

* **normalization** — apply a rule set to fixpoint (used for fusion: the
  fusion subset is terminating because every rule strictly decreases the
  number of HoF nodes or layout operators);
* **directed derivation** — apply a named rule at an explicit path, recording
  a ``Trace``; this is how ``enumerate.py`` derives each permutation of a HoF
  nest from its neighbour by a single exchange, mirroring the paper's
  Steinhaus–Johnson–Trotter walk.

This is the port's copy of the reference's engine: the same traversal, so
``normalize`` and ``fuse`` record the same ``Trace`` (rule names at paths).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from . import expr as E
from .expr import children, rebuild

Path = Tuple[int, ...]
Rule = Callable[[E.Expr], Optional[E.Expr]]


@dataclasses.dataclass
class Step:
    rule: str
    path: Path
    before_size: int
    after_size: int


@dataclasses.dataclass
class Trace:
    steps: List[Step] = dataclasses.field(default_factory=list)

    def record(self, rule: str, path: Path, before: E.Expr, after: E.Expr):
        self.steps.append(Step(rule, path, E.size(before), E.size(after)))

    def __repr__(self):
        return " ; ".join(f"{s.rule}@{list(s.path)}" for s in self.steps)


def get_at(e: E.Expr, path: Path) -> E.Expr:
    for i in path:
        e = children(e)[i]
    return e


def replace_at(e: E.Expr, path: Path, new: E.Expr) -> E.Expr:
    if not path:
        return new
    kids = list(children(e))
    kids[path[0]] = replace_at(kids[path[0]], path[1:], new)
    return rebuild(e, tuple(kids))


def find_matches(e: E.Expr, rule: Rule) -> List[Path]:
    """All paths where ``rule`` fires (pre-order)."""
    out: List[Path] = []

    def go(e: E.Expr, path: Path):
        if rule(e) is not None:
            out.append(path)
        for i, c in enumerate(children(e)):
            go(c, path + (i,))

    go(e, ())
    return out


def apply_at(
    e: E.Expr, path: Path, rule: Rule, trace: Optional[Trace] = None
) -> E.Expr:
    node = get_at(e, path)
    new = rule(node)
    if new is None:
        raise ValueError(
            f"rule {getattr(rule, '__name__', rule)} does not match at {path}: "
            f"{node!r}"
        )
    if trace is not None:
        trace.record(getattr(rule, "__name__", str(rule)), path, node, new)
    return replace_at(e, path, new)


def rewrite_once(
    e: E.Expr, rules: Sequence[Rule], trace: Optional[Trace] = None
) -> Tuple[E.Expr, bool]:
    """One bottom-up pass; apply the first matching rule at each node."""

    changed = False

    def go(e: E.Expr, path: Path) -> E.Expr:
        nonlocal changed
        kids = tuple(
            go(c, path + (i,)) for i, c in enumerate(children(e))
        )
        e2 = rebuild(e, kids)
        for rule in rules:
            new = rule(e2)
            if new is not None:
                changed = True
                if trace is not None:
                    trace.record(
                        getattr(rule, "__name__", str(rule)), path, e2, new
                    )
                return new
        return e2

    return go(e, ()), changed


def normalize(
    e: E.Expr,
    rules: Sequence[Rule],
    max_steps: int = 200,
    trace: Optional[Trace] = None,
) -> E.Expr:
    """Apply ``rules`` bottom-up to fixpoint."""
    for _ in range(max_steps):
        e, changed = rewrite_once(e, rules, trace)
        if not changed:
            return e
    raise RuntimeError(f"normalize: no fixpoint after {max_steps} passes")


def fuse(e: E.Expr, trace: Optional[Trace] = None) -> E.Expr:
    """Normalize with the fusion subset (paper's group-1 rules)."""
    from .rules import FUSION_RULES

    return normalize(e, FUSION_RULES, trace=trace)
