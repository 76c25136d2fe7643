"""Strided array layouts — the paper's §2.1 data model.

An array is a flat buffer plus a list of ``(extent, stride)`` pairs.  Dims are
listed *innermost-first* (dim 0 has the smallest stride for a fresh row-major
array), exactly as in the paper's 120-element example::

    a^((3,1),(2,3),(5,6),(4,30))      # flat 4-D row-major tensor
    a^((3,1),(2,15),(5,3),(4,30))     # same buffer viewed as a subdivided matrix

Higher-order functions consume the *outermost* dimension, i.e. ``dims[-1]``.

Three logical (zero-copy) operators re-interpret the buffer:

* ``subdiv(d, b)``  — split dim ``d`` into blocks of ``b`` (paper's tiling)
* ``flatten(d)``    — merge dims ``d`` and ``d+1`` (inverse of subdiv)
* ``flip(d1, d2)``  — swap two dims (logical transposition)

``Layout`` is pure metadata; ``View`` pairs it with a numpy buffer and can
materialize the *logical* array (axes ordered outermost-first) for oracles.

This is the port's copy of the reference's module, numpy inside; the
strided views ``execute`` builds on tensors follow the same algebra.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Tuple

import numpy as np

Dim = Tuple[int, int]  # (extent, stride), strides in elements


@dataclasses.dataclass(frozen=True)
class Layout:
    """Immutable (extent, stride) list, innermost-first."""

    dims: Tuple[Dim, ...]

    # -- constructors ------------------------------------------------------
    @staticmethod
    def row_major(shape_outer_first: Tuple[int, ...]) -> "Layout":
        """Row-major layout for a logical shape given outermost-first.

        ``row_major((4, 3))`` is a 4x3 matrix of rows: dims ``((3,1),(4,3))``.
        """
        dims = []
        stride = 1
        for extent in reversed(shape_outer_first):
            dims.append((int(extent), stride))
            stride *= int(extent)
        return Layout(tuple(dims))

    # -- queries -----------------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.dims)

    @property
    def extents(self) -> Tuple[int, ...]:
        return tuple(e for e, _ in self.dims)

    @property
    def strides(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.dims)

    @property
    def size(self) -> int:
        return math.prod(self.extents) if self.dims else 1

    def shape_outer_first(self) -> Tuple[int, ...]:
        """Logical shape with the outermost dim first (numpy axis order)."""
        return tuple(reversed(self.extents))

    def offset(self, idx_inner_first: Tuple[int, ...]) -> int:
        assert len(idx_inner_first) == self.rank
        return sum(i * s for i, (_, s) in zip(idx_inner_first, self.dims))

    def indices(self) -> Iterator[Tuple[int, ...]]:
        """All logical indices, innermost-first component order."""

        def rec(d: int, prefix: Tuple[int, ...]):
            if d < 0:
                yield prefix
                return
            for i in range(self.dims[d][0]):
                yield from rec(d - 1, (i,) + prefix)

        yield from rec(self.rank - 1, ())

    # -- the paper's three logical operators --------------------------------
    def subdiv(self, d: int, b: int) -> "Layout":
        """Split dim ``d`` into inner blocks of size ``b`` (paper eq. on subdiv)."""
        d = d + self.rank if d < 0 else d
        e_d, s_d = self.dims[d]
        if e_d % b != 0:
            raise ValueError(f"subdiv: block {b} does not divide extent {e_d}")
        new = (
            self.dims[:d]
            + ((b, s_d), (e_d // b, b * s_d))
            + self.dims[d + 1 :]
        )
        return Layout(new)

    def flatten(self, d: int) -> "Layout":
        """Merge dims ``d`` (inner) and ``d+1`` (outer); inverse of subdiv."""
        d = d + self.rank if d < 0 else d
        if d + 1 >= self.rank:
            raise ValueError("flatten: needs two adjacent dims")
        (e_d, s_d), (e_d1, s_d1) = self.dims[d], self.dims[d + 1]
        if s_d1 != e_d * s_d:
            raise ValueError(
                f"flatten: dims {d},{d+1} are not contiguous "
                f"(stride {s_d1} != {e_d}*{s_d})"
            )
        new = self.dims[:d] + ((e_d * e_d1, s_d),) + self.dims[d + 2 :]
        return Layout(new)

    def flip(self, d1: int, d2: int | None = None) -> "Layout":
        """Swap dims ``d1`` and ``d2`` (default ``d1+1``). Involutive."""
        d1 = d1 + self.rank if d1 < 0 else d1
        if d2 is None:
            d2 = d1 + 1
        d2 = d2 + self.rank if d2 < 0 else d2
        dims = list(self.dims)
        dims[d1], dims[d2] = dims[d2], dims[d1]
        return Layout(tuple(dims))

    # -- relation to reshape/transpose --------------------------------------
    def is_separable(self) -> bool:
        """True if strides are products of extents of smaller-stride dims.

        Every layout reachable from ``row_major`` via subdiv/flatten/flip is
        separable; separable layouts lower to a reshape and a transpose.
        """
        nontrivial = [i for i in range(self.rank) if self.dims[i][0] > 1]
        order = sorted(nontrivial, key=lambda i: self.dims[i][1])
        stride = 1
        for i in order:
            e, s = self.dims[i]
            if s != stride:
                return False
            stride *= e
        return True

    def reshape_transpose_plan(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Return ``(reshape_shape, transpose_perm)`` lowering this view.

        Given the *flat row-major buffer*, ``buffer.reshape(reshape_shape)
        .transpose(transpose_perm)`` equals the logical array of this layout
        with axes outermost-first.
        """
        if not self.is_separable():
            raise ValueError(f"layout {self.dims} is not separable")
        # buffer reshaped to extents sorted by descending stride (row-major);
        # extent-1 dims carry no stride information — put them first (size-1
        # axes can sit anywhere in a reshape).
        ones = [i for i in range(self.rank) if self.dims[i][0] == 1]
        nontrivial = [i for i in range(self.rank) if self.dims[i][0] > 1]
        by_stride_desc = ones + sorted(
            nontrivial, key=lambda i: -self.dims[i][1]
        )
        reshape_shape = tuple(self.dims[i][0] for i in by_stride_desc)
        # logical axis k (outermost-first) is dim (rank-1-k); find where that
        # dim landed in the reshaped axes.
        pos_of_dim = {dim_i: ax for ax, dim_i in enumerate(by_stride_desc)}
        perm = tuple(pos_of_dim[self.rank - 1 - k] for k in range(self.rank))
        return reshape_shape, perm


@dataclasses.dataclass(frozen=True)
class View:
    """A flat numpy buffer interpreted through a Layout."""

    buffer: np.ndarray  # 1-D
    layout: Layout

    def __post_init__(self):
        assert self.buffer.ndim == 1

    @staticmethod
    def from_logical(arr: np.ndarray) -> "View":
        """Wrap a logical (outermost-first axes) array as a row-major view."""
        a = np.ascontiguousarray(arr)
        return View(a.reshape(-1), Layout.row_major(a.shape))

    def materialize(self) -> np.ndarray:
        """Logical array, axes outermost-first (a copy)."""
        itemsize = self.buffer.itemsize
        shape = self.layout.shape_outer_first()
        strides = tuple(
            s * itemsize for s in reversed(self.layout.strides)
        )
        return np.lib.stride_tricks.as_strided(
            self.buffer, shape=shape, strides=strides
        ).copy()

    # the three operators lift pointwise to views (zero-copy)
    def subdiv(self, d: int, b: int) -> "View":
        return View(self.buffer, self.layout.subdiv(d, b))

    def flatten(self, d: int) -> "View":
        return View(self.buffer, self.layout.flatten(d))

    def flip(self, d1: int, d2: int | None = None) -> "View":
        return View(self.buffer, self.layout.flip(d1, d2))
