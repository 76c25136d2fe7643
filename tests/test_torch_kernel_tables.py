"""What the host hands B3 and B1's chain mode, checked on the CPU.

* B3 (``csrc/grouped.cu``): ``fused_gen.group_table`` cuts every non-empty
  group into row blocks of at most the M tile (``grouped_tile_m``): every
  row covered exactly once, no block across two groups, empty groups
  skipped, ragged tails; ``FusedKernel._table``'s largest block and band.
  The kernel's band rasterization is held on the card, at bands that split
  a group and bands past the table's end (``tests/test_torch_gpu.py``).
* The chain (``csrc/contract_chain.cu``): ``modes.chain_cluster``, and the
  association ``cuda_gen._launch_chain`` picks under ``_chain_cost`` at
  one qwen3-8b head's (QK^T)V shape and its three derived specs.

The kernels themselves need the card (``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import pytest
import torch

import repro_torch.core.enumerate as PE
from repro_torch import codegen
from repro_torch.codegen import cuda_gen, fused_gen, modes
from repro_torch.grad import derived_specs

KIMI_TRAIN = (320,) * 32   # kimi-k2 training: 32 experts of C = 320
KIMI_SERVE = (16,) * 384   # kimi-k2 serving: 384 experts of C = 16
SIZES = [
    (0, 1, 129, 320, 700),
    KIMI_TRAIN,
    KIMI_SERVE,
    (0, 0, 5),
    (0, 1, 17, 0, 100, 3, 0, 45, 1, 16),
    (64, 65, 128, 129, 256, 0),
    (1, 1, 1, 1),
    (0, 0, 0),
]


def _check_table(table, sizes, tile):
    """Every row once, in order; no block across two groups; empties
    skipped; every block at most ``tile`` rows, only a group's last block
    short."""
    offs = [sum(sizes[:g]) for g in range(len(sizes))]
    seen = []
    for gid, first, rows in table:
        assert 1 <= rows <= tile
        assert sizes[gid] > 0
        assert offs[gid] <= first and first + rows <= offs[gid] + sizes[gid]
        # a short block is its group's tail
        if rows < tile:
            assert first + rows == offs[gid] + sizes[gid]
        seen.extend(range(first, first + rows))
    assert seen == list(range(sum(sizes)))
    want_blocks = sum(-(-s // tile) for s in sizes)
    assert len(table) == want_blocks


@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: str(s)[:40])
def test_group_table_covers_every_row_once_within_its_group(sizes):
    tile = fused_gen.grouped_tile_m(sizes)
    assert tile in fused_gen.GROUPED_TILES
    live = [s for s in sizes if s]
    # 128 rows only where the groups average more than 64
    cap = 128 if live and sum(live) / len(live) > 64 else 64
    assert tile >= min(max(sizes), cap)
    # the smallest tile that holds the largest group, up to the cap
    assert all(t < min(max(sizes), cap)
               for t in fused_gen.GROUPED_TILES if t < tile)
    _check_table(fused_gen.group_table(sizes), sizes, tile)


@pytest.mark.parametrize("sizes,tile", [
    ((16, 0, 3), 16), ((17, 32), 32), ((33, 0, 64), 64), ((65, 65), 128),
    ((1, 1, 130), 64), ((200, 200, 1), 128), ((64,) * 7, 64),
    ((1000,), 128), ((129, 0, 0, 257), 128), ((15, 31), 32),
    ((0, 63, 1), 64), ((100, 40), 128),
])
def test_group_table_at_every_tile(sizes, tile):
    """Each M tile is picked and cut at: 128 only where the groups average
    more than 64 rows."""
    assert fused_gen.grouped_tile_m(sizes) == tile
    _check_table(fused_gen.group_table(sizes), sizes, tile)


def test_group_table_at_kimi_k2_shapes():
    train = fused_gen.group_table(KIMI_TRAIN)
    assert fused_gen.grouped_tile_m(KIMI_TRAIN) == 128
    # 128 + 128 + 64 rows for each expert, in order
    assert [r for _, _, r in train[:3]] == [128, 128, 64]
    assert len(train) == 3 * 32 and train[3] == (1, 320, 128)
    serve = fused_gen.group_table(KIMI_SERVE)
    # one block per expert, as the serving body has always run
    assert serve == [(g, 16 * g, 16) for g in range(384)]
    # ragged serving: one group of 100 among small ones takes 64-row
    # blocks (64 + 36), not the 128-row body
    ragged = (0, 1, 17, 0, 100, 3, 0, 45, 1, 16)
    assert fused_gen.grouped_tile_m(ragged) == 64
    assert [r for g, _, r in fused_gen.group_table(ragged) if g == 4] == [
        64, 36]


@pytest.mark.parametrize("sizes,want", [
    ((0, 1, 129, 320, 700), (128, 6)),
    (KIMI_TRAIN, (128, 3)),
    (KIMI_SERVE, (16, 1)),
    ((0, 0, 5), (5, 1)),
    ((0, 0, 0), (0, 1)),
])
def test_fused_kernel_table_max_rows_and_band(sizes, want):
    spec = PE.grouped_matmul_spec(sizes, 8, 16)
    kern = codegen.compile(spec, codegen.default_schedule(spec))
    table, max_rows, band = kern._table(torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape[1] == 3
    assert (max_rows, band) == want
    assert max_rows <= fused_gen.GROUPED_MAX_ROWS
    _check_table([tuple(r) for r in table.tolist()], sizes,
                 fused_gen.grouped_tile_m(sizes))


@pytest.mark.parametrize("dtype,step", [(torch.bfloat16, 64),
                                        (torch.float32, 32),
                                        (torch.int8, 32),
                                        (torch.float8_e4m3fn, 32)])
def test_chain_cluster_leaves_each_rank_two_steps(dtype, step):
    assert modes.chain_cluster(dtype, 4096) == modes.CHAIN_MAX_CLUSTER
    for p in (1, step, 2 * step, 4 * step - 1, 4 * step, 300, 1000, 10**6):
        cs = modes.chain_cluster(dtype, p)
        assert cs & (cs - 1) == 0 and 1 <= cs <= modes.CHAIN_MAX_CLUSTER
        steps = -(-p // step)
        assert cs == 1 or steps >= 2 * cs
        # the largest such power of two
        assert cs == modes.CHAIN_MAX_CLUSTER or steps < 4 * cs


CHAIN_SHAPE = (4096, 128, 4096, 128)  # one qwen3-8b head's (QK^T)V


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("which", ["chain_matmul", "dA", "dB", "dC"])
def test_chain_association_at_chain_shape(monkeypatch, dtype, which):
    """At CHAIN_SHAPE the forward and each derived spec run as the
    transposed chain (R', P', Q', N') = (128, 4096, 128, 4096), the cheaper
    association under the cluster cost, in one launch."""
    calls = []

    def record(x, y, z, out_dtype, *, epilogue=None, vectors=None,
               out=None, plan=None):
        calls.append((tuple(x.shape), tuple(y.shape), tuple(z.shape),
                      not out.is_contiguous()))
        return out

    monkeypatch.setattr(cuda_gen, "CONTRACT_CHAIN", record)
    base = PE.chain_matmul_spec(*CHAIN_SHAPE)
    spec = base if which == "chain_matmul" else (
        derived_specs(base)[which[1]])
    if dtype == torch.int8:
        spec = PE.quantize_spec(spec, fmt="int8")
    arrays = [torch.zeros([spec.extents[i] for i in ax], dtype=dtype)
              for ax in spec.operands.values()]
    out_dtype = cuda_gen._default_out_dtype(spec, None, dtype)
    cuda_gen._launch_cuda(spec, *arrays, out_dtype=out_dtype)
    assert [c[:3] for c in calls] == [((128, 4096), (4096, 128), (128, 4096))]
    # dB's chain A^T.dout.C^T lies that way round already; the others
    # are transposed (Z^T Y^T X^T into C^T)
    assert calls[0][3] == (which != "dB")
    r, p, q, c = 128, 4096, 128, 4096
    tile = modes.chain_tile_n(dtype)
    # T formed once per cluster of 8 column blocks, not once per block
    assert cuda_gen._chain_cost(r, p, q, c, dtype) == (
        r * p * q * (c // tile // 8) + r * q * c)
    assert cuda_gen._chain_cost(r, p, q, c, dtype) < cuda_gen._chain_cost(
        4096, 128, 4096, 128, dtype)
