"""The grouped GEMM's planner and its grid, in plain Python (no card).

``plan`` picks ``mma`` for bf16 operands with 16-byte rows, with 32, 64
or 128 rows a block as R / G grows, and ``fma`` for f32 and for other
layouts; ``dw_plan`` the same by dtype and layout. ``tile_map`` is the
forward kernel's grid of ``ceil(R / BM) + G`` row tiles, each with its
group and rows as the kernel's ``find_tile`` forms them: the product
formed tile by tile from that map, with rows past the sum zeroed, equals
the plain version exactly, every row is covered once, no tile crosses a
group and no tile belongs to an empty group.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.grouped_matmul import grouped_matmul_ref, plan, tile_map
from repro_torch.kernels.grouped_matmul import ops

BMS = (32, 64, 128)


@pytest.mark.parametrize("rows,groups,bm", [
    (24, 64, 32),       # deepseek-moe-16b decode: 4 tokens x top-6
    (3072, 64, 64),     # its prefill: 4 x 128 tokens x top-6
    (24576, 64, 128),   # its training step: 8 x 512 x top-6
    (512, 16, 64),      # llama4-scout's prefill: 4 x 128 x top-1
    (4, 16, 32),        # its decode
])
def test_plan_block_rows_grow_with_rows_per_group(rows, groups, bm):
    assert plan(rows, groups, torch.bfloat16, True) == ops.Plan("mma", bm)


@pytest.mark.parametrize("dtype,aligned,want", [
    (torch.bfloat16, True, "mma"), (torch.bfloat16, False, "fma"),
    (torch.float32, True, "fma"), (torch.float32, False, "fma"),
])
def test_plan_variant_by_dtype_and_layout(dtype, aligned, want):
    assert plan(3072, 64, dtype, aligned).variant == want
    assert ops.dw_plan(dtype, aligned) == want


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_layouts_the_mma_kernel_takes():
    w = _bf16(8, 2048, 1408)
    assert ops._w_aligned(w)                        # unit stride along n
    assert ops._w_aligned(w.transpose(-1, -2))      # unit stride along k: dX's w^T, no copy
    assert not ops._w_aligned(_bf16(8, 64, 1001))   # rows off 16 bytes
    assert not ops._w_aligned(_bf16(8, 64, 96)[:, :, 1:])  # base off 16 bytes
    assert ops._w_aligned(_bf16(8, 128, 96)[:, ::2])        # every other k: ldw 192
    assert not ops._w_aligned(_bf16(8, 64, 96)[:, :, ::2])  # no unit stride
    x = _bf16(24, 2048)
    assert ops._rows16(x, 1, [0])
    assert not ops._rows16(_bf16(24, 1001), 1, [0])
    assert not ops._rows16(x.T.contiguous().T, 1, [0])


SIZES = {
    "random": [5, 0, 9, 3, 0, 7, 40, 1],
    "empty groups": [0, 0, 70, 0, 0, 3, 0, 0],
    "one group holds every row": [0, 0, 0, 100, 0],
    "rows past the sum": [3, 0, 5, 2],
    "sizes past the rows": [50, 50, 50],
    "all empty": [0, 0, 0],
    "decode": [1, 0, 2, 0, 0, 1, 0, 0] * 8,
}
ROWS = {"rows past the sum": 100, "sizes past the rows": 120, "all empty": 17}


def _emulate(x, w, sizes, bm):
    """The forward as the grid runs it: one (tile, all columns) at a time."""
    out = torch.full((x.shape[0], w.shape[-1]), float("nan"))
    for g, a, b in tile_map(sizes, x.shape[0], bm):
        if b <= a:
            continue
        out[a:b] = 0.0 if g < 0 else x[a:b] @ w[g]
    return out


@pytest.mark.parametrize("name", list(SIZES))
@pytest.mark.parametrize("bm", BMS + (ops.FMA_BM,))
def test_tile_map_covers_each_row_once_and_equals_the_plain_version(name, bm):
    sizes = torch.tensor(SIZES[name], dtype=torch.int32)
    rows = ROWS.get(name, int(sizes.sum()))
    tiles = tile_map(sizes, rows, bm)
    assert len(tiles) == -(-rows // bm) + len(sizes)  # the grid the kernel launches
    bounds, off = [], 0
    for s in sizes.tolist():
        bounds.append((min(off, rows), min(off + s, rows)))
        off += s
    covered = np.zeros(rows, int)
    for g, a, b in tiles:
        if b <= a:
            continue
        assert b - a <= bm
        covered[a:b] += 1
        if g >= 0:  # inside its group, and the group is not empty
            ga, gb = bounds[g]
            assert ga <= a and b <= gb and gb > ga
        else:
            assert a >= min(off, rows)
    assert (covered == 1).all()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(rows, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(len(sizes), 24, 20)).astype(np.float32))
    torch.testing.assert_close(_emulate(x, w, sizes, bm), grouped_matmul_ref(x, w, sizes),
                               rtol=0, atol=0)


def test_no_block_reads_an_empty_groups_weight():
    sizes = [0] * 60 + [4, 0, 20, 0]
    groups = {g for g, a, b in tile_map(sizes, 24, 32) if b > a and g >= 0}
    assert groups == {60, 62}
