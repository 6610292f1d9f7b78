"""The grouped GEMM's planner, its grids and tile lists, in plain Python
(no card).

``plan`` picks ``wgmma`` for bf16 operands that TMA can describe over at
most ``WGMMA_MAX_GROUPS`` groups (64 rows a tile up to
``WGMMA_BM64_ROWS`` rows a group, 128 above), and ``fma`` for the rest;
``dw_plan`` the same variant by the same rule. ``_tma`` is the layout
TMA takes. ``tile_map`` is the ``fma`` forward's grid of
``ceil(R / BM) + G`` row tiles, each with its group and rows as the
kernel's ``find_tile`` forms them, and ``tile_list`` the ``wgmma``
forward's list of (group, rows, column) tiles as ``group_list`` and
``fwd_tile`` form them: the product formed tile by tile from either, with
rows past the sum zeroed, equals the plain version exactly, every row (of
every column tile) is covered once, no tile crosses a group and no tile
belongs to an empty group. ``dw_stages`` is the ``wgmma`` dW's row
stages: summed stage by stage with the next group's rows zeroed, they
give the plain version's dW exactly (integer-valued data, so that the
order of the f32 sums cannot change a bit).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul import grouped_matmul_dw_ref, grouped_matmul_ref, plan
from repro_torch.kernels.grouped_matmul import tile_map
from repro_torch.kernels.grouped_matmul import ops

BMS = (32, 64, 128)
WGMMA_BMS = (64, 128)


@pytest.mark.parametrize("rows,groups,want", [
    (24, 64, ops.Plan("wgmma", 64)),       # deepseek-moe-16b decode: 4 tokens x top-6
    (3072, 64, ops.Plan("wgmma", 64)),     # its prefill: 4 x 128 tokens x top-6
    (24576, 64, ops.Plan("wgmma", 128)),   # its training step: 8 x 512 x top-6
    (512, 16, ops.Plan("wgmma", 64)),      # llama4-scout's prefill: 4 x 128 x top-1
    (4, 16, ops.Plan("wgmma", 64)),        # its decode
])
def test_plan_block_rows_grow_with_rows_per_group(rows, groups, want):
    assert plan(rows, groups, torch.bfloat16, True) == want


@pytest.mark.parametrize("dtype,aligned,want", [
    (torch.bfloat16, True, "wgmma"), (torch.bfloat16, False, "fma"),
    (torch.float32, True, "fma"), (torch.float32, False, "fma"),
])
def test_plan_variant_by_dtype_and_layout(dtype, aligned, want):
    assert plan(3072, 64, dtype, aligned).variant == want
    assert ops.dw_plan(dtype, aligned) == want


def test_plan_keeps_wgmma_to_the_groups_its_tile_list_holds():
    many = ops.WGMMA_MAX_GROUPS + 1
    assert plan(100 * many, many, torch.bfloat16, True) == ops.Plan("fma", ops.FMA_BM)
    assert ops.dw_plan(torch.bfloat16, True, many) == "fma"
    assert plan(100 * (many - 1), many - 1, torch.bfloat16, True) == ops.Plan("wgmma", 128)
    assert ops.dw_plan(torch.bfloat16, True, ops.WGMMA_MAX_GROUPS) == "wgmma"


@pytest.mark.parametrize("groups", [1, 16, 64, ops.WGMMA_MAX_GROUPS, ops.WGMMA_MAX_GROUPS + 1,
                                    4096])
@pytest.mark.parametrize("dtype,aligned", [(torch.bfloat16, True), (torch.bfloat16, False),
                                           (torch.float32, True)])
def test_plan_and_dw_plan_agree(groups, dtype, aligned):
    """A training call's forward, dX and dW run one variant, on either
    side of the wgmma tile list's limit."""
    assert plan(384 * groups, groups, dtype, aligned).variant == ops.dw_plan(dtype, aligned,
                                                                              groups)


@pytest.mark.parametrize("variant,rows,groups,want", [
    ("wgmma", 24, 64, ops.Plan("wgmma", 64)),     # forced at decode: one consumer warpgroup
    ("wgmma", 24576, 64, ops.Plan("wgmma", 128)),
    ("wgmma", 3072, 64, ops.Plan("wgmma", 64)),   # prefill: 48 rows a group
    ("fma", 24576, 64, ops.Plan("fma", ops.FMA_BM)),  # forced in training: fma's block rows
    ("fma", 3072, 64, ops.Plan("fma", ops.FMA_BM)),
])
def test_forced_variants_take_their_own_block_rows(variant, rows, groups, want):
    assert ops._forced(variant, rows, groups) == want


@pytest.mark.parametrize("force,dtype,tma", [
    ("wgmma", torch.float32, True), ("wgmma", torch.bfloat16, False),
    ("mma", torch.bfloat16, True), ("mma", torch.float32, True),  # no mma kernel
    ("dense", torch.bfloat16, True),
])
def test_a_forced_variant_the_layout_cannot_take_raises(force, dtype, tma):
    with pytest.raises(ValueError):
        ops._check_force(force, dtype, tma, "grouped_matmul")


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_layouts_the_tma_maps_take():
    """TMA takes what has 16-byte rows, within its extents and strides."""
    w = _bf16(8, 2048, 1408)
    assert ops._w_tma(w)                            # MN-major B (row-major weights)
    assert ops._w_tma(w.transpose(-1, -2))          # K-major B: dX's w^T, no copy
    assert not ops._w_tma(_bf16(8, 64, 1001))       # rows off 16 bytes
    assert not ops._w_tma(_bf16(8, 64, 96)[:, :, 1:])  # base off 16 bytes
    assert ops._w_tma(_bf16(8, 128, 96)[:, ::2])          # every other k: a row stride of 192
    assert not ops._w_tma(_bf16(8, 64, 96)[:, :, ::2])    # no unit stride
    x = _bf16(24, 2048)
    assert ops._tma(x, 1, [0])
    assert not ops._tma(_bf16(24, 1001), 1, [0])
    assert not ops._tma(x.T.contiguous().T, 1, [0])
    assert ops._tma(_bf16(1, 1001), 1, [0])         # one row: its stride is never used
    big = torch.empty_strided((2, 8), (2**39, 1), dtype=torch.bfloat16, device="meta")
    assert ops._rows16(big, 1, [0]) and not ops._tma(big, 1, [0])  # a stride of 2**40 bytes


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


def _emulate_list(x, w, sizes, bm, bn):
    """The wgmma forward as its persistent blocks run it: one (rows,
    columns) tile at a time."""
    out = torch.full((x.shape[0], w.shape[-1]), float("nan"))
    for g, a, b, n0 in ops.tile_list(sizes, x.shape[0], bm, w.shape[-1], bn):
        out[a:b, n0:n0 + bn] = 0.0 if g < 0 else x[a:b] @ w[g][:, n0:n0 + bn]
    return out


@pytest.mark.parametrize("name", list(SIZES))
@pytest.mark.parametrize("bm", WGMMA_BMS)
def test_tile_list_covers_each_row_once_and_equals_the_plain_version(name, bm):
    sizes = torch.tensor(SIZES[name], dtype=torch.int32)
    rows, n, bn = ROWS.get(name, int(sizes.sum())), 20, 8  # 3 column tiles, the last ragged
    tiles = ops.tile_list(sizes, rows, bm, n, bn)
    # the kernel's bound on the list, from which it sizes its grid
    assert len(tiles) <= (-(-rows // bm) + len(sizes)) * -(-n // bn)
    bounds = [(min(sum(SIZES[name][:g]), rows), min(sum(SIZES[name][:g + 1]), rows))
              for g in range(len(sizes))]
    covered = np.zeros((rows, -(-n // bn)), int)
    for g, a, b, n0 in tiles:
        assert 0 < b - a <= bm and n0 % bn == 0
        covered[a:b, n0 // bn] += 1
        if g >= 0:  # inside its group, and the group is not empty
            ga, gb = bounds[g]
            assert ga <= a and b <= gb and gb > ga
        else:
            assert a >= min(sum(SIZES[name]), rows)
    assert (covered == 1).all()
    groups = [g for g, *_ in tiles]
    assert groups == sorted(groups, key=lambda g: g if g >= 0 else len(sizes))  # group order
    rng = np.random.default_rng(0)  # small integers: a column slice's product is exact
    x = torch.from_numpy(rng.integers(-3, 4, size=(rows, 24)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-3, 4, size=(len(sizes), 24, n)).astype(np.float32))
    torch.testing.assert_close(_emulate_list(x, w, sizes, bm, bn),
                               grouped_matmul_ref(x, w, sizes), rtol=0, atol=0)


def _emulate_dw_stages(x, dy, sizes):
    """The wgmma dW as its consumers sum it: each group's stages of
    DW_ROWS rows from its first row, rows past R zero (TMA's fill), rows
    past the group's zeroed in shared memory, in both operands."""
    rows, st = x.shape[0], ops.DW_ROWS
    pad = lambda t: torch.cat([t, t.new_zeros(st, t.shape[1])])  # noqa: E731
    xp, dp = pad(x), pad(dy)
    dw = torch.zeros(len(sizes), x.shape[1], dy.shape[1])
    for g, stages in enumerate(ops.dw_stages(sizes, rows)):
        for r, valid in stages:
            xs, ds = xp[r:r + st].clone(), dp[r:r + st].clone()
            assert 0 < valid <= st
            xs[valid:] = 0
            ds[valid:] = 0
            dw[g] += xs.T @ ds
    return dw


@pytest.mark.parametrize("name", list(SIZES))
def test_dw_stages_with_their_masks_equal_the_plain_version(name):
    sizes = torch.tensor(SIZES[name], dtype=torch.int32)
    rows = ROWS.get(name, int(sizes.sum()))
    stages = ops.dw_stages(sizes, rows)
    covered = np.zeros(rows, int)
    for stg in stages:
        for r, valid in stg:
            covered[r:r + valid] += 1
    used = min(int(sizes.sum()), rows)
    assert (covered[:used] == 1).all() and not covered[used:].any()
    rng = np.random.default_rng(1)  # small integers: every f32 sum exact in any order
    x = torch.from_numpy(rng.integers(-3, 4, size=(rows, 24)).astype(np.float32))
    dy = torch.from_numpy(rng.integers(-3, 4, size=(rows, 20)).astype(np.float32))
    torch.testing.assert_close(_emulate_dw_stages(x, dy, sizes),
                               grouped_matmul_dw_ref(x, dy, sizes), rtol=0, atol=0)


def test_dw_stages_need_their_masks():
    """A group of 3 rows before one of 70: its one stage holds 61 of the
    next group's rows, which the mask removes."""
    sizes = torch.tensor([3, 70], dtype=torch.int32)
    assert ops.dw_stages(sizes, 73) == [[(0, 3)], [(3, 64), (67, 6)]]
    x, dy = torch.ones(73, 4), torch.ones(73, 2)
    assert _emulate_dw_stages(x, dy, sizes)[0].eq(3).all()


@pytest.mark.parametrize("name", ["random", "empty groups", "rows past the sum"])
def test_dw_ref_in_bf16_is_the_f32_result_cast(name):
    sizes = torch.tensor(SIZES[name], dtype=torch.int32)
    rows = ROWS.get(name, int(sizes.sum()))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(rows, 24)).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.normal(size=(rows, 20)).astype(np.float32)).to(torch.bfloat16)
    got = grouped_matmul_dw_ref(x, dy, sizes, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, grouped_matmul_dw_ref(x, dy, sizes).to(torch.bfloat16))


def test_no_wgmma_tile_reads_an_empty_groups_weight():
    sizes = [0] * 60 + [40, 0, 200, 0]
    groups = {g for g, *_ in ops.tile_list(sizes, 240, 128, 2048, 256)}
    assert groups == {60, 62}


def test_a_header_edit_rebuilds_every_kernel(tmp_path, monkeypatch):
    """The library's name hashes the shared headers: an edit of
    wgmma_util.cuh gives dos_matmul and grouped_matmul new libraries."""
    for name in ("dos_matmul.cu", "grouped_matmul.cu", "wgmma_util.cuh", "mma_util.cuh"):
        (tmp_path / name).write_bytes(open(f"{_build.CSRC}/{name}", "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = {n: _build._lib_path(n, str(tmp_path / f"{n}.cu"))
              for n in ("dos_matmul", "grouped_matmul")}
    with open(tmp_path / "wgmma_util.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._lib_path(n, str(tmp_path / f"{n}.cu")) for n in before}
    assert all(before[n] != after[n] for n in before)


def test_no_block_reads_an_empty_groups_weight():
    sizes = [0] * 60 + [4, 0, 20, 0]
    groups = {g for g, a, b in tile_map(sizes, 24, 32) if b > a and g >= 0}
    assert groups == {60, 62}
