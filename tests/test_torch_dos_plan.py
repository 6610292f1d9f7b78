"""The dOS matmul's host planner (``repro_torch.kernels.dos_matmul.plan``).

The planner picks the CUDA kernel and its tiling from the shape before
the launch; it is pure Python, so its rules are held here on the CPU:
every bf16 projection of the ported models goes to ``skinny`` (M <= 16)
or ``wgmma``, never ``general``; operands TMA cannot describe go to
``general`` at M > 16, and so do bf16 operands asked for an f32 output;
f32 goes to ``f32``; a K split never exceeds a cluster of 8 blocks and
its chunks cover K exactly. The kernels
themselves are held on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.dos_matmul import dos_matmul, plan
from repro_torch.kernels.dos_matmul.ops import (MAX_CLUSTER, N_SM, SKINNY_BM, W_BK,
                                                skinny_max_blocks)

ARCHS = ["smollm-135m", "zamba2-2.7b", "gemma3-1b", "qwen2.5-3b"]
MS = [1, 2, 4, 256, 512]


def projection_gemms(cfg):
    """(K, N, B transposed, ldb) of every projection and the head."""
    e, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    shapes = [(e, q), (e, kv), (q, e), (e, f), (f, e)]
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * e
        shapes += [(e, di), (e, cfg.ssm_state), (e, di // cfg.ssm_head_dim), (di, e)]
    out = [(k, n, False, n) for k, n in shapes]
    # the tied head multiplies by tok.T: unit stride along k, rows e apart
    out.append((e, v, True, e) if cfg.tie_embeddings else (e, v, False, v))
    return out


def _check_split(p, k):
    assert 1 <= p.split <= MAX_CLUSTER
    if k:
        # the chunks [r * k_chunk, (r + 1) * k_chunk) of ranks 0..split-1
        # cover [0, k) exactly, and none is empty
        assert (p.split - 1) * p.k_chunk < k <= p.split * p.k_chunk
    if p.variant == "skinny":
        assert p.k_chunk % 8 == 0 and p.bm == SKINNY_BM and p.bn in (64, 128)
    if p.variant == "wgmma":
        assert p.k_chunk % W_BK == 0 and p.bm == 128 and p.bn in (64, 128, 192, 256)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch", ARCHS)
def test_projections_plan_to_skinny_or_wgmma(arch, m):
    for k, n, b_t, ldb in projection_gemms(get_config(arch)):
        p = plan(m, n, k, torch.bfloat16, ldb, b_t, True)
        assert p.variant == ("skinny" if m <= 16 else "wgmma"), (arch, m, k, n, p)
        _check_split(p, k)


@pytest.mark.parametrize("case,want", [
    ((37, 130, 200, torch.bfloat16, 130, False, True), "general"),  # chip_smoke's edge: ldb = N = 130
    ((37, 128, 100, torch.bfloat16, 128, False, True), "general"),  # K = 100 alone
    ((64, 130, 256, torch.bfloat16, 130, False, True), "general"),  # ldb = 130 alone
    ((64, 256, 256, torch.bfloat16, 256, False, False), "general"),  # an offset base
    ((64, 300, 100, torch.bfloat16, 100, True, True), "general"),  # transposed, K = 100
    ((37, 130, 200, torch.bfloat16, 200, True, True), "wgmma"),  # transposed: ldb = K = 200
    ((17, 64, 2560, torch.bfloat16, 64, False, True), "wgmma"),
    ((4, 130, 200, torch.bfloat16, 130, False, True), "skinny"),
    ((16, 128, 200, torch.bfloat16, 128, False, False), "skinny"),
    ((3, 300, 200, torch.bfloat16, 200, True, False), "skinny"),
    ((1, 1, 1, torch.bfloat16, 1, False, True), "skinny"),
    ((4, 576, 576, torch.float32, 576, False, True), "f32"),
    ((512, 2560, 2560, torch.float32, 2560, False, True), "f32"),
    # bf16 operands, f32 output: skinny and wgmma store bf16 only
    ((4, 576, 576, torch.bfloat16, 576, False, True, torch.float32), "general"),
    ((512, 2560, 2560, torch.bfloat16, 2560, False, True, torch.float32), "general"),
    ((4, 576, 576, torch.float32, 576, False, True, torch.bfloat16), "f32"),
    ((4, 576, 576, torch.bfloat16, 576, False, True, torch.bfloat16), "skinny"),
])
def test_variant_rules(case, want):
    p = plan(*case)
    assert p.variant == want
    _check_split(p, case[2])


@pytest.mark.parametrize("seed", range(4))
def test_splits_cover_k(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        m = int(rng.choice([1, 3, 4, 8, 16, 17, 63, 65, 200, 512, 4096]))
        n = int(rng.integers(1, 70000))
        k = int(rng.integers(1, 30000))
        aligned = bool(rng.integers(0, 2))
        ldb = k if rng.integers(0, 2) else n
        p = plan(m, n, k, torch.bfloat16, ldb, ldb == k, aligned)
        _check_split(p, k)
        assert p.variant != "f32"
        if p.variant == "general":
            assert m > 16 and not (aligned and k % 8 == 0 and ldb % 8 == 0)


def test_decode_shapes_fill_the_card():
    """At M = 4 no zamba2 GEMM runs as one block walking all of K: the
    N = 64 projections take 8 splits, and every wide one has more blocks
    than the card's 132 SMs, but no more than the planner's budget."""
    for k, n, b_t, ldb in projection_gemms(get_config("zamba2-2.7b")):
        p = plan(4, n, k, torch.bfloat16, ldb, b_t, True)
        blocks = p.split * -(-n // p.bn)
        assert blocks >= 8
        if n >= 2560:
            assert N_SM <= blocks <= max(skinny_max_blocks(N_SM), -(-n // p.bn))
        if k == 10240:
            assert p.k_chunk <= 2048  # cut >= 5 ways, not walked by 40 blocks alone


@pytest.mark.parametrize("m", [5, 8, 13, 16])
def test_skinny_rows_beyond_four_take_more_blocks(m):
    """5 <= M <= 16 runs the 4-row kernel over ceil(M / 4) row chunks of
    the grid; the K split shrinks so the grid stays within its budget."""
    for k, n, b_t, ldb in projection_gemms(get_config("zamba2-2.7b")):
        p4 = plan(4, n, k, torch.bfloat16, ldb, b_t, True)
        p = plan(m, n, k, torch.bfloat16, ldb, b_t, True)
        chunks = -(-m // SKINNY_BM)
        assert p.variant == "skinny" and (p.bm, p.bn) == (p4.bm, p4.bn)
        assert p.split <= p4.split
        tiles = -(-n // p.bn) * chunks
        if p.split > 1:
            assert tiles * p.split <= skinny_max_blocks(N_SM)


@pytest.mark.parametrize("m,k,n", [(4, 2560, 2560), (4, 10240, 2560), (512, 2560, 64),
                                   (512, 2560, 5120)])
def test_plan_follows_the_sm_count(m, k, n):
    """The planner fills the card it is given: on a card with half the
    SMs a grid is never larger."""
    full = plan(m, n, k, torch.bfloat16, n, False, True)
    half = plan(m, n, k, torch.bfloat16, n, False, True, n_sm=N_SM // 2)
    assert full == plan(m, n, k, torch.bfloat16, n, False, True, n_sm=N_SM)
    blocks = lambda p: p.split * -(-n // p.bn) * -(-m // p.bm)  # noqa: E731
    assert blocks(half) <= blocks(full)
    _check_split(half, k)


def test_cpu_path_counts_no_variant():
    before = dict(dos_matmul.variants)
    a = torch.randn(4, 16, dtype=torch.bfloat16)
    dos_matmul(a, torch.randn(16, 8, dtype=torch.bfloat16))
    assert dos_matmul.variants == before
    assert set(before) == {"skinny", "wgmma", "general", "f32"}
