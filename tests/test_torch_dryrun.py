"""The dry-run (``launch/dryrun.py``): meta-device accounting of each
cell's sharded step, held three ways on the CPU.

- **Against the reference's pure functions**, exactly, for every arch x
  shape: ``model_flops_for``, ``microbatch_policy``, ``n_units``, the
  fields ``variant_cfg`` sets, ``cell_key`` and ``configs.cells()``.
- **Against the reference's lowering** (8 fake devices, the mesh's axes
  ``AxisType.Auto``, as ``tests/test_torch_sharding_ranks.py`` builds it):
  reduced gemma3-1b train 4 x 64 under ``dos`` with FSDP at (2, 4), its
  decode twin and a reduced MoE train cell. The argument bytes are
  XLA's ``argument_size_in_bytes`` exactly, but for the decode cache's
  length: the reference keeps one int32 per layer, the port one host
  int, so the port holds 4 bytes a layer less. Both put bytes on the
  wire under ``dos``. FLOPs and wire bytes are printed, not gated: XLA
  counts loop bodies once and counts elementwise work, the port counts
  every matmul-class op once per run (remat's recompute included) and
  the flash kernel at the dense 4 B H Sq Skv D its plain version runs.
- **Against rank 0 of 8 ``gloo`` ranks** (``tests/_torch_ranks.py``): a
  reduced cell of each family at (2, 4), train, prefill and decode,
  accounted on a ``MeshSpec`` equals what rank 0 issues and holds: its
  collectives op by op (op, dtype, shape, group size), the bytes of its
  shards, and the FLOPs the same recorder counts on the plain versions,
  which each kernel's meta charge equals at the same shapes.

Then the unit combination (``measure_cost_corrected``) against the full
count, one production cell per family through ``run_and_save``, the
meta branch's reach (meta only: a CPU tensor takes the plain version, a
collective over a ``MeshSpec`` raises outside the accounting; a meta
call moves no wrapper's launch counters; the accounting changes no op
on CPU tensors), and the kernels' ``work`` at phase 4's shapes against
the bounds PERF.md §6 reports. The lowering and the gloo job run in
subprocesses started with the module's first test, beside the others;
the tests that read them come last.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import importlib
import json
import os
import pickle

import pytest
import torch

from _torch_ranks import run_ranks
from conftest import run_multidevice
from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.configs import REGISTRY, cells, get_config, reduced
from repro_torch.kernels import (
    KERNELS, dos_matmul, flash_attention, grouped_matmul, launch_counts, slstm_scan, ssm_scan,
)
from repro_torch.kernels.dos_matmul import matmul_ref
from repro_torch.kernels.dos_matmul import ops as dos_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.slstm import ops as slstm_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.accounting import Accounting, account, tree_bytes
from repro_torch.launch.mesh import MeshSpec
from repro_torch.parallel import collectives as C
from repro_torch.parallel.axes import ShardingRules
from repro_torch.parallel.plan import make_plan

MESH = MeshSpec((2, 4), ("data", "model"))
FAMILY_ARCHS = ("smollm-135m", "deepseek-moe-16b", "llama-3.2-vision-11b", "zamba2-2.7b",
                "xlstm-125m", "whisper-medium")  # dense, moe, vlm, hybrid, ssm, encdec
GLOO_BATCH, GLOO_SEQ = 4, 32
GLOO_CELLS = [(a, m) for a in FAMILY_ARCHS for m in ("train", "prefill", "decode")]
LOWERED = (("gemma3-1b", "train"), ("gemma3-1b", "decode"), ("deepseek-moe-16b", "train"))

_LOWER = """
    import json
    import jax
    from jax.sharding import AxisType
    from repro.configs import REGISTRY, reduced
    from repro.config import ShapeConfig
    from repro.models import build
    from repro.parallel.axes import ShardingRules, use_rules
    from repro.parallel.plan import make_plan
    from repro.launch.steps import make_train_step, make_serve_step
    from repro.optim import OptConfig
    from repro.analysis.roofline import parse_collectives
    from repro._jax_compat import unwrap_cost_analysis

    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, mode in CELLS:
        model = build(reduced(REGISTRY[arch]))
        rules = ShardingRules(mesh, strategy="dos", fsdp=mode == "train")
        plan = make_plan(model, ShapeConfig("t", 64, 4, mode), rules)
        step = make_train_step(model, OptConfig()) if mode == "train" else make_serve_step(model)
        with use_rules(rules), mesh:
            compiled = jax.jit(step, in_shardings=plan.in_shardings,
                               out_shardings=plan.out_shardings).lower(*plan.abstract).compile()
        coll = parse_collectives(compiled.as_text())
        out[f"{arch} {mode}"] = {
            "argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
            "flops": unwrap_cost_analysis(compiled.cost_analysis()).get("flops", 0.0),
            "wire_bytes": coll.wire_bytes, "counts": coll.counts}
    print("LOWERED " + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def spawned(request, tmp_path_factory):
    """The reference's lowering (a JAX subprocess of 8 fake devices) and the
    8-rank ``gloo`` job of ``GLOO_CELLS``, started with the module's first
    test and run beside the tests that do not read them; those that do
    come last in the module and wait for them (``runs``). Nothing starts
    where no selected test reads them."""
    mine = [item for item in request.session.items
            if item.module is request.module and "runs" in item.fixturenames]
    if not mine:
        yield None
        return
    work = tmp_path_factory.mktemp("dryrun8")
    (work / "inputs.pkl").write_bytes(pickle.dumps(
        {"dryrun": [(a, m, GLOO_BATCH, GLOO_SEQ) for a, m in GLOO_CELLS]}))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {"xla": pool.submit(run_multidevice, _LOWER.replace("CELLS", repr(LOWERED)), 8, 300),
               "gloo": pool.submit(run_ranks, "dryrun8", 8, work, timeout=300)}


@pytest.fixture(scope="module")
def runs(spawned):
    line = next(s for s in spawned["xla"].result().splitlines() if s.startswith("LOWERED "))
    return {"xla": json.loads(line[len("LOWERED "):]), "gloo": spawned["gloo"].result()}


def _meta_cell(cfg, mode, batch, seq, strategy="dos"):
    model = D.meta_model(cfg)
    shape = ShapeConfig("t", seq, batch, mode)
    rules = ShardingRules(MESH, strategy=strategy, fsdp=mode == "train")
    return model, shape, rules, D.account_step(model, shape, rules)


# --- the reference's pure functions -------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """The reference's dry-run module, imported without letting its
    module-level ``XLA_FLAGS`` (512 host devices) leak into this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_pure_functions_equal_the_references(ref, arch):
    from repro.configs import get_config as ref_config
    from repro.models import build as ref_build

    from repro.config import SHAPES as REF_SHAPES

    rcfg, cfg = ref_config(arch), get_config(arch)
    rmodel, model = ref_build(rcfg), D.meta_model(cfg)
    assert model.n_params == rmodel.n_params
    for name in SHAPES:
        assert D.model_flops_for(model, SHAPES[name]) == ref.model_flops_for(rmodel,
                                                                             REF_SHAPES[name])
        assert D.microbatch_policy(cfg, SHAPES[name]) == ref.microbatch_policy(rcfg,
                                                                               REF_SHAPES[name])
        for mesh in ("pod16x16", "pod2x16x16"):
            for strategy in ("dos", "megatron"):
                assert D.cell_key(arch, name, mesh, strategy) == ref.cell_key(arch, name, mesh,
                                                                              strategy)
    assert D.n_units(cfg) == ref.n_units(rcfg)
    for k in (1, 2):
        assert dataclasses.asdict(D.variant_cfg(cfg, k)) == dataclasses.asdict(
            ref.variant_cfg(rcfg, k))


def test_cells_equal_the_references(ref):
    from repro.configs import cells as ref_cells

    assert cells() == ref_cells()
    live, skipped = cells()
    assert len(live) == 33 and {a for a, _ in live} == set(REGISTRY)


def _both(fn, *shapes_dtypes, grad=False):
    """FLOPs of ``fn`` on CPU tensors (the plain version) and on meta
    tensors of the same shapes (the kernel's charge), under the dry-run's
    recorder; with ``grad``, forward and backward."""
    gen = torch.Generator().manual_seed(0)
    flops = []
    for device in ("cpu", "meta"):
        ins = [torch.randn(s, generator=gen).to(dt).to(device).requires_grad_(grad)
               for s, dt in shapes_dtypes]
        with Accounting() as acc:
            out = fn(*ins)
            if grad:
                outs = [o for o in (out if isinstance(out, tuple) else (out,))
                        if o.requires_grad]
                torch.autograd.grad(outs, [t for t in ins if t.requires_grad],
                                    [torch.ones_like(o) for o in outs], allow_unused=True)
        flops.append(acc.flops)
    return flops


@pytest.mark.parametrize("m,k,n", [(5, 7, 3), (2, 16, 24), (64, 32, 8)])
@pytest.mark.parametrize("grad", [False, True])
def test_dos_matmul_charge_equals_its_plain_flops(m, k, n, grad):
    cpu, meta = _both(lambda a, b: dos_matmul(a, b), ((2, m, k), torch.float32),
                      ((k, n), torch.float32), grad=grad)
    assert cpu == meta == 2 * 2 * m * k * n * (3 if grad else 1)


@pytest.mark.parametrize("sq,skv,h,kvh,causal,window", [
    (16, 16, 4, 2, True, None), (8, 24, 2, 1, False, None), (32, 32, 4, 4, True, 8)])
@pytest.mark.parametrize("grad", [False, True])
def test_flash_charges_equal_their_plain_flops(sq, skv, h, kvh, causal, window, grad):
    def fn(q, k, v):
        return flash_attention(q, k, v, causal=causal, window=window)

    cpu, meta = _both(fn, ((2, sq, h, 32), torch.float32), ((2, skv, kvh, 32), torch.float32),
                      ((2, skv, kvh, 32), torch.float32), grad=grad)
    assert cpu == meta == (14 if grad else 4) * 2 * h * sq * skv * 32


@pytest.mark.parametrize("s,h,p,n,shared", [(40, 2, 8, 16, True), (64, 3, 1, 16, False),
                                            (20, 2, 16, 32, False)])
@pytest.mark.parametrize("grad", [False, True])
def test_ssm_scan_charges_equal_their_plain_flops(s, h, p, n, shared, grad):
    nb = 1 if shared else h

    def fn(u, ld, B, C):
        return ssm_scan(u, -ld.abs(), B, C)

    cpu, meta = _both(fn, ((2, s, h, p), torch.float32), ((2, s, h), torch.float32),
                      ((2, s, nb, n), torch.float32), ((2, s, nb, n), torch.float32), grad=grad)
    want = ssm_ops.work(2, s, h, p, n, 4, shared).flops
    if grad:
        want += ssm_ops.bwd_work(2, s, h, p, n, 4, shared).flops
    assert cpu == meta == want


@pytest.mark.parametrize("s,h,d", [(5, 2, 16), (12, 4, 8)])
@pytest.mark.parametrize("grad", [False, True])
def test_slstm_charges_equal_their_plain_flops(s, h, d, grad):
    e = h * d
    cpu, meta = _both(lambda *a: slstm_scan(*a), ((2, s, e), torch.float32),
                      ((2, s, h), torch.float32), ((2, s, h), torch.float32),
                      ((2, s, e), torch.float32), ((h, d, d), torch.float32),
                      ((2, e), torch.float32), ((2, h), torch.float32), ((2, e), torch.float32),
                      grad=grad)
    want = slstm_ops.work(2, s, h, d).flops  # the backward adds slstm_dr's plain matmul
    assert cpu == meta and (grad or meta == want)


@pytest.mark.parametrize("rows,k,n,g", [(12, 8, 4, 3), (33, 16, 8, 5)])
@pytest.mark.parametrize("grad", [False, True])
def test_grouped_matmul_charges_equal_their_plain_flops(rows, k, n, g, grad):
    sizes = [rows // g] * (g - 1) + [rows - (g - 1) * (rows // g)]  # every row in a group
    gen = torch.Generator().manual_seed(0)
    flops = []
    for device in ("cpu", "meta"):
        x = torch.randn(rows, k, generator=gen).to(device).requires_grad_(grad)
        w = torch.randn(g, k, n, generator=gen).to(device).requires_grad_(grad)
        gs = torch.tensor(sizes, dtype=torch.int32).to(device)
        with Accounting() as acc:
            y = grouped_matmul(x, w, gs)
            if grad:
                torch.autograd.grad(y, [x, w], torch.ones_like(y))
        flops.append(acc.flops)
    assert flops[0] == flops[1] == 2 * rows * k * n * (3 if grad else 1)


# --- the unit combination, the production cells ---------------------------------------------


PRODUCTION = [("smollm-135m", "prefill_32k", False), ("qwen2.5-3b", "prefill_32k", False),
              ("deepseek-moe-16b", "decode_32k", False),
              ("llama-3.2-vision-11b", "decode_32k", False), ("zamba2-2.7b", "long_500k", False),
              ("xlstm-125m", "train_4k", False), ("whisper-medium", "decode_32k", False),
              ("gemma3-1b", "decode_32k", True)]


@pytest.fixture(scope="module")
def art_dir(tmp_path_factory):
    """One directory of production artifacts for the module: ``run_and_save``
    traces a cell once and reads it back after."""
    return tmp_path_factory.mktemp("dryrun_torch")


@pytest.mark.parametrize("arch", [a for a in FAMILY_ARCHS if a != "xlstm-125m"])
def test_unit_combination_equals_the_full_count(art_dir, arch):
    """At the family's production cell (its full count traced once, with
    ``test_production_cell_traces``). xlstm is exempt: its ``variant_cfg``
    drops the sLSTM blocks (the reference counts them as
    mLSTM-equivalent), so its units differ."""
    shape = next(s for a, s, multi_pod in PRODUCTION if a == arch and not multi_pod)
    cost, coll = D.measure_cost_corrected(arch, shape, multi_pod=False, strategy="dos",
                                          fsdp=True, remat=True)
    art = D.run_and_save(arch, shape, multi_pod=False, art_dir=art_dir, verbose=False)
    assert cost == art["cost"]
    assert coll.counts == art["collectives"]["counts"]
    assert coll.wire_bytes == art["collectives"]["wire_bytes"]


@pytest.mark.parametrize("arch,shape,multi_pod", PRODUCTION)
def test_production_cell_traces(art_dir, arch, shape, multi_pod):
    art = D.run_and_save(arch, shape, multi_pod=multi_pod, art_dir=art_dir, verbose=False)
    assert "error" not in art, art.get("traceback")
    assert art["memory"]["peak_per_device_gb"] > 0 and art["memory"]["temp_bytes"] > 0
    assert sum(n for by in art["launches"].values() for n in by.values()) > 0
    assert art["n_chips"] == (512 if multi_pod else 256) and art["compile_s"] == 0.0
    assert art["cost_corrected"] == art["cost"]
    assert (art_dir / (D.cell_key(arch, shape, art["mesh"], "dos") + ".json")).exists()


# --- the meta branch is for meta tensors only ---------------------------------------------------


def test_a_cpu_tensor_takes_the_plain_version():
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    before = launch_counts()
    with Accounting() as acc:
        out = dos_matmul(a, b)
    assert launch_counts() == before and acc.launches == {} and acc.kernels == {}
    assert torch.equal(out, matmul_ref(a, b))


def _counters():
    return {k: (fn.launches, dict(fn.variants)) for k, fn in KERNELS.items()}


def test_a_meta_tensor_is_planned_counted_and_charged():
    """Counted by the accounting, from its charges; the wrapper's own
    counters count launches on a card only."""
    a = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    b = torch.empty(32, 48, dtype=torch.bfloat16, device="meta")
    before = _counters()
    out, rec = account(dos_matmul, a, b)
    assert _counters() == before
    assert out.device.type == "meta" and out.shape == (64, 48)
    assert rec.launches == {"dos_matmul": {"wgmma": 1}}
    assert rec.kernels["dos_matmul"]["flops"] == 2 * 64 * 32 * 48
    # a base 2 bytes off 16 (a view at storage offset 1) plans as the card's would
    off = torch.empty(64 * 32 + 1, dtype=torch.bfloat16, device="meta")[1:].view(64, 32)
    assert account(dos_matmul, off, b)[1].launches == {"dos_matmul": {"general": 1}}


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-2.7b", "xlstm-125m"])
def test_a_meta_trace_leaves_the_launch_counters(arch):
    """A train step of each kernel's family, traced on meta, charges every
    kernel forward and backward and moves no wrapper's ``launches`` or
    ``variants``, which count what a card ran."""
    before = _counters()
    *_, rec = _meta_cell(reduced(get_config(arch)), "train", GLOO_BATCH, GLOO_SEQ)[-1]
    assert _counters() == before
    want = {"deepseek-moe-16b": {"grouped_matmul", "grouped_matmul_dw", "flash_attention_bwd"},
            "zamba2-2.7b": {"ssm_scan", "ssm_scan_bwd", "flash_attention"},
            "xlstm-125m": {"slstm_scan", "slstm_scan_bwd", "dos_matmul"}}[arch]
    assert want <= set(rec.launches)


def test_meta_plans_read_the_same_rules_as_the_cards():
    """Alignment and the backward's sizes for meta tensors: the storage
    offset stands for the address; the tables stand for the library's
    answers (``chip_smoke.py`` holds them to the library on the card)."""
    assert gmm_ops._rows16(torch.empty(4, 8, dtype=torch.bfloat16, device="meta"), 1, [0])
    odd = torch.empty(33, dtype=torch.bfloat16, device="meta")[1:].view(4, 8)
    assert not gmm_ops._rows16(odd, 1, [0])
    assert slstm_ops.part_floats(192) == 3 * (192 // 2 * 4 // 32)
    assert ssm_ops.MAX_GROUP == {(64, 96): 1}
    assert set(KERNELS) == {"dos_matmul", "flash_attention", "flash_attention_bwd", "ssm_scan",
                            "ssm_scan_bwd", "slstm_scan", "slstm_scan_bwd", "grouped_matmul",
                            "grouped_matmul_dw"}


def test_the_accounting_keeps_the_engines_in_place_sums():
    """Under a dispatch mode autograd sums two gradients of one input, and
    fills gather's backward zeros, out of place; without one (the card) in
    place. The accounting runs them in place where the card does: the
    live bytes peak at two gradients of 1 MiB, not three, and at gather's
    one zero-filled gradient, not two."""
    mib = 2**20
    x = torch.empty(mib // 4, device="meta", requires_grad=True)
    with Accounting() as acc:
        torch.autograd.grad((x * 2).sum() + (x * 3).sum(), [x])
    assert 2 * mib <= acc.peak < 2 * mib + 4096
    i = torch.zeros(mib // 8, dtype=torch.int64, device="meta")
    with Accounting() as acc:
        torch.autograd.grad(x.gather(0, i).sum(), [x])
    assert mib <= acc.peak < mib + 4096


def test_the_accounting_runs_every_op_as_called_on_the_cpu():
    """On CPU tensors the accounting books the card's in-place sums and
    changes no op: the gradients are those of a run without it, and the
    live bytes peak as on meta."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2**16, generator=gen, requires_grad=True)
    i = torch.randint(0, 2**16, (2**14,), generator=gen)

    def grads():
        y = x.exp()
        return torch.autograd.grad((y * 2).sum() + (y * 3).sum() + y.gather(0, i).sum(), [x])[0]

    want = grads()
    with Accounting() as acc:
        got = grads()
    assert torch.equal(got, want)
    xm, im = x.detach().to("meta").requires_grad_(), i.to("meta")
    with Accounting() as meta:
        y = xm.exp()
        torch.autograd.grad((y * 2).sum() + (y * 3).sum() + y.gather(0, im).sum(), [xm])
    assert acc.peak == meta.peak > 0


def test_a_collective_over_a_mesh_spec_runs_only_in_the_accounting():
    with pytest.raises(RuntimeError, match="no process group"):
        C.all_reduce(torch.ones(4), MESH, "model")
    with C.accounting(), pytest.raises(RuntimeError, match="no process group"):
        C.all_reduce(torch.ones(4), MESH, "model")  # a CPU tensor, even inside
    x = torch.empty(4, 8, dtype=torch.bfloat16, device="meta")
    with C.accounting(), C.recording() as log:
        y = C.all_gather(x, MESH, "model", dim=1)
        z = C.reduce_scatter(x, MESH, "model", dim=1)
        w = C.all_reduce(x, MESH, ("data", "model"))
    assert (y.shape, z.shape, w.shape) == ((4, 32), (4, 2), (4, 8))
    assert [tuple(c) for c in log] == [("all-gather", "bfloat16", (4, 8), 4),
                                       ("reduce-scatter", "bfloat16", (4, 8), 4),
                                       ("all-reduce", "bfloat16", (4, 8), 8)]
    assert [c.wire_bytes for c in log] == [3 * 64, 3 * 64 / 4, 2 * 7 / 8 * 64]


# --- one definition of each kernel's work ----------------------------------------------------------


def _bound_ms(work, dtype):
    peak = {torch.bfloat16: 989e12, torch.float32: 67e12}[dtype]
    return max(work.bytes / 3.35e12, work.ops / peak) * 1e3


def test_work_gives_the_bounds_perf_md_reports():
    """PERF.md §6's bound column (phases 4 and 12-15's shapes, bf16 but the
    sLSTM's f32), to its printed digits, from each wrapper's ``work``."""
    smol, zam = get_config("smollm-135m"), get_config("zamba2-2.7b")
    xl, moe = get_config("xlstm-125m"), get_config("deepseek-moe-16b")
    bf, f32 = torch.bfloat16, torch.float32
    heads = zam.ssm_expand * zam.d_model // zam.ssm_head_dim
    flash = (30 * _bound_ms(flash_ops.work(4, 128, 128, smol.n_heads, smol.n_kv_heads,
                                           smol.head_dim_, 2), bf)
             + 9 * _bound_ms(flash_ops.work(4, 128, 128, zam.n_heads, zam.n_kv_heads,
                                            zam.head_dim_, 2), bf))
    assert round(flash, 4) == 0.0423  # row 2: one prefill of smollm and zamba2
    assert round(54 * _bound_ms(ssm_ops.work(4, 128, heads, zam.ssm_head_dim, zam.ssm_state, 2,
                                             True), bf), 3) == 0.258  # row 3
    assert round(30 * _bound_ms(flash_ops.bwd_work(8, 512, 512, smol.n_heads, smol.n_kv_heads,
                                                   smol.head_dim_, 2), bf), 3) == 0.227  # row 4
    assert round(_bound_ms(ssm_ops.bwd_work(8, 512, heads, zam.ssm_head_dim, zam.ssm_state, 2,
                                            True), bf), 4) == 0.0891  # row 5, a call
    d = xl.d_model // xl.n_heads
    serve = 2 * (_bound_ms(slstm_ops.work(4, 128, xl.n_heads, d), f32)
                 + _bound_ms(slstm_ops.work(4, 1, xl.n_heads, d), f32))
    assert round(serve, 4) == 0.0050  # row 6
    assert round(_bound_ms(slstm_ops.work(8, 512, xl.n_heads, d, store=True), f32), 4) == 0.0190
    assert round(_bound_ms(slstm_ops.bwd_work(8, 512, xl.n_heads, d), f32), 4) == 0.0228  # row 7
    e, f, g = moe.d_model, moe.expert_d_ff, moe.n_experts
    for tokens, want in ((4 * 128, 0.1165), (8 * 512, 0.1609)):  # row 8: prefill, training
        rows = tokens * moe.top_k
        sizes = [rows // g] * g
        assert round(_bound_ms(gmm_ops.work(rows, e, f, sizes, 2), bf), 4) == want
    rows = 8 * 512 * moe.top_k
    assert round(_bound_ms(gmm_ops.dw_work(rows, e, f, [rows // g] * g, 2, 2), bf),
                 4) == 0.1609  # row 9
    w = dos_ops.work(512, 576, 1536, 2)
    assert (w.bytes, w.ops) == ((512 * 576 + 576 * 1536 + 512 * 1536) * 2, 2.0 * 512 * 576 * 1536)


# --- against the reference's lowering (last: they wait for ``spawned``) ----------------------


@pytest.mark.parametrize("arch,mode", LOWERED)
def test_argument_bytes_equal_the_references_lowering(runs, arch, mode):
    cfg = reduced(get_config(arch))
    _, _, _, (memory, cost, coll, _) = _meta_cell(cfg, mode, 4, 64)
    xla = runs["xla"][f"{arch} {mode}"]
    per_layer_length = 4 * cfg.n_layers if mode == "decode" else 0
    assert memory["argument_bytes"] + per_layer_length == xla["argument_bytes"]
    assert coll.wire_bytes > 0 and xla["wire_bytes"] > 0  # dOS puts partial sums on the wire
    print(f"[dryrun vs xla] {arch} {mode}: argument bytes {memory['argument_bytes']} "
          f"(xla {xla['argument_bytes']}); flops {cost['flops']:.0f} / xla {xla['flops']:.0f} "
          f"= {cost['flops'] / xla['flops']:.3f}; wire bytes {coll.wire_bytes:.0f} (xla "
          f"{xla['wire_bytes']:.0f}); collectives {coll.counts} (xla {xla['counts']})")


# --- against rank 0 of 8 gloo ranks ------------------------------------------------------------


@pytest.mark.parametrize("arch,mode", GLOO_CELLS)
def test_meta_accounting_equals_rank_0_of_eight_gloo_ranks(runs, arch, mode):
    """Remat recomputes each layer whole on both sides (the gloo job's
    docstring says why); phase 20 holds the early stop's collectives on
    the card."""
    cfg = reduced(get_config(arch))
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        model, shape, rules, (_, _, _, rec) = _meta_cell(cfg, mode, GLOO_BATCH, GLOO_SEQ)
    got = runs["gloo"][f"{arch} {mode}"]
    assert [list(c) for c in rec.collectives] == [
        [op, dt, tuple(shape_), n] for op, dt, shape_, n in got["collectives"]]
    assert rec.flops == got["flops"]
    inputs = D.step_inputs(model, shape, make_plan(model, shape, rules))
    assert tree_bytes(inputs[:-1]) == got["shard_bytes"]
    assert rec.launches and rec.peak_bytes > 0
