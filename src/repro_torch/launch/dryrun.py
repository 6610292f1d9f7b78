"""Multi-pod dry-run: meta-device accounting of every (arch x shape x mesh) cell.

The JAX package's dry-run lowers and compiles each cell's jitted step on
512 placeholder devices and reads XLA's memory and cost analyses and
the collectives of the compiled HLO. The port has no compiler to ask.
It traces each cell's step once, eagerly, as rank 0 of the production
mesh (``launch.mesh.make_production_mesh``: a ``MeshSpec`` of (16, 16)
or (2, 16, 16) ranks with no process group behind it), on the meta
device (``launch.accounting``): the layers run on rank 0's shards, the
kernel wrappers plan, count and charge their launches, and the
collectives record themselves. That is the proof that every family's
sharded step holds together at 256 and 512 ranks, with no card and no
process group. It records, per cell, what the reference records:

  - ``memory``: the arguments (rank 0's shards of ``make_plan``'s
    abstract inputs, as the reference's ``argument_size_in_bytes``
    counts them), the step's outputs and what it updates in place
    (params and AdamW moments in a train step, the cache in a decode
    step: the reference's ``donate_argnums``), and ``temp_bytes``: the
    peak of the bytes the step allocates, less its new outputs;
  - ``cost``: FLOPs and bytes accessed on rank 0;
  - ``collectives``: the counts, wire bytes and bytes by op of the
    collectives rank 0 issues;
  - ``roofline``: ``analysis.roofline`` on those, with the reference's
    TPU v5e constants (``hw``), since the meshes are the reference's pods;

and one thing XLA cannot give: ``launches``, by kernel and variant.
Eager tracing counts every layer and microbatch, so ``cost_corrected``
and ``collectives_corrected`` equal the full count; no 1-unit and
2-unit lowering is needed to form them (``measure_cost_corrected``
keeps that combination; the tests hold it equal to the full count).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes

Artifacts go to ``experiments/dryrun_torch/`` (the reference's go to
``experiments/dryrun/``), one JSON file per cell, with the reference's
keys. The dry-run needs no card: the meta device is asked for here and
by no other entry point.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from ..analysis.roofline import CollectiveStats, roofline_from_artifact
from ..analysis.traffic import traffic_bytes_per_device
from ..config import SHAPES
from ..configs import cells, get_config
from ..core.ppa import constants as HW
from ..models.decoder import decoder_defs
from ..models.encdec import encdec_defs
from ..models.params import leaves, map_tree, tree_size, unflatten
from ..models.zoo import Model
from ..optim import OptConfig
from ..parallel.axes import ShardingRules, use_rules
from ..parallel.collectives import shard_of
from ..parallel.plan import abstract_cache, make_plan, serve_cache_specs
from .accounting import account, collective_stats, tree_bytes
from .mesh import axis_sizes, make_production_mesh, mesh_size
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["ART_DIR", "model_flops_for", "microbatch_policy", "variant_cfg", "n_units",
           "meta_model", "step_inputs", "account_step", "lower_cell", "measure_cost_corrected",
           "cell_key", "run_and_save", "main"]

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
META = torch.device("meta")
HW_NOTE = {"model": "TPU v5e (the reference's pods)", "peak_flops_bf16": HW.TPU_PEAK_FLOPS_BF16,
           "hbm_bw": HW.TPU_HBM_BW, "ici_bw_per_link": HW.TPU_ICI_BW_PER_LINK}


def model_flops_for(model, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N = active
    params minus the embedding gather table, D = tokens processed."""
    cfg = model.cfg
    n = model.n_params
    if cfg.family == "moe":
        routed = tree_size({k: v for k, v in model.defs["layers"]["ffn"].items()
                            if k in ("wi_gate", "wi_up", "wo")})
        n -= routed * (1.0 - cfg.top_k / cfg.n_experts)
    n -= cfg.vocab * cfg.d_model  # embedding gather does no matmul flops
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def microbatch_policy(cfg, shape) -> int:
    """Gradient-accumulation factor for train cells: activation
    transients shrink by this factor so the biggest models fit HBM."""
    if shape.mode != "train":
        return 1
    n = cfg.n_params
    if n > 40e9:
        return 8
    if n > 5e9:
        return 4
    return 1


def variant_cfg(cfg, k: int):
    """A k-unit copy of the arch, the reference's unit of exact cost
    accounting (its ``cost_analysis`` counts loop bodies once). The port
    counts every layer eagerly, so ``measure_cost_corrected`` only checks
    that the unit combination agrees with the full count."""
    kw = dict(scan_layers=False, unroll_inner=True)
    fam = cfg.family
    if fam in ("dense", "moe"):
        kw["n_layers"] = k
    elif fam == "vlm":
        kw["n_layers"] = k * cfg.cross_every
    elif fam == "hybrid":
        kw["n_layers"] = k * cfg.attn_every
    elif fam == "ssm":
        kw["n_layers"] = k
        kw["slstm_at"] = ()  # sLSTM counted as mLSTM-equivalent (noted)
    elif fam == "encdec":
        kw["n_layers"] = k
        kw["n_enc_layers"] = k
    return dataclasses.replace(cfg, **kw)


def n_units(cfg) -> int:
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_every
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers  # dense/moe/ssm layers; encdec (enc, dec) pairs


def meta_model(cfg) -> Model:
    """The model of ``cfg`` on the meta device (``build`` takes ``cuda`` or
    ``cpu`` only)."""
    defs = encdec_defs(cfg) if cfg.family == "encdec" else decoder_defs(cfg)
    return Model(cfg=cfg, defs=defs, device=META)


def _shards(tree, specs, mesh):
    """Rank 0's shard of every tensor leaf of ``tree`` under ``specs``
    (other leaves as they are)."""
    spec_of = dict(leaves(specs))
    return unflatten((path, shard_of(t, spec_of[path], mesh) if isinstance(t, torch.Tensor)
                      else t) for path, t in leaves(tree))


def _argument_bytes(abstract, shardings, mesh) -> int:
    """Bytes of rank 0's shards of the plan's abstract inputs."""
    return sum(tree_bytes(_shards(tree, specs, mesh)) for tree, specs in zip(abstract, shardings))


def step_inputs(model, shape, plan):
    """The step's arguments as rank 0 holds them, on meta: its shards of
    the f32 masters and AdamW moments (train) or of the serving weights
    (``Model.compute_params`` of the masters: bf16 GEMM weights, f32 norm
    scales), the global batch, and for decode its shard of a cache of
    ``seq_len`` slots in the compute dtype (``serve_cache_specs``) whose
    last slot the step writes."""
    mesh = plan.rules.mesh
    cfg = model.cfg
    if shape.mode == "train":
        params, opt, batch = plan.abstract
        ps, oss, _ = plan.in_shardings
        return (_shards(params, ps, mesh), _shards(opt, oss, mesh), batch)
    master = map_tree(lambda d: torch.empty(d.shape, dtype=getattr(torch, cfg.param_dtype),
                                            device=META), model.defs)
    params = model.compute_params(_shards(master, plan.in_shardings[0], mesh))
    batch = plan.abstract[-1]
    if shape.mode == "prefill":
        return params, batch
    b, length = shape.global_batch, shape.seq_len
    ac = abstract_cache(cfg, b, length, getattr(torch, cfg.compute_dtype))
    cache = _shards(ac, serve_cache_specs(plan.rules, ac, b), mesh)
    kv = cfg.family != "ssm"  # the xLSTM's cache holds states only (decoder.placed_cache)
    cache.update(length=length - 1, batch=b, max_len=length if kv else 0)
    return params, cache, batch


def _aliased(inputs, outputs) -> int:
    """Bytes of the outputs that are inputs updated in place."""
    held = {t.untyped_storage()._cdata for t in tree_leaves(inputs) if isinstance(t, torch.Tensor)}
    return tree_bytes([t for t in tree_leaves(outputs)
                       if isinstance(t, torch.Tensor) and t.untyped_storage()._cdata in held])


def account_step(model, shape, rules, *, remat=True, microbatches: int = 1):
    """``(memory, cost, CollectiveStats, Record)`` of the step ``shape``
    implies (train, prefill or decode) for ``model`` (``meta_model``)
    under ``rules``, traced on meta as rank 0 of ``rules.mesh``."""
    plan = make_plan(model, shape, rules)
    if shape.mode == "train":
        step = make_train_step(model, OptConfig(), remat=remat, microbatches=microbatches)
    elif shape.mode == "prefill":
        step = make_prefill_step(model, max_len=shape.seq_len)
    else:
        step = make_serve_step(model)
    inputs = step_inputs(model, shape, plan)
    with use_rules(rules):
        out, rec = account(step, *inputs)
    args = _argument_bytes(plan.abstract, plan.in_shardings, plan.rules.mesh)
    alias = _aliased(inputs, out)
    temp = max(rec.peak_bytes - (rec.output_bytes - alias), 0)
    memory = {"argument_bytes": args, "output_bytes": rec.output_bytes, "temp_bytes": temp,
              "alias_bytes": alias,
              "peak_per_device_gb": round((args + temp + rec.output_bytes - alias) / 2**30, 3)}
    return memory, {"flops": rec.flops, "bytes accessed": rec.bytes}, \
        collective_stats(rec.collectives), rec


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False, strategy: str = "dos",
               fsdp: bool = True, remat=True, cfg_override=None,
               microbatches: int | None = None):
    """Trace one cell's step on the meta device as rank 0 of the production
    mesh; returns (artifact dict, ``accounting.Record``). Where the
    reference lowers and compiles, this traces eagerly, so ``lower_s`` is
    the host seconds of the trace and ``compile_s`` is 0: nothing is
    compiled. ``alias_bytes`` are the bytes the step updates in place, as
    the reference's ``donate_argnums`` alias them."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    n_chips = mesh_size(mesh)
    model = meta_model(cfg)
    rules = ShardingRules(mesh, strategy=strategy, fsdp=fsdp and shape.mode == "train")
    mb = microbatches if microbatches is not None else microbatch_policy(cfg, shape)
    memory, cost, coll, rec = account_step(model, shape, rules, remat=remat, microbatches=mb)
    rf = roofline_from_artifact(arch=arch, shape=shape_name, mesh_name=mesh_name,
                                n_chips=n_chips, cost=cost, coll=coll,
                                model_flops=model_flops_for(model, shape))
    artifact = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "strategy": strategy,
        "fsdp": bool(fsdp and shape.mode == "train"),
        "n_chips": n_chips,
        "mode": shape.mode,
        "microbatches": mb,
        "n_params": model.n_params,
        "lower_s": round(rec.seconds, 2),
        "compile_s": 0.0,
        "memory": memory,
        "cost": cost,
        "collectives": {"counts": coll.counts, "wire_bytes": coll.wire_bytes,
                        "by_op_bytes": coll.by_op_bytes},
        "roofline": rf.to_dict(),
        "launches": rec.launches,
        "kernel_charges": rec.kernels,
        "mesh_axes": axis_sizes(mesh),
        "device": "meta (rank 0 of the mesh; nothing computed)",
        "hw": HW_NOTE,
    }
    return artifact, rec


def measure_cost_corrected(arch, shape_name, *, multi_pod, strategy, fsdp, remat,
                           microbatches=None):
    """The reference's unit combination, total(metric) = cost(1) + (units -
    1) * (cost(2) - cost(1)), over the 1-unit and 2-unit variants
    (``variant_cfg``) at the arch's microbatching. Every unit of a family
    traces the same ops, so it equals the full count (but for xlstm, whose
    variants drop the sLSTM blocks)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mb = microbatches if microbatches is not None else microbatch_policy(cfg, shape)
    outs = []
    for k in (1, 2):
        art, rec = lower_cell(arch, shape_name, multi_pod=multi_pod, strategy=strategy,
                              fsdp=fsdp, remat=remat, cfg_override=variant_cfg(cfg, k),
                              microbatches=mb)
        outs.append((art["cost"], collective_stats(rec.collectives)))
    (c1, coll1), (c2, coll2) = outs
    units = n_units(cfg)

    def comb(a, b):
        return a + (units - 1) * (b - a)

    cost = {key: comb(c1.get(key, 0.0), c2.get(key, 0.0)) for key in ("flops", "bytes accessed")}
    ops = set(coll1.counts) | set(coll2.counts)
    coll = CollectiveStats(
        wire_bytes=comb(coll1.wire_bytes, coll2.wire_bytes), result_bytes=0.0,
        counts={op: int(comb(coll1.counts.get(op, 0), coll2.counts.get(op, 0))) for op in ops},
        by_op_bytes={op: comb(coll1.by_op_bytes.get(op, 0.0), coll2.by_op_bytes.get(op, 0.0))
                     for op in ops})
    return cost, coll


def cell_key(arch, shape, mesh_name, strategy):
    return f"{arch}__{shape}__{mesh_name}__{strategy}"


def run_and_save(arch, shape_name, *, multi_pod, strategy="dos", force=False, verbose=True,
                 art_dir=None, **kw):
    """One cell's artifact, from ``art_dir`` (default ``ART_DIR``) unless
    ``force``, else traced and written there; a failure is recorded with
    its error and traceback (a port fault to fix)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    art_dir = pathlib.Path(art_dir or ART_DIR)
    art_dir.mkdir(parents=True, exist_ok=True)
    out = art_dir / (cell_key(arch, shape_name, mesh_name, strategy) + ".json")
    if out.exists() and not force:
        if verbose:
            print(f"[skip] {out.name} (cached)")
        return json.loads(out.read_text())
    try:
        artifact, _ = lower_cell(arch, shape_name, multi_pod=multi_pod, strategy=strategy, **kw)
        # every layer is counted: the corrected figures are the full ones, and the
        # single-pod roofline takes the kernel-aware traffic, as the reference's does
        artifact["cost_corrected"] = dict(artifact["cost"])
        artifact["collectives_corrected"] = dict(artifact["collectives"])
        if not multi_pod:
            cfg = get_config(arch)
            shape = SHAPES[shape_name]
            model = meta_model(cfg)
            kbytes = traffic_bytes_per_device(cfg, shape, model.n_params,
                                              n_chips=artifact["n_chips"],
                                              microbatches=artifact["microbatches"])
            c = artifact["collectives"]
            coll = CollectiveStats(wire_bytes=c["wire_bytes"], result_bytes=0.0,
                                   counts=c["counts"], by_op_bytes=c["by_op_bytes"])
            rf = roofline_from_artifact(arch=arch, shape=shape_name, mesh_name=mesh_name,
                                        n_chips=artifact["n_chips"], cost=artifact["cost"],
                                        coll=coll, model_flops=model_flops_for(model, shape),
                                        kernel_bytes=kbytes)
            artifact["roofline"] = rf.to_dict()
    except Exception as e:  # record failures: they are port faults to fix
        artifact = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "strategy": strategy,
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]}
        out.write_text(json.dumps(artifact, indent=1))
        if verbose:
            print(f"[FAIL] {out.name}: {artifact['error']}")
        return artifact
    out.write_text(json.dumps(artifact, indent=1))
    if verbose:
        launches = sum(n for by in artifact["launches"].values() for n in by.values())
        print(f"[ok] {out.name}: mem/dev={artifact['memory']['peak_per_device_gb']}GB "
              f"flops/dev={artifact['cost']['flops']:.3e} "
              f"collectives={sum(artifact['collectives']['counts'].values())} "
              f"launches={launches} (trace {artifact['lower_s']}s)", flush=True)
    return artifact


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--strategy", default="dos", choices=["dos", "megatron", "zero", "auto"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default=None, choices=["save_gathered"],
                    help="'save_gathered' keeps the cast weights across the backward")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    live, skipped = cells()
    if args.list:
        for a, s in live:
            print(f"{a} {s}")
        for a, s, why in skipped:
            print(f"# SKIP {a} {s}: {why}")
        return

    todo = [(a, s) for a, s in live
            if (args.arch is None or a == args.arch) and (args.shape is None or s == args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    remat = (args.remat_policy or True) if not args.no_remat else False
    n_fail = 0
    t0 = time.perf_counter()
    for a, s in todo:
        for mp in meshes:
            art = run_and_save(a, s, multi_pod=mp, strategy=args.strategy,
                               fsdp=not args.no_fsdp, remat=remat, force=args.force)
            n_fail += 1 if "error" in art else 0
    print(f"traced in {time.perf_counter() - t0:.1f} s")
    print(f"done: {len(todo) * len(meshes)} cells, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
