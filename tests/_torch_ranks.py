"""Multi-rank jobs of the port on the CPU: one process per ``gloo`` rank.

    python tests/_torch_ranks.py JOB RANK WORLD WORKDIR

Each rank joins the process group through a file in WORKDIR (no port is
opened), runs ``JOBS[JOB]`` and leaves; rank 0 writes the job's results
to ``WORKDIR/JOB.json``. ``run_ranks`` starts the ranks together and
kills them all if one fails or the job outlives its timeout, so that a
hang fails one test. ``shared`` runs a test module's spawns once per
session, whichever pytest-xdist worker draws its tests. The inputs of the jobs that take any (the
reference's weights as numpy, the batches) come from the test in
``WORKDIR/inputs.pkl``. This module
imports torch, numpy and the port only; ``np_one_sync`` is the int8
sync's numpy transcription, which ``tools/mesh_nccl.py`` uses too.
"""

from __future__ import annotations

import fcntl
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def shared(tmp_path_factory, name: str, run):
    """``run(workdir)``'s result, made once per test session: under
    pytest-xdist the first worker to ask makes it under a file lock in the
    session's shared temporary folder, and the others read it there."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return run(tmp_path_factory.mktemp(name))
    root = tmp_path_factory.getbasetemp().parent
    done = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            (root / name).mkdir(exist_ok=True)
            done.write_bytes(pickle.dumps(run(root / name)))
    return pickle.loads(done.read_bytes())


def run_ranks(job: str, world: int, workdir, timeout: float = 300.0) -> dict:
    """Run ``job`` on ``world`` ranks; returns rank 0's results."""
    workdir = pathlib.Path(workdir)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(world), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        r = bad[0][0]
        raise AssertionError(f"{job}: ranks {bad} failed or timed out after {timeout} s; rank "
                             f"{r}'s output:\n{logs[r][-6000:]}")
    return json.loads((workdir / f"{job}.json").read_text())


# --- inside a rank -----------------------------------------------------------------


def _setup():
    import torch

    torch.set_num_threads(1)
    torch.manual_seed(0)


def _cfg(spec):
    import dataclasses

    from repro_torch.configs import get_config, reduced

    arch, over = spec
    return dataclasses.replace(reduced(get_config(arch)), **over)


def _max_rel(got, want) -> float:
    """The largest gap of two gradient trees, each leaf's over its max|want|."""
    from repro_torch.models.params import leaves

    worst = 0.0
    have = dict(leaves(got))
    for path, w in leaves(want):
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((have[path] - w).abs().max()) / scale)
    return worst


BATCH_KEYS = ("tokens", "labels", "image_embeds", "enc_frames")


def _routes():
    """``(restore, calls)``: ``models.moe.route`` made to record each call's
    top-k indices and layout until ``restore()``."""
    from repro_torch.models import moe

    route, calls = moe.route, []

    def recording(p, xt, k, *lay):
        top_p, top_i = route(p, xt, k, *lay)
        calls.append((top_i.detach().clone(), lay[0] if lay else None))
        return top_p, top_i

    moe.route = recording

    def restore():
        moe.route = route

    return restore, calls


def _routes_differ(calls, one, n_layers) -> int:
    """Routes of this rank's rows (its forward's first ``n_layers`` calls)
    that differ from one device's, summed over every rank."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import collectives as C

    bad = 0
    for (top_i, lay), (want, _) in zip(calls[:n_layers], one[:n_layers]):
        rows = top_i.shape[0]
        lo = C.axis_index(lay.mesh, lay.batch) * rows
        bad += int((top_i != want[lo:lo + rows]).any(dim=-1).sum())
    total = torch.tensor([bad])
    dist.all_reduce(total)
    return int(total)


def job_loss(rank, world, workdir, inputs, key="loss"):
    """Loss and gathered gradients of every config, mesh and strategy in
    ``inputs[key]`` against the port's single-device ones (a case's
    ``image_embeds`` or ``enc_frames`` go into its batch); an MoE case's
    routes of every rank's rows against one device's. Rank 0, whose
    results are read, runs the single device; the other ranks get its
    routes by broadcast."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build
    from repro_torch.models.convert import from_numpy
    from repro_torch.parallel.axes import ShardingRules, param_sharding, use_rules
    from repro_torch.parallel.plan import gather_tree, shard_tree

    out = {}
    for case in inputs[key]:
        cfg = _cfg(case["cfg"])
        model = build(cfg, device="cpu")
        full = from_numpy(model, case["params"])
        batch = {k: torch.from_numpy(case[k]) for k in BATCH_KEYS if k in case}
        one = [None]
        if rank == 0:
            restore, one[0] = _routes()
            try:
                loss1, g1 = loss_and_grads(model, full, batch, remat=False)
            finally:
                restore()
            out[f"{cfg.name} single"] = float(loss1)
        dist.broadcast_object_list(one, src=0)
        one = one[0]
        for d, m in case["meshes"]:
            mesh = make_test_mesh(d, m)
            for strategy in case["strategies"]:
                rules = ShardingRules(mesh, strategy=strategy, fsdp=True)
                specs = param_sharding(model.defs, rules)
                restore, calls = _routes()
                try:
                    with use_rules(rules):
                        loss, g = loss_and_grads(model, shard_tree(full, specs, mesh), batch,
                                                 remat=strategy == "zero")
                finally:
                    restore()
                g = gather_tree(g, specs, mesh)
                out[f"{cfg.name} ({d}, {m}) {strategy}"] = {
                    "loss": float(loss), "grad_gap": _max_rel(g, g1) if rank == 0 else None,
                    "routes_differ": _routes_differ(calls, one, cfg.n_layers) if one else None}
    return out


def job_train8(rank, world, workdir, inputs):
    """``train_loop`` at (4, 2), saving its state after 2 steps."""
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import OptConfig

    t = inputs["train"]
    _, losses, _ = train_loop(_cfg(t["cfg"]), steps=2, global_batch=t["batch"],
                              seq_len=t["seq"], strategy="dos", mesh_shape=(4, 2),
                              ckpt_dir=str(workdir / "ckpt"), ckpt_every=100, log_every=0,
                              opt_cfg=OptConfig(**t["opt"]), device="cpu")
    return {"losses": losses}


def job_mesh4(rank, world, workdir, inputs):
    """Serving at every mesh and strategy of ``inputs["serve"]``; training
    at (2, 2); the (4, 2) checkpoint restored onto (2, 2)."""
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import OptConfig

    out = {"serve": {}}
    for case in inputs["serve"]:
        cfg = _cfg(case["cfg"])
        for d, m in case["meshes"]:
            for strategy in case["strategies"]:
                r = serve_loop(cfg, batch=case["batch"], prompt_len=case["prompt"],
                               gen_tokens=case["gen"], strategy=strategy, mesh_shape=(d, m),
                               device="cpu")
                out["serve"][f"{case['name']} ({d}, {m}) {strategy}"] = \
                    r["generated"].tolist()
    t = inputs["train"]
    kw = dict(global_batch=t["batch"], seq_len=t["seq"], mesh_shape=(2, 2), log_every=0,
              opt_cfg=OptConfig(**t["opt"]), device="cpu")
    out["train"] = {s: train_loop(_cfg(t["cfg"]), steps=3, strategy=s, **kw)[1]
                    for s in t["strategies"]}
    out["resumed"] = train_loop(_cfg(t["cfg"]), steps=4, strategy="dos",
                                ckpt_dir=str(workdir / "ckpt"), ckpt_every=100, **kw)[1]
    out["families"] = {  # the two families that raised on a mesh before they were sharded
        "zamba2-2.7b": serve_loop(_cfg(("zamba2-2.7b", {})), **OTHER_SERVE, mesh_shape=(1, 4),
                                  device="cpu")["generated"].tolist(),
        "xlstm-125m": train_loop(_cfg(("xlstm-125m", {})), **OTHER_TRAIN, mesh_shape=(2, 2),
                                 device="cpu")[1],
    }
    return out


# the other families' runs of ``job_mesh4``, ``job_serve2`` and ``job_train2``
# (the tests make one rank's with the same arguments)
OTHER_SERVE = {"batch": 4, "prompt_len": 8, "gen_tokens": 4}
OTHER_TRAIN = {"steps": 2, "global_batch": 4, "seq_len": 16, "log_every": 0}


def job_serve2(rank, world, workdir, inputs):
    """``serve_loop``'s defaults at (2, 1); a hybrid model at (1, 2)."""
    from repro_torch.launch.serve import serve_loop

    tokens = serve_loop(_cfg(("smollm-135m", {})), mesh_shape=(2, 1), device="cpu")
    return {"tokens": tokens["generated"].tolist(),
            "hybrid": serve_loop(_cfg(("zamba2-2.7b", {})), **OTHER_SERVE, mesh_shape=(1, 2),
                                 device="cpu")["generated"].tolist()}


def job_train2(rank, world, workdir, inputs):
    """``train_loop`` at (2, 1); an xLSTM model at (1, 2)."""
    from repro_torch.launch.train import train_loop

    kw = dict(steps=2, global_batch=4, seq_len=32, log_every=0, device="cpu")
    return {"losses": train_loop(_cfg(("smollm-135m", {})), mesh_shape=(2, 1), **kw)[1],
            "xlstm": train_loop(_cfg(("xlstm-125m", {})), **OTHER_TRAIN, mesh_shape=(1, 2),
                                device="cpu")[1]}


def _local_shape(shape, spec, mesh) -> list:
    from repro_torch.parallel import collectives as C

    return [d // C.axis_size(mesh, part) for d, part in zip(shape, spec)]


def _served_with_cache_gaps(cfg, case, mesh_shape, strategy):
    """``serve_loop``'s greedy tokens of ``case`` on ``mesh_shape`` under
    ``strategy``, and each cache leaf whose shape on this rank differs from
    its shard under ``plan.serve_cache_specs``, after the run's prefill and
    after its first decode step."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.params import leaves
    from repro_torch.models.zoo import Model
    from repro_torch.parallel.axes import ShardingRules
    from repro_torch.parallel.plan import abstract_cache, serve_cache_specs

    b, max_len = case["batch"], case["prompt"] + case["gen"]
    rules = ShardingRules(make_test_mesh(*mesh_shape), strategy=strategy, fsdp=False)
    full = dict(leaves(abstract_cache(cfg, b, max_len)))
    specs = dict(leaves(serve_cache_specs(rules, abstract_cache(cfg, b, max_len), b)))
    gaps, seen = [], set()

    def check(cache, when):
        if when in seen:
            return
        seen.add(when)
        for path, t in leaves(cache):
            if path in full and isinstance(t, torch.Tensor):
                want = _local_shape(full[path].shape, specs[path], rules.mesh)
                if list(t.shape) != want:
                    gaps.append(f"{when} {'.'.join(map(str, path))}: {list(t.shape)}, spec "
                                f"{specs[path]} gives {want}")

    prefill, decode = Model.prefill, Model.decode

    def checked_prefill(self, params, batch, **kw):
        logits, cache = prefill(self, params, batch, **kw)
        check(cache, "prefill")
        return logits, cache

    def checked_decode(self, params, cache, batch):
        logits, cache = decode(self, params, cache, batch)
        check(cache, "decode")
        return logits, cache

    Model.prefill, Model.decode = checked_prefill, checked_decode
    try:
        tokens = serve_loop(cfg, batch=b, prompt_len=case["prompt"], gen_tokens=case["gen"],
                            strategy=strategy, mesh_shape=mesh_shape,
                            device="cpu")["generated"].tolist()
    finally:
        Model.prefill, Model.decode = prefill, decode
    if seen != {"prefill", "decode"}:
        gaps.append(f"the run made no {sorted({'prefill', 'decode'} - seen)}")
    return tokens, gaps


def job_families4(rank, world, workdir, inputs):
    """Every family of ``inputs["families_serve"]`` served at each (mesh,
    strategy) it lists (greedy tokens, and the cache's shards after a
    prefill and a decode step); ``train_loop`` for each config of
    ``inputs["families_train_loop"]``, ``make_train_step`` for each of
    ``inputs["families_train_step"]`` (their batches given), all at (2, 2)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import OptConfig

    out = {"serve": {}, "cache": {}, "train": {}}
    for case in inputs["families_serve"]:
        cfg = _cfg(case["cfg"])
        for d, m, strategy in case["runs"]:
            key = f"{case['name']} ({d}, {m}) {strategy}"
            out["serve"][key], out["cache"][key] = _served_with_cache_gaps(cfg, case, (d, m),
                                                                           strategy)
    for t in inputs["families_train_loop"]:
        out["train"][t["name"]] = train_loop(
            _cfg(t["cfg"]), steps=t["steps"], global_batch=t["batch"], seq_len=t["seq"],
            strategy=t["strategy"], mesh_shape=(2, 2), log_every=0,
            opt_cfg=OptConfig(**t["opt"]), device="cpu")[1]
    for t in inputs["families_train_step"]:
        out["train"][t["name"]] = train_steps(_cfg(t["cfg"]), t, make_test_mesh(2, 2))
    return out


def train_steps(cfg, t, mesh=None) -> list:
    """The losses of ``make_train_step`` over ``t["batches"]`` (numpy), from
    the weights ``init`` draws from seed 0: on one device, or on ``mesh``
    under ``t["strategy"]`` with each rank's shards."""
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.parallel.axes import ShardingRules, param_sharding, use_rules
    from repro_torch.parallel.plan import shard_place

    model = build(cfg, device="cpu")
    rules = None if mesh is None else ShardingRules(mesh, strategy=t["strategy"], fsdp=True)
    place = None if rules is None else shard_place(param_sharding(model.defs, rules), mesh)
    params = model.init(torch.Generator().manual_seed(0), place=place)
    opt = init_opt_state(params)
    step = make_train_step(model, OptConfig(**t["opt"]), remat=True)
    losses = []
    for b in t["batches"]:
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        with use_rules(rules):
            params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return losses


def job_families8(rank, world, workdir, inputs):
    return job_loss(rank, world, workdir, inputs, key="families_loss")


def job_mesh8(rank, world, workdir, inputs):
    return {"loss": job_loss(rank, world, workdir, inputs),
            "train8": job_train8(rank, world, workdir, inputs)}


def _gaps(got, want) -> dict:
    """Each leaf's largest gap over its max|want| (``want`` numpy leaves)."""
    import torch

    from repro_torch.models.params import leaves

    have = dict(leaves(got))
    out = {}
    for path, w in leaves(want):
        w = torch.from_numpy(w)
        out[".".join(map(str, path))] = float((have[path] - w).abs().max()) / (
            float(w.abs().max()) or 1.0)
    return out


def job_pipeline(rank, world, workdir, inputs):
    """``make_gpipe_loss`` on ``world`` stages (one rank each): every
    rank's loss, and the whole model's gradients (the stages' layers
    gathered) against the reference's ``jax.grad(model.loss)``."""
    import torch

    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.models import build
    from repro_torch.models.convert import from_numpy
    from repro_torch.models.params import map_tree
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.pipeline import make_gpipe_loss, stage_params

    t = inputs["pipeline"]
    cfg = _cfg(t["cfg"])
    model = build(cfg, device="cpu")
    mesh = make_stage_mesh(world)
    params = stage_params(from_numpy(model, t["params"]), cfg, mesh, n_stages=world)
    params = map_tree(lambda a: a.detach().clone().requires_grad_(), params)
    batch = {k: torch.from_numpy(t[k]) for k in ("tokens", "labels")}
    loss = make_gpipe_loss(cfg, mesh, n_stages=world, n_microbatches=t["n_mb"])(params, batch)
    loss.backward()
    grads = map_tree(lambda a: a.grad, params)  # the stages' layers gathered, in stage order
    grads["layers"] = map_tree(lambda a: C.gather(a, mesh, "pod", 0), grads["layers"])
    losses = C.gather(loss.detach().reshape(1), mesh, "pod", 0)
    return {"losses": losses.tolist(), "grad_gaps": _gaps(grads, t["grads"])}


def job_moe_ep(rank, world, workdir, inputs):
    """``moe_block_ep`` on the (data, model) mesh the test gives: the output
    rows gathered, the routing indices ``moe_block_ep`` itself routed
    every rank's rows with, and the gradients of ``sum(y * gy)`` (each
    rank's rows' share, summed over ``data``; the experts gathered over
    ``model``) against the reference's."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import leaves, map_tree, unflatten
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import moe_ep

    t = inputs["moe_ep"]
    cfg = _cfg(t["cfg"])
    mesh = make_test_mesh(*t["mesh"])
    full = map_tree(lambda a: torch.from_numpy(a.copy()), t["params"])
    p = map_tree(lambda a: a.requires_grad_(), moe_ep.expert_shard(full, mesh))
    x = torch.from_numpy(t["x"]).requires_grad_()
    route, routed = moe_ep.route, []

    def recording(*args):  # the indices moe_block_ep routes its rows with
        top_p, top_i = route(*args)
        routed.append(top_i.detach())
        return top_p, top_i

    moe_ep.route = recording
    try:
        y = moe_ep.moe_block_ep(p, x, cfg, mesh)
    finally:
        moe_ep.route = route
    gy = C.local_slice(torch.from_numpy(t["gy"]), mesh, "data", 0)
    (y * gy).sum().backward()
    (top_i,) = routed
    top_i = C.gather(top_i, mesh, "data", 0)

    def whole(path, g):
        g = C.psum(g, mesh, "data")
        return C.gather(g, mesh, "model", 0) if path in (("wi_gate",), ("wi_up",), ("wo",)) else g

    grads = unflatten((path, whole(path, a.grad)) for path, a in leaves(p))
    grads["x"] = C.psum(x.grad, mesh, "data")
    return {"y": C.gather(y.detach(), mesh, "data", 0).tolist(),
            "top_i_equal": bool(torch.equal(top_i, torch.from_numpy(t["top_i"]).long())),
            "grad_gaps": _gaps(grads, t["grads"])}


def np_one_sync(g, err):
    """The reference's ``one_sync`` (``compressed_psum_grads`` on one
    leaf) for every rank at once, in numpy: g and err (ranks, ...) f32 ->
    q, g_hat, new_err. The scale and the residual are rounded once, as
    XLA's fused multiply-adds round them; the scales are summed in rank
    order."""
    import numpy as np

    f32, world = np.float32, g.shape[0]
    g = (g + err).astype(f32)
    flat = np.abs(g).reshape(world, -1).max(axis=1).astype(np.float64)
    scale = (flat * np.float64(f32(1) / f32(127)) + np.float64(f32(1e-12))).astype(f32)
    scale = scale.reshape(world, *([1] * (g.ndim - 1)))
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    qsum = q.astype(np.int32).sum(axis=0).astype(f32)
    ssum = f32(0)
    for s in scale.reshape(-1):
        ssum = f32(ssum + s)
    n = f32(world)
    g_hat = (qsum * f32(ssum / n) / n).astype(f32)
    new_err = (g.astype(np.float64) - q.astype(np.float64) * scale.astype(np.float64)).astype(f32)
    return q, g_hat, new_err


def job_compress(rank, world, workdir, inputs):
    """``compressed_psum_grads`` at (8, 1): identical gradients on every
    rank (two steps), and each rank's own gradients (two steps); each
    step's ``q``, ``g_hat`` and ``new_err`` of every rank, gathered."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.compression import (
        compressed_psum_grads, init_error_state, quantize,
    )

    mesh = make_test_mesh(world, 1)
    out = {}
    for case, steps in inputs["compress"].items():
        err = None
        out[case] = []
        for g in steps:  # each leaf (world, ...): rank r's gradient is [r]
            g = map_tree(lambda a: torch.from_numpy(a[rank].copy()), g)
            err = init_error_state(g) if err is None else err
            q = {path: quantize(a.float() + e)[0] for (path, a), (_, e) in
                 zip(leaves(g), leaves(err))}
            g_hat, err = compressed_psum_grads(g, err, mesh)
            step = {}
            for path, gh in leaves(g_hat):
                ne = dict(leaves(err))[path]
                key = ".".join(path)
                step[key] = {n: C.gather(v[None], mesh, "data", 0).tolist()
                             for n, v in (("q", q[path].int()), ("g_hat", gh), ("new_err", ne))}
            out[case].append(step)
    return out


def dryrun_cell(cfg, mode, batch, seq, mesh, strategy="dos", gen=None):
    """``(step, inputs)`` of one dry-run cell on CPU tensors, as rank 0 holds
    them on ``mesh``: the train step (remat, AdamW) on this rank's f32 shards
    and their moments; a prefill of ``seq`` tokens; or a decode step after
    a prefill of ``seq - 1`` tokens into a cache of ``seq`` slots (the
    dry-run's decode cell). Random weights and batch from ``gen``."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.models import build
    from repro_torch.models.zoo import MODEL_INPUTS
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.parallel.axes import ShardingRules, param_sharding, use_rules
    from repro_torch.parallel.plan import shard_place

    gen = gen or torch.Generator().manual_seed(0)
    model = build(cfg, device="cpu")
    rules = ShardingRules(mesh, strategy=strategy, fsdp=mode == "train")
    master = model.init(gen, place=shard_place(param_sharding(model.defs, rules), mesh))

    def tokens(n):
        return torch.randint(0, cfg.vocab, (batch, n), generator=gen, dtype=torch.int32)

    extra = {}
    if cfg.family in MODEL_INPUTS and mode != "decode":
        name, length = MODEL_INPUTS[cfg.family]
        extra[name] = torch.randn(batch, getattr(cfg, length), cfg.d_model, generator=gen)
    if mode == "train":
        step = make_train_step(model, OptConfig(), remat=True)
        return step, (master, init_opt_state(master), {"tokens": tokens(seq),
                                                       "labels": tokens(seq), **extra})
    params = model.compute_params(master)
    if mode == "prefill":
        return make_prefill_step(model, max_len=seq), (params, {"tokens": tokens(seq), **extra})
    if cfg.family in MODEL_INPUTS:  # the prompt's image embeddings or frames
        name, length = MODEL_INPUTS[cfg.family]
        extra[name] = torch.randn(batch, getattr(cfg, length), cfg.d_model, generator=gen)
    with use_rules(rules):
        _, cache = model.prefill(params, {"tokens": tokens(seq - 1), **extra}, max_len=seq)
    return make_serve_step(model), (params, cache, {"token": tokens(1)})


def job_dryrun8(rank, world, workdir, inputs):
    """Each cell of ``inputs["dryrun"]`` ((arch, mode, batch, seq) at (2, 4)
    under dos) run once on this rank's shards: rank 0's collectives in
    order (``collectives.recording``), the FLOPs the dry-run's recorder
    counts on the plain versions and the bytes of the step's inputs but
    the batch (its shards: params, moments, cache). Remat recomputes each
    layer whole (``checkpoint``'s early stop off, as the test's meta side
    runs it too): a kernel's autograd Function (on the card, and on meta)
    runs a layer's last product in the recompute before the early stop
    can skip it, where a plain GEMM, which saves its inputs before it
    runs, is skipped on the CPU."""
    import torch

    from repro_torch.launch.accounting import Accounting, tree_bytes
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.axes import ShardingRules, use_rules

    mesh = make_test_mesh(2, 4)
    out = {}
    for arch, mode, batch, seq in inputs["dryrun"]:
        cfg = _cfg((arch, {}))
        step, args = dryrun_cell(cfg, mode, batch, seq, mesh)
        rules = ShardingRules(mesh, strategy="dos", fsdp=mode == "train")
        with use_rules(rules), C.recording() as log, Accounting() as acc, \
                torch.utils.checkpoint.set_checkpoint_early_stop(False):
            step(*args)
        out[f"{arch} {mode}"] = {"collectives": [list(c) for c in log], "flops": acc.flops,
                                 "shard_bytes": tree_bytes(args[:-1])}
        del step, args
        torch.manual_seed(0)
    return out


JOBS = {"dryrun8": job_dryrun8, "mesh8": job_mesh8, "mesh4": job_mesh4, "serve2": job_serve2, "train2": job_train2,
        "families8": job_families8, "families4": job_families4,
        "pipeline4": job_pipeline, "pipeline2": job_pipeline, "moe_ep": job_moe_ep,
        "compress": job_compress}


def main(job, rank, world, workdir):
    _setup()
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.launch.mesh import init_distributed

    workdir = pathlib.Path(workdir)
    init_distributed("cpu", init_method=f"file://{workdir / f'pg_{job}'}", rank=rank,
                     world_size=world)
    import torch.distributed as dist

    given = workdir / "inputs.pkl"
    inputs = pickle.loads(given.read_bytes()) if given.exists() else {}
    out = JOBS[job](rank, world, workdir, inputs)
    if rank == 0:
        (workdir / f"{job}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
