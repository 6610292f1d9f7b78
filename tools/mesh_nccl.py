#!/usr/bin/env python3
"""Serve and train the zoo's families over a (data, model) mesh of cards.

    python3 tools/mesh_nccl.py [--json PATH] [--world 4] [--only mesh|parallel|families]
                               [--families ARCH,...]

Needs ``--world`` CUDA cards on one host (4 by default). Builds the
kernels once, then starts one process per card, each given ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` (localhost) and a free
``MASTER_PORT``, as ``torchrun`` gives them. Each rank first serves and
trains on its card alone (no process group): those are the one-card
tokens and losses. Then the ranks join one NCCL group and run, through
the entry points a user calls:

- ``serve_loop`` for smollm-135m at full size (batch 4, prompt 128, 32
  greedy tokens, bf16) at (2, 2), (1, 4) and (4, 1) (world 4) under
  ``dos``, ``megatron``, ``zero`` and ``auto``: the tokens against the
  one-card tokens (a bf16 projection's partial sums meet in another
  order on a mesh, so a near tie may pick another token: the count of
  equal tokens is reported beside the first that differs), the prefill
  time, the decode step's p50 and the launches of the ranks' kernels;
- the same in f32 (``compute_dtype="float32"``) under ``dos`` and
  ``megatron`` at (1, 4), whose tokens must equal the one card's;
- ``train_loop`` for smollm-135m at 8 x 512 for 3 steps at (2, 2) under
  ``dos``, ``megatron`` and ``zero``: the losses against the one card's
  (f32 masters, bf16 GEMMs), reported as the largest gap.

Then, in the same group (``--only parallel`` runs these alone):

- ``make_gpipe_loss`` on qwen2.5-3b whole (36 layers) over ``world``
  stages, 8 x 512 in 4 microbatches, bf16 and f32 compute on f32
  masters, remat: the loss against one card's non-pipelined
  ``model.loss`` on the same weights (f32 within 1e-5 relative, bf16
  within 3e-2), the pipelined loss + backward's step time beside one
  card's ``model.loss`` + backward, and the bubble fraction;
- ``moe_block_ep`` on one deepseek-moe-16b layer at full width at
  (1, ``world``) (a 4 x 128 prefill and a 4 x 1 decode step): the output
  against one card's ``moe_block`` (bf16 band), each call's time beside
  one card's, and the all-reduce of the rows' outputs alone (the EP
  wire cost);
- ``compressed_psum_grads`` at (``world``, 1) over smollm-135m's
  gradients, each rank's from its own 2 x 512 rows: rank 0 gathers every
  rank's gradients and holds ``g_hat`` and each rank's ``new_err``
  against the numpy transcription of the reference's ``one_sync``
  (``tests/_torch_ranks.py::np_one_sync``): ``new_err`` exact, ``g_hat``
  within 4 eps relative (NCCL sums the scales in its own order); ms per
  sync beside one rank's.

The CPU check of these three paths is their ``gloo`` tests
(``tests/test_torch_{pipeline,moe_ep,compression}.py``).

``--only families`` runs the other families instead, each at full width
cut in depth as ``chip_smoke.py``'s phase 19 cuts it (one
deepseek-moe-16b layer, one zamba2-2.7b group, one xlstm-125m mLSTM and
one sLSTM block, one llama-3.2-vision-11b group, one whisper-medium
encoder and decoder layer; ``--families`` names some of them):
``serve_loop`` (batch 4, prompt 128, 8 greedy
tokens) at (2, 2) and (1, ``world``) under ``dos`` in bf16, and at (1,
``world``) in f32, whose tokens must equal one card's; ``train_loop`` for
the MoE, hybrid and xLSTM models at (2, ``world`` / 2) under ``dos`` for 3
steps of 8 x 512, the losses against one card's; and xlstm-125m served
again at both meshes with each decode step's state moves (the cache's
placement to the blocks' heads and back, ``decoder._to_block`` and
``_to_cache``) timed by host clock between synchronizes. The CPU check of every
family on a mesh is ``tests/test_torch_sharding_families.py``. Rank 0 prints
one line per run and the ``nvidia-smi`` line, and writes everything to
``--json``. Every rank process is killed if one fails or the run
outlives ``--timeout`` seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "smollm-135m"
BATCH, PROMPT, GEN = 4, 128, 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 3
STRATEGIES = ("dos", "megatron", "zero", "auto")
TRAIN_STRATEGIES = ("dos", "megatron", "zero")


def meshes(world: int):
    out = [(1, world), (world, 1)]
    if world == 4:
        out.insert(0, (2, 2))
    return out


def rank_main(out_path: str, only: str, families: tuple) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    rank = int(os.environ["RANK"])
    out = {}
    try:
        if only == "families":
            out.update(families_cases(rank, families))
        elif only != "parallel":  # its one-card runs first, then it joins the group
            out.update(mesh_cases(rank))
        else:
            init_distributed("cuda")
        if only in (None, "parallel"):
            out["parallel"] = parallel_cases(rank)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    bad = [k for k, v in out.get("parallel", {}).items() if not v.get("ok", True)]
    if not out.get("ok", True) or bad:
        raise SystemExit(f"failed: {'f32 mesh tokens ' if not out.get('ok', True) else ''}{bad}")


def _log(text):
    if int(os.environ["RANK"]) == 0:
        print(text, flush=True)


def mesh_cases(rank) -> dict:
    """The (data, model) mesh's serving and training against one card;
    leaves this rank in the process group it joins."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import OptConfig

    world = int(os.environ["WORLD_SIZE"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    cfgs = {"bfloat16": get_config(ARCH),
            "float32": dataclasses.replace(get_config(ARCH), compute_dtype="float32")}
    opt = OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS)

    def serve(dtype, mesh_shape=(1, 1), strategy="dos"):
        return serve_loop(cfgs[dtype], batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN,
                          strategy=strategy, mesh_shape=mesh_shape, device=dev)

    def train(mesh_shape=(1, 1), strategy="dos"):
        return train_loop(get_config(ARCH), steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                          seq_len=TRAIN_SEQ, seed=0, log_every=0, strategy=strategy,
                          mesh_shape=mesh_shape, opt_cfg=opt, device=dev)[1]

    solo = {dtype: serve(dtype) for dtype in cfgs}
    solo_losses = train()
    out = {"one_card": {dtype: {"step_p50_s": r["step_p50_s"], "prefill_s": r["prefill_s"]}
                        for dtype, r in solo.items()},
           "one_card_losses": solo_losses, "serve": [], "train": []}

    log = _log
    log(f"[one card] serve bf16 step p50 {solo['bfloat16']['step_p50_s']*1e3:.3f} ms, f32 "
        f"{solo['float32']['step_p50_s']*1e3:.3f} ms; train losses {solo_losses}")
    init_distributed("cuda")
    ok = True
    runs = [("bfloat16", m, s) for m in meshes(world) for s in STRATEGIES]
    runs += [("float32", (1, world), s) for s in ("dos", "megatron")]
    for dtype, mesh_shape, strategy in runs:
        t0 = time.perf_counter()
        r = serve(dtype, mesh_shape, strategy)
        got, want = r["generated"].cpu(), solo[dtype]["generated"].cpu()
        eq = got == want
        first = None if bool(eq.all()) else int((~eq).any(dim=0).nonzero()[0])
        row = {"dtype": dtype, "mesh": mesh_shape, "strategy": strategy,
               "equal_tokens": int(eq.sum()), "tokens": eq.numel(),
               "first_differing_position": first, "prefill_s": r["prefill_s"],
               "step_p50_s": r["step_p50_s"], "launches": r["launches"],
               "wall_s": time.perf_counter() - t0}
        out["serve"].append(row)
        log(f"[mesh] serve {dtype} {mesh_shape} {strategy}: {row['equal_tokens']}/"
            f"{row['tokens']} tokens equal the one card's (first differing position "
            f"{first}); prefill {r['prefill_s']*1e3:.2f} ms, step p50 "
            f"{r['step_p50_s']*1e3:.3f} ms; launches {r['launches']}")
        if dtype == "float32" and first is not None:
            ok = False
    for strategy in TRAIN_STRATEGIES:
        losses = train((2, world // 2), strategy)
        gap = max(abs(a - b) for a, b in zip(losses, solo_losses))
        out["train"].append({"mesh": (2, world // 2), "strategy": strategy,
                             "losses": losses, "max_gap": gap})
        log(f"[mesh] train (2, {world // 2}) {strategy}: losses {losses}, largest gap to "
            f"the one card's {gap:.3g}")
    out["ok"] = ok
    return out


FAMILIES = ("deepseek-moe-16b", "zamba2-2.7b", "xlstm-125m", "llama-3.2-vision-11b",
            "whisper-medium")
FAMILY_TRAIN = ("deepseek-moe-16b", "zamba2-2.7b", "xlstm-125m")
FAMILY_GEN = 8
FAMILY_XLSTM = "xlstm-125m"


def family_cfg(arch):
    """``arch`` at full width cut in depth as chip_smoke.py's phase 19 cuts it."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=2, slstm_at=(1,))
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=1, n_enc_layers=1)
    return dataclasses.replace(cfg, n_layers=cfg.attn_every or cfg.cross_every or 1)


def families_cases(rank, families=FAMILIES) -> dict:
    """``families`` (every family but the dense one) served (and the MoE,
    hybrid and xLSTM models trained) on the mesh against one card; leaves
    this rank in the process group it joins."""
    import torch

    from repro_torch.launch.mesh import init_distributed
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import OptConfig

    world = int(os.environ["WORLD_SIZE"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    opt = OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS)

    def cfg_of(arch, dtype):
        cfg = family_cfg(arch)
        return cfg if dtype == "bfloat16" else dataclasses.replace(cfg, compute_dtype=dtype)

    def serve(arch, dtype, mesh_shape=(1, 1)):
        return serve_loop(cfg_of(arch, dtype), batch=BATCH, prompt_len=PROMPT,
                          gen_tokens=FAMILY_GEN, mesh_shape=mesh_shape, device=dev)

    def train(arch, mesh_shape=(1, 1)):
        return train_loop(family_cfg(arch), steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                          seq_len=TRAIN_SEQ, seed=0, log_every=0, mesh_shape=mesh_shape,
                          opt_cfg=opt, device=dev)[1]

    trained = [a for a in FAMILY_TRAIN if a in families]
    runs = [(a, "bfloat16", m) for a in families for m in ((2, world // 2), (1, world))]
    runs += [(a, "float32", (1, world)) for a in families]
    solo = {(a, d): serve(a, d) for a, d in {(a, d) for a, d, _ in runs}}
    solo_losses = {a: train(a) for a in trained}
    out = {"families": {"serve": [], "train": []}}
    init_distributed("cuda")
    ok = True
    for arch, dtype, mesh_shape in runs:
        r = serve(arch, dtype, mesh_shape)
        got, want = r["generated"].cpu(), solo[arch, dtype]["generated"].cpu()
        eq = got == want
        first = None if bool(eq.all()) else int((~eq).any(dim=0).nonzero()[0])
        row = {"arch": arch, "dtype": dtype, "mesh": mesh_shape, "equal_tokens": int(eq.sum()),
               "tokens": eq.numel(), "first_differing_position": first,
               "prefill_s": r["prefill_s"], "step_p50_s": r["step_p50_s"],
               "one_card_prefill_s": solo[arch, dtype]["prefill_s"],
               "one_card_step_p50_s": solo[arch, dtype]["step_p50_s"], "launches": r["launches"]}
        out["families"]["serve"].append(row)
        _log(f"[families] serve {arch} {dtype} {mesh_shape} dos: {row['equal_tokens']}/"
             f"{row['tokens']} tokens equal the one card's (first differing position {first});"
             f" prefill {r['prefill_s']*1e3:.2f} ms (one card "
             f"{row['one_card_prefill_s']*1e3:.2f}), step p50 {r['step_p50_s']*1e3:.3f} ms "
             f"(one card {row['one_card_step_p50_s']*1e3:.3f})")
        if dtype == "float32" and first is not None:
            ok = False
    if FAMILY_XLSTM in families:
        out["families"]["xlstm_reshard"] = [_time_xlstm_reshard(serve, m, dev)
                                            for m in ((2, world // 2), (1, world))]
    for arch in trained:
        losses = train(arch, (2, world // 2))
        gap = max(abs(a - b) for a, b in zip(losses, solo_losses[arch]))
        out["families"]["train"].append({"arch": arch, "mesh": (2, world // 2), "losses": losses,
                                         "one_card_losses": solo_losses[arch], "max_gap": gap})
        _log(f"[families] train {arch} (2, {world // 2}) dos: losses {losses}, one card's "
             f"{solo_losses[arch]}, largest gap {gap:.3g}")
    out["ok"] = ok
    return out


def _time_xlstm_reshard(serve, mesh_shape, dev) -> dict:
    """xlstm-125m served in bf16 on ``mesh_shape`` with every decode step's
    state moves (``decoder._to_block`` and ``_to_cache``: the cache's
    placement to the block's heads and back) timed on the host clock, a
    synchronize before and after each: ms a decode step by state leaf,
    beside the step p50 of the same run (the synchronizes in it)."""
    from repro_torch.models import decoder

    orig = {name: getattr(decoder, name) for name in ("_to_block", "_to_cache")}
    spent = {}

    def timing(fn):
        def wrapped(lay, cfg, cache, path, t):
            _sync(dev)
            t0 = time.perf_counter()
            got = fn(lay, cfg, cache, path, t)
            _sync(dev)
            spent[path[-1]] = spent.get(path[-1], 0.0) + time.perf_counter() - t0
            return got
        return wrapped

    for name, fn in orig.items():
        setattr(decoder, name, timing(fn))
    try:
        r = serve(FAMILY_XLSTM, "bfloat16", mesh_shape)
    finally:
        for name, fn in orig.items():
            setattr(decoder, name, fn)
    steps = FAMILY_GEN - 1
    row = {"mesh": mesh_shape, "ms_a_step": {k: v / steps * 1e3 for k, v in spent.items()},
           "step_p50_s": r["step_p50_s"]}
    _log(f"[families] xlstm-125m {mesh_shape} decode: the state moves (cache placement to "
         f"the blocks' heads and back) {sum(row['ms_a_step'].values()):.3f} ms a step by host "
         f"clock ({', '.join(f'{k} {v:.3f}' for k, v in row['ms_a_step'].items())}); step p50 "
         f"{r['step_p50_s'] * 1e3:.3f} ms with the synchronizes")
    return row


PIPE_ARCH, PIPE_MB, PIPE_REPS = "qwen2.5-3b", 4, 3
EP_ARCH, SYNC_ARCH, SYNC_ROWS = "deepseek-moe-16b", "smollm-135m", 2
BF16_TOL, F32_LOSS_TOL = 3e-2, 1e-5


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall(dev, fn, reps):
    """Host seconds per call of ``fn()`` (after one warm call), ending in a
    synchronize; the value of the last call."""
    out = fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps, out


def parallel_cases(rank: int) -> dict:
    """The pipeline over every rank, expert parallelism at (1, world) and
    the int8 sync at (world, 1), each against one card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from _torch_ranks import np_one_sync
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import MeshSpec, make_stage_mesh, make_test_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build, moe
    from repro_torch.models.params import leaves, map_tree, materialize_cast
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.compression import compressed_psum_grads, init_error_state
    from repro_torch.parallel.moe_ep import expert_shard, moe_block_ep
    from repro_torch.parallel.pipeline import bubble_fraction, make_gpipe_loss, stage_params

    world = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    batch_rows, seq, prompt = 8, 512, 128
    out = {}

    # -- the pipeline: every rank a stage ----------------------------------
    base = get_config(PIPE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    master = build(base, dev).init(gen)  # the same weights on every rank
    data = SyntheticLM(DataConfig(base.vocab, seq, batch_rows, seed=0), 0, 1)  # the global batch
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    mesh = make_stage_mesh(world)
    stage = stage_params(master, base, mesh, n_stages=world)
    row = {"arch": base.name, "layers": base.n_layers, "stages": world,
           "microbatches": PIPE_MB, "bubble": bubble_fraction(world, PIPE_MB)}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        model = build(cfg, dev)
        one = None
        if rank == 0:  # one card, no pipeline: the loss, and loss + backward's time
            with torch.no_grad():
                one = float(model.loss(master, batch, remat=True))
            row[f"one_card_{dtype}_s"] = _wall(
                dev, lambda: loss_and_grads(model, master, batch, True), PIPE_REPS)[0]
        dist.barrier()
        loss_fn = make_gpipe_loss(cfg, mesh, n_stages=world, n_microbatches=PIPE_MB)

        def step():
            tree = map_tree(lambda t: t.detach().requires_grad_(), stage)
            loss = loss_fn(tree, batch)
            loss.backward()
            return loss.detach()

        secs, loss = _wall(dev, step, PIPE_REPS)
        losses = C.gather(loss.reshape(1), mesh, "pod", 0).tolist()
        row[f"{dtype}_losses"], row[f"{dtype}_s"] = losses, secs
        if rank == 0:
            rel = abs(losses[0] - one) / abs(one)
            tol = F32_LOSS_TOL if dtype == "float32" else BF16_TOL
            row[f"{dtype}_one_card_loss"], row[f"{dtype}_rel"] = one, rel
            row["ok"] = row.get("ok", True) and rel <= tol and len(set(losses)) == 1
            _log(f"[pipeline] {base.name} ({base.n_layers} layers) over {world} stages, "
                 f"{batch_rows} x {seq} in {PIPE_MB} microbatches, {dtype}: losses {losses} "
                 f"against one card's {one:.6f} (relative {rel:.3g}, band {tol}); loss + "
                 f"backward {secs*1e3:.1f} ms against one card's "
                 f"{row[f'one_card_{dtype}_s']*1e3:.1f} ms; bubble {row['bubble']:.3f}")
    out["pipeline"] = row
    del master, stage
    torch.cuda.empty_cache()

    # -- expert parallelism at (1, world) ------------------------------------
    cfg = get_config(EP_ARCH)
    gen = torch.Generator(device=dev).manual_seed(18)
    p = materialize_cast(moe.moe_defs(cfg), gen, torch.float32, torch.bfloat16, dev)
    xs = {tag: torch.randn(4, s, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
          for tag, s in (("prefill", prompt), ("decode", 1))}
    mesh = make_test_mesh(1, world)
    pl = expert_shard(p, mesh)
    row = {"arch": cfg.name, "mesh": (1, world), "ok": True}
    with torch.no_grad():
        for tag, x in xs.items():
            one_s, want = _wall(dev, lambda: moe.moe_block(p, x, cfg), PIPE_REPS)
            ep_s, got = _wall(dev, lambda: moe_block_ep(pl, x, cfg, mesh), PIPE_REPS)
            y = torch.randn(x.shape[0] * x.shape[1], cfg.d_model, device=dev).to(x.dtype)
            wire_s = _wall(dev, lambda: C.psum(y, mesh, "model"), 20)[0]
            gap = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
            row[tag] = {"rel": gap, "one_card_s": one_s, "ep_s": ep_s, "all_reduce_s": wire_s,
                        "all_reduce_bytes": y.numel() * y.element_size()}
            row["ok"] = row["ok"] and gap <= BF16_TOL
            _log(f"[moe_ep] {cfg.name} one layer at (1, {world}), {tag} {tuple(x.shape)}: "
                 f"against one card's moe_block {gap:.3g} of its max (band {BF16_TOL}); "
                 f"{ep_s*1e3:.3f} ms against one card's {one_s*1e3:.3f} ms; the all-reduce of "
                 f"its {y.numel() * y.element_size():,} bytes alone {wire_s*1e3:.3f} ms")
    out["moe_ep"] = row
    del p, pl
    torch.cuda.empty_cache()

    # -- the int8 sync at (world, 1) -----------------------------------------
    cfg = get_config(SYNC_ARCH)
    model = build(cfg, dev)
    master = model.init(torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLM(DataConfig(cfg.vocab, seq, SYNC_ROWS * world, seed=0), 0, 1)
    mine = {k: torch.from_numpy(v[rank * SYNC_ROWS:(rank + 1) * SYNC_ROWS]).to(dev)
            for k, v in data.batch(0).items()}
    grads = loss_and_grads(model, master, mine, True)[1]  # this rank's rows only
    mesh = make_test_mesh(world, 1)
    err = init_error_state(grads)
    g_hat, new_err = compressed_psum_grads(grads, err, mesh)
    sync_s = _wall(dev, lambda: compressed_psum_grads(grads, err, mesh), PIPE_REPS)[0]
    one = MeshSpec((1, 1), ("data", "model"))  # this rank alone: no collective
    one_s = _wall(dev, lambda: compressed_psum_grads(grads, err, one), PIPE_REPS)[0]
    ok, worst_ulp = True, 0.0
    got_hat, new = dict(leaves(g_hat)), dict(leaves(new_err))
    for path, g in leaves(grads):  # rank 0 holds every rank's result to the transcription
        gs = C.gather(g.float()[None], mesh, "data", 0)
        errs = C.gather(new[path][None], mesh, "data", 0)
        if rank == 0:
            gs = gs.cpu().numpy()
            _, want_hat, want_err = np_one_sync(gs, np.zeros_like(gs))
            got = got_hat[path].cpu().numpy()
            ulp = float((np.abs(got - want_hat) / np.finfo(np.float32).eps
                         / np.maximum(np.abs(want_hat), np.finfo(np.float32).tiny)).max())
            worst_ulp = max(worst_ulp, ulp)
            ok = ok and np.array_equal(errs.cpu().numpy(), want_err)
    n_el = sum(t.numel() for _, t in leaves(grads))
    ok = ok and worst_ulp <= 4.0  # the scale sum in the collective's order: a few eps
    out["compression"] = {"arch": cfg.name, "mesh": (world, 1), "elements": n_el,
                          "sync_s": sync_s, "one_rank_sync_s": one_s,
                          "worst_g_hat_rel_in_eps": worst_ulp, "ok": ok}
    _log(f"[compress] {cfg.name}'s gradients ({n_el:,} elements), each rank's from its own "
         f"{SYNC_ROWS} x {seq} rows, at ({world}, 1): g_hat against the numpy transcription "
         f"on the ranks' gathered gradients, worst {worst_ulp:.3g} eps relative (band 4); every "
         f"new_err exact, and g_hat within the band: {ok}; {sync_s*1e3:.3f} ms per sync, "
         f"{one_s*1e3:.3f} ms with no collective")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=os.path.join(ROOT, "chiprun_out", "mesh_nccl.json"))
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=780.0)
    ap.add_argument("--only", choices=("mesh", "parallel", "families"),
                    help="only the dense family's (data, model) mesh cases, only the pipeline, "
                         "expert parallelism and int8 sync, or only the other families")
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="with --only families: the families' archs to run, comma-separated")
    args = ap.parse_args(argv)
    families = tuple(args.families.split(","))
    if not set(families) <= set(FAMILIES):
        ap.error(f"--families: {sorted(set(families) - set(FAMILIES))} not in {FAMILIES}")
    if os.environ.get("RANK") is not None:
        rank_main(args.json, args.only, families)
        return 0
    import torch

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    if torch.cuda.device_count() < args.world:
        print(f"needs {args.world} cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {'; '.join(smi.stdout.strip().splitlines())}", flush=True)
    _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(args.world),
               PYTHONPATH=os.pathsep.join(os.path.join(ROOT, d) for d in ("src", "tests")))
    flags = ["--json", args.json, "--families", args.families] + (
        ["--only", args.only] if args.only else [])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *flags],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT)
             for r in range(args.world)]
    deadline = time.monotonic() + args.timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    print(f"[mesh] ranks' exit codes {[p.returncode for p in procs]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
