"""Serving launcher: batched prefill + greedy decode loop.

Serves every family of the zoo: dense, MoE (deepseek-moe, llama4-scout),
vision cross-attention (llama-3.2-vision: the prefill also takes image
embeddings), hybrid (zamba2), SSM (xLSTM) and encoder-decoder (whisper:
the prefill also takes encoder frames). Measures prefill latency,
aggregate decode throughput and per-step decode latency percentiles,
with each step ended by a device synchronize, so the times are device
work and not enqueue time. It also
records how many times each CUDA kernel launched in prefill and in
decode. ``--json`` prints the machine-readable summary with the JAX
package's keys, plus the device the run used.

    python -m repro_torch.launch.serve --json            # on the card
    python -m repro_torch.launch.serve --arch zamba2-2.7b --json
    python -m repro_torch.launch.serve --arch xlstm-125m --json
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --json
    python -m repro_torch.launch.serve --arch llama-3.2-vision-11b --prompt-len 128 --json
    python -m repro_torch.launch.serve --arch whisper-medium --prompt-len 128 --json
    python -m repro_torch.launch.serve --smoke --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --strategy megatron --json

Under ``torchrun`` the ranks join one process group (``nccl`` on the
cards, ``gloo`` with ``--device cpu``) laid out as a (1, WORLD_SIZE)
mesh: the model axis, over which ``dos`` and ``megatron`` shard the
weights (``zero`` spreads the batch over it). Rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import device_info, resolve_device
from ..configs import get_config, reduced
from ..kernels import launch_counts
from ..models import build
from ..models.zoo import MODEL_INPUTS, spans_ranks
from ..parallel.axes import STRATEGIES, ShardingRules, param_sharding, use_rules
from ..parallel.plan import shard_place
from .mesh import cli_mesh, is_first_rank, make_test_mesh
from .steps import make_prefill_step, make_serve_step

__all__ = ["serve_loop", "generate", "model_inputs"]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def model_inputs(cfg, batch: int, seed: int) -> dict:
    """The prefill's input beside the prompts: ``image_embeds`` (B,
    n_image_tokens, E) for the vision model, ``enc_frames`` (B, enc_seq, E)
    for the encoder-decoder, none for the other families. Standard normals
    drawn on the CPU from ``seed + 2`` and cast to the compute dtype, as
    the reference's serve loop draws them in it."""
    if cfg.family not in MODEL_INPUTS:
        return {}
    name, length = MODEL_INPUTS[cfg.family]
    x = torch.randn((batch, getattr(cfg, length), cfg.d_model),
                    generator=torch.Generator().manual_seed(seed + 2))
    return {name: x.to(getattr(torch, cfg.compute_dtype))}


def generate(model, params, prompts, gen_tokens: int, inputs=None):
    """Greedy prefill-then-decode of ``prompts`` (B, S); the first token
    comes from the prefill logits. ``inputs`` (``model_inputs``) go to the
    prefill only: the decode steps read what it made of them from the
    cache. Returns the tokens (B, gen_tokens), the timings and the kernel
    launches of each phase."""
    dev = model.device
    batch, prompt_len = prompts.shape
    prefill = make_prefill_step(model, max_len=prompt_len + gen_tokens)
    decode = make_serve_step(model)
    pf_batch = {"tokens": prompts.to(dev), **{k: t.to(dev) for k, t in (inputs or {}).items()}}

    c0 = launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, pf_batch)
    tok = model.greedy(logits[:, -1:], cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    c1 = launch_counts()

    out_tokens = [tok]
    step_s = []
    t0 = time.perf_counter()
    for _ in range(gen_tokens - 1):
        ts = time.perf_counter()
        logits, cache = decode(params, cache, {"token": tok})
        tok = model.greedy(logits, cache)
        _sync(dev)
        step_s.append(time.perf_counter() - ts)
        out_tokens.append(tok)
    t_decode = time.perf_counter() - t0
    c2 = launch_counts()

    steps = np.asarray(step_s) if step_s else np.zeros(1)
    return {
        "generated": torch.cat(out_tokens, dim=1),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
        "step_p50_s": float(np.percentile(steps, 50)),
        "step_p99_s": float(np.percentile(steps, 99)),
        "launches": {"prefill": _delta(c1, c0), "decode": _delta(c2, c1)},
    }


def serve_loop(
    cfg,
    *,
    batch: int = 4,
    prompt_len: int = 64,
    gen_tokens: int = 32,
    strategy: str = "dos",
    mesh_shape=(1, 1),
    seed: int = 0,
    greedy: bool = True,
    device=None,
):
    """Serve ``cfg`` with random weights and prompts made from ``seed``.

    Runs on ``cuda`` unless ``device="cpu"``; raises without a card.
    ``strategy`` (dos, megatron, zero, auto) and ``mesh_shape`` (data,
    model) are the reference's: on a mesh of more than one rank (the
    default process group's, ``launch.mesh``), each rank draws every
    weight, keeps its shard under the rules (FSDP off, as serving has
    it) and serves its part of the batch; every rank returns the whole
    batch's tokens. At (1, 1) every strategy serves as one device does.
    Decoding is greedy, as in the reference. Weights and prompts are
    drawn on the CPU, so one seed gives the same run on either device;
    ``init_s`` is the time that takes (weights drawn, cut, moved and
    cast), outside the prefill and decode times. The weights are formed
    a leaf at a time (``Model.init_compute``), so the card holds them in
    the compute dtype only (deepseek-moe-16b: 33.8 GB of bf16, where the
    f32 tree alone is 67.5 GB); drawing its 16.9 B values on the host
    takes minutes. The vision and encoder-decoder prefills also take
    ``model_inputs`` (drawn after ``init_s``)."""
    dev = resolve_device(device)
    rules = ShardingRules(make_test_mesh(*mesh_shape), strategy=strategy, fsdp=False)
    multi = spans_ranks(cfg, rules)
    t0 = time.perf_counter()
    model = build(cfg, device=dev)
    place = shard_place(param_sharding(model.defs, rules), rules.mesh) if multi else None
    params = model.init_compute(torch.Generator().manual_seed(seed), place)
    _sync(dev)
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1))
    with use_rules(rules if multi else None):  # one rank: one device's path, no lookups
        out = generate(model, params, prompts, gen_tokens, model_inputs(cfg, batch, seed))
    out["init_s"] = init_s
    out["device"] = device_info(dev)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--strategy", default="dos", choices=STRATEGIES,
                    help="the reference's sharding rules")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable summary")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    dev, mesh_shape = cli_mesh(args.device)
    r = serve_loop(
        cfg, batch=args.batch, prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
        strategy=args.strategy, mesh_shape=mesh_shape, device=dev,
    )
    if not is_first_rank():
        return
    if args.json:
        print(json.dumps({
            "arch": args.arch,
            "batch": args.batch,
            "prompt_len": args.prompt_len,
            "gen_tokens": args.gen_tokens,
            "prefill_s": r["prefill_s"],
            "decode_tok_s": r["decode_tok_s"],
            "step_p50_s": r["step_p50_s"],
            "step_p99_s": r["step_p99_s"],
            "launches": r["launches"],
            "device": r["device"],
        }, indent=1))
        return
    print(
        f"prefill {r['prefill_s']*1e3:.1f}ms; decode {r['decode_tok_s']:.1f} tok/s "
        f"(step p50 {r['step_p50_s']*1e3:.2f}ms, p99 {r['step_p99_s']*1e3:.2f}ms) "
        f"on {r['device']['kind']}; sample: {r['generated'][0, :16].tolist()}"
    )


if __name__ == "__main__":
    main()
