"""Decoder LM: the dense branch (llama/smollm/qwen and gemma3's
local:global; with ``family="moe"`` each layer's MLP is a
Mixture-of-Experts FFN: deepseek-moe, llama4-scout), the ``vlm`` branch
(llama-3.2-vision: groups of ``cross_every - 1`` self-attention layers,
each group followed by a gated cross-attention layer over the image
embeddings), the hybrid branch (zamba2: groups of Mamba2 layers, each
group followed by one weight-shared attention+MLP block) and the ``ssm``
branch (xLSTM: a list of mLSTM and sLSTM blocks, each behind its own
rmsnorm ``ln``, with no MLP). The encoder-decoder family is
``models/encdec.py``.

The reference scans stacked layer trees with ``lax.scan`` and carries
each layer's window and rope theta as scanned arrays. The port keeps the
stacked parameter layout (``layers.wq`` is (L, E, H*hd); the vision
model's ``layers.attn.wq`` is (n_groups, n_self, E, H*hd) and its
``cross_layers`` are stacked (n_groups); the hybrid's ``layers.wx`` is
(n_groups, period, E, Di), and so on) but runs the layers in a Python
loop, so each layer's window and theta are Python numbers: the window
reaches the flash kernel as a launch argument.

Modes: ``train`` (whole sequence, loss-ready logits, no cache; ``remat``
recomputes each dense or vision self-attention layer, or each of the
hybrid's Mamba2 layers, in the backward), ``prefill`` (whole prompt;
returns the cache) and ``decode`` (one token; the cache advances in
place).

On a mesh (``layout``: this rank's ``layers.Layout`` under sharding
rules) every branch runs on the rank's shards, its FSDP leaves gathered
one layer (a Mamba2 layer, an xLSTM block, the hybrid's shared block at
each of its calls) at a time; a prefill returns the rank's shard of the
cache under the reference's placement (``parallel.plan``), and between
decode steps each rank holds exactly that shard. The vision cross
layers run on the rank's heads, their ``gate`` replicated; the cross
cache is placed as ``cross.k`` and ``cross.v`` are (on its sequence
where the KV heads do not divide ``model``: the decode then merges the
slices' softmaxes). A state leaf that the placement splits otherwise
than the block computes it (the mLSTM's ``C`` on P or N, the block on
heads; any state at a ``model`` its heads do not divide) is moved into
the block's layout at each decode step and back after it: one
all-gather of the leaf over ``model`` each way, per block and step
(``_reshard``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ArchConfig
from ..parallel import axes as A
from ..parallel import collectives as C
from ..parallel import plan as P
from .layers import (
    ONE, Layout, attention, attn_defs, compute_cross_kv, embed_defs, embed_tokens, mlp, mlp_defs,
    rmsnorm, rmsnorm_def, unembed,
)
from .moe import moe_block, moe_defs
from .params import ParamDef, compute_cast, leaves, map_tree, stack_defs, unflatten
from .ssm import mamba_block, mamba_defs, mamba_init_state
from .xlstm import (
    mlstm_block, mlstm_defs, mlstm_init_state, slstm_block, slstm_defs, slstm_init_state,
)

__all__ = ["decoder_defs", "decoder_forward", "init_cache", "layer_metadata", "layout", "pad_kv",
           "placed_cache", "ring_of"]

_GLOBAL_WINDOW = 2**30  # "window" larger than any sequence = global attn


def _check_family(cfg: ArchConfig):
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "ssm"):
        raise ValueError(f"decoder does not handle family {cfg.family!r} ({cfg.name})")


def _block_defs(cfg: ArchConfig):
    return {
        "ln1": rmsnorm_def(cfg.d_model),
        "attn": attn_defs(cfg),
        "ln2": rmsnorm_def(cfg.d_model),
        "ffn": moe_defs(cfg) if cfg.family == "moe" else mlp_defs(cfg),
    }


def _groups(cfg: ArchConfig):
    """Hybrid layout: (n_groups, period) Mamba2 layers."""
    return cfg.n_layers // cfg.attn_every, cfg.attn_every


def _vlm_groups(cfg: ArchConfig):
    """Vision layout: (n_groups, n_self) self-attention layers, each group
    followed by one cross layer."""
    return cfg.n_layers // cfg.cross_every, cfg.cross_every - 1


def decoder_defs(cfg: ArchConfig):
    _check_family(cfg)
    defs = {"embed": embed_defs(cfg), "final_norm": rmsnorm_def(cfg.d_model)}
    if cfg.family == "hybrid":
        n_groups, period = _groups(cfg)
        defs["layers"] = stack_defs(stack_defs(mamba_defs(cfg), period), n_groups)
        defs["shared_attn"] = _block_defs(cfg)  # ONE set of weights, applied every period
    elif cfg.family == "ssm":
        defs["blocks"] = [
            {"kind_slstm": slstm_defs(cfg)} if i in cfg.slstm_at
            else {"kind_mlstm": mlstm_defs(cfg)}
            for i in range(cfg.n_layers)
        ]
        for blk in defs["blocks"]:
            blk["ln"] = rmsnorm_def(cfg.d_model)
    elif cfg.family == "vlm":
        n_groups, n_self = _vlm_groups(cfg)
        defs["layers"] = stack_defs(stack_defs(_block_defs(cfg), n_self), n_groups)
        cross = {
            "ln1": rmsnorm_def(cfg.d_model),
            "attn": attn_defs(cfg),
            "gate": ParamDef((1,), ("one",), init="zeros"),
            "ln2": rmsnorm_def(cfg.d_model),
            "ffn": mlp_defs(cfg),
        }
        defs["cross_layers"] = stack_defs(cross, n_groups)
    else:
        defs["layers"] = stack_defs(_block_defs(cfg), cfg.n_layers)
    return defs


def layer_metadata(cfg: ArchConfig, n: int | None = None):
    """Per-layer (window, theta) lists."""
    n = n or cfg.n_layers
    wins, thetas = [], []
    for i in range(n):
        is_global = cfg.global_every and ((i + 1) % cfg.global_every == 0)
        if cfg.sliding_window and not is_global:
            wins.append(cfg.sliding_window)
        else:
            wins.append(_GLOBAL_WINDOW)
        if is_global and cfg.global_rope_theta:
            thetas.append(float(cfg.global_rope_theta))
        else:
            thetas.append(float(cfg.rope_theta))
    return wins, thetas


@functools.lru_cache(maxsize=64)
def layout(cfg: ArchConfig, rules, batch: int) -> Layout:
    """This rank's layout of any family under ``rules`` (a mesh of more
    than one rank) for a global batch of ``batch`` rows. A dim that does
    not split over ``model`` stays whole on every rank, as the
    reference's ``_divisible`` and ``shard()`` fall back: the heads
    (attention's, Mamba2's, the xLSTM's), the MLP's and the experts'
    hidden, the vocab."""
    from .encdec import encdec_defs  # encdec imports this module

    mesh = rules.mesh
    tp = ("model",) if "model" in rules.axis_names and rules.strategy != "zero" else ()
    m = C.axis_size(mesh, tp)
    bspec = P.batch_sharding(rules, {"tokens": torch.empty((batch, 1), device="meta")})
    defs = encdec_defs(cfg) if cfg.family == "encdec" else decoder_defs(cfg)
    specs = dict(leaves(A.param_sharding(defs, rules)))
    dims = {}
    for path, spec in specs.items():
        tail = spec[-2:] if len(spec) >= 2 else ()
        if tp and "model" in tail:
            dims[path[-2:]] = tail.index("model")
    split = lambda n: bool(tp) and n % m == 0  # noqa: E731
    return Layout(
        rules=rules, mesh=mesh, specs=specs, dims=dims, tp=tp, m=m,
        batch=A.spec_axes(bspec["tokens"][0]), all_batch=rules.batch_axes(), global_batch=batch,
        resid=split(cfg.d_model) and rules.act_spec("residual")[-1] == "model",
        heads=split(cfg.n_kv_heads) and split(cfg.n_heads), hidden=split(cfg.d_ff),
        vocab=split(cfg.vocab),
        ssm_heads=cfg.family == "hybrid" and split(cfg.ssm_expand * cfg.d_model
                                                   // cfg.ssm_head_dim),
        expert_hidden=cfg.family == "moe" and split(cfg.expert_d_ff),
        fsdp=any(p is not None and not (tp and p == "model")
                 for spec in specs.values() for p in spec))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Decode-ready cache and one ``length`` for all layers (the
    reference keeps a copy per layer). Dense and MoE: stacked (L, B,
    max_len, KVH, D) k/v buffers under ``layers``. Vision: the self
    layers' (n_groups, n_self, B, max_len, KVH, D) under ``layers`` and the
    cross layers' (n_groups, B, n_image_tokens, KVH, D) under ``cross``.
    Hybrid: the Mamba2 states stacked (n_groups, period, ...) under ``mamba`` (``ssm`` in f32,
    ``conv`` in ``dtype``) and the shared block's (n_groups, B, max_len,
    KVH, D) k/v under ``attn``. xLSTM: each block's f32 state under
    ``blocks``, a list (mLSTM ``C`` (B, H, N, P) and ``n`` (B, H, N, 1);
    sLSTM ``c``, ``h`` (B, E) and ``n`` (B, H)), whatever ``dtype`` and
    ``max_len``, as in the reference."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return {"blocks": [slstm_init_state(cfg, batch, device) if i in cfg.slstm_at
                           else mlstm_init_state(cfg, batch, device)
                           for i in range(cfg.n_layers)],
                "length": 0}

    def kv(*lead, s=max_len):
        shape = (*lead, batch, s, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    if cfg.family in ("dense", "moe"):
        return {"layers": kv(cfg.n_layers), "length": 0}
    if cfg.family == "vlm":
        n_groups, n_self = _vlm_groups(cfg)
        return {"layers": kv(n_groups, n_self), "cross": kv(n_groups, s=cfg.n_image_tokens),
                "length": 0}
    n_groups, period = _groups(cfg)
    m = mamba_init_state(cfg, batch, dtype, device)
    return {
        "mamba": {k: t.expand((n_groups, period) + t.shape).clone() for k, t in m.items()},
        "attn": kv(n_groups),
        "length": 0,
    }


def _attn_mlp_block(lp, x, cfg, *, mode, cache, window, theta, cross_kv=None, lay=ONE,
                    root="layers"):
    """One attention+MLP layer (``root``: its parameters' path; None: they
    are gathered already); on a mesh its FSDP shards are gathered here,
    just before the layer uses them (and again in a recompute). A cross
    layer (``cross_kv``) takes its cache's ``seq_axes`` in decode."""
    if root is not None:
        lp = lay.gather(lp, root)
    h, new_cache = attention(
        lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps, lay, lay.resid), cfg,
        mode=mode, cache=cache, window=window, theta=theta, cross_kv=cross_kv, lay=lay,
    )
    if "gate" in lp:  # gated cross-attention (llama-3.2-vision)
        gate = lp["gate"]
        if lay.resid:  # one scalar times this rank's slice of E: its gradient sums the slices
            gate = C.copy_to(gate, lay.mesh, lay.tp)
        h = torch.tanh(gate.float()).to(h.dtype) * h
    x = x + h
    y = rmsnorm(x, lp["ln2"], cfg.norm_eps, lay, lay.resid)
    ffn = moe_block(lp["ffn"], y, cfg, lay) if "router" in lp["ffn"] else mlp(lp["ffn"], y, lay)
    return x + ffn, new_cache


def _train_block(lp, x, cfg, *, window, theta, remat, lay=ONE):
    """One attention+MLP layer in training. ``remat=True`` recomputes the
    layer in the backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of its scanned body); ``"save_gathered"`` also
    keeps the weights cast to the compute dtype, as the reference's
    policy saves its ``gathered_w`` names: the cast runs once, outside
    the checkpoint, and the recompute reads its result."""

    def block(lp, x):
        return _attn_mlp_block(lp, x, cfg, mode="train", cache=None, window=window,
                               theta=theta, lay=lay)[0]

    if not remat:
        return block(lp, x)
    if remat == "save_gathered":
        lp = compute_cast(lp, x.dtype)
    return checkpoint(block, lp, x, use_reentrant=False)


def _dense_layers(params, x, cfg, *, mode, cache, remat=False, lay=ONE):
    """The dense (and MoE) stack; prefill returns its k/v stacked (L, B, S, KVH, D),
    train no cache. A sequence-sharded decode cache's ``seq_lo`` and
    ``seq_axes`` reach every layer."""
    wins, thetas = layer_metadata(cfg)
    ks, vs = [], []  # prefill: each layer's new k, v
    # one unbind per stacked leaf: in training its backward stacks the
    # layers' gradients once, where indexing a[i] per layer would give each
    # layer's gradient as a zero-filled copy of the whole stack and sum L
    # of them
    stacked = map_tree(lambda a: a.unbind(0), params["layers"])
    ring = ring_of(lay, cfg, cache, "layers") if mode == "decode" else {}
    for i in range(cfg.n_layers):
        lp = map_tree(lambda a: a[i], stacked)
        if mode == "train":
            x = _train_block(lp, x, cfg, window=wins[i], theta=thetas[i], remat=remat, lay=lay)
            continue
        cache_l = None
        if mode == "decode":
            cache_l = {"k": cache["layers"]["k"][i], "v": cache["layers"]["v"][i],
                       "length": cache["length"], **ring}
        x, nc = _attn_mlp_block(lp, x, cfg, mode=mode, cache=cache_l,
                                window=wins[i], theta=thetas[i], lay=lay)
        if mode == "prefill":
            ks.append(nc["k"])
            vs.append(nc["v"])
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, {"layers": cache["layers"]}
    return x, {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def _vlm_layers(params, x, cfg, *, mode, cache, image_embeds, remat=False, lay=ONE):
    """Groups of ``n_self`` self-attention layers (each layer's window and
    theta from ``layer_metadata`` over the n_groups * n_self self layers),
    each group followed by its gated cross-attention layer. Train and
    prefill project each cross layer's k, v from ``image_embeds`` (prefill
    returns them under ``cross``); decode reads them from the cache and
    writes the self layers' new k, v into it in place. ``remat``
    recomputes the self layers in the backward, not the cross layers, as
    in the reference."""
    n_groups, n_self = _vlm_groups(cfg)
    if mode != "decode" and image_embeds is None:
        raise ValueError(f"{cfg.name}: {mode} needs image_embeds "
                         f"(B, {cfg.n_image_tokens}, {cfg.d_model})")
    wins, thetas = layer_metadata(cfg, n_groups * n_self)
    # one unbind of each stacked leaf, as in _dense_layers
    self_stack = map_tree(lambda a: a.flatten(0, 1).unbind(0), params["layers"])
    cross_stack = map_tree(lambda a: a.unbind(0), params["cross_layers"])
    ring = ring_of(lay, cfg, cache, "layers") if mode == "decode" else {}
    cross_ring = ring_of(lay, cfg, cache, "cross") if mode == "decode" else {}
    ks, vs, cross_k, cross_v = [], [], [], []  # prefill: each layer's new k, v
    for g in range(n_groups):
        for i in range(n_self):
            j = g * n_self + i
            lp = map_tree(lambda a: a[j], self_stack)
            if mode == "train":
                x = _train_block(lp, x, cfg, window=wins[j], theta=thetas[j], remat=remat,
                                 lay=lay)
                continue
            cache_l = None
            if mode == "decode":
                cache_l = {"k": cache["layers"]["k"][g, i], "v": cache["layers"]["v"][g, i],
                           "length": cache["length"], **ring}
            x, nc = _attn_mlp_block(lp, x, cfg, mode=mode, cache=cache_l, window=wins[j],
                                    theta=thetas[j], lay=lay)
            if mode == "prefill":
                ks.append(nc["k"])
                vs.append(nc["v"])
        cp = lay.gather(map_tree(lambda a: a[g], cross_stack), "cross_layers")
        if mode == "decode":
            ckv = (cache["cross"]["k"][g], cache["cross"]["v"][g])
        else:
            ckv = compute_cross_kv(cp["attn"], image_embeds, cfg, lay)
        x, _ = _attn_mlp_block(cp, x, cfg, mode=mode, cache=cross_ring or None, window=None,
                               theta=None, cross_kv=ckv, lay=lay, root=None)
        if mode == "prefill":
            cross_k.append(ckv[0])
            cross_v.append(ckv[1])
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, {"layers": cache["layers"], "cross": cache["cross"]}
    return x, {"layers": {"k": torch.stack(ks).unflatten(0, (n_groups, n_self)),
                          "v": torch.stack(vs).unflatten(0, (n_groups, n_self))},
               "cross": {"k": torch.stack(cross_k), "v": torch.stack(cross_v)}}


def _train_mamba(lp, x, cfg, *, remat, lay=ONE):
    """One residual Mamba2 layer in training, its FSDP shards gathered
    inside (so a recompute gathers again). ``remat`` (either policy)
    recomputes it in the backward, as the reference's ``jax.checkpoint``
    of its scanned body, which takes no policy here."""

    def layer(lp, x):
        return x + mamba_block(lay.gather(lp, "layers"), x, cfg, mode="train", lay=lay)[0]

    return checkpoint(layer, lp, x, use_reentrant=False) if remat else layer(lp, x)


def _hybrid_layers(params, x, cfg, *, mode, cache, remat=False, lay=ONE):
    """Groups of ``period`` residual Mamba2 layers, each group followed by
    the shared attention+MLP block (no window, ``cfg.rope_theta``).
    Decode writes the new states into the stacked cache in place; train
    returns no cache, and ``remat`` recomputes each Mamba2 layer (not the
    shared block) in the backward. On a mesh the shared block's FSDP
    shards are gathered at each of its calls, and its gradient sums every
    call's (autograd)."""
    n_groups, period = _groups(cfg)
    states, ks, vs = [], [], []  # prefill: each layer's state, each group's k, v
    # train: one unbind of each stacked leaf, as in _dense_layers
    stacked = (map_tree(lambda a: a.flatten(0, 1).unbind(0), params["layers"])
               if mode == "train" else None)
    ring = ring_of(lay, cfg, cache, "attn") if mode == "decode" else {}
    for g in range(n_groups):
        for i in range(period):
            if mode == "train":
                x = _train_mamba(map_tree(lambda a: a[g * period + i], stacked), x, cfg,
                                 remat=remat, lay=lay)
                continue
            lp = lay.gather(map_tree(lambda a: a[g, i], params["layers"]), "layers")
            st = None
            if mode == "decode":
                st = {k: _to_block(lay, cfg, cache, ("mamba", k), t[g, i])
                      for k, t in cache["mamba"].items()}
            y, nst = mamba_block(lp, x, cfg, mode=mode, state=st, lay=lay)
            x = x + y
            if mode == "decode":
                for k, t in cache["mamba"].items():
                    t[g, i].copy_(_to_cache(lay, cfg, cache, ("mamba", k), nst[k]))
            else:
                states.append(nst)
        cache_a = None
        if mode == "decode":
            cache_a = {"k": cache["attn"]["k"][g], "v": cache["attn"]["v"][g],
                       "length": cache["length"], **ring}
        x, nc = _attn_mlp_block(params["shared_attn"], x, cfg, mode=mode, cache=cache_a,
                                window=None, theta=cfg.rope_theta, lay=lay, root="shared_attn")
        if mode == "prefill":
            ks.append(nc["k"])
            vs.append(nc["v"])
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, {"mamba": cache["mamba"], "attn": cache["attn"]}
    mamba = {k: torch.stack([st[k] for st in states]).unflatten(0, (n_groups, period))
             for k in ("ssm", "conv")}
    return x, {"mamba": mamba, "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def _xlstm_blocks(params, x, cfg, *, mode, cache, remat=False, lay=ONE):
    """The xLSTM's residual blocks, ``x + block(rmsnorm(x, ln))``, each an
    mLSTM or (at ``cfg.slstm_at``) an sLSTM, its FSDP shards gathered
    just before it runs. Prefill returns every block's final state;
    decode writes the new states into the cache in place; train returns
    no cache. ``remat`` is ignored: the reference applies no checkpoint to
    this branch."""
    del remat
    states = []
    for i, bp in enumerate(params["blocks"]):
        bp = lay.gather(bp, ("blocks", i))
        slstm = i in cfg.slstm_at
        block = slstm_block if slstm else mlstm_block
        st = None
        if mode == "decode":
            st = {k: _to_block(lay, cfg, cache, ("blocks", i, k), t)
                  for k, t in cache["blocks"][i].items()}
        y, nst = block(bp["kind_slstm" if slstm else "kind_mlstm"],
                       rmsnorm(x, bp["ln"], cfg.norm_eps, lay, lay.resid), cfg, mode=mode,
                       state=st, lay=lay)
        x = x + y
        if mode == "decode":
            for k, t in cache["blocks"][i].items():
                t.copy_(_to_cache(lay, cfg, cache, ("blocks", i, k), nst[k]))
        elif mode == "prefill":
            states.append(nst)
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, {"blocks": cache["blocks"]}
    return x, {"blocks": states}


def decoder_forward(params, tokens, cfg: ArchConfig, *, mode: str, cache=None,
                    image_embeds=None, max_len: int = 0, remat=False, lay: Layout = ONE):
    """tokens (B, S) int -> (logits (B, S, V) f32, new cache); ``train``
    returns no cache, and ``remat`` (False, True or ``"save_gathered"``)
    applies to it alone, as in the reference. The vision model's train and
    prefill take ``image_embeds`` (B, n_image_tokens, E). On a mesh
    (``lay``) every branch takes this rank's parameter shards and rows of
    the batch (``image_embeds`` also split on E if ``lay.resid``), and
    returns its logits (its vocab slice where the vocab is sharded) and
    its cache (``placed_cache``)."""
    _check_family(cfg)
    emb = lay.gather(params["embed"], "embed")
    x = embed_tokens(emb, tokens, getattr(torch, cfg.compute_dtype), lay)
    remat = remat if mode == "train" else False
    if cfg.family == "vlm":
        x, new_cache = _vlm_layers(params, x, cfg, mode=mode, cache=cache,
                                   image_embeds=image_embeds, remat=remat, lay=lay)
    elif cfg.family in ("hybrid", "ssm"):
        layers = _hybrid_layers if cfg.family == "hybrid" else _xlstm_blocks
        x, new_cache = layers(params, x, cfg, mode=mode, cache=cache, remat=remat, lay=lay)
    else:
        x, new_cache = _dense_layers(params, x, cfg, mode=mode, cache=cache, remat=remat,
                                     lay=lay)

    x = rmsnorm(x, lay.gather(params["final_norm"], "final_norm"), cfg.norm_eps, lay, lay.resid)
    logits = unembed(emb, x, cfg.tie_embeddings, lay)

    if mode == "train":
        return logits, None
    if mode == "decode":  # a mesh's cache keeps its placement's keys
        return logits, {**cache, **new_cache, "length": cache["length"] + 1}
    new_cache["length"] = tokens.shape[1]
    kv = "attn" if cfg.family == "hybrid" else "layers"  # the xLSTM's states have no k/v
    if max_len and kv in new_cache:
        new_cache[kv] = pad_kv(new_cache[kv], max_len)
    return logits, placed_cache(lay, cfg, new_cache)


# --- the cache's placement on a mesh -------------------------------------------------

_KV_GROUP = {"dense": "layers", "moe": "layers", "vlm": "layers", "hybrid": "attn",
             "encdec": "self"}  # the self-attention k/v whose length is the cache's


@functools.lru_cache(maxsize=64)
def _cache_specs(cfg: ArchConfig, rules, batch: int, max_len: int) -> dict:
    """{path: spec} of every leaf of the serving cache (``serve_cache_specs``)."""
    return dict(leaves(P.serve_cache_specs(rules, P.abstract_cache(cfg, batch, max_len),
                                           batch)))


def _held(lay: Layout, path, ndim: int) -> tuple:
    """The spec of the cache leaf at ``path`` as the forward computes it:
    its rows as the activations hold them, k and v on this rank's KV heads
    if attention ran on them, a Mamba2 state on the rank's heads (``ssm``)
    or Di channels (``conv``), an xLSTM state on the rank's heads (the
    dim after the batch: H, or E of the sLSTM's ``c`` and ``h``)."""
    b = lay.batch or None
    name = path[-1]
    if name in ("k", "v"):
        core = (b, None, lay.tp if lay.heads else None, None)
    elif name == "conv":
        core = (b, None, lay.tp if lay.ssm_heads else None)
    elif name == "ssm":
        core = (b, lay.tp if lay.ssm_heads else None, None, None)
    else:  # the xLSTM's per-block states (B, H, ...) or (B, E)
        core = (b, lay.tp if lay.heads else None) + (None,) * (ndim - 2)
    return (None,) * (ndim - len(core)) + core


def _reshard(t, mesh, have, want):
    """``t``, held under spec ``have``, cut to spec ``want``: every dim
    whose axes differ gathered over those it has, and only then each
    sliced over those it wants (outside autograd; no call where they
    agree)."""
    moved = [dim for dim, (h, w) in enumerate(zip(have, want))
             if A.spec_axes(h) != A.spec_axes(w)]
    for dim in moved:
        t = C.gather(t, mesh, have[dim], dim)
    for dim in moved:
        t = C.local_slice(t, mesh, want[dim], dim)
    return t


def placed_cache(lay: Layout, cfg, cache):
    """This rank's shard of a prefill's cache under ``serve_cache_specs``
    (the cache unchanged on one device). K and v leave as the forward
    computed them (its rows, its KV heads) but for their sequence, of
    which they keep the placement's slice; a state leaf is moved to the
    placement's layout (``_reshard``). ``batch`` and ``max_len`` (the
    self-attention's, 0 for the xLSTM) are the global sizes."""
    if lay.mesh is None:
        return cache
    group = _KV_GROUP.get(cfg.family)
    max_len = cache[group]["k"].shape[-3] if group else 0
    specs = _cache_specs(cfg, lay.rules, lay.global_batch, max_len)

    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        have, want = _held(lay, path, t.ndim), specs[path]
        if path[-1] in ("k", "v") and any(A.spec_axes(h) != A.spec_axes(w) for i, (h, w) in
                                          enumerate(zip(have, want)) if i != t.ndim - 3):
            raise AssertionError(f"cache spec {want} of {path} and the activations' {have} differ "
                                 "but for the sequence")
        return _reshard(t, lay.mesh, have, want)

    placed = unflatten((path, one(path, t)) for path, t in leaves(cache))
    return {**placed, "batch": lay.global_batch, "max_len": max_len}


def ring_of(lay: Layout, cfg, cache, group: str) -> dict:
    """``seq_lo`` and ``seq_axes`` of the k/v under ``cache[group]`` in a
    decode step: the axes the placement splits their sequence over, and
    the first position of this rank's slots (none on one device)."""
    if lay.mesh is None:
        return {}
    spec = _cache_specs(cfg, lay.rules, cache["batch"], cache["max_len"])[(group, "k")]
    axes = A.spec_axes(spec[-3])
    return {"seq_lo": C.axis_index(lay.mesh, axes) * cache[group]["k"].shape[-3],
            "seq_axes": axes}


def _state_specs(lay: Layout, cfg, cache, path, ndim: int):
    """(the placement's, the block's) spec of one layer's slice (``ndim``
    dims) of the state leaf at ``path``."""
    spec = _cache_specs(cfg, lay.rules, cache["batch"], cache["max_len"])[path]
    return spec[len(spec) - ndim:], _held(lay, path, len(spec))[len(spec) - ndim:]


def _to_block(lay: Layout, cfg, cache, path, t):
    """One layer's state ``t`` from the cache's placement to its block's."""
    if lay.mesh is None:
        return t
    table, held = _state_specs(lay, cfg, cache, path, t.ndim)
    return _reshard(t, lay.mesh, table, held)


def _to_cache(lay: Layout, cfg, cache, path, t):
    """One layer's new state ``t`` from its block's layout to the cache's."""
    if lay.mesh is None:
        return t
    table, held = _state_specs(lay, cfg, cache, path, t.ndim)
    return _reshard(t, lay.mesh, held, table)


def pad_kv(kv, max_len):
    """A ``{"k", "v"}`` pair of buffers (dim -3 = seq) padded with zeros
    up to ``max_len``."""
    s = kv["k"].shape[-3]
    if s >= max_len:
        return kv
    pad = (0, 0, 0, 0, 0, max_len - s)  # (D, KVH, S) from the last dim back
    return {n: F.pad(t, pad) for n, t in kv.items()}
