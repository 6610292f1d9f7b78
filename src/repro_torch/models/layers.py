"""Shared transformer layers: norms, RoPE, attention, MLP, embeddings.

Functions on tensors, ``(params, x, ...) -> y``, with params described
by ParamDef trees, as in the JAX package. Every GEMM goes through
``proj`` and so through the dOS matmul kernel on the card; prefill and
training attention go through the flash kernel. All of them are
differentiable: in training the GEMMs and attention run through the
kernels' autograd Functions. ``attention`` is the reference's universal
block: causal self-attention with or without rope (whisper's decoder
passes ``theta=None``), bidirectional (``causal=False``, whisper's
encoder) and cross-attention to keys and values that
``compute_cross_kv`` projects once from an outside source (the vision
model's image embeddings, whisper's encoder output). ``mlp`` is the
gated-silu MLP or the plain 2-layer gelu one (whisper), as its tree's
keys say. The MoE family's expert FFN is ``models/moe.py``.

**Sharding.** ``proj``, ``rmsnorm``, ``embed_tokens``, ``unembed``,
``attention``, ``compute_cross_kv`` and ``mlp`` take a ``Layout``: what
one rank of a (data, model) mesh holds and computes. The default,
``ONE``, is one device's; every collective then spans one rank and
returns its input with no call, so the functions launch what they
launched before sharding existed. Every family runs on a mesh of several
ranks (``decoder.layout``). Each rank holds exactly the shards of the
weights and the cache that the reference's placement gives it; FSDP
shards (the batch axes' entries of a weight's spec) are gathered one
layer at a time, just before the layer uses them, and their gradients
leave by reduce-scatter (``Layout.gather``).

Tensor parallelism runs over ``model`` (none under ``zero``, whose batch
spans the whole mesh). Every GEMM is ``dos_matmul`` on the local
operands (``proj``):

- a weight sharded on its contraction axis (``dos``; megatron's
  out-projections) multiplies this rank's K-slice of the input into an
  f32 partial, and the partials are summed over ``model`` in f32 and
  only then cast, as the reference accumulates in f32 before its cast:
  by all-reduce, or by reduce-scatter onto the next GEMM's contraction
  axis (the dOS "optimized pile");
- a weight sharded on its output axis (megatron's in-projections)
  multiplies the whole input into this rank's output columns;
- a replicated weight (the reference's fallback where a shard does not
  divide) multiplies the whole input.

Activations take a simpler layout than the reference's ``act_spec``
where the result is the same: the last dim of each is either whole or
split evenly over ``model``. The residual is split on E under ``dos``
(``act_spec("residual")``, where E divides), with ``rmsnorm``
all-reducing its sum of squares; attention runs on this rank's heads
when the KV heads divide ``model`` (so every local query head's KV head
is local), else on all heads on every rank; the MLP hidden is split on F
and the logits on the vocab where they divide. The vocab-sharded table
looks up the rows it holds, masks the others and all-reduces. A cache
sharded on its sequence (the "ring": the KV heads do not divide
``model``, or the batch does not divide the data axes) is attended to
slice by slice, and the slices' softmaxes are merged by their
log-sum-exps; so is a cross-attention cache placed that way (the vision
model's one KV head).

Autograd: a tensor that is the same on every rank of the group but that
a rank uses for its own slice only (B and C of Mamba2 beside its local
heads, a bias or a gate on the E-split residual) passes through
``collectives.copy_to`` or ``split``, so its gradient is summed over the
group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import decode_attention, dos_matmul, flash_attention
from ..parallel import collectives as C
from ..parallel.axes import spec_axes
from .params import ParamDef, leaves, unflatten

__all__ = [
    "Layout", "ONE", "proj", "rmsnorm", "rmsnorm_def", "rope", "embed_defs", "embed_tokens",
    "unembed", "attn_defs", "compute_cross_kv", "attention", "mlp_defs", "mlp",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """What one rank holds and computes in one run (``ONE``: one device)."""

    rules: object = None  # the sharding rules (None: one device)
    mesh: object = None
    specs: dict = dataclasses.field(default_factory=dict)  # every leaf's spec, by path
    dims: dict = dataclasses.field(default_factory=dict)  # (group, name) -> a weight's TP dim
    tp: tuple = ()        # the tensor-parallel axes: ("model",), or () under zero
    m: int = 1            # ranks along them
    batch: tuple = ()     # the axes the activations' batch is split over
    all_batch: tuple = ()  # the rules' batch axes (the loss is averaged over them)
    global_batch: int = 0
    resid: bool = False   # the residual split on E
    heads: bool = False   # attention on this rank's heads
    hidden: bool = False  # the MLP hidden split on F
    vocab: bool = False   # logits split on the vocab
    ssm_heads: bool = False  # Mamba2 on this rank's heads (and its Di channels)
    expert_hidden: bool = False  # the routed experts' hidden split on expert_ff
    fsdp: bool = False    # some leaf sharded over other axes than the TP ones

    def dim(self, group, name):
        """The dim of weight ``group/name`` that tensor parallelism shards
        (0: contraction, 1: output), or None."""
        return self.dims.get((group, name))

    def splits(self, n: int) -> bool:
        """Whether a dim of ``n`` splits evenly over the tensor-parallel
        ranks (False under ``zero`` and on one device)."""
        return bool(self.tp) and n % self.m == 0

    def gather(self, tree, root):
        """``tree`` (the parameters' subtree at path ``root``, a key or a
        tuple of keys, or a layer's slice of it, or a leaf) with its FSDP
        shards gathered; the tensor-parallel shards stay."""
        if not self.fsdp:
            return tree
        root = root if isinstance(root, tuple) else (root,)

        def one(path, t):
            spec = self.specs[path]
            spec = spec[len(spec) - t.ndim:] if spec else spec  # a layer's slice drops "layers"
            for dim, part in enumerate(spec):
                if part is not None and not (self.tp and part == "model"):
                    t = C.gather_params(t, self.mesh, part, dim)
            return t

        if isinstance(tree, torch.Tensor):
            return one(root, tree)
        return unflatten((path[len(root):], one(path, t)) for path, t in leaves(tree, root))

    def batch_slice(self, x):
        """This rank's rows of a global batch tensor (B, ...)."""
        return C.local_slice(x, self.mesh, self.batch, 0)

    def reduce_grads(self, grads):
        """Each gradient summed over the batch axes its leaf is not sharded
        over (an FSDP leaf's reduce-scatter summed it already)."""
        if self.mesh is None:
            return grads

        def one(path, g):
            held = {a for part in self.specs[path] for a in spec_axes(part)}
            return C.psum(g, self.mesh, tuple(a for a in self.all_batch if a not in held))

        return unflatten((path, one(path, g)) for path, g in leaves(grads))


ONE = Layout()


def proj(x, w, b=None, lay: Layout = ONE, wdim=None, x_split: bool = False,
         out_split: bool = False, mm=None):
    """x (..., K) @ w (K, N) in compute dtype, f32 accumulation, by
    ``mm(x, w, out_dtype=...)``: ``dos_matmul`` (the default), or the MoE
    experts' ``grouped_matmul`` with its group sizes bound (w (G, K, N)).

    The weight is cast to the compute dtype here, as the reference's
    ``astype`` does on every call: in training ``w`` is the f32 master
    and its gradient passes back through the cast. Serving casts once at
    load (``Model.compute_params``), which gives the same values and
    saves a read, a write and a cast per call; for a weight already in
    x's dtype ``.to`` returns it unchanged.

    On a mesh the operands are this rank's: ``x_split`` says that x holds
    its slice of K's columns, ``wdim`` which dim of w is split over
    ``lay``'s tensor-parallel ranks (None: replicated); the result holds
    its slice of N if ``out_split``, else all of N."""
    dt = x.dtype
    w = w.to(dt)
    mesh, tp, mm = lay.mesh, lay.tp, mm or dos_matmul
    if wdim == 0:  # the paper's pile: K-slice partials summed in f32
        y = mm(x if x_split else C.split(x, mesh, tp), w, out_dtype=torch.float32)
        y = (C.reduce_scatter(y, mesh, tp) if out_split else C.all_reduce(y, mesh, tp)).to(dt)
    elif wdim == 1:  # column-parallel
        xf = C.all_gather(x, mesh, tp) if x_split else x
        y = mm(C.copy_to(xf, mesh, tp), w, out_dtype=dt)
        if not out_split:
            y = C.all_gather(y, mesh, tp)
    else:
        y = mm(C.all_gather(x, mesh, tp) if x_split else x, w, out_dtype=dt)
        if out_split:
            y = C.split(y, mesh, tp)
    if b is not None:
        b = b.to(dt)
        y = y + (C.split(b, mesh, tp) if out_split else b)
    return y


# --- norms ---------------------------------------------------------------


def rmsnorm_def(dim: int, axes=("embed",)):
    return ParamDef((dim,), axes, init="ones")


def rmsnorm(x, scale, eps: float = 1e-6, lay: Layout = ONE, x_split: bool = False):
    """``x_split``: x holds this rank's slice of E (the sum of squares is
    all-reduced over ``lay``'s tensor-parallel ranks)."""
    xf = x.float()
    if not x_split:
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
    # the sum feeds this rank's slice only: copy_to sums its gradient's parts
    ss = C.copy_to(C.all_reduce((xf * xf).sum(dim=-1, keepdim=True), lay.mesh, lay.tp),
                   lay.mesh, lay.tp)
    var = ss / (xf.shape[-1] * lay.m)
    return (xf * torch.rsqrt(var + eps) * C.split(scale, lay.mesh, lay.tp).float()).to(x.dtype)


# --- rotary embeddings -----------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (S,) tensor or an int (decode)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -torch.log(torch.full((), theta, dtype=torch.float32, device=x.device))
        * (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    )
    if isinstance(positions, int):
        ang = (freqs * float(positions))[None, :]  # (1, half)
    else:
        ang = positions.float()[:, None] * freqs  # (S, half)
    cos = torch.cos(ang)[:, None, :]  # (S, 1, half)
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- embeddings -------------------------------------------------------------


def embed_defs(cfg):
    defs = {"tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef(
            (cfg.d_model, cfg.vocab), ("embed", "vocab"), contract=0, out=1
        )
    return defs


def embed_tokens(p, tokens, compute_dtype, lay: Layout = ONE):
    """Token embeddings (B, S, E), split on E if ``lay.resid``. A
    vocab-sharded table looks up its own rows, masks the rest and sums
    over ``model`` (one nonzero term per entry: exact)."""
    mesh, tp, tok = lay.mesh, lay.tp, p["tok"]
    if lay.dim("embed", "tok") == 0:
        rows = tok.shape[0]
        local = tokens - C.axis_index(mesh, tp) * rows
        mine = (local >= 0) & (local < rows)
        e = torch.where(mine[..., None], F.embedding(torch.where(mine, local, 0), tok), 0.0)
        e = C.reduce_scatter(e, mesh, tp) if lay.resid else C.all_reduce(e, mesh, tp)
        return e.to(compute_dtype)
    # the backward of F.embedding (torch's embedding backward) gave the same
    # bits in two runs on the card: chip_smoke.py phase 12's restart check
    # holds the resumed losses to an uninterrupted run's bit for bit
    e = F.embedding(tokens, tok).to(compute_dtype)
    return C.split(e, mesh, tp) if lay.resid else e


def unembed(p, x, tie: bool, lay: Layout = ONE):
    """Logits in f32, split on the vocab if ``lay.vocab``. The tied head
    is the transposed embedding, passed to the matmul kernel as a strided
    view (no copy)."""
    if tie:
        dim = lay.dim("embed", "tok")
        w, wdim = p["tok"].T, (None if dim is None else 1 - dim)
    else:
        w, wdim = p["head"], lay.dim("embed", "head")
    return proj(x, w, None, lay, wdim, lay.resid, lay.vocab).float()


# --- attention ---------------------------------------------------------------


def attn_defs(cfg):
    e, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    defs = {
        "wq": ParamDef((e, h * hd), ("embed", "heads_flat"), contract=0, out=1),
        "wk": ParamDef((e, kvh * hd), ("embed", "heads_flat"), contract=0, out=1),
        "wv": ParamDef((e, kvh * hd), ("embed", "heads_flat"), contract=0, out=1),
        "wo": ParamDef((h * hd, e), ("heads_flat", "embed"), contract=0, out=1),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * hd,), ("heads_flat",), init="zeros")
        defs["bk"] = ParamDef((kvh * hd,), ("heads_flat",), init="zeros")
        defs["bv"] = ParamDef((kvh * hd,), ("heads_flat",), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_def(hd, ("head_dim",))
        defs["k_norm"] = rmsnorm_def(hd, ("head_dim",))
    return defs


def compute_cross_kv(p, kv_src, cfg, lay: Layout = ONE, group: str = "attn"):
    """Project a cross-attention source (image embeddings, encoder
    output) (B, Skv, E) to ``(k, v)``, each (B, Skv, KVH, D): once at
    prefill, read from the cache by every decode step. ``proj`` casts the
    weights to the source's dtype, as the reference's does. On a mesh
    (``lay``) the source is split on E as the residual is, and k and v
    hold this rank's KV heads if attention runs on them; ``group`` names
    the weights' subtree (``attn``, whisper's ``xattn``)."""
    b, skv, _ = kv_src.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    if lay.heads:
        kvh //= lay.m

    def kv(name):
        return proj(kv_src, p[name], p.get("b" + name[1]), lay, lay.dim(group, name), lay.resid,
                    lay.heads).reshape(b, skv, kvh, hd)

    return kv("wk"), kv("wv")


def attention(p, x, cfg, *, mode: str, window=None, theta=None, cache=None, cross_kv=None,
              causal: bool = True, lay: Layout = ONE, group: str = "attn"):
    """The universal attention block. Returns (y, new_cache).

    ``mode`` is ``train`` (whole sequence, no cache: new_cache is None),
    ``prefill`` (whole prompt; the new cache holds its k, v) or
    ``decode`` (one token; ``cache`` is ``{"k", "v", "length"}`` with
    (B, S_max, KVH, D) buffers that this step writes slot ``length`` of
    in place, where the reference returns an updated copy). ``theta``
    None applies no rope. With ``cross_kv`` (k, v) the block attends to
    them, every key visible (no mask, no window, no rope); q is normed if
    ``cfg.qk_norm``, k is not, as in the reference; a cross block returns
    no cache.

    On a mesh (``lay``) x is split on E if ``lay.resid`` and the block
    runs on this rank's heads if ``lay.heads``; a decode cache sharded on
    its sequence also holds ``seq_lo`` (the first position of this rank's
    slots) and ``seq_axes`` (the axes it is split over). A cross decode
    step's ``cache`` may hold ``seq_axes`` alone: the axes its cross k, v
    are split over on their sequence. ``group`` names the weights'
    subtree (``attn``, whisper's ``xattn``)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: one of train, prefill, decode")
    if lay.heads:
        h, kvh = h // lay.m, kvh // lay.m

    def qkv(name, n):
        return proj(x, p[name], p.get("b" + name[1]), lay, lay.dim(group, name), lay.resid,
                    lay.heads).reshape(b, s, n, hd)

    q = qkv("wq", h)
    if cross_kv is None:
        k, v = qkv("wk", kvh), qkv("wv", kvh)
    else:
        k, v = cross_kv
    if cfg.qk_norm:  # one scale for every head: on local heads, its gradient sums over them
        qn, kn = p["q_norm"], p["k_norm"]
        if lay.heads:
            qn, kn = C.copy_to(qn, lay.mesh, lay.tp), C.copy_to(kn, lay.mesh, lay.tp)
        q = rmsnorm(q, qn, cfg.norm_eps)
        if cross_kv is None:
            k = rmsnorm(k, kn, cfg.norm_eps)

    new_cache = None
    if cross_kv is not None:
        if mode == "decode":
            o = _ring_decode(lay, q, k, v, k.shape[1], None, (cache or {}).get("seq_axes", ()))
        else:
            o = flash_attention(q, k, v, causal=False, window=None)
    elif mode == "decode":
        if cache is None or s != 1:
            raise ValueError("decode takes one token and a cache")
        length = cache["length"]
        if theta is not None:
            q = rope(q, length, theta)
            k = rope(k, length, theta)
        kc, vc = cache["k"], cache["v"]
        lo, seq_axes = cache.get("seq_lo", 0), cache.get("seq_axes", ())
        slot = length - lo
        if not seq_axes or 0 <= slot < kc.shape[1]:  # the rank holding the slot writes it
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
        o = _ring_decode(lay, q, kc, vc, slot + 1, window, seq_axes)
        new_cache = {"k": kc, "v": vc, "length": length + 1}
    else:
        if theta is not None:
            positions = torch.arange(s, device=x.device)
            q = rope(q, positions, theta)
            k = rope(k, positions, theta)
        o = flash_attention(q, k, v, causal=causal, window=window)
        if mode == "prefill":
            new_cache = {"k": k, "v": v, "length": s}

    y = proj(o.reshape(b, s, h * hd), p["wo"], None, lay, lay.dim(group, "wo"), lay.heads,
             lay.resid)
    return y, new_cache


def _ring_decode(lay: Layout, q, kc, vc, length, window, seq_axes):
    """Decode attention over this rank's cache slots (positions shifted
    so that slot 0 is the rank's first); over a sequence-sharded cache,
    each rank's softmax is merged with the others' by its log-sum-exp."""
    if C.axis_size(lay.mesh, seq_axes) == 1:
        return decode_attention(q, kc, vc, length=length, window=window)
    o, lse = decode_attention(q, kc, vc, length=length, window=window, return_lse=True)
    top = C.all_reduce_max(lse, lay.mesh, seq_axes)
    w = torch.exp(lse - top)  # 0 on a rank with no visible slot
    num = C.all_reduce(o * w[..., None], lay.mesh, seq_axes)
    den = C.all_reduce(w, lay.mesh, seq_axes)
    return (num / den[..., None]).to(q.dtype)


# --- MLP -----------------------------------------------------------------------


def mlp_defs(cfg, d_ff=None, act=None):
    e = cfg.d_model
    f = d_ff or cfg.d_ff
    act = act or cfg.act
    if act == "silu":  # gated (llama family)
        return {
            "wi_gate": ParamDef((e, f), ("embed", "mlp"), contract=0, out=1),
            "wi_up": ParamDef((e, f), ("embed", "mlp"), contract=0, out=1),
            "wo": ParamDef((f, e), ("mlp", "embed"), contract=0, out=1),
        }
    return {  # plain 2-layer (whisper)
        "wi": ParamDef((e, f), ("embed", "mlp"), contract=0, out=1),
        "bi": ParamDef((f,), ("mlp",), init="zeros"),
        "wo": ParamDef((f, e), ("mlp", "embed"), contract=0, out=1),
        "bo": ParamDef((e,), ("embed",), init="zeros"),
    }


def mlp(p, x, lay: Layout = ONE, group: str = "ffn", hidden: bool | None = None):
    """The gated-silu MLP (llama family) if the tree has ``wi_gate``, else
    the plain 2-layer MLP with the tanh form of gelu (``jax.nn.gelu``'s
    default). The tree's keys pick the form, as in the reference, whose
    ``act`` argument picks nothing. On a mesh (``lay``) x and the result
    are split on E if ``lay.resid``, the hidden on F if ``hidden``
    (default ``lay.hidden``; the MoE's shared experts give their own F's);
    ``group`` names the weights' subtree. The gelu MLP's ``bo`` is added
    once, after the row-parallel or K-split sum (``proj``)."""
    hidden = lay.hidden if hidden is None else hidden

    def up(name, b=None):
        return proj(x, p[name], b, lay, lay.dim(group, name), lay.resid, hidden)

    def down(h, b=None):
        return proj(h, p["wo"], b, lay, lay.dim(group, "wo"), hidden, lay.resid)

    if "wi_gate" in p:
        return down(F.silu(up("wi_gate")) * up("wi_up"))
    return down(F.gelu(up("wi", p["bi"]), approximate="tanh"), p["bo"])
