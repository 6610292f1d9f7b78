#!/usr/bin/env python3
"""Time every variant of the grouped GEMM's kernels on one GPU.

    python3 tools/gmm_variants.py [--json PATH] [--probes]
    python3 tools/gmm_variants.py --host [--src DIR] [--json PATH]

At deepseek-moe-16b's shapes, with group sizes from a random router as
``chip_smoke.py``'s phase 15 forms them (64 experts, top-6): the forward
at a serving prefill (4 x 128 tokens), a decode step (4 tokens) and a
training step (8 x 512 tokens; gate/up, down and both dX on the
weights' transposed views), and dW at the training step. Each variant is
forced through the wrapper's private ``_launch_forward`` or
``_launch_dw`` on the same inputs: ``wgmma`` with 64- and 128-row tiles,
and dW's ``wgmma`` with an f32 and a bf16 output. Each row: the variant
against the plain version (``chip_smoke.GMM_TOL``: 1e-5 of the largest
entry, plus one bf16 rounding of each entry of a bf16 output), ms per
call (CUDA-graph replay, inputs rotated over two sets), TFLOP/s, and beside them ``torch._grouped_mm`` and the call's
bound. ptxas's registers and spills of each grouped kernel.

``--probes`` then times the planned training forward (``wgmma``, 128-row
tiles, gate/up and down) as built; built from copies of
``csrc/grouped_matmul.cu`` with tiles 256 wide (``W_BN``) and without its
output stores (the epilogue's cost); and as built on group sizes of 384
rows each, three whole 128-row tiles (what the partial tiles of the
router's sizes cost).

``--host`` times instead the wrapper's host cost per call at the decode
shapes (4 tokens, top-6 of 64 experts; gate/up and down): the host time
per call of 200 back-to-back calls (20 for ``fma``), the median of 5
runs, the device left to run behind them (a decode call's device time,
~0.05 ms, exceeds the host's, so no call waits for the queue). Rows: the
planned call (``wgmma``: three tensor maps encoded a call), ``fma``
forced (no tensor maps) and the layout checks (``_tma``) alone. ``--src
DIR`` loads ``repro_torch`` from DIR (another tree's ``src``, as
``git archive`` unpacks it) and times its planned call, to hold one
wrapper against another in one run.
Needs a CUDA card, nvcc and ``chip_smoke.py`` beside this directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_VARIANTS = [("wgmma", 64), ("wgmma", 128)]
DW_VARIANTS = [("wgmma", torch.float32), ("wgmma", torch.bfloat16)]
MOE, DECODE_TOKENS = "deepseek-moe-16b", 4  # --host: chip_smoke.py's MOE and BATCH
cs = _build = ops = grouped_matmul_ref = grouped_matmul_dw_ref = None  # set by _load


def _load(src=None):
    """Import ``chip_smoke`` and the port's grouped GEMM into this module's
    globals; with ``src``, only the port, from that directory."""
    global cs, _build, ops, grouped_matmul_ref, grouped_matmul_dw_ref
    if src is None:
        sys.path.insert(0, ROOT)
        import chip_smoke
        cs = chip_smoke
    else:
        sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.grouped_matmul import grouped_matmul_dw_ref as dw_ref
    from repro_torch.kernels.grouped_matmul import grouped_matmul_ref as ref
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    _build, ops, grouped_matmul_ref, grouped_matmul_dw_ref = build, gmm_ops, ref, dw_ref


def ptxas_lines() -> list[str]:
    libs = _build.build_all()
    log = os.path.splitext(libs["grouped_matmul"])[0] + ".log"
    out, fn = [], ""
    for line in open(log):
        if "Compiling entry function" in line:
            fn = cs._kernel_tag(line.split("'")[1])
        elif "Used" in line or "spill" in line:
            out.append(f"{fn}: {line.strip().replace('ptxas info    : ', '')}")
    return out


def fwd_rows(gen, what, rows, k, n, sizes, transposed):
    g = len(sizes)

    def operands():
        x = torch.randn(rows, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(g, n, k, generator=gen, device="cuda") / k**0.5).to(torch.bfloat16)
        return x, (w.transpose(-1, -2) if transposed else w.reshape(g, k, n))

    sets = [operands(), operands()]
    x, w = sets[0]
    exact = grouped_matmul_ref(x.float(), w.float(), sizes)
    tol = cs.GMM_TOL * exact.abs().max() + 2.0**-8 * exact.abs()
    n_bytes, n_ops = cs.gmm_work(rows, k, n, sizes.cpu(), 2)
    bound, by = cs.bound_ms(n_bytes, n_ops, torch.bfloat16)
    planned = ops.plan(rows, g, torch.bfloat16, True)
    out = []
    for variant, bm in FWD_VARIANTS:
        got = ops._launch_forward(x, w, sizes, force=variant, bm=bm)
        ok = bool(((got.float() - exact).abs() <= tol).all()) and torch.equal(
            got, ops._launch_forward(x, w, sizes, force=variant, bm=bm))
        ms = cs.cuda_ms(lambda i: ops._launch_forward(sets[i][0], sets[i][1], sizes, force=variant,
                                                      bm=bm), 2)
        out.append({"what": what, "variant": variant, "bm": bm, "ok": ok, "ms": ms,
                    "tflops": n_ops / ms / 1e9, "bound_ms": bound, "bound_by": by,
                    "planned": planned.variant == variant and planned.bm == (bm or planned.bm)})
    offs = sizes.cumsum(0).to(torch.int32)
    lib = cs._library_ms(lambda i: torch._grouped_mm(sets[i][0], sets[i][1], offs=offs), what)
    for r in out:
        r["library_ms"] = lib
        print(f"[gmm] {what} ({rows}, {k}) x ({g}, {k}, {n}){' w^T' * transposed}: {r['variant']} "
              f"bm {r['bm']}: {r['ms']:.4f} ms ({r['tflops']:.0f} TFLOP/s), ok "
              f"{r['ok']}; torch._grouped_mm {lib}; bound {bound:.4f} ({by})", flush=True)
    return out


def dw_rows(gen, what, rows, k, n, sizes):
    sets = [(torch.randn(rows, k, generator=gen, device="cuda").to(torch.bfloat16),
             torch.randn(rows, n, generator=gen, device="cuda").to(torch.bfloat16))
            for _ in range(2)]
    x, dy = sets[0]
    exact = grouped_matmul_dw_ref(x, dy, sizes)
    out = []
    for variant, odt in DW_VARIANTS:
        got = ops._launch_dw(x, dy, sizes, force=variant, out_dtype=odt)
        f32 = ops._launch_dw(x, dy, sizes, force=variant)
        ok = (bool(((f32 - exact).abs() <= cs.GMM_TOL * exact.abs().max()).all())
              and torch.equal(got, f32.to(odt)))
        ms = cs.cuda_ms(lambda i: ops._launch_dw(sets[i][0], sets[i][1], sizes, force=variant,
                                                 out_dtype=odt), 2)
        es_out = torch.finfo(odt).bits // 8
        used = int(sizes.sum())
        n_bytes = 2 * used * (k + n) + es_out * len(sizes) * k * n
        n_ops = 2.0 * used * k * n
        bound, by = cs.bound_ms(n_bytes, n_ops, torch.bfloat16)
        out.append({"what": what, "variant": variant, "out": str(odt), "ok": ok,
                    "ms": ms, "tflops": n_ops / ms / 1e9, "bound_ms": bound, "bound_by": by})
    offs = sizes.cumsum(0).to(torch.int32)
    lib = cs._library_ms(lambda i: torch._grouped_mm(sets[i][0].T, sets[i][1], offs=offs), what)
    for r in out:
        r["library_ms"] = lib
        print(f"[gmm] {what} dW ({rows}, {k})^T x ({rows}, {n}): {r['variant']} "
              f"{r['out']}: {r['ms']:.4f} ms ({r['tflops']:.0f} TFLOP/s), ok {r['ok']}; "
              f"torch._grouped_mm {lib}; bound {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return out


# text edits of csrc/grouped_matmul.cu for --probes: the forward's stores
# from registers and its TMA stores (the staging is still written)
NO_STORES = [("          if (r < tl.r1 && n < N)\n", "          if (false)\n"),
             ("tma_store2d(&tout, stg + b * 8192, tl.n0 + 64 * b, r_w);", ";")]
WIDE = [("constexpr int W_BN = 128;", "constexpr int W_BN = 256;")]


def probe_lib(edits):
    """The grouped library built from a copy of csrc/ with ``edits`` ((old,
    new) pairs) applied to grouped_matmul.cu, loaded as ``ops._lib()``
    loads it."""
    tmp = tempfile.mkdtemp()
    for f in os.listdir(_build.CSRC):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(_build.CSRC, f), tmp)
    src = os.path.join(tmp, "grouped_matmul.cu")
    text = open(src).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"probe edit not found once: {old!r}")
        text = text.replace(old, new)
    with open(src, "w") as fh:
        fh.write(text)
    so = os.path.join(tmp, "grouped_matmul.so")
    subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-o", so, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    for fn, args in (("grouped_matmul_launch", ops._Args), ("grouped_matmul_dw_launch", ops._DwArgs)):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(args), ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def probes(gen, cfg, routes) -> list:
    e, f = cfg.d_model, cfg.expert_d_ff
    rt = int(routes.sum())
    whole = torch.full((cfg.n_experts,), rt // cfg.n_experts, dtype=torch.int32, device="cuda")
    built, wide, no_stores = ops._lib(), probe_lib(WIDE), probe_lib(NO_STORES)
    out = []
    for what, k, n in (("train gate/up", e, f), ("train down", f, e)):
        sets = [(torch.randn(rt, k, generator=gen, device="cuda").to(torch.bfloat16),
                 (torch.randn(cfg.n_experts, k, n, generator=gen, device="cuda") / k**0.5)
                 .to(torch.bfloat16)) for _ in range(2)]
        for name, lib, sizes in (("as built", built, routes), ("256-wide tiles", wide, routes),
                                 ("no output stores", no_stores, routes),
                                 ("groups of 3 x 128 rows", built, whole),
                                 ("as built", built, routes)):
            ops._LIB = lib
            ms = cs.cuda_ms(lambda i: ops._launch_forward(sets[i][0], sets[i][1], sizes,
                                                          force="wgmma", bm=128), 2)
            n_ops = 2.0 * int(sizes.sum()) * k * n
            out.append({"what": what, "probe": name, "ms": ms, "tflops": n_ops / ms / 1e9})
            print(f"[probe] {what} wgmma 128-row tiles, {name}: {ms:.4f} ms "
                  f"({n_ops / ms / 1e9:.0f} TFLOP/s)", flush=True)
    ops._LIB = built
    return out


def host_us(call, n=200, runs=5) -> float:
    """Median over ``runs`` of the host time a call of ``n`` back-to-back
    calls takes, in us, the device left to run behind them."""
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def host_rows(tree: str) -> list:
    """The wrapper's host cost per call at deepseek-moe-16b's decode
    shapes: the planned call, and where this tree's wrapper has them,
    ``fma`` forced and the layout checks alone."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE)
    e, f, g = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    cpu = torch.Generator().manual_seed(15)
    top = torch.randn(DECODE_TOKENS, g, generator=cpu).topk(cfg.top_k, dim=-1).indices
    sizes = torch.bincount(top.flatten(), minlength=g).to(torch.int32).cuda()
    rows, out = int(sizes.sum()), []
    for what, k, n in (("decode gate/up", e, f), ("decode down", f, e)):
        x = torch.randn(rows, k, generator=cpu).to(torch.bfloat16).cuda()
        w = (torch.randn(g, k, n, generator=cpu) / k**0.5).to(torch.bfloat16).cuda()
        before = dict(ops.grouped_matmul.variants)
        ops.grouped_matmul(x, w, sizes)
        planned = [v for v, c in ops.grouped_matmul.variants.items() if c != before[v]]
        row = {"tree": tree, "what": what, "planned": planned[0],
               "planned_us": host_us(lambda: ops.grouped_matmul(x, w, sizes))}
        if hasattr(ops, "_tma"):
            row["fma_us"] = host_us(lambda: ops._launch_forward(x, w, sizes, force="fma"), n=20)
            row["checks_us"] = host_us(lambda: ops._tma(x, 1, [0]) and ops._w_tma(w))
        out.append(row)
        print(f"[host] {tree} {what} ({rows}, {k}) x ({g}, {k}, {n}): planned {row['planned']} "
              f"{row['planned_us']:.2f} us a call"
              + (f", fma forced {row['fma_us']:.2f}, layout checks {row['checks_us']:.2f}"
                 if "fma_us" in row else ""), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="PATH", help="write every row as JSON")
    ap.add_argument("--probes", action="store_true",
                    help="then split the training forward's time (probes of the source)")
    ap.add_argument("--host", action="store_true",
                    help="time the wrapper's host cost per call at the decode shapes instead")
    ap.add_argument("--src", metavar="DIR", help="with --host: load repro_torch from DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[gmm] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    if args.src and not args.host:
        ap.error("--src needs --host")
    _load(args.src if args.host else None)
    if args.host:
        rows = host_rows(args.src or os.path.join(ROOT, "src"))
        if args.json:
            with open(args.json, "w") as fh:
                json.dump({"nvidia_smi": smi, "host": rows}, fh, indent=1)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    for line in ptxas_lines():
        print(f"[build] {line}")
    ops._lib()
    gen = torch.Generator(device="cuda").manual_seed(15)
    cfg = cs.get_config(cs.MOE)
    e, f = cfg.d_model, cfg.expert_d_ff
    routes = {tag: cs.moe_routes(gen, cfg, tokens) for tag, tokens in
              (("prefill", cs.BATCH * cs.PROMPT), ("decode", cs.BATCH),
               ("train", cs.TRAIN_BATCH * cs.TRAIN_SEQ))}
    rows = []
    for tag, sizes in routes.items():
        r = int(sizes.sum())
        rows += fwd_rows(gen, f"{tag} gate/up", r, e, f, sizes, False)
        rows += fwd_rows(gen, f"{tag} down", r, f, e, sizes, False)
    rt, st = int(routes["train"].sum()), routes["train"]
    rows += fwd_rows(gen, "train dX of gate/up", rt, f, e, st, True)
    rows += fwd_rows(gen, "train dX of down", rt, e, f, st, True)
    rows += dw_rows(gen, "train gate/up", rt, e, f, st)
    rows += dw_rows(gen, "train down", rt, f, e, st)
    probe_rows = probes(gen, cfg, st) if args.probes else []
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"nvidia_smi": smi, "rows": rows, "probes": probe_rows}, fh, indent=1)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
