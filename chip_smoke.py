#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which ends the run
with a non-zero exit (and without the final ``{"ok": true, ...}`` line)
if it fails:

1. device: a CUDA card must be present; prints its name, count,
   ``nvidia-smi`` name and power limit, and the torch/CUDA versions;
2. build: compiles every kernel of ``src/repro_torch/kernels/csrc`` with
   nvcc (one process per source, in parallel) and loads them;
3. main paths, each with the launch counts set to 0 just before and
   read just after: ``serve_loop`` on smollm-135m (dense) and on
   zamba2-2.7b (hybrid: Mamba2 + shared attention), both at full width
   and depth (batch 4, prompt 128, 32 tokens). Each path must launch
   each of its kernels exactly as often as its layers call it, and the
   two paths together every registered kernel;
4. kernels: calls each kernel's wrapper at the main paths' shapes (and
   a few edge shapes), holds it against its plain PyTorch version on the
   same inputs with the tolerance stated beside each check, and times
   kernel, plain version and the one PyTorch call that computes the same
   function (where there is one), next to the least time the card could
   take (bound);
5. card against CPU (plain versions), the same weights and prompts:
   smollm-135m end to end in bf16 (prefill logits and 4 teacher-forced
   decode steps within the bf16 band); zamba2-2.7b at full width with
   its depth cut to 2 groups (so the CPU side stays short), block by
   block in bf16 (every Mamba2 block, shared-block call and the head of
   the prefill and of 4 decode steps, each fed the CPU's inputs and
   states, within the bf16 band) and end to end in f32. The random-weight
   hybrid amplifies rounding differences ~100x over 2 groups (the CPU's
   own bf16 and f32 logits differ by O(1)), so two bf16 runs that round
   in different orders cannot agree end to end; the script prints that
   difference too;
6. profile, per path: a few decode steps under ``torch.profiler`` give
   the device busy time per step and the idle share against the main
   path's step time;
7. prints the kernels line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

``--details PATH`` also writes every measurement to a JSON file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import KERNELS, _build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.dos_matmul import dos_matmul, matmul_ref  # noqa: E402
from repro_torch.kernels.dos_matmul import ops as dos_ops  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import CHUNK, CHUNKS, ssm_scan, ssm_scan_chunked  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.launch.serve import serve_loop  # noqa: E402
from repro_torch.models import build, decoder  # noqa: E402
from repro_torch.models.params import map_tree  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a call
# is the larger of its bytes over HBM bandwidth and its operations over
# the peak rate of its type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
COLD_BYTES = 128 * 2**20  # rotate inputs over more than the 50 MB L2

# The main paths: smollm-135m (dense) and zamba2-2.7b (hybrid), each at
# batch 4, prompt 128, 32 generated tokens.
ARCH, HYBRID, BATCH, PROMPT, GEN = "smollm-135m", "zamba2-2.7b", 4, 128, 32
PATHS = (ARCH, HYBRID)
E2E_DECODE_STEPS = 4
# zamba2's end-to-end check against the CPU keeps full width but 2 of
# its 9 groups (12 Mamba2 layers, 2 shared-block calls) at batch 2.
HYBRID_E2E_LAYERS, HYBRID_E2E_BATCH = 12, 2
PROFILE_STEPS = 5
# bf16 band of the end-to-end check, as a fraction of max|logits|: both
# devices round activations to bf16 at the same points; only the GEMM
# summation order (and so an occasional 1-ulp flip, 2**-8 relative) and
# the attention kernel's f32 arithmetic order differ, and those flips
# propagate through 30 residual layers. 3e-2 is the repo's bf16 band
# (tests/test_kernel_flash.py).
E2E_TOL = 3e-2
# f32 band of zamba2's end-to-end check: each block differs between the
# devices by ~1e-5 of its scale (summation order), and the random-weight
# hybrid amplifies a perturbation ~100x over 2 groups (a 1e-6 relative
# change of the embedding moves its f32 logits by ~1e-4), so ~1e-3; 1e-2
# leaves room for the decode steps. A wrong mask, state or layout moves
# the logits by the order of their scale.
E2E_F32_TOL = 1e-2

RESULTS: dict = {"phases": {}, "main_paths": {}, "profile": {}}


class Failure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise Failure(what)


def cuda_ms(fn, n_sets: int) -> float:
    """Mean device ms per call of ``fn(i)``. The calls cycle over
    ``n_sets`` input sets (so each finds its inputs outside L2, as on the
    serve path) and are replayed from a CUDA graph, so the host's launch
    rate does not enter the time."""
    iters = max(50, n_sets)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs need
        for i in range(3):
            fn(i % n_sets)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_sets)
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device is available")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} x{count}; nvidia-smi: {smi_line}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    RESULTS["device"] = {"kind": name, "count": count, "nvidia_smi": smi_line,
                         "torch": torch.__version__, "cuda": torch.version.cuda}
    return name, count, smi_line


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    dos_ops._lib()
    flash_ops._lib()
    ssm_ops._lib()
    dt = time.perf_counter() - t0
    print(f"[build] {len(libs)} kernels built and loaded in {dt:.1f} s", flush=True)
    for name, path in libs.items():
        log = os.path.splitext(path)[0] + ".log"
        if os.path.isfile(log):
            for line in open(log):
                if "Used" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")
    RESULTS["phases"]["build_s"] = dt


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def expected_launches(cfg) -> dict:
    """Kernel launches of one prefill (and of each decode step) as the
    layers call them: a GEMM per projection, one flash call per
    attention layer in prefill, one scan per Mamba2 layer in prefill."""
    head = 1  # the unembedding, tied or not
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every  # shared-block calls
        n_mamba = n_attn * cfg.attn_every
        gemms = 6 * n_mamba + 7 * n_attn + head  # wx wz wB wC wdt wo; q k v o gate up down
    else:
        n_attn, n_mamba = cfg.n_layers, 0
        gemms = 7 * n_attn + head
    prefill = {"dos_matmul": gemms, "flash_attention": n_attn, "ssm_scan": n_mamba}
    step = {"dos_matmul": gemms, "flash_attention": 0, "ssm_scan": 0}
    return {"prefill": prefill, "decode": {k: n * (GEN - 1) for k, n in step.items()}}


def phase_main_path(arch):
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    r = serve_loop(cfg, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, device="cuda")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gen_tokens = r["generated"]
    summary = {k: r[k] for k in ("init_s", "prefill_s", "decode_s", "decode_tok_s",
                                 "step_p50_s", "step_p99_s", "launches")}
    summary.update(launches_total=counts, peak_mem_bytes=peak, mem_before_bytes=base,
                   n_params=build(cfg, "cuda").n_params)
    print(f"[main] serve_loop {arch} ({summary['n_params']:,} parameters) batch {BATCH} prompt "
          f"{PROMPT} gen {GEN} on {r['device']['kind']}: init {r['init_s']:.2f} s, prefill "
          f"{r['prefill_s']*1e3:.2f} ms, decode {r['decode_tok_s']:.1f} tok/s, step p50 "
          f"{r['step_p50_s']*1e3:.3f} ms, p99 {r['step_p99_s']*1e3:.3f} ms, peak memory "
          f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB allocated before the run)", flush=True)
    print(f"[main] {arch} launches: prefill {r['launches']['prefill']}, decode "
          f"{r['launches']['decode']}, total {counts}", flush=True)
    check(tuple(gen_tokens.shape) == (BATCH, GEN), f"generated shape {tuple(gen_tokens.shape)}")
    check(bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab)).all()), "token outside vocab")
    want = expected_launches(cfg)
    check(r["launches"] == want, f"{arch}: launches {r['launches']}, expected {want}")
    check(all(counts[k] > 0 for k, n in want["prefill"].items() if n),
          f"{arch}: a kernel of the path never launched: {counts}")
    RESULTS["main_paths"][arch] = summary
    return counts, r["step_p50_s"]


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def _gemm_case(gen, m, k, n, dtype, b_transposed, n_sets):
    """Operand sets for a GEMM; the transposed case is the tied unembed
    (B = tok.T, a strided view of the (N, K) embedding table)."""
    sets = []
    for _ in range(n_sets):
        a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        if b_transposed:
            b = torch.randn(n, k, generator=gen, device="cuda").to(dtype).T
        else:
            b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
        sets.append((a, b))
    return sets


def check_gemm(gen, m, k, n, dtype, b_transposed=False, time_it=True):
    es = 2 if dtype == torch.bfloat16 else 4
    n_sets = max(1, math.ceil(COLD_BYTES / ((m * k + k * n) * es))) if time_it else 1
    sets = _gemm_case(gen, m, k, n, dtype, b_transposed, n_sets)
    a, b = sets[0]
    out = dos_matmul(a, b, out_dtype=dtype)
    plain = matmul_ref(a, b, dtype)
    exact = matmul_ref(a, b, torch.float32)  # f32 sums of the same operands
    torch.cuda.synchronize()
    err = (out.float() - exact).abs()
    scale = exact.abs().max().item()
    # f32: only the summation order differs -> 1e-5 of the largest entry.
    # bf16 output: plus one rounding to bf16 -> 2**-8 of each entry.
    tol = (2.0**-8 * exact.abs() if dtype == torch.bfloat16 else 0.0) + 1e-5 * scale
    ok = bool((err <= tol).all())
    row = {"m": m, "k": k, "n": n, "dtype": str(dtype).split(".")[-1],
           "b_transposed": b_transposed, "max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "max_abs_err_vs_f32": err.max().item(), "max_ref": scale, "ok": ok}
    if time_it:
        row["bytes"], row["ops"] = (m * k + k * n + m * n) * es, 2.0 * m * n * k
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"], dtype)
        row["ms"] = cuda_ms(lambda i: dos_matmul(*sets[i], out_dtype=dtype), len(sets))
        row["plain_ms"] = cuda_ms(lambda i: matmul_ref(*sets[i], dtype), len(sets))
        row["library_ms"] = cuda_ms(lambda i: torch.matmul(*sets[i]), len(sets))
    print(f"[kernels] dos_matmul {m}x{k}x{n} {row['dtype']}{' B^T' if b_transposed else ''}: "
          f"max|err| vs f32 {row['max_abs_err_vs_f32']:.3g} (max|ref| {scale:.3g}) "
          + (f"kernel {row['ms']*1e3:.1f} us, plain {row['plain_ms']*1e3:.1f} us, "
             f"torch.matmul {row['library_ms']*1e3:.1f} us, bound {row['bound_ms']*1e3:.2f} us "
             f"({row['bound_by']})" if time_it else "")
          + ("" if ok else "  FAIL"), flush=True)
    check(ok, f"dos_matmul {m}x{k}x{n} {dtype} disagrees with its plain version")
    return row


def _visible_pairs(sq, skv, causal, window, q_offset):
    n = 0
    for i in range(sq):
        p = i + q_offset
        lo = max(0, p - window + 1) if window is not None else 0
        hi = min(skv, p + 1) if causal else skv
        n += max(0, hi - lo)
    return n


def check_flash(gen, b, sq, skv, h, kvh, d, dtype, causal=True, window=None, q_offset=0,
                time_it=False):
    per_set = (b * sq * h + 2 * b * skv * kvh) * d * (2 if dtype == torch.bfloat16 else 4)
    n_sets = max(1, math.ceil(COLD_BYTES / per_set)) if time_it else 1
    sets = [tuple(torch.randn(b, s, hh, d, generator=gen, device="cuda").to(dtype)
                  for s, hh in ((sq, h), (skv, kvh), (skv, kvh))) for _ in range(n_sets)]
    q, k, v = sets[0]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_attention(q, k, v, **kw)
    plain = attention_ref(q, k, v, **kw)
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err = (out.float() - exact).abs()
    # f32 math on both sides -> 1e-5 absolute (|v| is O(1)); a bf16
    # output adds one rounding: 2**-8 of each entry.
    tol = (2.0**-8 * exact.abs() if dtype == torch.bfloat16 else 0.0) + 1e-5
    ok = bool((err <= tol).all())
    tag = (f"B{b} Sq{sq} Skv{skv} H{h}/{kvh} D{d} {str(dtype).split('.')[-1]} "
           f"causal={causal} window={window} q_offset={q_offset}")
    row = {"case": tag, "max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "max_abs_err_vs_f32": err.max().item(), "ok": ok}
    if time_it:
        es = 2 if dtype == torch.bfloat16 else 4
        check(causal and q_offset == 0 and (window or skv) >= skv,
              "the library yardstick (sdpa) covers plain causal attention only")
        pairs = _visible_pairs(sq, skv, causal, window, q_offset)
        row["bytes"] = (2 * b * sq * h + 2 * b * skv * kvh) * d * es
        row["ops"] = 4.0 * b * h * d * pairs
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"], dtype)
        row["ms"] = cuda_ms(lambda i: flash_attention(*sets[i], **kw), n_sets)
        row["plain_ms"] = cuda_ms(lambda i: attention_ref(*sets[i], **kw), n_sets)

        def sdpa(i):
            q_, k_, v_ = (t.transpose(1, 2) for t in sets[i])
            return F.scaled_dot_product_attention(q_, k_, v_, is_causal=causal,
                                                  enable_gqa=True)

        row["library_ms"] = cuda_ms(sdpa, n_sets)
    print(f"[kernels] flash_attention {tag}: max|err| vs f32 {row['max_abs_err_vs_f32']:.3g} "
          + (f"kernel {row['ms']*1e3:.1f} us, plain {row['plain_ms']*1e3:.1f} us, "
             f"sdpa {row['library_ms']*1e3:.1f} us, bound {row['bound_ms']*1e3:.2f} us "
             f"({row['bound_by']})" if time_it else "")
          + ("" if ok else "  FAIL"), flush=True)
    check(ok, f"flash_attention {tag} disagrees with its plain version")
    return row


def _ssm_set(gen, bt, s, h, p, n, dtype, shared_bc):
    """Scan inputs as Mamba2 makes them: u, B, C in ``dtype``; ld in f32,
    dt * A with dt = softplus(normal) and A = -[1..H] (zamba2's init), so
    the heads run from light decay to ~-50 per step; and with
    ``shared_bc`` one B, C per step expanded over the heads."""
    u = torch.randn(bt, s, h, p, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(bt, s, h, generator=gen, device="cuda"))
    ld = -dt * torch.arange(1, h + 1, device="cuda", dtype=torch.float32)
    nb = 1 if shared_bc else h
    B, C = (torch.randn(bt, s, nb, n, generator=gen, device="cuda").to(dtype)
            .expand(bt, s, h, n) for _ in range(2))
    return u, ld, B, C


def ssm_work(bt, s, h, p, n, es, shared_bc, chunk):
    """Bytes of a scan (each input read once: B, C once per step when
    broadcast over the heads; y and the f32 state written once) and the
    operations the chunked algorithm needs: per chunk of t steps the
    lower triangle of C B^T and of G U, C S_prev (not in the first chunk,
    whose S_prev is zero) and the state update."""
    nb = 1 if shared_bc else h
    n_bytes = 2 * bt * s * h * p * es + bt * s * h * 4 + 2 * bt * s * nb * n * es + bt * h * n * p * 4
    ops = 0
    for c0 in range(0, s, chunk):
        t = min(chunk, s - c0)
        tri = t * (t + 1) // 2
        ops += 2 * (tri * n + tri * p + t * n * p * (2 if c0 else 1))
    return n_bytes, float(ops * bt * h)


def check_ssm(gen, bt, s, h, p, n, dtype, shared_bc=True, chunk=CHUNK, time_it=False):
    es = 2 if dtype == torch.bfloat16 else 4
    n_bytes, n_ops = ssm_work(bt, s, h, p, n, es, shared_bc, chunk)
    n_sets = max(1, math.ceil(COLD_BYTES / n_bytes)) if time_it else 1
    sets = [_ssm_set(gen, bt, s, h, p, n, dtype, shared_bc) for _ in range(n_sets)]
    u, ld, B, C = sets[0]
    y, st = ssm_scan(u, ld, B, C, chunk=chunk)
    py, pst = ssm_scan_chunked(u, ld, B, C, chunk)
    ey, est = ssm_scan_chunked(u.float(), ld, B.float(), C.float(), chunk)  # f32 of the same operands
    torch.cuda.synchronize()
    yerr, serr = (y.float() - ey).abs(), (st - est).abs()
    # f32: the summation order over T*N terms and the chunk's cumulative
    # log-decay, summed in another order inside the exp -> 1e-4 of the
    # largest entry; a bf16 y adds one rounding: 2**-8 of each entry.
    ytol = 1e-4 * ey.abs().max() + (2.0**-8 * ey.abs() if dtype == torch.bfloat16 else 0.0)
    ok = bool((yerr <= ytol).all()) and bool((serr <= 1e-4 * est.abs().max()).all())
    tag = (f"Bt{bt} S{s} H{h} P{p} N{n} {str(dtype).split('.')[-1]} chunk {chunk}"
           f"{' B/C broadcast' if shared_bc else ''}")
    row = {"case": tag, "max_abs_err": max((y.float() - py.float()).abs().max().item(),
                                           (st - pst).abs().max().item()),
           "max_abs_err_vs_f32": max(yerr.max().item(), serr.max().item()),
           "max_ref": max(ey.abs().max().item(), est.abs().max().item()), "ok": ok}
    if time_it:
        row["bytes"], row["ops"] = n_bytes, n_ops
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, dtype)
        row["ms"] = cuda_ms(lambda i: ssm_scan(*sets[i], chunk=chunk), n_sets)
        row["plain_ms"] = cuda_ms(lambda i: ssm_scan_chunked(*sets[i], chunk), n_sets)
        row["library_ms"] = None  # no single PyTorch call computes the scan
    print(f"[kernels] ssm_scan {tag}: max|err| vs f32 {row['max_abs_err_vs_f32']:.3g} "
          f"(max|ref| {row['max_ref']:.3g}) "
          + (f"kernel {row['ms']*1e3:.1f} us, plain {row['plain_ms']*1e3:.1f} us, "
             f"bound {row['bound_ms']*1e3:.2f} us ({row['bound_by']})" if time_it else "")
          + ("" if ok else "  FAIL"), flush=True)
    check(ok, f"ssm_scan {tag} disagrees with its plain version")
    return row


def path_gemms(cfg) -> dict:
    """{(K, N, B transposed): calls per prefill and per decode step} of a
    path's projections and its unembedding."""
    e, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    calls = expected_launches(cfg)["prefill"]
    n_attn, n_mamba = calls["flash_attention"], calls["ssm_scan"]
    out: dict = {}
    shapes = [(e, q, n_attn), (e, kv, 2 * n_attn), (q, e, n_attn), (e, f, 2 * n_attn),
              (f, e, n_attn)]
    if n_mamba:
        di = cfg.ssm_expand * e
        shapes += [(e, di, 2 * n_mamba), (e, cfg.ssm_state, 2 * n_mamba),
                   (e, di // cfg.ssm_head_dim, n_mamba), (di, e, n_mamba)]
    for k, n, count in shapes + [(e, v, 1)]:
        key = (k, n, cfg.tie_embeddings and (k, n) == (e, v))
        out[key] = out.get(key, 0) + count
    return out


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"dos_matmul": [], "flash_attention": [], "ssm_scan": []}
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "ops": 0.0,
                  "bytes": 0.0} for k in rows}
    main_err = {k: 0.0 for k in rows}

    def add(kernel, row, count, path):
        rows[kernel].append(dict(row, path=path, calls_per_prefill_and_step=count))
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops"):
            if row[key] is None or totals[kernel][key] is None:
                totals[kernel][key] = None
            else:
                totals[kernel][key] += count * row[key]
        main_err[kernel] = max(main_err[kernel], row["max_abs_err"])

    for arch in PATHS:
        cfg = get_config(arch)
        gemms = path_gemms(cfg)
        for m in (BATCH * PROMPT, BATCH):
            for (k, n, tr), count in gemms.items():
                add("dos_matmul", check_gemm(gen, m, k, n, torch.bfloat16, b_transposed=tr),
                    count, arch)
        for m in (BATCH * PROMPT, BATCH):  # the same shapes in f32 (reduced configs' dtype)
            for (k, n, tr) in gemms:
                check_gemm(gen, m, k, n, torch.float32, b_transposed=tr, time_it=False)
    for dtype in (torch.bfloat16, torch.float32):
        check_gemm(gen, 37, 200, 130, dtype, time_it=False)  # ragged on every side
        check_gemm(gen, 37, 200, 130, dtype, b_transposed=True, time_it=False)

    cfg = get_config(ARCH)
    hd, h, kvh = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    main = check_flash(gen, BATCH, PROMPT, PROMPT, h, kvh, hd, torch.bfloat16,
                       window=2**30, time_it=True)  # the global layers' sentinel
    add("flash_attention", main, cfg.n_layers, ARCH)
    hcfg = get_config(HYBRID)
    hh, hkvh, hhd = hcfg.n_heads, hcfg.n_kv_heads, hcfg.head_dim_
    calls = expected_launches(hcfg)["prefill"]
    add("flash_attention", check_flash(gen, BATCH, PROMPT, PROMPT, hh, hkvh, hhd, torch.bfloat16,
                                       time_it=True), calls["flash_attention"], HYBRID)
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32:
            check_flash(gen, BATCH, PROMPT, PROMPT, h, kvh, hd, dtype)
            check_flash(gen, BATCH, PROMPT, PROMPT, hh, hkvh, hhd, dtype)  # zamba2's D 80
        check_flash(gen, BATCH, 200, 200, h, kvh, hd, dtype)  # ragged
        check_flash(gen, BATCH, PROMPT, PROMPT, h, kvh, hd, dtype, window=32)
        check_flash(gen, 2, PROMPT, PROMPT, 4, 1, 256, dtype)  # gemma3's D, MQA
        check_flash(gen, 2, 64, 200, 4, 2, 32, dtype, q_offset=136)  # queries at the end
        check_flash(gen, 2, 64, 64, 4, 4, 128, dtype, causal=False, window=2**30)
        check_flash(gen, 1, 70, 70, 2, 1, 64, dtype, window=0)  # no visible key: mean(v)
        check_flash(gen, 2, 90, 90, 4, 4, 80, dtype, window=16)  # D 80, ragged, window

    # zamba2's prefill scan: u (Bt, S, H, P) bf16, ld f32, B/C broadcast over the heads
    sh = (BATCH, PROMPT, hcfg.ssm_expand * hcfg.d_model // hcfg.ssm_head_dim,
          hcfg.ssm_head_dim, hcfg.ssm_state)
    by_chunk = {c: check_ssm(gen, *sh, torch.bfloat16, chunk=c, time_it=True) for c in CHUNKS}
    add("ssm_scan", by_chunk[CHUNK], calls["ssm_scan"], HYBRID)
    RESULTS["ssm_scan_by_chunk"] = by_chunk
    for dtype in (torch.bfloat16, torch.float32):
        for c in CHUNKS:
            if dtype == torch.float32:
                check_ssm(gen, *sh, dtype, chunk=c)
            check_ssm(gen, 2, 200, 8, 64, 64, dtype, chunk=c)  # ragged S
            check_ssm(gen, 2, 20, 8, 64, 64, dtype, shared_bc=False, chunk=c)  # S < T
            check_ssm(gen, 1, 512, 8, 64, 64, dtype, chunk=c)  # many chunks
            check_ssm(gen, 2, 40, 16, 16, 16, dtype, shared_bc=False, chunk=c)  # N = P = 16
            check_ssm(gen, 1, 100, 2, 192, 96, dtype, shared_bc=False, chunk=c)  # P tiles, N 96

    RESULTS["kernel_rows"] = rows
    RESULTS["kernel_totals"] = totals
    return totals, main_err


# ---------------------------------------------------------------------------
# phase 5: end to end against the plain path on the CPU
# ---------------------------------------------------------------------------


def _e2e_setup(arch, dtype=None):
    """The path's config as the card-vs-CPU checks run it (zamba2 with its
    depth and batch cut), CPU and card models, the CPU's parameters and
    the prompts."""
    cfg, batch = get_config(arch), BATCH
    if cfg.family == "hybrid":
        cfg, batch = dataclasses.replace(cfg, n_layers=HYBRID_E2E_LAYERS), HYBRID_E2E_BATCH
    if dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    mc, mg = build(cfg, "cpu"), build(cfg, "cuda")
    params_c = mc.compute_params(mc.init(torch.Generator().manual_seed(0)))
    prompts = torch.randint(0, cfg.vocab, (batch, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    return cfg, batch, mc, mg, params_c, prompts


def phase_e2e(arch, dtype=None, tol=E2E_TOL):
    """Card against CPU end to end: prefill logits and E2E_DECODE_STEPS
    teacher-forced decode steps. Returns what the profile of a decode
    step needs (the card's model, parameters, cache and next token) and
    the CPU's prefill logits."""
    cfg, batch, mc, mg, params_c, prompts = _e2e_setup(arch, dtype)
    params_g = map_tree(lambda t: t.to("cuda"), params_c)
    max_len = PROMPT + E2E_DECODE_STEPS + PROFILE_STEPS + 2
    lg, cg = mg.prefill(params_g, {"tokens": prompts}, max_len=max_len)
    lc, cc = mc.prefill(params_c, {"tokens": prompts}, max_len=max_len)
    lc0, worst = lc, 0.0
    for step in range(E2E_DECODE_STEPS + 1):
        ref, got = lc.float(), lg.float().cpu()
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        worst = max(worst, rel)
        what = "prefill" if step == 0 else f"decode step {step}"
        print(f"[e2e] {cfg.name} ({cfg.n_layers} layers, batch {batch}, {cfg.compute_dtype}) "
              f"{what}: max|logits card - cpu| / max|cpu| = {rel:.3g} (band {tol})", flush=True)
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits on the card")
        check(rel <= tol, f"{what}: card and CPU logits differ by {rel:.3g}")
        if step == E2E_DECODE_STEPS:
            break
        tok = lg[:, -1:].argmax(dim=-1)  # teacher-forced on the card's tokens
        lg, cg = mg.decode(params_g, cg, {"token": tok})
        lc, cc = mc.decode(params_c, cc, {"token": tok.cpu()})
    RESULTS.setdefault("e2e_max_rel_logit_err", {})[f"{arch} {cfg.compute_dtype}"] = worst
    return (mg, params_g, cg, lg[:, -1:].argmax(dim=-1)), lc0


_BLOCKS = ("mamba_block", "_attn_mlp_block", "unembed")  # the decoder's blocks, by name


def _tree(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return tree


def recorded_blocks(run):
    """Run ``run()`` with the decoder's blocks recorded: returns its result
    and every call as (name, function, args, kwargs, output). The state
    and cache arguments are copied before each call (decode writes them
    in place); weights and activations are not modified and are kept."""
    calls, originals = [], {n: getattr(decoder, n) for n in _BLOCKS}

    def hook(name):
        fn = originals[name]

        def recorded(*args, **kwargs):
            kept = {k: _tree(torch.clone, v) if k in ("state", "cache") else v
                    for k, v in kwargs.items()}
            out = fn(*args, **kwargs)
            calls.append((name, fn, args, kept, out))
            return out

        return recorded

    for n in _BLOCKS:
        setattr(decoder, n, hook(n))
    try:
        result = run()
    finally:
        for n, fn in originals.items():
            setattr(decoder, n, fn)
    return result, calls


def phase_e2e_blocks(arch):
    """Card against CPU block by block: the CPU runs the prefill and
    E2E_DECODE_STEPS teacher-forced decode steps; every call of a Mamba2
    block, of the shared block and of the head is run again on the card
    with the CPU's inputs and states, and each output (the block's
    output, and a Mamba2 block's new SSM and conv states) must agree
    within the bf16 band of the CPU's. Returns the CPU's prefill logits."""
    cfg, batch, mc, _, params_c, prompts = _e2e_setup(arch)

    def run():
        lc, cc = mc.prefill(params_c, {"tokens": prompts}, max_len=PROMPT + E2E_DECODE_STEPS)
        first = lc
        for _ in range(E2E_DECODE_STEPS):
            lc, cc = mc.decode(params_c, cc, {"token": lc[:, -1:].argmax(dim=-1)})
        return first

    lc0, calls = recorded_blocks(run)
    worst: dict = {}
    for name, fn, args, kwargs, out in calls:
        got = fn(*_tree(lambda t: t.to("cuda"), args),
                 **_tree(lambda t: t.to("cuda"), kwargs))
        if name == "mamba_block":
            pairs = {"out": (got[0], out[0]), "ssm state": (got[1]["ssm"], out[1]["ssm"]),
                     "conv state": (got[1]["conv"], out[1]["conv"])}
        elif name == "_attn_mlp_block":
            pairs = {"out": (got[0], out[0])}
        else:
            pairs = {"logits": (got, out)}
        mode = kwargs["mode"] if "mode" in kwargs else (
            "prefill" if out.shape[1] > 1 else "decode")
        for what, (g, c) in pairs.items():
            c = c.float()
            rel = (g.float().cpu() - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
            check(bool(torch.isfinite(g).all()), f"{name} {what}: non-finite on the card")
            check(rel <= E2E_TOL, f"{arch} {mode} {name} {what}: card and CPU differ by {rel:.3g}")
            key = f"{mode} {name.strip('_')} {what}"
            worst[key] = max(worst.get(key, 0.0), rel)
    print(f"[e2e] {cfg.name} ({cfg.n_layers} layers, batch {batch}, {cfg.compute_dtype}) block "
          f"by block, {len(calls)} calls over the prefill and {E2E_DECODE_STEPS} decode steps; "
          f"worst max|card - cpu| / max|cpu| (band {E2E_TOL}):", flush=True)
    for key, rel in worst.items():
        print(f"[e2e]   {key}: {rel:.3g}")
    RESULTS.setdefault("e2e_blocks", {})[arch] = worst
    return lc0


def full_depth_decode_state(arch):
    """The path's full model with weights drawn on the card (fast; the
    values do not change the work) after a prefill of the main path's
    shape: what the profile of its decode step needs."""
    model = build(get_config(arch), "cuda")
    params = model.compute_params(model.init(torch.Generator(device="cuda").manual_seed(0)))
    prompts = torch.randint(0, model.cfg.vocab, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  max_len=PROMPT + PROFILE_STEPS + 2)
    return model, params, cache, logits[:, -1:].argmax(dim=-1)


# ---------------------------------------------------------------------------
# phase 6: where a decode step's time goes (torch.profiler)
# ---------------------------------------------------------------------------


def phase_profile(arch, model, params, cache, tok, step_p50_s):
    """Device busy time per decode step, from the profiler's kernel
    records (merged intervals), and the idle share it implies against the
    step time measured without the profiler (the main path's p50)."""
    from torch.profiler import ProfilerActivity, profile

    model.decode(params, cache, {"token": tok})  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            logits, cache = model.decode(params, cache, {"token": tok})
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t0, t1 = evt.time_range.start, evt.time_range.end
            spans.append((t0, t1))
            by_name[evt.name] = by_name.get(evt.name, 0.0) + (t1 - t0)
    if not spans:
        print(f"[profile] {arch}: the profiler recorded no device time: idle share not measured")
        RESULTS["profile"][arch] = None
        return
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    busy_ms = busy / 1e3 / PROFILE_STEPS
    idle = 1.0 - busy_ms / (step_p50_s * 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {arch} decode step: device busy {busy_ms:.3f} ms of a {step_p50_s*1e3:.3f} ms "
          f"step (p50 without profiler): idle share {idle:.3f}; {len(spans) / PROFILE_STEPS:.0f} "
          f"device ops per step", flush=True)
    for name, us in top:
        print(f"[profile]   {us / PROFILE_STEPS:9.1f} us/step  {name[:90]}")
    RESULTS["profile"][arch] = {"busy_ms_per_step": busy_ms, "idle_share": idle,
                          "device_ops_per_step": len(spans) / PROFILE_STEPS,
                          "top_us_per_step": {n: us / PROFILE_STEPS for n, us in top}}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--details", metavar="PATH", help="write every measurement as JSON")
    details = ap.parse_args(argv).details
    t0 = time.perf_counter()
    name, count, smi_line = phase_device()
    phase_build()
    counts, step_p50_s = {}, {}
    for arch in PATHS:  # first, so nothing else holds memory
        counts[arch], step_p50_s[arch] = phase_main_path(arch)
    launched = {k for c in counts.values() for k, n in c.items() if n > 0}
    check(launched == set(KERNELS), f"kernels no main path launched: {set(KERNELS) - launched}")
    totals, main_err = phase_kernels()
    phase_profile(ARCH, *phase_e2e(ARCH)[0], step_p50_s[ARCH])
    bf16_logits = phase_e2e_blocks(HYBRID)
    f32_logits = phase_e2e(HYBRID, "float32", E2E_F32_TOL)[1]
    sens = ((bf16_logits.float() - f32_logits).abs().max() / f32_logits.abs().max()).item()
    print(f"[e2e] {HYBRID} ({HYBRID_E2E_LAYERS} layers): the CPU's own bf16 and f32 prefill "
          f"logits differ by {sens:.3g} of max|logits| (the model's sensitivity to rounding)")
    RESULTS["hybrid_cpu_bf16_vs_f32"] = sens
    phase_profile(HYBRID, *full_depth_decode_state(HYBRID), step_p50_s[HYBRID])

    replaces = {
        "dos_matmul": ("src/repro_torch/kernels/csrc/dos_matmul.cu",
                       "src/repro/kernels/dos_matmul/kernel.py:83"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:147"),
        "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:104"),
    }
    kernels = []
    for kname, (source, repl) in replaces.items():
        tot = totals[kname]
        by_bytes = tot["bytes"] / HBM_BYTES_S >= tot["ops"] / PEAK_OPS_S[torch.bfloat16]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": repl,
            "launches": sum(c[kname] for c in counts.values()), "max_abs_err": main_err[kname],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": tot["library_ms"],
        })
    RESULTS["kernels"] = kernels
    RESULTS["wall_s"] = time.perf_counter() - t0
    if details:
        os.makedirs(os.path.dirname(os.path.abspath(details)), exist_ok=True)
        with open(details, "w") as f:
            json.dump(RESULTS, f, indent=1)
    print(f"[done] {RESULTS['wall_s']:.1f} s; the kernels' launches sum both main paths' "
          "runs; ms, plain_ms, library_ms and bound_ms sum both main paths' calls of one "
          "prefill plus one decode step")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
