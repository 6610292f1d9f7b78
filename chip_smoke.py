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
3. main path: ``serve_loop`` on smollm-135m at full width (batch 4,
   prompt 128, 32 tokens) with the launch counts set to 0 just before
   and read just after; every kernel must have launched;
4. kernels: calls each kernel's wrapper at the main path's shapes (and a
   few edge shapes), holds it against its plain PyTorch version on the
   same inputs with the tolerance stated beside each check, and times
   kernel, plain version and the one PyTorch call that computes the same
   function, next to the least time the card could take (bound);
5. end to end: the same weights and prompts through the port on the
   card and on the CPU (plain versions): prefill logits and 4
   teacher-forced decode steps must agree within the stated bf16 band;
6. profile: a few decode steps under ``torch.profiler`` give the device
   busy time per step and the idle share against the step time;
7. prints the kernels line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

``--details PATH`` also writes every measurement to a JSON file.
"""

from __future__ import annotations

import argparse
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
from repro_torch.kernels import _build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.dos_matmul import dos_matmul, matmul_ref  # noqa: E402
from repro_torch.kernels.dos_matmul import ops as dos_ops  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch.serve import serve_loop  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.params import map_tree  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a call
# is the larger of its bytes over HBM bandwidth and its operations over
# the peak rate of its type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
COLD_BYTES = 128 * 2**20  # rotate inputs over more than the 50 MB L2

# The main path: smollm-135m, batch 4, prompt 128, 32 generated tokens.
ARCH, BATCH, PROMPT, GEN = "smollm-135m", 4, 128, 32
E2E_DECODE_STEPS = 4
PROFILE_STEPS = 5
# bf16 band of the end-to-end check, as a fraction of max|logits|: both
# devices round activations to bf16 at the same points; only the GEMM
# summation order (and so an occasional 1-ulp flip, 2**-8 relative) and
# the attention kernel's f32 arithmetic order differ, and those flips
# propagate through 30 residual layers. 3e-2 is the repo's bf16 band
# (tests/test_kernel_flash.py).
E2E_TOL = 3e-2

RESULTS: dict = {"phases": {}}


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


def phase_main_path():
    cfg = get_config(ARCH)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    r = serve_loop(cfg, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, device="cuda")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gen_tokens = r["generated"]
    summary = {k: r[k] for k in ("prefill_s", "decode_s", "decode_tok_s", "step_p50_s",
                                 "step_p99_s", "launches")}
    summary.update(launches_total=counts, peak_mem_bytes=peak, mem_before_bytes=base,
                   n_params=build(cfg, "cuda").n_params)
    print(f"[main] serve_loop {ARCH} batch {BATCH} prompt {PROMPT} gen {GEN} on "
          f"{r['device']['kind']}: prefill {r['prefill_s']*1e3:.2f} ms, decode "
          f"{r['decode_tok_s']:.1f} tok/s, step p50 {r['step_p50_s']*1e3:.3f} ms, "
          f"p99 {r['step_p99_s']*1e3:.3f} ms, peak memory {peak / 2**20:.1f} MiB "
          f"({base / 2**20:.1f} MiB allocated before the run)", flush=True)
    print(f"[main] launches: prefill {r['launches']['prefill']}, decode "
          f"{r['launches']['decode']}, total {counts}", flush=True)
    check(tuple(gen_tokens.shape) == (BATCH, GEN), f"generated shape {tuple(gen_tokens.shape)}")
    check(bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab)).all()), "token outside vocab")
    check(r["launches"]["prefill"]["dos_matmul"] > 0, "dos_matmul never launched in prefill")
    check(r["launches"]["decode"]["dos_matmul"] > 0, "dos_matmul never launched in decode")
    check(r["launches"]["prefill"]["flash_attention"] > 0, "flash never launched in prefill")
    check(all(n > 0 for n in counts.values()), f"a kernel never launched: {counts}")
    RESULTS["main_path"] = summary
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


def phase_kernels():
    cfg = get_config(ARCH)
    e, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, h, kvh = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    gen = torch.Generator(device="cuda").manual_seed(0)
    # one layer's GEMMs (q, k, v, o, gate, up, down) and the unembed, as (K, N, count)
    layer = [(e, h * hd, 2), (e, kvh * hd, 2), (e, f, 2), (f, e, 1)]
    rows = {"dos_matmul": [], "flash_attention": []}
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "ops": 0.0,
                  "bytes": 0.0} for k in rows}
    main_err = {k: 0.0 for k in rows}

    def add(kernel, row, count):
        rows[kernel].append(dict(row, calls_per_prefill_and_step=count))
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops"):
            totals[kernel][key] += count * row[key]
        main_err[kernel] = max(main_err[kernel], row["max_abs_err"])

    for m, per_layer in ((BATCH * PROMPT, cfg.n_layers), (BATCH, cfg.n_layers)):
        for k, n, count in layer:
            add("dos_matmul", check_gemm(gen, m, k, n, torch.bfloat16), count * per_layer)
        add("dos_matmul", check_gemm(gen, m, e, v, torch.bfloat16, b_transposed=True), 1)
    for m in (BATCH * PROMPT, BATCH):  # the same shapes in f32 (reduced configs' dtype)
        for k, n, _ in layer:
            check_gemm(gen, m, k, n, torch.float32, time_it=False)
        check_gemm(gen, m, e, v, torch.float32, b_transposed=True, time_it=False)
    for dtype in (torch.bfloat16, torch.float32):
        check_gemm(gen, 37, 200, 130, dtype, time_it=False)  # ragged on every side
        check_gemm(gen, 37, 200, 130, dtype, b_transposed=True, time_it=False)

    main = check_flash(gen, BATCH, PROMPT, PROMPT, h, kvh, hd, torch.bfloat16,
                       window=2**30, time_it=True)  # the global layers' sentinel
    add("flash_attention", main, cfg.n_layers)
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32:
            check_flash(gen, BATCH, PROMPT, PROMPT, h, kvh, hd, dtype)
        check_flash(gen, BATCH, 200, 200, h, kvh, hd, dtype)  # ragged
        check_flash(gen, BATCH, PROMPT, PROMPT, h, kvh, hd, dtype, window=32)
        check_flash(gen, 2, PROMPT, PROMPT, 4, 1, 256, dtype)  # gemma3's D, MQA
        check_flash(gen, 2, 64, 200, 4, 2, 32, dtype, q_offset=136)  # queries at the end
        check_flash(gen, 2, 64, 64, 4, 4, 128, dtype, causal=False, window=2**30)
        check_flash(gen, 1, 70, 70, 2, 1, 64, dtype, window=0)  # no visible key: mean(v)

    RESULTS["kernel_rows"] = rows
    RESULTS["kernel_totals"] = totals
    return totals, main_err


# ---------------------------------------------------------------------------
# phase 5: end to end against the plain path on the CPU
# ---------------------------------------------------------------------------


def phase_e2e():
    cfg = get_config(ARCH)
    mc, mg = build(cfg, "cpu"), build(cfg, "cuda")
    params_c = mc.compute_params(mc.init(torch.Generator().manual_seed(0)))
    params_g = map_tree(lambda t: t.to("cuda"), params_c)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    max_len = PROMPT + E2E_DECODE_STEPS + PROFILE_STEPS + 2
    lg, cg = mg.prefill(params_g, {"tokens": prompts}, max_len=max_len)
    lc, cc = mc.prefill(params_c, {"tokens": prompts}, max_len=max_len)
    worst = 0.0
    for step in range(E2E_DECODE_STEPS + 1):
        ref, got = lc.float(), lg.float().cpu()
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        worst = max(worst, rel)
        what = "prefill" if step == 0 else f"decode step {step}"
        print(f"[e2e] {what}: max|logits card - cpu| / max|cpu| = {rel:.3g} "
              f"(band {E2E_TOL})", flush=True)
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits on the card")
        check(rel <= E2E_TOL, f"{what}: card and CPU logits differ by {rel:.3g}")
        if step == E2E_DECODE_STEPS:
            break
        tok = lg[:, -1:].argmax(dim=-1)  # teacher-forced on the card's tokens
        lg, cg = mg.decode(params_g, cg, {"token": tok})
        lc, cc = mc.decode(params_c, cc, {"token": tok.cpu()})
    RESULTS["e2e_max_rel_logit_err"] = worst
    return mg, params_g, cg, lg[:, -1:].argmax(dim=-1)


# ---------------------------------------------------------------------------
# phase 6: where a decode step's time goes (torch.profiler)
# ---------------------------------------------------------------------------


def phase_profile(model, params, cache, tok, step_p50_s):
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
        print("[profile] the profiler recorded no device time: idle share not measured")
        RESULTS["profile"] = None
        return
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    busy_ms = busy / 1e3 / PROFILE_STEPS
    idle = 1.0 - busy_ms / (step_p50_s * 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] decode step: device busy {busy_ms:.3f} ms of a {step_p50_s*1e3:.3f} ms "
          f"step (p50 without profiler): idle share {idle:.3f}; {len(spans) / PROFILE_STEPS:.0f} "
          f"device ops per step", flush=True)
    for name, us in top:
        print(f"[profile]   {us / PROFILE_STEPS:9.1f} us/step  {name[:90]}")
    RESULTS["profile"] = {"busy_ms_per_step": busy_ms, "idle_share": idle,
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
    counts, step_p50_s = phase_main_path()  # first, so nothing else holds memory
    totals, main_err = phase_kernels()
    phase_profile(*phase_e2e(), step_p50_s)

    replaces = {
        "dos_matmul": ("src/repro_torch/kernels/csrc/dos_matmul.cu",
                       "src/repro/kernels/dos_matmul/kernel.py:83"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:147"),
    }
    kernels = []
    for kname, (source, repl) in replaces.items():
        tot = totals[kname]
        by_bytes = tot["bytes"] / HBM_BYTES_S >= tot["ops"] / PEAK_OPS_S[torch.bfloat16]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": repl,
            "launches": counts[kname], "max_abs_err": main_err[kname],
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
    print(f"[done] {RESULTS['wall_s']:.1f} s; the kernels' ms, plain_ms, library_ms and "
          "bound_ms sum the main path's calls of one prefill plus one decode step")
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
