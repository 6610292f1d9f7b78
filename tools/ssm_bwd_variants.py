#!/usr/bin/env python3
"""Time variants of the ssm_scan backward's mma kernel on one GPU.

    python3 tools/ssm_bwd_variants.py [--json PATH] [--only NAME ...] [--also FILE ...]

Each variant is a list of text edits of ``csrc/ssm_scan_bwd.cu`` as
committed (``VARIANTS`` below): the design choices of the ``mma`` kernel,
each undone or pushed further, or a part of its work left out to see what
it costs. Every variant is compiled with the port's nvcc flags (all in
parallel), loaded in place of the built library, and called through
``ssm_scan_bwd``'s own wrapper at zamba2-2.7b's training shape (Bt 8, S
512, H 80, P = N = 64, chunk 32, bf16, B and C shared by the heads), with
the heads' dB and dC summed on chip (a cluster of 8 heads) and, as a
second row, per head: its gradients against ``ssm_scan_bwd_ref`` on the
f32 result of the same operands (``chip_smoke.py``'s gate; variants marked
"times only" change the arithmetic and fail it), ms per call (CUDA-graph
replay, inputs rotated through more than L2) and the kernel's device ms
(``chip_smoke.device_ms_per_call``). Needs a CUDA card, nvcc and
``chip_smoke.py`` beside this directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_ref  # noqa: E402

ONE_TERM = [("constexpr int B_TERMS = 2;", "constexpr int B_TERMS = 1;")]
NO_GA = [("if (q % R_WARPS != rw) continue;  // warp-uniform", "continue;")]
# S_c read at the start of the tile that uses it, not a chunk ahead
LATE_SC = [("      if (rw < NTILE && c > 0) load_sc(c - 1, rw, scv);  // in flight through the next "
            "chunk\n", ""),
           ("        if (mt != rw) load_sc(c, mt, scv);\n", "        load_sc(c, mt, scv);\n")]
# the slices sent and awaited, the owners' sums left out
NO_REDUCE = [("idx < T * 4; idx += 32 * R_WARPS) {", "idx < 0; idx += 32 * R_WARPS) {")]
# expf, the accurate exponential, in place of exp2f of a scaled argument
EXPF = [("__device__ __forceinline__ float fexp(float x) { return exp2f(x * LOG2E); }",
         "__device__ __forceinline__ float fexp(float x) { return expf(x); }")]
# the cluster's wait at the start of the second phase, not just before the sends
WAIT = ("      if (cl > 1 && c < nchunks - 1) cluster_wait();  // every block has read the chunk "
        "after's\n")
EARLY_WAIT = [(WAIT + "      for (int mt = warp; mt < NTILE; mt += C_WARPS) send(0, mt);\n",
               "      for (int mt = warp; mt < NTILE; mt += C_WARPS) send(0, mt);\n"),
              ("      block_sync();  // (2) G, A, dS's terms and a's sums are in\n",
               "      block_sync();  // (2) G, A, dS's terms and a's sums are in\n"
               "      if (cl > 1 && c < nchunks - 1) cluster_wait();\n"),
              (WAIT + "      for (int mt = rw; mt < NTILE; mt += R_WARPS) send(1, mt);\n",
               "      for (int mt = rw; mt < NTILE; mt += R_WARPS) send(1, mt);\n"),
              ("      block_sync();  // (2)\n",
               "      block_sync();  // (2)\n      if (cl > 1 && c < nchunks - 1) cluster_wait();\n")]
NO_DS_UPDATE = [("            mma_bf16(dS[j], af, bf[0], bf[1]);\n"
                 "            mma_bf16(dS[j + 1], af, bf[2], bf[3]);\n", "")]
NO_DLD = [("      if (rw == 0 && c + 1 < nchunks) finish_dld(c + 1);\n", "")]

VARIANTS = {
    "as built": [],
    "one term (times only)": ONE_TERM,
    "no G/A blocks (times only)": NO_GA,
    "S_c read in its chunk": LATE_SC,
    "cluster wait at the second phase's start": EARLY_WAIT,
    "expf": EXPF,
    "no cluster sum (times only)": NO_REDUCE,
    "no dS update (times only)": NO_DS_UPDATE,
    "no d(ld) pass (times only)": NO_DLD,
}

def build(tmp, variants, also=()):
    """{variant: loaded library}, every variant compiled at once (and each
    source of ``also`` as it is, named by its path); ptxas's register and
    spill lines of the mma kernel at T 32, N 64 by variant."""
    src = open(os.path.join(_build.CSRC, "ssm_scan_bwd.cu")).read()
    procs = {}
    todo = [(name, src, edits) for name, edits in variants.items()]
    todo += [(path, open(path).read(), []) for path in also]
    for i, (name, text, edits) in enumerate(todo):
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: an edit does not match the source once")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", _build.CSRC, "-o", cu[:-3] + ".so", cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), cu[:-3] + ".so")
    libs, regs = {}, {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} does not build:\n{out[-4000:]}")
        lines = out.splitlines()
        for k, line in enumerate(lines):
            if "ssd_bwd_mmaILi32ELi64E" in line:
                regs[name] = " ".join(x.strip().replace("ptxas info    : ", "")
                                      for x in lines[k + 1:k + 3])
        lib = ctypes.CDLL(so)
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        fn = lib.ssm_scan_bwd_launch
        fn.argtypes = ssm_ops._bwd_lib().ssm_scan_bwd_launch.argtypes
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", metavar="PATH", help="write the rows as JSON")
    ap.add_argument("--only", nargs="*", metavar="NAME", help="the variants to time (default all)")
    ap.add_argument("--also", nargs="*", default=[], metavar="FILE",
                    help="other versions of the source, timed as they are beside the variants")
    args = ap.parse_args(argv)
    variants = {k: v for k, v in VARIANTS.items() if not args.only or k in args.only}
    chip_smoke.phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        libs, regs = build(tmp, variants, args.also)
        gen = torch.Generator(device="cuda").manual_seed(20)
        bt, s, h, p, n, chunk = 8, 512, 80, 64, 64, 32
        n_bytes, _ = chip_smoke.ssm_bwd_work(bt, s, h, p, n, 2, True, chunk, False)
        sets = []
        for _ in range(max(1, math.ceil(chip_smoke.COLD_BYTES / n_bytes))):
            u, ld, Bh, Ch = chip_smoke._ssm_set(gen, bt, s, h, p, n, torch.bfloat16, True)
            dy = torch.randn(bt, s, h, p, generator=gen, device="cuda").to(torch.bfloat16)
            _, _, states = ssm_ops._forward(u, ld, Bh, Ch, chunk, with_states=True)
            sets.append((u, ld, Bh, Ch, dy, None, states, chunk))
        u, ld, Bh, Ch, dy, _, states, _ = sets[0]
        exact = ssm_scan_bwd_ref(u.float(), ld, Bh.float(), Ch.float(), dy.float(), None, chunk)
        exact = (*exact[:2], exact[2].sum(2, keepdim=True), exact[3].sum(2, keepdim=True))
        built = ssm_ops._BWD_LIB
        rows = []
        try:
            for rep in range(2):  # the variants in turn, twice
                for name, lib in libs.items():
                    ssm_ops._BWD_LIB = lib
                    for shared in (True, False):
                        def call(i, shared=shared):
                            return ssm_ops._backward(*sets[i % len(sets)], shared=shared)

                        du, dld, dB, dC = call(0)
                        got = (du, dld, dB.sum(2, keepdim=True).to(torch.bfloat16),
                               dC.sum(2, keepdim=True).to(torch.bfloat16))
                        worst = 0.0
                        for g, x, rounded in zip(got, exact, (True, False, True, True)):
                            err = (g.float() - x).abs() - (2.0**-8 * x.abs() if rounded else 0.0)
                            v = (err.max() / x.abs().max()).item()
                            worst = v if not v <= worst else worst  # NaN fails
                        ms = chip_smoke.cuda_ms(call, len(sets))
                        kernel_ms = sum(v for k, v in chip_smoke.device_ms_per_call(call).items()
                                        if "ssd_bwd" in k)
                        row = {"variant": name, "heads_summed_on_chip": shared, "rep": rep,
                               "gate_ok": bool(worst <= chip_smoke.SSM_BWD_TOL[torch.bfloat16]),
                               "err_past_rounding_of_scale": worst, "ms": ms,
                               "kernel_ms": kernel_ms, "ptxas": regs.get(name, "")}
                        rows.append(row)
                        print(f"{name:34s} {'cluster' if shared else 'per head':8s} gate "
                              f"{'ok' if row['gate_ok'] else 'FAIL'} ({worst:.2g}) "
                              f"{ms * 1e3:6.1f} us per call, kernel {kernel_ms * 1e3:6.1f} us"
                              + (f" | {regs.get(name, '')}" if rep == 0 and shared else ""),
                              flush=True)
        finally:
            ssm_ops._BWD_LIB = built
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": chip_smoke.RESULTS["device"], "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
