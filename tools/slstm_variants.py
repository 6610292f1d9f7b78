#!/usr/bin/env python3
"""Time variants of the sLSTM recurrence's kernels on one GPU.

    python3 tools/slstm_variants.py [--json PATH] [--only NAME ...]

Each variant is a list of text edits of ``csrc/slstm.cu``,
``csrc/slstm_bwd.cu`` and the reg layout they share,
``csrc/slstm_reg.cuh``, as committed (``VARIANTS`` below; a header edit
may reach one kernel's copy alone), compiled with the port's nvcc flags
(all at once, in parallel), loaded in place of the built libraries and
called through the wrapper's ``_forward`` and ``_backward`` at
xlstm-125m's shapes (H 4, d 192): the forward at 8 x 512 storing c, n,
z (training), at 4 x 128 (the serving prefill) and one decode step (4 x
1, a state in); the backward at 8 x 512.

- The ``fma`` kernels in four forms, to split a step's time: as built;
  with the matvec's shared-memory reads cut (the FMA chain kept); with
  the gates cut (plain arithmetic in place of exp, tanh, sigmoid and the
  divides); with the step's input loads cut.
- The ``reg`` kernels as built; with the gates' expf and divides precise
  (as built they use __expf and __fdividef); the forward's tanh from
  __expf; 1 / max(n, 1) once a step; 768 threads holding 48 floats of r
  each (``CPT`` 1), or for the forward 192 holding 192 (``CPT`` 4),
  instead of 384 holding 96; the step's stores on the other side of its
  barrier; the ring's refills after the matvec; a ring of 4 steps
  instead of 8; and, to split a step, without the gates, without
  the matvec's shared-memory reads, over half of k, without the step's
  barrier, without its stores to device memory and without the ring's
  refills. (The forward's head split over a thread-block cluster of 2
  or 4 blocks, exchanging h through distributed shared memory, was timed
  with an earlier form of this tool and lost at both shapes; PERF.md
  keeps the numbers.)

Each row: the variant's outputs against the plain versions on the same
card (``slstm_scan_ref`` and ``slstm_scan_bwd_ref``, max|err| / max|ref|
of each output, gate 1e-4 as ``chip_smoke.py``'s; "times only" variants
change the arithmetic and fail it), ms per call (CUDA-graph replay,
inputs rotated through more than L2) and us per step. ptxas's registers
and spills of each kernel at d 192. Needs a CUDA card, nvcc and
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
from repro_torch.kernels.slstm import ops as slstm_ops  # noqa: E402
from repro_torch.kernels.slstm import slstm_scan_bwd_ref, slstm_scan_ref  # noqa: E402

FWD, BWD, HDR = "slstm.cu", "slstm_bwd.cu", "slstm_reg.cuh"
# an edit's target: FWD or BWD (that source), HDR (the header as both
# kernels see it) or (FWD, HDR) / (BWD, HDR) (that kernel's copy of it)

# the fma kernels' matvec without its shared-memory reads: the same FMA chain
FMA_NO_LDS = [(FWD, "acc = fmaf(h_s[k], r_s[k * D + j], acc);", "acc = fmaf(acc, 0.999f, 1e-3f);"),
              (BWD, "acc = fmaf(dz_s[jj], rt_s[jj * D + j], acc);",
               "acc = fmaf(acc, 0.999f, 1e-3f);")]
# the fma kernels' gates as plain arithmetic: no exp, tanh, sigmoid or divide
FMA_NO_GATES = [
    (FWD, "      const float z = tanhf(zt + rec);\n      const float ig = expf(fminf(it, 10.f));\n"
          "      const float fg = sigmoidf_(ft);\n",
     "      const float z = zt + rec;\n      const float ig = it;\n      const float fg = ft;\n"),
    (FWD, "const float hv = sigmoidf_(ot) * (c / fmaxf(n, 1.f));", "const float hv = ot * c;"),
    (BWD, "        const float og = sigmoidf_(o_in[ie]);", "        const float og = o_in[ie];"),
    (BWD, "        const float q = c / m;", "        const float q = c;"),
    (BWD, "        dct = dc + dq / m;", "        dct = dc + dq;"),
    (BWD, "      const float ig = expf(fminf(it, 10.f));\n      const float fg = sigmoidf_(ft);\n"
          "      const float dm = -S1 / m;",
     "      const float ig = it;\n      const float fg = ft;\n      const float dm = -S1;"),
]
# the fma kernels' per-step loads from device memory replaced by constants
FMA_NO_LOADS = [
    (FWD, "      zt = z_in[ie];\n      ot = o_in[ie];\n      it = i_in[ih];\n"
          "      ft = f_in[ih];\n",
     "      zt = 0.1f;\n      ot = 0.2f;\n      it = 0.3f;\n      ft = 0.4f;\n"),
    (BWD, "      n = n_all[ih];\n      n_prev = t > 0 ? n_all[ih - H] : n0[st_h];\n"
          "      it = i_in[ih];\n      ft = f_in[ih];\n",
     "      n = 1.5f;\n      n_prev = 1.25f;\n      it = 0.3f;\n      ft = 0.4f;\n"),
    (BWD, "        const float c = c_all[ie];\n"
          "        const float c_prev = t > 0 ? c_all[ie - E] : c0[st_e + j];\n"
          "        z = z_all[ie];\n        const float og = sigmoidf_(o_in[ie]);\n"
          "        const float dht = dys[ie] + dh;\n",
     "        const float c = 0.5f;\n        const float c_prev = 0.25f;\n        z = 0.1f;\n"
     "        const float og = sigmoidf_(0.2f);\n        const float dht = 0.3f + dh;\n"),
]

# the reg kernels' gates that do not wait on the matvec with expf and a
# precise divide, as fma's, in place of __expf and __fdividef; every reg
# edit starts at a line's start (the fma kernels indent deeper)
_IG = "\n    const float ig = __expf(fminf(it, 10.f));\n"
_FG = "    const float fg = sigmoid_fast(ft);\n"
_OG_FWD = "    const float og = sigmoid_fast(ot);\n"
_OG_BWD = "\n    const float og = sigmoid_fast(oin);"
_PRECISE_FG = "    const float fg = sigmoidf_(ft);\n"
REG_PRECISE_GATES = [
    (FWD, _IG + _FG + _OG_FWD,
     "\n    const float ig = expf(fminf(it, 10.f));\n" + _PRECISE_FG
     + "    const float og = sigmoidf_(ot);\n"),
    (BWD, _OG_BWD + _IG + _FG,
     "\n    const float og = sigmoidf_(oin);\n    const float ig = expf(fminf(it, 10.f));\n"
     + _PRECISE_FG),
]
# the forward's tanh as 1 - 2 / (exp(2 x) + 1) with the intrinsics
_TANH = "\n    const float z = tanhf(zt + rec);\n"
REG_FAST_TANH = [(FWD, _TANH,
                  "\n    const float z = 1.f - __fdividef(2.f, __expf(2.f * (zt + rec)) + 1.f);\n")]
# 1 / max(n, 1) once a step, off the chain, and products in place of the divides by it
_M = "\n    const float m = fmaxf(n, 1.f);\n"
_M_RCP = "\n    const float m = fmaxf(n, 1.f), rm = 1.f / m;\n"
_HV, _Q, _DCT = ("\n    hv = og * (c / m);\n", "\n    const float q = c / m;\n",
                 "\n    const float dct = dc + dq / m;\n")
REG_RCP = [(FWD, _M, _M_RCP), (FWD, _HV, "\n    hv = og * (c * rm);\n"),
           (BWD, _M, _M_RCP), (BWD, _Q, "\n    const float q = c * rm;\n"),
           (BWD, _DCT, "\n    const float dct = dc + dq * rm;\n")]
# the reg kernels' gates as plain arithmetic
REG_NO_GATES = [
    (FWD, _IG + _FG + _OG_FWD,
     "\n    const float ig = it;\n    const float fg = ft;\n    const float og = ot;\n"),
    (FWD, _TANH, "\n    const float z = zt + rec;\n"), (FWD, _HV, "\n    hv = og * c;\n"),
    (BWD, _OG_BWD + _IG + _FG,
     "\n    const float og = oin;\n    const float ig = it;\n    const float fg = ft;\n"),
    (BWD, _Q, "\n    const float q = c;\n"), (BWD, _DCT, "\n    const float dct = dc + dq;\n"),
]
# the reg kernels' matvec over half of each slice (half the FMAs and reads)
REG_HALF_FMA = [(f, "for (int i = 0; i < KPT / 4; ++i) {\n      const float4 " + v,
                 "for (int i = 0; i < KPT / 8; ++i) {\n      const float4 " + v)
                for f, v in ((FWD, "hk"), (BWD, "zk"))]
# the reg kernels' matvec without its shared-memory reads (the same FMAs on
# values in registers), and without the step's block barrier
REG_NO_LDS = [(FWD, "const float4 hk = *reinterpret_cast<const float4*>(hc + g * G::STR + 4 * i);",
               "const float4 hk = make_float4(zt, ot, it, ft);"),
              (BWD, "const float4 zk = *reinterpret_cast<const float4*>(dzc + g * G::STR + 4 * i);",
               "const float4 zk = make_float4(c, z, oin, dy);")]
REG_NO_BARRIER = [(FWD, "    __syncthreads();                   // h_t", "    // h_t"),
                  (BWD, "    __syncthreads();                   // dz_t", "    // dz_t")]
_CPT4 = [((FWD, HDR), "constexpr int CPT = 2;", "constexpr int CPT = 4;")]  # forward only
# the reg kernels' per-step stores to device memory left out (ys, c, z; dz_in,
# do_in and the per-warp sums), and the ring's refills left out (the steps
# after the first NSTAGE - 1 read stale inputs)
_FWD_STORES = "      *y_t = hv;\n      if (keep) {\n        *c_t = c;\n        *z_t = z;\n      }\n"
_BWD_STORES = "      *dz_t = dpre;\n      *do_t = dht * q * og * (1.f - og);\n"
REG_NO_STORES = [(FWD, _FWD_STORES, ""), (BWD, _BWD_STORES, ""),
                 (BWD, "    if (lane < 3) *pw_t", "    if (lane < 0) *pw_t")]
REG_NO_REFILLS = [(FWD, "    if (t + NSTAGE - 1 < S) issue(t + NSTAGE - 1);", ""),
                  (BWD, "    if (u + NSTAGE - 1 < S) issue(u + NSTAGE - 1);", "")]
# the step's stores behind its barrier in the forward, before it in the backward
_FWD_N = "    if (keep && tid == 0) *n_t = n;\n"
_FWD_NEXT = ("    y_t += E;\n    if (keep) {\n      c_t += E;\n      z_t += E;\n      n_t += H;\n"
             "    }\n")
_FWD_SYNC = ("    mma::cp_async_wait<NSTAGE - 2>();  // this thread's copies of step t + 1\n"
             "    __syncthreads();                   // h_t and step t + 1's inputs are in\n")
_BWD_NEXT = "    dz_t -= E;\n    do_t -= E;\n"
_BWD_SYNC = "    __syncthreads();                   // dz_t and step u + 2's inputs are in\n"
# (as built in the backward; the forward's before it)
_BWD_AFTER = "    if (own) {  // step t's gradients, behind the barrier\n" + _BWD_STORES + "    }\n"
REG_STORES_SWAPPED = [
    (FWD, _FWD_STORES + "    }\n" + _FWD_N + _FWD_NEXT + _FWD_SYNC,
     "    }\n" + _FWD_SYNC + "    if (own) {\n" + _FWD_STORES + "    }\n" + _FWD_N + _FWD_NEXT),
    (BWD, "    if (own) dz_s[(u & 1) * G::HS + G::pos(j)] = dpre;\n",
     "    if (own) {\n      dz_s[(u & 1) * G::HS + G::pos(j)] = dpre;\n" + _BWD_STORES + "    }\n"
     + _BWD_NEXT),
    (BWD, _BWD_SYNC + _BWD_AFTER + _BWD_NEXT, _BWD_SYNC),
]
# the ring's refill issued after the matvec's FMAs, not at the step's start
_FWD_REFILL = ("    if (t + NSTAGE - 1 < S) issue(t + NSTAGE - 1);"
               "  // into the stage step t - 1 read\n"
               "    mma::cp_async_commit();\n")
_BWD_REFILL = ("    if (u + NSTAGE - 1 < S) issue(u + NSTAGE - 1);"
               "  // into the stage step u - 1 read\n"
               "    mma::cp_async_commit();\n")
REG_REFILL_LATE = [
    (FWD, _FWD_REFILL, ""), (FWD, "    float rec = 0.f;\n", _FWD_REFILL + "    float rec = 0.f;\n"),
    (BWD, _BWD_REFILL, ""),
    (BWD, "    // step t's per-head sums, per warp, off the chain\n",
     _BWD_REFILL + "    // step t's per-head sums, per warp, off the chain\n"),
    (BWD, "    mma::cp_async_wait<NSTAGE - 3>();  // this thread's copies of step u + 2",
     "    mma::cp_async_wait<NSTAGE - 4>();  // this thread's copies of step u + 2"),
]

VARIANTS = {  # name: (edits, the variant the wrapper launches)
    "fma as built": ([], "fma"),
    "fma, matvec without shared-memory reads (times only)": (FMA_NO_LDS, "fma"),
    "fma, no gates (times only)": (FMA_NO_GATES, "fma"),
    "fma, no input loads (times only)": (FMA_NO_LOADS, "fma"),
    "reg as built": ([], "reg"),
    "reg, gates with expf and precise divides": (REG_PRECISE_GATES, "reg"),
    "reg, the forward's tanh from __expf": (REG_FAST_TANH, "reg"),
    "reg, 1 / max(n, 1) once a step": (REG_RCP, "reg"),
    "reg, 768 threads x 48 floats of r": (
        [(HDR, "constexpr int CPT = 2;", "constexpr int CPT = 1;")], "reg"),
    "reg, forward on 192 threads x 192 floats of r": (_CPT4, "reg"),
    "reg, a ring of 4 steps": (
        [(HDR, "constexpr int NSTAGE = 8;", "constexpr int NSTAGE = 4;")], "reg"),
    "reg, stores behind the barrier (forward), before it (backward)": (REG_STORES_SWAPPED, "reg"),
    "reg, refills after the matvec": (REG_REFILL_LATE, "reg"),
    "reg, no gates (times only)": (REG_NO_GATES, "reg"),
    "reg, matvec without shared-memory reads (times only)": (REG_NO_LDS, "reg"),
    "reg, matvec over half of k (times only)": (REG_HALF_FMA, "reg"),
    "reg, no barrier (times only)": (REG_NO_BARRIER, "reg"),
    "reg, no per-step stores (times only)": (REG_NO_STORES, "reg"),
    "reg, no ring refills (times only)": (REG_NO_REFILLS, "reg"),
}

H, D = 4, 192
SHAPES = (("forward 8 x 512, storing c, n, z", "fwd", 8, 512, False, True),
          ("forward 4 x 128", "fwd", 4, 128, False, False),
          ("forward, one decode step (4 x 1)", "fwd", 4, 1, True, False),
          ("backward 8 x 512", "bwd", 8, 512, False, False))


def _edit(text, edits, name):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: an edit does not match the source once: {old!r}")
        text = text.replace(old, new)
    return text


def _ptxas(out):
    """{kernel: 'registers, spills'} of the d 192 reg kernels and the fma ones."""
    lines, regs = out.splitlines(), {}
    for k, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        fn = line.split("'")[1]
        for key in ("slstm_fwd_regILi192E", "slstm_bwd_regILi192E", "9slstm_fwdE", "9slstm_bwdE"):
            if key in fn:
                regs[key.strip("9E").replace("ILi192", " d192")] = "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 5]
                    if "Used" in x or "spill" in x)
    return regs


def build(tmp, variants):
    """{variant: (forward library, backward library)}, every source of every
    variant compiled at once; ptxas's lines by variant."""
    srcs = {f: open(os.path.join(_build.CSRC, f)).read() for f in (FWD, BWD, HDR)}
    procs = {}
    for i, (name, (edits, _)) in enumerate(variants.items()):
        for f in (FWD, BWD):
            # each kernel in a directory of its own, beside its copy of the
            # header (a quoted include looks there first)
            where = os.path.join(tmp, f"v{i}_{f[:-3]}")
            os.makedirs(where)
            with open(os.path.join(where, HDR), "w") as fh:
                fh.write(_edit(srcs[HDR], [(o, n) for t, o, n in edits if t in (HDR, (f, HDR))],
                               name))
            cu = os.path.join(where, f)
            with open(cu, "w") as fh:
                fh.write(_edit(srcs[f], [(o, n) for t, o, n in edits if t == f], name))
            cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", _build.CSRC, "-o", cu[:-3] + ".so", cu]
            procs[(name, f)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True),
                                cu[:-3] + ".so")
    libs, regs = {}, {}
    for (name, f), (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            for other, _ in procs.values():  # stop the other builds
                other.kill()
                other.wait()
            raise RuntimeError(f"variant {name!r} ({f}) does not build:\n{out[-4000:]}")
        regs.setdefault(name, {}).update(_ptxas(out))
        lib = ctypes.CDLL(so)
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        if f == FWD:
            lib.slstm_scan_launch.argtypes = slstm_ops._lib().slstm_scan_launch.argtypes
            lib.slstm_scan_launch.restype = ctypes.c_int
        else:
            built = slstm_ops._bwd_lib()
            lib.slstm_scan_bwd_launch.argtypes = built.slstm_scan_bwd_launch.argtypes
            lib.slstm_scan_bwd_launch.restype = ctypes.c_int
            lib.slstm_bwd_part_floats.argtypes = built.slstm_bwd_part_floats.argtypes
            lib.slstm_bwd_part_floats.restype = ctypes.c_int
        libs.setdefault(name, {})[f] = lib
    return libs, regs


def _rel(got, want):
    return max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", metavar="PATH", help="write the rows as JSON")
    ap.add_argument("--only", nargs="*", metavar="NAME", help="the variants to time (default all)")
    args = ap.parse_args(argv)
    variants = {k: v for k, v in VARIANTS.items() if not args.only or k in args.only}
    chip_smoke.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(22)
    cases = []
    for tag, kind, b, s, with_state, store in SHAPES:
        n_bytes = (chip_smoke.slstm_work(b, s, H, D, store) if kind == "fwd"
                   else chip_smoke.slstm_bwd_work(b, s, H, D))[0]
        sets = []
        for _ in range(max(1, math.ceil(chip_smoke.COLD_BYTES / n_bytes))):
            ins = chip_smoke._slstm_set(gen, b, s, H, D, with_state)
            if kind == "bwd":
                z_in, i_in, f_in, o_in, r, c0, n0, h0 = ins
                (_, _, _, _), saved = slstm_scan_ref(*ins, store=True)
                dys = torch.randn(b, s, H * D, generator=gen, device="cuda")
                ins = (i_in, f_in, o_in, r, c0, n0, saved, dys)
            sets.append(ins)
        want = (slstm_scan_ref(*sets[0], store=store) if kind == "fwd"
                else slstm_scan_bwd_ref(*sets[0]))
        if kind == "fwd" and store:
            want = (*want[0], *want[1])
        cases.append((tag, kind, s, store, sets, want))
    with tempfile.TemporaryDirectory() as tmp:
        libs, regs = build(tmp, variants)
        built = (slstm_ops._LIB, slstm_ops._BWD_LIB)
        rows = []
        try:
            for rep in range(2):  # the variants in turn, twice
                for name, (_, variant) in variants.items():
                    slstm_ops._LIB, slstm_ops._BWD_LIB = libs[name][FWD], libs[name][BWD]
                    fma = variant == "fma"
                    for tag, kind, s, store, sets, want in cases:
                        if kind == "fwd":
                            def call(i, store=store, sets=sets):
                                return slstm_ops._forward(*sets[i % len(sets)], store=store,
                                                          force_fma=fma)
                        else:
                            def call(i, sets=sets):
                                return slstm_ops._backward(*sets[i % len(sets)], force_fma=fma)
                        before = dict(slstm_ops.slstm_scan.variants if kind == "fwd"
                                      else slstm_ops.slstm_scan_bwd.variants)
                        got = call(0)
                        after = (slstm_ops.slstm_scan.variants if kind == "fwd"
                                 else slstm_ops.slstm_scan_bwd.variants)
                        if after[variant] != before[variant] + 1:
                            raise RuntimeError(f"{name}: {tag} did not launch {variant}")
                        if kind == "fwd":
                            got = (*got[:4], *got[4]) if store else got[:4]
                        err = _rel(got, want)
                        ms = chip_smoke.cuda_ms(call, len(sets))
                        row = {"variant": name, "launches": variant, "shape": tag, "rep": rep,
                               "gate_ok": bool(err <= 1e-4), "rel_err": err, "ms": ms,
                               "us_per_step": ms * 1e3 / s, "ptxas": regs.get(name, {})}
                        rows.append(row)
                        print(f"{name:55s} {tag:34s} gate {'ok' if row['gate_ok'] else 'FAIL'} "
                              f"({err:.2g}) {ms:8.4f} ms, {row['us_per_step']:6.3f} us a step",
                              flush=True)
                    if rep == 0:
                        print(f"{'':55s} ptxas: {regs.get(name, {})}", flush=True)
        finally:
            slstm_ops._LIB, slstm_ops._BWD_LIB = built
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"device": chip_smoke.RESULTS["device"], "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
