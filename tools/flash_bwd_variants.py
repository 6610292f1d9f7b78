#!/usr/bin/env python3
"""Time variants of the flash backward's mma kernels on one GPU.

    python3 tools/flash_bwd_variants.py [--json PATH]

Each variant is a list of text edits of ``csrc/flash_attention_bwd.cu``
as committed (``VARIANTS`` below): the design choices of the ``mma``
kernels, each undone or pushed further. Every variant is compiled with
the port's nvcc flags (all in parallel), loaded in place of the built
library, and called through ``flash_attention_bwd``'s own wrapper at
smollm-135m's training shape (B 8, S 512, H 9 / 3, D 64, bf16): its
gradients against the f32 backward (``chip_smoke.py``'s gate; variants
marked "times only" change the arithmetic and fail it), ms per call
(CUDA-graph replay, inputs rotated through more than L2) and each
pass's device ms (``chip_smoke.device_ms_per_call``), causal and
unmasked. Needs a
CUDA card, nvcc and ``chip_smoke.py`` beside this directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import attention_bwd_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402

ONE_TERM = [("constexpr int BWD_TERMS = 2;", "constexpr int BWD_TERMS = 1;")]
THREE_TERMS = [("constexpr int BWD_TERMS = 2;", "constexpr int BWD_TERMS = 3;")]
# the first design's masks: a short-circuit test, and exp only where visible
BRANCHY_MASK = [
    ("""          const bool vis = (key[r] >= lo) & (key[r] < hi);
          const float p = exp2f(fmaf(s[n][e], scale2, -ls));
          const float ds = p * (dp[n][e] - dd) * a.scale;
          s[n][e] = vis ? p : pd;
          dp[n][e] = vis ? ds : 0.f;""",
     """          const bool vis = key[r] >= lo && key[r] < hi;
          const float p = vis ? expf(s[n][e] * a.scale - ls / LOG2E) : pd;
          dp[n][e] = vis ? p * (dp[n][e] - dd) * a.scale : 0.f;
          s[n][e] = p;"""),
    ("""        const bool vis = (kj >= lo[r]) & (kj < hi[r]);
        const float ds = exp2f(fmaf(s[n][e], scale2, -lse2[r])) * (dp[n][e] - dsum[r]) * a.scale;
        s[n][e] = vis ? ds : 0.f;""",
     """        const bool vis = kj >= lo[r] && kj < hi[r];
        s[n][e] = vis ? expf(s[n][e] * a.scale - lse2[r] / LOG2E) * (dp[n][e] - dsum[r]) * a.scale
                      : 0.f;"""),
]
NO_MASK = [("const bool vis = (key[r] >= lo) & (key[r] < hi);", "const bool vis = true;"),
           ("const bool vis = (kj >= lo[r]) & (kj < hi[r]);", "const bool vis = true;")]
FOUR_QUERY_WARPS = [("static constexpr int QW = 2 / DS; ", "static constexpr int QW = 4 / DS; ")]
KEYS_64 = [("static constexpr int KW = 2;                  // warps along the keys",
            "static constexpr int KW = D == 256 ? 2 : 4;  // warps along the keys")]
DQ_8_WARPS = [("static constexpr int NW = 4, NT = 32 * NW, BQ = 16 * NW;",
               "static constexpr int NW = 8, NT = 32 * NW, BQ = 16 * NW;")]
# each KV tile's touched (head, query tile) pairs split over two blocks,
# whose f32 partial dK and dV a third kernel adds in a fixed order
TWO_PART_SPLIT = [
    ("bf16* __restrict__ dv, Args a) {\n  using namespace mma;\n  using C = KvTile<D>;",
     "bf16* __restrict__ dv, Args a, float* part_buf, int parts) {\n  using namespace mma;\n"
     "  using C = KvTile<D>;"),
    ("  const int k0 = blockIdx.y * BK;",
     "  const int k0 = (blockIdx.y / parts) * BK, part = blockIdx.y % parts;"),
    ("""  int cur = next_pair(0);
  if (cur < npairs) issue(cur, 0);
  cp_async_commit();
  int nxt = cur < npairs ? next_pair(cur + 1) : npairs;""",
     """  int total = 0;
  for (int it = next_pair(0); it < npairs; it = next_pair(it + 1)) ++total;
  const int r0 = part * total / parts;
  int left = (part + 1) * total / parts - r0, cur = npairs;
  if (left > 0) {
    cur = next_pair(0);
    for (int r = 0; r < r0; ++r) cur = next_pair(cur + 1);
  }
  if (cur < npairs) issue(cur, 0);
  cp_async_commit();
  int nxt = left > 1 ? next_pair(cur + 1) : npairs;"""),
    ("""    cur = nxt;
    if (nxt < npairs) nxt = next_pair(nxt + 1);""",
     """    cur = nxt;
    --left;
    nxt = (left > 1 && nxt < npairs) ? next_pair(nxt + 1) : npairs;"""),
    ("  bf16* dkb = dk + b * a.dk.b + kh * a.dk.h + ds * DH + 2 * tq;",
     """  if (parts > 1) {
    const size_t plane = (size_t)a.B * a.KVH * a.Skv * D;
    float* pb = part_buf + (((size_t)part * a.B + b) * a.KVH + kh) * a.Skv * D + ds * DH + 2 * tq;
    for (int r = 0; r < 2; ++r)
      for (int n = 0; key[r] < a.Skv && n < DT; ++n) {
        *reinterpret_cast<float2*>(pb + (size_t)key[r] * D + n * 8) =
            make_float2(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
        *reinterpret_cast<float2*>(pb + parts * plane + (size_t)key[r] * D + n * 8) =
            make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
    return;
  }
  bf16* dkb = dk + b * a.dk.b + kh * a.dk.h + ds * DH + 2 * tq;"""),
    ("template <int D>\nint launch_mma(",
     """__global__ void flash_bwd_mma_dkdv_sum(const float* part_buf, bf16* dk, bf16* dv, Args a,
                                       int parts, int D) {
  const size_t plane = (size_t)a.B * a.KVH * a.Skv * D;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2;
  if (i >= plane) return;
  const int d = i % D, key = (i / D) % a.Skv, kh = (i / D / a.Skv) % a.KVH;
  const int b = i / D / a.Skv / a.KVH;
  for (int w = 0; w < 2; ++w) {
    float2 acc = make_float2(0.f, 0.f);
    for (int p = 0; p < parts; ++p) {
      const float2 x = *reinterpret_cast<const float2*>(part_buf + (w * parts + p) * plane + i);
      acc.x += x.x;
      acc.y += x.y;
    }
    bf16* out = w == 0 ? dk + b * a.dk.b + kh * a.dk.h + (int64_t)key * a.dk.s + d
                       : dv + b * a.dv.b + kh * a.dv.h + (int64_t)key * a.dv.s + d;
    *reinterpret_cast<uint32_t*>(out) = mma::pack_bf16(acc.x, acc.y);
  }
}

static float* g_part = nullptr;  // 256 MiB of partial sums, allocated once

template <int D>
int launch_mma("""),
    ("""  flash_bwd_mma_dkdv<D><<<dim3((unsigned)(a.B * a.KVH), (unsigned)nk), KvTile<D>::NT, smem_kv,
                          s>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO,
                               (bf16*)dk, (bf16*)dv, a);
  return (int)cudaGetLastError();""",
     """  const int parts = a.causal ? 2 : 1;
  if (!g_part && cudaMalloc(&g_part, (size_t)1 << 28) != cudaSuccess) return 2;
  flash_bwd_mma_dkdv<D><<<dim3((unsigned)(a.B * a.KVH), (unsigned)(nk * parts)), KvTile<D>::NT,
                          smem_kv, s>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                        (const bf16*)dO, (bf16*)dk, (bf16*)dv, a, g_part, parts);
  e = (int)cudaGetLastError();
  if (e != 0 || parts == 1) return e;
  const size_t plane = (size_t)a.B * a.KVH * a.Skv * D;
  flash_bwd_mma_dkdv_sum<<<(unsigned)((plane / 2 + 255) / 256), 256, 0, s>>>(
      g_part, (bf16*)dk, (bf16*)dv, a, parts, D);
  return (int)cudaGetLastError();"""),
]

VARIANTS = {
    "as built": [],
    "three terms": THREE_TERMS,
    "one term (times only)": ONE_TERM,
    "branchy mask": BRANCHY_MASK,
    "no mask (times only)": NO_MASK,
    "four query warps": FOUR_QUERY_WARPS,
    "64-key dK/dV blocks": KEYS_64,
    "8-warp dQ blocks": DQ_8_WARPS,
    "two-part dK/dV split": TWO_PART_SPLIT,
}
PASSES = ("flash_bwd_mma_dkdv_sum", "flash_bwd_mma_dkdv", "flash_bwd_mma_dq")


def build(tmp):
    """{variant: loaded library}, every variant compiled at once."""
    src = open(os.path.join(_build.CSRC, "flash_attention_bwd.cu")).read()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
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
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} does not build:\n{out[-4000:]}")
        lib = ctypes.CDLL(so)
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = flash_ops._bwd_lib().flash_attention_bwd_launch.argtypes
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", metavar="PATH", help="write the rows as JSON")
    args = ap.parse_args(argv)
    chip_smoke.phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        gen = torch.Generator(device="cuda").manual_seed(18)
        b, s, h, kvh, d = 8, 512, 9, 3, 64
        sets = {True: [], False: []}
        for _ in range(6):  # > 128 MB of inputs: each call finds its own outside L2
            q, k, v, do = (torch.randn(b, s, hh, d, generator=gen, device="cuda")
                           .to(torch.bfloat16) for hh in (h, kvh, kvh, h))
            for causal in (True, False):
                o, lse = flash_ops._forward(q, k, v, causal=causal, window=None, scale=None,
                                            q_offset=0, with_lse=True)
                sets[causal].append((q, k, v, o, do, lse))
        kw = {c: dict(causal=c, window=None, scale=None, q_offset=0) for c in (True, False)}
        q, k, v, o, do, lse = sets[True][0]
        exact = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(), lse,
                                  causal=True)
        built = flash_ops._BWD_LIB
        rows = []
        try:
            for rep in range(2):  # the variants in turn, twice
                for name, lib in libs.items():
                    flash_ops._BWD_LIB = lib
                    ok, _, _, slack = chip_smoke._bwd_gate(
                        flash_ops._backward(q, k, v, o, do, lse, **kw[True]), exact,
                        torch.bfloat16)
                    ms = chip_smoke.cuda_ms(
                        lambda i: flash_ops._backward(*sets[True][i], **kw[True]), len(sets[True]))
                    passes = {}
                    for causal in (True, False):
                        by_name = chip_smoke.device_ms_per_call(
                            lambda i: flash_ops._backward(*sets[causal][i % 6], **kw[causal]))
                        for n, pass_ms in by_name.items():
                            key = next((p for p in PASSES if p in n), None)
                            if key:
                                col = f"{key} {'causal' if causal else 'unmasked'} ms"
                                passes[col] = passes.get(col, 0.0) + pass_ms
                    row = {"variant": name, "rep": rep, "gate_ok": ok, "slack_used": slack,
                           "ms": ms, **passes}
                    rows.append(row)
                    print(f"{name:24s} gate {'ok' if ok else 'FAIL'} (slack {slack:.3g}) "
                          f"{ms * 1e3:6.1f} us per call | " + " ".join(
                              f"{k.replace('flash_bwd_mma_', '').replace(' ms', '')} "
                              f"{x * 1e3:.1f}" for k, x in passes.items()), flush=True)
        finally:
            flash_ops._BWD_LIB = built
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": chip_smoke.RESULTS["device"], "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
