#!/usr/bin/env python3
"""Phase 3's serving paths with the CPU's thermal references beside them.

    python3 tools/serve_beside_cpu.py TREE MODE

Runs ``chip_smoke.py``'s phase 3 (``phase_main_path`` for smollm-135m and
zamba2-2.7b: batch 4, prompt 128, 32 greedy tokens, bf16) from the
checkout at TREE on one GPU, after its phases 1-2, while phase 9's CPU
thermal references (``thermal_cpu_reports``, Fig. 8's nine reports)
run in a process beside it: MODE ``none`` (no such process), ``t1`` (one
CPU thread, as ``chip_smoke.py`` starts it) or ``tN`` (torch's default
thread count). TREE may be another commit's checkout (unpacked with
``git archive``) whose ``chip_smoke.py`` has phase 3: MODE ``none`` then
needs nothing else of it. Prints one line ``AB {json}``: the decode
steps' p50 in ms by path, whether the CPU process still ran when the
paths ended, and its seconds. Compare trees and modes within one call:
the host's clock moves between machines.
"""

import json
import os
import subprocess
import sys
import tempfile
import time


def main(root: str, mode: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    proc = None
    if mode != "none":
        path = os.path.join(tempfile.mkdtemp(), "thermal_cpu.pt")
        code = (f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
                + ("chip_smoke.torch.set_num_threads(1); " if mode == "t1" else "")
                + f"chip_smoke.thermal_cpu_reports({path!r})")
        env = dict(os.environ, **({"OMP_NUM_THREADS": "1"} if mode == "t1" else {}))
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    p50 = {arch: chip_smoke.phase_main_path(arch)[1] for arch in chip_smoke.PATHS}
    row = {"tree": os.path.basename(root), "mode": mode,
           "step_p50_ms": {k: v * 1e3 for k, v in p50.items()}}
    if proc is not None:
        row["cpu_alive_after_paths"] = proc.poll() is None
        proc.wait()
        row["cpu_refs_s"] = time.perf_counter() - t0
    print("AB " + json.dumps(row), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[2] not in ("none", "t1", "tN"):
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
