"""Quickstart on the PyTorch port: the paper's model, the simulator,
and a tiny training run.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--smoke] [--device cpu]
(--smoke trims the training section to a few steps; --device picks where
the simulator, the Study and the training run: cuda, the default, or cpu.)
"""

import argparse

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("--smoke", action="store_true")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# --- 1. The paper's analytical model (Eqs. 1-2) -----------------------------
from repro_torch.core.analytical import optimal_tiers, speedup_3d, tau_2d, tau_3d

M, K, N = 64, 12100, 147  # ResNet50's RN0 layer as a GEMM (Table I)
print("tau_2d(64x64 array)      :", int(tau_2d(M, K, N, 64, 64)), "cycles")
print("tau_3d(8 tiers of 64x64) :", int(tau_3d(M, K, N, 64, 64, 8)), "cycles")
l, cyc = optimal_tiers(M, K, N, n_macs=2**18)
print(f"optimal tiers @ 2^18 MACs: l*={l}  speedup={speedup_3d(M,K,N,2**18,l):.2f}x")

# --- 2. The cycle-level 3D systolic array actually computing a GEMM ---------
from repro_torch.core.systolic import simulate_dos_3d

A = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
B = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
r = simulate_dos_3d(A, B, 8, 8, tiers=4, device=args.device)
print("dOS simulator exact:", np.allclose(r.out.cpu().numpy(), A @ B, atol=1e-4),
      f"({r.cycles} cycles, {r.tiers} tiers)")

# --- 3. The same idea as a mesh sharding choice (the advisor) ----------------
from repro_torch.core.advisor import GemmShard, choose_sharding

for name, g in [
    ("train GEMM (1M tokens)", GemmShard(M=1 << 20, K=4096, N=4096, axis=16)),
    ("decode GEMM (8 tokens)", GemmShard(M=8, K=8192, N=8192, axis=16)),
]:
    print(f"advisor[{name}] -> {choose_sharding(g).name}")

# --- 4. The same question, bandwidth-aware (one declarative Study) ----------
from repro_torch.core.study import AnalysisSpec, BandwidthSpec, SpaceSpec, Study, WorkloadSpec

res = Study(
    workload=WorkloadSpec(kind="gemms", gemms=[(M, K, N)]),
    space=SpaceSpec(mac_budgets=[2**18], tiers=range(1, 17)),
    analysis=AnalysisSpec(kind="roofline", bandwidth=BandwidthSpec.paper_default(),
                          device=args.device),
).run()
r = res.result
best = int(np.nanargmax(np.where(r.feasible[0], r.speedup[0], np.nan)))
print(f"bandwidth-aware: best feasible tier count {int(r.grid.tiers[best])}, "
      f"{r.speedup[0, best]:.2f}x vs 2D ({r.bound[0, best]}-bound — the "
      f"compute-bound {speedup_3d(M, K, N, 2**18, l):.2f}x needs infinite DRAM)")

# --- 5. Train a tiny model end to end ------------------------------------------
from repro_torch.configs import REGISTRY, reduced
from repro_torch.launch.train import train_loop

cfg = reduced(REGISTRY["smollm-135m"])
steps = 5 if args.smoke else 20
_, losses, _ = train_loop(cfg, steps=steps, global_batch=4, seq_len=64, log_every=5,
                          device=args.device)
print(f"tiny LM loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
