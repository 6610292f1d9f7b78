#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which ends the run
with a non-zero exit (and without the final ``{"ok": true, ...}`` line)
if it fails:

1. device: a CUDA card must be present; prints its name, count,
   ``nvidia-smi`` name and power limit, and the torch/CUDA versions;
2. build: compiles every kernel of ``src/repro_torch/kernels/csrc`` with
   nvcc (one process per source, in parallel) and loads them; prints
   ptxas registers and spills per kernel, each tagged with its variant;
3. main paths, each with the launch counts set to 0 just before and
   read just after (the training paths are phase 12's and 13's): ``serve_loop`` on
   smollm-135m (dense) and on zamba2-2.7b (hybrid: Mamba2 + shared
   attention), both at full width and depth (batch 4, prompt 128, 32
   tokens). Each path must launch each of its kernels exactly as often
   as its layers call it (the flash backward never); every ``dos_matmul``
   launch must be a ``skinny`` or ``wgmma`` one (``general`` 0), and
   every ``flash_attention`` and ``ssm_scan`` launch an ``mma`` one
   (``fma`` 0), each kernel's variants adding up to its launches;
4. kernels: calls each kernel's wrapper at the main paths' shapes (and
   edge shapes: for dos_matmul M on both sides of each variant's
   limits, ragged N, both B layouts, operands TMA cannot describe; for
   attention and the scan every head dim, N and chunk, ragged tails,
   and layouts that plan to ``fma``: a base off 16 bytes, a stride of 2),
   holds it against its plain PyTorch version on the same inputs with
   the tolerance stated beside each check, and times kernel, plain
   version and the one PyTorch call that computes the same function
   (where there is one), next to the least time the card could take
   (bound); checks that two calls of each variant of each kernel give
   the same bits, and times the dos_matmul wrapper's host cost per call;
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
6. profile, per path: one prefill of the full model under
   ``torch.profiler`` gives its device busy time, the idle share against
   the same prefill's wall time without the profiler, and device time by
   kernel; a few decode steps give the device busy time per step and the
   idle share against the main path's step time;
7. calibration, with the launch counts set to 0 before the run and each
   row's launches read as the counts after it less those before it:
   ``run_calibration(CalibrateSpec(preset="default"))``, 23
   rows; each GEMM row must launch ``dos_matmul`` once per call (``skinny``
   at M = 16, ``wgmma`` above), each prefill row ``flash_attention``
   ``fma``, each SSM row ``ssm_scan`` ``fma``, a decode row none; every
   row's output against its plain version (phase 4's tolerances), every
   ``t_s`` finite and positive, the artifact's JSON round trip and
   ``evaluate`` with it bit-identical; prints the fit;
8. the DSE engine: ``backend="torch"`` on the card against
   ``backend="numpy"`` on the Fig. 5 grid (every ``EvalResult`` field,
   the int64 search results, the 12-tier speedup 9.57x) and on the dse
   sweep (300 workloads x 3 budgets x 16 tiers through
   ``optimal_tiers_batched``), both backends timed;
9. the grid thermal solve: Fig. 8's nine ``thermal_report`` calls on the
   card against the CPU's (made in a process of their own on one CPU
   thread, started after phase 2, while the card runs phases 3-8), with
   iteration counts and ms per solve; the configuration that runs to the
   iteration cap must read 69.007 degC;
10. the systolic simulators on the card: ragged folds, tiers 1-4, ``out``
    against A @ B at 1e-4, ``cycles`` against Eq. 1 / Eq. 2;
11. the Study front door, ``python -m repro_torch run`` in subprocesses
    started together: the nine ``example-spec KIND | run -`` pipes (the
    templates set ``backend="torch"``), Fig. 5, Fig. 7 at the paper's 300
    workloads x 3 budgets x 16 tiers and qwen2-72b's prefill_32k
    schedule; each artifact's payload must equal the same spec's
    ``backend="numpy"`` payload (the calibrate template's replayed from
    the CLI run's cache), Fig. 5 read 9.57x and Fig. 7's medians 2/4/7.
    Then, in this process: seconds per kind of both backends; a calibrate
    Study at the default preset through the CLI with a cache (launches
    per row as in phase 7; the ``--resume`` run launches nothing and
    reproduces the artifact bit for bit); the search at workers 1 and 2
    (spawned workers on the card) bit-identical; the Study facade's
    overhead over direct engine calls;
12. training (``python -m repro_torch.launch.train``): its main path, run
    right after phase 3's with the counts set to 0 just before and read
    just after, is ``train_loop`` on smollm-135m at full width and depth
    (bf16 compute on f32 master weights, batch 8 x 512 tokens, seed 0,
    remat on, 30 steps): every loss finite and falling, the launches per
    step exact (``dos_matmul`` 843, all ``wgmma``; ``flash_attention`` 60,
    all ``mma``; ``flash_attention_bwd`` 30, all ``mma``), step p50/p99,
    tokens/s, peak memory. The six main paths (phases 3, 12, 13 and 14)
    together must launch every registered kernel. After phase 11: the forward's o and lse (both
    variants; o also through the autograd Function) and the flash backward
    (``mma`` for bf16 with 16-byte rows, ``fma`` for f32 and the offset
    layout) against their plain versions at the training shape (timed
    beside the ``fma`` kernel on the same inputs and the SDPA backward's
    device time) and edge shapes (every head dim, GQA 4/4, 16/1, 8/2, a
    binding window, ragged Sq/Skv, q_offset, no visible key, a base off 16
    bytes, a sequence stride of 2), two calls bit-identical; each pass of
    both backward variants timed causal and unmasked (what the causal
    mask's uneven work costs beyond its share of the pairs); the
    dos_matmul Function's forward against matmul_ref and its dA and dB
    against autograd of matmul_ref at every training projection (all
    ``wgmma``), each product timed beside torch.matmul; one train step
    under ``torch.profiler`` (device busy, idle share, kernels and plain
    ops), at microbatches 2 (the same loss, and the same gradients leaf by
    leaf, within the bf16 band) and without remat (step time and peak
    memory beside remat's); the card against the CPU at full width and 2
    layers (loss and every gradient leaf: f32 within 1e-3 of the leaf's
    max|g|, bf16 within 3e-2); ``train_loop`` with checkpoints and a fault
    at step 12 (depth cut to 4 layers), resumed from step 10 with the
    losses of an uninterrupted run; the CLI ``--steps 5 --json`` in a
    subprocess (run with phases 13-16's CLIs after phase 16, in two waves
    of processes started together: ``phase_clis``);
13. hybrid training: its main path, run right after phase 12's with the
    counts set to 0 just before and read just after, is ``train_loop`` on
    zamba2-2.7b at full width and depth (2,422,220,960 parameters, bf16
    compute on f32 master weights, batch 8 x 512, seed 0, remat on, 30
    steps): every loss finite, the launches per step exact
    (``dos_matmul`` 1,488, all ``wgmma``; ``flash_attention`` 9 and its
    backward 9, all ``mma``; ``ssm_scan`` 108 and ``ssm_scan_bwd`` 54, all
    ``mma``: every scan gradient is the tensor-core kernel's), step
    p50/p99, tokens/s, peak memory; then the f32 global gradient norm of
    its trained state (not finite: random weights grow the residual stream
    through 54 Mamba2 layers, as in the reference, so AdamW's clip zeroes
    every update and the loss cannot fall; ROADMAP queue 3), read in a warm
    step, and one train step under ``torch.profiler`` (device busy, idle share, ms by
    kernel with ``ssm_scan_bwd`` on its own line, plain ops). After phase
    12's checks: the loss falls at full width cut to one group (6 Mamba2
    layers and the shared block), ``train_loop`` as the main path runs it;
    ``ssm_scan_bwd`` against ``ssm_scan_bwd_ref`` at the training shape
    (bf16 ``mma`` and f32 ``fma``, B and C shared by the heads and summed
    over groups of 8 heads on chip, ``d_state`` zero and not; timed beside
    the ``fma`` kernel on the same inputs, the plain version, its bound and
    the forward with and without states) and edge shapes (ragged S, chunk
    64, N 16/32/96, P 1 and 40; each bf16 one that ``mma`` takes on both
    variants), two calls bit-identical; the card against the CPU on the same
    weights (one Mamba2 block at full width in bf16, every gradient within
    3e-2 of its max|g|; the full-width model cut to one group, 6 Mamba2
    layers and the shared block, at batch 2 x 128 in f32, the loss and
    every gradient leaf within 1e-3); the CLI ``--arch zamba2-2.7b --steps
    3 --json`` in a subprocess (``phase_clis``), launches per step exact; and the
    dos_matmul Function at zamba2's training projections (forward, dA,
    dB), timed beside torch.matmul;
14. xLSTM (xlstm-125m, 66,153,264 parameters: 10 mLSTM and 2 sLSTM
    blocks) at full width and depth. Its serving main path runs right
    after phase 3's, its training main path right after phase 13's, each
    with the counts set to 0 just before and read just after:
    ``serve_loop`` (batch 4, prompt 128, 32 tokens) with the launches
    per prefill and per decode step exact by kernel and variant
    (``dos_matmul`` ``wgmma`` and, for the (768, 4) ``wi``/``wf``
    projections only, ``general`` in prefill, ``skinny`` in decode;
    ``ssm_scan`` 10 ``mma`` + 10 ``fma`` per prefill; ``slstm_scan`` 2
    ``reg`` per prefill and per decode step), profiled like phase 6; and
    ``train_loop`` (bf16 on f32 masters, 8 x 512, seed 0, 30 steps):
    every loss finite and falling, the launches per step exact by kernel
    and variant (``slstm_scan`` and ``slstm_scan_bwd`` 2 ``reg`` each),
    its gradient norm and one profiled step. After phase 13's checks:
    ``slstm_scan`` against its plain loop at the serving and training
    shapes, a decode step with a state, a ragged S and the reduced width,
    ``slstm_scan_bwd`` (with dr) against autograd of the loop, each in
    both variants (``reg`` as planned, ``fma`` forced on the same
    inputs), two calls of each bit-identical, ``reg`` timed beside
    ``fma``, the plain loop and its bound; the mLSTM's scans and their backwards (memory N
    96, P 192 ``mma``; normaliser P 1 ``fma``) and the path's GEMMs
    (``wi``/``wf`` ``general`` forward, dA and dB) timed; card against
    CPU: one mLSTM and one sLSTM block at full width in bf16 (output and
    every gradient within 3e-2), the full model in f32 at 2 x 128
    (logits, loss and every gradient leaf within 1e-3), a prefill and 4
    decode steps block by block in bf16; both CLIs in subprocesses
    (``phase_clis``) with launches exact;
15. MoE (deepseek-moe-16b, 16,879,568,896 parameters: 28 layers of 64
    routed experts, top-6, and 2 shared). Its serving main path runs right
    after phase 14's, its training main path right after phase 14's
    training, each with the counts set to 0 just before and read just
    after: ``serve_loop`` at full width with the depth cut to 7 of the 28
    layers (``SERVE_LAYERS``: the full model's host draws alone take over
    two minutes) (batch 4, prompt 128, 32 tokens; weights formed a leaf at
    a time) with the launches per prefill and per decode step exact by
    kernel and variant (``dos_matmul`` 57 with the 7 routers ``f32``,
    ``grouped_matmul`` 21 ``wgmma`` per prefill and per decode step,
    ``flash_attention`` 7 per prefill), at the same depth
    profiled like phase 6 (the grouped GEMM's share of busy time); and
    ``train_loop`` at full width cut to 4 layers (8 x 512, 30 steps,
    remat): the loss falls, the launches per step exact by variant
    (``grouped_matmul`` 36 and ``grouped_matmul_dw`` 12 ``wgmma``), one
    profiled step. After phase 14's checks: ``grouped_matmul`` against
    ``grouped_matmul_ref`` at deepseek's prefill, decode and training
    shapes with a real router's routes (some groups empty at decode), the
    training backward's dX on the weights' transposed views, both of
    llama4-scout's expert shapes, and edge cases (empty groups, one group
    holding every row, rows past the sum, ragged K and N, rows off 16
    bytes, f32, both weight layouts); ``grouped_matmul_dw`` at the
    training shape and the edges; each the planned variant and every
    other variant the operands allow (``wgmma``, ``fma``), forced on the
    same inputs, at phase 4's GEMM gate, two calls bit-identical, each
    dW's bf16 output its f32 one cast bit for bit; the planned variant
    (``wgmma``) timed beside the bound, the plain version and
    ``torch._grouped_mm`` (dW with the bf16 output training asks for, and
    with an f32 output beside it);
    one decode call of ``moe_block``
    under ``set_sync_debug_mode("error")``; card against CPU: one
    attention+MoE layer in bf16 (each sub-block fed the CPU's input,
    within 3e-2), the model cut to 2 layers in f32 at 2 x 128 (prefill and
    4 decode steps within 1e-3), one ``moe_block``'s gradients in bf16
    (the input's and every parameter's, within 3e-2), one layer's loss and
    every gradient leaf in f32 (within 1e-3), each with the routing
    agreement printed; a fault
    and resume at one layer cut to 8 experts and a 4,096-row vocabulary
    (deepseek's expert shapes, top-6, the shared experts; every expert
    product and dW ``wgmma``), every loss bit-identical to an uninterrupted
    run's; the train CLI ``--layers 1 --steps 3`` (``phase_clis``),
    launches exact;
16. vision cross-attention (llama-3.2-vision-11b, 9,775,157,256
    parameters: 8 groups of 4 self-attention layers and a gated
    cross-attention layer over 1,600 image embeddings) and the
    encoder-decoder (whisper-medium, 758,123,520 parameters: 24 encoder
    layers over 1,500 frames, 24 decoder layers). Their serving main paths
    run right after phase 15's, their training main paths right after
    phase 15's training, each with the counts set to 0 just before and
    read just after: ``serve_loop`` (batch 4, prompt 128, 32 tokens; the
    image embeddings or frames drawn as serving draws them), whisper at
    full size and the vision model at full width cut to 2 of its 8 groups
    (``SERVE_LAYERS``: the full model's host draws take 65-91 s), with
    the launches per prefill and per decode step exact by kernel and
    variant (vision: 71 ``dos_matmul`` ``wgmma`` and 10 flash ``mma`` per
    prefill, 67 ``skinny`` per decode step; whisper: 385 and 72, 193), and
    ``make_train_step`` (the reference's ``train_loop`` cannot feed these
    families) on the vision model cut to one group (5 layers; lr 3e-4: at
    1e-3 neither it nor a dense model of its width learns in 30 steps,
    ``tools/vlm_lr_probe.py``) and on whisper at full size (lr 1e-3), 8 x
    512 tokens with each step's image embeddings or frames, 30 steps: the
    loss falls, launches per step exact by
    variant, microbatches=2 against 1, one profiled step. After phase 15's
    checks: one prefill and one decode step of each profiled like phase 6;
    the flash forward and backward at the paths' non-causal shapes (128 x
    1,600 keys GQA 32/8 D 128; 1,500 x 1,500 and 128 x 1,500 MHA 16 D 64)
    against their plain versions in bf16 (timed beside SDPA and the bound)
    and f32; card against CPU with the vision gates opened to 0.5 (at
    their init of 0 no cross-attention result reaches the logits): block by
    block in bf16 and end to end in f32 at full width with the depth cut
    (vision one group, whisper 4 + 4 layers; a prefill and 4 decode steps),
    a decode step with no device-to-host sync, and one layer of each kind's
    loss and every gradient leaf (f32 within 1e-3, bf16 within 3e-2 of the
    leaf's max|g|); the serve CLI for whisper at full size and for the
    vision model at ``--smoke`` size (``phase_clis``), launches exact;
    And a bf16 vision model (reduced) with f32 image embeddings: the
    card's flash wrapper promotes the operands to f32 (``fma``), its
    prefill within E2E_TOL of the CPU's logits;
17. the (data, model) mesh (``launch/mesh.py``, ``parallel/``, the
    layers' ``Layout``): smollm-135m's ``serve_loop`` at phase 3's size
    with no process group, in an NCCL group of one rank under ``dos``,
    ``megatron``, ``zero`` and ``auto``, and with no group again (one
    device's path at (1, 1): the arguments' way through the loop, and
    what the live group costs a decode step), and 3 ``train_loop`` steps
    at phase 12's under
    each, the tokens equal to phase 3's and the losses to phase 12's
    first three, bit for bit, the serving launches exact; the phase's
    time on its own line;
18. pipeline stages, expert parallelism and the int8 gradient sync
    (``parallel/{pipeline,moe_ep,compression}.py``), their main paths each
    with the counts set to 0 just before and read just after. In an NCCL
    group of one rank: ``make_gpipe_loss`` on smollm-135m at full size over
    a one-stage mesh (phase 12's 8 x 512 batch, 4 microbatches, remat, f32
    masters; bf16 and f32 compute): the loss and every gradient leaf
    against ``model.loss`` plus backward on the same weights (f32: the loss
    within 1e-5 relative, each leaf within 1e-3 of its max|g|; bf16
    3e-2), the launches exactly 4 x one microbatch's, the step time beside
    phase 12's; ``moe_block_ep`` on one deepseek-moe-16b layer at full width
    at (1, 1) (a prefill 4 x 128 and a decode step 4 x 1; launches exact by
    variant): output and prefill gradients equal ``moe_block``'s bit for bit,
    the decode call without a sync; ``compressed_psum_grads`` over the
    pipeline step's gradient tree (every leaf of smollm-135m, f32), two
    steps of error feedback, q, g_hat and new_err equal to the CPU's bit
    for bit, ms per sync beside its bound. Then ``moe_block_ep`` as rank 0
    of (1, 4) and (2, 4) meshes in a ``fake`` group: its partial output
    against the same code on the CPU (bf16 band), each local grouped
    product (16 of the 64 experts: about 3/4 of the rows past the sum) and
    its dW against the plain versions, exact zeros past the sum, the
    planned variant, timed beside the bound; the phase's time on its own
    line;
19. every family's sharded forward, each with the counts set to 0 just
    before and read just after: smollm-135m and qwen2.5-3b (dense),
    deepseek-moe-16b, zamba2-2.7b, xlstm-125m, llama-3.2-vision-11b and
    whisper-medium at full width cut to one layer, group or block pair
    (``family_cfg``), a 4 x 128 prefill and a decode step (and for the
    MoE, hybrid and xLSTM models the loss and its backward), on this card
    alone and as rank 0 of each (1, 2), (1, 4) and (2, 4) mesh under
    ``dos`` and ``megatron`` in a ``fake`` process group (collectives
    emulated as copies of rank 0's; the multi-rank numerics are held on
    the CPU's gloo ranks by ``tests/test_torch_sharding_ranks.py`` and
    ``tests/test_torch_sharding_families.py``): each run's launches by
    kernel equal one card's, mode by mode, and every distinct launch (a
    kernel at a rank's shapes, strides and flags: ``dos_matmul`` with its
    K-split f32 partials, ``grouped_matmul`` with its f32 output,
    ``flash_attention`` and its backward, ``ssm_scan`` and its backward,
    ``slstm_scan`` and its backward) is replayed on copies of its
    arguments against its plain version with the variant it launched,
    and timed on inputs cold in L2 beside its bound; then the grouped
    forward's f32 output on its own at deepseek-moe-16b's (1, 4) and (2, 4) K-split shard shapes,
    against its plain version and the bf16 forward's rounding, beside
    ``torch._grouped_mm``; the phase's time on its own line. Each sharded
    run also records, mode by mode, its launches by kernel and variant,
    the collectives rank 0 issued (``collectives.recording``) and the peak
    bytes it allocated (``torch.cuda.max_memory_allocated`` above what was
    allocated before it), from a second run of it outside the recorder,
    whose copies of the launches' arguments would raise its peak;
20. the dry-run's meta-device accounting (``launch/dryrun.py``,
    ``launch/accounting.py``): each of phase 19's sharded runs traced on
    the meta device at the same config, mesh shape (a ``MeshSpec``, no
    process group), strategy and mode; its launches by kernel and variant
    and its collectives (op, dtype, shape, group size) must equal the
    card's exactly, its peak bytes per rank (plus the run's argument
    bytes, on both sides) lie within 10 % of the card's, and its temp
    alone (the bytes allocated above the arguments) within 25 % of the
    card's (or 4 KiB), each gap printed;
    the meta branch's stand-ins for two library answers (the SSD
    backward's cluster size, the sLSTM backward's scratch) equal the
    libraries'; the phase's time on its own line;
21. the report and the examples (``repro_torch/report.py``,
    ``examples/torch``): ``report.main`` (what ``python -m repro_torch
    report`` runs) with all eight sections on ``cuda`` into a temporary
    directory, then the five example twins at their test flags on the
    card, each run in this process with the launch counts set to 0 just
    before and read just after. The dse, network, search, serve and thermal
    sections must equal the committed ``experiments/*_section.md`` byte
    for byte, the roofline section up to its dry-run table; the calibrate
    section has the committed file's row labels and launches
    ``dos_matmul``, ``flash_attention`` and ``ssm_scan``; the dry-run
    section reads 33 + 33 cells traced and 0 failures. ``serve_decode``
    must launch ``dos_matmul`` and ``flash_attention``, ``train_lm`` and
    ``quickstart`` the flash backward too; ``dse_explore`` and
    ``network_explore`` print on the card every line they print on the
    CPU; the phase's time on its own line;
22. prints the kernels line, the ``nvidia-smi`` line, and last
    ``{"ok": true, "device": {...}}``.

``--details PATH`` also writes every measurement to a JSON file.
``--sweep`` runs phases 1 and 2, times each dos_matmul tiling (BN, K
split) at every bf16 GEMM shape of the main paths beside torch.matmul,
and stops. ``--only front-door,families,report`` runs phases 1 and 2 and
the phases named (11; 19 and 20; 21), prints no result line and stops.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import analytical, calibrate, engine, systolic  # noqa: E402
from repro_torch.core.dse import random_workloads  # noqa: E402
from repro_torch.core.ppa import thermal  # noqa: E402
from repro_torch.kernels import KERNELS, _build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.adamw import adamw, adamw_ref, sum_squares, sum_squares_ref  # noqa: E402
from repro_torch.kernels.adamw import ops as adamw_ops  # noqa: E402
from repro_torch.kernels.dos_matmul import dos_matmul, matmul_ref  # noqa: E402
from repro_torch.kernels.dos_matmul import ops as dos_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_fwd_ref, attention_ref, decode_attention, decode_attention_ref,
    flash_attention, flash_attention_bwd,
)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul, grouped_matmul_dw, grouped_matmul_dw_ref, grouped_matmul_ref,
)
from repro_torch.kernels.grouped_matmul import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.slstm import (  # noqa: E402
    slstm_dr, slstm_scan, slstm_scan_bwd, slstm_scan_bwd_ref, slstm_scan_ref,
)
from repro_torch.kernels.slstm import ops as slstm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    CHUNK, CHUNKS, ssm_scan, ssm_scan_bwd, ssm_scan_bwd_ref, ssm_scan_chunked,
)
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.serve import model_inputs, serve_loop  # noqa: E402
from repro_torch.launch.steps import accumulate_grads, loss_and_grads, make_train_step  # noqa: E402
from repro_torch.launch.train import cut_depth, train_loop  # noqa: E402
from repro_torch.models import build, decoder, encdec, layers, moe  # noqa: E402
from repro_torch.models.params import leaves, map_tree, materialize, materialize_cast  # noqa: E402
from repro_torch.models.zoo import MODEL_INPUTS  # noqa: E402
from repro_torch.models.ssm import mamba_block, mamba_defs  # noqa: E402
from repro_torch.models.xlstm import mlstm_block, mlstm_defs, slstm_block, slstm_defs  # noqa: E402
from repro_torch.optim import OptConfig, adamw_update, init_opt_state  # noqa: E402
from repro_torch.runtime import FaultInjector  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_stage_mesh, make_test_mesh  # noqa: E402
from repro_torch.parallel import moe_ep  # noqa: E402
from repro_torch.parallel.axes import ShardingRules  # noqa: E402
from repro_torch.parallel.compression import (  # noqa: E402
    compressed_psum_grads, init_error_state, quantize,
)
from repro_torch.parallel.pipeline import (  # noqa: E402
    bubble_fraction, make_gpipe_loss, stage_params,
)

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
XLSTM = "xlstm-125m"  # phase 14's serving and training paths, at the same sizes
MOE = "deepseek-moe-16b"  # phase 15's serving and training paths
SCOUT = "llama4-scout-17b-a16e"  # its expert shapes, in phase 15's kernel checks
# phase 16's serving and training paths: vision cross-attention and the
# encoder-decoder
VLM, WHISPER = "llama-3.2-vision-11b", "whisper-medium"
# Serving main paths run at full size but for these, cut in depth at full
# width: deepseek-moe-16b's 16.9 G weights are drawn on the host (130-151 s
# of an H100 machine's run), and with phase 16 the script took 1,046-1,084 s
# of its 1,200; the vision model's 9.8 G took 65-91 s, and with phase 17 the
# script took 1,184 s on a slow host. Each layer's work and launches are the
# full model's; the vision model keeps 2 of its 8 groups.
SERVE_LAYERS = {MOE: 7, VLM: 10}
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
MAIN_TOKENS: dict = {}  # phase 3's greedy tokens by arch, for phase 17


class Failure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise Failure(what)


def cuda_ms(fn, n_sets: int, iters: int | None = None) -> float:
    """Mean device ms per call of ``fn(i)``. The calls cycle over
    ``n_sets`` input sets (so each finds its inputs outside L2, as on the
    serve path) and are replayed from a CUDA graph, so the host's launch
    rate does not enter the time. ``iters`` calls per graph (default at
    least 50; fewer for a call of thousands of kernels)."""
    iters = iters or max(50, n_sets)
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
    flash_ops._bwd_lib()
    ssm_ops._lib()
    ssm_ops._bwd_lib()
    slstm_ops._lib()
    slstm_ops._bwd_lib()
    gmm_ops._lib()
    flash_ops._decode_lib()
    adamw_ops._lib()
    dt = time.perf_counter() - t0
    print(f"[build] {len(libs)} kernels built and loaded in {dt:.1f} s", flush=True)
    for name, path in libs.items():
        log = os.path.splitext(path)[0] + ".log"
        if os.path.isfile(log):
            fn = ""
            for line in open(log):
                if "Compiling entry function" in line:
                    fn = _kernel_tag(line.split("'")[1])
                elif "Used" in line or "spill" in line:
                    print(f"[build] {name} {fn}: {line.strip().replace('ptxas info    : ', '')}")
    RESULTS["phases"]["build_s"] = dt


# the kernels of each variant, by function name (csrc/*.cu)
_VARIANT_OF = {"dos_matmul_skinny": "skinny", "dos_matmul_wgmma": "wgmma",
               "dos_matmul_wmma": "general", "dos_matmul_fma": "f32",
               "flash_mma": "mma", "flash_fwd": "fma", "flash_bwd_mma": "mma", "flash_bwd": "fma",
               "ssd_mma": "mma", "ssd_fwd": "fma", "ssd_bwd_mma": "mma", "ssd_bwd": "fma",
               "slstm_fwd_reg": "reg", "slstm_fwd": "fma", "slstm_bwd_reg": "reg",
               "slstm_bwd": "fma", "gmm_fwd_wgmma": "wgmma",
               "gmm_fwd_fma": "fma", "gmm_dw_wgmma": "wgmma", "gmm_dw_fma": "fma",
               "adamw_flat": "update", "adamw_strided": "update", "sum_squares": "norm",
               "decode_split": "split", "decode_combine": "split"}


def _variant_tag(name: str) -> str:
    """``name`` led by its kernel's variant, where it is one of the port's."""
    for key, variant in _VARIANT_OF.items():
        if key in name:
            return f"[{variant}] {name}"
    return name


def _kernel_tag(mangled: str) -> str:
    """A readable name for a compiled kernel: the demangled signature's
    function and template arguments, led by its variant."""
    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True, text=True,
                              timeout=10).stdout.strip() or mangled
    except OSError:
        name = mangled
    return _variant_tag(name.replace("(anonymous namespace)::", "").split("(")[0]
                        .replace("void ", ""))


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def xlstm_block_counts(cfg) -> tuple[int, int]:
    """(mLSTM blocks, sLSTM blocks) of an xLSTM config."""
    n_s = sum(1 for i in range(cfg.n_layers) if i in cfg.slstm_at)
    return cfg.n_layers - n_s, n_s


def xlstm_gemms(cfg) -> tuple[int, int]:
    """(GEMMs of one forward, of which the (E, H) wi and wf ones): an
    mLSTM block's q k v i f o_gate o, an sLSTM block's z i f o_gate o, and
    the unembedding."""
    n_m, n_s = xlstm_block_counts(cfg)
    return 7 * n_m + 5 * n_s + 1, 2 * (n_m + n_s)


def expected_launches(cfg, gen_tokens: int = GEN) -> dict:
    """Kernel launches of one prefill (and of the ``gen_tokens - 1``
    decode steps) as the layers call them: a GEMM per projection, one
    flash call per attention layer in prefill, one scan per Mamba2 layer
    in prefill; an xLSTM's two scans per mLSTM block in prefill and one
    recurrence per sLSTM block in prefill and in each decode step; an MoE
    layer's router, shared-expert and attention GEMMs and its three
    grouped expert products in prefill and in each decode step; a vision
    cross layer's or whisper decoder layer's cross k and v projections
    and its cross-attention in prefill only (decode reads them from the
    cache), whisper's encoder in prefill only; one decode_attention per
    attention call of a decode step (self and cross)."""
    head = 1  # the unembedding, tied or not
    prefill = dict.fromkeys(KERNELS, 0)
    step = dict.fromkeys(KERNELS, 0)
    if cfg.family == "ssm":
        n_m, n_s = xlstm_block_counts(cfg)
        gemms = xlstm_gemms(cfg)[0]
        prefill.update(dos_matmul=gemms, ssm_scan=2 * n_m, slstm_scan=n_s)
        step.update(dos_matmul=gemms, slstm_scan=n_s)
        return {"prefill": prefill, "decode": {k: n * (gen_tokens - 1) for k, n in step.items()}}
    if cfg.family == "vlm":  # a self layer's 7; a cross layer's q o and MLP, k v in prefill
        n_groups, n_self = decoder._vlm_groups(cfg)
        n_attn = n_groups * n_self
        prefill.update(dos_matmul=7 * n_attn + 7 * n_groups + head,
                       flash_attention=n_attn + n_groups)
        step.update(dos_matmul=7 * n_attn + 5 * n_groups + head,
                    decode_attention=n_attn + n_groups)
        return {"prefill": prefill, "decode": {k: n * (gen_tokens - 1) for k, n in step.items()}}
    if cfg.family == "encdec":  # encoder q k v o wi wo; decoder q k v o, cross q o (k v), wi wo
        n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
        prefill.update(dos_matmul=6 * n_enc + 10 * n_dec + head,
                       flash_attention=n_enc + 2 * n_dec)
        step.update(dos_matmul=8 * n_dec + head, decode_attention=2 * n_dec)
        return {"prefill": prefill, "decode": {k: n * (gen_tokens - 1) for k, n in step.items()}}
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every  # shared-block calls
        n_mamba = n_attn * cfg.attn_every
        gemms = 6 * n_mamba + 7 * n_attn + head  # wx wz wB wC wdt wo; q k v o gate up down
    elif cfg.family == "moe":  # and three expert products per layer
        n_attn, n_mamba = cfg.n_layers, 0
        gemms = moe_layer_gemms(cfg) * n_attn + head
        prefill["grouped_matmul"] = step["grouped_matmul"] = 3 * n_attn
    else:
        n_attn, n_mamba = cfg.n_layers, 0
        gemms = 7 * n_attn + head
    prefill.update(dos_matmul=gemms, flash_attention=n_attn, ssm_scan=n_mamba)
    step.update(dos_matmul=gemms, decode_attention=n_attn)
    return {"prefill": prefill, "decode": {k: n * (gen_tokens - 1) for k, n in step.items()}}


def expected_serve_variants(cfg, gen_tokens: int = GEN) -> dict:
    """An xLSTM serve run's launches by kernel and variant, prefill and
    decode together: every prefill GEMM ``wgmma`` but the (E, H) wi and
    wf ones (their ldb of 4 is no TMA row: ``general``), every decode GEMM
    ``skinny`` (M = batch <= 16; neither prefill variant takes M <= 16,
    nor ``skinny`` M > 16, so the counts pin each phase's variants), the
    mLSTM's memory scan ``mma`` and its P = 1 normaliser ``fma``, the
    recurrence ``reg``."""
    n_m, n_s = xlstm_block_counts(cfg)
    gemms, gates = xlstm_gemms(cfg)
    out = {k: dict.fromkeys(fn.variants, 0) for k, fn in KERNELS.items()}
    out["dos_matmul"].update(wgmma=gemms - gates, general=gates,
                             skinny=gemms * (gen_tokens - 1))
    out["ssm_scan"].update(mma=n_m, fma=n_m)
    out["slstm_scan"].update(reg=n_s * gen_tokens)
    return out


def cross_serve_variants(cfg, gen_tokens: int = GEN) -> dict:
    """A vision or whisper serve run's launches by kernel and variant:
    every prefill GEMM ``wgmma`` (whisper's tied unembedding included: B
    is the table's transposed view, ldb = E), every decode GEMM ``skinny``
    (M = batch), every prefill attention ``mma``, every decode attention
    ``split``."""
    want = expected_launches(cfg, gen_tokens)
    out = {k: dict.fromkeys(fn.variants, 0) for k, fn in KERNELS.items()}
    out["dos_matmul"].update(wgmma=want["prefill"]["dos_matmul"],
                             skinny=want["decode"]["dos_matmul"])
    out["flash_attention"]["mma"] = want["prefill"]["flash_attention"]
    out["decode_attention"]["split"] = want["decode"]["decode_attention"]
    return out


def serve_cfg(arch):
    """The config of ``arch``'s serving main path (``SERVE_LAYERS``)."""
    cfg = get_config(arch)
    return cut_depth(cfg, SERVE_LAYERS[arch]) if arch in SERVE_LAYERS else cfg


def phase_main_path(arch):
    cfg = serve_cfg(arch)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    r = serve_loop(cfg, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, device="cuda")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gen_tokens = r["generated"]
    MAIN_TOKENS[arch] = gen_tokens.cpu()
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
    variants = dict(dos_matmul.variants)
    print(f"[main] {arch} dos_matmul launches by variant: {variants}", flush=True)
    summary["dos_matmul_variants"] = variants
    variants_of = {"ssm": expected_serve_variants, "moe": moe_serve_variants,
                   "vlm": cross_serve_variants, "encdec": cross_serve_variants}
    if cfg.family in variants_of:  # phases 14-16: every kernel's variants exact
        got = {k: dict(fn.variants) for k, fn in KERNELS.items()}
        want_v = variants_of[cfg.family](cfg)
        print(f"[main] {arch} launches by kernel and variant: {got}", flush=True)
        summary["variants"] = got
        check(got == want_v, f"{arch}: launches by variant {got}, expected {want_v}")
    else:
        check(variants["general"] == 0 and variants["f32"] == 0,
              f"{arch}: a bf16 main-path GEMM left the skinny and wgmma kernels: {variants}")
        check(variants["skinny"] + variants["wgmma"] == counts["dos_matmul"],
              f"{arch}: variants {variants} do not add up to {counts['dos_matmul']} launches")
        for kname, fn in (("flash_attention", flash_attention), ("ssm_scan", ssm_scan)):
            v = dict(fn.variants)
            print(f"[main] {arch} {kname} launches by variant: {v}", flush=True)
            summary[f"{kname}_variants"] = v
            check(v["fma"] == 0, f"{arch}: a bf16 main-path {kname} call launched fma: {v}")
            check(sum(v.values()) == counts[kname],
                  f"{arch}: {kname} variants {v} do not add up to {counts[kname]} launches")
    want = expected_launches(cfg)
    check(r["launches"] == want, f"{arch}: launches {r['launches']}, expected {want}")
    check(all(counts[k] > 0 for k, n in want["prefill"].items() if n),
          f"{arch}: a kernel of the path never launched: {counts}")
    RESULTS["main_paths"][arch] = summary
    return counts, r["step_p50_s"]


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def _gemm_case(gen, m, k, n, dtype, b_transposed, n_sets, offset=0):
    """Operand sets for a GEMM; the transposed case is the tied unembed
    (B = tok.T, a strided view of the (N, K) embedding table). ``offset``
    elements shift A's base off 16 bytes."""
    sets = []
    for _ in range(n_sets):
        a = torch.randn(m * k + offset, generator=gen, device="cuda").to(dtype)[offset:].view(m, k)
        if b_transposed:
            b = torch.randn(n, k, generator=gen, device="cuda").to(dtype).T
        else:
            b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
        sets.append((a, b))
    return sets


def gemm_plan(a, b):
    """The dos_matmul planner's choice for ``a @ b``, as the wrapper asks."""
    from repro_torch.kernels.dos_matmul import plan

    (m, k), n = a.shape, b.shape[1]
    b_t = b.stride(1) != 1
    return plan(m, n, k, a.dtype, b.stride(1) if b_t else b.stride(0), b_t,
                (a.data_ptr() | b.data_ptr()) % 16 == 0,
                n_sm=torch.cuda.get_device_properties(a.device).multi_processor_count)


def check_gemm(gen, m, k, n, dtype, b_transposed=False, time_it=True, offset=0):
    es = 2 if dtype == torch.bfloat16 else 4
    n_sets = max(1, math.ceil(COLD_BYTES / ((m * k + k * n) * es))) if time_it else 1
    sets = _gemm_case(gen, m, k, n, dtype, b_transposed, n_sets, offset)
    a, b = sets[0]
    p = gemm_plan(a, b)
    before = dict(dos_matmul.variants)
    out = dos_matmul(a, b, out_dtype=dtype)
    check(dos_matmul.variants[p.variant] == before[p.variant] + 1,
          f"dos_matmul {m}x{k}x{n}: planned {p.variant}, counted {dos_matmul.variants}")
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
           "b_transposed": b_transposed, "offset": offset, "variant": p.variant,
           "plan": p._asdict(), "max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "max_abs_err_vs_f32": err.max().item(), "max_ref": scale, "ok": ok}
    if time_it:
        row["bytes"], row["ops"] = dos_ops.work(m, k, n, es)[:2]
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"], dtype)
        row["ms"] = cuda_ms(lambda i: dos_matmul(*sets[i], out_dtype=dtype), len(sets))
        row["plain_ms"] = cuda_ms(lambda i: matmul_ref(*sets[i], dtype), len(sets))
        row["library_ms"] = cuda_ms(lambda i: torch.matmul(*sets[i]), len(sets))
    tiling = "" if p.variant in ("general", "f32") else f" bn {p.bn} split {p.split}"
    print(f"[kernels] dos_matmul {m}x{k}x{n} {row['dtype']}{' B^T' if b_transposed else ''}"
          f"{f' A+{offset}' if offset else ''} [{p.variant}{tiling}]: max|err| vs f32 "
          f"{row['max_abs_err_vs_f32']:.3g} (max|ref| {scale:.3g}) "
          + (f"kernel {row['ms']*1e3:.1f} us, plain {row['plain_ms']*1e3:.1f} us, "
             f"torch.matmul {row['library_ms']*1e3:.1f} us, bound {row['bound_ms']*1e3:.2f} us "
             f"({row['bound_by']})" if time_it else "")
          + ("" if ok else "  FAIL"), flush=True)
    check(ok, f"dos_matmul {m}x{k}x{n} {dtype} disagrees with its plain version")
    return row


def check_bit_identical(gen) -> dict:
    """Two calls of each variant on the same inputs give the same bits."""
    cases = {"skinny": (4, 10240, 2560, False), "skinny B^T": (4, 576, 49152, True),
             "wgmma": (512, 2560, 2560, False), "wgmma split": (512, 2560, 64, False),
             "wgmma B^T": (512, 576, 49152, True), "general": (37, 200, 130, False),
             "f32": (4, 576, 192, False)}
    out = {}
    for tag, (m, k, n, tr) in cases.items():
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        a, b = _gemm_case(gen, m, k, n, dtype, tr, 1)[0]
        variant = gemm_plan(a, b).variant
        check(variant == tag.split()[0], f"bit-identity case {tag} planned {variant}")
        same = torch.equal(dos_matmul(a, b), dos_matmul(a, b))
        out[tag] = same
        print(f"[kernels] dos_matmul {tag} {m}x{k}x{n}: two calls bit-identical: {same}",
              flush=True)
        check(same, f"dos_matmul {tag}: two calls on the same inputs differ")
    return out


def check_attn_scan_bit_identical(gen) -> dict:
    """Two calls of each flash_attention and ssm_scan variant on the same
    inputs give the same bits (neither uses atomics)."""
    out = {}
    cfg, hcfg = get_config(ARCH), get_config(HYBRID)
    for dtype in (torch.bfloat16, torch.float32):
        for c in (cfg, hcfg):
            q, k, v = (torch.randn(BATCH, PROMPT, hh, c.head_dim_, generator=gen,
                                   device="cuda").to(dtype) for hh in (c.n_heads, c.n_kv_heads,
                                                                       c.n_kv_heads))
            variant = _want_variant(dtype)
            tag = f"flash_attention {variant} H{c.n_heads}/{c.n_kv_heads} D{c.head_dim_}"
            call = functools.partial(flash_attention, q, k, v)
            o1, o2 = (_count_variant(flash_attention, variant, call) for _ in range(2))
            out[tag] = torch.equal(o1, o2)
        for chunk in CHUNKS:
            u, ld, B, C = _ssm_set(gen, BATCH, PROMPT, 80, 64, 64, dtype, True)
            variant = _want_variant(dtype)
            call = functools.partial(ssm_scan, u, ld, B, C, chunk=chunk)
            (y1, s1), (y2, s2) = (_count_variant(ssm_scan, variant, call) for _ in range(2))
            out[f"ssm_scan {variant} chunk {chunk}"] = torch.equal(y1, y2) and torch.equal(s1, s2)
    for tag, same in out.items():
        print(f"[kernels] {tag}: two calls bit-identical: {same}", flush=True)
        check(same, f"{tag}: two calls on the same inputs differ")
    return out


def wrapper_host_us(n_calls=1000) -> float:
    """Host time per call of the dos_matmul wrapper at a decode shape
    (smollm's 4x576x576, bf16): ``time.perf_counter`` over ``n_calls``
    back-to-back enqueues, after a warm-up. The device work per call is
    shorter than the host's, so the launch queue never fills."""
    a = torch.randn(BATCH, 576, device="cuda").to(torch.bfloat16)
    b = torch.randn(576, 576, device="cuda").to(torch.bfloat16)
    for _ in range(50):
        dos_matmul(a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        dos_matmul(a, b)
    us = (time.perf_counter() - t0) / n_calls * 1e6
    torch.cuda.synchronize()
    print(f"[kernels] dos_matmul wrapper host time at {BATCH}x576x576 bf16: {us:.3f} us per "
          f"call ({n_calls} back-to-back enqueues)", flush=True)
    return us


def sweep_dos_matmul() -> list:
    """Every bf16 GEMM shape of the main paths (prefill M = 512 and decode
    M = 4) under each tiling its variant can take (BN, K split), timed as
    phase 4 times kernels, beside torch.matmul: the measurements the
    planner's constants (kernels/dos_matmul/ops.py) are fitted to. Each
    tiling's output is held against the f32 result first."""
    from repro_torch.kernels.dos_matmul import ops

    lib, gen, rows = ops._lib(), torch.Generator(device="cuda").manual_seed(0), []
    cdiv = lambda x, y: -(-x // y)  # noqa: E731
    shapes = {(m, k, n, tr) for arch in PATHS for m in (BATCH * PROMPT, BATCH)
              for (k, n, tr) in path_gemms(get_config(arch))}
    for m, k, n, tr in sorted(shapes):
        n_sets = max(1, math.ceil(COLD_BYTES / ((m * k + k * n) * 2)))
        sets = _gemm_case(gen, m, k, n, torch.bfloat16, tr, n_sets)
        outs = [torch.empty(m, n, device="cuda", dtype=torch.bfloat16) for _ in sets]
        exact = matmul_ref(*sets[0], torch.float32)
        chosen = gemm_plan(*sets[0])
        cands = set()
        if m <= ops.SKINNY_MAX_M:
            for bn in ((64,) if tr else (64, 128)):
                for split in range(1, ops.MAX_CLUSTER + 1):
                    kc = max(8, cdiv(cdiv(k, split), 8) * 8)
                    cands.add(ops.Plan("skinny", chosen.bm, bn, cdiv(k, kc), kc))
        else:
            for bn in (64, 128, 192, 256):
                for split in range(1, ops._W_MAX_SPLIT + 1):
                    per = cdiv(cdiv(k, ops.W_BK), split)
                    cands.add(ops.Plan("wgmma", ops.W_BM, bn, cdiv(cdiv(k, ops.W_BK), per),
                                       per * ops.W_BK))
        line = []
        for p in sorted(cands, key=lambda q: (q.bn, q.split)):
            args = ops._Launch(m, n, k, sets[0][1].stride(0), sets[0][1].stride(1), 1, 1,
                               ops._CODES[p.variant], p.bm, p.bn, p.split, p.k_chunk)

            def fn(i, args=args):
                a, b = sets[i]
                err = lib.dos_matmul_launch(a.data_ptr(), b.data_ptr(), outs[i].data_ptr(), args,
                                            torch.cuda.current_stream().cuda_stream)
                check(err == 0, f"sweep launch {p} failed: {err}")

            fn(0)
            torch.cuda.synchronize()
            check(bool(((outs[0].float() - exact).abs()
                        <= 2.0**-8 * exact.abs() + 1e-5 * exact.abs().max()).all()),
                  f"sweep {m}x{k}x{n} {p} disagrees with its plain version")
            us = cuda_ms(fn, n_sets) * 1e3
            rows.append(dict(m=m, k=k, n=n, b_transposed=tr, plan=p._asdict(), us=us,
                             chosen=p == chosen))
            line.append(f"{p.bn}/{p.split}:{us:.1f}{'*' if p == chosen else ''}")
        lib_us = cuda_ms(lambda i: torch.matmul(*sets[i]), n_sets) * 1e3
        rows.append(dict(m=m, k=k, n=n, b_transposed=tr, library_us=lib_us))
        print(f"[sweep] {chosen.variant} {m}x{k}x{n}{' B^T' if tr else ''} torch.matmul "
              f"{lib_us:.1f} us | BN/split: " + " ".join(line), flush=True)
    return rows


def _off16(t):
    """``t``'s values in a tensor of its shape whose base lies 2 bytes off
    16-byte alignment: a layout the mma variants do not take."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _want_variant(dtype, layout="aligned"):
    """The variant a flash_attention or ssm_scan call must launch, from
    its inputs alone: bf16 operands with 16-byte rows take the tensor
    cores (mma); f32 operands, or a base off 16 bytes or a strided inner
    dimension, take the CUDA cores (fma)."""
    return "mma" if dtype == torch.bfloat16 and layout == "aligned" else "fma"


def _count_variant(fn, want, call):
    """``call()``, which must launch ``fn``'s ``want`` variant once."""
    before = dict(fn.variants)
    out = call()
    check(fn.variants == dict(before, **{want: before[want] + 1}),
          f"expected one {want} launch; counted {fn.variants} (before {before})")
    return out


def decode_exact(q, kc, vc, *, length, window=None, scale=None, return_lse=False):
    """The f32 result of ``decode_attention``'s semantics on the same
    operands, ``(o, lse)``: q' = q scaled in f32 and rounded to q's dtype,
    f32 scores and sums, p unrounded (the plain version rounds the
    normalised p to the cache's dtype before P V; the kernel need not)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qr = (q.float() * scale).to(q.dtype).float()
    return decode_attention_ref(qr, kc.float(), vc.float(), length=length, window=window,
                                scale=1.0, return_lse=True)


def _dead_rows_agree(got, exact) -> bool:
    """Whether ``got`` is infinite (an lse of -inf: a row with no visible
    slot) exactly where ``exact`` is."""
    return bool((torch.isinf(got) == torch.isinf(exact)).all())


def events_ms(fn, reps=10) -> float:
    """Device ms per call of ``fn()`` between CUDA events, over ``reps``
    calls after two warm ones (for calls that launch many kernels each or
    that a graph capture cannot hold)."""
    fn(), fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def check_decode(gen, b, s, h, kvh, d, dtype, length=None, window=None, return_lse=False,
                 time_it=False, kv_dtype=None, strided=False):
    """``decode_attention`` on the card against ``decode_exact`` of the same
    operands: 1e-5 absolute (phase 4's flash gate) plus one bf16 rounding
    of each entry of a bf16 output; the lse within 1e-5 of its size; a row
    with no visible slot exact zeros and lse -inf. ``length``: an int (s
    if None) or one per row (a tensor on the card). ``kv_dtype``: the
    cache's, if not q's; ``strided``: the caches are the slots s/2.. of
    twice as long a cache. Timed: the kernel, the plain version and SDPA
    with a boolean mask, on input sets cold in L2."""
    kv_dtype = kv_dtype or dtype
    length = s if length is None else length
    lengths = torch.tensor(length, device="cuda") if isinstance(length, list) else length
    rows = length if isinstance(length, list) else [length] * b
    es, kv_es = torch.finfo(dtype).bits // 8, torch.finfo(kv_dtype).bits // 8
    per_set = b * h * d * es + 2 * b * s * kvh * d * kv_es
    n_sets = max(1, math.ceil(COLD_BYTES / per_set)) if time_it else 1

    def one_set():
        q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dtype)
        kv = torch.randn(2, b, 2 * s if strided else s, kvh, d, generator=gen,
                         device="cuda").to(kv_dtype)
        if strided:
            kv = kv[:, :, s:]
        return q, kv[0], kv[1]

    sets = [one_set() for _ in range(n_sets)]
    q, kc, vc = sets[0]
    kw = dict(length=lengths, window=window, return_lse=return_lse)
    got = _count_variant(decode_attention, "split", lambda: decode_attention(q, kc, vc, **kw))
    plain = decode_attention_ref(q, kc, vc, **kw)
    exact_o, exact_lse = decode_exact(q, kc, vc, **kw)
    torch.cuda.synchronize()
    o, lse = got if return_lse else (got, None)
    plain_o = plain[0] if return_lse else plain
    dead = torch.isinf(exact_lse)
    tol = 1e-5 + (2.0**-8 * exact_o.abs() if o.dtype == torch.bfloat16 else 0.0)
    ok = (o.dtype == (torch.float32 if return_lse else dtype) and o.shape == q.shape
          and bool(((o.float() - exact_o).abs() <= tol).all()) and bool((o[dead] == 0).all()))
    if return_lse:
        live = ~dead
        ok = ok and bool((lse[dead] == -math.inf).all()) and bool(
            ((lse - exact_lse)[live].abs() <= 1e-5 * exact_lse[live].abs().clamp(min=1)).all())
    tag = (f"B{b} S{s} H{h}/{kvh} D{d} q {str(dtype).split('.')[-1]} cache "
           f"{str(kv_dtype).split('.')[-1]} length {length} window {window}"
           f"{' lse' if return_lse else ''}{' strided' if strided else ''}")
    row = {"case": tag, "max_abs_err": (o.float() - plain_o.float()).abs().max().item(),
           "max_abs_err_vs_f32": (o.float() - exact_o).abs().max().item(),
           "dead_rows": int(dead.sum()), "ok": ok}
    if time_it:
        row["bytes"], row["ops"] = flash_ops.decode_work(b, s, h, kvh, d, es, kv_es, rows, window,
                                                         return_lse)[:2]
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"], kv_dtype)
        row["ms"] = cuda_ms(lambda i: decode_attention(*sets[i], **kw), n_sets)
        row["plain_ms"] = cuda_ms(lambda i: decode_attention_ref(*sets[i], **kw), n_sets)
        pos = torch.arange(s, device="cuda")
        n = lengths.reshape(-1, 1) if isinstance(lengths, torch.Tensor) else lengths
        mask = ((pos < n) & (pos >= n - window) if window is not None else pos < n)
        mask = mask.expand(b, s)[:, None, None, :]

        def sdpa(i):
            q_, k_, v_ = (t.transpose(1, 2) for t in sets[i])
            return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask, enable_gqa=True)

        row["library_ms"] = cuda_ms(sdpa, n_sets) if kv_dtype == dtype else None
    print(f"[kernels] decode_attention {tag}: max|err| vs f32 {row['max_abs_err_vs_f32']:.3g}, "
          f"vs plain {row['max_abs_err']:.3g}, {row['dead_rows']} rows with no slot"
          + (f"; kernel {row['ms']*1e3:.2f} us, plain {row['plain_ms']*1e3:.2f} us, sdpa "
             + (f"{row['library_ms']*1e3:.2f} us" if row["library_ms"] is not None else "n/a")
             + f", bound {row['bound_ms']*1e3:.2f} us ({row['bound_by']})" if time_it else "")
          + ("" if ok else "  FAIL"), flush=True)
    check(ok, f"decode_attention {tag} disagrees with its semantics' f32 result")
    return row


def decode_paths() -> list:
    """Each serving path's decode attention calls of one step, mid-way
    through its 31 steps: (path, calls a step, b, cache slots, h, kvh, d,
    length) for its self caches (PROMPT + GEN slots) and its cross caches
    (every key visible)."""
    half = PROMPT + GEN // 2
    out = []
    for arch in (ARCH, HYBRID, MOE, VLM, WHISPER):
        cfg = serve_cfg(arch)
        n = expected_launches(cfg)["decode"]["decode_attention"] // (GEN - 1)
        shape = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
        if cfg.family == "vlm":
            n_groups = decoder._vlm_groups(cfg)[0]
            out.append((f"{arch} cross", n_groups, BATCH, cfg.n_image_tokens, *shape,
                        cfg.n_image_tokens))
            n -= n_groups
        elif cfg.family == "encdec":
            out.append((f"{arch} cross", n // 2, BATCH, cfg.enc_seq, *shape, cfg.enc_seq))
            n //= 2
        out.append((arch, n, BATCH, PROMPT + GEN, *shape, half))
    return out


def phase_decode_kernels() -> tuple[dict, float]:
    """Phase 4's decode attention: every serving path's decode shapes in
    bf16, timed, summed over one decode step of each path; then f32, a
    window, per-batch lengths with a zero-length row, ``return_lse``, a
    strided cache and a bf16 q over an f32 cache (the vision model with
    f32 image embeddings). Returns the summed row and the largest
    |kernel - plain|."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    total = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops")}
    err, rows = 0.0, []
    for path, calls, b, s, h, kvh, d, length in decode_paths():
        row = check_decode(gen, b, s, h, kvh, d, torch.bfloat16, length=length, time_it=True)
        rows.append(dict(row, path=path, calls_per_step=calls))
        for k in total:
            total[k] += calls * row[k]
        err = max(err, row["max_abs_err"])
        lens = [length, 0] + [length - 1] * (b - 2)  # per-batch lengths, a zero-length row
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_decode(gen, b, s, h, kvh, d, dtype, length=lens, return_lse=True))
        rows.append(check_decode(gen, b, s, h, kvh, d, torch.float32, length=length))
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_decode(gen, 3, 513, 4, 1, 256, dtype, length=[513, 7, 200], window=64))
        rows.append(check_decode(gen, 2, 40, 8, 1, 32, dtype, length=40, window=0))
        rows.append(check_decode(gen, 2, 200, 40, 8, 128, dtype, length=[1, 199], window=24,
                                 return_lse=True))
        rows.append(check_decode(gen, BATCH, 1500, 16, 16, 64, dtype, length=900, strided=True))
    rows.append(check_decode(gen, BATCH, 1600, 32, 8, 128, torch.bfloat16,
                             kv_dtype=torch.float32))
    err = max([err] + [r["max_abs_err"] for r in rows])
    total["bound_by"] = ("bytes" if total["bytes"] / HBM_BYTES_S
                         >= total["ops"] / PEAK_OPS_S[torch.bfloat16] else "operations")
    print(f"[kernels] decode_attention, one decode step of each serving path: kernel "
          f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, sdpa {total['library_ms']:.4f} "
          f"ms, bound {total['bound_ms']:.4f} ms ({total['bound_by']})", flush=True)
    RESULTS["decode_attention"] = {"rows": rows, "step_total": total}
    return total, err


def check_flash(gen, b, sq, skv, h, kvh, d, dtype, causal=True, window=None, q_offset=0,
                time_it=False, layout="aligned"):
    """``layout`` "offset" moves each operand's base 2 bytes off 16 (fma)."""
    per_set = (b * sq * h + 2 * b * skv * kvh) * d * (2 if dtype == torch.bfloat16 else 4)
    n_sets = max(1, math.ceil(COLD_BYTES / per_set)) if time_it else 1
    sets = [tuple(torch.randn(b, s, hh, d, generator=gen, device="cuda").to(dtype)
                  for s, hh in ((sq, h), (skv, kvh), (skv, kvh))) for _ in range(n_sets)]
    if layout == "offset":
        sets[0] = tuple(_off16(t) for t in sets[0])
    q, k, v = sets[0]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    variant = _want_variant(dtype, layout)
    out = _count_variant(flash_attention, variant, lambda: flash_attention(q, k, v, **kw))
    plain = attention_ref(q, k, v, **kw)
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err = (out.float() - exact).abs()
    # f32 math on both sides -> 1e-5 absolute (|v| is O(1)); a bf16
    # output adds one rounding: 2**-8 of each entry.
    tol = (2.0**-8 * exact.abs() if dtype == torch.bfloat16 else 0.0) + 1e-5
    ok = bool((err <= tol).all())
    tag = (f"B{b} Sq{sq} Skv{skv} H{h}/{kvh} D{d} {str(dtype).split('.')[-1]} "
           f"causal={causal} window={window} q_offset={q_offset}"
           f"{' base+2B' if layout == 'offset' else ''} [{variant}]")
    row = {"case": tag, "variant": variant,
           "max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "max_abs_err_vs_f32": err.max().item(), "ok": ok}
    if time_it:
        es = 2 if dtype == torch.bfloat16 else 4
        check(q_offset == 0 and (window or skv) >= skv,
              "the library yardstick (sdpa) covers attention with no window or offset only")
        row["bytes"], row["ops"] = flash_ops.work(b, sq, skv, h, kvh, d, es, causal, window,
                                                  q_offset)[:2]
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


def check_ssm(gen, bt, s, h, p, n, dtype, shared_bc=True, chunk=CHUNK, time_it=False,
              layout="aligned"):
    """``layout`` "offset" moves u's base 2 bytes off 16, "strided" reads u
    with a stride of 2 along P (both fma)."""
    es = 2 if dtype == torch.bfloat16 else 4
    n_bytes, n_ops = ssm_ops.work(bt, s, h, p, n, es, shared_bc, chunk)[:2]
    n_sets = max(1, math.ceil(COLD_BYTES / n_bytes)) if time_it else 1
    sets = [_ssm_set(gen, bt, s, h, p, n, dtype, shared_bc) for _ in range(n_sets)]
    u, ld, B, C = sets[0]
    if layout == "offset":
        u = _off16(u)
    elif layout == "strided":
        u = torch.stack([u, u], dim=-1).flatten(-2)[..., ::2]
    variant = _want_variant(dtype, layout) if p % 8 == 0 else "fma"  # plan's P rule
    y, st = _count_variant(ssm_scan, variant, lambda: ssm_scan(u, ld, B, C, chunk=chunk))
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
           f"{' B/C broadcast' if shared_bc else ''}"
           f"{'' if layout == 'aligned' else ' u ' + layout} [{variant}]")
    row = {"case": tag, "variant": variant,
           "max_abs_err": max((y.float() - py.float()).abs().max().item(),
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
    # each variant's edges: M on both sides of the skinny limit and of the
    # wgmma tile, N ragged against the 64/128/256 tiles, both B layouts,
    # K and ldb that TMA cannot describe (general at M > 16), A's base
    # off 16 bytes
    for m in (1, 2, 3, 16, 17, 63, 65, 200):
        check_gemm(gen, m, 2560, 80, torch.bfloat16, time_it=False)
        check_gemm(gen, m, 576, 1000, torch.bfloat16, b_transposed=True, time_it=False)
        check_gemm(gen, m, 200, 130, torch.bfloat16, time_it=False)
        check_gemm(gen, m, 100, 300, torch.bfloat16, b_transposed=True, time_it=False)
        check_gemm(gen, m, 1536, 576, torch.bfloat16, time_it=False, offset=1)
    RESULTS["dos_matmul_bit_identical"] = check_bit_identical(gen)
    RESULTS["dos_matmul_host_us"] = wrapper_host_us()

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
        # bf16 cases in both layouts: aligned plans mma, a base off 16 bytes fma
        for layout in (("aligned", "offset") if dtype == torch.bfloat16 else ("aligned",)):
            fl = functools.partial(check_flash, gen, dtype=dtype, layout=layout)
            if dtype == torch.float32 or layout == "offset":
                fl(BATCH, PROMPT, PROMPT, h, kvh, hd)
                fl(BATCH, PROMPT, PROMPT, hh, hkvh, hhd)  # zamba2's D 80
            fl(BATCH, 200, 200, h, kvh, hd)  # ragged
            fl(BATCH, PROMPT, PROMPT, h, kvh, hd, window=32)
            fl(2, PROMPT, PROMPT, 4, 1, 256)  # gemma3's D, MQA
            fl(2, 64, 200, 4, 2, 32, q_offset=136)  # queries at the end
            fl(2, 64, 64, 4, 4, 128, causal=False, window=2**30)
            fl(1, 70, 70, 2, 1, 64, window=0)  # no visible key: mean(v)
            fl(2, 90, 90, 4, 4, 80, window=16)  # D 80, ragged, window
    for d in flash_ops.HEAD_DIMS:  # mma at every head dim, a ragged tail
        check_flash(gen, 2, 100, 100, 6, 2, d, torch.bfloat16)

    # zamba2's prefill scan: u (Bt, S, H, P) bf16, ld f32, B/C broadcast over the heads
    sh = (BATCH, PROMPT, hcfg.ssm_expand * hcfg.d_model // hcfg.ssm_head_dim,
          hcfg.ssm_head_dim, hcfg.ssm_state)
    by_chunk = {c: check_ssm(gen, *sh, torch.bfloat16, chunk=c, time_it=True) for c in CHUNKS}
    add("ssm_scan", by_chunk[CHUNK], calls["ssm_scan"], HYBRID)
    RESULTS["ssm_scan_by_chunk"] = by_chunk
    for dtype in (torch.bfloat16, torch.float32):
        # bf16 cases in three layouts: aligned plans mma; u off 16 bytes or
        # with a stride of 2 along P, fma
        for layout in (("aligned", "offset", "strided") if dtype == torch.bfloat16
                       else ("aligned",)):
            for c in CHUNKS:
                sc = functools.partial(check_ssm, gen, dtype=dtype, chunk=c, layout=layout)
                if dtype == torch.float32 or layout != "aligned":
                    sc(*sh)
                sc(2, 200, 8, 64, 64)  # ragged S
                sc(2, 20, 8, 64, 64, shared_bc=False)  # S < T
                sc(1, 512, 8, 64, 64)  # many chunks
                sc(2, 40, 16, 16, 16, shared_bc=False)  # N = P = 16
                sc(1, 100, 2, 192, 96, shared_bc=False)  # P tiles, N 96
    for n in ssm_ops.STATE_DIMS:  # mma at every N and chunk, a ragged P tile (P = 40)
        for c in CHUNKS:
            check_ssm(gen, 2, 100, 3, 40, n, torch.bfloat16, chunk=c)
    RESULTS["attn_scan_bit_identical"] = check_attn_scan_bit_identical(gen)

    RESULTS["kernel_rows"] = rows
    RESULTS["kernel_totals"] = totals
    return totals, main_err


# ---------------------------------------------------------------------------
# phase 5: end to end against the plain path on the CPU
# ---------------------------------------------------------------------------


def _e2e_setup(arch, dtype=None):
    """The path's config as the card-vs-CPU checks run it (zamba2, the
    MoE, the vision model and whisper with their depth and batch cut),
    CPU and card models, the CPU's parameters (the vision model's gates
    opened to VLM_GATE) and the prefill's batch on the CPU."""
    cfg, batch = get_config(arch), BATCH
    if cfg.family == "hybrid":
        cfg, batch = dataclasses.replace(cfg, n_layers=HYBRID_E2E_LAYERS), HYBRID_E2E_BATCH
    elif cfg.family == "ssm":  # full depth, batch 2: the CPU side stays short
        batch = HYBRID_E2E_BATCH
    elif cfg.family == "moe":  # full width, 2 layers, batch 2
        cfg, batch = dataclasses.replace(cfg, n_layers=MOE_E2E_LAYERS), MOE_E2E_BATCH
    elif cfg.family in ("vlm", "encdec"):  # full width, depth cut, batch 2
        cfg, batch = dataclasses.replace(cfg, **CROSS_E2E_DEPTH[cfg.family]), CROSS_E2E_BATCH
    if dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    mc, mg = build(cfg, "cpu"), build(cfg, "cuda")
    # compute_params(init()) is init_compute() bit for bit; the draw is shared
    params_c = mc.compute_params(_cpu_master(dataclasses.replace(cfg, compute_dtype="float32")))
    return cfg, batch, mc, mg, params_c, prefill_batch(cfg, batch, "cpu")


@functools.lru_cache(maxsize=1)
def _cpu_master(cfg):
    """``cfg``'s f32 master weights on the CPU from seed 0 (the vision
    model's gates opened to VLM_GATE), drawn once for a path's bf16 and
    f32 checks: a full-width draw takes the host seconds a billion."""
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    if cfg.family == "vlm":
        params["cross_layers"]["gate"].fill_(VLM_GATE)
    return params


def phase_e2e(arch, dtype=None, tol=E2E_TOL):
    """Card against CPU end to end: prefill logits and E2E_DECODE_STEPS
    teacher-forced decode steps. Returns what the profile of a decode
    step needs (the card's model, parameters, cache and next token) and
    the CPU's prefill logits."""
    cfg, batch, mc, mg, params_c, pf_batch = _e2e_setup(arch, dtype)
    params_g = map_tree(lambda t: t.to("cuda"), params_c)
    max_len = PROMPT + E2E_DECODE_STEPS + PROFILE_STEPS + 2
    lg, cg = mg.prefill(params_g, {k: t.cuda() for k, t in pf_batch.items()}, max_len=max_len)
    lc, cc = mc.prefill(params_c, pf_batch, max_len=max_len)
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


# the blocks recorded by module: the decoder's (the vision model's cross
# k, v projections among them) and the encoder-decoder's
_BLOCKS = {decoder: ("mamba_block", "_attn_mlp_block", "mlstm_block", "slstm_block",
                     "compute_cross_kv", "unembed"),
           encdec: ("_enc_layer", "compute_cross_kv", "_dec_layer", "unembed")}


def _tree(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return tree


def recorded_blocks(run, module=decoder):
    """Run ``run()`` with ``module``'s blocks recorded: returns its result
    and every call as (name, function, args, kwargs, output). The state
    and cache arguments are copied before each call and the outputs after
    it (decode writes states in place); weights and activations are not
    modified and are kept."""
    calls, originals = [], {n: getattr(module, n) for n in _BLOCKS[module]}

    def hook(name):
        fn = originals[name]

        def recorded(*args, **kwargs):
            kept = {k: _tree(torch.clone, v) if k in ("state", "cache") else v
                    for k, v in kwargs.items()}
            out = fn(*args, **kwargs)
            # a copy: an xLSTM block's prefill state is the cache that the
            # decode steps then write in place
            calls.append((name, fn, args, kept, _tree(torch.clone, out)))
            return out

        return recorded

    for n in originals:
        setattr(module, n, hook(n))
    try:
        result = run()
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)
    return result, calls


def phase_e2e_blocks(arch):
    """Card against CPU block by block: the CPU runs the prefill and
    E2E_DECODE_STEPS teacher-forced decode steps; every call of a Mamba2
    block, of an attention+MLP block (the shared, self-attention or gated
    cross-attention one), of an mLSTM or sLSTM block, of a cross k, v
    projection, of whisper's encoder and decoder layers and of the head
    is run again on the card with the CPU's inputs and states, and each
    output (the block's output, and a Mamba2 block's new SSM and conv
    states or an xLSTM block's new state) must agree within the bf16 band
    of the CPU's. Returns the CPU's prefill logits."""
    cfg, batch, mc, _, params_c, pf_batch = _e2e_setup(arch)

    def run():
        lc, cc = mc.prefill(params_c, pf_batch, max_len=PROMPT + E2E_DECODE_STEPS)
        first = lc
        for _ in range(E2E_DECODE_STEPS):
            lc, cc = mc.decode(params_c, cc, {"token": lc[:, -1:].argmax(dim=-1)})
        return first

    lc0, calls = recorded_blocks(run, encdec if cfg.family == "encdec" else decoder)
    worst: dict = {}
    for name, fn, args, kwargs, out in calls:
        got = fn(*_tree(lambda t: t.to("cuda"), args),
                 **_tree(lambda t: t.to("cuda"), kwargs))
        if name == "mamba_block":
            pairs = {"out": (got[0], out[0]), "ssm state": (got[1]["ssm"], out[1]["ssm"]),
                     "conv state": (got[1]["conv"], out[1]["conv"])}
        elif name in ("mlstm_block", "slstm_block"):
            pairs = {"out": (got[0], out[0]),
                     **{f"state {k}": (got[1][k], out[1][k]) for k in out[1]}}
        elif name in ("_attn_mlp_block", "_dec_layer"):
            pairs = {"out": (got[0], out[0])}
        elif name == "compute_cross_kv":
            pairs = {"k": (got[0], out[0]), "v": (got[1], out[1])}
        else:
            pairs = {"out" if name == "_enc_layer" else "logits": (got, out)}
        mode = kwargs["mode"] if "mode" in kwargs else (
            "prefill" if next(iter(pairs.values()))[1].shape[1] > 1 else "decode")
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


def prefill_batch(cfg, batch, device="cuda"):
    """The main path's prompts (batch x PROMPT, seed 1) and the model's
    other inputs (``model_inputs``, seed 0), as serving draws them."""
    prompts = torch.randint(0, cfg.vocab, (batch, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    return {k: t.to(device) for k, t in dict(model_inputs(cfg, batch, 0), tokens=prompts).items()}


def serve_decode_state(arch):
    """The serving main path's model (``serve_cfg``) with weights drawn on
    the card (fast; the values do not change the work) after a prefill of
    the main path's shape: what the profile of its decode step needs."""
    model = build(serve_cfg(arch), "cuda")
    params = model.init_compute(torch.Generator(device="cuda").manual_seed(0))
    logits, cache = model.prefill(params, prefill_batch(model.cfg, BATCH),
                                  max_len=PROMPT + PROFILE_STEPS + 2)
    return model, params, cache, logits[:, -1:].argmax(dim=-1)


# ---------------------------------------------------------------------------
# phase 6: where a prefill's and a decode step's time goes (torch.profiler)
# ---------------------------------------------------------------------------


def _profiled(run, host_ops=True):
    """Run ``run()`` under torch.profiler; returns the device busy us
    (kernel intervals merged), the device operations and the device us by
    kernel name (tagged with the port's variants). ``host_ops=False``
    records the device's activity only, which a step of tens of thousands
    of launches processes in a fraction of the time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t0, t1 = evt.time_range.start, evt.time_range.end
            spans.append((t0, t1))
            name = _variant_tag(evt.name)
            by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy, len(spans), by_name


def device_ms_per_call(call, reps=20):
    """Device ms per call of ``call(i)`` by kernel name, under
    torch.profiler: ``2 reps`` calls after a synchronize, of which each
    kernel's last ``k reps`` launches count (``k`` launches per call).
    A session can miss its first launches; a short one, such as 20 calls
    of a 0.1 ms kernel, by half of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(2 * reps):
            call(i)
        torch.cuda.synchronize()
    spans: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(evt.name, []).append((evt.time_range.start, evt.time_range.end))
    out = {}
    for name, ts in spans.items():
        k = -(-len(ts) // (2 * reps))  # launches per call
        out[name] = sum(t1 - t0 for t0, t1 in sorted(ts)[-k * reps:]) / 1e3 / reps
    return out


def phase_profile_prefill(arch, reps=5):
    """One prefill of the serving main path's model (``serve_cfg``; batch
    4, prompt 128, weights drawn on the card from a seed) under
    torch.profiler: device busy ms, the idle share against the same
    prefill's wall time without the profiler (the median of ``reps``, host
    clock ending in a synchronize), and device ms by kernel."""
    model = build(serve_cfg(arch), "cuda")
    params = model.init_compute(torch.Generator(device="cuda").manual_seed(0))
    batch = prefill_batch(model.cfg, BATCH)

    def run():
        model.prefill(params, batch, max_len=PROMPT + 1)

    run()  # warm
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = sorted(walls)[reps // 2] * 1e3
    busy, n_ops, by_name = _profiled(run)
    del model, params
    torch.cuda.empty_cache()
    key = f"{arch} prefill"
    if not n_ops:
        print(f"[profile] {key}: the profiler recorded no device time: idle share not measured")
        RESULTS["profile"][key] = None
        return
    busy_ms = busy / 1e3
    by_kernel = {k: sum(us for n, us in by_name.items() if k in n) / 1e3
                 for k in ("dos_matmul", "flash", "ssd", "slstm", "gmm")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"[profile] {key}: device busy {busy_ms:.3f} ms of a {wall_ms:.3f} ms prefill (median "
          f"of {reps} without profiler): idle share {1 - busy_ms / wall_ms:.3f}; {n_ops} device "
          f"ops; dos_matmul {by_kernel['dos_matmul']:.3f} ms, flash_attention "
          f"{by_kernel['flash']:.3f} ms, ssm_scan {by_kernel['ssd']:.3f} ms, slstm_scan "
          f"{by_kernel['slstm']:.3f} ms, grouped_matmul {by_kernel['gmm']:.3f} ms "
          f"({by_kernel['gmm'] / busy_ms:.3f} of busy)", flush=True)
    for name, us in top:
        print(f"[profile]   {us / 1e3:9.3f} ms  {name[:90]}")
    RESULTS["profile"][key] = {"busy_ms": busy_ms, "wall_ms": wall_ms, "walls_ms":
                               [w * 1e3 for w in walls], "idle_share": 1 - busy_ms / wall_ms,
                               "device_ops": n_ops, "kernel_ms": by_kernel,
                               "top_ms": {n: us / 1e3 for n, us in top}}


def phase_profile(arch, model, params, cache, tok, step_p50_s):
    """Device busy time per decode step, from the profiler's kernel
    records (merged intervals), and the idle share it implies against the
    step time measured without the profiler (the main path's p50)."""
    model.decode(params, cache, {"token": tok})  # warm
    torch.cuda.synchronize()

    def run():
        nonlocal cache, tok
        for _ in range(PROFILE_STEPS):
            logits, cache = model.decode(params, cache, {"token": tok})
            tok = logits.argmax(dim=-1)

    busy, n_ops, by_name = _profiled(run)
    if not n_ops:
        print(f"[profile] {arch}: the profiler recorded no device time: idle share not measured")
        RESULTS["profile"][arch] = None
        return
    busy_ms = busy / 1e3 / PROFILE_STEPS
    idle = 1.0 - busy_ms / (step_p50_s * 1e3)
    dos_ms = sum(us for n, us in by_name.items() if "dos_matmul" in n) / 1e3 / PROFILE_STEPS
    slstm_ms = sum(us for n, us in by_name.items() if "slstm" in n) / 1e3 / PROFILE_STEPS
    gmm_ms = sum(us for n, us in by_name.items() if "gmm_" in n) / 1e3 / PROFILE_STEPS
    dec_ms = sum(us for n, us in by_name.items() if "decode_split" in n or "decode_combine" in n
                 ) / 1e3 / PROFILE_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {arch} decode step: device busy {busy_ms:.3f} ms of a {step_p50_s*1e3:.3f} ms "
          f"step (p50 without profiler): idle share {idle:.3f}; {n_ops / PROFILE_STEPS:.0f} "
          f"device ops per step; dos_matmul {dos_ms:.3f} ms per step"
          + (f", slstm_scan {slstm_ms:.3f} ms" if slstm_ms else "")
          + (f", grouped_matmul {gmm_ms:.3f} ms ({gmm_ms / busy_ms:.3f} of busy)"
             if gmm_ms else "")
          + (f", decode_attention {dec_ms:.3f} ms" if dec_ms else ""), flush=True)
    for name, us in top:
        print(f"[profile]   {us / PROFILE_STEPS:9.1f} us/step  {name[:90]}")
    RESULTS["profile"][arch] = {"busy_ms_per_step": busy_ms, "idle_share": idle,
                                "dos_matmul_ms_per_step": dos_ms, "slstm_ms_per_step": slstm_ms,
                                "grouped_matmul_ms_per_step": gmm_ms,
                                "decode_attention_ms_per_step": dec_ms,
                                "device_ops_per_step": n_ops / PROFILE_STEPS,
                                "top_us_per_step": {n: us / PROFILE_STEPS for n, us in top}}


# ---------------------------------------------------------------------------
# phase 7: calibration, the path that feeds the paper's model
# ---------------------------------------------------------------------------


def _cal_kernel(row):
    """The kernel and variant a calibration row's calls must launch, from
    the row alone: bf16 GEMMs plan to skinny at M <= 16 and to wgmma above;
    prefill attention and the scan take f32 operands, so fma; a decode row
    launches the decode kernel (``split``)."""
    fam, p = row["family"], row["params"]
    if fam == "gemm":
        return "dos_matmul", ("skinny" if p["m"] <= 16 else "wgmma")
    if fam == "ssm":
        return "ssm_scan", "fma"
    return ("flash_attention", "fma") if p["mode"] == "prefill" else ("decode_attention", "split")


def _cal_check_output(row, seed) -> float:
    """One call of the row's kernel on the card against its plain version
    on the same inputs (outside the timing), at phase 4's tolerances.
    Returns max|kernel - plain|."""
    args = calibrate._build_inputs(row, seed, "cuda")
    fam, mode = row["family"], row["params"].get("mode", "")
    out = calibrate._kernel_fn(fam, mode)(*args).float()
    if fam == "gemm":
        plain = matmul_ref(*args, torch.bfloat16).float()
        exact = matmul_ref(*args, torch.float32)
        tol = 2.0**-8 * exact.abs() + 1e-5 * exact.abs().max()  # one bf16 rounding
    elif fam == "ssm":
        plain = exact = ssm_scan_chunked(*args)[0]
        tol = 1e-4 * exact.abs().max()  # f32 summation order
    elif mode == "prefill":
        plain = exact = attention_ref(*args, causal=True)
        tol = 1e-5  # f32 math on both sides, O(1) outputs
    else:  # decode: f32 operands, f32 math on both sides
        q, kc, vc, length = args
        plain = exact = decode_attention_ref(q, kc, vc, length=length)
        tol = 1e-5
    torch.cuda.synchronize()
    check(bool(((out - exact).abs() <= tol).all()),
          f"calibration row {row['label']}: the card disagrees with the plain version")
    return (out - plain.float()).abs().max().item()


def _recording_measure_row(per_row: list):
    """A ``calibrate.measure_row`` that records each row's launches and
    launches by variant: the counts after the row less those before it
    (the caller sets the counts to 0 once, before the run)."""
    original = calibrate.measure_row

    def snapshot():
        return launch_counts(), {k: dict(fn.variants) for k, fn in KERNELS.items()}

    def recorded(row, **kw):
        c0, v0 = snapshot()
        out = original(row, **kw)
        c1, v1 = snapshot()
        per_row.append((row, {k: c1[k] - c0[k] for k in c1},
                        {k: {v: n - v0[k].get(v, 0) for v, n in v1[k].items()} for k in v1}))
        return out

    return recorded


def _check_row_launches(per_row, calls, what) -> tuple[dict, dict]:
    """Each row must launch its planned kernel and variant ``calls`` times
    and nothing else. Returns the counts summed over the rows, and by
    variant."""
    counts = {k: sum(c[k] for _, c, _ in per_row) for k in KERNELS}
    by_variant: dict = {}
    for row, c, variants in per_row:
        kname, variant = _cal_kernel(row)
        want = {k: (calls if k == kname else 0) for k in KERNELS}
        check(c == want, f"{what} row {row['label']}: launches {c}, expected {want}")
        if kname:
            check(variants[kname][variant] == calls,
                  f"{what} row {row['label']}: {kname} variants {variants[kname]}, "
                  f"expected {calls} {variant}")
            by_variant[f"{kname} {variant}"] = by_variant.get(f"{kname} {variant}", 0) + calls
    return counts, by_variant


def phase_calibration():
    """``run_calibration(CalibrateSpec(preset="default"))`` on the card:
    each row's launches counted by variant (``measure_row`` recorded, the
    counts set to 0 before the run), every output held against its plain
    version, the artifact's JSON round trip and the model it prices."""
    spec = calibrate.CalibrateSpec(preset="default")
    calls = 1 + max(spec.warmup, 1) + spec.reps  # the first (build) call, warmup, timed
    per_row, original = [], calibrate.measure_row
    calibrate.measure_row = _recording_measure_row(per_row)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = calibrate.run_calibration(spec)
    finally:
        calibrate.measure_row = original
    wall = time.perf_counter() - t0
    check(len(per_row) == len(res["rows"]) == 23, f"calibration measured {len(per_row)} rows")
    counts, by_variant = _check_row_launches(per_row, calls, "calibration")
    errs = {k: 0.0 for k in KERNELS}
    for (row, _, _), m in zip(per_row, res["rows"]):
        kname, variant = _cal_kernel(row)
        check(math.isfinite(m["t_s"]) and m["t_s"] > 0, f"{row['label']}: t_s {m['t_s']}")
        err = _cal_check_output(row, spec.seed)
        if kname:
            errs[kname] = max(errs[kname], err)
        print(f"[calibration] {row['label']:34s} {kname or 'plain torch':15s} "
              f"{variant or '':6s} t_s {m['t_s']*1e6:10.3f} us  (spread {m['spread_s']*1e6:.3f}) "
              f"{m['achieved_gflops']:10.1f} GFLOP/s {m['achieved_gbs']:8.1f} GB/s  model "
              f"{m['pred_s']*1e6:10.3f} us{'  holdout' if row['holdout'] else ''}", flush=True)
    art = res["artifact"]
    text = json.dumps(art.to_dict())
    back = calibrate.CalibratedBandwidth.from_dict(json.loads(text))
    check(json.dumps(back.to_dict()) == text, "the artifact does not survive a JSON round trip")
    grid = engine.DesignGrid.product(FIG5_WORKLOADS, FIG5_BUDGETS, FIG5_TIERS)
    same = _eval_diff(engine.evaluate(grid, bandwidth=art.bandwidth),
                      engine.evaluate(grid, bandwidth=back.bandwidth))
    check(not same, f"evaluate with the reloaded artifact differs in {same}")
    e = res["errors"]
    print(f"[calibration] {len(per_row)} rows in {wall:.2f} s; launches {counts} by variant "
          f"{by_variant}; fitted dram_gbs {res['dram_gbs_fitted']:.3f}, rates (FLOP/s) "
          f"{ {k: f'{v:.4g}' for k, v in res['rates_flops'].items()} }, overheads (s) "
          f"{ {k: f'{v:.4g}' for k, v in res['overhead_s'].items()} }; median rel. error: fit "
          f"{e['fit_median_rel_err']:.4f}, holdout {e['holdout_median_rel_err']:.4f}, "
          f"uncalibrated (the model's nominal TPU peaks) "
          f"{e['uncalibrated_holdout_median_rel_err']:.4f}; artifact JSON round trip and "
          f"evaluate() with it bit-identical", flush=True)
    RESULTS["calibration"] = {
        "wall_s": wall, "launches": counts, "launches_by_variant": by_variant,
        "max_abs_err": errs, "rows": res["rows"], "rates_flops": res["rates_flops"],
        "dram_gbs_fitted": res["dram_gbs_fitted"], "efficiency": res["efficiency"],
        "overhead_s": res["overhead_s"], "errors": e, "artifact": art.to_dict()}
    return counts, errs


# ---------------------------------------------------------------------------
# phase 8: the DSE engine's search on the card against numpy
# ---------------------------------------------------------------------------

# Fig. 5: M 64, N 147 (ResNet50's RN0), three K, budgets 2^12-2^18, 1-16 tiers
FIG5_WORKLOADS = [(64, k, 147) for k in (255, 2560, 12100)]
FIG5_BUDGETS = [2**12, 2**14, 2**16, 2**18]
FIG5_TIERS = range(1, 17)
DSE_BUDGETS = (2**14, 2**16, 2**18)


def _eval_diff(a, b) -> list:
    """Names of the EvalResult fields that differ (bits, dtype or shape)."""
    import numpy as np

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f")):
                bad.append(f.name)
    return bad


def _timed(fn, reps=3):
    """(result, seconds of each of ``reps`` calls; host clock)."""
    ts, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, ts


def phase_engine():
    import numpy as np

    out = {}
    grid = engine.DesignGrid.product(FIG5_WORKLOADS, FIG5_BUDGETS, FIG5_TIERS)
    n = grid.n_workloads * grid.n_points
    res_t, ts_t = _timed(lambda: engine.evaluate(grid, backend="torch"))
    res_n, ts_n = _timed(lambda: engine.evaluate(grid))
    bad = _eval_diff(res_t, res_n)
    check(not bad, f"Fig. 5: backend='torch' and 'numpy' differ in {bad}")
    flat = [np.repeat(np.asarray(FIG5_WORKLOADS)[:, i], grid.n_points) for i in range(3)]
    rc = [analytical.optimize_rc_batched(*flat, np.tile(grid.mac_budgets, 3),
                                         np.tile(grid.tiers, 3), backend=b)
          for b in ("torch", "numpy")]
    check(all(x.dtype == np.int64 and np.array_equal(x, y) for x, y in zip(*rc)),
          "Fig. 5: the int64 rows, cols and cycles differ between backends")
    i12 = FIG5_BUDGETS.index(2**18) * len(FIG5_TIERS) + 11
    s12 = float(res_t.speedup[2, i12])
    check(s12 == float(res_n.speedup[2, i12]) and round(s12, 2) == 9.57,
          f"Fig. 5 12-tier speedup {s12}")
    print(f"[engine] Fig. 5 grid ({n} points, every metric): torch (card) and numpy equal in "
          f"every EvalResult field and in the int64 rows/cols/cycles; 12-tier speedup at 2^18 "
          f"MACs, K 12100: {s12:.4f}x (torch) = {float(res_n.speedup[2, i12]):.4f}x (numpy); "
          f"evaluate s per call: torch {[round(t, 4) for t in ts_t]}, numpy "
          f"{[round(t, 4) for t in ts_n]}", flush=True)
    out["fig5"] = {"points": n, "speedup_12tier": s12, "torch_s": ts_t, "numpy_s": ts_n}

    wl = random_workloads()
    n = len(wl) * len(DSE_BUDGETS) * 16
    (tt, ct), ts_t = _timed(lambda: engine.optimal_tiers_batched(wl, DSE_BUDGETS, backend="torch"))
    (tn, cn), ts_n = _timed(lambda: engine.optimal_tiers_batched(wl, DSE_BUDGETS))
    check(tt.dtype == tn.dtype and np.array_equal(tt, tn) and np.array_equal(ct, cn),
          "dse sweep: backend='torch' and 'numpy' differ")
    pps = {b: n / min(ts) for b, ts in (("torch", ts_t), ("numpy", ts_n))}
    print(f"[engine] dse sweep (300 workloads x {len(DSE_BUDGETS)} budgets x 16 tiers = {n} "
          f"points, optimal_tiers_batched): equal tiers and cycles; s per call: torch "
          f"{[round(t, 4) for t in ts_t]}, numpy {[round(t, 4) for t in ts_n]}; best points/s: "
          f"torch {pps['torch']:.0f}, numpy {pps['numpy']:.0f}", flush=True)
    out["dse"] = {"points": n, "torch_s": ts_t, "numpy_s": ts_n, "points_per_s": pps}
    RESULTS["engine"] = out


# ---------------------------------------------------------------------------
# phase 9: the grid thermal solve (Fig. 8) on the card against the CPU
# ---------------------------------------------------------------------------

FIG8 = [(m, t, tech) for m in (4096, 16384, 65536) for t, tech in ((1, "2d"), (3, "tsv"),
                                                                     (3, "miv"))]
# The card and the CPU run the same f32 operations in the same order, so
# their temperatures should be bit-identical; the gate leaves 1e-3 degC
# (~130 f32 ulps at 70 degC) for a rounding difference carried to the stop.
THERMAL_TOL_C = 1e-3


def _recording_solves(solves):
    """``thermal._solve_stack`` made to append each solve's (T, iterations,
    seconds, host clock up to a synchronize) to ``solves``; returns the
    original, to put back."""
    original = thermal._solve_stack

    def recorded(*args, **kw):
        t0 = time.perf_counter()
        T, it = original(*args, **kw)
        if T.device.type == "cuda":
            torch.cuda.synchronize()
        solves.append((T, it, time.perf_counter() - t0))
        return T, it

    thermal._solve_stack = recorded
    return original


def thermal_cpu_reports(path):
    """Fig. 8's nine reports on the CPU, each with its recorded solve,
    saved to ``path`` (``torch.save``): phase 9's references, made in a
    process of their own while the card runs phases 3-8."""
    solves = []
    _recording_solves(solves)
    out = []
    for macs, tiers, tech in FIG8:
        r = thermal.thermal_report(macs, tiers, tech, device="cpu")
        T, it, secs = solves[-1]
        out.append({"T": T, "it": it, "s": secs, "bottom": r.bottom, "middle": r.middle})
    torch.save(out, path)


def _stop(run):
    """A started (process, file) run: the process killed if it still
    runs, its folder removed."""
    proc, path = run
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def start_thermal_cpu(tmp):
    """``thermal_cpu_reports`` in a subprocess on one CPU thread, so the
    host-bound phases beside it keep their cores: (the process, its file)."""
    path = os.path.join(tmp, "thermal_cpu.pt")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.torch.set_num_threads(1); chip_smoke.thermal_cpu_reports({path!r})")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    return proc, path


def phase_thermal(cpu_run):
    """Fig. 8's nine ``thermal_report`` calls on the card (the entry
    point), each held against the same report from the CPU (made by
    ``cpu_run``, the ``start_thermal_cpu`` process, beside phases 3-8);
    the solve is recorded for its iteration count and time (host clock
    up to a synchronize)."""
    proc, path = cpu_run
    log = proc.communicate(timeout=900)[0]
    check(proc.returncode == 0, f"the CPU's thermal reports exited {proc.returncode}: "
          f"{log[-2000:]}")
    cpu_reports = torch.load(path)
    solves = []
    original = _recording_solves(solves)
    rows = []
    try:
        for (macs, tiers, tech), cpu in zip(FIG8, cpu_reports):
            card = thermal.thermal_report(macs, tiers, tech)
            (tg, it_g, s_g), tc, it_c, s_c = solves[-1], cpu["T"], cpu["it"], cpu["s"]
            diff = (tg.cpu() - tc).abs().max().item()
            stats = [abs(a - b) for x, y in ((card.bottom, cpu["bottom"]),
                                             (card.middle or (), cpu["middle"] or ()))
                     for a, b in zip(x, y)]
            ok = diff <= THERMAL_TOL_C and max(stats) <= THERMAL_TOL_C and it_g == it_c
            tag = f"{macs} MACs x {tiers} {tech}"
            print(f"[thermal] {tag}: {it_g} iterations (CPU {it_c}), {s_g * 1e3:.1f} ms per "
                  f"solve on the card ({s_g / it_g * 1e6:.1f} us per iteration; CPU "
                  f"{s_c * 1e3:.1f} ms), T max {card.t_max_c:.3f} degC, max|card - cpu| "
                  f"{diff:.3g} degC (bit-identical: {diff == 0.0})" + ("" if ok else "  FAIL"),
                  flush=True)
            check(ok, f"thermal {tag}: the card and the CPU differ")
            rows.append({"config": [macs, tiers, tech], "iterations": it_g, "cpu_iterations": it_c,
                         "card_s": s_g, "cpu_s": s_c, "t_max_c": card.t_max_c,
                         "max_abs_diff_c": diff})
    finally:
        thermal._solve_stack = original
    capped = rows[FIG8.index((65536, 3, "tsv"))]
    check(capped["iterations"] == thermal._MAX_ITERS and round(capped["t_max_c"], 3) == 69.007,
          f"the capped configuration: {capped['iterations']} iterations, {capped['t_max_c']}")
    RESULTS["thermal"] = rows


# ---------------------------------------------------------------------------
# phase 10: the cycle-level systolic simulators on the card
# ---------------------------------------------------------------------------

SYSTOLIC_CASES = [(37, 48, 29, 8, 8), (20, 40, 50, 6, 16), (64, 24, 64, 16, 16)]  # M K N R C


def phase_systolic():
    """``simulate_os_2d`` and ``simulate_dos_3d`` (tiers 1-4) on the card,
    for shapes whose folds are ragged: ``out`` against A @ B (f64 on the
    host) at the reference test's rtol and atol of 1e-4, ``cycles``
    against Eq. 1 / Eq. 2 exactly."""
    import numpy as np

    rng = np.random.default_rng(0)
    rows = []
    for M, K, N, R, C in SYSTOLIC_CASES:
        A = rng.normal(size=(M, K)).astype(np.float32)
        B = rng.normal(size=(K, N)).astype(np.float32)
        exact = A.astype(np.float64) @ B.astype(np.float64)
        for L in range(0, 5):
            t0 = time.perf_counter()
            r = (systolic.simulate_os_2d(A, B, R, C) if L == 0
                 else systolic.simulate_dos_3d(A, B, R, C, L))
            out = r.out.cpu().numpy()
            dt = time.perf_counter() - t0
            tau = (analytical.tau_2d(M, K, N, R, C) if L == 0
                   else analytical.tau_3d(M, K, N, R, C, L))
            err = float(np.abs(out - exact).max())
            ok = (r.out.device.type == "cuda" and bool(np.all(np.abs(out - exact)
                                                              <= 1e-4 + 1e-4 * np.abs(exact)))
                  and r.cycles == int(tau))
            what = "os_2d" if L == 0 else f"dos_3d x{L}"
            print(f"[systolic] {what} {M}x{K}x{N} on {R}x{C} ({r.folds} folds): max|out - A@B| "
                  f"{err:.3g}, cycles {r.cycles} (Eq. {'1' if L == 0 else '2'}: {int(tau)}), "
                  f"{dt * 1e3:.1f} ms" + ("" if ok else "  FAIL"), flush=True)
            check(ok, f"systolic {what} {M}x{K}x{N} on {R}x{C}")
            rows.append({"case": [M, K, N, R, C, max(L, 1)], "sim": what, "max_abs_err": err,
                         "cycles": r.cycles, "s": dt})
    RESULTS["systolic"] = rows


# ---------------------------------------------------------------------------
# phase 11: the Study front door (python -m repro_torch run) on the card
# ---------------------------------------------------------------------------

FRONT_DOOR_TIMEOUT_S = 300


def _payload_of(result) -> dict:
    """The artifact's payload in its JSON form (what a saved artifact holds)."""
    return json.loads(result.to_json(indent=None))["payload"]


def _as_backend(s, backend):
    """The same Study at another backend (``device`` follows the engine's
    rule: the numpy backend takes none, except to measure a calibration)."""
    a = s.analysis
    device = a.device if (backend == "torch" or a.kind == "calibrate") else None
    return dataclasses.replace(s, analysis=dataclasses.replace(a, backend=backend,
                                                               device=device))


def _start_front_door(tmp, specs):
    """One shell per study, all started together: ``python -m repro_torch
    run SPEC --out ...``, SPEC the template ``repro_torch example-spec
    KIND`` prints (which sets ``backend='torch'``; written here by the CLI's
    own ``main``) or a full-width study's; the first template is piped as a
    user types it, ``python -m repro_torch example-spec KIND | python -m
    repro_torch run - --out ...``. (One ``example-spec`` process for each
    template would take 21 pythons where 13 do; their start-up on the
    host's cores is most of the phase.)"""
    import contextlib
    import io

    from repro_torch import cli

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"  # a dozen processes share the host's cores
    py = f"{sys.executable} -m repro_torch"
    procs = {}
    for i, (name, spec) in enumerate(specs.items()):
        out = os.path.join(tmp, f"artifact-{i}.json")
        if spec is None:  # an example-spec template
            extra = f" --cache {os.path.join(tmp, 'cache-example-calibrate')}" \
                if name == "calibrate" else ""
            if i == 0:  # piped as a user types it
                cmd = f"set -o pipefail; {py} example-spec {name} | {py} run - --out {out}{extra}"
            else:
                path = os.path.join(tmp, f"spec-{i}.json")
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    check(cli.main(["example-spec", name]) == 0, f"example-spec {name} failed")
                with open(path, "w") as f:
                    f.write(text.getvalue())
                cmd = f"{py} run {path} --out {out}{extra}"
        else:
            path = os.path.join(tmp, f"spec-{i}.json")
            spec.save(path)
            cmd = f"{py} run {path} --out {out}"
        log = open(os.path.join(tmp, f"log-{i}.txt"), "w")
        procs[name] = (subprocess.Popen(["bash", "-c", cmd], stdout=log, stderr=log, env=env,
                                        cwd=tmp, start_new_session=True), out, log)
    return procs


def _paired(fn_a, fn_b, reps):
    """Alternating reps of two calls of the same work (host clock): the
    outputs, each one's times, and the median paired difference over the
    best ``fn_a`` time (the reference's study_bench statistic)."""
    import numpy as np

    ta, tb, out = [], [], [None, None]
    for _ in range(reps):
        for i, (fn, acc) in enumerate(((fn_a, ta), (fn_b, tb))):
            t0 = time.perf_counter()
            out[i] = fn()
            acc.append(time.perf_counter() - t0)
    over = float(np.median(np.asarray(tb) - np.asarray(ta))) / min(ta)
    return out, ta, tb, over


def _catching(fn):
    """``fn()``'s exception as text (None if it returned), for a thread."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - reported by the thread's caller
        return f"{type(e).__name__}: {e}"
    return None


def phase_front_door():
    """``python -m repro_torch run`` on the card: every example-spec kind at
    ``backend="torch"`` (the templates' backend) and three full-width
    studies (Fig. 5, Fig. 7 at the paper's 300 x 3 x 16, qwen2-72b's
    prefill_32k schedule), each artifact's payload equal to the same
    spec's ``backend="numpy"`` payload; then, in this process, the
    seconds per kind of both backends, the calibrate kind at the default
    preset through the CLI with a cache (launches per row counted as in
    phase 7, the resumed run launching nothing and reproducing the
    artifact bit for bit), the search at workers 1 and 2 (spawned
    workers on the card; run in a thread beside the CLI processes, from
    the template the CLI runs, and held to the CLI's artifact after
    both), and the Study facade's overhead over direct engine calls."""
    import shutil
    import tempfile
    import threading

    from repro_torch import cli
    from repro_torch.configs import REGISTRY, SHAPES
    from repro_torch.core import dse
    from repro_torch.core.cache import ResultCache
    from repro_torch.core.dse import PAPER_WORKLOADS
    from repro_torch.core.network import lower_network
    from repro_torch.core.study import (
        ANALYSIS_KINDS, AnalysisSpec, SpaceSpec, Study, WorkloadSpec, _jsonify,
    )

    out = {}
    t_start = time.perf_counter()
    parts = {}
    tmp = tempfile.mkdtemp(prefix="repro-torch-front-door-")
    full = {
        "schedule qwen2-72b prefill_32k": Study(
            name="schedule-qwen2-72b-prefill_32k",
            workload=WorkloadSpec(kind="network", arch="qwen2-72b", shape="prefill_32k"),
            analysis=AnalysisSpec(kind="schedule", backend="torch")),
        "sweep fig7 (300 x 3 x 16)": dse.fig7_study(backend="torch"),
        "sweep fig5": dse.fig5_study(backend="torch"),
    }
    procs = {}
    search = Study.example("search")  # the template `example-spec search` prints
    searched = {"pays": [], "walls": []}

    def run_search():
        """The search at workers 1 and 2: two blocks per generation, the
        second's workers spawned."""
        for w in (1, 2):
            s = dataclasses.replace(search, analysis=dataclasses.replace(search.analysis,
                                                                         workers=w))
            t = time.perf_counter()
            r = s.run(cache=ResultCache(os.path.join(tmp, f"search-w{w}"), block_cells=64))
            searched["walls"].append(time.perf_counter() - t)
            searched["pays"].append(_payload_of(r))

    searcher = threading.Thread(target=lambda: searched.update(error=_catching(run_search)))
    try:
        t0 = time.perf_counter()
        searcher.start()
        procs = _start_front_door(tmp, {**{k: None for k in ANALYSIS_KINDS}, **full})
        arts = {}
        for name, (proc, path, log) in procs.items():
            rc = proc.wait(timeout=FRONT_DOOR_TIMEOUT_S)
            log.close()
            tail = open(log.name).read()[-2000:]
            check(rc == 0, f"python -m repro_torch run ({name}) exited {rc}: {tail}")
            with open(path) as f:
                arts[name] = json.load(f)
            check(arts[name]["study"]["analysis"]["backend"] == "torch",
                  f"{name}: the artifact's backend is not torch")
        cli_wall = time.perf_counter() - t0
        searcher.join()  # nothing below runs beside it: the calibrate part counts launches
        check(searched.get("error") is None, f"search at workers 1 and 2: {searched.get('error')}")
        parts["cli"] = cli_wall
        parts["cli and search"] = time.perf_counter() - t0 - cli_wall
        print(f"[front door] {len(procs)} `python -m repro_torch run` processes in parallel, "
              f"all done in {cli_wall:.2f} s (wall, start-up included)", flush=True)

        timing = {}
        for name, art in arts.items():
            spec = Study.from_dict(art["study"])
            numpy_spec, torch_spec = _as_backend(spec, "numpy"), _as_backend(spec, "torch")
            if name == "calibrate":
                # the numpy spec replays the card's measurements from the
                # CLI run's cache: same content hash, same device
                cache = ResultCache(os.path.join(tmp, "cache-example-calibrate"))
                rep = numpy_spec.run(cache=cache)
                check(rep.cache["misses"] == 0 and rep.cache["hits"] == len(
                    art["payload"]["rows"]), f"calibrate replay: {rep.cache}")
                want = _payload_of(rep)
            else:
                want = None
            (res_n, res_t), ts_n, ts_t, _ = _paired(numpy_spec.run, torch_spec.run, 3)
            if want is None:
                want = _payload_of(res_n)
                check(_payload_of(res_t) == want,
                      f"{name}: Study.run() at backend torch and numpy differ in this process")
            check(art["payload"] == want,
                  f"{name}: the CLI's backend='torch' payload differs from backend='numpy'")
            timing[name] = {"numpy_s": ts_n, "torch_s": ts_t}
            print(f"[front door] {name}: the CLI's torch payload equals numpy's; Study.run() s "
                  f"per call: numpy {[round(t, 4) for t in ts_n]}, torch (card) "
                  f"{[round(t, 4) for t in ts_t]}; {res_t.describe()}", flush=True)
        p5 = arts["sweep fig5"]["payload"]
        s12 = p5["speedup"][2][3][11]  # K 12100, 2^18 MACs, 12 tiers
        check(round(s12, 2) == 9.57, f"Fig. 5 12-tier speedup {s12}")
        med = arts["sweep fig7 (300 x 3 x 16)"]["payload"]["medians"]
        check(med == [2.0, 4.0, 7.0], f"Fig. 7 medians {med}")
        print(f"[front door] Fig. 5 12-tier speedup {s12:.4f}x; Fig. 7 medians {med}", flush=True)
        out["kinds"] = timing
        out["cli_parallel_wall_s"] = cli_wall
        parts["kinds"] = time.perf_counter() - t_start - sum(parts.values())

        # the calibrate kind at the default preset, through the CLI with a cache
        cal_dir = os.path.join(tmp, "cache-calibrate-default")
        cal_spec = Study(name="calibrate-default", workload=WorkloadSpec(kind="random", n=1),
                         analysis=AnalysisSpec(kind="calibrate", backend="torch",
                                               calibrate=calibrate.CalibrateSpec()))
        spec_path = os.path.join(tmp, "spec-calibrate-default.json")
        cal_spec.save(spec_path)
        calls = 1 + max(cal_spec.analysis.calibrate.warmup, 1) + cal_spec.analysis.calibrate.reps
        original = calibrate.measure_row
        runs = []
        try:
            for argv in (["run", spec_path, "--cache", cal_dir], ["run", "--resume", cal_dir]):
                per_row = []
                calibrate.measure_row = _recording_measure_row(per_row)
                path = os.path.join(tmp, f"calibrate-default-{len(runs)}.json")
                reset_launch_counts()
                t0 = time.perf_counter()
                check(cli.main(argv + ["--out", path]) == 0, f"repro_torch {argv} failed")
                wall = time.perf_counter() - t0
                runs.append((per_row, launch_counts(), wall, open(path).read()))
        finally:
            calibrate.measure_row = original
        (rows1, counts1, wall1, text1), (rows2, counts2, wall2, text2) = runs
        check(len(rows1) == 23, f"the calibrate Study measured {len(rows1)} rows")
        counts, by_variant = _check_row_launches(rows1, calls, "calibrate Study")
        check(counts1 == counts, f"calibrate Study launches {counts1} outside its rows")
        check(not rows2 and not any(counts2.values()),
              f"the resumed calibrate Study measured {len(rows2)} rows, launches {counts2}")
        art1, art2 = json.loads(text1), json.loads(text2)
        check(art1["payload"] == art2["payload"] and art2["cache"]["misses"] == 0
              and art2["cache"]["hits"] == 23,
              f"the resumed calibrate Study differs or recomputed: {art2['cache']}")
        check(json.dumps(art1["payload"]) == json.dumps(art2["payload"]),
              "the resumed calibrate artifact is not bit-identical")
        e = art1["payload"]["errors"]
        print(f"[front door] calibrate Study, default preset: 23 rows in {wall1:.2f} s, launches "
              f"{counts} by variant {by_variant} ({calls} per kernel row); resumed from its "
              f"cache in {wall2:.2f} s: 23 chunks reused, 0 launches, artifact bit-identical; "
              f"holdout median rel. error {e['holdout_median_rel_err']:.4f} (fit "
              f"{e['fit_median_rel_err']:.4f}, uncalibrated "
              f"{e['uncalibrated_holdout_median_rel_err']:.4f})", flush=True)
        out["calibrate_default"] = {"wall_s": wall1, "resume_wall_s": wall2, "launches": counts,
                                    "launches_by_variant": by_variant, "errors": e}
        parts["calibrate"] = time.perf_counter() - t_start - sum(parts.values())

        # the search at workers 1 and 2 (run beside the CLI processes)
        pays, walls = searched["pays"], searched["walls"]
        check(Study.from_dict(arts["search"]["study"]) == search,
              "search: the CLI ran another spec than the template")
        check(pays[0] == pays[1] == arts["search"]["payload"],
              "search: workers 1 and 2 (and the uncached CLI run) differ")
        print(f"[front door] search at workers 1 and 2 (2 blocks per generation): bit-identical "
              f"payloads, equal to the CLI's; {walls[0]:.2f} s and {walls[1]:.2f} s (the "
              f"second spawns its 2 workers)", flush=True)
        out["search_workers_s"] = walls

        # the facade against direct engine calls, on the card
        wl = list(PAPER_WORKLOADS.values())
        budgets, tiers = (2**14, 2**16, 2**18), tuple(range(1, 17))
        ev = Study(name="facade-evaluate", workload=WorkloadSpec(kind="gemms", gemms=wl),
                   space=SpaceSpec(mac_budgets=budgets, tiers=tiers),
                   analysis=AnalysisSpec(backend="torch"))
        (d, r), t_d, t_s, over_e = _paired(
            lambda: engine.evaluate(engine.DesignGrid.product(wl, budgets, tiers),
                                    backend="torch"), ev.run, 7)
        bad = _eval_diff(d, r.result)
        check(not bad, f"facade evaluate differs from the engine in {bad}")
        cfg, shape = REGISTRY["smollm-135m"], SHAPES["decode_32k"]
        sc = Study(name="facade-schedule",
                   workload=WorkloadSpec(kind="network", arch=cfg.name, shape=shape.name),
                   analysis=AnalysisSpec(kind="schedule", backend="torch"))
        sp = sc.space
        (d2, r2), t_d2, t_s2, over_s = _paired(
            lambda: engine.schedule(lower_network(cfg, shape), mac_budgets=sp.mac_budgets,
                                    tiers=sp.tiers, backend="torch"), sc.run, 5)
        check(json.dumps(_jsonify(d2)) == json.dumps(_jsonify(r2.report)),
              "facade schedule differs from the engine")
        print(f"[front door] facade over direct engine calls (torch, card; median paired "
              f"difference over the best direct time): evaluate {len(wl)} x "
              f"{len(budgets) * len(tiers)} points {over_e * 100:+.2f}% (direct best "
              f"{min(t_d) * 1e3:.3f} ms, Study best {min(t_s) * 1e3:.3f} ms); schedule "
              f"smollm-135m decode_32k {over_s * 100:+.2f}% (direct best {min(t_d2) * 1e3:.3f} "
              f"ms, Study best {min(t_s2) * 1e3:.3f} ms)", flush=True)
        out["facade"] = {"evaluate": {"direct_s": t_d, "study_s": t_s, "overhead": over_e},
                         "schedule": {"direct_s": t_d2, "study_s": t_s2, "overhead": over_s}}
        parts["facade"] = time.perf_counter() - t_start - sum(parts.values())
    finally:
        for proc, _, log in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
            log.close()
        if searcher.is_alive():
            searcher.join()
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s_by_part"] = parts
    RESULTS["front_door"] = out
    print("[front door] phase 11 took " + f"{time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()), flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 12: training (python -m repro_torch.launch.train) on the card
# ---------------------------------------------------------------------------

# The training path: smollm-135m at full width and depth, bf16 compute on
# f32 master weights, batch 8 x 512 tokens, seed 0, remat on.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 30
# card against CPU: full width, depth cut to 2 layers, batch 2 x 256
TRAIN_E2E_LAYERS, TRAIN_E2E_BATCH, TRAIN_E2E_SEQ = 2, 2, 256
# the f32 gradient band, as a fraction of each leaf's max|g|: the same
# f32 arithmetic summed in other orders (tests/test_torch_train.py holds
# the CPU to the reference within the same 1e-3)
TRAIN_F32_TOL = 1e-3
# the restart check: full width, depth cut to 4 layers (each checkpoint
# holds params, m and v in f32: 0.5 GB), 16 steps, a fault at step 12
RESTART_LAYERS, RESTART_STEPS, RESTART_FAULT = 4, 16, 12


def param_leaves(cfg) -> int:
    """The parameter tree's leaves: AdamW launches its update and its sum
    of squares once each per leaf and train step."""
    return len(list(leaves(build(cfg, "cpu").defs)))  # the tree alone: nothing allocated


def adamw_variants(cfg) -> dict:
    """AdamW's launches by variant in one train step."""
    n = param_leaves(cfg)
    return {"update": n, "norm": n}


def expected_train_launches(cfg) -> dict:
    """Kernel launches of one train step with remat, AdamW's two a leaf
    (``param_leaves``) beside what the layers launch."""
    out = _layer_train_launches(cfg)
    out["adamw"] = 2 * param_leaves(cfg)
    return out


def _layer_train_launches(cfg) -> dict:
    """Kernel launches of one train step with remat as the layers call
    them: each projection's GEMM in the forward, again in each
    checkpointed layer's recompute (the unembedding is outside them), and
    dA and dB of every projection in the backward. Dense: every layer is
    checkpointed, so one flash forward per layer, again in its recompute,
    and one flash backward. Hybrid: only the Mamba2 layers are (as the
    reference's ``jax.checkpoint(mbody)``): one scan per Mamba2 layer,
    again in its recompute (with the states its backward reads), and one
    scan backward; the shared block's flash forward and backward once per
    call. xLSTM: no remat (as the reference): each GEMM once forward, then
    dA and dB; two scans per mLSTM block (with states) and their two
    backwards; one recurrence per sLSTM block and its backward. MoE: as
    dense, with the router's product among each layer's GEMMs and one more
    outside the layers (the load-balance term's), and per layer three
    grouped expert products, again in the recompute, their three dX
    products and three dW."""
    out = dict.fromkeys(KERNELS, 0)
    if cfg.family == "ssm":
        n_m, n_s = xlstm_block_counts(cfg)
        out.update(dos_matmul=3 * xlstm_gemms(cfg)[0], ssm_scan=2 * n_m, ssm_scan_bwd=2 * n_m,
                   slstm_scan=n_s, slstm_scan_bwd=n_s)
        return out
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every  # shared-block calls
        n_mamba = n_attn * cfg.attn_every
        gemms = 6 * n_mamba + 7 * n_attn + 1
        out.update(dos_matmul=gemms + 6 * n_mamba + 2 * gemms, flash_attention=n_attn,
                   flash_attention_bwd=n_attn, ssm_scan=2 * n_mamba, ssm_scan_bwd=n_mamba)
        return out
    if cfg.family == "moe":
        n = cfg.n_layers
        gemms = moe_layer_gemms(cfg) * n + 2  # the unembedding and the load-balance router
        out.update(dos_matmul=gemms + moe_layer_gemms(cfg) * n + 2 * gemms,
                   flash_attention=2 * n, flash_attention_bwd=n, grouped_matmul=9 * n,
                   grouped_matmul_dw=3 * n)
        return out
    gemms = 7 * cfg.n_layers + 1
    out.update(dos_matmul=gemms + 7 * cfg.n_layers + 2 * gemms,
               flash_attention=2 * cfg.n_layers, flash_attention_bwd=cfg.n_layers)
    return out


def expected_train_variants(cfg) -> dict:
    """An xLSTM train step's launches by kernel and variant: the wi and wf
    GEMMs, their dA (K = 4) and their dB (N = 4) ``general``, every other
    GEMM ``wgmma``; each mLSTM block's memory scan and its backward
    ``mma``, its P = 1 normaliser's ``fma``; the recurrence and its
    backward ``reg``."""
    n_m, n_s = xlstm_block_counts(cfg)
    gemms, gates = xlstm_gemms(cfg)
    out = {k: dict.fromkeys(fn.variants, 0) for k, fn in KERNELS.items()}
    out["dos_matmul"].update(wgmma=3 * (gemms - gates), general=3 * gates)
    for k in ("ssm_scan", "ssm_scan_bwd"):
        out[k].update(mma=n_m, fma=n_m)
    out["slstm_scan"]["reg"] = out["slstm_scan_bwd"]["reg"] = n_s
    out["adamw"] = adamw_variants(cfg)
    return out


def _sdpa_bwd_ms(sets, causal=True, reps=20):
    """Device ms per call of the autograd backward of
    ``scaled_dot_product_attention`` (GQA, causal or not) on the same operands,
    the backend that ran it and its three longest kernels: the sum of its
    device operations under torch.profiler (``device_ms_per_call``,
    cycling the input sets, after a warm-up), so autograd's host launches
    stay outside the time. The backend is read from the kernels' names."""
    graphs = []
    for q, k, v, _, do, _ in sets:
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)
        graphs.append((out, (qs, ks, vs), do.transpose(1, 2)))

    def run(i):
        out, leaves_, do = graphs[i % len(graphs)]
        torch.autograd.grad(out, leaves_, do, retain_graph=True)

    for i in range(3):
        run(i)
    by_name = device_ms_per_call(run, reps)
    check(bool(by_name), "the profiler recorded no device time in SDPA's backward")
    names = " ".join(by_name).lower()
    backend = ("cudnn" if "cudnn" in names else "flash" if "flash" in names else
               "efficient" if "fmha" in names or "cutlass" in names else "math")
    top = sorted(by_name, key=lambda n: -by_name[n])[:3]
    return sum(by_name.values()), backend, top


# Tiles of the backward's passes at D <= 128, (query rows, keys) per step
# of a block, as csrc/flash_attention_bwd.cu sets them: what the causal
# mask's work is counted in.
BWD_TILES = {"flash_bwd_mma_dq": (64, 64), "flash_bwd_mma_dkdv": (64, 32),
             "flash_bwd_dq": (64, 64), "flash_bwd_dkdv": (64, 64)}


def _tile_pairs(sq, skv, bq, bk, causal):
    """(query tile, KV tile) pairs a pass visits with queries at 0..Sq-1."""
    return sum(min(-(-skv // bk), (q0 + bq - 1) // bk + 1) if causal else -(-skv // bk)
               for q0 in range(0, sq, bq))


def _bwd_passes(sets, kw, force_fma, reps=20):
    """Device ms per call of each pass of the flash backward (dsum, dQ,
    dK/dV; ``device_ms_per_call``), calls cycling the sets."""
    by_name = device_ms_per_call(lambda i: flash_ops._backward(
        *sets[i % len(sets)], scale=None, force_fma=force_fma, **kw), reps)
    out = {}
    for name, ms in by_name.items():
        key = next((k for k in ("flash_bwd_mma_dkdv", "flash_bwd_mma_dq", "flash_bwd_dkdv",
                                "flash_bwd_dq", "flash_bwd_dsum") if k in name), None)
        if key:
            out[key] = out.get(key, 0.0) + ms
    return out


def bwd_mask_cost(gen, b, s, h, kvh, d):
    """What the causal mask costs each pass of both backward variants at
    the training shape: each pass timed causal and unmasked, and the
    causal time against the unmasked time scaled by the tile pairs each
    visits (what the causal pairs would take at the unmasked grid's rate
    per pair). The excess holds the uneven work per block (the first KV
    tiles see every query tile, the last one) and each block's fixed
    costs, which weigh more on the causal grid's short blocks."""
    sets = {True: [], False: []}
    for _ in range(max(1, math.ceil(COLD_BYTES / (6 * b * s * h * d * 2)))):
        q, k, v, do = (torch.randn(b, s, hh, d, generator=gen, device="cuda").to(torch.bfloat16)
                       for hh in (h, kvh, kvh, h))
        for c in (True, False):
            o, lse = flash_ops._forward(q, k, v, causal=c, window=None, scale=None, q_offset=0,
                                        with_lse=True)
            sets[c].append((q, k, v, o, do, lse))
    out = {}
    for variant in ("mma", "fma"):
        t = {c: _bwd_passes(sets[c], dict(causal=c, window=None, q_offset=0), variant == "fma")
             for c in (True, False)}
        for name, causal_ms in t[True].items():
            out[name] = {"variant": variant, "causal_ms": causal_ms, "unmasked_ms": t[False][name]}
            if name not in BWD_TILES:
                continue
            bq, bk = BWD_TILES[name]
            frac = _tile_pairs(s, s, bq, bk, True) / _tile_pairs(s, s, bq, bk, False)
            even = t[False][name] * frac
            out[name].update(tile_pair_fraction=frac, even_ms=even, excess_ms=causal_ms - even)
            print(f"[train] flash backward [{variant}] {name}: causal {causal_ms*1e3:.1f} us, "
                  f"unmasked {t[False][name]*1e3:.1f} us; at the unmasked rate per tile pair the "
                  f"causal pairs ({frac:.3f} of them) would take {even*1e3:.1f} us: "
                  f"{(causal_ms - even)*1e3:.1f} us more", flush=True)
    return out


def check_flash_bwd(gen, b, sq, skv, h, kvh, d, dtype, causal=True, window=None, q_offset=0,
                    time_it=False, layout="aligned"):
    """The forward's o and lse (the variant ``layout`` plans; o also
    through ``flash_attention``'s autograd Function) and the backward
    kernel (the same variant: ``mma`` for bf16 with 16-byte rows, ``fma``
    otherwise) against their plain versions. ``layout`` "offset" moves
    every operand's base 2 bytes off 16 (both run fma), "seq stride 2"
    reads q, k, v, o and dO at every other row of a tensor twice as long
    (a bf16 pair runs mma through the strides). Timed, the fma kernel
    also runs on the same inputs (forced: it takes every layout) and is
    held to the same gate."""
    es = 2 if dtype == torch.bfloat16 else 4
    n_bytes, n_ops = flash_ops.bwd_work(b, sq, skv, h, kvh, d, es, causal, window, q_offset)[:2]
    n_sets = max(1, math.ceil(COLD_BYTES / n_bytes)) if time_it else 1
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    variant = _want_variant(dtype, "offset" if layout == "offset" else "aligned")
    sets = []
    for i in range(n_sets):
        q, k, v, do = (torch.randn(bb, 2 * s if layout == "seq stride 2" else s, hh, d,
                                   generator=gen, device="cuda").to(dtype)
                       for bb, s, hh in ((b, sq, h), (b, skv, kvh), (b, skv, kvh), (b, sq, h)))
        if layout == "seq stride 2":
            q, k, v, do = (t[:, ::2] for t in (q, k, v, do))
        elif layout == "offset":
            q, k, v, do = (_off16(t) for t in (q, k, v, do))
        o, lse = (_count_variant(flash_attention, variant, lambda: flash_ops._forward(
            q, k, v, scale=None, with_lse=True, **kw)) if i == 0 else
            flash_ops._forward(q, k, v, scale=None, with_lse=True, **kw))
        sets.append((q, k, v, o, do, lse))
    q, k, v, o, do, lse = sets[0]
    want_o, want_lse = attention_fwd_ref(q.float(), k.float(), v.float(), **kw)
    # the Function's forward, as a train step calls it (an input requires
    # grad): the same kernel with lse, so the same bits as o
    wrapped = _count_variant(flash_attention, variant, lambda: flash_attention(
        q.detach().requires_grad_(), k, v, **kw)).detach()
    before = flash_attention_bwd.launches
    grads = _count_variant(flash_attention_bwd, variant,
                           lambda: flash_attention_bwd(q, k, v, o, do, lse, **kw))
    check(flash_attention_bwd.launches == before + 1, "flash_attention_bwd did not launch once")
    again = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    plain = attention_bwd_ref(q, k, v, o, do, lse, **kw)
    exact = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(), lse, **kw)
    torch.cuda.synchronize()
    # lse: f32 math on both sides, 1e-5 absolute plus 1e-6 of |lse| (a log
    # of an f32 sum; a row with no visible key holds NEG_INF on both)
    lse_err = (lse - want_lse).abs()
    ok = bool((lse_err <= 1e-5 + 1e-6 * want_lse.abs()).all())
    # o: check_flash's tolerance (f32 math on both sides, 1e-5 absolute; a
    # bf16 output adds one rounding, 2**-8 of each entry)
    o_err = (o.float() - want_o).abs()
    o_tol = (2.0**-8 * want_o.abs() if dtype == torch.bfloat16 else 0.0) + 1e-5
    o_same = torch.equal(wrapped, o)
    ok = ok and bool((o_err <= o_tol).all()) and o_same
    grads_ok, errs, ref_max, slack = _bwd_gate(grads, exact, dtype)
    ok = ok and grads_ok
    same = all(torch.equal(x, y) for x, y in zip(grads, again))
    tag = (f"B{b} Sq{sq} Skv{skv} H{h}/{kvh} D{d} {str(dtype).split('.')[-1]} causal={causal} "
           f"window={window} q_offset={q_offset}"
           f"{'' if layout == 'aligned' else ' ' + layout} [lse {variant}, bwd {variant}]")
    row = {"case": tag, "variant": variant, "lse_variant": variant,
           "max_abs_err": max((g.float() - p.float()).abs().max().item()
                              for g, p in zip(grads, plain)),
           "max_abs_err_vs_f32": max(errs), "abs_slack_used": slack,
           "lse_max_abs_err": lse_err.max().item(),
           "o_max_abs_err_vs_f32": o_err.max().item(), "wrapper_o_bit_identical": o_same,
           "max_ref": ref_max, "bit_identical": same, "ok": ok and same}
    if time_it:
        check(q_offset == 0 and (window or skv) >= skv,
              "the library yardstick (sdpa) covers attention with no window or offset only")
        row["bytes"], row["ops"] = n_bytes, n_ops
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, dtype)
        row["ms"] = cuda_ms(lambda i: flash_attention_bwd(*sets[i], **kw), n_sets)
        if variant != "fma":  # the fma kernel on the same inputs, beside it
            fma = _count_variant(flash_attention_bwd, "fma", lambda: flash_ops._backward(
                q, k, v, o, do, lse, scale=None, force_fma=True, **kw))
            fma_ok, fma_errs, _, row["fma_abs_slack_used"] = _bwd_gate(fma, exact, dtype)
            row["fma_max_abs_err_vs_f32"] = max(fma_errs)
            row["ok"] = row["ok"] and fma_ok
            row["fma_ms"] = cuda_ms(lambda i: flash_ops._backward(
                *sets[i], scale=None, force_fma=True, **kw), n_sets)
        row["plain_ms"] = cuda_ms(lambda i: attention_bwd_ref(*sets[i], **kw), n_sets)
        row["library_ms"], row["library_backend"], row["library_kernels"] = _sdpa_bwd_ms(sets,
                                                                                        causal)
    print(f"[train] flash_attention_bwd {tag}: max|err| vs f32 dq/dk/dv "
          f"{'/'.join(f'{e:.3g}' for e in errs)} (max|ref| {ref_max:.3g}; beyond one bf16 "
          f"rounding {slack:.3f} of the 1e-5 slack), lse "
          f"{row['lse_max_abs_err']:.3g}, o {row['o_max_abs_err_vs_f32']:.3g} (through "
          f"flash_attention: same bits {o_same}), two calls bit-identical {same} "
          + (f"kernel {row['ms']*1e3:.1f} us"
             + (f" (fma {row['fma_ms']*1e3:.1f} us, max|err| vs f32 "
                f"{row['fma_max_abs_err_vs_f32']:.3g})" if "fma_ms" in row else "")
             + f", plain {row['plain_ms']*1e3:.1f} us, sdpa backward ({row['library_backend']}: "
             f"{', '.join(n[:60] for n in row['library_kernels'])}) {row['library_ms']*1e3:.1f} "
             f"us on the device, bound {row['bound_ms']*1e3:.2f} us ({row['bound_by']})"
             if time_it else "")
          + ("" if row["ok"] else "  FAIL"), flush=True)
    check(same, f"flash_attention_bwd {tag}: two calls on the same inputs differ")
    check(row["ok"], f"flash_attention_bwd {tag} or its forward's o and lse disagree with "
          "their plain versions")
    return row


def _bwd_gate(grads, exact, dtype):
    """The flash backward's gate: each gradient within 1e-5 of its
    largest entry (they are O(10), not O(1) like the forward's output; at
    least 1e-5 absolute) of the f32 result of the same operands (o, dO
    and lse included); a bf16 gradient adds one rounding, 2**-8 of each
    entry. Returns (ok, max|err| per gradient, the largest reference
    entry, and how much of the 1e-5 slack the worst entry uses beyond
    that rounding)."""
    ok, errs, ref_max, slack = True, [], 0.0, -math.inf
    for got, ex in zip(grads, exact):
        err = (got.float() - ex).abs()
        abs_tol = 1e-5 * max(1.0, ex.abs().max().item())
        rounding = 2.0**-8 * ex.abs() if dtype == torch.bfloat16 else 0.0
        ok = ok and bool((err <= abs_tol + rounding).all())
        slack = max(slack, ((err - rounding) / abs_tol).max().item())
        errs.append(err.max().item())
        ref_max = max(ref_max, ex.abs().max().item())
    return ok, errs, ref_max, slack


def train_gemms(cfg) -> dict:
    """{(K, N, tied): projections per train step} of the dense path: each
    layer's q, k, v, o and gated MLP, and the unembedding."""
    e, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    out: dict = {}
    for k, n, count in ((e, q, 1), (e, kv, 2), (q, e, 1), (e, f, 2), (f, e, 1)):
        out[(k, n, False)] = out.get((k, n, False), 0) + count * cfg.n_layers
    out[(e, v, cfg.tie_embeddings)] = 1
    return out


def check_dos_function(gen, m, k, n, tied, time_it=True, variant="wgmma"):
    """The dos_matmul Function's forward against ``matmul_ref``, and its
    dA and dB (two more launches, each of ``variant``: ``wgmma``, or
    ``general`` for xLSTM's (E, H) gates) against autograd of
    ``matmul_ref`` on the card, for a
    bf16 activation and an f32 master weight cast in the graph; and the
    times of the forward, dA, dB, the transposed copy of A that dB reads,
    each beside torch.matmul."""
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(n, k, generator=gen, device="cuda").T if tied
         else torch.randn(k, n, generator=gen, device="cuda"))
    dc = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    a1, w1 = a.clone().requires_grad_(), w.detach().clone().requires_grad_()
    before = dict(dos_matmul.variants)
    c1 = dos_matmul(a1, w1.to(torch.bfloat16))
    torch.autograd.backward(c1, dc)
    launched = {v: dos_matmul.variants[v] - before[v] for v in before}
    a2, w2 = a.clone().requires_grad_(), w.detach().clone().requires_grad_()
    c2 = matmul_ref(a2, w2.to(torch.bfloat16))
    torch.autograd.backward(c2, dc)
    wb = w.to(torch.bfloat16)
    exact = (dc.float() @ wb.float().T, a.float().T @ dc.float())  # f32 sums, same operands
    exact_c = matmul_ref(a, wb, torch.float32)
    torch.cuda.synchronize()
    library = (torch.matmul(dc, wb.T), torch.matmul(a.T, dc))  # bf16 on the tensor cores
    # the forward: phase 4's GEMM tolerance (one bf16 rounding, 2**-8 of
    # each entry, plus 1e-5 of the largest for the order of the sum)
    c_err = (c1.detach().float() - exact_c).abs()
    ok = (c1.dtype == c2.dtype
          and bool((c_err <= 2.0**-8 * exact_c.abs() + 1e-5 * exact_c.abs().max()).all()))
    errs, excess = [], []
    for got, want, ex, lib, depth in ((a1.grad, a2.grad, exact[0], library[0], n),
                                      (w1.grad, w2.grad, exact[1], library[1], m)):
        # each rounds an f32 sum of the same bf16 products to bf16 once: the
        # Function's and autograd's gradients each within 2**-8 of every
        # entry of the f32 result, plus phase 4's 1e-5 of the largest entry
        # for the order of the sum, growing linearly with its depth past
        # 8192 terms (the tensor cores' f32 adds truncate, so their error
        # grows with the length of the sum: dA of the tied unembedding sums
        # 49,152 terms)
        tol = 2.0**-8 * ex.abs() + 1e-5 * max(1.0, depth / 8192) * ex.abs().max()
        ok = (ok and got.dtype == want.dtype and bool(((got.float() - ex).abs() <= tol).all())
              and bool(((want.float() - ex).abs() <= tol).all()))
        errs.append((got.float() - want.float()).abs().max().item())
        excess.append(((got.float() - ex).abs() - 2.0**-8 * ex.abs()).max().item()
                      / ex.abs().max().item())
        excess.append(((lib.float() - ex).abs() - 2.0**-8 * ex.abs()).max().item()
                      / ex.abs().max().item())
    tag = f"{m}x{k}x{n}{' tied (B^T)' if tied else ''}"
    row = {"case": tag, "launched": launched,
           "max_abs_err_forward": (c1.detach().float() - c2.detach().float()).abs().max().item(),
           "forward_max_abs_err_vs_f32": c_err.max().item(), "max_abs_err_dA": errs[0],
           "max_abs_err_dB": errs[1], "sum_error_dA": excess[0],
           "sum_error_dA_torch_matmul": excess[1], "sum_error_dB": excess[2],
           "sum_error_dB_torch_matmul": excess[3], "ok": ok}
    if time_it:
        at = a.T.contiguous()
        calls = {"forward": (lambda: dos_matmul(a, wb), lambda: torch.matmul(a, wb)),
                 "dA": (lambda: dos_matmul(dc, wb.T), lambda: torch.matmul(dc, wb.T)),
                 "dB": (lambda: dos_matmul(at, dc), lambda: torch.matmul(at, dc))}
        for name, (kern, lib) in calls.items():
            row[f"{name}_ms"] = cuda_ms(lambda i: kern(), 1)
            row[f"{name}_torch_matmul_ms"] = cuda_ms(lambda i: lib(), 1)
        row["transpose_copy_ms"] = cuda_ms(lambda i: a.T.contiguous(), 1)
    print(f"[train] dos_matmul Function {tag}: forward max|err| vs f32 {c_err.max().item():.3g} "
          f"(max|ref| {exact_c.abs().max().item():.3g}); max|Function - autograd of matmul_ref| dA "
          f"{errs[0]:.3g}, dB {errs[1]:.3g}; error of the sum past one bf16 rounding, of "
          f"max|ref|: dA {excess[0]:.3g} (bf16 torch.matmul {excess[1]:.3g}), dB {excess[2]:.3g} "
          f"({excess[3]:.3g}); launches by variant {launched}"
          + ("".join(f"; {n} {row[n + '_ms']*1e3:.1f} us (torch.matmul "
                     f"{row[n + '_torch_matmul_ms']*1e3:.1f} us)" for n in ("forward", "dA", "dB"))
             + f"; A^T copy {row['transpose_copy_ms']*1e3:.1f} us" if time_it else "")
          + ("" if ok else "  FAIL"), flush=True)
    check(launched == dict(dict.fromkeys(launched, 0), **{variant: 3}),
          f"dos_matmul Function {tag}: launches {launched}, expected 3 {variant}")
    check(ok, f"dos_matmul Function {tag}: the forward or the gradients disagree with "
          "matmul_ref and its autograd")
    return row


def _adamw_set(gen, shape, gdtype):
    """p, g (``gdtype``), m and v (positive) of ``shape`` on the card."""
    def r(scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    return r(), r().to(gdtype), r(0.1), r(0.1).square()


def _ulps_apart(got, want) -> float:
    """max|got - want| in f32 ulps of max|want|."""
    scale = want.abs().max().clamp(min=torch.finfo(torch.float32).tiny)
    return ((got - want).abs().max() / (torch.nextafter(scale, scale * 2) - scale)).item()


def _plain_adamw_update(params, grads, state, cfg):
    """``optim.adamw_update`` through the plain versions: ``sum_squares_ref``
    and ``adamw_ref``, in place. Returns the global norm."""
    from repro_torch.optim import schedule

    step = state["step"] + 1
    lr = schedule(cfg, step)
    total = 0
    for s_ in sum_squares_ref([g for _, g in leaves(grads)]):
        total = total + s_
    gnorm = torch.sqrt(total)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    bc1, bc2 = (1 - torch.pow(b, step.float()) for b in (cfg.b1, cfg.b2))
    for (_, p), (_, g), (_, m), (_, v) in zip(*(leaves(t) for t in (params, grads, state["m"],
                                                                   state["v"]))):
        adamw_ref(p, g, m, v, scale, lr, bc1, bc2, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                  weight_decay=cfg.weight_decay)
    return gnorm


def phase_adamw() -> tuple[dict, float]:
    """Phase 12's AdamW kernels. The update bit for bit against
    ``adamw_ref`` given the same scale, lr and bias corrections, with f32
    and bf16 gradients, at every leaf of smollm-135m and the largest leaf
    of each other train path; the sums of squares the same on every run
    and within 1e-5 of the plain sums (another f32 order); one whole
    ``adamw_update`` of smollm-135m within 4 ulp of each leaf's scale of
    the same step through the plain versions (only the norm's order
    differs); then that step timed: the kernels (a sum of squares and an
    update per leaf), the plain versions and ``torch._fused_adamw_`` over
    the same tensors. Returns the timed row and the largest difference
    from the plain update."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    cfg = OptConfig()
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    scalars = [torch.tensor(x, device="cuda") for x in (0.37, 2.5e-4, 0.1, 0.0975)]
    train_cfgs = {ARCH: get_config(ARCH), HYBRID: get_config(HYBRID), XLSTM: get_config(XLSTM),
                  MOE: dataclasses.replace(get_config(MOE), n_layers=MOE_TRAIN_LAYERS),
                  VLM: cross_train_cfg(VLM), WHISPER: cross_train_cfg(WHISPER)}
    shapes = {a: [tuple(d.shape) for _, d in leaves(build(c, "cpu").defs)]
              for a, c in train_cfgs.items()}
    per_step = {a: 2 * len(v) for a, v in shapes.items()}
    print(f"[adamw] launches per train step (an update and a sum of squares a leaf): {per_step}",
          flush=True)
    cases = shapes[ARCH] + [max(v, key=math.prod) for a, v in shapes.items() if a != ARCH]
    err = 0.0
    for gdtype in (torch.float32, torch.bfloat16):
        for shape in cases + [(1,), (1001,)]:
            p, g, m, v = _adamw_set(gen, shape, gdtype)
            want = [t.clone() for t in (p, m, v)]
            adamw_ref(want[0], g, want[1], want[2], *scalars, **kw)
            _count_variant(adamw, "update", lambda: adamw(p, g, m, v, *scalars, **kw))
            torch.cuda.synchronize()
            err = max(err, max((a - b).abs().max().item() for a, b in zip((p, m, v), want)))
            check(all(torch.equal(a, b) for a, b in zip((p, m, v), want)),
                  f"adamw {shape} with a {gdtype} gradient is not the plain update bit for bit")
            del p, g, m, v, want
    print(f"[adamw] the update bit for bit against adamw_ref at {len(cases) + 2} leaf shapes "
          f"(smollm-135m's {len(shapes[ARCH])}, each train path's largest, two odd sizes), f32 "
          "and bf16 gradients", flush=True)

    model = build(get_config(ARCH), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    grads = map_tree(lambda t: torch.randn(t.shape, generator=gen, device="cuda") * 1e-3, params)
    state = {"m": map_tree(lambda t: torch.randn_like(t) * 1e-4, params),
             "v": map_tree(lambda t: torch.rand_like(t) * 1e-7, params),
             "step": torch.tensor(5, dtype=torch.int32, device="cuda")}
    gs = [g for _, g in leaves(grads)]
    sums = sum_squares(gs)
    again = sum_squares(gs)
    ref_sums = sum_squares_ref(gs)
    check(torch.equal(sums, again), "the sums of squares differ between two runs")
    check(bool(((sums - ref_sums).abs() <= 1e-5 * ref_sums).all()),
          f"the sums of squares {sums.tolist()} are not the plain {ref_sums.tolist()}")
    kern = (map_tree(torch.clone, params), map_tree(torch.clone, state))
    plain = (map_tree(torch.clone, params), map_tree(torch.clone, state))
    _, new_state, gnorm = adamw_update(kern[0], grads, kern[1], cfg)
    plain_norm = _plain_adamw_update(plain[0], grads, plain[1], cfg)
    worst = {"gnorm": _ulps_apart(gnorm, plain_norm)}
    for name, a, b in (("p", kern[0], plain[0]), ("m", new_state["m"], plain[1]["m"]),
                       ("v", new_state["v"], plain[1]["v"])):
        for (path, x), (_, y) in zip(leaves(a), leaves(b)):
            worst[f"{name} {'.'.join(map(str, path))}"] = _ulps_apart(x, y)
    top = max(worst.items(), key=lambda kv: kv[1])
    print(f"[adamw] smollm-135m's whole step against the plain step: gnorm "
          f"{gnorm.item():.6g} ({worst['gnorm']:.2f} ulp), worst leaf {top[0]} at {top[1]:.2f} "
          f"ulp of its scale", flush=True)
    check(top[1] <= 4, f"adamw_update's {top[0]} is {top[1]:.2f} ulp from the plain step's")
    del kern, plain, new_state

    ps, ms, vs = (list(x for _, x in leaves(t)) for t in (params, state["m"], state["v"]))
    scale, lr, bc1, bc2 = scalars

    def kernels():
        sum_squares(gs)
        for p, g, m, v in zip(ps, gs, ms, vs):
            adamw(p, g, m, v, scale, lr, bc1, bc2, **kw)

    def plain_fn():
        sum_squares_ref(gs)
        for p, g, m, v in zip(ps, gs, ms, vs):
            adamw_ref(p, g, m, v, scale, lr, bc1, bc2, **kw)

    steps = [torch.zeros((), device="cuda") for _ in ps]

    def library():
        torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=2.5e-4, beta1=cfg.b1, beta2=cfg.b2,
                            weight_decay=cfg.weight_decay, eps=cfg.eps, amsgrad=False,
                            maximize=False)

    n = [p.numel() for p in ps]
    n_bytes = sum(adamw_ops.work(k, 4).bytes + adamw_ops.norm_work(k, 4).bytes for k in n)
    n_ops = sum(adamw_ops.work(k, 4).ops + adamw_ops.norm_work(k, 4).ops for k in n)
    bound, by = bound_ms(n_bytes, n_ops, torch.float32)
    row = {"path": ARCH, "leaves": len(ps), "elements": sum(n), "launches_per_step": 2 * len(ps),
           "ms": events_ms(kernels), "plain_ms": events_ms(plain_fn),
           "library_ms": events_ms(library), "bound_ms": bound, "bound_by": by,
           "bytes": n_bytes, "ops": n_ops, "whole_step_ulps": worst, "launches_by_path": per_step}
    print(f"[adamw] one smollm-135m step ({len(ps)} leaves, {sum(n):,} f32 parameters): kernels "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, torch._fused_adamw_ "
          f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
    RESULTS["adamw"] = row
    return row, err


def phase_train_kernels():
    """Phase 12's kernel checks: the forward's lse and the flash backward
    at the training shape (timed) and edge shapes, and the dos_matmul
    Function at every training projection. Returns the flash backward's
    row at the training shape and the largest error of the checks."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    cfg = get_config(ARCH)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    out = {"flash_attention_bwd": [], "dos_matmul_function": []}
    main = check_flash_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, h, kvh, hd, torch.bfloat16,
                           window=2**30, time_it=True)  # the global layers' sentinel
    out["flash_attention_bwd_passes"] = bwd_mask_cost(gen, TRAIN_BATCH, TRAIN_SEQ, h, kvh, hd)
    rows = [main, check_flash_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, h, kvh, hd,
                                  torch.float32)]
    for dtype in (torch.bfloat16, torch.float32):
        fb = functools.partial(check_flash_bwd, gen, dtype=dtype)
        for d in flash_ops.HEAD_DIMS:  # every head dim built, a ragged tail
            rows.append(fb(2, 100, 100, 6, 2, d))
        for gh, gkv in ((4, 4), (16, 1), (8, 2)):  # the GQA extremes
            rows.append(fb(2, 128, 128, gh, gkv, 64))
        rows.append(fb(2, 256, 256, 4, 1, 256, window=128))  # gemma3's heads, a window that binds
        rows.append(fb(2, 200, 333, 4, 2, 64, causal=False))  # ragged
        rows.append(fb(2, 200, 333, 4, 2, 64, q_offset=133))  # queries at the end
        rows.append(fb(2, 64, 200, 4, 2, 32, window=16, q_offset=136))
        rows.append(fb(1, 70, 70, 2, 1, 64, window=0))  # no row sees a key
    for layout in ("offset", "seq stride 2"):
        rows.append(check_flash_bwd(gen, 2, 128, 128, h, kvh, hd, torch.bfloat16, layout=layout))
    out["flash_attention_bwd"] = rows
    for (k, n, tied) in train_gemms(cfg):
        out["dos_matmul_function"].append(
            check_dos_function(gen, TRAIN_BATCH * TRAIN_SEQ, k, n, tied))
    # the train step's GEMM device time: the forward twice (remat) but the
    # unembedding once, dA and dB once, and one transposed copy per dB
    counts = train_gemms(cfg)
    step = {"kernel_ms": 0.0, "torch_matmul_ms": 0.0, "transpose_copy_ms": 0.0}
    for row, ((k, n, tied), c) in zip(out["dos_matmul_function"], counts.items()):
        fwd = c if tied else 2 * c
        step["kernel_ms"] += fwd * row["forward_ms"] + c * (row["dA_ms"] + row["dB_ms"])
        step["torch_matmul_ms"] += (fwd * row["forward_torch_matmul_ms"]
                                    + c * (row["dA_torch_matmul_ms"] + row["dB_torch_matmul_ms"]))
        step["transpose_copy_ms"] += c * row["transpose_copy_ms"]
    print(f"[train] a train step's GEMMs ({sum(counts.values())} projections; forward, remat "
          f"recompute, dA, dB): dos_matmul {step['kernel_ms']:.3f} ms, torch.matmul "
          f"{step['torch_matmul_ms']:.3f} ms; the transposed copies dB reads "
          f"{step['transpose_copy_ms']:.3f} ms", flush=True)
    out["train_step_gemms"] = step
    RESULTS["train_kernels"] = out
    return main, max(r["max_abs_err"] for r in rows)


# Each kernel's variant on the training paths (bf16 with 16-byte rows).
TRAIN_VARIANTS = {"dos_matmul": "wgmma", "flash_attention": "mma", "flash_attention_bwd": "mma",
                  "ssm_scan": "mma", "ssm_scan_bwd": "mma"}


def phase_train_path(arch=ARCH):
    """Phase 12's main path (smollm-135m), phase 13's (zamba2-2.7b), 14's
    (xlstm-125m) or 15's (deepseek-moe-16b, depth cut to
    MOE_TRAIN_LAYERS): ``train_loop`` at full width on the card, with the launch counts set to
    0 just before and read just after. Every loss finite (and falling on
    the dense path: phase_train_hybrid_learns holds the hybrid's), the
    launches per step exact (every dos_matmul launch wgmma, every flash
    forward and backward and every scan forward mma), step times,
    tokens/s and peak memory. Returns the counts, the final state and the
    step p50."""
    cfg = get_config(arch)
    if cfg.family == "moe":  # phase 15: full width, depth cut
        cfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, wd = train_loop(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ, seed=0, log_every=10, device="cuda")
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    variants = {k: dict(fn.variants) for k, fn in KERNELS.items()}
    steps = sorted(wd.times)
    p50, p99 = steps[len(steps) // 2], steps[min(len(steps) - 1, int(0.99 * len(steps)))]
    tok_s = TRAIN_BATCH * TRAIN_SEQ / p50
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    summary = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "wall_s": wall,
               "step_s": wd.times, "step_p50_s": p50, "step_p99_s": p99,
               "first_step_s": wd.times[0], "tok_s_p50": tok_s, "losses": losses,
               "peak_mem_bytes": peak, "mem_before_bytes": base, "launches": counts,
               "variants": variants, "slow_steps": wd.slow_steps}
    remat = "no remat, as the reference" if cfg.family == "ssm" else "remat"
    print(f"[train] train_loop {cfg.name} ({build(cfg, 'cuda').n_params:,} parameters, "
          f"{cfg.compute_dtype} compute on {cfg.param_dtype} masters, {remat}) batch {TRAIN_BATCH} "
          f"x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps in {wall:.2f} s: step p50 {p50*1e3:.3f} ms, "
          f"p99 {p99*1e3:.3f} ms (first step {wd.times[0]*1e3:.1f} ms), {tok_s:,.0f} tokens/s at "
          f"p50, peak memory {peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB before)", flush=True)
    print(f"[train] losses: {' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"[train] launches {counts}; by variant {variants}", flush=True)
    check(all(math.isfinite(x) for x in losses), "a training loss is not finite")
    if cfg.family == "hybrid":  # phase_train_hybrid_learns holds its loss, and says why
        print(f"[train] {cfg.name}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (means of 5: "
              f"{first:.4f} -> {last:.4f})", flush=True)
    else:
        check(last < first and losses[-1] < losses[0],
              f"the loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f} (means of 5: "
              f"{first:.4f} -> {last:.4f})")
    want = {k: n * TRAIN_STEPS for k, n in expected_train_launches(cfg).items()}
    check(counts == want, f"train launches {counts}, expected {want}")
    if cfg.family in ("ssm", "moe"):  # phases 14, 15: every kernel's variants exact
        want_v = {k: {v: n * TRAIN_STEPS for v, n in c.items()} for k, c in
                  (expected_train_variants if cfg.family == "ssm" else moe_train_variants)(cfg)
                  .items()}
        check(variants == want_v, f"train launches by variant {variants}, expected {want_v}")
    else:
        for k, want_variant in TRAIN_VARIANTS.items():
            check(variants[k][want_variant] == counts[k] == sum(variants[k].values()),
                  f"a training {k} launch left the {want_variant} kernel: {variants[k]}")
    RESULTS["main_paths"]["train" if arch == ARCH else f"train {arch}"] = summary
    return counts, state, p50


def phase_train_profile(state, step_p50_s):
    """One train step (the path's model and its trained state, the next
    batch) under torch.profiler: device busy time, the idle share against
    the path's step p50, and device time by kernel and by plain op; one
    step with microbatches=2 against the same step's loss and gradients;
    and step time
    and peak memory with and without remat (these steps go on training the
    state in place)."""
    cfg = get_config(ARCH)
    model = build(cfg, "cuda")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch = {k: torch.from_numpy(x).to("cuda") for k, x in data.batch(TRAIN_STEPS).items()}
    step = make_train_step(model, opt_cfg)
    params, opt = state["params"], state["opt"]

    def fresh():  # a step updates its state in place: the two compared start from clones
        return map_tree(torch.clone, params), map_tree(torch.clone, opt)

    _, _, loss1 = step(*fresh(), batch)  # warm; the loss microbatches=2 must repeat
    _, _, loss2 = make_train_step(model, opt_cfg, microbatches=2)(*fresh(), batch)
    l1, l2 = float(loss1), float(loss2)
    rel = abs(l2 - l1) / abs(l1)
    print(f"[train] one step at microbatches 1 and 2: loss {l1:.6f} and {l2:.6f}, relative "
          f"difference {rel:.3g} (band {E2E_TOL})", flush=True)
    check(rel <= E2E_TOL, f"the microbatches=2 loss {l2} differs from {l1}")
    # the gradients that step updates with (the loss computed before the
    # update does not see them) against the full batch's, leaf by leaf in
    # the bf16 band of the leaf's max|g|; beside them, how far one
    # microbatch's gradients alone lie from the full batch's
    _, g1 = loss_and_grads(model, params, batch, True)
    l_acc, g2 = accumulate_grads(model, params, batch, True, 2)
    _, g_half = loss_and_grads(model, params, {k: x[:TRAIN_BATCH // 2] for k, x in batch.items()},
                               True)
    flat2, flat_half = dict(leaves(g2)), dict(leaves(g_half))
    worst = {"accumulated": (0.0, None), "one microbatch": (0.0, None)}
    for path, want in leaves(g1):
        scale = max(want.abs().max().item(), 1e-30)
        for key, got in (("accumulated", flat2[path]), ("one microbatch", flat_half[path])):
            r = (got.float() - want.float()).abs().max().item() / scale
            if r > worst[key][0]:
                worst[key] = (r, ".".join(path))
    print(f"[train] microbatches 2 against 1, leaf by leaf: worst accumulated gradient "
          f"{worst['accumulated'][1]} at {worst['accumulated'][0]:.3g} of its max|g| (band "
          f"{E2E_TOL}); one microbatch alone: worst {worst['one microbatch'][1]} at "
          f"{worst['one microbatch'][0]:.3g}", flush=True)
    check(float(l_acc) == l2, f"the accumulated loss {float(l_acc)} is not the step's {l2}")
    check(worst["accumulated"][0] <= E2E_TOL,
          f"the microbatches=2 gradient {worst['accumulated'][1]} differs from the full batch's "
          f"by {worst['accumulated'][0]:.3g} of its scale")
    out = {"microbatch_loss": [l1, l2], "microbatch_worst_grad_rel": worst}
    del g1, g2, g_half, flat2, flat_half
    # what remat costs and saves: the median of 3 steps (host clock ending in
    # a synchronize) and the peak memory, with and without it
    for remat in (True, False):
        fn = step if remat else make_train_step(model, opt_cfg, remat=False)
        fn(params, opt, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[f"remat_{remat}"] = {"step_ms": sorted(times)[1] * 1e3,
                                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    print(f"[train] one step with remat {out['remat_True']['step_ms']:.3f} ms (peak "
          f"{out['remat_True']['peak_mem_bytes'] / 2**20:.1f} MiB), without "
          f"{out['remat_False']['step_ms']:.3f} ms "
          f"({out['remat_False']['peak_mem_bytes'] / 2**20:.1f} MiB); median of 3 steps, host "
          "clock", flush=True)
    out.update(_profile_train_step(lambda: step(params, opt, batch), step_p50_s, "train step",
                                   {"dos_matmul": "dos_matmul", "flash forward": "flash_mma",
                                    "flash backward": "flash_bwd"}))
    RESULTS["profile"]["train"] = out


def _profile_train_step(run, step_p50_s, what, kernels, host_ops=True):
    """``run()``, one train step, under torch.profiler: device busy ms,
    the idle share against the path's step p50, device ms by kernel
    (``kernels``: label -> a substring of the kernel's name) and by plain
    op. An empty dict where the profiler recorded no device time."""
    busy, n_ops, by_name = _profiled(run, host_ops)
    if not n_ops:
        print(f"[profile] {what}: the profiler recorded no device time: idle share not measured")
        return {}
    kernels = dict(kernels, **{"adamw update": "adamw_", "adamw norm": "sum_squares"})
    busy_ms = busy / 1e3
    kern = {label: sum(us for n, us in by_name.items() if key in n) / 1e3
            for label, key in kernels.items()}
    plain = {n: us for n, us in by_name.items() if not any(k in n for k in kernels.values())}
    copies_ms = sum(us for n, us in plain.items() if "copy" in n.lower()) / 1e3
    top = sorted(plain.items(), key=lambda kv: -kv[1])[:12]
    idle = 1 - busy_ms / (step_p50_s * 1e3)
    print(f"[profile] {what}: device busy {busy_ms:.3f} ms of a {step_p50_s*1e3:.3f} ms step "
          f"(p50 without profiler): idle share {idle:.3f}; {n_ops} device ops; "
          + ", ".join(f"{label} {ms:.3f} ms" for label, ms in kern.items())
          + f", plain ops {sum(plain.values()) / 1e3:.3f} ms (copy kernels {copies_ms:.3f} ms)",
          flush=True)
    for name, us in top:
        print(f"[profile]   {us / 1e3:9.3f} ms  {name[:90]}")
    return dict(busy_ms=busy_ms, idle_share=idle, device_ops=n_ops, kernel_ms=kern,
                plain_ms=sum(plain.values()) / 1e3, copy_kernels_ms=copies_ms,
                top_plain_ms={n: us / 1e3 for n, us in top})


def _grad_gap(got, want) -> tuple[float, str]:
    """The largest max|got - want| / max|want| over the leaves of two
    gradient trees, and its leaf; every leaf of ``got`` must be finite."""
    worst, worst_leaf = 0.0, None
    flat = dict(leaves(got))
    for path, w in leaves(want):
        g = flat[path].float().cpu()
        check(bool(torch.isfinite(g).all()), f"non-finite gradient {path} on the card")
        rel = (g - w.float()).abs().max().item() / max(w.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_leaf = rel, ".".join(map(str, path))
    return worst, worst_leaf


def phase_train_e2e():
    """Card against CPU: one train step's loss and every gradient leaf on
    the same f32 master weights and batch, at full width with the depth
    cut to 2 layers and batch 2 x 256; in f32 within 1e-3 of each leaf's
    max|g|, in bf16 within the bf16 band (3e-2 of the leaf's max|g|)."""
    out = {}
    for dtype, tol in (("float32", TRAIN_F32_TOL), ("bfloat16", E2E_TOL)):
        cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_E2E_LAYERS, compute_dtype=dtype)
        mc, mg = build(cfg, "cpu"), build(cfg, "cuda")
        params_c = mc.init(torch.Generator().manual_seed(0))
        params_g = map_tree(lambda t: t.to("cuda"), params_c)
        data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_E2E_SEQ, TRAIN_E2E_BATCH, seed=0))
        batch = {k: torch.from_numpy(x) for k, x in data.batch(0).items()}
        lc, gc = loss_and_grads(mc, params_c, batch, True)
        lg, gg = loss_and_grads(mg, params_g, {k: x.cuda() for k, x in batch.items()}, True)
        loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
        worst, worst_leaf = _grad_gap(gg, gc)
        print(f"[train] card vs CPU, {cfg.name} {TRAIN_E2E_LAYERS} layers, batch "
              f"{TRAIN_E2E_BATCH} x {TRAIN_E2E_SEQ}, {dtype}: loss {float(lg):.6f} vs "
              f"{float(lc):.6f} (relative {loss_rel:.3g}); worst gradient leaf {worst_leaf} at "
              f"{worst:.3g} of its max|g| (band {tol})", flush=True)
        check(loss_rel <= tol, f"{dtype}: the card's loss differs from the CPU's by {loss_rel:.3g}")
        check(worst <= tol, f"{dtype}: gradient {worst_leaf} differs by {worst:.3g} of its scale")
        out[dtype] = {"loss_rel": loss_rel, "worst_grad_rel": worst, "worst_leaf": worst_leaf}
    RESULTS["train_e2e"] = out


def phase_train_restart():
    """``train_loop`` with checkpoints every 5 steps and a fault injected
    at step 12 (full width, depth cut to 4 layers): the fault fires, the
    loop resumes from step 10 and completes, and the resumed steps' losses
    equal an uninterrupted run's."""
    import shutil
    import tempfile

    cfg = dataclasses.replace(get_config(ARCH), n_layers=RESTART_LAYERS)
    kw = dict(steps=RESTART_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=0,
              device="cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        inj = FaultInjector(fail_at_steps=(RESTART_FAULT,))
        t0 = time.perf_counter()
        _, losses, _ = train_loop(cfg, ckpt_dir=tmp, ckpt_every=5, fault_injector=inj, **kw)
        wall = time.perf_counter() - t0
        _, clean, _ = train_loop(cfg, **kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resumed, want = losses[RESTART_FAULT:], clean[10:]
    same = resumed == want
    diff = max(abs(a - b) for a, b in zip(resumed, want)) if len(resumed) == len(want) else None
    print(f"[train] restart: fault at step {RESTART_FAULT} fired {RESTART_FAULT in inj.fired}; "
          f"{len(losses)} losses ({RESTART_FAULT} before the fault, {len(resumed)} resumed from "
          f"step 10) in {wall:.2f} s with checkpoints; resumed losses equal an uninterrupted "
          f"run's bit for bit: {same} (max difference {diff})", flush=True)
    check(RESTART_FAULT in inj.fired, "the injected fault did not fire")
    check(len(losses) == RESTART_FAULT + RESTART_STEPS - 10, f"{len(losses)} losses recorded")
    check(losses[:RESTART_FAULT] == clean[:RESTART_FAULT], "the steps before the fault differ")
    check(same, f"the resumed losses {resumed} differ from an uninterrupted run's {want}")
    RESULTS["train_restart"] = {"losses": losses, "clean": clean, "bit_identical": same,
                                "wall_s": wall}


TRAIN_CLI = ["repro_torch.launch.train", "--steps", "5", "--json"]


def check_train_cli(out, wall):
    """``python -m repro_torch.launch.train --steps 5 --json`` (run by
    ``phase_clis``) must exit 0 with five finite losses on the card."""
    check(out["device"]["platform"] == "gpu" and len(out["losses"]) == 5
          and all(math.isfinite(x) for x in out["losses"]),
          f"the CLI's summary is wrong: {out['device']}, {out['losses']}")
    print(f"[train] python -m repro_torch.launch.train --steps 5 --json: exit 0 in {wall:.1f} s on "
          f"{out['device']['kind']}; loss {out['loss_first']:.4f} -> {out['loss_last']:.4f}, step "
          f"p50 {out['step_p50_s']*1e3:.3f} ms (batch {out['batch']} x {out['seq']}), launches "
          f"{out['launches']}", flush=True)
    RESULTS["train_cli"] = {k: out[k] for k in ("losses", "step_p50_s", "launches", "wall_s")}


# ---------------------------------------------------------------------------
# phase 13: hybrid training (zamba2-2.7b) on the card
# ---------------------------------------------------------------------------

# card against CPU: one Mamba2 block at full width in bf16, and the
# full-width model cut to one group (6 Mamba2 layers and the shared block)
# in f32, both at batch 2 x 128
HYBRID_TRAIN_E2E_BATCH, HYBRID_TRAIN_E2E_SEQ = 2, 128
# ssm_scan_bwd against ssm_scan_bwd_ref on the f32 result of the same
# operands, as a fraction of each gradient's max|ref|: f32, 1e-4 (the
# forward's gate: sums over T*N and T*P terms in other orders, the chunk's
# cumulative log-decay inside the exps); bf16, 1e-3 (the states it reads
# come from the bf16 forward, held to 1e-4 of the state's scale) plus one
# bf16 rounding (2**-8) of each du, dB and dC entry
SSM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
HYBRID_CLI_STEPS = 3


def _ssm_bwd_gate(got, exact, dtype):
    """The scan backward's gate (``SSM_BWD_TOL``): each of du, dld, dB, dC
    within the tolerance of its max|ref| plus, in bf16, one rounding of each
    du, dB and dC entry. Returns (ok, max|err| by output, the error past
    the rounding as a fraction of the scale by output)."""
    ok, errs, rel = True, [], []
    for g, x, rounded in zip(got, exact, (True, False, True, True)):
        err = (g.float() - x).abs()
        scale = max(x.abs().max().item(), 1e-30)
        rounding = 2.0**-8 * x.abs() if dtype == torch.bfloat16 and rounded else 0.0
        ok = ok and g.shape == x.shape and bool((err <= SSM_BWD_TOL[dtype] * scale + rounding).all())
        errs.append(err.max().item())
        rel.append(((err - rounding) / scale).max().item())
    return ok, errs, rel


def check_ssm_bwd(gen, bt, s, h, p, n, dtype, chunk=CHUNK, shared_bc=True, with_dstate=False,
                  time_it=False):
    """``ssm_scan_bwd`` (the variant ``plan`` picks: ``mma`` for bf16 with
    16-byte rows, ``fma`` otherwise) against ``ssm_scan_bwd_ref`` on the
    f32 result of the same operands, with the forward kernel's states (B
    and C shared by the heads come with a head dim of 1, as Mamba2 passes
    them: the kernel sums their gradients over groups of heads, the
    wrapper over the groups); two calls bit-identical. Where the call runs
    ``mma``, the ``fma`` kernel runs on the same inputs too (forced: it
    takes every layout), held to the same gate. Timed: the wrapper, the
    kernel alone (device time), ``fma`` beside them, the plain version on
    the card, and the forward scan with and without the states it stores."""
    es = 2 if dtype == torch.bfloat16 else 4
    n_bytes, n_ops = ssm_ops.bwd_work(bt, s, h, p, n, es, shared_bc, chunk, with_dstate)[:2]
    n_sets = max(1, math.ceil(COLD_BYTES / n_bytes)) if time_it else 1
    sets = []
    for _ in range(n_sets):
        u, ld, Bh, Ch = _ssm_set(gen, bt, s, h, p, n, dtype, shared_bc)
        B, C = (Bh[:, :, :1], Ch[:, :, :1]) if shared_bc else (Bh, Ch)
        dy = torch.randn(bt, s, h, p, generator=gen, device="cuda").to(dtype)
        ds = torch.randn(bt, h, n, p, generator=gen, device="cuda") if with_dstate else None
        _, _, states = ssm_ops._forward(u, ld, Bh, Ch, chunk, with_states=True)
        sets.append((u, ld, B, C, dy, ds, states))
    u, ld, B, C, dy, ds, states = sets[0]
    variant = _want_variant(dtype) if p % 8 == 0 else "fma"

    def call(i):
        u, ld, B, C, dy, ds, states = sets[i % n_sets]
        return ssm_scan_bwd(u, ld, B, C, dy, ds, states=states, chunk=chunk)

    def call_fma(i):  # the fma kernel on the same inputs, through the same sums and casts
        u, ld, B, C, dy, ds, states = sets[i % n_sets]
        return ssm_ops._backward(u, ld, B.expand(-1, -1, h, -1), C.expand(-1, -1, h, -1), dy, ds,
                                 states, chunk, shared=shared_bc, force_fma=True, grad_dtype=dtype)

    before = ssm_scan_bwd.launches
    got = _count_variant(ssm_scan_bwd, variant, lambda: call(0))
    check(ssm_scan_bwd.launches == before + 1, "ssm_scan_bwd did not launch once")
    again = call(0)
    exact = ssm_scan_bwd_ref(u.float(), ld, B.float().expand(-1, -1, h, -1),
                             C.float().expand(-1, -1, h, -1), dy.float(), ds, chunk)
    if shared_bc:
        exact = (*exact[:2], exact[2].sum(2, keepdim=True), exact[3].sum(2, keepdim=True))
    torch.cuda.synchronize()
    ok, errs, rel = _ssm_bwd_gate(got, exact, dtype)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    tag = (f"Bt{bt} S{s} H{h} P{p} N{n} {str(dtype).split('.')[-1]} chunk {chunk}"
           f"{' B/C shared' if shared_bc else ''}{' d_state' if with_dstate else ''} [{variant}]")
    row = {"case": tag, "variant": variant, "max_abs_err": max(errs), "max_abs_err_by_output": errs,
           "err_past_rounding_of_scale": rel, "bit_identical": same, "ok": ok and same}
    if variant == "mma":
        fma = _count_variant(ssm_scan_bwd, "fma", lambda: call_fma(0))
        fma_ok, fma_errs, fma_rel = _ssm_bwd_gate(fma, exact, dtype)
        fma_same = all(torch.equal(x, y) for x, y in zip(fma, call_fma(0)))
        row.update(fma_max_abs_err=max(fma_errs), fma_err_past_rounding_of_scale=fma_rel,
                   fma_bit_identical=fma_same)
        row["ok"] = row["ok"] and fma_ok and fma_same
    if time_it:
        row["bytes"], row["ops"] = n_bytes, n_ops
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, dtype)
        row["f32_cuda_core_floor_ms"] = n_ops / PEAK_OPS_S[torch.float32] * 1e3
        row["ms"] = cuda_ms(call, n_sets)
        row["kernel_only_ms"] = sum(ms for name, ms in device_ms_per_call(call).items()
                                    if "ssd_bwd" in name)
        if variant == "mma":  # the fma kernel on the same inputs, beside it
            row["fma_ms"] = cuda_ms(call_fma, n_sets)
            row["fma_kernel_only_ms"] = sum(ms for name, ms in device_ms_per_call(call_fma).items()
                                            if "ssd_bwd" in name)
        row["plain_ms"] = cuda_ms(lambda i: ssm_scan_bwd_ref(
            *sets[i][:2], *(t.expand(-1, -1, h, -1) for t in sets[i][2:4]), *sets[i][4:6],
            chunk), n_sets)
        row["library_ms"] = None  # no PyTorch call computes the scan's backward
        fwd = [(t[0], t[1], t[2].expand(-1, -1, h, -1), t[3].expand(-1, -1, h, -1))
               for t in sets]
        for key, with_states in (("forward_ms", False), ("forward_with_states_ms", True)):
            row[key] = cuda_ms(lambda i: ssm_ops._forward(*fwd[i], chunk, with_states), n_sets)
    print(f"[train] ssm_scan_bwd {tag}: max|err| vs f32 du/dld/dB/dC "
          f"{'/'.join(f'{e:.3g}' for e in errs)}, past one rounding "
          f"{'/'.join(f'{r:.2g}' for r in rel)} of the scale (gate {SSM_BWD_TOL[dtype]}); two "
          f"calls bit-identical {same}"
          + (f"; fma on the same inputs past one rounding "
             f"{'/'.join(f'{r:.2g}' for r in row['fma_err_past_rounding_of_scale'])}, "
             f"bit-identical {row['fma_bit_identical']}" if variant == "mma" else "")
          + (f"; {row['ms']*1e3:.1f} us per call ({row['kernel_only_ms']*1e3:.1f} us the kernel "
             f"alone)"
             + (f", fma {row['fma_ms']*1e3:.1f} us ({row['fma_kernel_only_ms']*1e3:.1f} us)"
                if "fma_ms" in row else "")
             + f", plain {row['plain_ms']*1e3:.1f} us, bound {row['bound_ms']*1e3:.2f} us "
             f"({row['bound_by']}; the f32 CUDA cores' floor {row['f32_cuda_core_floor_ms']*1e3:.1f}"
             f" us); the forward {row['forward_ms']*1e3:.1f} us, with states "
             f"{row['forward_with_states_ms']*1e3:.1f} us" if time_it else "")
          + ("" if row["ok"] else "  FAIL"), flush=True)
    check(same, f"ssm_scan_bwd {tag}: two calls on the same inputs differ")
    check(row["ok"], f"ssm_scan_bwd {tag} (or fma beside it) disagrees with ssm_scan_bwd_ref")
    return row


def phase_train_ssm_bwd():
    """Phase 13's kernel checks: ssm_scan_bwd at zamba2's training shape
    (timed in bf16, ``mma`` with ``fma`` on the same inputs beside it) and
    at edge shapes, each bf16 one that ``mma`` takes on both variants.
    Returns the timed row and the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    cfg = get_config(HYBRID)
    sh = (TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
          cfg.ssm_head_dim, cfg.ssm_state)
    main = check_ssm_bwd(gen, *sh, torch.bfloat16, time_it=True)
    rows = [main, check_ssm_bwd(gen, *sh, torch.bfloat16, with_dstate=True),
            check_ssm_bwd(gen, *sh, torch.bfloat16, chunk=64)]
    for dtype in (torch.float32, torch.bfloat16):
        sb = functools.partial(check_ssm_bwd, gen, dtype=dtype)
        if dtype == torch.float32:
            rows += [sb(*sh), sb(*sh, with_dstate=True)]
        for chunk in CHUNKS:
            rows.append(sb(2, 200, 8, 64, 64, chunk=chunk, with_dstate=True))  # ragged S
            rows.append(sb(2, 20, 4, 64, 64, chunk=chunk, shared_bc=False))  # S below the chunk
            rows.append(sb(2, 40, 16, 16, 16, chunk=chunk, shared_bc=False))  # N = P = 16
            rows.append(sb(2, 40, 3, 40, 32, chunk=chunk, with_dstate=True))  # ragged P tile, N 32
            rows.append(sb(1, 100, 2, 192, 96, chunk=chunk, shared_bc=False))  # P tiles, N 96
            rows.append(sb(1, 33, 2, 1, 96, chunk=chunk, shared_bc=False))  # P = 1
            rows.append(sb(2, 70, 8, 64, 96, chunk=chunk, with_dstate=True))  # 8 heads' sums, N 96
    RESULTS["train_ssm_bwd"] = rows
    return main, max(r["max_abs_err"] for r in rows)


def phase_train_hybrid_profile(state, step_p50_s):
    """One warm train step of the hybrid path's model on its trained state
    and the next batch, written out as train_step's two calls so that it
    reports the global gradient norm AdamW clips with (f32, as the
    reference forms it) and the largest gradients; then one train step
    under torch.profiler. Both update the state in place, as train_loop's
    steps do, so that params and moments are held once."""
    cfg = get_config(HYBRID)
    model = build(cfg, "cuda")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS)
    step = make_train_step(model, opt_cfg)
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch = {k: torch.from_numpy(x).to("cuda") for k, x in data.batch(TRAIN_STEPS).items()}
    params, opt = state["params"], state["opt"]
    _, grads = loss_and_grads(model, params, batch, True)
    top = sorted(((g.float().abs().max().item(), ".".join(path)) for path, g in leaves(grads)),
                 reverse=True)[:3]
    params, opt, gnorm = adamw_update(params, grads, opt, opt_cfg)
    gnorm = float(gnorm)
    del grads
    print(f"[train] {HYBRID} after {TRAIN_STEPS} steps: the f32 global gradient norm AdamW clips "
          f"with is {gnorm:.6g} (largest |g|: "
          + ", ".join(f"{name} {v:.3g}" for v, name in top)
          + "); a norm that is not finite scales every update to 0, leaving weight decay alone",
          flush=True)
    RESULTS.setdefault("train_hybrid", {}).update(global_grad_norm=gnorm, largest_grads=top)
    torch.cuda.synchronize()
    RESULTS["profile"][f"train {HYBRID}"] = _profile_train_step(
        lambda: step(params, opt, batch), step_p50_s, f"{HYBRID} train step",
        {"dos_matmul": "dos_matmul", "flash forward": "flash_mma", "flash backward": "flash_bwd",
         "ssm_scan": "ssd_mma", "ssm_scan_bwd": "ssd_bwd"})


def phase_train_hybrid_learns():
    """The hybrid's loss falls where its gradient norm is finite: zamba2-2.7b
    at full width cut to one group (6 Mamba2 layers and the shared block),
    ``train_loop`` as the main path runs it (8 x 512, seed 0, 30 steps,
    remat): every loss finite, the last below the first and the mean of
    the last 5 below that of the first 5. At full depth, random weights
    grow the residual stream through 54 Mamba2 layers that take it without
    a norm (as the reference's), so the f32 gradient norm overflows and
    AdamW's clip zeroes every update (ROADMAP queue 3; the main path prints
    its norm)."""
    cfg = dataclasses.replace(get_config(HYBRID), n_layers=get_config(HYBRID).attn_every)
    t0 = time.perf_counter()
    _, losses, wd = train_loop(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                               seq_len=TRAIN_SEQ, seed=0, log_every=0, device="cuda")
    wall = time.perf_counter() - t0
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[train] train_loop {cfg.name} cut to one group ({cfg.n_layers} Mamba2 layers and the "
          f"shared block), batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps in {wall:.2f} s: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (means of 5: {first:.4f} -> {last:.4f})",
          flush=True)
    check(all(math.isfinite(x) for x in losses), "a training loss of the one-group hybrid is "
          "not finite")
    check(last < first and losses[-1] < losses[0],
          f"the one-group hybrid's loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f} (means "
          f"of 5: {first:.4f} -> {last:.4f})")
    RESULTS.setdefault("train_hybrid", {}).update(one_group_losses=losses, one_group_wall_s=wall,
                                                  one_group_step_s=wd.times)


def phase_train_hybrid_e2e():
    """Card against CPU on the same f32 master weights: one Mamba2 block
    at full width in bf16 (its input's and parameters' gradients under a
    random output gradient, within 3e-2 of each leaf's max|g|), and the
    full-width model cut to one group in f32 (the loss and every gradient
    leaf of one train step, within 1e-3): the hybrid is held block by
    block in bf16, as in serving (ROADMAP queue 3: random weights amplify
    rounding)."""
    cfg = get_config(HYBRID)
    b, s = HYBRID_TRAIN_E2E_BATCH, HYBRID_TRAIN_E2E_SEQ
    gen = torch.Generator().manual_seed(0)
    lp = materialize(mamba_defs(cfg), gen)
    x = torch.randn(b, s, cfg.d_model, generator=gen).to(torch.bfloat16)
    gy = torch.randn(b, s, cfg.d_model, generator=gen).to(torch.bfloat16)

    def block_grads(dev):
        ins = {"x": x.to(dev).requires_grad_(),
               "p": map_tree(lambda t: t.to(dev).requires_grad_(), lp)}
        out, _ = mamba_block(ins["p"], ins["x"], cfg, mode="train")
        torch.autograd.backward(out, gy.to(dev))
        return map_tree(lambda t: t.grad, ins)

    block_rel, block_leaf = _grad_gap(block_grads("cuda"), block_grads("cpu"))
    print(f"[train] card vs CPU, one mamba_block of {cfg.name} at full width, batch {b} x {s}, "
          f"bf16: worst gradient (input and parameters) {block_leaf} at {block_rel:.3g} of its "
          f"max|g| (band {E2E_TOL})", flush=True)
    check(block_rel <= E2E_TOL, f"mamba_block gradient {block_leaf} differs by {block_rel:.3g}")

    cfg1 = dataclasses.replace(cfg, n_layers=cfg.attn_every, compute_dtype="float32")
    mc, mg = build(cfg1, "cpu"), build(cfg1, "cuda")
    params_c = mc.init(torch.Generator().manual_seed(0))
    params_g = map_tree(lambda t: t.to("cuda"), params_c)
    data = SyntheticLM(DataConfig(cfg1.vocab, s, b, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    t0 = time.perf_counter()
    lc, gc = loss_and_grads(mc, params_c, batch, True)
    cpu_s = time.perf_counter() - t0
    lg, gg = loss_and_grads(mg, params_g, {k: v.cuda() for k, v in batch.items()}, True)
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    worst, worst_leaf = _grad_gap(gg, gc)
    print(f"[train] card vs CPU, {cfg.name} at full width cut to one group ({cfg1.n_layers} "
          f"Mamba2 layers and the shared block), batch {b} x {s}, float32: loss {float(lg):.6f} "
          f"vs {float(lc):.6f} (relative {loss_rel:.3g}); worst gradient leaf {worst_leaf} at "
          f"{worst:.3g} of its max|g| (band {TRAIN_F32_TOL}); the CPU's step {cpu_s:.1f} s",
          flush=True)
    check(loss_rel <= TRAIN_F32_TOL, f"float32: the card's loss differs by {loss_rel:.3g}")
    check(worst <= TRAIN_F32_TOL, f"float32: gradient {worst_leaf} differs by {worst:.3g}")
    RESULTS["train_hybrid_e2e"] = {"block_bf16_worst_grad_rel": block_rel,
                                   "block_bf16_worst_leaf": block_leaf, "f32_loss_rel": loss_rel,
                                   "f32_worst_grad_rel": worst, "f32_worst_leaf": worst_leaf}


HYBRID_CLI = ["repro_torch.launch.train", "--arch", HYBRID, "--steps", str(HYBRID_CLI_STEPS),
              "--json"]


def check_train_hybrid_cli(out, wall):
    """``python -m repro_torch.launch.train --arch zamba2-2.7b --steps 3
    --json`` (run by ``phase_clis``): exit 0, finite losses, the launches
    of 3 steps exact."""
    want = {k: n * HYBRID_CLI_STEPS
            for k, n in expected_train_launches(get_config(HYBRID)).items()}
    check(out["device"]["platform"] == "gpu" and len(out["losses"]) == HYBRID_CLI_STEPS
          and all(math.isfinite(x) for x in out["losses"]) and out["launches"] == want,
          f"the CLI's summary is wrong: {out['device']}, {out['losses']}, {out['launches']}")
    print(f"[train] python -m repro_torch.launch.train --arch {HYBRID} --steps "
          f"{HYBRID_CLI_STEPS} --json: exit 0 in {wall:.1f} s on {out['device']['kind']}; loss "
          f"{out['loss_first']:.4f} -> {out['loss_last']:.4f}, step p50 "
          f"{out['step_p50_s']*1e3:.3f} ms (batch {out['batch']} x {out['seq']}), launches "
          f"{out['launches']}", flush=True)
    RESULTS["train_hybrid_cli"] = {k: out[k] for k in ("losses", "step_p50_s", "launches",
                                                       "wall_s")}


def phase_train_hybrid_gemms():
    """The dos_matmul Function (forward, dA, dB; each ``wgmma``) at every
    projection of zamba2's train step (M = 8 x 512 tokens), each timed
    beside torch.matmul on the same operands, and summed over one step's
    calls: each Mamba2 projection's forward twice (remat), every
    projection's dA and dB (with the copy of A^T that dB reads) once."""
    cfg = get_config(HYBRID)
    gen = torch.Generator(device="cuda").manual_seed(16)
    e, di = cfg.d_model, cfg.ssm_expand * cfg.d_model
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    n_attn = cfg.n_layers // cfg.attn_every
    n_mamba = n_attn * cfg.attn_every
    calls: dict = {}  # (K, N, tied) -> [forward calls, backward calls] per step
    for k, n, c in ((e, di, 2), (e, cfg.ssm_state, 2), (e, di // cfg.ssm_head_dim, 1),
                    (di, e, 1)):  # wx wz, wB wC, wdt, wo
        calls.setdefault((k, n, False), [0, 0])
        calls[(k, n, False)][0] += 2 * c * n_mamba
        calls[(k, n, False)][1] += c * n_mamba
    for k, n, c in ((e, q, 1), (e, kv, 2), (q, e, 1), (e, cfg.d_ff, 2), (cfg.d_ff, e, 1)):
        calls.setdefault((k, n, False), [0, 0])
        calls[(k, n, False)][0] += c * n_attn
        calls[(k, n, False)][1] += c * n_attn
    calls[(e, cfg.vocab, cfg.tie_embeddings)] = [1, 1]
    launches = sum(f + 2 * b for f, b in calls.values())
    check(launches == expected_train_launches(cfg)["dos_matmul"],
          f"zamba2's training GEMMs: {launches} launches counted, expected "
          f"{expected_train_launches(cfg)['dos_matmul']}")
    tot = {"ms": 0.0, "torch_matmul_ms": 0.0, "transpose_copy_ms": 0.0}
    rows = []
    for (k, n, tied), (fwd, bwd) in calls.items():
        row = check_dos_function(gen, TRAIN_BATCH * TRAIN_SEQ, k, n, tied)
        rows.append(dict(row, forward_calls=fwd, backward_calls=bwd))
        tot["ms"] += fwd * row["forward_ms"] + bwd * (row["dA_ms"] + row["dB_ms"]
                                                      + row["transpose_copy_ms"])
        tot["torch_matmul_ms"] += (fwd * row["forward_torch_matmul_ms"]
                                   + bwd * (row["dA_torch_matmul_ms"]
                                            + row["dB_torch_matmul_ms"]))
        tot["transpose_copy_ms"] += bwd * row["transpose_copy_ms"]
    print(f"[train] {HYBRID}'s GEMMs of one train step ({launches} launches): dos_matmul "
          f"{tot['ms']:.3f} ms (A^T copies {tot['transpose_copy_ms']:.3f} ms of it), "
          f"torch.matmul on the same operands {tot['torch_matmul_ms']:.3f} ms", flush=True)
    RESULTS["train_hybrid_gemms"] = {"rows": rows, **tot}


# ---------------------------------------------------------------------------
# phase 14: xLSTM (xlstm-125m) serving and training on the card
# ---------------------------------------------------------------------------

# the sLSTM recurrence against its plain loop on the same card, as a
# fraction of each output's max|ref|: both variants sum each column's d
# products as 4 partial sums (reg: each as two chains that meet; the
# loop's einsum in another order) and their tanh, exp and divides round
# in other ways; the forget gate damps what the recurrence carries. 1e-4
# is the f32 scan's gate (phase 4).
SLSTM_TOL = 1e-4
# its backward (and dr) against autograd of the loop: 1e-4 of each
# gradient's max|ref|, the same f32 math summed in other orders
SLSTM_BWD_TOL = 1e-4
XLSTM_CLI_STEPS = 3


def _slstm_set(gen, b, s, h, d, with_state):
    """Recurrence inputs on the card: z_in, o_in ~ N(0, 1), i_in ~ N(0, 4),
    f_in ~ N(1, 4), r ~ N(0, 0.01) (the reference's init scale 0.1), and
    the initial state zeros (prefill, training) or random (decode)."""
    e = h * d

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    ins = [rn(b, s, e), rn(b, s, h, scale=2.0), rn(b, s, h, scale=2.0, shift=1.0), rn(b, s, e),
           rn(h, d, d, scale=0.1)]
    if with_state:
        return ins + [rn(b, e), rn(b, h).abs() + 0.5, rn(b, e, scale=0.5)]
    return ins + [torch.zeros(b, e, device="cuda"), torch.zeros(b, h, device="cuda"),
                  torch.zeros(b, e, device="cuda")]


def _rel_errs(got, want):
    """max|got - want| / max|want| of each pair."""
    return [(g.float() - w.float()).abs().max().item() / max(w.abs().max().item(), 1e-30)
            for g, w in zip(got, want)]


def _host_ms(fn, reps=3):
    """Wall ms per call of ``fn()`` launched from the host, ending in a
    synchronize (the plain loop's cost as a caller meets it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_slstm(gen, b, s, h, d, with_state=False, time_it=False, store=False):
    """``slstm_scan`` (the variant ``plan`` picks) against ``slstm_scan_ref``
    (the loop, on the same card) within SLSTM_TOL of each output's
    max|ref| (ys, c, n, h); where it picks ``reg``, ``fma`` forced on the
    same inputs too; two calls of each bit-identical. Timed: the kernel
    (with ``store``: as training calls it, keeping c, n, z), ``fma``
    beside it, the loop replayed from a CUDA graph and launched from the
    host, and the bound."""
    n_bytes, n_ops = slstm_ops.work(b, s, h, d, store)[:2]
    n_sets = max(1, math.ceil(COLD_BYTES / n_bytes)) if time_it else 1
    sets = [_slstm_set(gen, b, s, h, d, with_state) for _ in range(n_sets)]
    ins = sets[0]
    variant = slstm_ops.plan(d)
    got = _count_variant(slstm_scan, variant, lambda: slstm_scan(*ins))
    again = slstm_scan(*ins)
    plain = slstm_scan_ref(*ins)
    torch.cuda.synchronize()
    rel = _rel_errs(got, plain)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    tag = (f"B{b} S{s} H{h} d{d}{' state in' if with_state else ''}{' store' if store else ''} "
           f"[{variant}]")
    row = {"case": tag, "variant": variant,
           "max_abs_err": max((g - w).abs().max().item() for g, w in zip(got, plain)),
           "rel_err_by_output": rel, "bit_identical": same,
           "ok": max(rel) <= SLSTM_TOL and same}
    if variant != "fma":  # the fma kernel on the same inputs
        fma = _count_variant(slstm_scan, "fma",
                             lambda: slstm_ops._forward(*ins, force_fma=True)[:4])
        fma_rel = _rel_errs(fma, plain)
        fma_same = all(torch.equal(x, y) for x, y in
                       zip(fma, slstm_ops._forward(*ins, force_fma=True)[:4]))
        row.update(fma_rel_err_by_output=fma_rel, fma_bit_identical=fma_same,
                   fma_max_abs_err=max((g - w).abs().max().item() for g, w in zip(fma, plain)))
        row["ok"] = row["ok"] and max(fma_rel) <= SLSTM_TOL and fma_same
    if time_it:
        row["bytes"], row["ops"] = n_bytes, n_ops
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, torch.float32)
        row["ms"] = cuda_ms(lambda i: slstm_ops._forward(*sets[i], store=store), n_sets)
        if variant != "fma":
            row["fma_ms"] = cuda_ms(lambda i: slstm_ops._forward(*sets[i], store=store,
                                                                 force_fma=True), n_sets)
        row["us_per_step"] = row["ms"] * 1e3 / s
        row["plain_ms"] = cuda_ms(lambda i: slstm_scan_ref(*sets[i], store=store), n_sets,
                                  iters=None if s == 1 else 3)
        row["plain_host_ms"] = _host_ms(lambda: slstm_scan_ref(*ins, store=store))
        row["library_ms"] = None  # no PyTorch call computes the recurrence
    print(f"[xlstm] slstm_scan {tag}: max|err| / max|ref| ys/c/n/h "
          f"{'/'.join(f'{r:.2g}' for r in rel)} (gate {SLSTM_TOL}); two calls bit-identical "
          f"{same}"
          + (f"; fma on the same inputs "
             f"{'/'.join(f'{r:.2g}' for r in row['fma_rel_err_by_output'])}, bit-identical "
             f"{row['fma_bit_identical']}" if variant != "fma" else "")
          + (f"; kernel {row['ms']*1e3:.1f} us ({row['us_per_step']:.3f} us a step)"
             + (f", fma {row['fma_ms']*1e3:.1f} us" if "fma_ms" in row else "")
             + f", plain loop {row['plain_ms']*1e3:.1f} us (graph "
             f"replay; {row['plain_host_ms']*1e3:.1f} us launched from the host), bound "
             f"{row['bound_ms']*1e3:.2f} us ({row['bound_by']})" if time_it else "")
          + ("" if row["ok"] else "  FAIL"), flush=True)
    check(same, f"slstm_scan {tag}: two calls on the same inputs differ")
    check(row["ok"], f"slstm_scan {tag} (or fma beside it) disagrees with slstm_scan_ref: {rel}")
    return row


def check_slstm_bwd(gen, b, s, h, d, with_state=False, with_final=False, time_it=False):
    """``slstm_scan`` through its autograd Function (the forward kernel
    storing c, n, z; the backward kernel; dr by ``slstm_dr``), both of
    the variant ``plan`` picks, against autograd of ``slstm_scan_ref`` on
    the same card, every input's gradient within SLSTM_BWD_TOL of its
    max|ref|; where it picks ``reg``, both ``fma`` kernels forced on the
    same inputs too; two calls of each bit-identical. Timed: the backward
    kernel alone, ``fma``'s beside it on the same stored c, n, z, dr's
    product, the closed-form loop ``slstm_scan_bwd_ref`` on the card, and
    the bound."""
    ins = _slstm_set(gen, b, s, h, d, with_state)
    e = h * d
    dys = torch.randn(b, s, e, generator=gen, device="cuda")
    d_final = ([torch.randn(b, e, generator=gen, device="cuda"),
                torch.randn(b, h, generator=gen, device="cuda"),
                torch.randn(b, e, generator=gen, device="cuda")] if with_final else [])
    variant = slstm_ops.plan(d)

    def grads(fn):
        leaves_in = [t.clone().requires_grad_() for t in ins]
        outs = fn(*leaves_in)
        torch.autograd.backward(list(outs[:1 + len(d_final)]), [dys] + d_final)
        return [t.grad for t in leaves_in]

    def grads_fma():  # both fma kernels, forced, and the same dr
        z_in, i_in, f_in, o_in, r, c0, n0, h0 = ins
        ys, _, _, _, saved = slstm_ops._forward(*ins, store=True, force_fma=True)
        dz, di, df, do, dc0, dn0, dh0 = slstm_ops._backward(
            i_in, f_in, o_in, r, c0, n0, saved, dys, *(d_final or [None] * 3), force_fma=True)
        return [dz, di, df, do, slstm_dr(h0, ys, dz, h), dc0, dn0, dh0]

    before = (slstm_scan.launches, slstm_scan_bwd.launches)
    got = _count_variant(slstm_scan_bwd, variant,
                         lambda: _count_variant(slstm_scan, variant, lambda: grads(slstm_scan)))
    check((slstm_scan.launches, slstm_scan_bwd.launches) == (before[0] + 1, before[1] + 1),
          "the sLSTM Function did not launch one forward and one backward")
    want = grads(slstm_scan_ref)
    again = grads(slstm_scan)
    torch.cuda.synchronize()
    rel = _rel_errs(got, want)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    names = ("z_in", "i_in", "f_in", "o_in", "r", "c0", "n0", "h0")
    tag = (f"B{b} S{s} H{h} d{d}{' state in' if with_state else ''}"
           f"{' final-state gradient' if with_final else ''} [{variant}]")
    row = {"case": tag, "variant": variant,
           "max_abs_err": max((g - w).abs().max().item() for g, w in zip(got, want)),
           "rel_err_by_input": dict(zip(names, rel)), "bit_identical": same,
           "ok": max(rel) <= SLSTM_BWD_TOL and same}
    if variant != "fma":
        fma = _count_variant(slstm_scan_bwd, "fma", grads_fma)
        fma_rel = _rel_errs(fma, want)
        fma_same = all(torch.equal(x, y) for x, y in zip(fma, grads_fma()))
        row.update(fma_rel_err_by_input=dict(zip(names, fma_rel)), fma_bit_identical=fma_same,
                   fma_max_abs_err=max((g - w).abs().max().item() for g, w in zip(fma, want)))
        row["ok"] = row["ok"] and max(fma_rel) <= SLSTM_BWD_TOL and fma_same
    if time_it:
        z_in, i_in, f_in, o_in, r, c0, n0, h0 = ins
        ys, _, _, _, saved = slstm_ops._forward(*ins, store=True)
        n_bytes, n_ops = slstm_ops.bwd_work(b, s, h, d)[:2]
        row["bytes"], row["ops"] = n_bytes, n_ops
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, torch.float32)
        row["ms"] = cuda_ms(lambda i: slstm_scan_bwd(i_in, f_in, o_in, r, c0, n0, saved, dys), 1)
        if variant != "fma":
            row["fma_ms"] = cuda_ms(lambda i: slstm_ops._backward(
                i_in, f_in, o_in, r, c0, n0, saved, dys, force_fma=True), 1)
        row["us_per_step"] = row["ms"] * 1e3 / s
        dz = slstm_scan_bwd(i_in, f_in, o_in, r, c0, n0, saved, dys)[0]
        row["dr_ms"] = cuda_ms(lambda i: slstm_dr(h0, ys, dz, h), 1)
        row["plain_ms"] = cuda_ms(lambda i: slstm_scan_bwd_ref(i_in, f_in, o_in, r, c0, n0, saved,
                                                               dys), 1, iters=3)
        row["forward_with_store_ms"] = cuda_ms(lambda i: slstm_ops._forward(*ins, store=True), 1)
        row["library_ms"] = None
    print(f"[xlstm] slstm_scan_bwd {tag}: max|err| / max|ref| "
          + ", ".join(f"{n} {r:.2g}" for n, r in zip(names, rel))
          + f" (gate {SLSTM_BWD_TOL}); two calls bit-identical {same}"
          + (f"; fma on the same inputs worst {max(row['fma_rel_err_by_input'].values()):.2g}, "
             f"bit-identical {row['fma_bit_identical']}" if variant != "fma" else "")
          + (f"; kernel {row['ms']*1e3:.1f} us ({row['us_per_step']:.3f} us a step)"
             + (f", fma {row['fma_ms']*1e3:.1f} us" if "fma_ms" in row else "")
             + f" (+ dr {row['dr_ms']*1e3:.1f} us), plain "
             f"closed form {row['plain_ms']*1e3:.1f} us, bound {row['bound_ms']*1e3:.2f} us "
             f"({row['bound_by']}); the forward storing c, n, z "
             f"{row['forward_with_store_ms']*1e3:.1f} us" if time_it else "")
          + ("" if row["ok"] else "  FAIL"), flush=True)
    check(same, f"slstm_scan_bwd {tag}: two calls on the same inputs differ")
    check(row["ok"], f"slstm_scan_bwd {tag} (or fma beside it) disagrees with autograd of the "
          f"loop: {rel}")
    return row


def xlstm_path_gemms(cfg) -> dict:
    """{(K, N, B transposed): calls per prefill and per decode step} of
    the xLSTM's projections and its tied unembedding."""
    n_m, n_s = xlstm_block_counts(cfg)
    e, h = cfg.d_model, cfg.n_heads
    qk, hv = h * cfg.ssm_state, h * cfg.ssm_head_dim
    out: dict = {}
    for k, n, count in ((e, qk, 2 * n_m), (e, hv, 2 * n_m), (hv, e, n_m), (e, e, 3 * n_s),
                        (e, h, 2 * (n_m + n_s)), (e, cfg.vocab, 1)):
        key = (k, n, cfg.tie_embeddings and (k, n) == (e, cfg.vocab))
        out[key] = out.get(key, 0) + count
    return out


def phase_xlstm_kernels():
    """Phase 14's kernel checks: ``slstm_scan`` at the serving prefill,
    decode (a state in) and training (storing c, n, z) shapes, timed, and
    at a ragged S and the reduced width; ``slstm_scan_bwd`` at the training
    shape, timed, and at edge shapes; the mLSTM's scans (memory N 96, P
    192, B and C per head: ``mma``; normaliser P 1: ``fma``) at the serving
    and training shapes and their backwards at the training shape, timed;
    the path's GEMMs at the prefill and decode shapes, timed, and the
    general wi/wf GEMMs' Function at the training shape. Returns the rows,
    the path's GEMM totals and the largest errors by kernel."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    cfg = get_config(XLSTM)
    h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
    n_m, n_s = xlstm_block_counts(cfg)
    rows = {"slstm_scan": {}, "slstm_scan_bwd": {}, "ssm_scan": {}, "ssm_scan_bwd": {},
            "dos_matmul": []}
    fwd = rows["slstm_scan"]
    fwd["prefill"] = check_slstm(gen, BATCH, PROMPT, h, d, time_it=True)
    fwd["decode"] = check_slstm(gen, BATCH, 1, h, d, with_state=True, time_it=True)
    fwd["train"] = check_slstm(gen, TRAIN_BATCH, TRAIN_SEQ, h, d, time_it=True, store=True)
    fwd["ragged"] = check_slstm(gen, 2, 77, h, d, with_state=True)
    fwd["reduced"] = check_slstm(gen, 2, 40, 4, 32, with_state=True)
    bwd = rows["slstm_scan_bwd"]
    bwd["train"] = check_slstm_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, h, d, time_it=True)
    bwd["decode"] = check_slstm_bwd(gen, BATCH, 1, h, d, with_state=True, with_final=True)
    bwd["ragged"] = check_slstm_bwd(gen, 2, 77, h, d, with_state=True, with_final=True)
    bwd["reduced"] = check_slstm_bwd(gen, 2, 40, 4, 32)
    mem, nrm = (cfg.ssm_head_dim, cfg.ssm_state), (1, cfg.ssm_state)
    for tag, (bt, s) in (("serve", (BATCH, PROMPT)), ("train", (TRAIN_BATCH, TRAIN_SEQ))):
        for part, (p, n) in (("memory", mem), ("normaliser", nrm)):
            rows["ssm_scan"][f"{tag} {part}"] = check_ssm(gen, bt, s, h, p, n, torch.bfloat16,
                                                          shared_bc=False, time_it=True)
    for part, (p, n) in (("memory", mem), ("normaliser", nrm)):
        rows["ssm_scan_bwd"][part] = check_ssm_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, h, p, n,
                                                   torch.bfloat16, shared_bc=False, time_it=True)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "general_ms": 0.0}
    for m in (BATCH * PROMPT, BATCH):
        for (k, n, tr), count in xlstm_path_gemms(cfg).items():
            row = check_gemm(gen, m, k, n, torch.bfloat16, b_transposed=tr)
            rows["dos_matmul"].append(dict(row, calls_per_prefill_and_step=count))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] += count * row[key]
            if row["variant"] == "general":
                tot["general_ms"] += count * row["ms"]
    gates = check_dos_function(gen, TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, h, False,
                               variant="general")
    rows["train_gates"] = gates
    gates_ms = 2 * (n_m + n_s) * (gates["forward_ms"] + gates["dA_ms"] + gates["dB_ms"]
                                  + gates["transpose_copy_ms"])
    print(f"[xlstm] {XLSTM}'s GEMMs of one prefill plus one decode step: dos_matmul "
          f"{tot['ms']:.4f} ms (the general wi/wf products {tot['general_ms']:.4f} ms of it), "
          f"plain {tot['plain_ms']:.4f} ms, torch.matmul {tot['library_ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms; the wi/wf products of one train step (forward, dA, dB, "
          f"general) {gates_ms:.4f} ms", flush=True)
    errs = {"slstm_scan": max(r["max_abs_err"] for r in fwd.values()),
            "slstm_scan_bwd": max(r["max_abs_err"] for r in bwd.values()),
            "ssm_scan": max(r["max_abs_err"] for r in rows["ssm_scan"].values()),
            "ssm_scan_bwd": max(r["max_abs_err"] for r in rows["ssm_scan_bwd"].values()),
            "dos_matmul": max(r["max_abs_err"] for r in rows["dos_matmul"])}
    RESULTS["xlstm_kernels"] = {k: v for k, v in rows.items()}
    RESULTS["xlstm_gemm_totals"] = dict(tot, train_gates_ms=gates_ms)
    return rows, errs


def phase_train_xlstm_profile(state, step_p50_s):
    """One warm train step of the xLSTM path's model on its trained state
    and the next batch, written out as train_step's two calls so that it
    reports the f32 global gradient norm AdamW clips with; then one train
    step under torch.profiler. Both update the state in place."""
    cfg = get_config(XLSTM)
    model = build(cfg, "cuda")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS)
    step = make_train_step(model, opt_cfg)
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch = {k: torch.from_numpy(x).to("cuda") for k, x in data.batch(TRAIN_STEPS).items()}
    params, opt = state["params"], state["opt"]
    _, grads = loss_and_grads(model, params, batch, True)
    params, opt, gnorm = adamw_update(params, grads, opt, opt_cfg)
    gnorm = float(gnorm)
    del grads
    print(f"[xlstm] {XLSTM} after {TRAIN_STEPS} steps: the f32 global gradient norm AdamW clips "
          f"with is {gnorm:.6g}", flush=True)
    check(math.isfinite(gnorm), f"{XLSTM}: the gradient norm is not finite")
    RESULTS.setdefault("train_xlstm", {}).update(global_grad_norm=gnorm)
    torch.cuda.synchronize()
    RESULTS["profile"][f"train {XLSTM}"] = _profile_train_step(
        lambda: step(params, opt, batch), step_p50_s, f"{XLSTM} train step",
        {"dos_matmul": "dos_matmul", "ssm_scan mma": "ssd_mma", "ssm_scan fma": "ssd_fwd",
         "ssm_scan_bwd": "ssd_bwd", "slstm_scan": "slstm_fwd", "slstm_scan_bwd": "slstm_bwd"})


def phase_xlstm_e2e():
    """Card against CPU on the same f32 master weights: one mLSTM and one
    sLSTM block at full width in bf16 (the output, and the input's and
    parameters' gradients under a random output gradient, within 3e-2 of
    each one's max), and the full model (12 blocks) in f32 at batch 2 x
    128 (the logits, the loss and every gradient leaf of one train step
    within 1e-3)."""
    cfg = get_config(XLSTM)
    b, s = HYBRID_TRAIN_E2E_BATCH, HYBRID_TRAIN_E2E_SEQ
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, defs, block in (("mlstm_block", mlstm_defs, mlstm_block),
                              ("slstm_block", slstm_defs, slstm_block)):
        lp = materialize(defs(cfg), gen)
        x = torch.randn(b, s, cfg.d_model, generator=gen).to(torch.bfloat16)
        gy = torch.randn(b, s, cfg.d_model, generator=gen).to(torch.bfloat16)

        def run(dev):
            ins = {"x": x.to(dev).requires_grad_(),
                   "p": map_tree(lambda t: t.to(dev).requires_grad_(), lp)}
            y, _ = block(ins["p"], ins["x"], cfg, mode="train")
            torch.autograd.backward(y, gy.to(dev))
            return y.detach().float().cpu(), map_tree(lambda t: t.grad, ins)

        (yg, gg), (yc, gc) = run("cuda"), run("cpu")
        y_rel = (yg - yc).abs().max().item() / yc.abs().max().item()
        g_rel, leaf = _grad_gap(gg, gc)
        print(f"[xlstm] card vs CPU, one {name} of {XLSTM} at full width, batch {b} x {s}, bf16: "
              f"output {y_rel:.3g} of its max, worst gradient {leaf} at {g_rel:.3g} of its max|g| "
              f"(band {E2E_TOL})", flush=True)
        check(y_rel <= E2E_TOL, f"{name}: the card's output differs by {y_rel:.3g}")
        check(g_rel <= E2E_TOL, f"{name}: gradient {leaf} differs by {g_rel:.3g}")
        out[name] = {"out_rel": y_rel, "worst_grad_rel": g_rel, "worst_leaf": leaf}

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    mc, mg = build(cfg32, "cpu"), build(cfg32, "cuda")
    params_c = mc.init(torch.Generator().manual_seed(0))
    params_g = map_tree(lambda t: t.to("cuda"), params_c)
    data = SyntheticLM(DataConfig(cfg.vocab, s, b, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    with torch.no_grad():
        lc = decoder.decoder_forward(params_c, batch["tokens"], cfg32, mode="train")[0]
        lg = decoder.decoder_forward(params_g, batch["tokens"].cuda(), cfg32, mode="train")[0]
    logit_rel = (lg.cpu() - lc).abs().max().item() / lc.abs().max().item()
    t0 = time.perf_counter()
    loss_c, gc = loss_and_grads(mc, params_c, batch, True)
    cpu_s = time.perf_counter() - t0
    loss_g, gg = loss_and_grads(mg, params_g, {k: v.cuda() for k, v in batch.items()}, True)
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    worst, worst_leaf = _grad_gap(gg, gc)
    print(f"[xlstm] card vs CPU, {XLSTM} (all {cfg.n_layers} blocks), batch {b} x {s}, float32: "
          f"logits {logit_rel:.3g} of their max, loss {float(loss_g):.6f} vs {float(loss_c):.6f} "
          f"(relative {loss_rel:.3g}); worst gradient leaf {worst_leaf} at {worst:.3g} of its "
          f"max|g| (band {TRAIN_F32_TOL}); the CPU's step {cpu_s:.1f} s", flush=True)
    check(bool(torch.isfinite(lg).all()), "non-finite f32 logits on the card")
    check(logit_rel <= TRAIN_F32_TOL, f"float32: the card's logits differ by {logit_rel:.3g}")
    check(loss_rel <= TRAIN_F32_TOL, f"float32: the card's loss differs by {loss_rel:.3g}")
    check(worst <= TRAIN_F32_TOL, f"float32: gradient {worst_leaf} differs by {worst:.3g}")
    out["f32"] = {"logits_rel": logit_rel, "loss_rel": loss_rel, "worst_grad_rel": worst,
                  "worst_leaf": worst_leaf}
    RESULTS["xlstm_e2e"] = out


XLSTM_CLIS = {"train": ["repro_torch.launch.train", "--arch", XLSTM, "--steps",
                         str(XLSTM_CLI_STEPS), "--json"],
              "serve": ["repro_torch.launch.serve", "--arch", XLSTM, "--json"]}


def check_xlstm_cli(tr, sv, wall):
    """``python -m repro_torch.launch.train --arch xlstm-125m --steps 3
    --json`` and ``python -m repro_torch.launch.serve --arch xlstm-125m
    --json`` (run by ``phase_clis``; ``wall`` the longer of the two): each
    exits 0 on the card with finite losses (training) and launches exact."""
    cfg = get_config(XLSTM)
    want_tr = {k: n * XLSTM_CLI_STEPS for k, n in expected_train_launches(cfg).items()}
    check(tr["device"]["platform"] == "gpu" and len(tr["losses"]) == XLSTM_CLI_STEPS
          and all(math.isfinite(x) for x in tr["losses"]) and tr["launches"] == want_tr,
          f"the train CLI's summary is wrong: {tr['device']}, {tr['losses']}, {tr['launches']}")
    want_sv = expected_launches(cfg, sv["gen_tokens"])
    check(sv["device"]["platform"] == "gpu" and sv["launches"] == want_sv,
          f"the serve CLI's launches {sv['launches']}, expected {want_sv}")
    print(f"[xlstm] the train and serve CLIs (--arch {XLSTM}) in two subprocesses: exit 0 "
          f"within {wall:.1f} s; train {XLSTM_CLI_STEPS} steps (batch {tr['batch']} x "
          f"{tr['seq']}) loss {tr['loss_first']:.4f} -> {tr['loss_last']:.4f}, step p50 "
          f"{tr['step_p50_s']*1e3:.3f} ms, launches {tr['launches']}; serve batch {sv['batch']} "
          f"prompt {sv['prompt_len']} gen {sv['gen_tokens']}: prefill {sv['prefill_s']*1e3:.2f} "
          f"ms, decode {sv['decode_tok_s']:.1f} tok/s, launches {sv['launches']}", flush=True)
    RESULTS["xlstm_cli"] = {"train": {k: tr[k] for k in ("losses", "step_p50_s", "launches")},
                            "serve": {k: sv[k] for k in ("prefill_s", "decode_tok_s",
                                                         "launches")}, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 15: MoE (deepseek-moe-16b) serving and training on the card
# ---------------------------------------------------------------------------

# grouped_matmul against its plain version on the f32 result of the same
# operands (phase 4's GEMM gate): f32 within 1e-5 of the largest entry
# (sums in another order); a bf16 output one bf16 rounding (2**-8) of each
# entry more. grouped_matmul_dw's output is f32 whatever its operands:
# 1e-5 of the largest entry.
GMM_TOL = 1e-5
# the training path: full width, depth cut to 4 layers (f32 masters,
# gradients and AdamW moments: 16 bytes a parameter, ~44 GB at 4 layers,
# 270 GB at 28)
MOE_TRAIN_LAYERS = 4
# card against CPU: one attention+MoE layer in bf16, each sub-block fed the
# CPU's input (the bf16 band, E2E_TOL); the model in f32 at 2 layers,
# batch 2 x 128. f32 band: each GEMM differs between the devices by ~1e-6
# of its scale (summation order), two layers ~1e-5; a flipped route moves
# a token's output by the order of its scale, and shows in the routing
# agreement printed beside it.
MOE_E2E_LAYERS, MOE_E2E_BATCH, MOE_F32_TOL = 2, 2, 1e-3
# the restart check: one layer at deepseek's expert shapes (2,048 x 1,408,
# top-6, the 2 shared experts, wgmma forward and dW), 6 steps, a checkpoint
# every 3, a fault at step 4. A checkpoint holds params, m and v in f32:
# 12 GB with all 64 experts and the 102,400-row vocabulary (59-81 s of the
# script's 1,200), 1.4 GB with 8 experts and 4,096 rows (16 and 8,192:
# 2.5 GB, 29 s against the whole layer's 81 s in one run).
MOE_RESTART_LAYERS, MOE_RESTART_STEPS, MOE_RESTART_EVERY, MOE_RESTART_FAULT = 1, 6, 3, 4
MOE_RESTART_EXPERTS, MOE_RESTART_VOCAB = 8, 4096
MOE_CLI_LAYERS, MOE_CLI_STEPS = 1, 3


def gmm_variant(cfg, tokens: int) -> str:
    """The variant ``plan`` gives an expert product of ``tokens`` tokens
    (each routed to top_k experts) in bf16 with TMA-describable operands."""
    return gmm_ops.plan(tokens * cfg.top_k, cfg.n_experts, torch.bfloat16, True).variant


def moe_serve_variants(cfg, gen_tokens: int = GEN) -> dict:
    """An MoE serve run's launches by kernel and variant, prefill and
    decode together: the bf16 projections ``wgmma`` in prefill and
    ``skinny`` in decode (M = batch), the router's f32 product ``f32``,
    the expert products as ``plan`` picks them (``wgmma``), every prefill
    attention ``mma``, every decode attention ``split``."""
    n, per = cfg.n_layers, moe_layer_gemms(cfg)
    out = {k: dict.fromkeys(fn.variants, 0) for k, fn in KERNELS.items()}
    out["dos_matmul"].update(wgmma=(per - 1) * n + 1, skinny=((per - 1) * n + 1) * (gen_tokens - 1),
                             f32=n * gen_tokens)
    gmm = out["grouped_matmul"]
    gmm[gmm_variant(cfg, BATCH * PROMPT)] += 3 * n
    gmm[gmm_variant(cfg, BATCH)] += 3 * n * (gen_tokens - 1)
    out["flash_attention"]["mma"] = n
    out["decode_attention"]["split"] = n * (gen_tokens - 1)
    return out


def moe_layer_gemms(cfg) -> int:
    """dos_matmul calls of one MoE layer: q k v o, the router and, with
    shared experts, their gate, up and down projections."""
    return 5 + (3 if cfg.n_shared_experts else 0)


def moe_train_variants(cfg) -> dict:
    """An MoE train step's launches by kernel and variant (remat): the
    router's f32 products (forward, recompute, dA, dB; the load-balance
    term's once and its dA, dB) ``f32``, every other GEMM ``wgmma``; the
    expert products (forward, recompute, dX) as ``plan`` picks them
    (``wgmma``) and their dW as ``dw_plan`` does (``wgmma``); attention
    ``mma``."""
    n = cfg.n_layers
    out = {k: dict.fromkeys(fn.variants, 0) for k, fn in KERNELS.items()}
    total = expected_train_launches(cfg)
    f32 = (n + 1) + n + 2 * (n + 1)
    out["dos_matmul"].update(f32=f32, wgmma=total["dos_matmul"] - f32)
    out["grouped_matmul"][gmm_variant(cfg, TRAIN_BATCH * TRAIN_SEQ)] = total["grouped_matmul"]
    out["grouped_matmul_dw"][gmm_ops.dw_plan(torch.bfloat16, True, cfg.n_experts)] = (
        total["grouped_matmul_dw"])
    for k in ("flash_attention", "flash_attention_bwd"):
        out[k]["mma"] = total[k]
    out["adamw"] = adamw_variants(cfg)
    return out


def moe_routes(gen, cfg, tokens):
    """Group sizes (experts, int32, on the card) of ``tokens`` tokens
    routed as ``moe_block`` routes them: random activations through a
    random f32 router, top-k, sorted by expert."""
    x = torch.randn(tokens, cfg.d_model, generator=gen, device="cuda")
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=gen, device="cuda")
    _, top_i = moe.route({"router": router / cfg.d_model**0.5}, x, cfg.top_k)
    expert = top_i.reshape(-1).sort(stable=True).values
    bounds = torch.searchsorted(expert, torch.arange(cfg.n_experts + 1, device="cuda"))
    return bounds.diff().to(torch.int32)


def _library_ms(call, what):
    """``cuda_ms`` of ``torch._grouped_mm``, the one PyTorch call that
    computes a grouped GEMM, where this torch has it and it takes the
    inputs; else None, with the reason printed."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    try:
        call(0)
        return cuda_ms(call, 2)
    except (RuntimeError, TypeError, ValueError) as e:
        print(f"[moe] {what}: torch._grouped_mm does not take these inputs: {str(e)[:160]}")
        return None


def _gmm_variants(dtype, k, n) -> list[str]:
    """The variants that forced launches can take on these operands (the
    checks' operands are contiguous: bf16 rows on 16 bytes iff K and N are
    multiples of 8)."""
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        return list(gmm_ops.VARIANTS)
    return ["fma"]


def _count_one(fn, variant, call, what):
    """``call()``, checked to add one launch of ``variant`` to ``fn``."""
    before = dict(fn.variants)
    out = call()
    check(fn.variants == dict(before, **{variant: before[variant] + 1}),
          f"{what}: variants {fn.variants}, one more {variant} expected")
    return out


def check_gmm(gen, rows, k, n, sizes, dtype=torch.bfloat16, transposed=False, time_it=False,
              what=""):
    """``grouped_matmul`` on x (rows, k) and w (G, k, n), row-major or the
    transposed view of a (G, n, k) weight: the variant ``plan`` picks and
    every other variant the operands allow, forced on the same inputs,
    each against ``grouped_matmul_ref`` on the f32 result of the same
    operands at GMM_TOL (plus one bf16 rounding of each entry for bf16),
    rows past the sum zero, two calls bit-identical. Timed: the planned
    variant (inputs rotated over two sets), the plain version (host clock:
    it reads the sizes on the host), torch._grouped_mm where it takes the
    inputs, bound."""
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device="cuda")
    g = len(sizes)

    def operands():
        x = torch.randn(rows, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(g, n, k, generator=gen, device="cuda") / k**0.5).to(dtype)
        return x, (w.transpose(-1, -2) if transposed else w.reshape(g, k, n))

    x, w = operands()
    variants = _gmm_variants(dtype, k, n)
    want_v = gmm_ops.plan(rows, g, dtype, variants[0] == "wgmma").variant
    exact = grouped_matmul_ref(x.float(), w.float(), sizes)
    tol = GMM_TOL * exact.abs().max() + (2.0**-8 * exact.abs() if dtype == torch.bfloat16 else 0)
    used = int(sizes.sum())
    errs = {}
    for variant in [None] + variants:
        name = variant or f"planned {want_v}"
        call = ((lambda: grouped_matmul(x, w, sizes)) if variant is None else
                (lambda: gmm_ops._launch_forward(x, w, sizes, force=variant)))
        out = _count_one(grouped_matmul, variant or want_v, call, f"grouped_matmul {what} ({name})")
        err = (out.float() - exact).abs()
        errs[variant or want_v] = err.max().item()
        check(bool((err <= tol).all()), f"grouped_matmul {what} ({name}): off the gate by "
              f"{(err - tol).max().item():.3g}")
        check(not out[used:].any(), f"grouped_matmul {what} ({name}): a row past the sum is not "
              "zero")
        check(torch.equal(out, call()), f"grouped_matmul {what} ({name}): two calls differ")
    es = torch.finfo(dtype).bits // 8
    n_bytes, n_ops = gmm_ops.work(rows, k, n, sizes.cpu(), es)[:2]
    row = {"what": what, "rows": rows, "K": k, "N": n, "G": g,
           "active": int((sizes > 0).sum()), "dtype": str(dtype), "transposed": transposed,
           "variant": want_v, "max_abs_err": max(errs.values()), "max_abs_err_by_variant": errs,
           "bytes": n_bytes, "ops": n_ops}
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, dtype)
    if time_it:
        sets = [(x, w), operands()]
        row["ms"] = cuda_ms(lambda i: grouped_matmul(sets[i][0], sets[i][1], sizes), 2)
        row["plain_ms"] = _host_ms(lambda: grouped_matmul_ref(x, w, sizes))
        offs = sizes.cumsum(0).to(torch.int32)
        row["library_ms"] = _library_ms(
            lambda i: torch._grouped_mm(sets[i][0], sets[i][1], offs=offs), what)
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        print(f"[moe] grouped_matmul {what}: ({rows}, {k}) x ({g}, {k}, {n}){' w^T' * transposed}"
              f", {row['active']} groups non-empty, planned {want_v}: {row['ms']:.4f} ms"
              f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
              f"{row['plain_ms']:.3f} ms, torch._grouped_mm {lib}; max|err| by variant "
              + ", ".join(f"{v} {e:.3g}" for v, e in errs.items()), flush=True)
    return row


def check_gmm_dw(gen, rows, k, n, sizes, dtype=torch.bfloat16, time_it=False, what=""):
    """``grouped_matmul_dw``: the variant ``dw_plan`` picks and every other
    variant the operands allow, forced on the same inputs, each against
    ``grouped_matmul_dw_ref`` within GMM_TOL of the largest entry; empty
    groups zero; two calls of each bit-identical; each variant's bf16
    output the f32 one cast, bit for bit. Timed like ``check_gmm`` with
    the bf16 output the training path asks for (beside ``wgmma`` with an
    f32 output); torch._grouped_mm's 2-D x 2-D form (offsets along the
    rows, output in the operands' type) is the PyTorch call. The bound
    counts a bf16 dW."""
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device="cuda")
    x = torch.randn(rows, k, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
    exact = grouped_matmul_dw_ref(x, dy, sizes)
    scale = exact.abs().max().item()
    variants = _gmm_variants(dtype, k, n)
    want_v = gmm_ops.dw_plan(dtype, variants[0] == "wgmma", len(sizes))
    errs = {}
    for variant in [None] + variants:
        name = variant or f"planned {want_v}"
        call = ((lambda: grouped_matmul_dw(x, dy, sizes)) if variant is None else
                (lambda: gmm_ops._launch_dw(x, dy, sizes, force=variant)))
        dw = _count_one(grouped_matmul_dw, variant or want_v, call,
                        f"grouped_matmul_dw {what} ({name})")
        errs[variant or want_v] = (dw - exact).abs().max().item()
        check(errs[variant or want_v] <= GMM_TOL * scale, f"grouped_matmul_dw {what} ({name}): "
              f"{errs[variant or want_v] / scale:.3g} of the largest entry")
        check(all(not dw[i].any() for i in range(len(sizes)) if int(sizes[i]) == 0),
              f"grouped_matmul_dw {what} ({name}): an empty group's gradient is not zero")
        check(torch.equal(dw, call()), f"grouped_matmul_dw {what} ({name}): two calls differ")
        if variant:
            low = gmm_ops._launch_dw(x, dy, sizes, force=variant, out_dtype=torch.bfloat16)
            check(torch.equal(low, dw.to(torch.bfloat16)), f"grouped_matmul_dw {what} ({name}): "
                  "the bf16 output is not the f32 one cast")
    es = torch.finfo(dtype).bits // 8
    n_bytes, n_ops = gmm_ops.dw_work(rows, k, n, sizes.cpu(), es, es)[:2]
    row = {"what": what, "rows": rows, "K": k, "N": n, "G": len(sizes), "dtype": str(dtype),
           "variant": want_v, "max_abs_err": max(errs.values()), "max_abs_err_by_variant": errs,
           "bytes": n_bytes, "ops": n_ops}
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, dtype)
    if time_it:
        sets = [(x, dy), (torch.randn_like(x), torch.randn_like(dy))]
        row["ms"] = cuda_ms(lambda i: grouped_matmul_dw(sets[i][0], sets[i][1], sizes, dtype), 2)
        row["wgmma_f32_ms"] = cuda_ms(lambda i: gmm_ops._launch_dw(
            sets[i][0], sets[i][1], sizes, force="wgmma"), 2)
        row["plain_ms"] = _host_ms(lambda: grouped_matmul_dw_ref(x, dy, sizes, dtype))
        offs = sizes.cumsum(0).to(torch.int32)
        # its output in the operands' type: the one it takes
        row["library_ms"] = _library_ms(
            lambda i: torch._grouped_mm(sets[i][0].T, sets[i][1], offs=offs), what)
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        print(f"[moe] grouped_matmul_dw {what}: ({rows}, {k})^T x ({rows}, {n}) over "
              f"{len(sizes)} groups, {dtype} out, planned {want_v}: {row['ms']:.4f} ms (wgmma "
              f"f32 out {row['wgmma_f32_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain "
              f"{row['plain_ms']:.3f} ms, torch._grouped_mm {lib}; max|err| by variant "
              + ", ".join(f"{v} {e:.3g}" for v, e in errs.items()), flush=True)
    return row


def check_moe_decode_no_sync(gen):
    """One decode call of ``moe_block`` at deepseek-moe-16b's full width
    (4 tokens, weights drawn on the card) under
    ``torch.cuda.set_sync_debug_mode("error")``: a device-to-host sync
    raises."""
    cfg = get_config(MOE)
    p = materialize_cast(moe.moe_defs(cfg), torch.Generator(device="cuda").manual_seed(15),
                         torch.float32, torch.bfloat16, "cuda")
    x = torch.randn(BATCH, 1, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        moe.moe_block(p, x, cfg)  # warm: the first call loads the kernels
        torch.cuda.synchronize()
        before = grouped_matmul.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = moe.moe_block(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    check(grouped_matmul.launches == before + 3, "moe_block's decode call launched "
          f"{grouped_matmul.launches - before} grouped GEMMs, 3 expected")
    check(bool(torch.isfinite(y.float()).all()), "moe_block's decode output is not finite")
    print(f"[moe] moe_block decode call ({BATCH} tokens, full width) under "
          "set_sync_debug_mode('error'): no device-to-host sync", flush=True)


def phase_moe_kernels():
    """Phase 15's kernel checks (``check_gmm``, ``check_gmm_dw``): the
    expert products at deepseek-moe-16b's prefill, decode and training
    shapes with routes from a real router (timed), the training backward's
    dX on the weights' transposed views (timed), both of llama4-scout's
    expert shapes (16 groups, 5,120 x 8,192 and back; timed), edge cases
    (empty groups, one group holding every row, rows past the sum, ragged
    K and N, rows off 16 bytes, the f32 variant, both layouts), the weight
    gradient at the training shape (timed) and at edge shapes, and the
    decode call of ``moe_block`` without a sync. Returns the rows and the
    largest error by kernel."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    cfg, scout = get_config(MOE), get_config(SCOUT)
    e, f, k = cfg.d_model, cfg.expert_d_ff, cfg.top_k
    fw, dw = {}, {}
    routes = {tag: moe_routes(gen, cfg, tokens) for tag, tokens in
              (("prefill", BATCH * PROMPT), ("decode", BATCH), ("train", TRAIN_BATCH * TRAIN_SEQ))}
    for tag, sizes in routes.items():
        r = int(sizes.sum())
        fw[f"{tag} gate/up"] = check_gmm(gen, r, e, f, sizes, time_it=True,
                                         what=f"{MOE} {tag} gate/up")
        fw[f"{tag} down"] = check_gmm(gen, r, f, e, sizes, time_it=True, what=f"{MOE} {tag} down")
    rt = int(routes["train"].sum())
    fw["train dX of gate/up"] = check_gmm(gen, rt, f, e, routes["train"], transposed=True,
                                          time_it=True, what=f"{MOE} train dX of gate/up")
    fw["train dX of down"] = check_gmm(gen, rt, e, f, routes["train"], transposed=True,
                                       time_it=True, what=f"{MOE} train dX of down")
    s_sizes = moe_routes(gen, scout, BATCH * PROMPT)
    se, sf = scout.d_model, scout.expert_d_ff
    fw["scout up"] = check_gmm(gen, BATCH * PROMPT, se, sf, s_sizes, time_it=True,
                               what=f"{SCOUT} prefill gate/up")
    fw["scout down"] = check_gmm(gen, BATCH * PROMPT, sf, se, s_sizes, time_it=True,
                                 what=f"{SCOUT} prefill down")
    edges = {"empty groups": (96, 256, 136, [0, 40, 0, 0, 56, 0]),
             "one group holds every row": (300, 200, 136, [0, 300, 0]),
             "rows past the sum": (130, 96, 72, [17, 0, 40, 3]),
             "ragged K and N": (257, 1000, 520, [64, 1, 0, 100, 92]),
             "rows off 16 bytes": (77, 1001, 515, [30, 0, 47])}
    for name, (rows, kk, nn, sizes) in edges.items():
        for dtype in (torch.bfloat16, torch.float32):
            for tr in (False, True):
                fw[f"{name} {dtype} {'w^T' if tr else 'w'}"] = check_gmm(
                    gen, rows, kk, nn, sizes, dtype, tr, what=f"{name}, {dtype}")
        dw[f"{name} bf16"] = check_gmm_dw(gen, rows, kk, nn, sizes, what=name)
        dw[f"{name} f32"] = check_gmm_dw(gen, rows, kk, nn, sizes, torch.float32, what=name)
    dw["train gate/up"] = check_gmm_dw(gen, rt, e, f, routes["train"], time_it=True,
                                       what=f"{MOE} train gate/up")
    dw["train down"] = check_gmm_dw(gen, rt, f, e, routes["train"], time_it=True,
                                    what=f"{MOE} train down")
    check_moe_decode_no_sync(gen)
    rows = {"grouped_matmul": fw, "grouped_matmul_dw": dw}
    RESULTS["moe_kernels"] = rows
    return rows, {kname: max(r["max_abs_err"] for r in rs.values()) for kname, rs in rows.items()}


class _RecordRoutes:
    """Inside the ``with``, every ``moe.route`` call (``moe_block``'s and
    ``moe_block_ep``'s) records its top-k indices and the k-th to (k+1)-th
    probability gap of each token, by the device it ran on (the extra
    router product is outside every count)."""

    def __init__(self):
        self.calls = {"cuda": [], "cpu": []}

    def __enter__(self):
        self._route = moe.route

        def route(p, xt, k, *lay):
            top_p, top_i = self._route(p, xt, k, *lay)
            probs = torch.softmax(layers.proj(xt.float(), p["router"].float()), dim=-1)
            srt = probs.sort(dim=-1, descending=True).values
            self.calls[xt.device.type].append((top_i.cpu(), (srt[:, k - 1] - srt[:, k]).cpu()))
            return top_p, top_i

        moe.route = moe_ep.route = route
        return self

    def __exit__(self, *exc):
        moe.route = moe_ep.route = self._route

    def agreement(self) -> dict:
        """Tokens whose top-k experts agree between the card's calls and
        the CPU's, and the smallest gap the CPU saw."""
        card, cpu = self.calls["cuda"], self.calls["cpu"]
        check(len(card) == len(cpu) > 0, "the card and the CPU routed different calls")
        rows = sum(ic.shape[0] for ic, _ in cpu)
        same = sum(int((ig == ic).all(dim=-1).sum()) for (ig, _), (ic, _) in zip(card, cpu))
        return {"rows": rows, "agree": same, "smallest_gap": min(g.min().item() for _, g in cpu)}


def phase_moe_e2e():
    """Card against CPU on the same weights and inputs (the CPU's plain
    versions): one attention+MoE layer of deepseek-moe-16b at full width
    in bf16, the attention and the MoE sub-blocks each fed the CPU's
    input, within the bf16 band of the output's max; and the full-width
    model cut to 2 layers in f32 at batch 2 x 128, prefill and 4 decode
    steps, within MOE_F32_TOL. Prints the routing agreement of each."""
    cfg = dataclasses.replace(get_config(MOE), n_layers=1)
    lp_c = materialize_cast(decoder._block_defs(cfg), torch.Generator().manual_seed(0),
                            torch.float32, torch.bfloat16, "cpu")
    lp_g = map_tree(lambda t: t.to("cuda"), lp_c)
    x = torch.randn(MOE_E2E_BATCH, PROMPT, cfg.d_model, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    wins, thetas = decoder.layer_metadata(cfg)
    kw = dict(mode="prefill", window=wins[0], theta=thetas[0])
    with torch.no_grad(), _RecordRoutes() as rec:
        h_c = layers.attention(lp_c["attn"], layers.rmsnorm(x, lp_c["ln1"], cfg.norm_eps), cfg,
                               **kw)[0]
        h_g = layers.attention(lp_g["attn"], layers.rmsnorm(x.cuda(), lp_g["ln1"], cfg.norm_eps),
                               cfg, **kw)[0]
        y_in = layers.rmsnorm(x + h_c, lp_c["ln2"], cfg.norm_eps)
        m_c = moe.moe_block(lp_c["ffn"], y_in, cfg)
        m_g = moe.moe_block(lp_g["ffn"], y_in.cuda(), cfg)
    gaps = {what: (got.float().cpu() - ref.float()).abs().max().item()
            / ref.float().abs().max().item()
            for what, got, ref in (("attention", h_g, h_c), ("moe", m_g, m_c))}
    agree = rec.agreement()
    print(f"[moe] card vs CPU, one layer of {MOE} at full width in bf16, batch {MOE_E2E_BATCH} x "
          f"{PROMPT}, each sub-block fed the CPU's input: attention {gaps['attention']:.3g}, MoE "
          f"{gaps['moe']:.3g} of the output's max (band {E2E_TOL}); routes agree on "
          f"{agree['agree']} of {agree['rows']} tokens (smallest k-th to (k+1)-th probability "
          f"gap {agree['smallest_gap']:.3g})", flush=True)
    for what, gap in gaps.items():
        check(gap <= E2E_TOL, f"{MOE} bf16 {what} block: card and CPU differ by {gap:.3g}")
    del lp_c, lp_g
    with _RecordRoutes() as rec:
        timed(phase_e2e, MOE, "float32", MOE_F32_TOL)
    agree_f32 = rec.agreement()
    print(f"[moe] {MOE} ({MOE_E2E_LAYERS} layers) f32 end to end: routes agree on "
          f"{agree_f32['agree']} of {agree_f32['rows']} (token, layer) pairs of the prefill and "
          f"{E2E_DECODE_STEPS} decode steps (smallest k-th to (k+1)-th probability gap "
          f"{agree_f32['smallest_gap']:.3g})", flush=True)
    RESULTS["moe_e2e"] = {"bf16_block_rel": gaps, "bf16_routes": agree, "f32_routes": agree_f32}
def phase_train_moe_profile(state, step_p50_s):
    """One train step of phase 15's training path (its trained state, the
    next batch) under torch.profiler: device busy time, the idle share
    against the path's step p50, device time by kernel and by plain op.
    The step updates the state in place."""
    cfg = dataclasses.replace(get_config(MOE), n_layers=MOE_TRAIN_LAYERS)
    model = build(cfg, "cuda")
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS),
                           remat=True)
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch = {k: torch.from_numpy(x).to("cuda") for k, x in data.batch(TRAIN_STEPS).items()}
    RESULTS["profile"][f"train {MOE}"] = _profile_train_step(
        lambda: step(state["params"], state["opt"], batch), step_p50_s,
        f"{MOE} ({MOE_TRAIN_LAYERS} layers) train step",
        {"dos_matmul": "dos_matmul", "flash_attention": "flash_mma",
         "flash_attention_bwd": "flash_bwd", "grouped_matmul": "gmm_fwd",
         "grouped_matmul_dw": "gmm_dw"})


def phase_moe_train_e2e():
    """Card against CPU on the same f32 master weights: one ``moe_block``
    at full width in bf16, batch 2 x 128 (its input's and parameters'
    gradients under a random output gradient, within E2E_TOL of each
    leaf's max|g|: the ``mma`` dX on the weights' transposed views, the
    ``mma`` dW and the dispatch's backward, as training runs them); and
    one train step's loss (the load-balance term included) and every
    gradient leaf at full width with one layer, batch 2 x 128, in f32
    within TRAIN_F32_TOL of each leaf's max|g|. The routing agreement of
    each printed."""
    cfg = get_config(MOE)
    gen = torch.Generator().manual_seed(0)
    lp = materialize(moe.moe_defs(cfg), gen)
    x = torch.randn(MOE_E2E_BATCH, PROMPT, cfg.d_model, generator=gen).to(torch.bfloat16)
    gy = torch.randn(MOE_E2E_BATCH, PROMPT, cfg.d_model, generator=gen).to(torch.bfloat16)

    def block_grads(dev):
        ins = {"x": x.to(dev).requires_grad_(),
               "p": map_tree(lambda t: t.to(dev).requires_grad_(), lp)}
        torch.autograd.backward(moe.moe_block(ins["p"], ins["x"], cfg), gy.to(dev))
        return map_tree(lambda t: t.grad, ins)

    fv = gmm_variant(cfg, MOE_E2E_BATCH * PROMPT)
    dv = gmm_ops.dw_plan(torch.bfloat16, True, cfg.n_experts)
    with _RecordRoutes() as rec:
        before = (grouped_matmul.variants[fv], grouped_matmul_dw.variants[dv])
        block_g = block_grads("cuda")
        block_c = block_grads("cpu")
    after = (grouped_matmul.variants[fv], grouped_matmul_dw.variants[dv])
    check(after == (before[0] + 6, before[1] + 3), "moe_block's bf16 backward launched "
          f"{after[0] - before[0]} {fv} grouped GEMMs and {after[1] - before[1]} {dv} dW, 6 and "
          "3 expected")
    block_rel, block_leaf = _grad_gap(block_g, block_c)
    block_agree = rec.agreement()
    del block_g, block_c, lp
    print(f"[moe] train, card vs CPU, one moe_block of {MOE} at full width, batch "
          f"{MOE_E2E_BATCH} x {PROMPT}, bf16: worst gradient (input and parameters) {block_leaf} "
          f"at {block_rel:.3g} of its max|g| (band {E2E_TOL}); routes agree on "
          f"{block_agree['agree']} of {block_agree['rows']} tokens (smallest gap "
          f"{block_agree['smallest_gap']:.3g})", flush=True)
    check(block_rel <= E2E_TOL, f"moe_block gradient {block_leaf} differs by {block_rel:.3g}")

    cfg = dataclasses.replace(cfg, n_layers=1, compute_dtype="float32")
    mc, mg = build(cfg, "cpu"), build(cfg, "cuda")
    params_c = mc.init(torch.Generator().manual_seed(0))
    params_g = map_tree(lambda t: t.to("cuda"), params_c)
    data = SyntheticLM(DataConfig(cfg.vocab, PROMPT, MOE_E2E_BATCH, seed=0))
    batch = {k: torch.from_numpy(x) for k, x in data.batch(0).items()}
    with _RecordRoutes() as rec:
        lc, gc = loss_and_grads(mc, params_c, batch, True)
        lg, gg = loss_and_grads(mg, params_g, {k: x.cuda() for k, x in batch.items()}, True)
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    worst, worst_leaf = _grad_gap(gg, gc)
    agree = rec.agreement()
    print(f"[moe] train, card vs CPU, {MOE} 1 layer at full width, batch {MOE_E2E_BATCH} x "
          f"{PROMPT}, f32: loss {float(lg):.6f} vs {float(lc):.6f} (relative {loss_rel:.3g}); "
          f"worst gradient leaf {worst_leaf} at {worst:.3g} of its max|g| (band "
          f"{TRAIN_F32_TOL}); routes agree on {agree['agree']} of {agree['rows']} tokens "
          f"(smallest gap {agree['smallest_gap']:.3g})", flush=True)
    check(loss_rel <= TRAIN_F32_TOL,
          f"the card's MoE loss differs from the CPU's by {loss_rel:.3g}")
    check(worst <= TRAIN_F32_TOL, f"MoE gradient {worst_leaf} differs by {worst:.3g} of its scale")
    RESULTS["moe_train_e2e"] = {"block_bf16_worst_grad_rel": block_rel,
                                "block_bf16_worst_leaf": block_leaf,
                                "block_bf16_routes": block_agree, "loss_rel": loss_rel,
                                "worst_grad_rel": worst, "worst_leaf": worst_leaf,
                                "routes": agree}


def phase_moe_restart():
    """``train_loop`` on deepseek-moe-16b at full width and one layer, cut
    to MOE_RESTART_EXPERTS experts and a MOE_RESTART_VOCAB-row vocabulary,
    with a checkpoint every MOE_RESTART_EVERY steps and a fault at
    MOE_RESTART_FAULT: the loop resumes from the last checkpoint and its
    losses repeat an uninterrupted run's bit for bit (the grouped GEMM's
    dW and the dispatch's backward use no atomics); every expert product
    and dW of both runs ``wgmma``."""
    import shutil
    import tempfile

    cfg = dataclasses.replace(get_config(MOE), n_layers=MOE_RESTART_LAYERS,
                              n_experts=MOE_RESTART_EXPERTS, vocab=MOE_RESTART_VOCAB)
    kw = dict(steps=MOE_RESTART_STEPS, global_batch=MOE_E2E_BATCH, seq_len=PROMPT, log_every=0,
              device="cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_ckpt_")
    resume = MOE_RESTART_FAULT // MOE_RESTART_EVERY * MOE_RESTART_EVERY
    reset_launch_counts()
    try:
        inj = FaultInjector(fail_at_steps=(MOE_RESTART_FAULT,))
        t0 = time.perf_counter()
        _, losses, _ = train_loop(cfg, ckpt_dir=tmp, ckpt_every=MOE_RESTART_EVERY,
                                  fault_injector=inj, **kw)
        wall = time.perf_counter() - t0
        _, clean, _ = train_loop(cfg, **kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = losses == clean[:MOE_RESTART_FAULT] + clean[resume:]
    variants = {k: dict(KERNELS[k].variants) for k in ("grouped_matmul", "grouped_matmul_dw")}
    print(f"[moe] restart, {MOE} {MOE_RESTART_LAYERS} layer at full width, "
          f"{MOE_RESTART_EXPERTS} experts (top-{cfg.top_k}, {cfg.n_shared_experts} shared), "
          f"vocab {MOE_RESTART_VOCAB}: expert products by variant {variants}; fault at step "
          f"{MOE_RESTART_FAULT} fired {MOE_RESTART_FAULT in inj.fired}; resumed from step {resume} "
          f"in {wall:.2f} s with checkpoints; every loss equals an uninterrupted run's bit for "
          f"bit: {same} ({losses} vs {clean})", flush=True)
    check(MOE_RESTART_FAULT in inj.fired, "the injected fault did not fire")
    check(same, f"the resumed MoE losses {losses} differ from an uninterrupted run's {clean}")
    check(all(v["wgmma"] == sum(v.values()) > 0 for v in variants.values()),
          f"an expert product of the restart check left wgmma: {variants}")
    RESULTS["moe_restart"] = {"losses": losses, "clean": clean, "bit_identical": same,
                              "wall_s": wall, "variants": variants}


MOE_CLI = ["repro_torch.launch.train", "--arch", MOE, "--layers", str(MOE_CLI_LAYERS), "--steps",
           str(MOE_CLI_STEPS), "--batch", str(MOE_E2E_BATCH), "--seq", str(PROMPT), "--json"]


def check_moe_cli(out, wall):
    """``python -m repro_torch.launch.train --arch deepseek-moe-16b --layers
    1 --steps 3 --json`` (run by ``phase_clis``): exit 0 on the card,
    finite losses, the launches per step exact."""
    cfg = dataclasses.replace(get_config(MOE), n_layers=MOE_CLI_LAYERS)
    want = {k: n * MOE_CLI_STEPS for k, n in expected_train_launches(cfg).items()}
    check(out["device"]["platform"] == "gpu" and len(out["losses"]) == MOE_CLI_STEPS
          and all(math.isfinite(x) for x in out["losses"]) and out["launches"] == want,
          f"the MoE train CLI's summary is wrong: {out['device']}, {out['losses']}, "
          f"{out['launches']} (expected {want})")
    print(f"[moe] python -m {' '.join(MOE_CLI)}: exit 0 in {wall:.1f} s; loss "
          f"{out['loss_first']:.4f} -> {out['loss_last']:.4f}, step p50 "
          f"{out['step_p50_s']*1e3:.3f} ms, launches {out['launches']}", flush=True)
    RESULTS["moe_cli"] = {k: out[k] for k in ("losses", "step_p50_s", "launches", "wall_s")}


# ---------------------------------------------------------------------------
# phase 16: vision cross-attention (llama-3.2-vision-11b) and the
# encoder-decoder (whisper-medium), serving and training on the card
# ---------------------------------------------------------------------------

# The cross layers' gate starts at 0 and scales their output by
# tanh(gate): at init no cross-attention result reaches the logits, and a
# broken cross path would pass. Every card-vs-CPU check sets the gates to
# VLM_GATE on both devices.
VLM_GATE = 0.5
# the vision training path: full width cut to one group (4 self-attention
# layers and the cross layer; 2.14 B parameters, 16 bytes each with the
# gradients and AdamW's moments: ~34 GB, ~156 GB at full depth). Its
# learning rate: at the other paths' 1e-3 its loss does not fall in 30
# steps, and neither does that of a dense model of its width (4 layers at
# d_model 4,096, vocab 128,256), with image embeddings drawn per step or
# fixed; at 3e-4 both fall (tools/vlm_lr_probe.py). Whisper keeps 1e-3.
VLM_TRAIN_LAYERS, VLM_TRAIN_LR = 5, 3e-4
# card against CPU in serving: full width, depth cut where the CPU would
# dominate (the vision model to one group, whisper to 4 + 4 layers), batch
# 2. The f32 band: each block differs between the devices by ~1e-6 of its
# scale (sums in another order); a wrong mask, cache or gate moves the
# logits by the order of their scale.
CROSS_E2E_DEPTH = {"vlm": {"n_layers": 5}, "encdec": {"n_enc_layers": 4, "n_layers": 4}}
CROSS_E2E_BATCH, CROSS_F32_TOL = 2, 1e-3
# card against CPU in training: one layer of each kind at full width, 2 x 64
# tokens (the vision model's untied 4,096 x 128,256 head takes most of the
# CPU's time)
CROSS_TRAIN_E2E_SEQ = 64
# the flash kernels at the shapes these paths give them, all non-causal:
# (what, batch, Sq, Skv, H, KVH, D)
CROSS_ATTN = (("vision cross", BATCH, PROMPT, 1600, 32, 8, 128),
              ("whisper encoder", BATCH, 1500, 1500, 16, 16, 64),
              ("whisper cross", BATCH, PROMPT, 1500, 16, 16, 64))


def cross_train_cfg(arch):
    """Phase 16's training config: the vision model cut to one group,
    whisper whole."""
    cfg = get_config(arch)
    return cut_depth(cfg, VLM_TRAIN_LAYERS) if cfg.family == "vlm" else cfg


def cross_opt_cfg(cfg) -> OptConfig:
    """AdamW as the earlier training paths run it (20 warmup steps of 30),
    at VLM_TRAIN_LR for the vision model and 1e-3 for whisper."""
    return OptConfig(lr=VLM_TRAIN_LR if cfg.family == "vlm" else 1e-3, warmup_steps=20,
                     total_steps=TRAIN_STEPS)


def train_inputs(cfg, batch: int, seed: int) -> dict:
    """A train batch's image embeddings or encoder frames: standard normals
    drawn on the card from ``seed`` in the compute dtype (as serving draws
    them on the host; 8 x 1,600 x 4,096 values a step would cost the host
    ~0.4 s)."""
    name, length = MODEL_INPUTS[cfg.family]
    x = torch.randn(batch, getattr(cfg, length), cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    return {name: x.to(getattr(torch, cfg.compute_dtype))}


def cross_train_launches(cfg) -> dict:
    """Launches of one train step with remat on the vision or whisper
    path: each projection's GEMM in the forward, again in a checkpointed
    layer's recompute (the vision self-attention layers; each whisper
    decoder layer with its cross k and v; not the vision cross layers, the
    encoder or the unembedding: the reference checkpoints the same), its
    dB, and its dA unless A needs no gradient (a vision cross layer's k
    and v read the image embeddings); a flash forward per attention, again
    in a recompute, and one flash backward per attention; AdamW's two
    launches a leaf."""
    out = dict.fromkeys(KERNELS, 0)
    if cfg.family == "vlm":
        n_groups, n_self = decoder._vlm_groups(cfg)
        n = n_groups * n_self
        fwd = 7 * n + 7 * n_groups + 1
        out.update(dos_matmul=fwd + 7 * n + fwd + fwd - 2 * n_groups,
                   flash_attention=2 * n + n_groups, flash_attention_bwd=n + n_groups)
    else:
        n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
        fwd = 6 * n_enc + 10 * n_dec + 1
        out.update(dos_matmul=fwd + 10 * n_dec + 2 * fwd, flash_attention=n_enc + 4 * n_dec,
                   flash_attention_bwd=n_enc + 2 * n_dec)
    out["adamw"] = 2 * param_leaves(cfg)
    return out


def cross_train_variants(cfg) -> dict:
    """A phase-16 train step's launches by kernel and variant: every GEMM
    ``wgmma`` but the dA and dB of an unembedding whose vocab is no
    multiple of 8 (whisper's tied 51,865 rows: K of dA and ldb of dB are
    no TMA row, so ``general``), every attention ``mma``."""
    total = cross_train_launches(cfg)
    out = {k: dict.fromkeys(fn.variants, 0) for k, fn in KERNELS.items()}
    general = 2 if cfg.vocab % 8 else 0
    out["dos_matmul"].update(wgmma=total["dos_matmul"] - general, general=general)
    for k in ("flash_attention", "flash_attention_bwd"):
        out[k]["mma"] = total[k]
    out["adamw"] = adamw_variants(cfg)
    return out


def phase_train_cross(arch):
    """Phase 16's training main paths: ``make_train_step`` (the route the
    reference trains these families by: its ``train_loop`` feeds no image
    embeddings or frames) on the vision model cut to one group or on
    whisper at full size, bf16 compute on f32 masters, 8 x 512 tokens of
    ``SyntheticLM`` (seed 0) with each step's image embeddings or frames
    drawn on the card from the step, AdamW (``cross_opt_cfg``), remat, 30
    steps, with the launch counts set to 0 just before and read just
    after: every loss finite and falling, the launches per step exact by
    kernel and variant, step p50/p99 (host clock from the batch's
    transfer to a synchronize, as ``train_loop`` times a step), tokens/s,
    peak memory. Returns the counts, the trained state and the step p50."""
    cfg = cross_train_cfg(arch)
    model = build(cfg, "cuda")
    step_fn = make_train_step(model, cross_opt_cfg(cfg), remat=True)
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0))
    opt = init_opt_state(params)
    init_s = time.perf_counter() - t0
    reset_launch_counts()
    times, losses = [], []
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        ts = time.perf_counter()
        batch = {k: torch.from_numpy(x).to("cuda") for k, x in data.batch(step).items()}
        batch.update(train_inputs(cfg, TRAIN_BATCH, step))
        params, opt, loss = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        losses.append(float(loss))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    variants = {k: dict(fn.variants) for k, fn in KERNELS.items()}
    steps = sorted(times)
    p50, p99 = steps[len(steps) // 2], steps[min(len(steps) - 1, int(0.99 * len(steps)))]
    tok_s = TRAIN_BATCH * TRAIN_SEQ / p50
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[cross] train {cfg.name} ({model.n_params:,} parameters, {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder layers" if cfg.family == "encdec" else "")
          + f", {cfg.compute_dtype} on {cfg.param_dtype} masters, remat) batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, init {init_s:.2f} s, {TRAIN_STEPS} steps in {wall:.2f} s: step "
          f"p50 {p50*1e3:.3f} ms, p99 {p99*1e3:.3f} ms (first {times[0]*1e3:.1f} ms), "
          f"{tok_s:,.0f} tokens/s at p50, peak memory {peak / 2**20:.1f} MiB ({base / 2**20:.1f} "
          "MiB before)", flush=True)
    print(f"[cross] losses: {' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"[cross] launches {counts}; by variant {variants}", flush=True)
    check(all(math.isfinite(x) for x in losses), f"{arch}: a training loss is not finite")
    check(last < first and losses[-1] < losses[0],
          f"{arch}: the loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f} (means of 5: "
          f"{first:.4f} -> {last:.4f})")
    want = {k: n * TRAIN_STEPS for k, n in cross_train_launches(cfg).items()}
    check(counts == want, f"{arch}: train launches {counts}, expected {want}")
    want_v = {k: {v: n * TRAIN_STEPS for v, n in c.items()}
              for k, c in cross_train_variants(cfg).items()}
    check(variants == want_v, f"{arch}: train launches by variant {variants}, expected {want_v}")
    RESULTS["main_paths"][f"train {arch}"] = {
        "n_layers": cfg.n_layers, "n_params": model.n_params, "init_s": init_s,
        "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "wall_s": wall,
        "step_s": times, "step_p50_s": p50, "step_p99_s": p99, "tok_s_p50": tok_s,
        "losses": losses, "peak_mem_bytes": peak, "mem_before_bytes": base, "launches": counts,
        "variants": variants}
    return counts, {"params": params, "opt": opt}, p50


def phase_train_cross_profile(arch, state, step_p50_s):
    """On phase 16's trained state and the next batch: microbatches=2
    against 1 (the loss, and the gradients a step updates with, leaf by
    leaf, within the bf16 band of the leaf's max|g|), then one train step
    under torch.profiler (device busy, idle share, kernels, plain ops; the
    step updates the state in place)."""
    cfg = cross_train_cfg(arch)
    model = build(cfg, "cuda")
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch = {k: torch.from_numpy(x).to("cuda") for k, x in data.batch(TRAIN_STEPS).items()}
    batch.update(train_inputs(cfg, TRAIN_BATCH, TRAIN_STEPS))
    params = state["params"]
    l1, g1 = loss_and_grads(model, params, batch, True)
    l2, g2 = accumulate_grads(model, params, batch, True, 2)
    loss_rel = abs(float(l2) - float(l1)) / abs(float(l1))
    worst, worst_leaf = 0.0, None
    flat2 = dict(leaves(g2))
    for path, want in leaves(g1):
        r = ((flat2[path].float() - want.float()).abs().max()
             / want.abs().max().clamp_min(1e-30)).item()
        if r > worst:
            worst, worst_leaf = r, ".".join(map(str, path))
    del g1, g2, flat2
    print(f"[cross] {arch} microbatches 2 against 1: loss {float(l2):.6f} vs {float(l1):.6f} "
          f"(relative {loss_rel:.3g}); worst accumulated gradient {worst_leaf} at {worst:.3g} "
          f"of its max|g| (band {E2E_TOL})", flush=True)
    check(loss_rel <= E2E_TOL, f"{arch}: the microbatches=2 loss differs by {loss_rel:.3g}")
    check(worst <= E2E_TOL, f"{arch}: the microbatches=2 gradient {worst_leaf} differs by "
          f"{worst:.3g} of its scale")
    step = make_train_step(model, cross_opt_cfg(cfg), remat=True)
    out = {"microbatch_loss_rel": loss_rel, "microbatch_worst_grad_rel": worst,
           "microbatch_worst_leaf": worst_leaf}
    out.update(_profile_train_step(
        lambda: step(params, state["opt"], batch), step_p50_s, f"{arch} train step",
        {"dos_matmul": "dos_matmul", "flash_attention": "flash_mma",
         "flash_attention_bwd": "flash_bwd"}))
    RESULTS["profile"][f"train {arch}"] = out


def phase_cross_kernels() -> dict:
    """Both flash kernels at the shapes phase 16's paths give them
    (CROSS_ATTN, non-causal, Skv no multiple of a 128 tile) against their
    plain versions, bf16 (``mma``; timed beside the plain version, SDPA
    and the bound) and f32 (``fma``), each at check_flash's and
    check_flash_bwd's gates, the variant counted exactly. Returns the
    largest error against the plain version of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows, err = [], {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    for what, b, sq, skv, h, kvh, d in CROSS_ATTN:
        for dtype in (torch.bfloat16, torch.float32):
            timed_ = dtype == torch.bfloat16
            fwd = check_flash(gen, b, sq, skv, h, kvh, d, dtype, causal=False, time_it=timed_)
            bwd = check_flash_bwd(gen, b, sq, skv, h, kvh, d, dtype, causal=False, time_it=timed_)
            err["flash_attention"] = max(err["flash_attention"], fwd["max_abs_err"])
            err["flash_attention_bwd"] = max(err["flash_attention_bwd"], bwd["max_abs_err"])
            rows += [dict(fwd, path=what, kernel="flash_attention"),
                     dict(bwd, path=what, kernel="flash_attention_bwd")]
    RESULTS["cross_kernels"] = rows
    return err


def phase_cross_e2e(arch):
    """Card against CPU on the same weights (the vision gates opened):
    block by block in bf16 (``phase_e2e_blocks``), end to end in f32 (the
    prefill and E2E_DECODE_STEPS decode steps within CROSS_F32_TOL), the
    CPU's own bf16 against f32 prefill logits printed beside them (the
    model's sensitivity to rounding), and one decode step of the f32 model
    on the card under ``set_sync_debug_mode("error")``: no device-to-host
    sync inside a step."""
    bf16_logits = timed(phase_e2e_blocks, arch)
    (mg, params_g, cache, tok), f32_logits = timed(phase_e2e, arch, "float32", CROSS_F32_TOL)
    sens = ((bf16_logits.float() - f32_logits).abs().max() / f32_logits.abs().max()).item()
    before = dos_matmul.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = mg.decode(params_g, cache, {"token": tok})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(dos_matmul.launches > before and bool(torch.isfinite(logits).all()),
          f"{arch}: the decode step under sync debug mode launched nothing or is not finite")
    print(f"[cross] {arch}: the CPU's own bf16 and f32 prefill logits differ by {sens:.3g} of "
          "max|logits| (the cut model's sensitivity to rounding); a decode step on the card "
          "under set_sync_debug_mode('error'): no device-to-host sync", flush=True)
    RESULTS.setdefault("cross_cpu_bf16_vs_f32", {})[arch] = sens


def phase_cross_train_e2e(arch):
    """Card against CPU on the same f32 master weights (the vision gate
    opened) and batch (2 x 64 tokens with their image embeddings or
    frames), one layer of each kind at full width: the vision model as
    one self-attention and one cross layer, whisper as one encoder and one
    decoder layer. The loss and every gradient leaf, in f32 within
    TRAIN_F32_TOL and in bf16 within E2E_TOL of the leaf's max|g|."""
    cfg = get_config(arch)
    depth = ({"n_layers": 2, "cross_every": 2} if cfg.family == "vlm"
             else {"n_enc_layers": 1, "n_layers": 1})
    out = {}
    for dtype, tol in (("float32", TRAIN_F32_TOL), ("bfloat16", E2E_TOL)):
        c = dataclasses.replace(cfg, compute_dtype=dtype, **depth)
        mc, mg = build(c, "cpu"), build(c, "cuda")
        params_c = _cpu_master(dataclasses.replace(c, compute_dtype="float32"))
        params_g = map_tree(lambda t: t.to("cuda"), params_c)
        data = SyntheticLM(DataConfig(c.vocab, CROSS_TRAIN_E2E_SEQ, CROSS_E2E_BATCH, seed=0))
        batch = {k: torch.from_numpy(x) for k, x in data.batch(0).items()}
        batch.update(model_inputs(c, CROSS_E2E_BATCH, 0))
        lc, gc = loss_and_grads(mc, params_c, batch, True)
        lg, gg = loss_and_grads(mg, params_g, {k: x.cuda() for k, x in batch.items()}, True)
        loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
        worst, worst_leaf = _grad_gap(gg, gc)
        print(f"[cross] train, card vs CPU, {arch} one layer of each kind at full width, batch "
              f"{CROSS_E2E_BATCH} x {CROSS_TRAIN_E2E_SEQ}, {dtype}: loss {float(lg):.6f} vs "
              f"{float(lc):.6f} "
              f"(relative {loss_rel:.3g}); worst gradient leaf {worst_leaf} at {worst:.3g} of "
              f"its max|g| (band {tol})", flush=True)
        check(loss_rel <= tol, f"{arch} {dtype}: the card's loss differs by {loss_rel:.3g}")
        check(worst <= tol, f"{arch} {dtype}: gradient {worst_leaf} differs by {worst:.3g}")
        out[dtype] = {"loss_rel": loss_rel, "worst_grad_rel": worst, "worst_leaf": worst_leaf}
    RESULTS.setdefault("cross_train_e2e", {})[arch] = out


CROSS_CLIS = {WHISPER: ["--prompt-len", str(PROMPT)], VLM: ["--smoke"]}


def check_cross_cli(outs, walls):
    """``python -m repro_torch.launch.serve --arch whisper-medium
    --prompt-len 128 --json`` (full size) and ``--arch llama-3.2-vision-11b
    --smoke`` (reduced: the full model's host draws alone take over a
    minute, and its full-size run is the serving main path's
    ``serve_loop``), run by ``phase_clis``: each exits 0 on the card with
    the launches per prefill and decode exact."""
    for arch, out in outs.items():
        wall = walls[arch]
        cfg = get_config(arch) if arch == WHISPER else reduced(get_config(arch))
        want = expected_launches(cfg, out["gen_tokens"])
        check(out["device"]["platform"] == "gpu" and out["launches"] == want,
              f"the {arch} serve CLI's summary is wrong: {out['device']}, {out['launches']} "
              f"(expected {want})")
        print(f"[cross] python -m repro_torch.launch.serve --arch {arch} "
              f"{' '.join(CROSS_CLIS[arch])}: exit 0 within {wall:.1f} s; prefill "
              f"{out['prefill_s']*1e3:.2f} ms, decode {out['decode_tok_s']:.1f} tok/s, launches "
              f"{out['launches']}", flush=True)
        RESULTS.setdefault("cross_cli", {})[arch] = {k: out[k] for k in (
            "prefill_s", "decode_tok_s", "step_p50_s", "launches")}


# The CLIs of phases 12-16 in subprocesses, two waves of processes started
# together, each wave within the card's 80 GB: zamba2-2.7b's training state
# (f32 masters, gradients and two moments, 16 bytes a parameter) beside the
# three serving CLIs, then the other three trainings. One after another,
# most of their time was each process's start and its weights drawn on the
# host, one process at a time.
CLI_WAVES = (
    {f"train {HYBRID}": HYBRID_CLI, f"serve {XLSTM}": XLSTM_CLIS["serve"],
     **{f"serve {a}": ["repro_torch.launch.serve", "--arch", a, *extra, "--json"]
        for a, extra in CROSS_CLIS.items()}},
    {f"train {ARCH}": TRAIN_CLI, f"train {XLSTM}": XLSTM_CLIS["train"], f"train {MOE}": MOE_CLI},
)
CLI_TIMEOUT_S = 600


def _run_clis(cmds: dict) -> dict:
    """``python -m CMD`` for each of ``cmds``, all started together (their
    output to files, each in its own session). Returns each one's JSON
    summary and its wall seconds (start to exit, polled every 0.1 s);
    fails on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    procs, ends = {}, {}
    t0 = time.perf_counter()
    try:
        for name, cmd in cmds.items():
            out = open(os.path.join(tmp, f"{len(procs)}.out"), "w+")
            err = open(os.path.join(tmp, f"{len(procs)}.err"), "w+")
            procs[name] = (subprocess.Popen([sys.executable, "-m", *cmd], stdout=out, stderr=err,
                                            text=True, env=env, cwd=ROOT,
                                            start_new_session=True), out, err)
        while len(ends) < len(procs):
            check(time.perf_counter() - t0 < CLI_TIMEOUT_S,
                  f"CLIs still running after {CLI_TIMEOUT_S} s: {sorted(set(procs) - set(ends))}")
            for name, (p, _, _) in procs.items():
                if name not in ends and p.poll() is not None:
                    ends[name] = time.perf_counter() - t0
            time.sleep(0.1)
        res = {}
        for name, (p, out, err) in procs.items():
            out.seek(0)
            err.seek(0)
            check(p.returncode == 0, f"python -m {' '.join(cmds[name])} exited {p.returncode}: "
                  f"{err.read()[-2000:]}")
            res[name] = (json.loads(out.read()), ends[name])
        return res
    finally:
        for p, out, err in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_clis():
    """The train and serve CLIs of phases 12-16 (``CLI_WAVES``), each held
    to its phase's checks: ``check_train_cli``, ``check_train_hybrid_cli``,
    ``check_xlstm_cli``, ``check_moe_cli``, ``check_cross_cli``."""
    torch.cuda.empty_cache()  # the CLIs' training states are their own
    t0 = time.perf_counter()
    res, walls = {}, []
    for wave in CLI_WAVES:
        t = time.perf_counter()
        res.update(_run_clis(wave))
        walls.append(time.perf_counter() - t)
    check_train_cli(*res[f"train {ARCH}"])
    check_train_hybrid_cli(*res[f"train {HYBRID}"])
    (tr, t_tr), (sv, t_sv) = res[f"train {XLSTM}"], res[f"serve {XLSTM}"]
    check_xlstm_cli(tr, sv, max(t_tr, t_sv))
    check_moe_cli(*res[f"train {MOE}"])
    check_cross_cli({a: res[f"serve {a}"][0] for a in CROSS_CLIS},
                    {a: res[f"serve {a}"][1] for a in CROSS_CLIS})
    RESULTS["clis"] = {"wave_s": walls, "s": {k: w for k, (_, w) in res.items()}}
    print(f"[cli] the CLIs of phases 12-16 in {len(CLI_WAVES)} waves: "
          + ", ".join(f"{' + '.join(w)} {s:.1f} s" for w, s in zip(CLI_WAVES, walls))
          + f"; {time.perf_counter() - t0:.1f} s in all", flush=True)


# ---------------------------------------------------------------------------


def phase_vlm_mixed_dtype():
    """Phase 16: a bf16 vision model with f32 image embeddings (the
    reference projects the cross k, v in f32 and attends its bf16 q to
    them). The card's flash wrapper promotes q, k, v to f32, runs the
    ``fma`` kernel and returns bf16, as the CPU path does: the prefill's
    logits against the CPU's within E2E_TOL of max|logits|, the vision
    gates opened to 0.5 (at 0 no cross-attention result reaches them)."""
    cfg = dataclasses.replace(reduced(get_config(VLM)), compute_dtype="bfloat16")
    logits = {}
    for dev in ("cpu", "cuda"):
        model = build(cfg, device=dev)
        params = model.init_compute(torch.Generator().manual_seed(0))
        params["cross_layers"]["gate"].fill_(0.5)
        tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
        img = torch.randn(2, cfg.n_image_tokens, cfg.d_model,
                          generator=torch.Generator().manual_seed(2))
        before = dict(flash_attention.variants)
        logits[dev] = model.prefill(params, {"tokens": tokens, "image_embeds": img})[0].float().cpu()
        fma = flash_attention.variants["fma"] - before["fma"]
    gap = ((logits["cuda"] - logits["cpu"]).abs().max() / logits["cpu"].abs().max()).item()
    n_cross = cfg.n_layers // cfg.cross_every
    print(f"[cross] {VLM} (reduced, bf16) with f32 image embeddings: the prefill's logits "
          f"within {gap:.3g} of max|logits| of the CPU's; {fma} f32 flash (fma) launches "
          f"(the {n_cross} cross layers)", flush=True)
    RESULTS["vlm_mixed_dtype_gap"] = gap
    check(gap <= E2E_TOL, f"vision prefill with f32 image embeddings: {gap:.3g} of max|logits|")
    check(fma == n_cross, f"{fma} fma flash launches, expected {n_cross}")


# ---------------------------------------------------------------------------
# phase 17: the (data, model) mesh's entry points in an NCCL group of one rank
# ---------------------------------------------------------------------------

MESH_STRATEGIES = ("dos", "megatron", "zero", "auto")
MESH_TRAIN_STEPS = 3


def phase_mesh():
    """Phase 17: the mesh's entry points on the card. smollm-135m's
    ``serve_loop`` at phase 3's size with no process group, then in an
    NCCL group of one rank under every strategy, and with no group again,
    back to back (at (1, 1) the strategies run one device's path: they
    check the arguments' way through the loop, and the three dos runs'
    step times show what the live group costs); ``train_loop`` for MESH_TRAIN_STEPS steps at phase
    12's under every strategy. The tokens equal phase 3's, the losses
    phase 12's first three. (What rank 0 of a larger mesh launches is
    phase 19's, the dense family's included.)"""
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    out = {"serve": {}, "train": {}}
    cfg = serve_cfg(ARCH)

    def serve(strategy, group):
        r = serve_loop(cfg, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, strategy=strategy,
                       mesh_shape=(1, 1), device="cuda")
        same = torch.equal(r["generated"].cpu(), MAIN_TOKENS[ARCH])
        out["serve"][f"{strategy} {group}"] = {k: r[k] for k in ("prefill_s", "step_p50_s",
                                                                 "launches")}
        print(f"[mesh] serve_loop {ARCH} {strategy} (1, 1), {group}: tokens equal phase 3's: "
              f"{same}; prefill {r['prefill_s']*1e3:.2f} ms, step p50 "
              f"{r['step_p50_s']*1e3:.3f} ms", flush=True)
        check(same, f"{strategy} ({group}): tokens differ from phase 3's")
        check(r["launches"] == expected_launches(cfg),
              f"{strategy} ({group}): launches {r['launches']}, expected {expected_launches(cfg)}")

    serve("dos", "no process group")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    init_distributed("cuda", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"process group {dist.get_backend()} of {dist.get_world_size()} ranks")
        mesh = make_test_mesh(1, 1)
        check(type(mesh).__name__ == "DeviceMesh", f"make_test_mesh(1, 1) gave {mesh!r}")
        for strategy in MESH_STRATEGIES:
            serve(strategy, "NCCL group of 1")
        want = RESULTS["main_paths"]["train"]["losses"][:MESH_TRAIN_STEPS]
        for strategy in MESH_STRATEGIES:
            _, losses, wd = train_loop(
                get_config(ARCH), steps=MESH_TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, seed=0, log_every=0, strategy=strategy, mesh_shape=(1, 1),
                opt_cfg=OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS),
                device="cuda")
            out["train"][strategy] = losses
            print(f"[mesh] train_loop {ARCH} {strategy} (1, 1): losses "
                  f"{' '.join(f'{x:.6f}' for x in losses)} (phase 12: "
                  f"{' '.join(f'{x:.6f}' for x in want)})", flush=True)
            check(losses == want, f"{strategy}: losses {losses}, phase 12's {want}")
    finally:
        dist.destroy_process_group()
    serve("dos", "no process group again")
    wall = time.perf_counter() - t0
    out["wall_s"] = wall
    RESULTS["mesh"] = out
    print(f"[mesh] phase 17 took {wall:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 18: GPipe stages, expert-parallel MoE and the int8 gradient sync
# ---------------------------------------------------------------------------

PIPE_MB = 4  # microbatches of phase 12's 8 x 512 batch
PIPE_TIMED_STEPS = 3
PIPE_LOSS_F32_TOL = 1e-5  # relative: the same f32 sums over microbatches of 2 rows
EP_MESHES = ((1, 4), (2, 4))
# bytes an element of the gradient tree moves through compressed_psum_grads's
# plain passes, reads plus writes (f32 4, int8 1, int32 4, f64 8): g + err
# 12, |g| 8, its max 4, g / scale 8, round 8, clip 8, to int8 5, to int32 5,
# qsum to f32 8, its two scalings 16, g and q to f64 12 and 9, q * scale 16,
# g - it 24, back to f32 12
SYNC_PASS_BYTES = 155


def _pipeline_run(model, params, batch, n_mb):
    """``make_gpipe_loss`` over a one-stage mesh: the loss and the stage
    tree's gradients (f32 masters), launches counted from 0."""
    cfg = model.cfg
    mesh = make_stage_mesh(1)
    stage = map_tree(lambda t: t.detach().requires_grad_(),
                     stage_params(params, cfg, mesh, n_stages=1))
    loss_fn = make_gpipe_loss(cfg, mesh, n_stages=1, n_microbatches=n_mb)
    reset_launch_counts()
    loss = loss_fn(stage, batch)
    loss.backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    return loss.detach(), map_tree(lambda t: t.grad, stage), counts


def _pipeline_phase(out):
    """The pipeline part of phase 18 (inside the NCCL group of one): the
    loss and every gradient leaf against ``model.loss`` plus backward on
    the same weights, bf16 and f32 compute; the launches of the bf16 run
    exactly PIPE_MB times one microbatch's; step times. Returns the bf16
    run's gradient tree (f32), which the compression part syncs."""
    base = get_config(ARCH)
    master = build(base, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticLM(DataConfig(base.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.batch(0).items()}
    mb = {k: v[:TRAIN_BATCH // PIPE_MB] for k, v in batch.items()}
    grads_bf16 = None
    for dtype in ("bfloat16", "float32"):
        model = build(dataclasses.replace(base, compute_dtype=dtype), "cuda")
        ref_loss, ref_grads = loss_and_grads(model, master, batch, True)
        loss, grads, counts = _pipeline_run(model, master, batch, PIPE_MB)
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        worst, leaf = _grad_gap(grads, map_tree(lambda t: t.float().cpu(), ref_grads))
        loss_tol = PIPE_LOSS_F32_TOL if dtype == "float32" else E2E_TOL
        grad_tol = TRAIN_F32_TOL if dtype == "float32" else E2E_TOL
        row = {"loss": float(loss), "model_loss": float(ref_loss), "loss_rel": loss_rel,
               "worst_grad_rel": worst, "worst_leaf": leaf, "launches": counts}
        print(f"[pipeline] make_gpipe_loss {ARCH} ({dtype} compute on f32 masters, remat), one "
              f"stage in an NCCL group of one rank, {TRAIN_BATCH} x {TRAIN_SEQ} in {PIPE_MB} "
              f"microbatches: loss {float(loss):.6f} vs model.loss {float(ref_loss):.6f} "
              f"(relative {loss_rel:.3g}, band {loss_tol}); worst gradient leaf {leaf} at "
              f"{worst:.3g} of its max|g| (band {grad_tol})", flush=True)
        check(loss_rel <= loss_tol, f"the {dtype} pipeline loss differs by {loss_rel:.3g}")
        check(worst <= grad_tol, f"the {dtype} pipeline gradient {leaf} differs by {worst:.3g}")
        if dtype == "bfloat16":  # the main path's launches: PIPE_MB microbatches' worth
            _, _, one = _pipeline_run(model, master, mb, 1)
            want = {k: PIPE_MB * n for k, n in one.items()}
            print(f"[pipeline] launches {counts}; one microbatch's {one}", flush=True)
            check(counts == want and all(counts[k] > 0 for k in
                                         ("dos_matmul", "flash_attention", "flash_attention_bwd")),
                  f"pipeline launches {counts}, expected {PIPE_MB} x one microbatch's {one}")
            row["one_microbatch_launches"] = one
            grads_bf16 = grads
            # host clock, interleaved, each ending in a synchronize; beside them
            # phase 12's whole train step (AdamW on clones of the masters) in
            # this process now, to set against phase 12's own p50
            opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS)
            train_step = make_train_step(model, opt_cfg)
            state = (map_tree(torch.clone, master), init_opt_state(master))
            runs = {"pipeline": lambda: _pipeline_run(model, master, batch, PIPE_MB),
                    "model.loss": lambda: loss_and_grads(model, master, batch, True),
                    "train step": lambda: train_step(*state, batch)}
            times = {k: [] for k in runs}
            for _ in range(PIPE_TIMED_STEPS):
                for what, run in runs.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    times[what].append(time.perf_counter() - t0)
            p50 = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
            row["step_s"], row["step_p50_s"] = times, p50
            print(f"[pipeline] loss + backward p50 {p50['pipeline']*1e3:.3f} ms over "
                  f"{PIPE_TIMED_STEPS} steps; model.loss + backward {p50['model.loss']*1e3:.3f} "
                  f"ms; phase 12's train step (with AdamW) here {p50['train step']*1e3:.3f} ms, "
                  f"in phase 12 {RESULTS['main_paths']['train']['step_p50_s']*1e3:.3f} ms; "
                  f"bubble at 1 stage {bubble_fraction(1, PIPE_MB):.3f}, at 4 stages "
                  f"{bubble_fraction(4, PIPE_MB):.3f}", flush=True)
            del state
        out["pipeline"][dtype] = row
        del ref_grads, grads
    return grads_bf16


def _compression_phase(out, grads):
    """The compression part of phase 18 (inside the NCCL group of one):
    two syncs of the pipeline step's gradient tree (the second with the
    first's residual) on the card and on the CPU; q, g_hat and new_err
    equal bit for bit; ms per sync beside its bound."""
    mesh = make_test_mesh(1, 1)
    n = sum(t.numel() for _, t in leaves(grads))
    dev, cpu = {"grads": grads}, {"grads": map_tree(lambda t: t.cpu(), grads)}
    for side in (dev, cpu):  # a one-rank axis: the CPU's tensors take the same mesh
        err = init_error_state(side["grads"])
        side["g_hat1"], err1 = compressed_psum_grads(side["grads"], err, mesh)
        side["q2"] = {p: quantize(t.float() + e)[0] for (p, t), (_, e) in
                      zip(leaves(side["grads"]), leaves(err1))}
        side["g_hat2"], side["err2"] = compressed_psum_grads(side["grads"], err1, mesh)
        side["err1"] = err1
    same = {}
    for key in ("g_hat1", "err1", "g_hat2", "err2"):
        theirs = dict(leaves(cpu[key]))
        same[key] = all(torch.equal(t.cpu(), theirs[p]) for p, t in leaves(dev[key]))
    same["q2"] = all(torch.equal(t.cpu(), cpu["q2"][p]) for p, t in dev["q2"].items())
    err = dev["err1"]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    compressed_psum_grads(grads, err, mesh)
    e0.record()
    for _ in range(PIPE_TIMED_STEPS):
        compressed_psum_grads(grads, err, mesh)
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / PIPE_TIMED_STEPS
    bound = bound_ms(16.0 * n, 0.0, torch.float32)[0]  # g, err read; g_hat, new_err written
    passes = bound_ms(float(SYNC_PASS_BYTES) * n, 0.0, torch.float32)[0]
    out["compression"] = {"elements": n, "bit_identical": same, "ms_per_sync": ms,
                          "bound_ms": bound, "passes_bound_ms": passes}
    print(f"[compress] compressed_psum_grads over {ARCH}'s gradient tree ({n:,} f32 elements, "
          f"{len(list(leaves(grads)))} leaves) in an NCCL group of one rank, two steps of error "
          f"feedback: card equals CPU bit for bit {same}; {ms:.3f} ms per sync (plain torch), "
          f"bound {bound:.3f} ms (one read of g and err, one write of g_hat and new_err), "
          f"{passes:.3f} ms at its passes' {SYNC_PASS_BYTES} bytes an element", flush=True)
    check(all(same.values()), f"the card's int8 sync differs from the CPU's: {same}")


def _ep_inputs(cfg):
    gen = torch.Generator(device="cuda").manual_seed(18)
    p = materialize_cast(moe.moe_defs(cfg), gen, torch.float32, torch.bfloat16, "cuda")
    xs = {tag: torch.randn(BATCH, s, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
          for tag, s in (("prefill", PROMPT), ("decode", 1))}
    return p, xs


def _ep_one_rank(out, cfg, p, xs):
    """``moe_block_ep`` in the NCCL group of one rank at (1, 1): launches
    counted from 0 (the EP main path: a prefill and a decode call), the
    output of each and the prefill's gradients equal ``moe_block``'s bit
    for bit, the decode call without a device-to-host sync."""
    mesh = make_test_mesh(1, 1)
    pl = moe_ep.expert_shard(p, mesh)
    reset_launch_counts()
    with torch.no_grad():
        got = {tag: moe_ep.moe_block_ep(pl, x, cfg, mesh) for tag, x in xs.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    variants = {k: dict(KERNELS[k].variants) for k in ("dos_matmul", "grouped_matmul")}
    with torch.no_grad():
        want = {tag: moe.moe_block(p, x, cfg) for tag, x in xs.items()}
    same = {tag: torch.equal(got[tag], want[tag]) for tag in xs}
    gy = torch.randn_like(xs["prefill"])
    grads = []
    for fn, tree in ((lambda q, x: moe.moe_block(q, x, cfg), p),
                     (lambda q, x: moe_ep.moe_block_ep(q, x, cfg, mesh), pl)):
        q = map_tree(lambda t: t.detach().requires_grad_(), tree)
        x = xs["prefill"].detach().requires_grad_()
        torch.autograd.backward(fn(q, x), gy)
        grads.append([x.grad] + [t.grad for _, t in leaves(q)])
    same["prefill gradients"] = all(torch.equal(a, b) for a, b in zip(*grads))
    del grads
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe_ep.moe_block_ep(pl, xs["decode"], cfg, mesh)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    fv = {tag: gmm_variant(cfg, x.shape[0] * x.shape[1]) for tag, x in xs.items()}
    want_counts = dict.fromkeys(KERNELS, 0)
    want_counts.update(dos_matmul=2 * (1 + 3 * bool(cfg.n_shared_experts)), grouped_matmul=6)
    print(f"[moe_ep] moe_block_ep {MOE} one layer at full width in an NCCL group of one rank "
          f"(1, 1), prefill {BATCH} x {PROMPT} and decode {BATCH} x 1: equal to moe_block bit for "
          f"bit {same}; launches {counts}, by variant {variants} ({fv}); the decode call made "
          "no device-to-host sync", flush=True)
    check(all(same.values()), f"moe_block_ep at (1, 1) differs from moe_block: {same}")
    check(counts == want_counts, f"moe_block_ep launches {counts}, expected {want_counts}")
    want_v = {"dos_matmul": dict(dict.fromkeys(dos_matmul.variants, 0), f32=2, wgmma=3, skinny=3),
              "grouped_matmul": dict(dict.fromkeys(grouped_matmul.variants, 0))}
    for v in fv.values():
        want_v["grouped_matmul"][v] += 3
    check(variants == want_v, f"moe_block_ep launches by variant {variants}, expected {want_v}")
    out["moe_ep"]["(1, 1)"] = {"equal": same, "launches": counts, "variants": variants}
    return counts


def _ep_fake_rank(out, cfg, p, xs, gen):
    """``moe_block_ep`` as rank 0 of each EP_MESHES mesh in a ``fake``
    process group (its all-reduce returns without communicating, so the
    output is rank 0's partial plus the shared experts): each output
    against the same code on the CPU in a fake group within the bf16 band,
    and every grouped product rank 0 launched, with its dW, against the
    plain versions (exact zeros past the sum, the planned variant, timed
    beside the bound). Returns the rows."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    rows = {"grouped_matmul": {}, "grouped_matmul_dw": {}}
    record = []

    def recording(x, w, group_sizes, *, out_dtype=None):
        if x.is_cuda:
            record.append((x.shape[0], x.shape[1], w.shape[-1], group_sizes.clone()))
        return grouped_matmul(x, w, group_sizes, out_dtype=out_dtype)

    moe.grouped_matmul = recording
    try:
        for shape in EP_MESHES:
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
            try:
                mesh = make_test_mesh(*shape)
                pl = moe_ep.expert_shard(p, mesh)
                pl_c = map_tree(lambda t: t.cpu(), pl)
                record.clear()
                with torch.no_grad(), _RecordRoutes() as rec:
                    got = {t: moe_ep.moe_block_ep(pl, x, cfg, mesh) for t, x in xs.items()}
                    want = {t: moe_ep.moe_block_ep(pl_c, x.cpu(), cfg, mesh)
                            for t, x in xs.items()}
                calls = list(record)
                del pl_c
            finally:
                dist.destroy_process_group()
            gaps = {t: (got[t].float().cpu() - want[t].float()).abs().max().item()
                    / want[t].float().abs().max().item() for t in xs}
            agree = rec.agreement()
            print(f"[moe_ep] {shape} rank 0 ({cfg.n_experts // shape[1]} of {cfg.n_experts} "
                  f"experts, {BATCH // shape[0]} of {BATCH} rows) in a fake group: card vs CPU "
                  f"{', '.join(f'{t} {g:.3g}' for t, g in gaps.items())} of the output's max "
                  f"(band {E2E_TOL}); routes agree on {agree['agree']} of {agree['rows']} tokens",
                  flush=True)
            for t, gap in gaps.items():
                check(gap <= E2E_TOL, f"moe_block_ep {shape} {t}: card and CPU differ by {gap:.3g}")
            check(len(calls) == 6, f"moe_block_ep {shape} made {len(calls)} grouped products")
            for (r, k, n, sizes), what in zip(calls, ("gate", "up", "down") * 2):
                tag = "prefill" if r == BATCH // shape[0] * PROMPT * cfg.top_k else "decode"
                name = f"{shape} {tag} {what}"
                check(int(sizes.sum()) < r, f"{name}: no row past the sum ({sizes.tolist()})")
                if what == "up":  # the same operands' shapes and sizes as gate
                    continue
                rows["grouped_matmul"][name] = check_gmm(gen, r, k, n, sizes, time_it=True,
                                                         what=f"EP {name}")
                if tag == "prefill":
                    rows["grouped_matmul_dw"][name] = check_gmm_dw(gen, r, k, n, sizes,
                                                                   time_it=True,
                                                                   what=f"EP {name}")
            out["moe_ep"][str(shape)] = {"card_vs_cpu": gaps, "routes": agree}
    finally:
        moe.grouped_matmul = grouped_matmul
    return rows


def phase_parallel() -> tuple[dict, dict]:
    """Phase 18: ``parallel/pipeline.py``, ``parallel/moe_ep.py`` and
    ``parallel/compression.py`` on the card. In an NCCL group of one rank:
    ``make_gpipe_loss`` on smollm-135m at full size over a one-stage mesh
    (``_pipeline_phase``), ``moe_block_ep`` on one deepseek-moe-16b layer
    at (1, 1) (``_ep_one_rank``) and ``compressed_psum_grads`` over the
    pipeline step's gradients (``_compression_phase``); then
    ``moe_block_ep`` as rank 0 of the EP_MESHES meshes in a ``fake`` group
    (``_ep_fake_rank``). Returns the main paths' launch counts and the
    largest error of the grouped checks by kernel."""
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    out = {"pipeline": {}, "moe_ep": {}}
    counts = {}
    cfg = get_config(MOE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    init_distributed("cuda", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"process group {dist.get_backend()} of {dist.get_world_size()} ranks")
        grads = _pipeline_phase(out)
        parts = {"pipeline": time.perf_counter() - t0}
        counts["pipeline"] = out["pipeline"]["bfloat16"]["launches"]
        _compression_phase(out, grads)
        del grads
        torch.cuda.empty_cache()
        parts["compression"] = time.perf_counter() - t0 - sum(parts.values())
        p, xs = _ep_inputs(cfg)
        counts["moe_ep"] = _ep_one_rank(out, cfg, p, xs)
    finally:
        dist.destroy_process_group()
    rows = _ep_fake_rank(out, cfg, p, xs, torch.Generator(device="cuda").manual_seed(19))
    del p, xs
    torch.cuda.empty_cache()
    out["gmm_rows"] = rows
    out["wall_s"] = time.perf_counter() - t0
    parts["moe_ep"] = out["wall_s"] - sum(parts.values())
    out["wall_s_by_part"] = parts
    RESULTS["parallel"] = out
    print(f"[parallel] phase 18 took {out['wall_s']:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()), flush=True)
    return counts, {k: max(r["max_abs_err"] for r in rs.values()) for k, rs in rows.items()}


# ---------------------------------------------------------------------------
# phase 19: every family's sharded forward, as rank 0 of (data, model) meshes
# ---------------------------------------------------------------------------

# the dense family (smollm-135m; qwen2.5-3b, whose 2 KV heads split at 2
# ranks) and every other family
FAMILY_ARCHS = (ARCH, "qwen2.5-3b", MOE, HYBRID, XLSTM, VLM, WHISPER)
FAMILY_MESHES = ((1, 2), (1, 4), (2, 4))
FAMILY_STRATEGIES = ("dos", "megatron")
FAMILY_TRAIN = (MOE, HYBRID, XLSTM)  # also the loss and its backward
FAMILY_TIME_ITERS = 20  # graph-replayed calls a timed launch, at least
FAMILY_COLD_SETS = 64  # copies of a launch's arguments, at most, to time it cold
# kernel: (the module of its private launcher, the launcher's name)
FAMILY_LAUNCHERS = {
    "dos_matmul": (dos_ops, "_launch_kernel"), "flash_attention": (flash_ops, "_forward"),
    "flash_attention_bwd": (flash_ops, "_backward"), "ssm_scan": (ssm_ops, "_forward"),
    "ssm_scan_bwd": (ssm_ops, "_backward"), "slstm_scan": (slstm_ops, "_forward"),
    "slstm_scan_bwd": (slstm_ops, "_backward"), "grouped_matmul": (gmm_ops, "_launch_forward"),
    "grouped_matmul_dw": (gmm_ops, "_launch_dw"), "decode_attention": (flash_ops, "_decode"),
}


def family_cfg(arch):
    """``arch`` at full width, cut in depth to one repeating unit: one
    layer of a dense model, one deepseek-moe-16b layer, one zamba2-2.7b
    group (6 Mamba2 layers and the shared block), one xlstm-125m mLSTM
    and one sLSTM block, one
    llama-3.2-vision-11b group (4 self layers and the cross layer), one
    whisper-medium encoder and one decoder layer (1,500 frames)."""
    cfg = get_config(arch)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=2, slstm_at=(1,))
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=1, n_enc_layers=1)
    return cut_depth(cfg, cfg.attn_every or cfg.cross_every or 1)


def _sig(x):
    """A launch argument as its planning sees it: a tensor's shape,
    strides, dtype and base alignment; nested tuples; anything else as is."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), tuple(x.stride()), str(x.dtype), x.data_ptr() % 16)
    if isinstance(x, (tuple, list)):
        return tuple(_sig(v) for v in x)
    return x if x is None or isinstance(x, (int, float, bool, str)) else str(x)


def _tensors(x):
    """The tensors of a launch's (nested) arguments."""
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def _clone(x):
    """A copy of a launch argument with the same strides and base alignment
    (a broadcast dim stays a view of one copy)."""
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if not isinstance(x, torch.Tensor):
        return x
    base = x
    for d in range(x.dim()):
        if x.stride(d) == 0 and x.shape[d] > 1:
            base = base.narrow(d, 0, 1)
    off = (base.data_ptr() % 256) // base.element_size()
    span = 1 + sum((s - 1) * st for s, st in zip(base.shape, base.stride()) if s > 0)
    out = torch.empty(off + span, dtype=x.dtype, device=x.device).as_strided(
        base.shape, base.stride(), off)
    out.copy_(base)
    return out.expand(x.shape) if base is not x else out


class _LaunchRecorder:
    """Inside the ``with``, every launch of every kernel keeps, by its
    signature (``_sig`` of its arguments), a copy of its first arguments,
    the variants it launched, its calls and the runs that made it."""

    def __init__(self):
        self.seen = {}
        self.run = None

    def __enter__(self):
        self._orig = {k: getattr(mod, name) for k, (mod, name) in FAMILY_LAUNCHERS.items()}
        for kname, (mod, name) in FAMILY_LAUNCHERS.items():
            setattr(mod, name, self._wrap(kname, self._orig[kname]))
        return self

    def __exit__(self, *exc):
        for kname, (mod, name) in FAMILY_LAUNCHERS.items():
            setattr(mod, name, self._orig[kname])

    def _wrap(self, kname, fn):
        wrapper = KERNELS[kname]

        def launcher(*args, **kw):
            key = (kname, _sig(args), _sig(tuple(sorted(kw.items()))))
            row = self.seen.get(key)
            if row is None:
                row = self.seen[key] = {"kernel": kname, "args": _clone(args), "kw": dict(kw),
                                        "variants": set(), "calls": 0, "runs": set()}
            before = dict(wrapper.variants)
            out = fn(*args, **kw)
            row["variants"] |= {v for v in wrapper.variants if wrapper.variants[v] != before[v]}
            row["calls"] += 1
            row["runs"].add(self.run)
            return out

        return launcher


def _emulated_collectives():
    """Rank 0's collectives in a group whose other ranks hold what it
    holds: a sum is the rank's own tensor, a gather its copies side by
    side, a reduce-scatter its slice (``fake``'s collectives return
    without filling their outputs, which the replayed launches would then
    read). Only what moves the bytes is replaced (``collectives``'
    ``_all_reduce``, ``_all_gather``, ``_reduce_scatter``): each
    collective is still recorded, and allocates what NCCL's path does.
    Returns the originals, to put back."""
    from repro_torch.parallel import collectives as C

    orig = (C._all_reduce, C._all_gather, C._reduce_scatter)

    def all_gather(parts, buf, group):
        for part in parts:
            part.copy_(buf)

    C._all_reduce = lambda buf, op, group: None  # buf is the rank's own tensor already
    C._all_gather = all_gather
    C._reduce_scatter = lambda out, parts, group: out.copy_(parts[0])  # rank 0's slice
    return orig


def _family_gate(kname, args, kw, got, dtype):
    """(ok, max|err| against the f32 plain version of the same operands,
    max|ref|, the largest share of the order-of-sum term that an entry's
    error uses past its rounding, or None) of one replayed launch, at the
    gate of its kernel's own phase: f32 sums in another order within 1e-5 (GEMMs, the flash
    forward), 1e-4 (the scans' and the recurrence's outputs) or
    SSM_BWD_TOL of the largest entry, plus, for a bf16 output, one
    rounding of each entry (2**-8 of it). A GEMM's 1e-5 grows linearly
    with the depth of its sum past 8,192 terms, as phase 12's dA and dB
    gate has it (the tensor cores' f32 adds truncate: the unembedding's
    dA sums 102,400), and its bf16 output may be one bf16 ulp (2**-7 of
    each entry) off: its f32 sum in another order may fall on the other
    side of a rounding tie."""
    f = lambda t: t.float() if isinstance(t, torch.Tensor) else t  # noqa: E731
    ulps = 2.0**-8
    if kname == "dos_matmul":
        a, b, out_dtype = args
        exact, outs, ulps = [matmul_ref(a, b, torch.float32)], [got], 2.0**-7
        rel = 1e-5 * max(1.0, a.shape[-1] / 8192)
    elif kname == "grouped_matmul":
        x, w, sizes = args[:3]
        exact, outs, rel = [grouped_matmul_ref(f(x), f(w), sizes)], [got], GMM_TOL
    elif kname == "grouped_matmul_dw":
        x, dy, sizes = args[:3]
        exact, outs, rel = [grouped_matmul_dw_ref(x, dy, sizes)], [got], GMM_TOL
    elif kname == "flash_attention":
        q, k, v = args
        o, lse = attention_fwd_ref(f(q), f(k), f(v), causal=kw["causal"], window=kw["window"],
                                   scale=kw["scale"], q_offset=kw["q_offset"])
        exact, outs, rel = [o] + ([lse] if kw["with_lse"] else []), [t for t in got if
                                                                     t is not None], 1e-5
    elif kname == "flash_attention_bwd":
        q, k, v, o, do, lse = args
        exact = attention_bwd_ref(f(q), f(k), f(v), f(o), f(do), lse, causal=kw["causal"],
                                  window=kw["window"], scale=kw["scale"],
                                  q_offset=kw["q_offset"])
        ok, errs, ref_max, used = _bwd_gate(got, exact, dtype)
        return ok, max(errs), ref_max, used
    elif kname == "decode_attention":
        q, kc, vc = args
        exact, rel = list(decode_exact(q, kc, vc, **kw)), 1e-5
        outs = list(got) if kw["return_lse"] else [got]
        exact = exact[:len(outs)]
        if not all(_dead_rows_agree(g, x) for g, x in zip(outs, exact)):
            return False, math.inf, 0.0, None
        exact = [torch.where(torch.isinf(x), 0.0, x) for x in exact]  # lse -inf rows agreed
        outs = [torch.where(torch.isinf(g), 0.0, g) for g in outs]
    elif kname == "ssm_scan":
        u, ld, B, C, chunk = args[:5]
        exact, outs, rel = list(ssm_scan_chunked(f(u), ld, f(B), f(C), chunk)), list(got[:2]), 1e-4
    elif kname == "ssm_scan_bwd":
        u, ld, B, C, dy, d_state, _, chunk = args[:8]
        exact = list(ssm_scan_bwd_ref(f(u), ld, f(B), f(C), f(dy), d_state, chunk))
        if args[8] if len(args) > 8 else kw.get("shared", False):
            exact[2:] = [t.sum(2, keepdim=True) for t in exact[2:]]
        ok, errs, _ = _ssm_bwd_gate(got, exact, dtype)
        return ok, max(errs), max(t.abs().max().item() for t in exact), None
    elif kname == "slstm_scan":
        store = args[8] if len(args) > 8 else kw.get("store", False)
        ref = slstm_scan_ref(*args[:8], store=store)
        exact = list(ref[0]) + list(ref[1]) if store else list(ref)
        outs, rel = list(got[:4]) + (list(got[4]) if store else []), SLSTM_TOL
    else:  # slstm_scan_bwd
        exact, outs, rel = [t for t in slstm_scan_bwd_ref(*args[:11]) if t is not None], [
            t for t in got if t is not None], SLSTM_BWD_TOL
    ok, err, ref_max, used = True, 0.0, 0.0, -math.inf
    for g, x in zip(outs, exact):
        x = x.float()
        e = (g.float() - x).abs()
        scale = max(x.abs().max().item(), 1e-30)
        rounding = ulps * x.abs() if g.dtype == torch.bfloat16 else 0.0
        ok = ok and g.shape == x.shape and bool((e <= rel * scale + rounding).all())
        err, ref_max = max(err, e.max().item()), max(ref_max, scale)
        used = max(used, ((e - rounding) / (rel * scale)).max().item())
    return ok and len(outs) == len(exact), err, ref_max, used


def _family_work(kname, args, kw):
    """(bytes, operations, the operands' dtype) of one launch, by its
    wrapper's ``work`` (each input read once, each output written once;
    what these inputs need)."""
    t0 = args[0]
    es = t0.element_size()
    if kname == "dos_matmul":
        a, b, out_dtype = args
        m, k, n = a.numel() // a.shape[-1], a.shape[-1], b.shape[1]
        return (*dos_ops.work(m, k, n, es, torch.finfo(out_dtype).bits // 8)[:2], a.dtype)
    if kname in ("grouped_matmul", "grouped_matmul_dw"):
        x, w, sizes = args[:3]
        sizes = sizes.cpu()
        if kname == "grouped_matmul_dw":
            out_dtype = kw.get("out_dtype", args[4] if len(args) > 4 else torch.float32)
            return (*gmm_ops.dw_work(x.shape[0], x.shape[1], w.shape[1], sizes, es,
                                     torch.finfo(out_dtype).bits // 8)[:2], x.dtype)
        out_es = torch.finfo(kw.get("out_dtype") or x.dtype).bits // 8
        return (*gmm_ops.work(x.shape[0], x.shape[1], w.shape[2], sizes, es, out_es)[:2],
                x.dtype)
    if kname in ("flash_attention", "flash_attention_bwd"):
        q, k = args[0], args[1]
        b, sq, h, d = q.shape
        skv, kvh = k.shape[1], k.shape[2]
        mask = (kw["causal"], kw["window"], kw["q_offset"])
        if kname == "flash_attention_bwd":
            return (*flash_ops.bwd_work(b, sq, skv, h, kvh, d, es, *mask)[:2], q.dtype)
        return (*flash_ops.work(b, sq, skv, h, kvh, d, es, *mask, kw["with_lse"])[:2], q.dtype)
    if kname == "decode_attention":
        q, kc = args[0], args[1]
        b, _, h, d = q.shape
        length = kw["length"]
        rows = length.expand(b).tolist() if isinstance(length, torch.Tensor) else [length] * b
        return (*flash_ops.decode_work(b, kc.shape[1], h, kc.shape[2], d, q.element_size(),
                                       kc.element_size(), rows, kw["window"],
                                       kw["return_lse"])[:2], kc.dtype)
    if kname in ("ssm_scan", "ssm_scan_bwd"):
        u, B = args[0], args[2]
        bt, s, h, p = u.shape
        shared = B.stride(2) == 0
        chunk = args[4] if kname == "ssm_scan" else args[7]
        if kname == "ssm_scan":
            return (*ssm_ops.work(bt, s, h, p, B.shape[-1], es, shared, chunk)[:2], u.dtype)
        return (*ssm_ops.bwd_work(bt, s, h, p, B.shape[-1], es, shared, chunk,
                                  args[5] is not None)[:2], u.dtype)
    z, r = (args[0], args[4]) if kname == "slstm_scan" else (args[7], args[3])
    b, s, e = z.shape
    h, d = r.shape[0], r.shape[1]
    if kname == "slstm_scan":
        store = args[8] if len(args) > 8 else kw.get("store", False)
        return (*slstm_ops.work(b, s, h, d, store)[:2], torch.float32)
    return (*slstm_ops.bwd_work(b, s, h, d)[:2], torch.float32)


def _check_family_launch(row) -> dict:
    """One recorded launch replayed: the kernel on copies of its first
    arguments against its plain version (``_family_gate``), the variant it
    launched the one its plan gives again, timed (CUDA-graph replay) on
    inputs cold in L2 beside its bound: the calls cycle over copies of
    the arguments, COLD_BYTES of them in all, or FAMILY_COLD_SETS where
    an argument set is smaller than COLD_BYTES / FAMILY_COLD_SETS."""
    kname, args, kw = row["kernel"], row["args"], row["kw"]
    mod, name = FAMILY_LAUNCHERS[kname]
    launch = getattr(mod, name)
    wrapper = KERNELS[kname]
    before = dict(wrapper.variants)
    got = launch(*args, **kw)
    launched = {v for v in wrapper.variants if wrapper.variants[v] != before[v]}
    dtype = args[0].dtype if kname not in ("slstm_scan", "slstm_scan_bwd") else torch.float32
    ok, err, ref_max, used = _family_gate(kname, args, kw, got, dtype)
    n_bytes, n_ops, op_dtype = _family_work(kname, args, kw)
    bound, by = bound_ms(n_bytes, n_ops, op_dtype if op_dtype in PEAK_OPS_S else torch.float32)
    in_bytes = sum(t.numel() * t.element_size() for t in _tensors(args))
    sets = [args] + [_clone(args) for _ in range(
        min(FAMILY_COLD_SETS, math.ceil(COLD_BYTES / max(in_bytes, 1))) - 1)]
    ms = cuda_ms(lambda i: launch(*sets[i], **kw), len(sets), max(FAMILY_TIME_ITERS, len(sets)))
    del sets
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)][:3]
    out = got[0] if isinstance(got, tuple) else got
    return {"kernel": kname, "shapes": shapes, "dtype": str(dtype).split(".")[-1],
            "out": str(out.dtype).split(".")[-1],
            "variant": sorted(row["variants"]), "replayed": sorted(launched),
            "calls": row["calls"], "runs": sorted(row["runs"]), "max_abs_err": err,
            "max_ref": ref_max, "gate_used": used, "ms": ms, "bound_ms": bound, "bound_by": by,
            "ok": ok and launched == row["variants"] and len(launched) == 1}


def _variants_since(before) -> dict:
    """Launches by kernel and variant since the ``variants`` snapshot
    ``before``, without zeros."""
    out = {}
    for k, fn in KERNELS.items():
        by = {v: n - before[k][v] for v, n in fn.variants.items() if n != before[k][v]}
        if by:
            out[k] = by
    return out


def _card_run(fn):
    """``fn()`` on the card as rank 0: its output, and what phase 20 holds
    the meta accounting to: launches by kernel and variant, the
    collectives it issued, and the peak bytes it allocated above what was
    allocated before it."""
    from repro_torch.parallel import collectives as C

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = {k: dict(fn_.variants) for k, fn_ in KERNELS.items()}
    with C.recording() as log:
        out = fn()
    torch.cuda.synchronize()
    return out, {"launches": _variants_since(before), "collectives": [tuple(c) for c in log],
                 "peak": torch.cuda.max_memory_allocated() - held}


def _family_inputs(model, serve, master, mesh, strategy, train):
    """Rank 0's serving shards of ``serve`` and, if ``train``, training
    shards of ``master`` (FSDP on) on ``mesh`` under ``strategy``, with the
    rules of each."""
    from repro_torch.parallel.axes import param_sharding
    from repro_torch.parallel.plan import shard_tree

    s_rules = ShardingRules(mesh, strategy=strategy, fsdp=False)
    t_rules = ShardingRules(mesh, strategy=strategy, fsdp=True)
    params = shard_tree(serve, param_sharding(model.defs, s_rules), mesh)
    shards = shard_tree(master, param_sharding(model.defs, t_rules), mesh) if train else None
    return params, shards, s_rules, t_rules


def _family_runs(arch, rec, cfg=None, device="cuda") -> dict:
    """The launches of ``arch``'s cut config (``cfg``: another) by kernel
    on one card (no group), then as rank 0 of each FAMILY_MESHES mesh under
    each FAMILY_STRATEGIES plan (``rec`` recording them); each sharded
    run's launches checked equal to one card's, mode by mode. Returns the
    launches by run, and each sharded run's modes as ``_card_run`` gives
    them (with their argument bytes) for phase 20, from a second pass of
    the run outside the recorder (whose copies would raise its peak).
    ``device="cpu"`` rehearses the runs on the plain versions (no launch
    to count)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.accounting import tree_bytes
    from repro_torch.parallel.axes import use_rules

    cfg = cfg or family_cfg(arch)
    model = build(cfg, device=device)
    master = model.init(torch.Generator(device=device).manual_seed(0))
    serve = model.compute_params(master)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen)
    token = torch.randint(0, cfg.vocab, (BATCH, 1), generator=gen)
    extra = {k: v.to(device) for k, v in model_inputs(cfg, BATCH, 0).items()}
    train = arch in FAMILY_TRAIN
    batch = {"tokens": prompts, "labels": prompts.roll(-1, 1)} if train else None
    on_card = device == "cuda"

    def modes(params, master_params, rules=None, t_rules=None, measure=False):
        counts, card = {}, {}

        def run(mode, fn, r, args):
            c0 = launch_counts()
            with use_rules(r):
                if measure:
                    out, card[mode] = _card_run(fn)
                    card[mode]["args"] = tree_bytes(args)
                else:
                    out = fn()
            c1 = launch_counts()
            counts[mode] = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
            return out

        with torch.no_grad():
            _, cache = run("prefill", lambda: model.prefill(
                params, {"tokens": prompts, **extra}, max_len=PROMPT + 1), rules, (params, extra))
            run("decode", lambda: model.decode(params, cache, {"token": token}), rules,
                (params, cache))
        del cache
        if master_params is not None:
            run("train", lambda: loss_and_grads(model, master_params, batch, remat=True),
                t_rules or rules, (master_params,))
        if on_card:
            torch.cuda.synchronize()
        return counts, card

    one, _ = modes(serve, master if train else None)
    out = {"one card": one}
    cards = {}
    orig = _emulated_collectives()
    try:
        for mesh_shape in FAMILY_MESHES:
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=math.prod(mesh_shape))
            try:
                for strategy in FAMILY_STRATEGIES:
                    mesh = make_test_mesh(*mesh_shape)
                    params, shards, s_rules, t_rules = _family_inputs(model, serve, master, mesh,
                                                                      strategy, train)
                    rec.run = f"{mesh_shape} {strategy}"
                    with rec:
                        counts, _ = modes(params, shards, s_rules, t_rules)
                    if on_card:
                        again, cards[mesh_shape, strategy] = modes(params, shards, s_rules,
                                                                   t_rules, measure=True)
                        check(again == counts, f"{arch} as rank 0 of {rec.run}: a second run "
                              f"launched {again}, the first {counts}")
                    out[rec.run] = counts
                    check(counts == one, f"{arch} as rank 0 of {rec.run}: launches {counts}, one "
                          f"card's {one}")
                    del params, shards
            finally:
                dist.destroy_process_group()
    finally:
        from repro_torch.parallel import collectives as C

        C._all_reduce, C._all_gather, C._reduce_scatter = orig
    return out, cards


FAMILY_PEAK_GAP = 0.10  # the meta accounting's peak bytes per rank against the card's
# and its temp alone (the peak above the arguments): the earlier runs of this phase
# on the H100 put it 0 to 21 % under the card's, the largest in decode runs whose
# temp is a few MiB; 8 allocator granules bound a tiny temp
FAMILY_TEMP_GAP, FAMILY_TEMP_FLOOR = 0.25, 8 * 512


def _meta_family_runs(arch, cards, cfg=None) -> list:
    """Phase 20 for one family: each of ``cards``' runs (phase 19's sharded
    runs as rank 0 on the card, by (mesh, strategy)) accounted on the meta
    device at the same config, mesh shape (a ``MeshSpec``), strategy and
    mode, with the same inputs' shapes (``launch/accounting.py``), and held
    to the card's: launches by kernel and variant equal, the collectives
    equal op by op, the peak bytes per rank (allocated above the
    arguments, plus the arguments' bytes) within FAMILY_PEAK_GAP of the
    card's, and the temp alone (allocated above the arguments) within
    FAMILY_TEMP_GAP of the card's or FAMILY_TEMP_FLOOR bytes, whichever is
    more: in a decode run the arguments are most of the peak, and the
    first gate alone would pass a temp of 0. Returns a row per run and
    mode."""
    from repro_torch.launch.accounting import account
    from repro_torch.launch.dryrun import meta_model
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.params import map_tree
    from repro_torch.parallel.axes import use_rules

    cfg = cfg or family_cfg(arch)
    model = meta_model(cfg)
    master = map_tree(lambda d: torch.empty(d.shape, dtype=getattr(torch, cfg.param_dtype),
                                            device="meta"), model.defs)
    serve = model.compute_params(master)
    prompts = torch.zeros((BATCH, PROMPT), dtype=torch.int64)
    token = torch.zeros((BATCH, 1), dtype=torch.int64)
    extra = {k: v.to("meta") for k, v in model_inputs(cfg, BATCH, 0).items()}
    train = arch in FAMILY_TRAIN
    batch = {"tokens": prompts, "labels": prompts}
    rows = []
    for (mesh_shape, strategy), card in cards.items():
        mesh = MeshSpec(mesh_shape, ("data", "model"))
        params, shards, s_rules, t_rules = _family_inputs(model, serve, master, mesh, strategy,
                                                          train)
        with use_rules(s_rules):
            (_, cache), prefill = account(model.prefill, params, {"tokens": prompts, **extra},
                                          max_len=PROMPT + 1)
            _, decode = account(model.decode, params, cache, {"token": token})
        got = {"prefill": prefill, "decode": decode}
        if train:
            with use_rules(t_rules):
                got["train"] = account(loss_and_grads, model, shards, batch, True)[1]
        for mode, meta in got.items():
            c = card[mode]
            want, have = c["peak"] + c["args"], meta.peak_bytes + c["args"]
            gap = (have - want) / want
            temp_gap = (meta.peak_bytes - c["peak"]) / max(c["peak"], 1)
            temp_ok = abs(meta.peak_bytes - c["peak"]) <= max(FAMILY_TEMP_GAP * c["peak"],
                                                              FAMILY_TEMP_FLOOR)
            coll = [tuple(x) for x in meta.collectives]
            row = {"arch": arch, "mesh": list(mesh_shape), "strategy": strategy, "mode": mode,
                   "launches": meta.launches, "card_launches": c["launches"],
                   "collectives": len(coll), "card_collectives": len(c["collectives"]),
                   "peak_bytes": have, "card_peak_bytes": want, "args_bytes": c["args"],
                   "peak_gap": gap, "temp_bytes": meta.peak_bytes, "card_temp_bytes": c["peak"],
                   "temp_gap": temp_gap, "trace_s": meta.seconds,
                   "ok": (meta.launches == c["launches"] and coll == c["collectives"]
                          and abs(gap) <= FAMILY_PEAK_GAP and temp_ok)}
            rows.append(row)
            if not row["ok"]:
                print(f"[meta] {arch} {mesh_shape} {strategy} {mode}: launches {meta.launches} "
                      f"(card {c['launches']}); collectives equal: {coll == c['collectives']}; "
                      f"peak gap {gap:+.4f}, temp gap {temp_gap:+.4f}  FAIL", flush=True)
    return rows


def check_gmm_f32(gen, rows, k, n, sizes, what) -> dict:
    """The grouped forward's f32 output (a mesh's K-split or row-parallel
    partial) on x (rows, k) and w (G, k, n) bf16: against the plain version
    on the f32 result of the same operands (GMM_TOL of the largest entry),
    its rounding to bf16 bit for bit the bf16 forward's (the same f32
    accumulators, rounded once), rows past the sum zero; timed beside the
    bf16 forward, its bound and ``torch._grouped_mm`` (bf16 out)."""
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device="cuda")
    x = torch.randn(rows, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(len(sizes), k, n, generator=gen, device="cuda") / k**0.5).to(torch.bfloat16)
    want = gmm_ops.plan(rows, len(sizes), torch.bfloat16, True).variant
    f32 = _count_one(grouped_matmul, want, lambda: grouped_matmul(x, w, sizes,
                                                                out_dtype=torch.float32), what)
    bf16 = grouped_matmul(x, w, sizes)
    exact = grouped_matmul_ref(x.float(), w.float(), sizes)
    err = (f32 - exact).abs()
    used = int(sizes.sum())
    ok = (f32.dtype == torch.float32 and bool((err <= GMM_TOL * exact.abs().max()).all())
          and torch.equal(f32.to(torch.bfloat16), bf16) and not f32[used:].any())
    n_bytes, n_ops = gmm_ops.work(rows, k, n, sizes.cpu(), 2)[:2]
    row = {"what": what, "rows": rows, "K": k, "N": n, "variant": want,
           "max_abs_err": err.max().item(), "max_ref": exact.abs().max().item(), "ok": ok,
           "ms_f32": cuda_ms(lambda i: grouped_matmul(x, w, sizes, out_dtype=torch.float32), 1),
           "ms_bf16": cuda_ms(lambda i: grouped_matmul(x, w, sizes), 1)}
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes + 2 * rows * n, n_ops, torch.bfloat16)
    offs = sizes.cumsum(0).to(torch.int32)
    row["library_ms"] = _library_ms(lambda i: torch._grouped_mm(x, w, offs=offs), what)
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
    print(f"[families] grouped_matmul f32 out {what}: ({rows}, {k}) x ({len(sizes)}, {k}, {n}) "
          f"[{want}]: {row['ms_f32']:.4f} ms (bf16 out {row['ms_bf16']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms with the f32 output, torch._grouped_mm {lib}); max|err| "
          f"{row['max_abs_err']:.3g} of max|ref| {row['max_ref']:.3g}; bf16 rounding of it equal "
          "to the bf16 forward: " + str(torch.equal(f32.to(torch.bfloat16), bf16))
          + ("" if ok else "  FAIL"), flush=True)
    check(ok, f"grouped_matmul f32 out {what} disagrees")
    return row


def phase_mesh_families() -> dict:
    """Phase 19: every family's sharded forward on the card (FAMILY_ARCHS),
    as rank 0 of
    each FAMILY_MESHES mesh under dos and megatron (a ``fake`` group whose
    other ranks are taken to hold what rank 0 holds:
    ``_emulated_collectives``), at full width cut in depth
    (``family_cfg``): a prefill of BATCH x PROMPT (with the vision
    model's image embeddings, whisper's 1,500 frames) and one decode
    step, and for the MoE, hybrid and xLSTM models the loss and its
    backward on the same rows (FSDP on, remat). Each run's launches by
    kernel equal one card's exactly, mode by mode; every distinct launch
    (a kernel at a rank's shapes, strides and flags) is replayed against
    its plain version with the variant it launched, and timed beside its
    bound. Then the grouped forward's f32 output on its own at the (1, 4)
    and (2, 4) shard shapes of deepseek-moe-16b's K-split products.
    Returns the largest error by kernel and each family's sharded runs as
    ``_card_run`` gives them (phase 20's reference)."""
    t0 = time.perf_counter()
    out = {"launches": {}, "rows": []}
    errs, cards = {}, {}
    for arch in FAMILY_ARCHS:
        ta = time.perf_counter()
        rec = _LaunchRecorder()
        out["launches"][arch], cards[arch] = _family_runs(arch, rec)
        runs = time.perf_counter() - ta
        rows = [_check_family_launch(r) for r in rec.seen.values()]
        del rec
        torch.cuda.empty_cache()
        for row in rows:
            row["arch"] = arch
            errs[row["kernel"]] = max(errs.get(row["kernel"], 0.0), row["max_abs_err"])
            print(f"[families] {arch} {row['kernel']} {row['shapes']} {row['dtype']} "
                  f"[{'/'.join(row['variant'])}] x{row['calls']} in {len(row['runs'])} runs: "
                  f"max|err| {row['max_abs_err']:.3g} (max|ref| {row['max_ref']:.3g}), "
                  f"{row['ms']*1e3:.1f} us cold, bound {row['bound_ms']*1e3:.2f} us "
                  f"({row['bound_by']})" + ("" if row["ok"] else "  FAIL"), flush=True)
            check(row["ok"], f"{arch}: {row['kernel']} at a rank's shapes disagrees with its "
                  f"plain version or left its variant: {row}")
        out["rows"] += rows
        one = out["launches"][arch]["one card"]
        print(f"[families] {arch} ({family_cfg(arch).n_layers} layers): every rank-0 run's "
              f"launches equal one card's, {one}; {len(rows)} distinct launches checked; runs "
              f"{runs:.1f} s, checks {time.perf_counter() - ta - runs:.1f} s", flush=True)
    check(any(r["kernel"] == "dos_matmul" and r["dtype"] == "bfloat16" and r["out"] == "float32"
              for r in out["rows"]), "no K-split (f32 partial) GEMM was launched")
    cfg = get_config(MOE)
    gen = torch.Generator(device="cuda").manual_seed(29)
    gmm_rows = []
    for d, m in ((1, 4), (2, 4)):
        tokens = BATCH * PROMPT // d
        sizes = moe_routes(gen, cfg, tokens)
        e, f = cfg.d_model, cfg.expert_d_ff
        gmm_rows.append(check_gmm_f32(gen, tokens * cfg.top_k, e // m, f, sizes,
                                      f"dos ({d}, {m}) gate/up, K-split over E"))
        gmm_rows.append(check_gmm_f32(gen, tokens * cfg.top_k, f // m, e, sizes,
                                      f"({d}, {m}) down, K-split over expert_ff"))
    out["gmm_f32"] = gmm_rows
    errs["grouped_matmul"] = max(errs.get("grouped_matmul", 0.0),
                                 *(r["max_abs_err"] for r in gmm_rows))
    out["wall_s"] = time.perf_counter() - t0
    RESULTS["families"] = out
    print(f"[families] phase 19 took {out['wall_s']:.1f} s ({len(out['rows'])} distinct "
          "launches)", flush=True)
    return errs, cards


def phase_meta_families(cards) -> None:
    """Phase 20: phase 19's sharded runs accounted on the meta device, the
    dry-run's accounting (``launch/dryrun.py``, ``launch/accounting.py``),
    and held to the card's (``_meta_family_runs``): launches by kernel and
    variant and the collectives exactly, the peak bytes per rank within
    FAMILY_PEAK_GAP and the temp alone within FAMILY_TEMP_GAP. Also holds
    the meta branch's stand-ins for what a kernel library answers
    (``ssm_scan.ops.MAX_GROUP``, ``slstm.ops.part_floats``) to the
    libraries built here."""
    t0 = time.perf_counter()
    lib = ssm_ops._bwd_lib()
    for chunk in ssm_ops.CHUNKS:
        for n in ssm_ops.STATE_DIMS:
            check(ssm_ops.MAX_GROUP.get((chunk, n), 8) == lib.ssm_scan_bwd_max_group(chunk, n),
                  f"ssm_scan.ops.MAX_GROUP disagrees with the library at chunk {chunk}, N {n}")
    slib = slstm_ops._bwd_lib()
    for d in (16, 32, 64, 96, 128, 192):
        check(slstm_ops.part_floats(d) == slib.slstm_bwd_part_floats(d),
              f"slstm.ops.part_floats({d}) disagrees with the library")
    rows = []
    for arch, by_run in cards.items():
        ta = time.perf_counter()
        got = _meta_family_runs(arch, by_run)
        rows += got
        gaps = [r["peak_gap"] for r in got]
        temps = [r["temp_gap"] for r in got]
        print(f"[meta] {arch}: {len(got)} runs accounted on meta in "
              f"{time.perf_counter() - ta:.1f} s; launches by kernel and variant and collectives "
              f"(up to {max(r['collectives'] for r in got)} a run) equal the card's in "
              f"{sum(r['launches'] == r['card_launches'] for r in got)} and "
              f"{sum(r['collectives'] == r['card_collectives'] for r in got)} of them; peak gaps "
              f"{min(gaps):+.4f} to {max(gaps):+.4f}, temp gaps {min(temps):+.4f} to "
              f"{max(temps):+.4f}", flush=True)
    for r in rows:
        print(f"[meta] {r['arch']} {tuple(r['mesh'])} {r['strategy']} {r['mode']}: peak "
              f"{r['peak_bytes'] / 2**20:.1f} MiB meta, {r['card_peak_bytes'] / 2**20:.1f} MiB "
              f"card (arguments {r['args_bytes'] / 2**20:.1f} MiB): gap {r['peak_gap']:+.4f}; "
              f"temp {r['temp_bytes'] / 2**20:.2f} MiB meta, {r['card_temp_bytes'] / 2**20:.2f} "
              f"MiB card: gap {r['temp_gap']:+.4f}", flush=True)
    wall = time.perf_counter() - t0
    RESULTS["meta_families"] = {"rows": rows, "wall_s": wall}
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"the meta accounting disagrees with the card in {len(bad)} runs: {bad[:3]}")
    print(f"[meta] phase 20 took {wall:.1f} s: {len(rows)} runs, every launch by variant and "
          f"collective equal to the card's, peak bytes within {FAMILY_PEAK_GAP:.0%}, temp within "
          f"{FAMILY_TEMP_GAP:.0%}", flush=True)


# ---------------------------------------------------------------------------
# phase 21: the report and the examples on the card
# ---------------------------------------------------------------------------

# examples/torch/*.py and the flags tests/test_torch_examples.py runs them with
EXAMPLES = {
    "quickstart.py": ["--smoke"],
    "dse_explore.py": ["--m", "64", "--k", "2048", "--n", "147", "--pareto"],
    "network_explore.py": ["--arch", "smollm-135m", "--shape", "decode_32k"],
    "serve_decode.py": ["--arch", "smollm-135m", "--gen-tokens", "8"],
    "train_lm.py": ["--steps", "3", "--smoke"],
}
# what each example must launch on the card
EXAMPLE_KERNELS = {
    "quickstart.py": ("dos_matmul", "flash_attention", "flash_attention_bwd"),
    "serve_decode.py": ("dos_matmul", "flash_attention", "decode_attention"),
    "train_lm.py": ("dos_matmul", "flash_attention", "flash_attention_bwd", "adamw"),
}
# the examples whose every line the card prints as the CPU does (the
# engine's exact integers, the thermal solve's bits)
EXAMPLES_AS_CPU = ("dse_explore.py", "network_explore.py")
# the report's sections that equal the committed experiments/*_section.md
# (the engine's exact integers; the roofline section up to its dry-run table)
REPORT_EXACT = ("dse", "network", "search", "serve", "thermal")


def _run_example(name, args) -> str:
    """``examples/torch/<name> ARGS`` run in this process (``runpy``, so
    the launch counters see it), its stdout captured and returned."""
    import contextlib
    import io
    import runpy

    path = os.path.join(ROOT, "examples", "torch", name)
    argv, sys.argv = sys.argv, [path, *args]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv
    return buf.getvalue()


def _md_rows(text) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("| ") and not ln.startswith("| ---")]


def phase_report() -> dict:
    """``repro_torch.report.main`` (what ``python -m repro_torch report``
    runs) on ``cuda``, all eight sections into a temporary directory, and
    the five ``examples/torch`` scripts at their test flags on the card
    (default device), in this process: each with the launch counts set to
    0 just before and read just after. The dse, network, search, serve and
    thermal sections must equal the committed ``experiments/*_section.md``
    byte for byte, the roofline section up to its dry-run table; the
    calibrate section has the committed file's row labels and launched
    ``dos_matmul``, ``flash_attention`` and ``ssm_scan``; the dry-run
    section reads 66 cells traced, 0 failures. Each example must print, and
    launch its ``EXAMPLE_KERNELS``; ``EXAMPLES_AS_CPU`` print the CPU's
    lines. Returns the launch counts by run."""
    from repro_torch import report

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_report_")
    counts, out = {}, {}

    def committed(section):
        with open(os.path.join(ROOT, "experiments", f"{section}_section.md")) as f:
            return f.read()

    try:
        cal = {}
        section = report.calibrate_section

        def calibrate_counted(*a, **k):
            c0 = launch_counts()
            text = section(*a, **k)
            c1 = launch_counts()
            cal.update({n: c1[n] - c0[n] for n in c1})
            return text

        report.calibrate_section = calibrate_counted
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            written = report.main(device="cuda", out_dir=tmp)
        finally:
            report.calibrate_section = section
        wall = time.perf_counter() - t0
        counts["report"] = launch_counts()
        texts = {p.name[:-len("_section.md")]: p.read_text() for p in written
                 if p.name.endswith("_section.md")}
        check(sorted(texts) == sorted(report.SECTIONS), f"the report wrote {sorted(texts)}")
        for name in REPORT_EXACT:
            check(texts[name] == committed(name),
                  f"the report's {name} section differs from experiments/{name}_section.md")
        head, sep, _ = texts["roofline"].partition("\n### Dry-run roofline")
        check(sep and head == committed("roofline"),
              "the report's roofline section differs from experiments/roofline_section.md")
        rows, want = _md_rows(texts["calibrate"]), _md_rows(committed("calibrate"))
        check([r.split(" | ")[0] for r in rows] == [r.split(" | ")[0] for r in want],
              f"the calibrate section's rows {rows}")
        check(all(cal[k] > 0 for k in ("dos_matmul", "flash_attention", "ssm_scan")),
              f"the calibrate section launched {cal}")
        first = texts["dryrun"].splitlines()[0]
        check(first == "**33 single-pod + 33 multi-pod cells traced OK; 0 failures.**",
              f"the dry-run section reads {first!r}")
        backend = next(ln for ln in texts["calibrate"].splitlines() if ln.startswith("Backend:"))
        print(f"[report] python -m repro_torch report (all 8 sections, cuda) in {wall:.1f} s: "
              f"{', '.join(REPORT_EXACT)} equal to experiments/*_section.md, roofline up to its "
              f"dry-run table; dry-run: {first}; calibrate launched "
              f"{ {k: n for k, n in cal.items() if n} }, the whole report "
              f"{ {k: n for k, n in counts['report'].items() if n} }; {backend.split('. ')[0]}",
              flush=True)
        for r in rows[1:]:
            print(f"[report] calibrate {r}", flush=True)
        out["report"] = {"wall_s": wall, "calibrate_launches": cal,
                         "calibrate_section": texts["calibrate"]}

        for name, args in EXAMPLES.items():
            extra = ["--ckpt-dir", os.path.join(tmp, "ckpt")] if name == "train_lm.py" else []
            reset_launch_counts()
            t0 = time.perf_counter()
            text = _run_example(name, [*args, *extra])
            ex_wall = time.perf_counter() - t0
            c = counts[f"example {name}"] = launch_counts()
            lines = text.splitlines()
            check(bool(lines), f"examples/torch/{name} printed nothing")
            missing = [k for k in EXAMPLE_KERNELS.get(name, ()) if c[k] == 0]
            check(not missing, f"examples/torch/{name} launched no {missing}: {c}")
            note = ""
            if name in EXAMPLES_AS_CPU:
                cpu = _run_example(name, [*args, "--device", "cpu"]).splitlines()
                check(lines == cpu, f"examples/torch/{name} prints on the card other lines than "
                      f"on the CPU: {[(a, b) for a, b in zip(lines, cpu) if a != b][:3]}")
                note = "; every line equal to the CPU's"
            print(f"[report] examples/torch/{name} {' '.join(args)}: {len(lines)} lines in "
                  f"{ex_wall:.1f} s, last {lines[-1].strip()!r}; launches "
                  f"{ {k: n for k, n in c.items() if n} }{note}", flush=True)
            out[name] = {"wall_s": ex_wall, "launches": c, "stdout": text}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    RESULTS["report"] = out
    print(f"[report] phase 21 took {time.perf_counter() - t_start:.1f} s", flush=True)
    return counts


def timed(phase, *args):
    """``phase(*args)``, its wall time added to ``RESULTS["phases"]`` under
    its name and its string arguments."""
    t0 = time.perf_counter()
    out = phase(*args)
    key = " ".join([phase.__name__] + [a for a in args if isinstance(a, str)]) + "_s"
    RESULTS["phases"][key] = RESULTS["phases"].get(key, 0.0) + time.perf_counter() - t0
    return out


def phase_families_and_meta():
    """Phases 19 and 20 together (``--only families``)."""
    timed(phase_meta_families, timed(phase_mesh_families)[1])


ONLY = {"front-door": phase_front_door, "families": phase_families_and_meta,
        "report": phase_report, "decode": phase_decode_kernels, "adamw": phase_adamw}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--details", metavar="PATH", help="write every measurement as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="only time every dos_matmul tiling at the main paths' shapes, and stop")
    ap.add_argument("--only", metavar="PHASES",
                    help="only phases 1-2 and these, comma-separated (front-door: 11, families: "
                         "19 and 20, report: 21, decode: 4's decode attention, adamw: 12's "
                         "AdamW), and stop (no result line)")
    args = ap.parse_args(argv)
    details = args.details
    t0 = time.perf_counter()
    name, count, smi_line = timed(phase_device)
    timed(phase_build)
    if args.sweep or args.only:
        if args.sweep:
            RESULTS["dos_matmul_sweep"] = sweep_dos_matmul()
        else:
            for phase in args.only.split(","):
                timed(ONLY[phase])
            print("[done] wall s by phase: " + ", ".join(f"{k[:-2]} {v:.1f}"
                                                         for k, v in RESULTS["phases"].items()))
        if details:
            with open(details, "w") as f:
                json.dump(RESULTS, f, indent=1)
        return 0
    thermal_cpu = start_thermal_cpu(tempfile.mkdtemp(prefix="chip_smoke_thermal_"))
    atexit.register(_stop, thermal_cpu)
    counts, step_p50_s = {}, {}
    # first, so nothing else holds memory; XLSTM: phase 14's, MOE: phase 15's, VLM and
    # WHISPER: phase 16's
    for arch in PATHS + (XLSTM, MOE, VLM, WHISPER):
        counts[arch], step_p50_s[arch] = timed(phase_main_path, arch)
    counts["train"], train_state, train_p50 = timed(phase_train_path)  # phase 12's main path
    counts[f"train {HYBRID}"], hybrid_state, hybrid_p50 = timed(phase_train_path,
                                                                HYBRID)  # phase 13's
    timed(phase_train_hybrid_profile, hybrid_state, hybrid_p50)
    del hybrid_state  # 29 GB of params and moments
    torch.cuda.empty_cache()
    counts[f"train {XLSTM}"], xlstm_state, xlstm_p50 = timed(phase_train_path,
                                                             XLSTM)  # phase 14's
    timed(phase_train_xlstm_profile, xlstm_state, xlstm_p50)
    del xlstm_state
    torch.cuda.empty_cache()
    counts[f"train {MOE}"], moe_state, moe_p50 = timed(phase_train_path, MOE)  # phase 15's
    timed(phase_train_moe_profile, moe_state, moe_p50)
    del moe_state
    torch.cuda.empty_cache()
    for arch in (VLM, WHISPER):  # phase 16's
        counts[f"train {arch}"], cross_state, cross_p50 = timed(phase_train_cross, arch)
        timed(phase_train_cross_profile, arch, cross_state, cross_p50)
        del cross_state
        torch.cuda.empty_cache()
    launched = {k for c in counts.values() for k, n in c.items() if n > 0}
    check(launched == set(KERNELS), f"kernels no main path launched: {set(KERNELS) - launched}")
    totals, main_err = timed(phase_kernels)
    decode_row, decode_err = timed(phase_decode_kernels)
    for arch in PATHS:
        timed(phase_profile_prefill, arch)
    timed(phase_profile, ARCH, *timed(phase_e2e, ARCH)[0], step_p50_s[ARCH])
    bf16_logits = timed(phase_e2e_blocks, HYBRID)
    f32_logits = timed(phase_e2e, HYBRID, "float32", E2E_F32_TOL)[1]
    sens = ((bf16_logits.float() - f32_logits).abs().max() / f32_logits.abs().max()).item()
    print(f"[e2e] {HYBRID} ({HYBRID_E2E_LAYERS} layers): the CPU's own bf16 and f32 prefill "
          f"logits differ by {sens:.3g} of max|logits| (the model's sensitivity to rounding)")
    RESULTS["hybrid_cpu_bf16_vs_f32"] = sens
    timed(phase_profile, HYBRID, *serve_decode_state(HYBRID), step_p50_s[HYBRID])
    counts["calibration"], cal_err = timed(phase_calibration)
    check(all(counts["calibration"][k] > 0 for k in ("dos_matmul", "flash_attention", "ssm_scan",
                                                     "decode_attention")),
          f"a kernel calibration never launched: {counts['calibration']}")
    timed(phase_engine)
    timed(phase_thermal, thermal_cpu)
    timed(phase_systolic)
    counts["front door calibration"] = timed(phase_front_door)
    bwd_row, bwd_err = timed(phase_train_kernels)
    adamw_row, adamw_err = timed(phase_adamw)
    timed(phase_train_profile, train_state, train_p50)
    del train_state
    torch.cuda.empty_cache()
    timed(phase_train_e2e)
    timed(phase_train_restart)
    ssm_bwd_row, ssm_bwd_err = timed(phase_train_ssm_bwd)
    timed(phase_train_hybrid_learns)
    timed(phase_train_hybrid_e2e)
    timed(phase_train_hybrid_gemms)
    timed(phase_profile_prefill, XLSTM)  # phase 14 from here
    timed(phase_profile, XLSTM, *serve_decode_state(XLSTM), step_p50_s[XLSTM])
    xlstm_rows, xlstm_err = timed(phase_xlstm_kernels)
    timed(phase_xlstm_e2e)
    timed(phase_e2e_blocks, XLSTM)
    timed(phase_profile_prefill, MOE)  # phase 15 from here
    timed(phase_profile, MOE, *serve_decode_state(MOE), step_p50_s[MOE])
    moe_rows, moe_err = timed(phase_moe_kernels)
    timed(phase_moe_e2e)
    timed(phase_moe_train_e2e)
    timed(phase_moe_restart)
    for arch in (VLM, WHISPER):  # phase 16 from here
        timed(phase_profile_prefill, arch)
        timed(phase_profile, arch, *serve_decode_state(arch), step_p50_s[arch])
    cross_err = timed(phase_cross_kernels)
    for arch in (VLM, WHISPER):
        timed(phase_cross_e2e, arch)
        timed(phase_cross_train_e2e, arch)
    timed(phase_clis)  # the CLIs of phases 12-16
    timed(phase_vlm_mixed_dtype)
    timed(phase_mesh)  # phase 17
    parallel_counts, parallel_err = timed(phase_parallel)  # phase 18
    family_err, family_cards = timed(phase_mesh_families)  # phase 19
    timed(phase_meta_families, family_cards)  # phase 20
    counts.update(timed(phase_report))  # phase 21
    counts.update({f"phase 18 {k}": c for k, c in parallel_counts.items()})

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
            "launches": sum(c[kname] for c in counts.values()),
            "max_abs_err": max(main_err[kname], cal_err[kname], xlstm_err.get(kname, 0.0),
                               cross_err.get(kname, 0.0), family_err.get(kname, 0.0)),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": tot["library_ms"],
        })
    n_layers = get_config(ARCH).n_layers  # the flash backward's calls per train step
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/chunked.py:112 (_bwd_rule; a jnp custom "
                    "VJP, not a Pallas kernel)",
        "launches": sum(c["flash_attention_bwd"] for c in counts.values()),
        "max_abs_err": max(bwd_err, cross_err["flash_attention_bwd"],
                           family_err.get("flash_attention_bwd", 0.0)),
        **{k: n_layers * bwd_row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": bwd_row["bound_by"],
    })
    n_mamba = expected_train_launches(get_config(HYBRID))["ssm_scan_bwd"]  # calls per train step
    kernels.append({
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssm_scan/ops.py:26 (autodiff of ssm_scan_chunked_jnp; the "
                    "reference has no backward kernel)",
        "launches": sum(c["ssm_scan_bwd"] for c in counts.values()),
        "max_abs_err": max(ssm_bwd_err, xlstm_err["ssm_scan_bwd"],
                           family_err.get("ssm_scan_bwd", 0.0)),
        **{k: n_mamba * ssm_bwd_row[k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": ssm_bwd_row["bound_by"], "library_ms": None,
    })
    n_slstm = xlstm_block_counts(get_config(XLSTM))[1]  # the recurrence's calls per prefill, step
    fwd_rows = (xlstm_rows["slstm_scan"]["prefill"], xlstm_rows["slstm_scan"]["decode"])
    bwd_row = xlstm_rows["slstm_scan_bwd"]["train"]
    for kname, rows_k, src in (("slstm_scan", fwd_rows, "slstm.cu"),
                               ("slstm_scan_bwd", (bwd_row,), "slstm_bwd.cu")):
        n_bytes, n_ops = (n_slstm * sum(r[k] for r in rows_k) for k in ("bytes", "ops"))
        kernels.append({
            "name": kname, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": "src/repro/models/xlstm.py:149 (slstm_block's step under lax.scan"
                        + ("; its autodiff" if kname == "slstm_scan_bwd" else "")
                        + "; jnp, not a Pallas kernel)",
            "launches": sum(c[kname] for c in counts.values()),
            "max_abs_err": max(xlstm_err[kname], family_err.get(kname, 0.0)),
            **{k: n_slstm * sum(r[k] for r in rows_k) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": ("bytes" if n_bytes / HBM_BYTES_S >= n_ops / PEAK_OPS_S[torch.float32]
                         else "operations"),
            "library_ms": None,
        })
    moe_cfg = get_config(MOE)
    fw, dw = moe_rows["grouped_matmul"], moe_rows["grouped_matmul_dw"]
    per_layer = {  # one prefill plus one decode step: each layer's gate, up and down products
        "grouped_matmul": (moe_cfg.n_layers, [fw[f"{t} {p}"] for t in ("prefill", "decode")
                                              for p in ("gate/up", "gate/up", "down")]),
        # one train step of phase 15's training path: each layer's three dW
        "grouped_matmul_dw": (MOE_TRAIN_LAYERS, [dw["train gate/up"], dw["train gate/up"],
                                                 dw["train down"]]),
    }
    for kname, (n_layers, rows_k) in per_layer.items():
        lib = [r["library_ms"] for r in rows_k]
        n_bytes, n_ops = (n_layers * sum(r[k] for r in rows_k) for k in ("bytes", "ops"))
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/models/moe.py:72-76 (jax.lax.ragged_dot"
                        + ("; its autodiff's dW" if kname == "grouped_matmul_dw" else "")
                        + "; an XLA op, not a Pallas kernel)",
            "launches": sum(c[kname] for c in counts.values()),
            "max_abs_err": max(moe_err[kname], parallel_err[kname], family_err.get(kname, 0.0)),
            **{k: n_layers * sum(r[k] for r in rows_k) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": ("bytes" if n_bytes / HBM_BYTES_S >= n_ops / PEAK_OPS_S[torch.bfloat16]
                         else "operations"),
            "library_ms": None if None in lib else n_layers * sum(lib),
            # launches by variant on phase 15's serving and training paths
            "variants": {v: sum(RESULTS["main_paths"][p]["variants"][kname][v]
                                for p in (MOE, f"train {MOE}"))
                         for v in gmm_ops.VARIANTS},
        })
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/ops.py:106 (decode_attention; jnp "
                    "einsums, not a Pallas kernel)",
        "launches": sum(c["decode_attention"] for c in counts.values()),
        "max_abs_err": max(decode_err, cal_err["decode_attention"],
                           family_err.get("decode_attention", 0.0)),
        **{k: decode_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    kernels.append({
        "name": "adamw", "route": "cuda", "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "src/repro/optim/adamw.py:58 (global_norm and adamw_update; jnp, not a "
                    "Pallas kernel)",
        "launches": sum(c["adamw"] for c in counts.values()),
        "max_abs_err": adamw_err,
        **{k: adamw_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    RESULTS["kernels"] = kernels
    RESULTS["wall_s"] = time.perf_counter() - t0
    if details:
        os.makedirs(os.path.dirname(os.path.abspath(details)), exist_ok=True)
        with open(details, "w") as f:
            json.dump(RESULTS, f, indent=1)
    print(f"[done] {RESULTS['wall_s']:.1f} s; the kernels' launches sum the twelve main paths' "
          "runs (serving and training smollm-135m, zamba2-2.7b, xlstm-125m, deepseek-moe-16b, "
          "llama-3.2-vision-11b and whisper-medium), phase 18's pipeline step and expert-parallel "
          "calls, phase 7's calibration, the front door's calibrate Study and phase 21's "
          "report and examples; max_abs_err is the largest of phase 4's, 7's and 12's to 19's "
          "checks; ms, "
          "plain_ms, library_ms and bound_ms sum the calls of one prefill plus one decode step "
          "of both phase-3 serving paths (dos_matmul, flash_attention, ssm_scan), of xlstm-125m "
          "(slstm_scan) or of deepseek-moe-16b (grouped_matmul), for flash_attention_bwd the "
          "calls of one smollm-135m train step, for ssm_scan_bwd those of one zamba2-2.7b train "
          "step, for slstm_scan_bwd those of one xlstm-125m train step and for "
          "grouped_matmul_dw those of one deepseek-moe-16b train step at "
          f"{MOE_TRAIN_LAYERS} layers, for decode_attention those of one decode step of each "
          "serving path that attends (smollm-135m, zamba2-2.7b, deepseek-moe-16b, "
          "llama-3.2-vision-11b, whisper-medium) and for adamw one smollm-135m train step's "
          "sums of squares and updates (library: torch._fused_adamw_, no clip)")
    print("[done] wall s by phase: " + ", ".join(f"{k[:-2]} {v:.1f}"
                                                 for k, v in RESULTS["phases"].items()))
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
