#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) through its user entry points on
its three paths: the fleet scheduler — ``simulate_fleet`` / ``run_fleet``
/ ``FleetProgram`` at the paper's §8.6 fleet scale (28 edges, 84 drones)
and at a 1024-edge metropolis fleet, and the online control plane
``FleetController`` over it — live DNN serving — the
``ServeEngine`` over the three launcher roles at their published sizes,
and greedy decoding — the hybrid family: zamba2-7b (Mamba2 blocks and
a shared attention block) served and decoded at its published width and
depth — the moe family: qwen3-moe-30b-a3b (128 experts, top-8)
served and decoded at its published width and depth — head dim 192:
nemotron-4-340b at its published width — the encdec family:
whisper-medium served and decoded at its published width and depth —
and the trainer: granite-3-2b trained at its published size.  A served forward on the card
is a CUDA graph, captured once and replayed, and so is a train step
(``TrainProgram``: loss, gradient and AdamW in one graph) and a window
of fleet ticks: ``FleetProgram.step_chunk`` keeps a graph per shape key in its
program cache, runs a key's first window eagerly (the warm-up) and
captures it, and replays it for every later window; the kernel's
launches a replay are counted as its capture recorded them.  Its six
hand-written ``sm_90a`` kernels (masked arg-extremum, flash attention,
flash decode, RMSNorm, selective scan, MoE grouped GEMM) are built from
``src/repro_torch/kernels/csrc`` at first use, one ``nvcc`` each, all
started together.  Flash attention and the grouped GEMM have two bodies:
f32 on the CUDA cores, bf16 on the tensor cores (``mma.sync`` fed by
``cp.async``); the earlier CUDA-core bf16 body is checked and timed
beside it as ``previous``.  So has the selective scan: f32 sequential
on the CUDA cores, bf16 chunked (SSD) on the tensor cores; its earlier
sequential bf16 body is checked and timed beside it as ``previous``.  Flash decode is a split-KV kernel (bf16 on
the tensor cores); its earlier one-block-per-(b, h) body is checked and
timed beside it as ``previous``.  RMSNorm keeps a row in registers
(REGS) for every view on the 16-byte width, and the masked arg-extremum
folds each entry into one 64-bit key (KEY); each one's earlier body is
checked and timed beside it as ``previous``, and every timed row stands
beside the launch floor (a one-element ``fill_``, timed alike).
Phases, each printed on its own line and each failing the script
(non-zero exit) on error:

1. device: card name, ``nvidia-smi`` name and power limit, TF32 flags,
   the six kernels built at once, registers per instantiation;
2. kernels vs their plain PyTorch versions on the card: masked_argext
   exact on both bodies (ties of ±0.0 and enabled scores equal to the
   fill among the cases), timed at (28, 64), (1, 32), (1, 28) and
   (1024, 64) beside its previous body and the floor; flash attention and flash decode on the kernel tests' sweep
   and the serve/decode shapes, hd 64, 112, 128 and 192 (f32 1e-5, bf16
   2e-2), views off the 16-byte width, decode lengths 0 (exactly zero),
   1, W and off the slices, bf16 flash also over every hd × S 1-512 ×
   band × MHA/GQA/MQA;
   RMSNorm (f32 1e-5, bf16 2e-2; every case on the body its plan names,
   views off the 16-byte width on the previous one, and the previous one
   too where REGS took the case; the paths' shapes up to (4096, 2048) and
   (64, 18432)) and the selective scan (f32 2e-4, bf16
   2e-2) on the kernel tests' shapes and the zamba2 path's views (the
   scan also on ragged chunks, S up to 512, N and P 128, B/C per head,
   x at a zero head stride and views off the 16-byte width, which take
   the sequential body; every other bf16 case on both bodies, and the
   chunked one held to the emulation of its arithmetic); the
   grouped GEMM (f32 1e-4, bf16 3e-2 against f32) on the kernel tests'
   sweep, ragged T, the qwen3-moe path's shapes and 0-130 rows an
   expert, with the rows that no expert owns exactly zero; every bf16
   flash and GEMM case on both bodies (tensor cores and previous), every
   aligned decode case on both bodies;
3. small parity (this and phases 4, 9, 19, 20 on the captured program;
   each of them prints its graphs' node counts and capture and
   instantiate seconds, phases 4, 9 and 20 a line a graph, and drops the
   cached programs after it): the 2-edge golden runs (DEMS-A, GEMS,
   DEMS-COOP, SOTA2) on the card as one heterogeneous ``run_batch`` (a
   lane each),
   and alongside it in child processes by ``run_fleet`` each, on the card
   (one child a run) and on the host (two children); every final-state
   leaf equal across the three (a lane cut to its run's models),
   summaries equal to the golden JAX ones;
4. paper-scale fleet (masked_argext's main path; its launches are read
   over this phase, replays counted as their captures recorded them,
   every one on the key body, a graph's too): DEMS-A, GEMS and
   DEMS-COOP, 28 edges × 30 s each, each summary equal to its golden JAX
   entry;
5. model golden: granite-3-2b at full width, 2 layers, f32 — forward,
   prefill and teacher-forced decode against the JAX reference's numbers;
6. serve (flash_attention's main path): HV starcoder2-3b, DEV
   granite-3-2b and BP xlstm-1.3b, published widths and depths, bf16,
   ``attn_impl="kernel"``, each forward a CUDA graph (warm forward under
   ``set_sync_debug_mode("error")``, capture, replays), p95-calibrated,
   under GEMS for 15 s; launches = (warm forward + capture) × the path,
   replays = the forwards run, one replay == an eager forward bitwise
   (here and in phases 7, 13, 16 and 18 every bf16 flash, GEMM and scan
   launch must have taken the tensor cores; in the f32 goldens 5, 12 and
   15 none; in all of them every rmsnorm launch the REGS body);
7. decode (decode_attention's main path): granite-3-2b, bf16, batch 8,
   a 512-token prompt, 64 greedy steps, against ``attn_impl="ref"``.
   Here and in phases 13, 16, 18 and 23 the kernel route's steps run as
   a ``DecodeProgram`` (the counterpart of ``jax.jit(decode_step)``):
   prefilled into its cache, a warm step under
   ``set_sync_debug_mode("error")``, one capture, then replays at a
   device position; the first ``CHECK_REPLAYS`` replays each equal an
   eager step at the int position on a clone of the cache, bitwise
   (logits and cache); launches = prefill + (warm step, capture,
   checks) × the path; reported beside ``EAGER_TIMED`` eager steps of
   the same run: each one's wall p50, one replay's device span (CUDA
   events) and profile, graph nodes and capture seconds (the
   ``decode programs`` line after phase 29 gathers them).  The plain
   and f32 yardsticks stay eager.  Then llava-next-34b (vlm) and
   xlstm-1.3b (ssm) at a reduced size, on both routes, through a
   ``DecodeProgram`` against eager steps;
8. attention kernel times at the serve and decode shapes (granite,
   starcoder2, nemotron), beside the previous bodies', the plain
   versions', ``scaled_dot_product_attention``'s and the bounds;
9. metropolis fleet: DEMS-COOP on 1024 edges, two runs bitwise equal
   (its horizon shrinks to fit the time budget);
10. sync and capture: eager ticks under
    ``torch.cuda.set_sync_debug_mode("error")``, and one traced window of
    a padded, heterogeneous ``run_batch`` batch; then 28-edge DEMS-COOP
    and that batch, traced, without and with ``donate``: every captured
    window (the first the warm-up and capture, the rest replays, also
    under the sync check) equal to the eager one bitwise, state and
    streams;
11. profile: 5 DEMS-COOP ticks at 28 edges eager and as the replay of
    their graph alone, in the order eager, captured, captured, eager:
    device operations a tick equal between the two and to the graph's
    nodes a tick (within the profiler's dropped records), each one's busy
    share and ticks/s, then ticks/s and host enqueue time without the
    profiler, the arg-extremum kernel's time per launch, and the nearest
    plain PyTorch composition's time;
12. hybrid golden: zamba2-7b at full width, 8 layers (6 Mamba2, the
    shared block, a 2-layer tail), f32 — forward on S 256, prefill and
    teacher-forced decode against the JAX reference's numbers;
13. hybrid serve and decode (rmsnorm's and ssm_scan's main path; every
    model kernel's launches are read over this phase and must equal the
    path's exactly): zamba2-7b at 81 layers, bf16, ``"kernel"`` —
    ``ServableModel.from_arch`` (a CUDA graph) with ``probe_p95``, a 10 s
    GEMS stream, then a 128-token prompt and 32 greedy steps against
    ``"ref"`` and f32; after the counts are read, the served forward
    captured once with each bf16 scan body (chunked, previous) and once
    with each rmsnorm body (REGS, previous), each pair timed in this call
    (order new, previous, previous, new: p95 and the busy ms of one
    replay);
14. kernel times: RMSNorm at every path shape (``RMS_SHAPES``, the
    prefill ones also with inputs that miss the L2) beside its previous
    body, its plain version, ``torch.nn.functional.rms_norm``, its plan
    and registers; the zamba2 path's selective scan and the two
    attention kernels at hd 112 (each beside its previous body); the
    floor and a one-element ``copy_`` (a launch that loads, then
    stores);
15. moe golden: qwen3-moe-30b-a3b at full width, 2 layers, f32 — forward
    on (B 2, S 128) (capacity 21: pairs drop), prefill and teacher-forced
    decode against the JAX reference's numbers;
16. moe serve and decode (moe_gemm's main path; every model kernel's
    launches are read over this phase and must equal the path's
    exactly: 144 ``moe_gemm`` a forward, prefill or step): qwen3-moe at
    48 layers, bf16 (61 GB of the card), ``"kernel"`` —
    ``ServableModel.from_arch`` (a CUDA graph) with ``probe_p95``, a 10 s
    GEMS stream, one forward under ``set_sync_debug_mode("error")``, B 8
    greedy
    decoding against ``"ref"`` (relative RMS, and routing agreement per
    layer over the prefill and the eager steps: a replay never calls the
    router), then an f32 copy at 8 layers on both routes;
17. ``moe_gemm``'s times at the serve, decode and prefill shapes and a
    compacted ragged one, beside its previous CUDA-core bf16 body, its
    plain version, ``torch.bmm`` and ``torch._grouped_mm``;
18. hd 192 on the path: nemotron-4-340b at its published width, 2 layers,
    bf16, ``"kernel"`` — a (B 1, S 64) forward, a prefill and 8 greedy
    steps against ``"ref"`` on the same weights; flash and decode
    launches exactly the path's;
19. registry scenarios through the port alone, run right after phase 4
    (the scenario path: ``masked_argext``'s counts are read over this
    phase, every launch on the key body, at least one a run):
    ``hetero-edges``, ``duration-jitter`` and ``heavy-tail`` under DEMS,
    GEMS-A and DEMS-COOP, a short ``partition`` (link partition and edge
    crash) under DEMS-COOP and a short ``brownout`` under GEMS-A, each at
    its registry width — the spec rebuilt by the port's registry,
    compiled on the card by the port's ``compile_fleet`` (every field's
    SHA-256 equal to the JAX compiler's), run on the card by
    ``run_scenario_fleet`` (integer summary fields exactly the JAX ones,
    utilities within 1e-6 relative / 1e-4 absolute) and on the host by
    ``run_scenario_oracle`` (merged results exactly the JAX oracle's);
20. the batched, traced sweep through the port alone, right after phase
    19 (``masked_argext``'s counts are read over this phase, every launch
    on the key body): ``run_registry_sweep`` over all 14 registry
    scenarios at their registry widths, the horizon cut to 10 s, × DEMS,
    GEMS-A, DEMS-COOP and SJF-E+C, seed 0, ``TraceSpec.full()``, under
    both planners (exact-shape buckets, one padded batch); every row's
    summary, ``tail_metrics``, stream sums and stream digests equal to
    ``tests/golden/torch_port_sweep.json`` (histogram percentiles to one
    bin where the scenario scales durations), ``check_conservation`` on
    every row, the two planners' rows bitwise equal, an untraced padded
    batch's final state bitwise the traced one's; then the paper-width
    seed batch, ``run_fleet_batch`` of 28 edges × 3 drones × 4 seeds,
    DEMS-COOP, traced, every lane against the golden and lane 0 bitwise
    against ``run_fleet`` of seed 0; edge-ticks/s of each beside phase
    19's, and the traced/untraced ratio of one padded batch;
21. the online control plane, right after phase 11: (a) phase 19's runs
    streamed through ``FleetController`` in windows of 16 and of 7
    ticks, each final state bitwise phase 19's replay; (b) a paper-scale
    controller (28 edges, windows of 8 ticks, DEMS-COOP, traced) on 30 s
    of the paper's stream: step-latency p50/p95/p99 and mission over
    wall time, captured, then eager on its first 5 s; (c) kill and
    restore: (b)'s checkpoint at 15 s restored into a fresh controller
    finishes bitwise (b)'s final state; (d) ``python -m
    repro_torch.launch.serve --backend fleet`` on the card in a child
    process writes its snapshot;
22. encdec golden, after phase 18: whisper-medium at full width (d 1024,
    16 heads, hd 64, d_ff 4096, vocab 51865, 1,500 frames), 2 encoder and
    2 decoder layers, f32, on ``"kernel"`` — forward on (B 2, S 64) over
    frames N(0, 1) from the file's seed, a 48-token prefill and 8
    teacher-forced decode steps against the JAX reference's ``"ref"``
    numbers (its ``"pallas"`` route cannot take 1,500 frames);
23. encdec serve and decode (every model kernel's launches are read over
    this phase and must equal the path's exactly: 48 flash and 122
    rmsnorm a forward, 24 flash decode and 73 rmsnorm a step):
    whisper-medium at 24 + 24 layers, bf16, ``"kernel"`` —
    ``ServableModel.from_arch`` with its zero frames (a CUDA graph) with
    ``probe_p95``, a 5 s GEMS stream, then a 48-token prompt over random
    frames and 16 greedy steps against ``"ref"`` and f32; flash attention
    at the encoder's (1, 16, 1500, 64) non-causal shape and flash decode
    at (B 8, W 448, length 440) timed as in phase 8;
24. the trainer, on ``"ref"`` (no model kernel may launch): (a)
    granite-3-2b at full width, 2 layers, f32, 4 AdamW steps at B 2 × S
    64 against ``tests/golden/torch_port_train.json`` (the step-0 loss
    and gradient norm within 1e-5 relative, later losses and the final
    parameters' sums within 1e-3), and a ``TrainProgram`` (a warm step,
    then replays of its captured step) on the same weights and batches
    bitwise those eager steps; (c) the same loss on ``"kernel"`` with
    parameters that require grad raises the dispatch's forward-only
    error; (b) granite-3-2b at its published size, 10 steps at B 8 × S
    128, first eagerly (``make_train_step`` on ``train``'s init and
    batches), then freed and run again through ``train`` as ``python -m
    repro_torch.launch.train --full`` runs it (captured): the losses
    bitwise the eager ones, every loss finite and the last below the
    first; eager step p50 and captured replay p50, tokens/s and peak
    memory, capture seconds and graph nodes, a profile of one more eager
    step and of one more replay; (d) each of the 10 archs' reduced
    variants, 3 eager steps against a warm step and 2 replays, losses,
    parameters, moments and step count bitwise;
25. the fleet under a mesh at world size 1 (``make_host_mesh()``: one
    ``nccl`` rank, a ``(1, 1)`` mesh): phase 20's 28-edge × 4-seed
    ``run_fleet_batch`` and its padded ``run_batch`` under a ``(1, 1)``
    ``("replica", "edge")`` mesh, ``run_registry_sweep(mesh="auto")`` and
    the paper-scale DEMS-COOP ``run_fleet(mesh=)``, each bitwise equal to
    the unsharded call (phase 20's golden-checked results, phase 4's
    golden summary); the mesh runs capture no graph of their own and
    launch what the unsharded runs launch (a size-1 axis splits nothing);
26. ``opt_decode``: qwen2-72b at published width, 2 layers, bf16,
    ``"kernel"``, B 8 from a 512-token prefill, 16 greedy steps under
    ``sharding_rules(host mesh)``, the sharded flash-decode against the
    base step (the decode kernel) on the same tokens: layer 0's cache
    bitwise (its inputs are the same), every layer's and the logits
    within ``OPT_DECODE_TOL`` of the base's; base and opt step times;
27. ``expert_split``: grok-1-314b at published width, 2 layers, bf16
    (about 16 GB of weights), ``"kernel"``: a (B 1, S 64) forward and a
    prefill with ``expert_split=2`` on the same weights rearranged,
    against ``expert_split=1`` within ``MOE_TOL["bfloat16"]``;
    ``moe_gemm``'s launches are read over the phase and must equal the
    path's (2 a layer unsplit, 3 split: one up launch a split on the
    strided view, one down); ``moe_gemm`` timed at grok's split and
    unsplit shapes beside ``torch.bmm`` and the byte bound;
28. remat ``"dots"``: phase 24 (b)'s configuration (granite-3-2b, 40
    layers, B 8 × S 128, lr 3e-4) trained under ``"dots"`` through
    ``train`` (captured; its warm step is its eager step): losses equal
    to (b)'s captured ones under ``"full"``, capture seconds and nodes,
    replay p50, tokens/s and peak memory beside (b)'s;
29. the dry run: ``python -m repro_torch.launch.dryrun --arch
    granite-3-2b --shape train_4k --mesh single`` and ``--shape
    decode_32k``, each combo and its roofline ok (fake ranks; they pass
    on the host), the memory plan's argument, output, temp and alias
    bytes and its verdict printed (train_4k must fit 80 GB), the terms
    and the bottleneck printed; and a child tracing the reduced combos
    that once failed to trace (qwen3-moe-30b-a3b × train_4k, prefill_32k,
    decode_32k, xlstm-1.3b and zamba2-7b × train_4k) on a (2, 2) fake
    mesh, each ok with the JAX dry run's argument bytes
    (``tests/golden/torch_port_dryrun.json``) on this machine's torch.

The expected numbers come from ``tests/golden/torch_port_summaries.json``
(phase 19's under its ``scenario_runs`` key),
``tests/golden/torch_port_sweep.json`` (phase 20's),
``tests/golden/torch_port_model.json``,
``tests/golden/torch_port_zamba2.json``,
``tests/golden/torch_port_qwen3moe.json``,
``tests/golden/torch_port_whisper.json`` and
``tests/golden/torch_port_train.json`` (JAX results written by
``tests/golden/regen_torch_port_{summaries,model,sweep}.py``); the script
imports nothing of the JAX package.  Its last two lines are the
``kernels`` JSON record and ``{"ok": true, "device": {...}}``.
"""
import atexit
import dataclasses
import itertools
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_summaries.json")
GOLDEN_MODEL = os.path.join(ROOT, "tests", "golden", "torch_port_model.json")
GOLDEN_ZAMBA2 = os.path.join(ROOT, "tests", "golden",
                             "torch_port_zamba2.json")
GOLDEN_QWEN3MOE = os.path.join(ROOT, "tests", "golden",
                               "torch_port_qwen3moe.json")
GOLDEN_SWEEP = os.path.join(ROOT, "tests", "golden", "torch_port_sweep.json")
GOLDEN_WHISPER = os.path.join(ROOT, "tests", "golden",
                              "torch_port_whisper.json")
GOLDEN_TRAIN = os.path.join(ROOT, "tests", "golden", "torch_port_train.json")
METRO_EDGES = 1024
METRO_MS = 60_000.0
METRO_TICK_FACTOR = 2.0
# phase 9's horizon shrinks (never below MIN_METRO_MS) when the phases
# before it ran so slowly that the whole script, with RESERVE_S left for
# phases 10-18 and 21 (266 s on an H100, the fleet on the captured
# program: PERF.md), 22-24 (about 110 s, the encdec family and the
# trainer, eager and captured) and 25-29 (about 120 s: the mesh runs, opt_decode, the split
# experts, remat "dots", and what the dry run's children take past
# them), would pass this budget
BUDGET_S = 850.0
RESERVE_S = 550.0
MIN_METRO_MS = 5_000.0
SYNC_TICKS = 50
# phase 10: captured windows held to the eager ones, CHECK_WINDOWS of
# CHECK_TICKS ticks each
CHECK_TICKS = 10
CHECK_WINDOWS = 3
# phase 21: the paper-scale controller's mission, the eager controller's
# share of it, and the launcher's fleet backend in a child process
CONTROLLER_MS = 30_000.0
EAGER_CONTROLLER_MS = 5_000.0
SERVE_FLEET_S = 3.0
# the profiler's post-processing takes seconds per traced tick (thousands
# of kernels each, about 1.7 s a tick on the H100 host), so the profile
# covers a short steady window; it drops a record now and then (up to 7
# of 33,860 in a 10-tick window), so operations a tick may part from the
# graph's nodes a tick by this share
PROFILE_TICKS = 5
PROFILE_SLACK = 1e-3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, at 700 W
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores, same sheet
BF16_OPS_PER_S = 989e12          # bf16 dense tensor cores, same sheet
# the kernels' tolerances against their plain versions, as
# tests/test_kernels.py states them: |got - want| <= atol + rtol * |want|
ATT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# rmsnorm's (rows, D) on the served paths, timed in phase 14: zamba2-7b
# decode, serve and prefill; granite-3-2b serve, decode and prefill (B 2
# and B 8 × 512); starcoder2-3b serve; nemotron-4-340b serve
RMS_SHAPES = ((1, 3584), (64, 3584), (128, 3584), (64, 2048), (8, 2048),
              (1024, 2048), (4096, 2048), (64, 3072), (64, 18432))
# the scan sums a state over up to 512 steps in another order than the
# plain recurrence: tests/test_kernels.py's 2e-4 in f32
SCAN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# the grouped GEMM: tests/test_kernels.py's 1e-4 in f32, and 3e-2 for
# bf16 against the f32 plain version of the same (bf16) inputs
MOE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# model golden (f32, TF32 off): the card and the host's XLA sum in other
# orders; logits are O(1), so 1e-3 is ~100x the f32 rounding seen over
# two layers, and a row checksum of 49,155 logits gets 5e-2
GOLD_TOL = 1e-3
GOLD_SUM_TOL = 5e-2
# phase 2's decode shapes (B, H, KV, W, hd): the kernel tests' sweep,
# the path's (granite, starcoder2, zamba2, nemotron-4-340b) and GQA
# groups of 12 over MQA, MHA and 20 heads (two head tiles) at hd 192 and
# 64; each at lengths 0, 1, W and values off the 64-row slices, on the
# model's aligned cache views and on two views off the 16-byte width
DECODE_SWEEP = ((2, 4, 4, 512, 64), (3, 8, 2, 1024, 64), (1, 4, 1, 256, 128),
                (8, 32, 8, 1024, 64), (1, 24, 2, 128, 128),
                (1, 32, 32, 160, 112), (2, 8, 2, 512, 112),
                (2, 96, 8, 300, 192), (1, 12, 1, 200, 192),
                (2, 16, 16, 64, 192), (1, 40, 2, 100, 64))
SERVE_MS = 15_000.0
DECODE = dict(batch=8, prompt=512, max_seq=1024, steps=64, seed=11)
# the kernel route's greedy steps in phases 7, 13, 16, 18 and 23 run as a
# DecodeProgram: a warm step, the capture, then replays; the first
# CHECK_REPLAYS replays are each held bitwise to an eager step at the int
# position on a clone of the cache before it, and EAGER_TIMED eager steps
# are timed beside the replays after the launches are read
CHECK_REPLAYS = 3
EAGER_TIMED = 8
# and their prompts run as a PrefillProgram over the DecodeProgram's
# cache: a warm prefill and the capture, then one replay held bitwise to
# the warm prefill (logits and every cache leaf); after the launches are
# read, PREFILL_TIMED replays and PREFILL_TIMED eager prefills (a fresh
# cache each) are timed in the same run
PREFILL_TIMED = 5
# phase 7 also runs the families no other phase decodes on the card
# (vlm, ssm) through a DecodeProgram at a reduced size whose head dim the
# decode kernel takes (d 256 over 4 heads: hd 64), on both routes
REDUCED_DECODE = dict(archs=("llava-next-34b", "xlstm-1.3b"), d_model=256,
                      batch=2, prompt=12, max_seq=16, steps=8, seed=7)
# decode under "kernel" vs "ref" in bf16: the kernel keeps probabilities
# in f32 where the plain path rounds them to bf16, and 40 layers of bf16
# residual adds carry either rounding on, so the yardstick is the plain
# bf16 path's own distance rf from an f32 run of the same weights (RMS of
# the logit difference over RMS of the f32 logits).  Two paths each rf
# from f32 differ by about sqrt(2)·rf: kernel vs plain is held to 2·rf,
# and kernel vs f32 to 1.5·rf (the kernel is no less accurate).
DECODE_KR_TOL = 2.0
DECODE_KF_TOL = 1.5
# The same f32 model on its two routes ("kernel" vs "ref", teacher-forced
# on the same tokens) isolates the kernels from bf16: at 81 random-weight
# layers zamba2's bf16 logits decorrelate from f32 on either route (the
# JAX package's bf16 chunked scan as much as the port's plain path), while
# f32 rounding differences stayed below 1e-3 of the logits' RMS in the
# host's 48-layer runs.  A wrong kernel is O(1) off; 5e-2 is the bar.
DECODE_F32_TOL = 5e-2
# phase 13: zamba2-7b served as one role (the launcher's HV share,
# deadline multiple, β and costs) at (B 1, S 64) for 10 s, then decoded
# from a 128-token prompt for 32 greedy steps; the same yardsticks
ZAMBA2 = dict(seq=64, share=0.7, deadline_p95=3.0, beta=125, cost_edge=1,
              cost_cloud=25, serve_ms=10_000.0, prompt=128, max_seq=160,
              steps=32, seed=13)
# phase 16: qwen3-moe-30b-a3b (48 layers, bf16, 61 GB) served as one role
# as zamba2 is, then decoded at B 8 from a 128-token prompt for 32 greedy
# steps against "ref" on the same weights; then an f32 copy cut to
# f32_layers layers (22.4 GB; 48 f32 layers would need 122 GB) decoded
# on both routes, held to DECODE_F32_TOL
QWEN3MOE = dict(ZAMBA2, batch=8, prompt=128, max_seq=160, steps=32,
                seed=14, f32_layers=8)
# phase 18: nemotron-4-340b (hd 192) at published width, 2 layers (about
# 33 GB of bf16 weights; 96 would be 680 GB), a 64-token prompt and 8
# greedy steps.  Held to its "ref" route on the same weights: at 2
# layers the two differ by the kernels' rounding alone (f32
# probabilities where the plain path rounds them to bf16, the fused
# RMSNorm's one rounding), so the attention kernels' bf16 tolerance,
# 2e-2, bounds the relative RMS of the logit difference.
NEMOTRON = dict(layers=2, seq=64, steps=8, seed=18)
NEMOTRON_TOL = 2e-2
# phase 23: whisper-medium (24 + 24 layers, bf16) served as one role as
# zamba2 is, at (B 1, S 64) beside its 1,500 zero frames, for 5 s; then
# decoded from a 48-token prompt over random frames for 16 greedy steps
# against "ref" and f32; the yardsticks of phase 7
WHISPER = dict(ZAMBA2, serve_ms=5_000.0, prompt=48, max_seq=64, steps=16,
               seed=23)
# phase 24: the trainer.  (a) the training golden: the step-0 loss and
# gradient norm within TRAIN_TOL relative (f32, TF32 off: the card and
# the host's XLA sum in other orders, ~1e-7 relative), each later loss
# within TRAIN_STEP_TOL (AdamW's normalised step turns that rounding
# into a step of up to lr where a gradient is near zero, and the steps
# after it see those weights); each final leaf's sum of squares within
# TRAIN_STEP_TOL relative, its sum within TRAIN_STEP_TOL of its L2 norm
# times sqrt(numel) (a sum of values of either sign has no scale of its
# own).  (b) launch/train's --full path: granite-3-2b at its published
# size (bf16 parameters, f32 moments, remat) for 10 steps at B 8 × S 128,
# at lr 3e-4 (AdamW's own default): the launcher's default of 3e-3 is
# sized for the reduced variants, and at 40 layers its first steps
# overshoot (the loss went 11.21 → 10.43 → 12.16 and ended at 12.71
# after 10 steps on the H100; PERF.md)
TRAIN_TOL = 1e-5
TRAIN_STEP_TOL = 1e-3
TRAIN_FULL = dict(arch="granite-3-2b", steps=10, batch=8, seq=128, lr=3e-4)
# phase 26: opt_decode on qwen2-72b; the logits of the sharded
# flash-decode against the base step's, relative to the base's largest
# (bf16: the two attentions round apart, and layer 1 inherits it); then
# an f32 copy held to the JAX test's limits, |Δ| <= tol + tol·|want|
# (logits 2e-3, cache 1e-5), which a step that lost a key would miss
OPT_DECODE = dict(arch="qwen2-72b", layers=2, batch=8, prompt=512,
                  steps=16, seed=26)
OPT_DECODE_TOL = 2e-2
OPT_DECODE_F32_TOL = {"logits": 2e-3, "cache": 1e-5}
# phase 27: the split-expert layout on grok-1-314b
SPLIT = dict(arch="grok-1-314b", layers=2, split=2, seq=64, seed=27)
# phase 28: remat "dots" losses against "full" (bitwise expected)
DOTS_TOL = 1e-6
# phase 29: the dry run's combos (fake ranks; host work only)
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_TIMEOUT_S = 300
DRYRUN_REDUCED = (("qwen3-moe-30b-a3b", "train_4k"),
                  ("qwen3-moe-30b-a3b", "prefill_32k"),
                  ("qwen3-moe-30b-a3b", "decode_32k"),
                  ("xlstm-1.3b", "train_4k"), ("zamba2-7b", "train_4k"))
# phase 19: a fleet summary's float fields against the JAX one, the
# parity tolerance of tests/_torch_parity.py (XLA on the host fuses a
# product and a sum into one multiply-add where the port rounds twice,
# so utilities may part in the last bits); integer fields are exact
SUMMARY_RTOL, SUMMARY_ATOL = 1e-6, 1e-4
SUMMARY_FLOATS = ("qos_utility", "qoe_utility", "completion_rate")
# phase 20: the tail metrics' utilities and the f32 streams' sums are held
# like a summary's floats; the histogram percentiles exactly, or to one
# bin width where the run's signals scale durations (exec_jit, load_mult)
TAIL_FLOATS = ("qos_utility", "qoe_utility", "qos", "qoe")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def leaves(tree):
    if isinstance(tree, tuple):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def _short_name(mangled: str) -> str:
    """``kernel<args>`` from an entry function's mangled name: enough of
    the Itanium scheme for this repo's kernels (nested names such as
    nvcc's hashed anonymous namespace, and int, bool, float and
    named-type template arguments)."""
    if not mangled.startswith("_Z"):
        return mangled[:48]
    i = 2
    nested = mangled[i:i + 1] == "N"
    i += nested
    name = None
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        i += len(n)
        name = mangled[i:i + int(n)]
        i += int(n)
        if not nested:
            break
    if name is None:
        return mangled[:48]
    args = []
    if mangled[i:i + 1] == "I":
        i += 1
        while i < len(mangled) and mangled[i] != "E":
            if mangled[i] == "L":
                j = mangled.index("E", i)
                lit = mangled[i + 2:j]
                args.append(lit if mangled[i + 1] == "i"
                            else ("true" if lit == "1" else "false"))
                i = j + 1
            elif mangled[i] == "f":
                args.append("float")
                i += 1
            elif mangled[i] == "S":      # a substitution: this repo's
                j = mangled.index("_", i)    # templates repeat the last
                args.append(next((a for a in reversed(args)   # named type
                                  if not a.isdigit()), "?"))
                i = j + 1
            elif mangled[i].isdigit():
                n = re.match(r"\d+", mangled[i:]).group()
                i += len(n)
                args.append(mangled[i:i + int(n)].replace("__nv_", ""))
                i += int(n)
            else:
                break
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_rows(text: str) -> list:
    """One ``kernel<args>: registers, barriers, shared memory[, spills]``
    entry per entry function of ``nvcc -Xptxas -v``'s output."""
    rows, name, spill = [], None, "0"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = _short_name(m.group(1)), "0"
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        if "Used" in ln and name:
            rows.append(f"{name}: {ln.split('Used ')[-1].strip()}"
                        + (f", {spill} B spill stores" if spill != "0"
                           else ""))
            name = None
    return rows


def scenario_spec(entry: dict):
    """A phase-19 golden entry's ``ScenarioSpec``: the port's registry
    scenario cut to the entry's horizon, plus the fault schedule the
    entry spells out in JSON (``FaultSpec`` field → the faults' keyword
    arguments, lists as tuples)."""
    from repro_torch import faults
    from repro_torch.scenarios import registry
    spec = registry.get(entry["scenario"], duration_ms=entry["duration_ms"])
    if entry["faults"] is None:
        return spec
    kinds = dict(crashes=faults.EdgeCrash, partitions=faults.Partition,
                 jamming=faults.Jamming, brownouts=faults.Brownout,
                 floods=faults.Flood)
    return dataclasses.replace(spec, faults=faults.FaultSpec(**{
        field: tuple(kinds[field](**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in f.items()})
                     for f in fs)
        for field, fs in entry["faults"].items()}))


def summary_mismatch(got: dict, want: dict) -> list:
    """The fields of a fleet summary off the golden one: an integer field
    unequal, or a float one outside SUMMARY_RTOL / SUMMARY_ATOL."""
    bad = []
    for key, w in want.items():
        g = got[key]
        ok = (abs(g - w) <= SUMMARY_ATOL + SUMMARY_RTOL * abs(w)
              if key in SUMMARY_FLOATS else g == w)
        if not ok:
            bad.append(f"{key} {g} != {w}")
    return bad if set(got) == set(want) else bad + ["fields differ"]


def phase_scenarios(golden: dict) -> dict:
    """Phase 19: registry scenarios through the port alone.  Each entry's
    spec is rebuilt by the port's registry, compiled on the card by the
    port's ``compile_fleet`` (every field's SHA-256 from its host copy
    equal to the JAX compiler's), run on the card by
    ``run_scenario_fleet`` (its ``fleet_summary`` against the JAX one),
    and run on the host by the port's ``run_scenario_oracle`` (its merged
    results exactly the JAX oracle's).  ``masked_argext``'s counts are
    set to 0 before the phase and read after it, every launch on the
    key body and at least one a run.  Returns the phase's numbers."""
    import torch
    from repro_torch.kernels import sched_ops
    from repro_torch.scenarios.compile import compile_fleet, signal_digests
    from repro_torch.scenarios.runner import (fleet_summary,
                                              run_scenario_fleet,
                                              run_scenario_oracle)
    dt = golden["dt"]
    rows = {}
    sched_ops.reset_count()
    t_phase = time.perf_counter()
    for entry in golden["scenario_runs"]:
        name = entry["name"]
        spec = scenario_spec(entry)
        t0 = time.perf_counter()
        sig = compile_fleet(spec, dt, device="cuda")
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        digests = signal_digests(sig)
        off = sorted(k for k in digests
                     if digests[k] != entry["digests"].get(k))
        if off or set(digests) != set(entry["digests"]):
            fail(f"phase 19 {name}: signal fields {off} differ from the JAX "
                 f"compiler's")
        ticks = int(sig.times.shape[0])
        del sig
        before, key_before = sched_ops.launch_counts()
        t0 = time.perf_counter()
        final = run_scenario_fleet(spec, entry["policy"], dt=dt,
                                   device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, key = sched_ops.launch_counts()
        launches -= before
        if launches <= 0:
            fail(f"phase 19 {name}: no masked_argext launch")
        if key - key_before != launches:
            fail(f"phase 19 {name}: a masked_argext launch missed the key "
                 f"body")
        summ = fleet_summary(final)
        bad = summary_mismatch(summ, entry["summary"])
        if bad:
            fail(f"phase 19 {name}: summary off the golden: {bad}")
        t0 = time.perf_counter()
        merged = run_scenario_oracle(spec, entry["policy"], dt=dt).merged
        oracle_s = time.perf_counter() - t0
        oracle = {k: getattr(merged, k) for k in entry["oracle"]}
        if oracle != entry["oracle"]:
            fail(f"phase 19 {name}: oracle {oracle} != golden "
                 f"{entry['oracle']}")
        # run_scenario_fleet compiles the signals again on the host: its
        # card seconds are its wall less one compile
        card_s = run_s - compile_s
        rows[name] = dict(compile_s=compile_s, card_s=card_s, ticks=ticks,
                          edges=spec.n_edges, ticks_per_s=ticks / card_s,
                          launches=launches,
                          launches_per_tick=launches / ticks,
                          oracle_s=oracle_s,
                          final=[a.cpu() for a in leaves(final)])
        say(f"phase19 {name}: digests == JAX compiler's; summary == golden "
            f"{json.dumps(summ)}; oracle == JAX oracle's; compile "
            f"{compile_s:.4f} s, card {card_s:.3f} s for {ticks} ticks × "
            f"{spec.n_edges} edges = {ticks / card_s:.2f} ticks/s, oracle "
            f"{oracle_s:.3f} s; fleet − oracle: completed "
            f"{summ['completed'] - oracle['completed']}, QoS "
            f"{summ['qos_utility'] - oracle['qos_utility']:.1f}; "
            f"masked_argext {launches} launches "
            f"({launches / ticks:.1f} a tick), every one on the key body")
    launches, key = sched_ops.launch_counts()
    if key != launches:
        fail("phase 19: a masked_argext launch missed the key body")
    say(f"phase19 done: {len(rows)} runs in "
        f"{time.perf_counter() - t_phase:.1f} s; masked_argext {launches} "
        f"launches, every one on the key body")
    return dict(runs=rows, launches=launches)


def models_of(spec: str):
    """``PASSIVE`` / ``ACTIVE`` Table-1 sets or ``WLn@alpha`` (Table 2)."""
    from repro_torch.core import task
    if spec in ("PASSIVE", "ACTIVE"):
        names = task.PASSIVE if spec == "PASSIVE" else task.ACTIVE
        return [task.TABLE1[n] for n in names]
    wl, alpha = spec.split("@")
    return task.table2(wl, float(alpha))


def golden_signals(golden: dict, run: dict, device, n_edges=None,
                   duration_ms=None):
    """A golden run's ``default_signals`` (edges and horizon overridable)."""
    from repro_torch.sim import fleet as F
    from repro_torch.sim import network
    th = run["theta"]
    return F.default_signals(
        len(models_of(run["models"])), n_edges=n_edges or run["n_edges"],
        drones_per_edge=golden["drones_per_edge"],
        duration_ms=duration_ms or run["duration_ms"], dt=golden["dt"],
        theta_fn=None if th is None else network.trapezium(
            ramp_up=tuple(th["ramp_up"]), ramp_down=tuple(th["ramp_down"])),
        seed=golden["seed"], device=device)


def golden_run(golden: dict, run: dict, sig, device):
    """A golden run through ``run_fleet`` on ``device``."""
    from repro_torch.sim import fleet as F
    return F.run_fleet(models_of(run["models"]), run["policy"], sig,
                       dt=golden["dt"], edge_frac=golden["edge_frac"],
                       cloud_frac=golden["cloud_frac"],
                       cloud_slots=golden["cloud_slots"], device=device)


# state leaves whose last axis is the model axis (the estimator buffer has
# it second to last): phase 3 cuts a batch lane's to its run's models
MODEL_LAST = ("n_success", "n_miss", "n_drop", "n_stolen", "n_edge_exec",
              "lam", "lam_hat", "prev_lam", "win_end", "windows_met",
              "count", "idx", "current", "cooling_start")


def named_leaves(tree, name: str = ""):
    """``(field name, leaf)`` pairs of a state tree, in order."""
    if isinstance(tree, tuple):
        for field, v in zip(tree._fields, tree):
            yield from named_leaves(v, field)
    else:
        yield name, tree


def cut_models(name: str, a, m: int):
    """Leaf ``name`` of one lane with its model axis cut to ``m``."""
    if name in MODEL_LAST:
        return a[..., :m]
    return a[..., :m, :] if name == "buf" else a


def small_run(golden: dict, name: str, device: str) -> tuple:
    """One of phase 3's runs through ``run_fleet`` on ``device``, in a
    child process while the card runs the batch: one intra-op thread (the
    tensors are tiny, and the host's cores are shared); the final state's
    leaves as numpy arrays and the run's seconds."""
    sys.path.insert(0, SRC)
    import torch
    torch.set_num_threads(1)
    run = next(r for r in golden["runs"] if r["name"] == name)
    t0 = time.perf_counter()
    final = [a.cpu().numpy() for _, a in named_leaves(golden_run(
        golden, run, golden_signals(golden, run, device), device))]
    return final, time.perf_counter() - t0


def phase_small(golden: dict) -> None:
    """Phase 3: the four 2-edge golden runs, three ways at once.  The card
    runs them as one heterogeneous batch (a lane each, tables padded to
    the widest); alongside, child processes run each through
    ``run_fleet``, on the card (one child a run) and on the host (two
    children).  Every leaf of a card run and of a lane, cut to its run's
    models, must equal the host run's, and each lane's summary the golden
    one."""
    import numpy as np
    import torch
    from repro_torch.scenarios.runner import fleet_summary_batch
    from repro_torch.sim import fleet as F
    small = [r for r in golden["runs"] if r["phase"] == 3]
    # the four card children first: each holds a worker to the end, while
    # the host's four runs share the remaining two
    jobs = [(golden, r["name"], d) for d in ("cuda", "cpu") for r in small]
    with multiprocessing.get_context("spawn").Pool(len(small) + 2) as pool:
        t_children = time.perf_counter()
        pending = pool.starmap_async(small_run, jobs, chunksize=1)
        batch = F.build_fleet_batch(
            [(models_of(r["models"]), r["policy"],
              golden_signals(golden, r, "cpu"), golden["cloud_slots"])
             for r in small], dt=golden["dt"], device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = F.run_batch(batch, dt=golden["dt"],
                           edge_frac=golden["edge_frac"],
                           cloud_frac=golden["cloud_frac"])
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        done = pending.get(timeout=1200)
        children_s = time.perf_counter() - t_children
    runs = {(d, n): res for (_, n, d), res in zip(jobs, done)}
    for r, (run, summ) in enumerate(zip(small, fleet_summary_batch(card))):
        m = len(models_of(run["models"]))
        host, host_s = runs["cpu", run["name"]]
        own, own_s = runs["cuda", run["name"]]
        lane = [cut_models(n, a[r], m).cpu().numpy()
                for n, a in named_leaves(card)]

        def same(a, b):
            return len(a) == len(b) and all(
                x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(a, b))

        if not same(own, host):
            fail(f"{run['name']}: card and host run_fleet final states "
                 f"differ")
        if not same(lane, host):
            fail(f"{run['name']}: batch lane {r} and host run_fleet final "
                 f"states differ")
        if summ != run["summary"]:
            fail(f"{run['name']}: summary {summ} != golden "
                 f"{run['summary']}")
        say(f"phase3 {run['name']}: card run_fleet == card lane {r} of one "
            f"run_batch == host run_fleet (every leaf), summary == golden; "
            f"card run_fleet {own_s:.2f} s, host {host_s:.2f} s (children)")
    say(f"phase3 card: the four runs as one run_batch, {batch_s:.2f} s; "
        f"the eight run_fleet children alongside, {children_s:.2f} s")


def tail_mismatch(got, want, bin_ms: float, path: str = "") -> list:
    """Where a traced run's numbers (``tail_metrics`` or ``stream_sums``)
    leave the golden ones: integers and host-computed rates exactly (a
    golden ``None`` is NaN), the utilities within SUMMARY_RTOL /
    SUMMARY_ATOL, a slack or latency percentile within ``bin_ms``."""
    import math
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(got)} != {sorted(want)}"]
        return [m for k in want
                for m in tail_mismatch(got[k], want[k], bin_ms,
                                       f"{path}.{k}" if path else k)]
    if want is None:
        ok = isinstance(got, float) and math.isnan(got)
    elif path.split(".")[-1] in TAIL_FLOATS:
        ok = abs(got - want) <= SUMMARY_ATOL + SUMMARY_RTOL * abs(want)
    elif path.startswith(("slack_ms", "latency_ms")):
        ok = abs(got - want) <= bin_ms
    else:
        ok = got == want
    return [] if ok else [f"{path} {got} != {want}"]


def phase_sweep(scenario_rows: dict) -> dict:
    """Phase 20: the batched sweep through the port alone, traced.

    ``run_registry_sweep`` over all 14 registry scenarios (registry width,
    the horizon cut to the golden's) × the golden's policies × its seeds,
    under both planners; every row against
    ``tests/golden/torch_port_sweep.json`` (summary, ``tail_metrics``,
    the streams' sums and digests) and ``check_conservation``, the two
    planners' rows bitwise equal to each other, the padded batch's final
    state untraced bitwise equal to the traced rows'; then the paper-width
    seed batch (``run_fleet_batch``, 28 edges × the golden's seeds,
    DEMS-COOP, traced) lane by lane against the golden, lane 0 bitwise
    against ``run_fleet`` of its seed.  ``masked_argext``'s counts are
    set to 0 before the phase and read after it: every launch on the key
    body.  Edge-ticks/s: valid (tick, edge) cells over host wall time
    ending in ``torch.cuda.synchronize()``; information, not a claim."""
    import numpy as np
    import torch
    from repro_torch.core import task
    from repro_torch.kernels import sched_ops
    from repro_torch.obs import metrics
    from repro_torch.obs.trace import TraceSpec
    from repro_torch.scenarios.compile import compile_registry_batch
    from repro_torch.scenarios.runner import (fleet_summary_batch,
                                              run_registry_sweep)
    from repro_torch.sim import fleet as F

    gold = json.load(open(GOLDEN_SWEEP))
    dt, dur = gold["dt"], gold["duration_ms"]
    spec = TraceSpec.full(hist_bins=gold["hist_bins"],
                          hist_max_ms=gold["hist_max_ms"])
    bin_ms = spec.hist_max_ms / spec.hist_bins
    pols, seeds = tuple(gold["policies"]), tuple(gold["seeds"])
    want = {(r["scenario"], r["policy"], r["seed"]): r for r in gold["rows"]}
    summary_keys = ("scenario", "policy", "seed", "trace")

    def check_traced(what, summ, c, w):
        bad = summary_mismatch(summ, w["summary"])
        bad += tail_mismatch(metrics.tail_metrics(c, spec), w["tail"],
                             0.0 if w.get("exact_hist", True) else bin_ms)
        bad += tail_mismatch(metrics.stream_sums(c), w["sums"], 0.0)
        digests = metrics.stream_digests(c, w.get("n_edges"),
                                         w.get("n_models"))
        bad += [f"digest {k}" for k in w["digests"]
                if digests.get(k) != w["digests"][k]]
        try:
            metrics.check_conservation(c)
        except AssertionError as err:
            bad.append(str(err))
        if bad:
            fail(f"phase 20 {what}: off the golden: {bad}")

    sched_ops.reset_count()
    t_phase = time.perf_counter()
    rows, rates = {}, {}
    for planner in ("bucketed", "padded"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows[planner] = run_registry_sweep(
            None, pols, seeds, dt=dt, duration_ms=dur, trace=spec,
            planner=planner, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(rows[planner]) != len(want):
            fail(f"phase 20 {planner}: {len(rows[planner])} rows, the "
                 f"golden has {len(want)}")
        for row in rows[planner]:
            key = (row["scenario"], row["policy"], row["seed"])
            check_traced(f"{planner} {key}",
                         {k: v for k, v in row.items()
                          if k not in summary_keys},
                         row["trace"].counters, want[key])
        cells = sum(int(r["trace"].counters.valid.sum())
                    for r in rows[planner])
        rates[planner] = dict(wall_s=wall, cells=cells,
                              edge_ticks_per_s=cells / wall)
    # the planners' rows bitwise equal: everything but the padding
    for b, p in zip(rows["bucketed"], rows["padded"]):
        key = (b["scenario"], b["policy"], b["seed"])
        w = want[key]
        e, m = w["n_edges"], w["n_models"]
        cb, cp = b["trace"].counters, p["trace"].counters
        same = ({k: v for k, v in b.items() if k != "trace"}
                == {k: v for k, v in p.items() if k != "trace"}
                and json.dumps(metrics.tail_metrics(cb, spec))
                == json.dumps(metrics.tail_metrics(cp, spec))
                and metrics.stream_sums(cb) == metrics.stream_sums(cp)
                and metrics.stream_digests(cb, e, m)
                == metrics.stream_digests(cp, e, m)
                and all(np.array_equal(getattr(cb, f),
                                       getattr(cp, f)[:, :e])
                        for f in metrics.HIST_FIELDS)
                and np.array_equal(b["trace"].t_hat,
                                   p["trace"].t_hat[:, :e, :m]))
        if not same:
            fail(f"phase 20 {key}: the bucketed and padded rows differ")
    # trace off: the padded planner's batch untraced, compiled, run and
    # copied to the host as the traced sweep does; each lane's final
    # state bitwise the traced row's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch, brows = compile_registry_batch(None, pols, seeds, dt=dt,
                                          duration_ms=dur, device="cuda")
    plain = [a.cpu().numpy() for a in leaves(F.run_batch(batch, dt=dt))]
    untraced_s = time.perf_counter() - t0
    for br, row in zip(brows, rows["padded"]):
        traced = list(leaves(row["trace"].final))
        if len(traced) != len(plain) or not all(
                np.array_equal(a[br.lanes[0]], b)
                for a, b in zip(plain, traced)):
            fail(f"phase 20 {br.scenario} {br.policy}: the untraced final "
                 f"state differs from the traced one's")
    del batch
    # the paper-width seed batch, lane 0 against run_fleet of its seed
    sb = gold["seed_batch"]
    models = [task.TABLE1[n] for n in task.ACTIVE]
    kw = dict(dt=dt, edge_frac=sb["edge_frac"], cloud_frac=sb["cloud_frac"],
              cloud_slots=sb["cloud_slots"], trace=spec, device="cuda")
    sig = F.stack_signals([F.default_signals(
        len(models), n_edges=sb["n_edges"],
        drones_per_edge=sb["drones_per_edge"], duration_ms=dur, dt=dt,
        seed=s, device="cuda") for s in sb["seeds"]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = F.run_fleet_batch(models, sb["policy"], sig, **kw)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    for r, (summ, w) in enumerate(zip(fleet_summary_batch(res.final),
                                      sb["lanes"])):
        check_traced(f"seed batch lane {r}", summ,
                     metrics.select_replica(res.counters, r),
                     dict(w, n_edges=sb["n_edges"], n_models=len(models)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    own = F.run_fleet(models, sb["policy"],
                      F.FleetSignals(*(a[0] for a in sig)), **kw)
    torch.cuda.synchronize()
    own_s = time.perf_counter() - t0
    if not (all(torch.equal(a, b[0])
                for a, b in zip(leaves(own.final), leaves(res.final)))
            and torch.equal(own.t_hat, res.t_hat[0])
            and all(torch.equal(a, b[0])
                    for a, b in zip(own.counters, res.counters))):
        fail("phase 20: seed batch lane 0 differs from run_fleet of its "
             "seed")
    launches, key = sched_ops.launch_counts()
    if launches <= 0 or key != launches:
        fail(f"phase 20: {key} of {launches} "
             f"masked_argext launches on the key body")
    ticks = int(sig.times.shape[1])
    cells = ticks * sb["n_edges"] * len(sb["seeds"])
    rates["seed batch"] = dict(wall_s=batch_s, cells=cells,
                               edge_ticks_per_s=cells / batch_s)
    rates["run_fleet seed 0"] = dict(
        wall_s=own_s, cells=ticks * sb["n_edges"],
        edge_ticks_per_s=ticks * sb["n_edges"] / own_s)
    p19 = [r["ticks"] * r["edges"] / r["card_s"]
           for r in scenario_rows["runs"].values()]
    p19_tps = [r["ticks_per_s"] for r in scenario_rows["runs"].values()]
    ratio = rates["padded"]["wall_s"] / untraced_s
    say(f"phase20 sweep: {len(want)} rows (14 scenarios × {len(pols)} "
        f"policies × {len(seeds)} seed, {dur / 1e3:.0f} s traced) under "
        f"both planners, every row == golden (summary, tail_metrics, "
        f"stream sums and digests; histogram percentiles to one bin where "
        f"durations are scaled), check_conservation on every row, the "
        f"planners' rows bitwise equal; the untraced padded batch's final "
        f"state == the traced one's; seed batch {sb['n_edges']} edges × "
        f"{len(sb['seeds'])} seeds {sb['policy']}: every lane == golden, "
        f"lane 0 == run_fleet of seed {sb['seeds'][0]} bitwise; "
        f"masked_argext {launches} launches, every one on the key body")
    say(f"phase20 edge-ticks/s (valid cells / host wall): "
        f"{json.dumps({k: round(v['edge_ticks_per_s'], 1) for k, v in rates.items()})}"
        f"; walls s {json.dumps({k: round(v['wall_s'], 3) for k, v in rates.items()})}; "
        f"phase 19 per run in this call: {min(p19):.1f}-{max(p19):.1f} "
        f"edge-ticks/s ({min(p19_tps):.2f}-{max(p19_tps):.2f} ticks/s); "
        f"the padded sweep untraced (compile, run_batch, host copy) "
        f"{untraced_s:.3f} s against {rates['padded']['wall_s']:.3f} s "
        f"traced (traced/untraced {ratio:.3f}); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(rates=rates, launches=launches, traced_ratio=ratio,
                untraced_s=untraced_s, padded_rows=rows["padded"],
                padded_plain=plain, seed_batch=res)


def graph_report(phase: int, detail: bool = False, all_key: bool = False
                 ) -> dict:
    """The tick program's CUDA graphs captured since the last report:
    each graph's node count, capture and instantiate seconds and
    ``masked_argext`` launches a replay on a line of its own
    (``detail``), else one summary line.  ``all_key`` fails the phase
    unless every replay-counted launch is on the key body.  Then every
    cached program, with its graphs and their memory, is dropped."""
    import torch
    from repro_torch.obs import prof
    from repro_torch.sim import fleet as F
    graphs = [(p, g) for p in F._PROGRAM_REGISTRY for g in p.graphs.values()]
    for p, g in graphs:
        if all_key and g.launches[0] != g.launches[1]:
            fail(f"phase {phase}: a graph's replay counts {g.launches[0]} "
                 f"masked_argext launches, {g.launches[1]} on the key body")
        if detail:
            say(f"phase{phase} graph: state "
                f"{tuple(g.inputs[2].busy_rem.shape)}, "
                f"{g.inputs[3].times.shape[-1]} ticks, coop_rounds "
                f"{p.coop_rounds}, traced {p.tspec.enabled}, donate "
                f"{p.donate}: {g.nodes} nodes, capture {g.capture_s:.3f} s,"
                f" instantiate {g.instantiate_s:.3f} s; masked_argext "
                f"{g.launches[0]} launches a replay, {g.launches[1]} on the "
                f"key body")
    out = dict(graphs=len(graphs), nodes=sum(g.nodes for _, g in graphs),
               capture_s=sum(g.capture_s for _, g in graphs),
               instantiate_s=sum(g.instantiate_s for _, g in graphs))
    say(f"phase{phase} graphs: {out['graphs']} captured, {out['nodes']} "
        f"nodes, capture {out['capture_s']:.3f} s, instantiate "
        f"{out['instantiate_s']:.3f} s in all")
    prof.reset_fleet_programs()
    torch.cuda.empty_cache()
    return out


def coop_setup(golden: dict, ticks: int, trace=None, donate=False):
    """Phase 4's DEMS-COOP golden run at 28 edges as a program, its
    inputs and ``ticks`` ticks of its signals, on the card."""
    from repro_torch.obs.trace import TraceSpec
    from repro_torch.sim import fleet as F
    coop = next(r for r in golden["runs"] if r["name"] == "paper-dems-coop")
    pol = F.FleetPolicy.from_name(coop["policy"])
    prog = F.FleetProgram.for_policy(pol, dt=golden["dt"],
                                     trace=trace or TraceSpec(),
                                     donate=donate)
    prof = F.Profiles.build(models_of(coop["models"]), "cuda")
    sig = golden_signals(golden, coop, "cuda",
                         duration_ms=ticks * golden["dt"])
    state = prog.init(prof, pol, coop["n_edges"], golden["cloud_slots"])
    return prog, prof, pol.params("cuda"), state, sig


def phase_sync(golden: dict) -> None:
    """Phase 10: the tick never waits on the host, and a replay is the
    eager window bitwise.  The eager tick (``_capture=False``) runs
    ``SYNC_TICKS`` ticks, and a traced padded batch one window, under
    ``torch.cuda.set_sync_debug_mode("error")``.  Then 28-edge DEMS-COOP
    (traced) and the padded batch (traced), each without and with
    ``donate``, run ``CHECK_WINDOWS`` windows twice in step: eagerly and
    captured (the first window the warm-up and capture, every later one a
    replay, under the sync check too); every window's state and streams
    must be equal bitwise."""
    import torch
    from repro_torch.obs.trace import TraceSpec
    from repro_torch.scenarios.compile import compile_registry_batch
    from repro_torch.sim import fleet as F

    def no_sync(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return out

    def same(a, b):
        return all(torch.equal(x, y)
                   for x, y in zip(F._leaves(a), F._leaves(b)))

    dt = golden["dt"]
    prog, prof, pp, state, sig = coop_setup(golden, 10 + SYNC_TICKS)
    state, _ = prog.step_chunk(prof, pp, state, F.slice_signals(sig, 0, 10),
                               _capture=False)
    no_sync(lambda: prog.step_chunk(
        prof, pp, state, F.slice_signals(sig, 10, 10 + SYNC_TICKS),
        _capture=False))
    # one traced window of a padded, heterogeneous batch (1-3 edges, 4 and
    # 6 models, 2 and 16 pool slots, with and without peer offload)
    batch, _ = compile_registry_batch(
        ("rush-hour", "cloud-crunch", "brownout"), ("DEMS", "DEMS-COOP"),
        (0,), dt=dt, duration_ms=2_000.0, device="cuda")
    bprog = F.FleetProgram(dt=dt, coop_rounds=batch.coop_rounds,
                           trace=TraceSpec.full())
    bstate, _ = bprog.step_chunk(batch.profiles, batch.params, batch.state,
                                 F.slice_signals(batch.signals, 0, 10),
                                 _capture=False)
    _, bres = no_sync(lambda: bprog.step_chunk(
        batch.profiles, batch.params, bstate,
        F.slice_signals(batch.signals, 10, 10 + SYNC_TICKS),
        _capture=False))
    if tuple(bres.counters.valid.shape[:2]) != (
            batch.signals.times.shape[0], SYNC_TICKS):
        fail("phase 10: the traced batch window has the wrong shape")
    say(f"phase10 sync: {SYNC_TICKS} eager DEMS-COOP ticks at 28 edges, and "
        f"one traced {SYNC_TICKS}-tick window of a padded batch (R "
        f"{batch.signals.times.shape[0]}, edges "
        f"{batch.signals.arrive.shape[2]}, models "
        f"{batch.signals.arrive.shape[3]}), ran under "
        f"set_sync_debug_mode('error')")

    width = CHECK_TICKS
    for donate in (False, True):
        runs = {"28-edge DEMS-COOP": coop_setup(
            golden, CHECK_WINDOWS * width, TraceSpec.full(), donate)}
        bp = F.FleetProgram(dt=dt, coop_rounds=batch.coop_rounds,
                            trace=TraceSpec.full(), donate=donate)
        runs["padded batch"] = (bp, batch.profiles, batch.params,
                                batch.state, batch.signals)
        for what, (p, pr, pa, st, sg) in runs.items():
            eager = cap = st
            for w in range(CHECK_WINDOWS):
                win = F.slice_signals(sg, w * width, (w + 1) * width)
                eager, want = p.step_chunk(pr, pa, eager, win,
                                           _capture=False)
                if w == 0:      # warm-up and capture: outside the check
                    cap, got = p.step_chunk(pr, pa, cap, win)
                else:
                    cap, got = no_sync(
                        lambda: p.step_chunk(pr, pa, cap, win))
                if not (same(eager, cap) and same(want, got)):
                    fail(f"phase 10 {what} donate={donate}: window {w} "
                         f"captured differs from eager")
            if donate and not any(
                    all(a.data_ptr() == b.data_ptr() for a, b in
                        zip(F._leaves(cap), F._leaves(g.inputs[2])))
                    for g in p._program.graphs.values()):
                fail(f"phase 10 {what}: the donated carry is not the "
                     f"graph's own state buffers")
    say(f"phase10 capture: 28-edge DEMS-COOP and the padded batch, traced, "
        f"without and with donate: {CHECK_WINDOWS} windows of {width} ticks "
        f"each (the first the warm-up and capture, then replays under "
        f"set_sync_debug_mode('error')) equal to the eager windows bitwise, "
        f"final state and every stream")
    # two donated streams of one shape interleaved on one graph: a from
    # the fresh state over windows 0, 1, 2, ..., b from the fresh state
    # over windows 1, 2, 3, ...; every window's result, and the state the
    # other stream still holds, equal the eager windows bitwise
    p, pr, pa, fresh, sg = coop_setup(golden, (CHECK_WINDOWS + 2) * width,
                                      TraceSpec.full(), donate=True)
    cap = {"a": fresh, "b": fresh}
    eager = dict(cap)
    nxt = {"a": 0, "b": 1}
    order = "aababba"
    for s in order:
        win = F.slice_signals(sg, nxt[s] * width, (nxt[s] + 1) * width)
        nxt[s] += 1
        eager[s], want = p.step_chunk(pr, pa, eager[s], win, _capture=False)
        cap[s], got = p.step_chunk(pr, pa, cap[s], win)
        if not (same(want, got) and all(same(eager[k], cap[k])
                                        for k in "ab")):
            fail(f"phase 10: interleaved donated streams differ from the "
                 f"eager windows after stream {s}'s window {nxt[s] - 1}")
    say(f"phase10 donate: two donated 28-edge DEMS-COOP streams of "
        f"{width}-tick windows interleaved on one graph (order {order}), "
        f"each window and the other stream's held state equal to the "
        f"eager windows bitwise")
    graph_report(10, detail=True)


def phase_profile(golden: dict, compo_ms: float) -> dict:
    """Phase 11: ``PROFILE_TICKS`` DEMS-COOP ticks at 28 edges under
    ``torch.profiler``, eagerly (``_capture=False``) and as the replay of
    their window's graph, in the order eager, captured, captured, eager.
    A replayed window's inputs are copied into the graph's buffers before
    the profile starts, so it holds the graph's nodes alone.  Device
    operations a tick (kernels and copies: a copy inside the tick is a
    ``Memcpy`` record eagerly and a node of the graph) must be equal
    between the two and to the graph's nodes a tick, within
    ``PROFILE_SLACK`` of them (the profiler drops a record now and then).
    Every run must show ``masked_argext`` records, all of the key body,
    as many as the launches counted (the eager run's counters, the
    graph's replay accounting), less at most the records the profiler
    dropped in that run.  Each run's device busy share and ticks/s; then,
    without the profiler, ``step_chunk`` over ``2·PROFILE_TICKS``-tick
    windows in the same order: ticks/s and the host ms until it
    returned; and a replay's host ms with the profiles and params the
    last replay copied in (skipped) and with new ones (copied)."""
    import torch
    from repro_torch.kernels import sched_ops
    from repro_torch.sim import fleet as F
    from torch.profiler import ProfilerActivity, profile
    n = PROFILE_TICKS
    prog, prof, pp, state, sig = coop_setup(golden, 10 + 31 * n)
    state, _ = prog.step_chunk(prof, pp, state, F.slice_signals(sig, 0, 10),
                               _capture=False)
    lo = 10
    for width in (n, 2 * n):   # warm-up and capture of both window shapes
        state, _ = prog.step_chunk(prof, pp, state,
                                   F.slice_signals(sig, lo, lo + width))
        lo += width
    graph = next(g for g in prog._program.graphs.values()
                 if g.inputs[3].times.shape[0] == n)
    torch.cuda.synchronize()
    order = ("eager", "captured", "captured", "eager")
    runs = []
    for mode in order:
        win = F.slice_signals(sig, lo, lo + n)
        lo += n
        before = sched_ops.launch_counts()
        if mode == "captured":
            with torch.inference_mode():
                for a, b in zip(F._leaves(graph.inputs),
                                F._leaves((prof, pp, state, win))):
                    a.copy_(b)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pr:
            t0 = time.perf_counter()
            if mode == "captured":
                graph.graph.replay()
            else:
                state, _ = prog.step_chunk(prof, pp, state, win,
                                           _capture=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if mode == "captured":
            with torch.inference_mode():
                state = F._map(torch.clone, graph.outputs[0])
            launches, key = graph.launches
        else:
            launches, key = (a - b for a, b in
                             zip(sched_ops.launch_counts(), before))
        dev_ev = [e for e in pr.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [e for e in dev_ev if "masked_argext" in e.name]
        dropped = max(0, graph.nodes - len(dev_ev))
        if not ours:
            fail(f"phase 11 {mode}: the profile shows no masked_argext "
                 f"kernel in the tick")
        if key != launches or any("masked_argext_key" not in e.name
                                  for e in ours):
            fail(f"phase 11 {mode}: masked_argext off the key body")
        if not 0 <= launches - len(ours) <= dropped:
            fail(f"phase 11 {mode}: {len(ours)} masked_argext records "
                 f"against {launches} launches counted ({dropped} records "
                 f"dropped)")
        busy_us = sum(e.time_range.elapsed_us() for e in dev_ev)
        runs.append(dict(
            mode=mode, ops_per_tick=len(dev_ev) / n,
            busy_ms=busy_us / 1e3, wall_ms=wall * 1e3,
            busy_share=busy_us / 1e6 / wall, ticks_per_s=n / wall,
            argext_per_tick=launches / n, argext_records=len(ours) / n,
            argext_us=sum(e.time_range.elapsed_us() for e in ours)
            / max(len(ours), 1)))
    nodes = graph.nodes / n
    off = [r["ops_per_tick"] for r in runs
           if abs(r["ops_per_tick"] - nodes) > PROFILE_SLACK * nodes]
    if off:
        fail(f"phase 11: device operations a tick "
             f"{[r['ops_per_tick'] for r in runs]} (eager and replayed) "
             f"differ from the graph's {nodes} nodes a tick")
    plain, enqueue = [], []
    for mode in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = prog.step_chunk(prof, pp, state,
                                   F.slice_signals(sig, lo, lo + 2 * n),
                                   _capture=mode == "captured")
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        plain.append(2 * n / (time.perf_counter() - t0))
        lo += 2 * n
    for r in runs:
        say(f"phase11 profile {r['mode']} ({n} DEMS-COOP ticks, 28 edges): "
            f"{r['ops_per_tick']:.1f} device operations per tick (the "
            f"graph: {nodes:.1f} nodes a tick), masked_argext "
            f"{r['argext_per_tick']:.1f} launches per tick counted, "
            f"{r['argext_records']:.1f} records per tick at "
            f"{r['argext_us']:.3f} us per launch; device busy "
            f"{r['busy_ms']:.2f} ms of {r['wall_ms']:.2f} ms wall "
            f"({r['busy_share']:.3f}); {r['ticks_per_s']:.2f} ticks/s")
    say(f"phase11 without the profiler, {2 * n}-tick windows, ticks/s in "
        f"the order {', '.join(order)}: "
        f"{', '.join(f'{v:.2f}' for v in plain)} (host ms until "
        f"step_chunk returned: {', '.join(f'{v:.2f}' for v in enqueue)});"
        f" torch.max(where) on (28, 64): {compo_ms * 1e3:.3f} us")
    # a replay's host time with the profiles and params copied in anew
    # (new objects every window) and skipped (the objects the last
    # replay copied, unchanged): the median of a kind's last 3 windows
    host = {"skipped": [], "copied": []}
    for kind in ("skipped", "copied", "copied", "skipped"):
        ms = []
        for _ in range(4):
            ins = (prof, pp) if kind == "skipped" else (
                F._map(torch.clone, prof), F._map(torch.clone, pp))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = prog.step_chunk(*ins, state,
                                       F.slice_signals(sig, lo, lo + n))
            ms.append((time.perf_counter() - t0) * 1e3)
            lo += n
        host[kind].append(sorted(ms[1:])[1])
    say(f"phase11 replay host ms until step_chunk returned, {n}-tick "
        f"windows, profiles and params ({len(F._leaves((prof, pp)))} "
        f"leaves) skipped: {', '.join(f'{v:.3f}' for v in host['skipped'])}"
        f"; copied: {', '.join(f'{v:.3f}' for v in host['copied'])} (order "
        f"skipped, copied, copied, skipped)")
    graph_report(11)
    return dict(runs=runs, plain=plain, enqueue_ms=enqueue, host_ms=host)


def paper_events(golden: dict, duration_ms: float) -> list:
    """The paper's steady stream as controller telemetry: 3 drones an
    edge at 28 edges, each segment (1 s, a random phase a drone) a task of
    every ACTIVE model, as ``(t_ms, edge, model)`` in time order."""
    import numpy as np
    coop = next(r for r in golden["runs"] if r["name"] == "paper-dems-coop")
    m = len(models_of(coop["models"]))
    rng = np.random.default_rng(golden["seed"])
    ev = []
    for e in range(coop["n_edges"]):
        for _ in range(golden["drones_per_edge"]):
            for t in np.arange(rng.uniform(0, 1000.0), duration_ms, 1000.0):
                ev += [(float(t), e, k) for k in range(m)]
    return sorted(ev)


def drive(ctl, events: list, lo_ms: float, hi_ms: float,
          checkpoint_at=None) -> float:
    """Submit ``events`` in ``[lo_ms, hi_ms)`` a poll cadence (one
    window) at a time and poll after each; checkpoint at
    ``checkpoint_at``; flush.  Returns the host seconds."""
    cadence = ctl.window_ticks * ctl.dt
    i = next((k for k, ev in enumerate(events) if ev[0] >= lo_ms),
             len(events))
    t0 = time.perf_counter()
    now = lo_ms
    while now < hi_ms:
        now = min(now + cadence, hi_ms)
        while i < len(events) and events[i][0] < now:
            ctl.submit(*events[i])
            i += 1
        ctl.poll(now)
        if checkpoint_at is not None and now == checkpoint_at:
            if ctl.builder.pending_ticks:
                fail("phase 21: telemetry spilled past the checkpoint tick")
            ctl.checkpoint()
    ctl.close()
    return time.perf_counter() - t0


def phase_controller(golden: dict, scenarios: dict) -> dict:
    """Phase 21: the online control plane on the card.  (a) Phase 19's
    registry-scenario runs streamed through ``FleetController`` in windows
    of 16 and of 7 ticks, each final state bitwise phase 19's replay (held
    to the JAX goldens there).  (b) A paper-scale controller, 28 edges,
    ``window_ticks`` 8, DEMS-COOP, traced, on ``CONTROLLER_MS`` of the
    paper's stream: step-latency p50/p95/p99 (the first window, warm-up
    and capture, left out) and mission time over wall time, then the
    eager path (``_capture=False``) on the first ``EAGER_CONTROLLER_MS``
    of the same stream.  (c) Kill and restore: (b) checkpoints at half
    time; a fresh controller restores, takes the stream from there and
    finishes bitwise (b)'s final state.  (d) ``python -m
    repro_torch.launch.serve --backend fleet`` on the card in a child
    process; its snapshot must be written."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.scenarios.runner import stream_scenario_fleet
    from repro_torch.serve.controller import FleetController
    dt = golden["dt"]
    t_phase = time.perf_counter()
    n_streams = 0
    for entry in golden["scenario_runs"]:
        spec = scenario_spec(entry)
        want = scenarios["runs"][entry["name"]]["final"]
        for window in (16, 7):
            ctl = stream_scenario_fleet(spec, entry["policy"], dt=dt,
                                        window_ticks=window, device="cuda")
            if not all(torch.equal(a.cpu(), b)
                       for a, b in zip(leaves(ctl.state), want)):
                fail(f"phase 21 {entry['name']} window {window}: streamed "
                     f"state differs from phase 19's replay")
            n_streams += 1
    stream_s = time.perf_counter() - t_phase
    say(f"phase21 streaming: {n_streams} runs (phase 19's {n_streams // 2} "
        f"at windows of 16 and 7 ticks) through FleetController, each "
        f"final state == phase 19's replay bitwise; {stream_s:.1f} s")
    graph_report(21)

    coop = next(r for r in golden["runs"] if r["name"] == "paper-dems-coop")
    models = models_of(coop["models"])
    events = paper_events(golden, CONTROLLER_MS)
    half = CONTROLLER_MS / 2
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck")

        def controller(capture=True):
            return FleetController(
                models, coop["policy"], n_edges=coop["n_edges"], dt=dt,
                window_ticks=8, cloud_slots=golden["cloud_slots"],
                checkpoint_path=path, checkpoint_every=10**9,
                device="cuda", _capture=capture)

        def pcts(ctl):
            a = np.asarray(ctl.step_latencies_ms[1:])
            return {f"p{q}": float(np.percentile(a, q)) for q in (50, 95, 99)}

        for capture, horizon in ((True, CONTROLLER_MS),
                                 (False, EAGER_CONTROLLER_MS)):
            ctl = controller(capture)
            wall = drive(ctl, events, 0.0, horizon,
                         checkpoint_at=half if capture else None)
            snap = ctl.metrics_snapshot()
            key = "captured" if capture else "eager"
            out[key] = dict(step_ms=pcts(ctl), mission_s=horizon / 1e3,
                            wall_s=wall, ratio=horizon / 1e3 / wall,
                            windows=ctl.windows_run,
                            ingest_ms=snap["ingest_to_decision_ms"],
                            completed=snap["completed"],
                            decisions=len(ctl.decisions))
            if capture:
                full = ctl
            say(f"phase21 controller {key}: 28 edges DEMS-COOP, windows of "
                f"8 ticks, {horizon / 1e3:.0f} s of mission in {wall:.2f} s "
                f"(mission/wall {horizon / 1e3 / wall:.3f}); step latency ms "
                f"(first window left out) "
                f"{json.dumps({k: round(v, 3) for k, v in out[key]['step_ms'].items()})}; "
                f"ingest to decision ms {json.dumps(snap['ingest_to_decision_ms'])}; "
                f"{ctl.windows_run} windows, {len(ctl.decisions)} decision "
                f"records, completed {snap['completed']}")
        restored = controller()
        tick = restored.restore()
        if tick != int(half / dt):
            fail(f"phase 21: restored tick {tick} != {int(half / dt)}")
        drive(restored, events, half, CONTROLLER_MS)
        if not all(torch.equal(a, b) for a, b in
                   zip(leaves(restored.state), leaves(full.state))):
            fail("phase 21: the restored controller's final state differs "
                 "from the uninterrupted run's")
        say(f"phase21 kill and restore: checkpoint at tick {tick} of the "
            f"captured run, a fresh controller restored from it and fed "
            f"the stream from there: final state == the uninterrupted "
            f"run's bitwise")
        snap_path = os.path.join(tmp, "snapshot.json")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--backend",
             "fleet", "--device", "cuda", "--duration",
             str(SERVE_FLEET_S), "--edges", "2", "--snapshot-out",
             snap_path], cwd=ROOT, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
        if res.returncode != 0 or not os.path.isfile(snap_path):
            fail(f"phase 21: launch.serve --backend fleet failed "
                 f"(exit {res.returncode}): {res.stderr[-2000:]}")
        snap = json.load(open(snap_path))
        if snap["now_ms"] != SERVE_FLEET_S * 1e3 or not snap["windows_run"]:
            fail(f"phase 21: the launcher's snapshot is off: {snap}")
        say(f"phase21 launch.serve --backend fleet --device cuda, "
            f"{SERVE_FLEET_S} s of mission, in a child process: snapshot "
            f"written ({len(snap)} keys; completed {snap['completed']}, "
            f"windows {snap['windows_run']}, step latency ms "
            f"{json.dumps(snap['step_latency_ms'])}); child "
            f"{time.perf_counter() - t0:.1f} s")
    out["graphs"] = graph_report(21)
    say(f"phase21 done in {time.perf_counter() - t_phase:.1f} s")
    return out


def states_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(leaves(a), leaves(b)))


def _events_ms(run, calls: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Time per call of ``fn`` issued eagerly, in ms (CUDA events around
    ``iters`` calls): what the tick pays, bound by the host at these
    sizes."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def graph_ms(fn, iters: int = 200, replays: int = 10,
             warm: int = 3) -> float:
    """Device time per call of ``fn``, in ms: ``iters`` calls captured in
    one CUDA graph and replayed, so the host does not pace the card.
    ``warm`` replays run first: after a long host-bound phase the first
    replays ran slower (phase 17's first row read 160.6 µs a call where
    the profiler gave 137.5 µs, NVIDIA H100 80GB HBM3 at 700 W)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    for _ in range(warm):
        graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    return _events_ms(run, iters * replays)


def floor_ms() -> float:
    """The card's launch floor, in ms: a one-element ``fill_`` timed as
    :func:`graph_ms` times the kernels (200 launches a graph)."""
    import torch
    one = torch.zeros(1, device="cuda")
    return graph_ms(lambda: one.fill_(1.0))


def load_floor_ms() -> float:
    """A launch that loads one element and stores it (a one-element
    ``copy_``), timed as :func:`floor_ms`: the least a kernel that reads
    device memory before it writes can take."""
    import torch
    src, dst = torch.ones(1, device="cuda"), torch.zeros(1, device="cuda")
    return graph_ms(lambda: dst.copy_(src))


def same_values(got, want) -> bool:
    """Equal as numbers (+0.0 == -0.0: a reduction's max may return
    either sign of a tie of zeros), and bit for bit wherever not zero."""
    import torch
    nz = want != 0
    return bool(torch.equal(got, want) and torch.equal(
        got[nz].view(torch.int32), want[nz].view(torch.int32)))


def allclose_err(got, want, tol: float) -> tuple[float, float]:
    """(max |got - want|, the largest excess over tol + tol·|want|) in
    f32; the pair passes when the excess is ≤ 0."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), float((diff - tol - tol * w.abs()).max())


def profile_call(fn) -> tuple[int, float, float]:
    """One call of ``fn`` under ``torch.profiler``: (device kernels, device
    busy ms, wall ms).  The profiler slows the host, so the busy share it
    gives is a lower bound on the share without it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in pr.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(evs), sum(e.time_range.elapsed_us() for e in evs) / 1e3,
            wall * 1e3)


def check_attention_kernels(dev) -> tuple[dict, dict]:
    """Phase 2's attention cases, each kernel against its plain version
    on the same card tensors: the ``tests/test_kernels.py`` sweep (MHA,
    GQA, MQA, window 0/64, non-causal), the path's shapes (granite
    H32/KV8/hd64, starcoder2 H24/KV2/hd128, zamba2 H32/KV32/hd112 and
    nemotron-4-340b H96/KV8/hd192 at S 1-512 through (B,S,H,hd) views),
    views whose rows are off the 16-byte width (they take the CUDA-core
    body: no tensor-core launch) and, for the bf16 flash routes, every
    hd (64, 112, 128, 192) × S (1, 17, 64, 100, 203, 512) × (causal,
    window 64, non-causal) × (MHA, GQA, MQA) through (B,S,H,hd) views;
    decode over ``DECODE_SWEEP`` (rows of length 0 exactly zero).  Every
    bf16 flash case runs on the tensor-core route (``ops``) and on the
    previous CUDA-core route (``_route=CORE``, key "flash_attention
    previous"), every decode case on an aligned view on the split-KV
    route and on the previous body (``_route=PREVIOUS``).  Returns
    ({kernel: {dtype: max |err|}}, case counts)."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(20241231)
    errs = {"flash_attention": {}, "flash_attention previous": {},
            "decode_attention": {}, "decode_attention previous": {}}
    cases = dict.fromkeys(errs, 0)

    def flash(dname, q, k, v, what, causal=True, window=0):
        want = ref.ref_attention(q, k, v, causal=causal, window=window)
        record("flash_attention", dname,
               ops.flash_attention(q, k, v, causal=causal, window=window),
               want, what)
        if dname == "bfloat16":
            record("flash_attention previous", dname,
                   FA.cuda_flash_attention(q, k, v, causal=causal,
                                           window=window, _route=FA.CORE),
                   want, what)

    def decode(dname, got, want, lengths, kernel, what):
        """A row with no valid key is exactly zero (the kernel's, and the
        Pallas kernel's, semantics; the plain version averages V there);
        the others are held to the plain version."""
        torch.cuda.synchronize()
        empty = lengths == 0
        if bool((got[empty] != 0).any()):
            fail(f"{kernel} {what} {dname}: a row with length 0 is not 0")
        record(kernel, dname, got[~empty], want[~empty], what)

    def record(kernel, dname, got, want, what):
        torch.cuda.synchronize()
        if got.numel() == 0:               # every row had length 0
            cases[kernel] += 1
            return
        err, excess = allclose_err(got, want, ATT_TOL[dname])
        if not excess <= 0.0:
            fail(f"{kernel} {what} {dname}: kernel differs from the plain "
                 f"version (max |err| {err}, tolerance {ATT_TOL[dname]})")
        errs[kernel][dname] = max(errs[kernel].get(dname, 0.0), err)
        cases[kernel] += 1

    for dname, td in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=td)

        for (b, h, kv, s, hd) in ((1, 4, 4, 128, 64), (2, 8, 2, 256, 64),
                                  (1, 4, 1, 128, 128)):
            q, k, v = rnd(b, h, s, hd), rnd(b, kv, s, hd), rnd(b, kv, s, hd)
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                flash(dname, q, k, v,
                      f"{(b, h, kv, s, hd)} causal={causal} w={window}",
                      causal, window)
        for (h, kv, hd) in ((32, 8, 64), (24, 2, 128), (32, 32, 112),
                            (96, 8, 192)):
            for (b, s) in ((1, 1), (1, 17), (1, 64), (2, 128), (1, 512),
                           (8, 512), (2, 256)):
                if (hd in (128, 192) and b == 8) or (hd != 112 and s == 256) \
                        or (hd == 192 and s == 512):
                    continue
                q = rnd(b, s, h, hd).transpose(1, 2)
                k = rnd(b, s, kv, hd).transpose(1, 2)
                v = rnd(b, s, kv, hd).transpose(1, 2)
                flash(dname, q, k, v, f"path {(b, h, kv, s, hd)}")
        for hd in FA.HEAD_DIMS:     # rows off the 16-byte width
            for (h, kv, s) in ((8, 2, 64), (8, 8, 100)):
                wide = rnd(2, s, h + 2 * kv, hd + 1)
                q = wide[:, :, :h, 1:].transpose(1, 2)
                k = wide[:, :, h:h + kv, :hd].transpose(1, 2)
                v = wide[:, :, h + kv:, 1:].transpose(1, 2)
                want_tc = FA.tc_route(q, k, v)
                before = FA.tc_launch_count
                flash(dname, q, k, v, f"stride hd+1 {(2, h, kv, s, hd)}")
                if want_tc != FA.CORE or FA.tc_launch_count != before:
                    fail(f"flash_attention {dname} stride hd+1: a view off "
                         f"the 16-byte width did not take the CUDA cores")
        if dname == "bfloat16":     # the tensor-core route's sweep
            for hd in FA.HEAD_DIMS:
                for (h, kv) in ((8, 8), (8, 2), (8, 1)):
                    for s in (1, 17, 64, 100, 203, 512):
                        q = rnd(2, s, h, hd).transpose(1, 2)
                        k = rnd(2, s, kv, hd).transpose(1, 2)
                        v = rnd(2, s, kv, hd).transpose(1, 2)
                        for causal, window in ((True, 0), (True, 64),
                                               (False, 0)):
                            flash(dname, q, k, v, f"route sweep "
                                  f"{(2, h, kv, s, hd)} causal={causal} "
                                  f"w={window}", causal, window)

        for (b, h, kv, w, hd) in DECODE_SWEEP:
            ck, cv, q = rnd(b, w, kv, hd), rnd(b, w, kv, hd), rnd(b, h, hd)
            # the model's transposed cache views, and two whose rows are
            # off the 16-byte width (a stride of hd + 1, an offset of 1)
            wide = rnd(b, w, kv, hd + 1)
            flat = rnd(2 * b * w * kv * hd + 1)
            views = {"aligned": (ck, cv),
                     "stride hd+1": (wide[..., :hd], wide[..., 1:]),
                     "offset 1": (flat[1:1 + ck.numel()].view(ck.shape),
                                  flat[1 + ck.numel():].view(ck.shape))}
            lens = sorted({0, 1, 2, 31, 32, 33, 65, w // 2, w - 1, w}
                          | ({576} if w == 1024 else set()))
            for vname, (kc, vc) in views.items():
                kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
                for n in (lens if vname == "aligned" else (0, 33, w)):
                    lengths = torch.randint(0, n + 1, (b,), generator=gen,
                                            device=dev, dtype=torch.int32)
                    lengths[0] = n
                    what = f"{(b, h, kv, w, hd)} {vname} lengths ≤ {n}"
                    want = ref.ref_decode_attention(q, kt, vt, lengths)
                    decode(dname, ops.decode_attention(q, kt, vt, lengths),
                           want, lengths, "decode_attention", what)
                    if vname == "aligned":
                        decode(dname, DA.cuda_decode_attention(
                            q, kt, vt, lengths, _route=DA.PREVIOUS), want,
                            lengths, "decode_attention previous", what)
    return errs, cases


def path_launches(cfg, forwards: int = 0, prefills: int = 0,
                  steps: int = 0) -> dict:
    """The launches of each model kernel that ``forwards`` forward
    passes, ``prefills`` prefills and ``steps`` decode steps of a model
    under ``attn_impl="kernel"`` make: every norm, every ``forward``
    attention layer (and the encdec encoder's in ``prefill``), every
    decode attention layer on a contiguous cache,
    every Mamba2 scan in ``forward`` and ``prefill``, and every expert
    product of the moe family (3 a layer for silu experts, 2 for gelu)
    in all three.  A program's key counts as two calls, its warm call and
    its capture (a ``PrefillProgram``'s as two prefills, a
    ``DecodeProgram``'s as two steps); a replay as none."""
    if cfg.family == "encdec":
        # the encoder (flash, 2 norms a layer, enc_norm) runs in forward
        # and prefill; the decoder's self-attention takes flash in forward
        # only (prefill's is plain) and flash decode in a step; its
        # cross-attention is plain; 3 norms a decoder layer, and the final
        enc, dec = cfg.enc_layers, cfg.n_layers
        norms = 3 * dec + 1
        return {"flash_attention": (enc + dec) * forwards + enc * prefills,
                "decode_attention": dec * steps,
                "rmsnorm": (2 * enc + 1 + norms) * (forwards + prefills)
                + norms * steps,
                "ssm_scan": 0, "moe_gemm": 0}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        attn, norms, scans = groups, cfg.n_layers + 2 * groups + 1, \
            cfg.n_layers
    elif cfg.family == "ssm":
        attn, norms, scans = 0, cfg.n_layers + 1, 0
    else:
        attn, norms, scans = cfg.n_layers, 2 * cfg.n_layers + 1, 0
    gemms = (3 if cfg.act == "silu" else 2) * cfg.n_layers \
        if cfg.family == "moe" else 0
    return {"flash_attention": attn * forwards,
            "decode_attention": 0 if cfg.sliding_window else attn * steps,
            "rmsnorm": norms * (forwards + prefills + steps),
            "ssm_scan": scans * (forwards + prefills),
            "moe_gemm": gemms * (forwards + prefills + steps)}


def _model_kernels():
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import moe_gemm, rmsnorm, ssm_scan
    return (flash_attention, decode_attention, rmsnorm, ssm_scan, moe_gemm)


def model_counts() -> dict:
    return {m.KERNEL: m.launch_count for m in _model_kernels()}


def reset_model_counts() -> None:
    for m in _model_kernels():
        m.reset_count()


def tc_counts() -> dict:
    """The launches that took each redesigned model kernel's new body:
    the tensor-core route of flash and moe, the scan's chunked body, and
    rmsnorm's register-resident body (REGS)."""
    from repro_torch.kernels import flash_attention, moe_gemm, rmsnorm
    from repro_torch.kernels import ssm_scan
    counts = {m.KERNEL: m.tc_launch_count for m in (flash_attention,
                                                    moe_gemm, ssm_scan)}
    counts[rmsnorm.KERNEL] = rmsnorm.reg_launch_count
    return counts


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{what}: kernel launches {json.dumps(got)}, want "
             f"{json.dumps(want)}")


def check_tc(what: str, launches: dict, tc: dict, bf16: bool) -> None:
    """On a bf16 path every flash, moe and scan launch took the
    tensor-core route (the scan's chunked body); on an f32 one none did
    (the f32 goldens need the CUDA cores).  Every rmsnorm launch, in
    either dtype, took the REGS body: every norm of the paths is on the
    16-byte width."""
    want = {k: launches[k] if bf16 or k == "rmsnorm" else 0 for k in tc}
    if tc != want:
        fail(f"{what}: new-body launches (tensor cores; rmsnorm REGS) "
             f"{json.dumps(tc)}, want {json.dumps(want)} of "
             f"{json.dumps(launches)}")


def phase_golden(dev, path: str, phase: int) -> None:
    """A model golden file (phase 5: granite-3-2b, 2 layers; phase 12:
    zamba2-7b, 8 layers; phase 15: qwen3-moe-30b-a3b, 2 layers; phase
    22: whisper-medium, 2 + 2 layers, with frames N(0, 1) from the file's
    numpy seed), at full width in f32 with weights from the
    file's numpy seed, against the JAX reference's numbers (its route
    named in the file), run on ``"kernel"``; the kernel
    launches of the run must be exactly the path's."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import Model
    gold = json.load(open(path))
    depth = {k: gold[k] for k in ("n_layers", "enc_layers") if k in gold}
    cfg = dataclasses.replace(
        ARCHS[gold["arch"]], dtype=gold["dtype"], param_dtype=gold["dtype"],
        attn_impl="kernel", **depth)
    t0 = time.perf_counter()
    params = convert.params_from_numpy(
        cfg, convert.random_numpy_params(cfg, gold["weight_seed"]), dev)
    model = Model(cfg, dev)
    tokens = torch.tensor(gold["tokens"], dtype=torch.long, device=dev)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(np.random.default_rng(
            gold["frame_seed"]).standard_normal(
                (gold["batch"], cfg.n_frames, cfg.d_model),
                dtype=np.float32)).to(dev)
    reset_model_counts()
    worst = dict(value=0.0, checksum=0.0)

    def check_top(row, ids, values, what):
        row = row.double()
        got = row[ids]
        err = max(float((got - torch.tensor(values, dtype=torch.float64))
                        .abs().max()),
                  abs(float(row.topk(len(ids)).values[-1]) - values[-1]))
        worst["value"] = max(worst["value"], err)
        if err > GOLD_TOL:
            fail(f"golden {what}: top-{len(ids)} logits differ from the JAX "
                 f"reference by {err} (tolerance {GOLD_TOL})")

    logits = model.forward(params, {"tokens": tokens, **extra})[0].cpu()
    for e in gold["forward"]:
        row = logits[e["b"], e["pos"]]
        check_top(row, e["ids"], e["values"], f"forward b{e['b']} "
                  f"pos {e['pos']}")
        err = abs(float(row[:cfg.vocab].double().sum()) - e["checksum"])
        worst["checksum"] = max(worst["checksum"], err)
        if err > GOLD_SUM_TOL:
            fail(f"golden forward b{e['b']} pos {e['pos']}: checksum off "
                 f"by {err} (tolerance {GOLD_SUM_TOL})")
    prompt = gold["prompt"]
    last, cache = model.prefill(params, {"tokens": tokens[:, :prompt],
                                         **extra}, gold["max_seq"])
    last = last[:, 0].cpu()
    for b, e in enumerate(gold["prefill"]):
        check_top(last[b], e["ids"], e["values"], f"prefill b{b}")
    for t, step in enumerate(gold["decode"]):
        fed = torch.tensor(step["fed"], dtype=torch.long, device=dev)
        out, cache = model.decode_step(params, cache, fed[:, None],
                                       prompt + t)
        out = out[:, 0].cpu().double()
        for b in range(out.shape[0]):
            want_id, v1 = step["top1"][b], step["top1_value"][b]
            err = max(abs(float(out[b, want_id]) - v1),
                      abs(float(out[b].max()) - v1))
            worst["value"] = max(worst["value"], err)
            if err > GOLD_TOL:
                fail(f"golden decode step {t} b{b}: top-1 logit off by "
                     f"{err} (tolerance {GOLD_TOL})")
            if v1 - step["top2_value"][b] > 2 * GOLD_TOL \
                    and int(out[b].argmax()) != want_id:
                fail(f"golden decode step {t} b{b}: greedy token "
                     f"{int(out[b].argmax())} != {want_id}")
    launches = model_counts()
    check_launches(f"golden {gold['arch']}", launches, path_launches(
        cfg, forwards=1, prefills=1, steps=len(gold["decode"])))
    check_tc(f"golden {gold['arch']} (f32)", launches, tc_counts(),
             bf16=False)
    say(f"phase{phase} golden {gold['arch']} full width × "
        f"{json.dumps(depth)} layers f32 on 'kernel': forward (B "
        f"{gold['batch']}, S {gold['seq']}"
        f"{', frames ' + str(cfg.n_frames) if extra else ''}), prefill "
        f"{prompt} + {len(gold['decode'])} teacher-forced decode steps == "
        f"JAX golden ({gold['attn_impl']!r}); max |Δ top logit| "
        f"{worst['value']:.3e} (tol {GOLD_TOL}), max |Δ checksum| "
        f"{worst['checksum']:.3e} (tol {GOLD_SUM_TOL}); kernel launches "
        f"{json.dumps(launches)} (= the path's, none on the tensor "
        f"cores, every rmsnorm on the REGS body); "
        f"{time.perf_counter() - t0:.1f} s")


def graph_forwards(m) -> int:
    """The forwards of a served model that launched the kernel wrappers:
    on the card the sync-checked warm forward and the capture
    (``GraphForward``); a replay launches through the graph and counts
    nothing."""
    return m.graph.eager_forwards + m.graph.captures


def check_graph_logits(what: str, m) -> None:
    """One replay of ``m``'s captured forward against an eager forward of
    the same model and tokens: equal bitwise (the path's kernels are
    deterministic)."""
    import torch
    got = m.run()
    want = m.graph.fwd()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max())
        fail(f"{what}: the CUDA graph's logits differ from the eager "
             f"forward's (max |Δ| {err})")


def phase_serve(dev) -> dict:
    """Phase 6, the serve path: the launcher's three roles at published
    size under GEMS, each forward a CUDA-graph replay; returns the kernel
    launches of building (warm forward and capture) and serving them
    (flash attention's main path)."""
    import torch
    from repro_torch.core.schedulers import make_policy
    from repro_torch.launch import serve as launch
    from repro_torch.serve.engine import ServeEngine, run_stream
    t0 = time.perf_counter()
    reset_model_counts()
    models, fps = launch.build_roles(device=dev, full_size=True,
                                     attn_impl="kernel")
    cfgs = {name: launch.role_config(launch.ROLES[name][0], full_size=True,
                                     attn_impl="kernel")
            for name in models}
    say(f"phase6 roles built, captured and calibrated in "
        f"{time.perf_counter() - t0:.1f} s; p95 ms of one replay "
        f"{json.dumps({n: m.profile.t_edge for n, m in models.items()})}; "
        f"FPS {json.dumps(fps)}; peak memory "
        f"{torch.cuda.max_memory_allocated()} B")
    calls = dict.fromkeys(models, 0)
    lock = threading.Lock()

    def counted(name, run):
        def call():
            out = run()
            with lock:
                calls[name] += 1
            return out
        return call

    models = {n: dataclasses.replace(m, run=counted(n, m.run))
              for n, m in models.items()}
    replays0 = {n: m.graph.replays for n, m in models.items()}
    engine = ServeEngine(make_policy("GEMS"), models, cloud_concurrency=4,
                         seed=0)
    res = run_stream(engine, fps, SERVE_MS)
    launches = model_counts()
    replays = {n: m.graph.replays - replays0[n] for n, m in models.items()}
    expected = {k: sum(path_launches(cfgs[n], forwards=graph_forwards(m))[k]
                       for n, m in models.items()) for k in launches}
    check_launches("serve (warm forwards and captures "
                   f"{json.dumps({n: graph_forwards(m) for n, m in models.items()})})",
                   launches, expected)
    check_tc("serve", launches, tc_counts(), bf16=True)
    if replays != calls:
        fail(f"serve: graph replays {replays} != forwards run {calls}")
    if launches["flash_attention"] <= 0 or not all(
            calls[n] for n in models if cfgs[n].family != "ssm"):
        fail(f"serve: an attention role never ran: forwards {calls}")
    for n, st in res.per_model.items():
        done = (st.edge_success + st.edge_miss + st.cloud_success
                + st.cloud_miss + st.dropped)
        if done > st.generated:
            fail(f"serve {n}: {done} outcomes > {st.generated} generated")
    say(f"phase6 serve GEMS {SERVE_MS / 1e3:.0f} s: generated "
        f"{res.generated}, completed {res.completed}, completion rate "
        f"{res.completion_rate:.4f}, QoS utility {res.qos_utility}, QoE "
        f"utility {res.qoe_utility}, stolen {res.stolen}, migrated "
        f"{res.migrated}; forwards (graph replays) {json.dumps(calls)}; "
        f"kernel launches {json.dumps(launches)} (= Σ (warm forward + "
        f"capture) × the role's layers; every flash launch on the tensor "
        f"cores)")
    say(f"phase6 {res.summary()}")
    for name, m in models.items():
        n_k, busy, wall = profile_call(m.run)
        say(f"phase6 profile of one {name} replay alone: {n_k} device "
            f"kernels, device busy {busy:.3f} ms of {wall:.3f} ms wall "
            f"({busy / wall:.3f})")
        check_graph_logits(f"serve {name} ({cfgs[name].name}, "
                           f"{cfgs[name].family})", m)
    say(f"phase6 graph logits: one replay of each role == an eager forward "
        f"bitwise ({', '.join(f'{n} {c.family}' for n, c in cfgs.items())})")
    return launches


def program_greedy(program, tok, p: int, steps: int, what: str) -> dict:
    """Greedy decoding of ``steps`` tokens through ``program`` (a
    ``DecodeProgram`` whose cache holds a prompt of ``p`` tokens) from
    ``tok`` at position ``p``, the position a device scalar advanced on
    the card.  A program not yet captured makes its first call the warm
    step and the capture; each of the next CHECK_REPLAYS replays is held
    bitwise (logits and cache) to an eager ``Model.decode_step`` at the
    host int position on a clone of the cache before it; every replay is
    timed on the host's clock, ending in a synchronize.  Returns the
    tokens fed, each step's last logits, the replays' walls in ms
    (sorted) and ``step_calls``, the steps that launched the kernel
    wrappers (the warm step and the capture when this call made them, and
    the eager checks: a replay launches through the graph)."""
    import torch
    mk, params = program.model, program.params
    pos = torch.full((), p, dtype=torch.int32, device=tok.device)
    fed, outs, walls = [], [], []
    checks = 0
    fresh, start = program.graph is None, program.replays
    for t in range(steps):
        fed.append(tok)
        twin = want = None
        if program.graph is not None and checks < CHECK_REPLAYS:
            twin = {k: v.clone() for k, v in program.cache.items()}
            want = mk.decode_step(params, twin, tok, p + t)[0]
            checks += 1
        replay = program.graph is not None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = program(tok, pos)
        torch.cuda.synchronize()
        if replay:
            walls.append((time.perf_counter() - t0) * 1e3)
        if want is not None and not (torch.equal(logits, want) and all(
                torch.equal(program.cache[k], v) for k, v in twin.items())):
            fail(f"{what}: the replayed step at position {p + t} differs "
                 f"from the eager step at the int position (logits or "
                 f"cache)")
        pos.add_(1)
        outs.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1, keepdim=True)
    replays = steps - 1 if fresh else steps
    if program.replays - start != replays or checks != min(CHECK_REPLAYS,
                                                            replays):
        fail(f"{what}: {program.replays - start} replays and {checks} "
             f"checked, want {replays} and {min(CHECK_REPLAYS, replays)}")
    made = program.eager_steps + program.captures if fresh else 0
    return dict(fed=fed, outs=outs, walls=sorted(walls), checks=checks,
                step_calls=made + checks)


def program_report(program, g: dict, p: int) -> dict:
    """What a ``DecodeProgram`` costs beside the eager step, in one run:
    the replays' wall p50 (from :func:`program_greedy`'s ``g``), the p50
    of EAGER_TIMED eager steps (on a clone of the cache, from the next
    greedy token at positions ``p``...), one replay's device span read
    with CUDA events, one replay and one eager step under the profiler,
    and the graph's nodes and capture time.  The eager steps launch the
    kernel wrappers (EAGER_TIMED + 1 steps' worth); the replays here
    write the cache at the program's last position again."""
    import torch
    mk, params = program.model, program.params
    tok = g["outs"][-1].argmax(-1, keepdim=True)
    cache = {k: v.clone() for k, v in program.cache.items()}
    eager = []
    for i in range(EAGER_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mk.decode_step(params, cache, tok, p + i)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3)
    eager.sort()
    eager_prof = profile_call(
        lambda: mk.decode_step(params, cache, tok, p + EAGER_TIMED))
    del cache
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    program.graph.replay()
    end.record()
    torch.cuda.synchronize()
    span = start.elapsed_time(end)
    replay_prof = profile_call(program.graph.replay)
    walls = g["walls"]
    return dict(replay_p50_ms=walls[len(walls) // 2], replays=len(walls),
                eager_p50_ms=eager[len(eager) // 2], eager_steps=len(eager),
                replay_span_ms=span, replay_profile=replay_prof,
                eager_profile=eager_prof, nodes=program.nodes,
                capture_s=program.capture_s,
                instantiate_s=program.instantiate_s, checked=g["checks"])


# phase → the DecodeProgram report of its kernel-route decode
DECODE_PROGRAMS = {}


def program_line(name: str, b: int, rep: dict) -> str:
    (rk, rbusy, rwall), (ek, ebusy, ewall) = (rep["replay_profile"],
                                              rep["eager_profile"])
    return (f"DecodeProgram {name} B {b}: replayed step wall p50 "
            f"{rep['replay_p50_ms']:.4f} ms ({rep['replays']} replays, "
            f"{b / rep['replay_p50_ms'] * 1e3:.1f} tokens/s) beside the "
            f"eager step's p50 {rep['eager_p50_ms']:.4f} ms "
            f"({rep['eager_steps']} steps, same run); one replay's device "
            f"span (CUDA events) {rep['replay_span_ms']:.4f} ms; profiled: "
            f"one replay {rk} device kernels, busy {rbusy:.3f} ms of "
            f"{rwall:.3f} ms wall; one eager step {ek} device kernels, busy "
            f"{ebusy:.3f} ms of {ewall:.3f} ms wall; graph nodes "
            f"{rep['nodes']}, capture {rep['capture_s']:.3f} s, instantiate "
            f"{rep['instantiate_s']:.3f} s; the first {rep['checked']} "
            f"replays == eager steps at the int position bitwise (logits "
            f"and cache)")


def program_prefill(pp, batch: dict, what: str):
    """A request's first prefill through ``pp`` (a ``PrefillProgram``
    over a ``DecodeProgram``'s cache; ``batch``'s shape a new key): the
    warm prefill and the capture, timed together on the host's clock,
    then one replay, held bitwise to the warm prefill in its logits and
    in every cache leaf.  Every leaf keeps its address, and the replay
    launches nothing through the kernel wrappers.  Returns the warm
    prefill's logits and the first call's seconds."""
    import torch
    ptrs = {k: v.data_ptr() for k, v in pp.cache.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = pp(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    want = {k: v.clone() for k, v in pp.cache.items()}
    before, replays = model_counts(), pp.replays
    got = pp(batch)
    torch.cuda.synchronize()
    if model_counts() != before or pp.replays != replays + 1:
        fail(f"{what}: the prefill replay launched "
             f"{json.dumps(model_counts())} against {json.dumps(before)}, "
             f"or was no replay ({pp.replays - replays} replays)")
    if not (torch.equal(got, warm) and all(
            torch.equal(pp.cache[k], v) for k, v in want.items())):
        fail(f"{what}: the first prefill replay differs from the warm "
             f"prefill (logits or cache)")
    if {k: v.data_ptr() for k, v in pp.cache.items()} != ptrs:
        fail(f"{what}: a cache leaf moved in the prefill program")
    return warm, first_s


def prefill_report(pp, batch: dict) -> dict:
    """What a ``PrefillProgram``'s key costs beside the eager prefill, in
    one run: the wall p50 of PREFILL_TIMED replays and of PREFILL_TIMED
    eager ``Model.prefill`` calls into a fresh cache each (the prefill as
    it ran before it was captured; they launch the kernel wrappers), one
    replay's device span read with CUDA events, one replay under the
    profiler, and the graph's nodes and capture time.  The replays write
    ``batch``'s cache again."""
    import torch
    mk, params = pp.model, pp.params
    cap = pp.graphs[pp.key(batch)]

    def walls(fn) -> list:
        out = []
        for _ in range(PREFILL_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return sorted(out)
    replayed = walls(lambda: pp(batch))
    eager = walls(lambda: mk.prefill(params, batch, pp.max_seq))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    cap.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return dict(replay_p50_ms=replayed[PREFILL_TIMED // 2],
                eager_p50_ms=eager[PREFILL_TIMED // 2], timed=PREFILL_TIMED,
                replay_span_ms=start.elapsed_time(end),
                replay_profile=profile_call(cap.graph.replay),
                nodes=cap.nodes, capture_s=cap.capture_s,
                instantiate_s=cap.instantiate_s, shape=list(
                    batch["tokens"].shape))


# phase → the PrefillProgram report of its kernel-route prefill
PREFILL_PROGRAMS = {}


def prefill_line(name: str, rep: dict) -> str:
    rk, rbusy, rwall = rep["replay_profile"]
    b, s = rep["shape"]
    return (f"PrefillProgram {name} B {b} × S {s}: replayed prefill wall "
            f"p50 {rep['replay_p50_ms']:.4f} ms beside the eager prefill's "
            f"p50 {rep['eager_p50_ms']:.4f} ms ({rep['timed']} each, same "
            f"run; eager into a fresh cache); one replay's device span (CUDA "
            f"events) {rep['replay_span_ms']:.4f} ms; profiled: one replay "
            f"{rk} device kernels, busy {rbusy:.3f} ms of {rwall:.3f} ms "
            f"wall; graph nodes {rep['nodes']}, capture "
            f"{rep['capture_s']:.3f} s, instantiate "
            f"{rep['instantiate_s']:.3f} s; the first replay == the warm "
            f"prefill bitwise (logits and every cache leaf), cache "
            f"addresses unchanged, no wrapper launch in a replay")


def second_request(program, pp, batch: dict, p: int, what: str) -> dict:
    """A second request of the first's shape, after the first's decode
    steps: its prompt replayed into the used cache, logits and every
    leaf bitwise an eager ``Model.prefill`` into a fresh ``init_cache``,
    the replay launching nothing through the wrappers; then
    CHECK_REPLAYS decode replays from its greedy token, each bitwise an
    eager step (:func:`program_greedy`).  Returns the steps that launched
    the wrappers (the eager checks) beside the one eager prefill."""
    import torch
    before = model_counts()
    logits = pp(batch)
    torch.cuda.synchronize()
    if model_counts() != before:
        fail(f"{what}: the second request's prefill replay launched "
             f"through the wrappers")
    want, fresh = pp.model.prefill(pp.params, batch, pp.max_seq)
    if not (torch.equal(logits, want) and fresh.keys() == pp.cache.keys()
            and all(torch.equal(pp.cache[k], v) for k, v in fresh.items())):
        fail(f"{what}: the second request's prefill replay into the used "
             f"cache differs from an eager prefill into a fresh cache "
             f"(logits or cache)")
    del want, fresh
    g = program_greedy(program, logits[:, -1].argmax(-1, keepdim=True), p,
                       CHECK_REPLAYS, f"{what} second request")
    return dict(step_calls=g["step_calls"], prefills=1,
                launches={k: v - before[k]
                          for k, v in model_counts().items()})


def greedy_vs_yardsticks(dev, cfg, params, prompt, steps: int,
                         max_seq: int, extra=None, second=None) -> dict:
    """Prefill ``prompt`` (with ``extra``'s inputs: an encdec model's
    frames) and decode ``steps`` greedy tokens with ``cfg``
    (``attn_impl="kernel"``, bf16), then feed the same tokens through the
    plain bf16 path and an f32 copy of the model on both routes: the RMS
    of the logit differences over the RMS of the plain f32 logits (kr
    kernel vs plain, kf kernel vs f32, rf plain vs f32, ff the two f32
    routes), held to DECODE_KR_TOL·rf, DECODE_KF_TOL·rf and
    DECODE_F32_TOL.  The kernel model's request runs as two programs: a
    ``PrefillProgram`` over a ``DecodeProgram``'s cache
    (:func:`program_prefill`: the warm prefill, the capture, a replay
    held to it) and the steps (:func:`program_greedy`: a warm step and
    the capture, replays, the first ones held to eager steps); the
    yardsticks stay eager.  With ``second`` (phase 7), a second prompt of
    the same shape is then served through both (:func:`second_request`).
    Returns the timings, the RMSs, the kernel launches of the bf16 kernel
    model's prefill and steps, the prefills and steps that launched them
    (``prefill_calls``, ``step_calls``) and the programs' reports."""
    import torch
    from repro_torch.models.model import DecodeProgram, Model, PrefillProgram
    b, p = prompt.shape
    batch = {"tokens": prompt, **(extra or {})}
    mk = Model(cfg, dev)
    mr = Model(dataclasses.replace(cfg, attn_impl="ref"), dev)
    reset_model_counts()
    program = DecodeProgram(mk, params, mk.init_cache(b, max_seq))
    pp = PrefillProgram(mk, params, program.cache)
    last, prefill_s = program_prefill(pp, batch, f"prefill {cfg.name}")
    cache_r = {k: v.clone() for k, v in program.cache.items()}
    tok = last[:, -1].argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    g = program_greedy(program, tok, p, steps, f"decode {cfg.name}")
    wall = time.perf_counter() - t0
    launches, tc = model_counts(), tc_counts()
    fed, outs = g["fed"], g["outs"]
    sec = None if second is None else second_request(
        program, pp, dict(batch, tokens=second), p, f"serve {cfg.name}")
    report = program_report(program, g, p + steps)
    prefill = prefill_report(pp, batch)
    del program, pp
    f32 = dict(dtype="float32", param_dtype="float32")
    mf = Model(dataclasses.replace(cfg, attn_impl="ref", **f32), dev)
    mff = Model(dataclasses.replace(cfg, **f32), dev)
    pf = {k: ({kk: vv.float() for kk, vv in v.items()}
              if isinstance(v, dict) else v.float())
          for k, v in params.items()}
    _, cache_f = mf.prefill(pf, batch, max_seq)
    _, cache_ff = mff.prefill(pf, batch, max_seq)
    sq = dict(kr=0.0, kf=0.0, rf=0.0, ff=0.0, f=0.0)
    mx = 0.0
    for t in range(steps):
        lr, _ = mr.decode_step(params, cache_r, fed[t], p + t)
        lf, _ = mf.decode_step(pf, cache_f, fed[t], p + t)
        lff, _ = mff.decode_step(pf, cache_ff, fed[t], p + t)
        k_, r_, f_, ff_ = (x[:, -1, :cfg.vocab].float()
                           for x in (outs[t][:, None], lr, lf, lff))
        sq["kr"] += float((k_ - r_).square().sum())
        sq["kf"] += float((k_ - f_).square().sum())
        sq["rf"] += float((r_ - f_).square().sum())
        sq["ff"] += float((ff_ - f_).square().sum())
        sq["f"] += float(f_.square().sum())
        mx = max(mx, float((k_ - r_).abs().max()))
    rms = {k: (v / sq["f"]) ** 0.5 for k, v in sq.items() if k != "f"}
    if not (rms["kr"] <= DECODE_KR_TOL * rms["rf"]
            and rms["kf"] <= DECODE_KF_TOL * rms["rf"]
            and rms["ff"] <= DECODE_F32_TOL):
        fail(f"decode {cfg.name}: relative RMS differences "
             f"{json.dumps(rms)} (kernel vs plain kr, kernel vs f32 kf, "
             f"plain vs f32 rf, f32 kernel vs f32 plain ff): want kr ≤ "
             f"{DECODE_KR_TOL}·rf, kf ≤ {DECODE_KF_TOL}·rf and ff ≤ "
             f"{DECODE_F32_TOL}")
    del pf, cache_f, cache_ff, mf, mff
    return dict(prefill_s=prefill_s, wall=wall, rms=rms, max_diff=mx,
                launches=launches, tc=tc, step_calls=g["step_calls"],
                prefill_calls=PrefillProgram.eager_prefills
                + PrefillProgram.captures, program=report, prefill=prefill,
                second=sec, peak=torch.cuda.max_memory_allocated())


def decode_line(r: dict, b: int, p: int, steps: int) -> str:
    rms = r["rms"]
    return (f"B {b}, prompt {p} (the prefill program's warm prefill and "
            f"capture {r['prefill_s']:.3f} s), {steps} "
            f"greedy steps in {r['wall']:.3f} s (the warm step, the capture "
            f"and {CHECK_REPLAYS} eager checks among them); kernel launches "
            f"{json.dumps(r['launches'])} (= the path's: the warm prefill "
            f"and its capture, {r['prefill_calls']} prefills' worth; warm "
            f"step, capture and checks, {r['step_calls']} steps' worth); "
            f"teacher-forced on the same tokens, "
            f"RMS of the logit difference over RMS of the f32 logits: "
            f"kernel vs attn_impl='ref' {rms['kr']:.4e} (tol "
            f"{DECODE_KR_TOL}·rf), kernel vs f32 {rms['kf']:.4e} (tol "
            f"{DECODE_KF_TOL}·rf), 'ref' vs f32 {rms['rf']:.4e}; f32 "
            f"'kernel' vs f32 'ref' {rms['ff']:.4e} (tol {DECODE_F32_TOL}); "
            f"max |kernel − ref| {r['max_diff']:.4f}; peak memory "
            f"{r['peak']} B")


def phase_decode(dev) -> dict:
    """Phase 7, the decode path: greedy decoding of granite-3-2b in bf16
    through the decode kernel, held against the plain path on the same
    tokens; returns the kernel launches of the prefill and steps."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(ARCHS["granite-3-2b"], attn_impl="kernel")
    b, p, steps = DECODE["batch"], DECODE["prompt"], DECODE["steps"]
    gen = torch.Generator(device=dev).manual_seed(DECODE["seed"])
    params = Model(cfg, dev).init(gen)
    prompt = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    second = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    r = greedy_vs_yardsticks(dev, cfg, params, prompt, steps,
                             DECODE["max_seq"], second=second)
    check_launches("decode granite-3-2b", r["launches"],
                   path_launches(cfg, prefills=r["prefill_calls"],
                                 steps=r["step_calls"]))
    check_tc("decode granite-3-2b", r["launches"], r["tc"], bf16=True)
    sec = r["second"]
    check_launches("granite-3-2b second request", sec["launches"],
                   path_launches(cfg, prefills=sec["prefills"],
                                 steps=sec["step_calls"]))
    say(f"phase7 decode granite-3-2b bf16 {decode_line(r, b, p, steps)}")
    say(f"phase7 {program_line('granite-3-2b', b, r['program'])}")
    say(f"phase7 {prefill_line('granite-3-2b', r['prefill'])}")
    say(f"phase7 second request (B {b} × {p}, after the first's {steps} "
        f"steps): its prefill a replay into the used cache, bitwise an "
        f"eager prefill into a fresh init_cache (logits and every cache "
        f"leaf), launching nothing through the wrappers; its first "
        f"{CHECK_REPLAYS} decode replays bitwise eager steps; launches "
        f"{json.dumps(sec['launches'])} (= the eager comparisons: 1 "
        f"prefill, {sec['step_calls']} steps)")
    DECODE_PROGRAMS["dense granite-3-2b"] = dict(r["program"], batch=b)
    PREFILL_PROGRAMS["dense granite-3-2b"] = r["prefill"]
    del params, prompt, second
    torch.cuda.empty_cache()
    reduced_programs(dev)
    return r["launches"]


def reduced_programs(dev) -> None:
    """Phase 7's reduced families: each of REDUCED_DECODE's archs (vlm,
    ssm) at d 256, f32, on both routes, prefilled through a
    ``PrefillProgram`` (:func:`program_prefill`: a replay held to the
    warm prefill bitwise) and decoded greedily through a
    ``DecodeProgram`` (:func:`program_greedy`: its first replays held to
    eager steps bitwise), its greedy logits held to an eager run of the
    same steps on another cache to ``ATT_TOL["float32"]`` (the eager
    decode is the program's body), and finite."""
    import torch
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import DecodeProgram, Model, PrefillProgram
    z = REDUCED_DECODE
    rows = []
    for arch in z["archs"]:
        for impl in ("ref", "kernel"):
            cfg = dataclasses.replace(
                reduced(ARCHS[arch], d_model=z["d_model"]), attn_impl=impl)
            gen = torch.Generator(device=dev).manual_seed(z["seed"])
            mk = Model(cfg, dev)
            params = mk.init(gen)
            batch = {"tokens": torch.randint(
                0, cfg.vocab, (z["batch"], z["prompt"]), generator=gen,
                device=dev)}
            if cfg.family == "vlm":
                batch["patches"] = torch.randn(
                    (z["batch"], cfg.n_image_tokens, cfg.d_model),
                    generator=gen, device=dev)
            p = z["prompt"] + cfg.n_image_tokens
            max_seq = z["max_seq"] + cfg.n_image_tokens
            program = DecodeProgram(mk, params,
                                    mk.init_cache(z["batch"], max_seq))
            pp = PrefillProgram(mk, params, program.cache)
            last, _ = program_prefill(pp, batch, f"reduced {arch} {impl}")
            twin = {k: v.clone() for k, v in program.cache.items()}
            tok = last[:, -1].argmax(-1, keepdim=True)
            g = program_greedy(program, tok, p, z["steps"],
                               f"reduced {arch} {impl}")
            err = 0.0
            for t, fed in enumerate(g["fed"]):
                want = mk.decode_step(params, twin, fed, p + t)[0][:, -1]
                err = max(err, allclose_err(g["outs"][t], want,
                                            ATT_TOL["float32"])[1])
                if not bool(torch.isfinite(g["outs"][t]).all()):
                    fail(f"reduced {arch} {impl}: non-finite logits")
            if err > 0:
                fail(f"reduced {arch} {impl}: the program's greedy logits "
                     f"exceed {ATT_TOL['float32']} of the eager steps' by "
                     f"{err}")
            key = pp.key(batch)
            rows.append(f"{arch} ({cfg.family}) {impl}: prefill nodes "
                        f"{pp.graphs[key].nodes}, {z['steps']} steps, "
                        f"{program.replays} replays, nodes {program.nodes}")
            del program, pp, twin, params, mk
    torch.cuda.empty_cache()
    say(f"phase7 reduced families through PrefillProgram and "
        f"DecodeProgram (d {z['d_model']}, f32, B {z['batch']}, from "
        f"position {z['prompt']} past the cache's last slot): "
        f"{'; '.join(rows)}; the first prefill replay bitwise the warm "
        f"prefill, cache addresses unchanged; every step replay's greedy "
        f"logits within {ATT_TOL['float32']} of eager steps, the first "
        f"{CHECK_REPLAYS} bitwise")


def serve_one_role(dev, cfg, z: dict, role: str, phase: int) -> int:
    """``cfg`` served as the one role ``role`` (the launcher's HV share,
    deadline multiple, β and costs, from ``z``): ``ServableModel.from_arch``
    at (B 1, S ``z["seq"]``) — a CUDA graph of the forward — calibrated
    by the launcher's ``probe_p95`` (replays), a GEMS stream of
    ``z["serve_ms"]``, one replay under the profiler and one held to an
    eager forward bitwise.  The replays the engine ran must equal the
    forwards it asked for.  The model is freed before returning; returns
    the forwards that launched the kernel wrappers (the warm forward,
    the capture and the eager check)."""
    import torch
    from repro_torch.core.schedulers import make_policy
    from repro_torch.core.task import ModelProfile
    from repro_torch.launch import serve as launch
    from repro_torch.serve.engine import ServableModel, ServeEngine
    from repro_torch.serve.engine import run_stream
    calls = {"forward": 0}
    lock = threading.Lock()
    t0 = time.perf_counter()
    prof = ModelProfile(name=role, beta=z["beta"], deadline=1.0,
                        t_edge=1.0, t_cloud=1.0, cost_edge=z["cost_edge"],
                        cost_cloud=z["cost_cloud"], qoe_beta=100.0,
                        qoe_alpha=0.9, qoe_window=5_000.0)
    sm = ServableModel.from_arch(prof, cfg, batch=1, seq=z["seq"],
                                 device=dev)
    run = sm.run

    def counted():
        out = run()
        with lock:
            calls["forward"] += 1
        return out
    sm = dataclasses.replace(sm, run=counted)
    t95 = launch.probe_p95(sm)
    fps = min(60.0, z["share"] * 1000.0 / t95)
    prof = dataclasses.replace(prof, deadline=z["deadline_p95"] * t95
                               + 30.0, t_edge=t95, t_cloud=t95 * 0.7 + 60.0)
    sm = dataclasses.replace(sm, profile=prof)
    build_s = time.perf_counter() - t0
    engine = ServeEngine(make_policy("GEMS"), {role: sm},
                         cloud_concurrency=4, seed=0)
    replays0, calls0 = sm.graph.replays, calls["forward"]
    res = run_stream(engine, {role: fps}, z["serve_ms"])
    if sm.graph.replays - replays0 != calls["forward"] - calls0:
        fail(f"{cfg.name} serve: graph replays "
             f"{sm.graph.replays - replays0} != forwards run "
             f"{calls['forward'] - calls0}")
    st = res.per_model[role]
    done = (st.edge_success + st.edge_miss + st.cloud_success
            + st.cloud_miss + st.dropped)
    if done > st.generated or res.completed <= 0:
        fail(f"{cfg.name} serve: {res.completed} completed, {done} outcomes "
             f"of {st.generated} generated")
    n_k, busy, fwd_wall = profile_call(sm.run)
    check_graph_logits(f"{cfg.name} ({cfg.family})", sm)
    say(f"phase{phase} {cfg.name} bf16 {cfg.n_layers} layers "
        f"({cfg.param_count()} parameters): from_arch (warm forward, "
        f"CUDA-graph capture) + probe_p95 in {build_s:.1f} s, p95 of one "
        f"replay {t95:.3f} ms, {fps:.2f} FPS, deadline "
        f"{prof.deadline:.0f} ms; GEMS {z['serve_ms'] / 1e3:.0f} s: "
        f"generated {res.generated}, completed {res.completed}, completion "
        f"rate {res.completion_rate:.4f}, QoS utility {res.qos_utility}, "
        f"QoE utility {res.qoe_utility}; forwards (graph replays) "
        f"{calls['forward']}; profile of one replay: {n_k} device kernels, "
        f"busy {busy:.3f} ms of {fwd_wall:.3f} ms wall "
        f"({busy / fwd_wall:.3f}); one replay == an eager forward bitwise; "
        f"peak memory {torch.cuda.max_memory_allocated()} B")
    forwards = graph_forwards(sm) + 1              # + the eager check
    del sm, engine, run, counted
    torch.cuda.empty_cache()
    return forwards


def phase_hybrid(dev) -> dict:
    """Phase 13, the hybrid path at published width and depth (zamba2-7b,
    81 layers, bf16, ``attn_impl="kernel"``): served as one role by
    :func:`serve_one_role`, then greedy decoding held against the plain
    and f32 paths.  Every model kernel's launches over the phase must
    equal the path's exactly; returns them.  Then, after those counts are
    read, :func:`bodies_on_path` times the served forward with each bf16
    scan body and with each rmsnorm body."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(ARCHS["zamba2-7b"], attn_impl="kernel")
    z = ZAMBA2
    torch.cuda.synchronize()
    reset_model_counts()
    forwards = serve_one_role(dev, cfg, z, "ZAMBA2", 13)
    serve_counts, serve_tc = model_counts(), tc_counts()
    gen = torch.Generator(device=dev).manual_seed(z["seed"])
    params = Model(cfg, dev).init(gen)
    prompt = torch.randint(0, cfg.vocab, (1, z["prompt"]), generator=gen,
                           device=dev)
    r = greedy_vs_yardsticks(dev, cfg, params, prompt, z["steps"],
                             z["max_seq"])
    launches = {k: serve_counts[k] + r["launches"][k] for k in serve_counts}
    check_launches("hybrid zamba2-7b serve + decode", launches,
                   path_launches(cfg, forwards=forwards,
                                 prefills=r["prefill_calls"],
                                 steps=r["step_calls"]))
    check_tc("hybrid zamba2-7b serve + decode", launches,
             {k: serve_tc[k] + r["tc"][k] for k in serve_tc}, bf16=True)
    say(f"phase13 decode zamba2-7b bf16 "
        f"{decode_line(r, 1, z['prompt'], z['steps'])}")
    say(f"phase13 {program_line('zamba2-7b', 1, r['program'])}")
    say(f"phase13 {prefill_line('zamba2-7b', r['prefill'])}")
    DECODE_PROGRAMS["hybrid zamba2-7b"] = dict(r["program"], batch=1)
    PREFILL_PROGRAMS["hybrid zamba2-7b"] = r["prefill"]
    say(f"phase13 launches over the phase: {json.dumps(launches)} = "
        f"{forwards} eager forwards and captures (the graph's replays "
        f"launch nothing through the wrappers), {r['prefill_calls']} "
        f"prefills (the program's warm prefill and capture), "
        f"{r['step_calls']} steps (the program's warm step, capture and "
        f"checks) × the path's per-call counts; every flash launch on the "
        f"tensor cores, every ssm_scan launch ({serve_tc['ssm_scan']} + "
        f"{r['tc']['ssm_scan']}) on the chunked tensor-core body, every "
        f"rmsnorm launch ({serve_tc['rmsnorm']} + {r['tc']['rmsnorm']}) on "
        f"the REGS body")
    del params, prompt
    torch.cuda.empty_cache()
    bodies_on_path(dev, cfg, z, ("ssm_scan", "rmsnorm"))
    return launches


def body_switch(kernel: str):
    """How phase 13 sends every launch of a redesigned model kernel to
    its previous body for one capture: (module, the name of its route
    rule, a rule that names the previous body, the count of the new
    body's launches, the new and previous bodies' names)."""
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssm_scan as SS
    return {"ssm_scan": (SS, "scan_route", lambda *a: SS.SEQ,
                         "tc_launch_count", "chunked", "previous"),
            "rmsnorm": (RN, "norm_plan", lambda *a: RN.PREVIOUS_PLAN,
                        "reg_launch_count", "regs", "previous")}[kernel]


def bodies_on_path(dev, cfg, z: dict, kernels: tuple) -> None:
    """The served zamba2-7b forward of phase 13 (``from_arch``'s weights
    and tokens: seed 0, (B 1, S ``z["seq"]``)), for each of ``kernels``
    captured twice as a :class:`GraphForward` on one set of weights: with
    the kernel's route rule as it stands (every launch on the new body)
    and with that rule patched, for that capture only, to send every
    launch to the previous body (:func:`body_switch`).  Then, in the
    order new, previous, previous, new, each graph's ``probe_p95`` and
    the device busy ms of one profiled replay: the two bodies end to end
    in one call.  Launches made here are not the path's (phase 13's
    counts are read before); each capture must have taken the body it
    names."""
    import torch
    from repro_torch.launch import serve as launch
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GraphForward
    model = Model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    b = {"tokens": torch.randint(0, cfg.vocab, (1, z["seq"]), generator=gen,
                                 device=dev)}

    def fwd():
        return model.forward(params, b)[0]

    for kernel in kernels:
        mod, rule_name, previous_rule, count, new, old = body_switch(kernel)
        graphs = {}
        for name in (new, old):
            n0, k0 = mod.launch_count, getattr(mod, count)
            rule = getattr(mod, rule_name)
            if name == old:
                setattr(mod, rule_name, previous_rule)
            try:
                graphs[name] = GraphForward(fwd, dev)
            finally:
                setattr(mod, rule_name, rule)
            n, k = mod.launch_count - n0, getattr(mod, count) - k0
            if n == 0 or k != (n if name == new else 0):
                fail(f"phase13 {kernel} {name} capture: {n} launches, {k} "
                     f"on the {new} body")
        rows = []
        for name in (new, old, old, new):
            g = graphs[name]
            t95 = launch.probe_p95(types.SimpleNamespace(run=g))
            n_k, busy, wall = profile_call(g)
            rows.append(f"{name} p95 {t95:.3f} ms, busy {busy:.3f} ms of "
                        f"{wall:.3f} ms wall ({n_k} kernels)")
        ln, lo = graphs[new]().float(), graphs[old]().float()
        if not bool(torch.isfinite(ln).all() and torch.isfinite(lo).all()):
            fail(f"phase13: a {kernel} body's logits are not finite")
        rel = float((ln - lo).pow(2).mean().sqrt() / ln.pow(2).mean().sqrt())
        say(f"phase13 zamba2-7b served forward by {kernel} body, in this "
            f"call (CUDA-graph replays, order {new}, {old}, {old}, {new}): "
            f"{'; '.join(rows)}; logits relative RMS {new} vs {old} "
            f"{rel:.4g}")
        del graphs
        torch.cuda.empty_cache()
    del params, model
    torch.cuda.empty_cache()


def _bound(nbytes: float, ops: float, ops_per_s: float) -> tuple:
    """(least ms, "bytes" or "operations") for moving ``nbytes`` at the
    card's memory rate and doing ``ops`` at ``ops_per_s``."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = ops / ops_per_s * 1e3
    return max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations"


def _prof_us(fn, name: str, n: int = 20, windows: int = 3):
    """Mean device µs of the kernels named ``name`` over ``n`` calls of
    ``fn`` in a ``torch.profiler`` trace (None if no trace shows one).
    On the H100 machine a trace taken late in the script has been seen
    to hold only some of the window's kernel records, or none, so an
    empty window is traced again, up to ``windows`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in pr.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.name]
        if evs:
            return sum(e.time_range.elapsed_us() for e in evs) / len(evs)
    return None


def decode_row(dev, b, h, kv, w, hd, n) -> dict:
    """Flash decode in bf16 at (B, H, KV, W, hd) with ``n`` valid rows a
    batch row, on the model's transposed (B,W,KV,hd) cache views: device
    ms per call of the split-KV kernel, of the previous one-block-per-(b,
    h) body (``_route=PREVIOUS``), of the plain version and of
    ``scaled_dot_product_attention`` on the valid prefix (timed only),
    beside the bound: each valid K and V row read once, q read and out
    written once, the lengths read."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    bf = torch.bfloat16
    ck = torch.randn(b, w, kv, hd, device=dev, dtype=bf)
    cv = torch.randn(b, w, kv, hd, device=dev, dtype=bf)
    q = torch.randn(b, h, hd, device=dev, dtype=bf)
    lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    row = {name: graph_ms(fn) for name, fn in (
        ("kernel", lambda: DA.cuda_decode_attention(q, kt, vt, lengths)),
        ("previous", lambda: DA.cuda_decode_attention(
            q, kt, vt, lengths, _route=DA.PREVIOUS)),
        ("plain", lambda: ref.ref_decode_attention(q, kt, vt, lengths)),
        ("library", lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt[:, :, :n], vt[:, :, :n],
            enable_gqa=kv != h)))}
    nbytes = 2 * (2 * b * kv * n * hd + 2 * q.numel()) + 4 * b
    row["bound"], row["bound_by"] = _bound(nbytes, 4 * b * h * n * hd,
                                           BF16_OPS_PER_S)
    row["profile_us"] = _prof_us(
        lambda: DA.cuda_decode_attention(q, kt, vt, lengths), "decode_split")
    row["splits, chunk"] = DA.plan_splits(w, b, kv)
    return row


def flash_row(dev, b, h, kv, s, hd, causal: bool = True) -> dict:
    """Flash attention in bf16 at (B, H, KV, S, hd), causal or not, on
    the model's transposed (B,S,H,hd) views: device ms per call of the
    kernel, of its previous CUDA-core bf16 body (``_route=CORE``), of the
    plain version and of ``scaled_dot_product_attention`` (timed only),
    beside the bound (q, k and v read once, out written once; the
    products of the pairs the mask keeps at the tensor cores' rate)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    bf = torch.bfloat16
    q = torch.randn(b, s, h, hd, device=dev, dtype=bf).transpose(1, 2)
    k = torch.randn(b, s, kv, hd, device=dev, dtype=bf).transpose(1, 2)
    v = torch.randn(b, s, kv, hd, device=dev, dtype=bf).transpose(1, 2)
    iters = 20 if s > 128 else 200
    row = {name: graph_ms(fn, iters=iters) for name, fn in (
        ("kernel", lambda: FA.cuda_flash_attention(q, k, v, causal=causal)),
        ("previous", lambda: FA.cuda_flash_attention(
            q, k, v, causal=causal, _route=FA.CORE)),
        ("plain", lambda: ref.ref_attention(q, k, v, causal=causal)),
        ("library", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)))}
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    pairs = s * (s + 1) // 2 if causal else s * s
    row["bound"], row["bound_by"] = _bound(nbytes, 4 * hd * b * h * pairs,
                                           BF16_OPS_PER_S)
    row["profile_us"] = _prof_us(
        lambda: FA.cuda_flash_attention(q, k, v, causal=causal),
        "flash_tc_kernel")
    return row


def phase_times(dev) -> dict:
    """Phase 8: device ms per call (CUDA-graph replay) of each attention
    kernel at the serve and decode shapes (granite, starcoder2,
    nemotron-4-340b; flash also at B 8 × S 512), beside its plain
    version's, ``scaled_dot_product_attention``'s (timed only; the port
    never calls it) and the bound; plus each kernel's mean time in a
    profiler trace.  Every row adds ``previous``, timed in the same
    call: flash attention's earlier CUDA-core bf16 body (``_route=
    CORE``), flash decode's earlier one-block-per-(b, h) body
    (``_route=PREVIOUS``).  Phase 14 adds the zamba2 shapes (hd 112) and
    the RMSNorm and selective-scan kernels through :func:`kernel_times`."""
    out = {}
    floor = floor_ms()

    for key, shape in (("flash serve granite", (1, 32, 8, 64, 64)),
                       ("flash serve starcoder2", (1, 24, 2, 64, 128)),
                       ("flash B8 S512", (8, 32, 8, 512, 64)),
                       ("flash serve nemotron", (1, 96, 8, 64, 192))):
        out[key] = flash_row(dev, *shape)
        out[key]["floor"] = floor

    for key, shape in (("decode B8 W1024 L576", (8, 32, 8, 1024, 64, 576)),
                       ("decode starcoder2 B8 W1024 L576",
                        (8, 24, 2, 1024, 128, 576)),
                       ("decode nemotron B8 W1024 L576",
                        (8, 96, 8, 1024, 192, 576))):
        out[key] = decode_row(dev, *shape)
        out[key]["floor"] = floor
    say_times(8, out)
    return out


def say_times(phase: int, rows: dict) -> None:
    for key, row in rows.items():
        prev = (f"previous {row['previous']:.6f}, "
                if "previous" in row else "")
        plan = (f"; (splits, chunk) {row['splits, chunk']}"
                if "splits, chunk" in row else "")
        plan += "".join(f"; {k} {row[k]}" for k in (
            "kernel cold", "previous cold") if k in row)
        if "plan" in row:
            plan += (f"; plan (route, vpt, warps a row, rows a block, "
                     f"threads) {row['plan']}; ptxas {row['registers']}")
        say(f"phase{phase} {key} (bf16): device ms per call (graph replay) "
            f"kernel {row['kernel']:.6f}, {prev}plain {row['plain']:.6f}, "
            f"library {row['library']}; floor {row['floor']:.6f}; bound "
            f"{row['bound']:.6f} ms ({row['bound_by']}); profile µs per "
            f"launch {row['profile_us']}{plan}")


def kernel_times(dev) -> dict:
    """Phase 14: the zamba2 path's kernels at its serve and decode shapes,
    bf16, as phase 8 times the others, each row beside the launch floor
    (:func:`floor_ms`): ``rmsnorm`` at every path shape (``RMS_SHAPES``)
    beside its previous body, its plain version and
    ``torch.nn.functional.rms_norm`` (timed only; the port never calls
    it), with the plan it took and its instantiation's registers, and at
    the prefill shapes also on inputs that miss the L2 (``cold``), ``ssm_scan`` on the model's views at (B 1, S 64, H 112, P = N =
    64) beside its previous sequential body (no one PyTorch call computes
    it), flash attention at (1, 32, 64,
    112) beside its previous CUDA-core body, and flash decode at (1, 32,
    W 160, 112) with 144 valid rows, both beside
    ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssm_scan as SS
    bf = torch.bfloat16
    out = {}

    floor, load_floor = floor_ms(), load_floor_ms()
    say(f"phase14 launch floor: a one-element fill_ {floor:.6f} ms, a "
        f"one-element copy_ (a load, then a store) {load_floor:.6f} ms a "
        f"launch (graph replay)")
    ptx = ptxas_rows(_build.BUILD_LOG.get(RN.KERNEL, {}).get("ptxas", ""))
    for rows, d in RMS_SHAPES:
        x = torch.randn(rows, d, device=dev, dtype=bf)
        scale = torch.randn(d, device=dev, dtype=bf) + 1.0
        row = {name: graph_ms(fn) for name, fn in (
            ("kernel", lambda: RN.cuda_rmsnorm(x, scale)),
            ("previous", lambda: RN.cuda_rmsnorm(x, scale,
                                                 _route=RN.PREVIOUS)),
            ("plain", lambda: ref.ref_rmsnorm(x, scale)),
            ("library", lambda: F.rms_norm(x, (d,), scale, 1e-5)))}
        row["floor"] = floor
        # read x and scale once, write y once; square, sum, scale, multiply
        row["bound"], row["bound_by"] = _bound(
            2 * (2 * x.numel() + scale.numel()), 4 * x.numel(),
            F32_OPS_PER_S)
        row["profile_us"] = _prof_us(lambda: RN.cuda_rmsnorm(x, scale),
                                     "rmsnorm_rows_kernel")
        plan = RN.view_plan(x, scale)
        row["plan"] = plan
        inst = f"rmsnorm_rows_kernel<bfloat16, bfloat16, {plan[1]}, {plan[2]}>"
        row["registers"] = next((r.split(": ", 1)[1] for r in ptx
                                 if r.startswith(inst + ":")),
                                "built before this run (no ptxas record)")
        if x.numel() * 2 >= 4 << 20:
            # the same launches on buffers that together pass the 50 MB
            # L2: each launch finds its x cold, as a caller whose x was
            # written long before would
            copies = -(-120_000_000 // (4 * x.numel()))
            xs = [x] + [torch.randn_like(x) for _ in range(copies - 1)]
            for name, route in (("kernel cold", None),
                                ("previous cold", RN.PREVIOUS)):
                ring = itertools.cycle(xs)
                row[name] = graph_ms(lambda: RN.cuda_rmsnorm(
                    next(ring), scale, _route=route))
            del xs
        out[f"rmsnorm ({rows}, {d})"] = row

    b, s, h, p, n = 1, 64, 112, 64, 64
    views = scan_views(dev, bf, b, s, h, p, n, seed=5)
    row = {"kernel": graph_ms(lambda: SS.cuda_ssm_scan(*views)),
           "previous": graph_ms(lambda: SS.cuda_ssm_scan(
               *views, _route=SS.SEQ)),
           "plain": graph_ms(lambda: ref.ref_selective_scan(*views),
                             iters=5),
           "library": None}
    # x, dt, B, C (shared by the heads: read once), a, y and the final
    # state, each once; the chunked body's operations, its f32 ones
    # counted in tensor-core time at the ratio of the two rates
    nbytes = 2 * (2 * b * h * s * p + b * h * s + 2 * b * s * n
                  + b * h * p * n) + 4 * h
    mma, f32 = scan_chunked_ops(b, h, s, p, n)
    row["bound"], row["bound_by"] = _bound(
        nbytes, mma + f32 * BF16_OPS_PER_S / F32_OPS_PER_S, BF16_OPS_PER_S)
    row["profile_us"] = _prof_us(lambda: SS.cuda_ssm_scan(*views),
                                 "ssm_chunk_kernel")
    row["floor"] = floor
    out["ssm_scan (B1, S64, H112, P64, N64)"] = row

    b, h, s, hd = 1, 32, 64, 112
    q, k, v = (torch.randn(b, s, h, hd, device=dev, dtype=bf).transpose(1, 2)
               for _ in range(3))
    row = {name: graph_ms(fn) for name, fn in (
        ("kernel", lambda: FA.cuda_flash_attention(q, k, v)),
        ("previous", lambda: FA.cuda_flash_attention(q, k, v,
                                                     _route=FA.CORE)),
        ("plain", lambda: ref.ref_attention(q, k, v)),
        ("library", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)))}
    row["bound"], row["bound_by"] = _bound(
        2 * 4 * q.numel(), 4 * hd * b * h * s * (s + 1) // 2, BF16_OPS_PER_S)
    row["profile_us"] = _prof_us(lambda: FA.cuda_flash_attention(q, k, v),
                                 "flash_tc_kernel")
    row["floor"] = floor
    out["flash serve zamba2 (1, 32, 64, 112)"] = row

    out["decode zamba2 B1 W160 L144"] = decode_row(dev, 1, 32, 32, 160, 112,
                                                   144)
    out["decode zamba2 B1 W160 L144"]["floor"] = floor
    say_times(14, out)
    return out


def scan_chunked_ops(b, h, s, p, n, q: int = 64) -> tuple[int, int]:
    """(tensor-core FLOPs, f32 operations) of the chunked scan body at
    (B, S, H, P, N) with B and C shared by the heads, chunk by chunk of
    ``q`` steps (the last one ragged): G = C·Bᵀ on the causal pairs once a
    batch row; a head's M·x on the causal pairs and its (x∘w)ᵀ·B twice
    each (the f32 operand's bf16 hi and lo), its carried-state term
    (C∘exp(cum))·Sᵀ three times, after the first chunk; M's exponent,
    difference and two products in f32 on the causal pairs."""
    mma = f32 = 0
    for t0 in range(0, s, q):
        ln = min(q, s - t0)
        pairs = ln * (ln + 1) // 2
        mma += b * 2 * pairs * n
        mma += b * h * (2 * 2 * pairs * p + 2 * 2 * ln * p * n
                        + (2 * 3 * ln * n * p if t0 else 0))
        f32 += b * h * 4 * pairs
    return mma, f32


def scan_views(dev, dtype, b, s, h, p, n, seed):
    """The selective scan's inputs as the model hands them over: xs and dt
    as transposed views of one input projection, B and C shared by the
    heads through a zero head stride, the f32 decay a stride-0 broadcast."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed)
    di = h * p
    proj = torch.randn(b, s, 2 * di + 2 * n + h, generator=gen, device=dev,
                       dtype=dtype)
    xs = proj[..., di:2 * di].reshape(b, s, h, p)
    bm = proj[..., 2 * di:2 * di + n]
    cm = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = F.softplus(proj[..., 2 * di + 2 * n:])
    a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.3)
    return (xs.transpose(1, 2), dt.transpose(1, 2), a.expand(b, h),
            bm[:, None].expand(b, h, s, n), cm[:, None].expand(b, h, s, n))


def check_norm_scan_kernels(dev) -> tuple[dict, dict]:
    """Phase 2's RMSNorm and selective-scan cases, each kernel against its
    plain version on the same card tensors: ``tests/test_kernels.py``'s
    shapes (RMSNorm (2,128,256), (4,96,512), (1,1,64), (300,128); the scan
    (4,256,64,64), (2,128,32,16), (8,512,64,64) and the carry case), a D
    that is not a multiple of 8, strided and unaligned rows, and the
    paths' shapes (RMSNorm on (1|64|128|512, 3584), (8|64|1024|4096,
    2048), (64, 3072), (1|64, 18432), scale in the other dtype; the scan
    at S 64, 100, 128, 256 and 512 with B/C at a zero head stride through
    the model's views).  RMSNorm runs each case on the body its plan
    names (views off the 16-byte width and D 1003 on the previous body,
    every other on REGS, checked) and, where that is REGS, on the
    previous body too (key "<dtype> previous").  The scan also runs ragged chunks (S 37, 70,
    100, 130), N 128, P 128, B/C per head, x at a zero head stride, views
    off the 16-byte width and P, N off multiples of 8; every bf16 case on
    the 16-byte width must take the chunked tensor-core body and also runs
    the previous sequential body (key "bfloat16 previous"), the two off it
    must take the sequential body, and at the zamba2 views of S ≤ 128 the
    chunked
    body is also held to :func:`ref.ref_chunked_scan`, the emulation of
    its arithmetic.  RMSNorm is also held to the model's plain
    ``rms_norm`` in f32.  Returns ({kernel: {key: max |err|}}, case
    counts)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.models import layers as L
    gen = torch.Generator(device=dev).manual_seed(20241232)
    errs = {"rmsnorm": {}, "ssm_scan": {}}
    cases = dict.fromkeys(errs, 0)

    def record(kernel, dname, got, want, tol, what):
        torch.cuda.synchronize()
        err, excess = allclose_err(got, want, tol)
        if not excess <= 0.0:
            fail(f"{kernel} {what} {dname}: kernel differs from the plain "
                 f"version (max |err| {err}, tolerance {tol})")
        errs[kernel][dname] = max(errs[kernel].get(dname, 0.0), err)
        cases[kernel] += 1

    for dname, td in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(td)

        tol = RMS_TOL[dname]

        def norm(what, x, scale, route=None):
            """``ops.rmsnorm`` on the body its plan names (``route`` where
            given), counted on REGS exactly when the plan names it; where
            it does, the previous body too (key "<dtype> previous")."""
            plan = RN.view_plan(x, scale)
            if route is not None and plan[0] != route:
                fail(f"rmsnorm {what} {dname}: plan {plan}, want route "
                     f"{route}")
            want = ref.ref_rmsnorm(x, scale)
            r0 = RN.reg_launch_count
            record("rmsnorm", dname, ops.rmsnorm(x, scale), want, tol, what)
            if RN.reg_launch_count - r0 != (plan[0] == RN.REGS):
                fail(f"rmsnorm {what} {dname}: plan {plan}, but "
                     f"{RN.reg_launch_count - r0} REGS launches")
            if plan[0] == RN.REGS:
                record("rmsnorm", f"{dname} previous", RN.cuda_rmsnorm(
                    x, scale, _route=RN.PREVIOUS), want, tol, what)

        for shape in ((2, 128, 256), (4, 96, 512), (1, 1, 64), (300, 128),
                      (3, 5, 1003), (1, 3584), (64, 3584), (128, 3584),
                      (2, 256, 3584), (8, 2048), (64, 3072), (4096, 2048),
                      (1024, 2048), (64, 18432), (1, 18432)):
            x, scale = rnd(*shape), rnd(shape[-1]) + 1.0
            norm(f"{shape}", x, scale,
                 RN.PREVIOUS if shape[-1] == 1003 else RN.REGS)
            if dname == "float32":
                record("rmsnorm", dname,
                       L.rms_norm(x, scale, 1e-5, "kernel"),
                       L.rms_norm(x, scale, 1e-5), tol,
                       f"{shape} vs the model's rms_norm")
        other = torch.bfloat16 if td == torch.float32 else torch.float32
        for shape in ((64, 3584), (4096, 2048), (1, 18432)):
            norm(f"{shape}, scale in {other}", rnd(*shape),
                 (torch.randn(shape[-1], generator=gen, device=dev)
                  + 1.0).to(other), RN.REGS)
        scale = rnd(3584) + 1.0
        norm("strided rows, copied", rnd(4, 65, 3584)[:, 1:], scale,
             RN.REGS)
        norm("strided rows on the width", rnd(64, 3600)[:, :3584], scale,
             RN.REGS)
        norm("strided rows off the width", rnd(64, 3585)[:, :3584], scale,
             RN.PREVIOUS)
        norm("unaligned rows", rnd(2, 64, 3585)[..., 1:], scale,
             RN.PREVIOUS)

        tol = SCAN_TOL[dname]

        def pad8(t):
            """``t`` copied into a fresh buffer whose last axis is padded
            with zeros to a multiple of 8: on the 16-byte width."""
            n = t.shape[-1]
            out = t.new_zeros(*t.shape[:-1], -(-n // 8) * 8)
            out[..., :n] = t
            return out

        def scan(what, args, chunked=True):
            """The kernel against the plain version on ``args``; a bf16
            launch must take the chunked tensor-core body where
            ``chunked``, the sequential one elsewhere.  bf16 also runs the
            other body: the previous (sequential) one, key "bfloat16
            previous", beside the chunked one; the chunked one on a copy
            padded onto the 16-byte width (zero columns of x, B and C add
            nothing to y or the state) beside the sequential one."""
            want = ref.ref_selective_scan(*args)
            tc0 = SS.tc_launch_count
            bodies = [(dname, ops.ssm_scan(*args))]
            if td == torch.bfloat16:
                if SS.tc_launch_count != tc0 + chunked:
                    fail(f"ssm_scan {what}: a bf16 launch took the "
                         f"{'sequential' if chunked else 'chunked'} body")
            if td == torch.bfloat16 and chunked:
                bodies.append((f"{dname} previous",
                               SS.cuda_ssm_scan(*args, _route=SS.SEQ)))
            elif td == torch.bfloat16:
                x_, dt_, a_, bm_, cm_ = args
                p_, n_ = x_.shape[-1], bm_.shape[-1]
                tc0 = SS.tc_launch_count
                y_, fin_ = SS.cuda_ssm_scan(pad8(x_), dt_, a_, pad8(bm_),
                                            pad8(cm_))
                if SS.tc_launch_count != tc0 + 1:
                    fail(f"ssm_scan {what}: the padded copy missed the "
                         f"chunked body")
                bodies.append((dname, (y_[..., :p_], fin_[..., :p_, :n_])))
            for key, got in bodies:
                for g_, w_, part in zip(got, want, ("y", "final")):
                    record("ssm_scan", key, g_, w_, tol, f"{what} {part}")
            return bodies[0][1]

        for (g, s, p, n) in ((4, 256, 64, 64), (2, 128, 32, 16),
                             (8, 512, 64, 64), (3, 37, 64, 64),
                             (2, 70, 48, 20), (2, 100, 64, 64),
                             (2, 200, 64, 128), (2, 130, 128, 64),
                             (1, 96, 128, 128)):
            x = rnd(g, s, p)
            dt = torch.nn.functional.softplus(rnd(g, s))
            a = -torch.exp(torch.randn(g, generator=gen, device=dev) * 0.3)
            bm, cm = rnd(g, s, n, scale=0.3), rnd(g, s, n, scale=0.3)
            scan(f"{(g, s, p, n)}", (x, dt, a, bm, cm),
                 chunked=p % 8 == n % 8 == 0)
        g, s, p, n = 1, 256, 8, 4                    # the carry case
        ones = dict(device=dev, dtype=td)
        args = (torch.ones(g, s, p, **ones),
                torch.full((g, s), 1e-3, **ones),
                torch.full((g,), -0.01, device=dev),
                torch.ones(g, s, n, **ones), torch.ones(g, s, n, **ones))
        y, _ = scan("carry", args, chunked=False)      # N 4
        if not float(y[0, -1, 0]) > 0.9 * s * 1e-3 * n:
            fail(f"ssm_scan carry {dname}: y[-1] {float(y[0, -1, 0])}")
        for (b, s) in ((1, 64), (1, 128), (2, 256), (1, 512), (1, 100)):
            views = scan_views(dev, td, b, s, 112, 64, 64, seed=s)
            got = scan(f"zamba2 views (B {b}, S {s})", views)
            if td == torch.bfloat16 and s <= 128:
                # the kernel against the emulation of its own arithmetic
                for g_, w_, part in zip(got, ref.ref_chunked_scan(*views),
                                        ("y", "final")):
                    record("ssm_scan", "bfloat16 vs emulation", g_, w_, tol,
                           f"zamba2 views (B {b}, S {s}) {part}")
        # B/C per head (a non-zero head stride: G per head), x at a zero
        # head stride (y keeps P innermost), and views off the 16-byte
        # width, which take the sequential body: x one element into its
        # buffer, B/C at an odd row stride, P and N off multiples of 8
        b, s, h, p, n = 2, 100, 8, 64, 64
        x, dt, a, bm, cm = scan_views(dev, td, b, s, h, p, n, seed=3)
        bh, ch = rnd(b, h, s, n), rnd(b, h, s, n)
        scan("per-head B/C", (x, dt, a, bh, ch))
        scan("x at a zero head stride",
             (x[:, :1].expand(x.shape), dt, a, bm, cm))
        xo = rnd(b, h, s, p + 1)[..., 1:]
        bo, co = rnd(b, h, s, n + 3)[..., :n], rnd(b, h, s, n + 3)[..., :n]
        scan("views off the 16-byte width", (xo, dt, a, bo, co),
             chunked=False)
        scan("P 60, N 20", (rnd(b, h, s, 60), dt, a, rnd(b, h, s, 20),
                            rnd(b, h, s, 20)), chunked=False)
    return errs, cases


def check_moe_gemm(dev) -> tuple[dict, int]:
    """Phase 2's grouped-GEMM cases, the kernel against its plain version
    on the same card tensors (bf16 inputs against the f32 plain version
    of the same values): ``tests/test_kernels.py``'s sweep ((256,64,128,
    4), (512,128,64,8), (128,32,32,3) with random ragged offsets), its
    empty-experts and bf16 cases, ragged T that is not a multiple of 64
    and D, F off the 16-byte vector width, the qwen3-moe path's shapes
    with E 128 on uniform offsets: (768, 2048→768), (768, 768→2048) and
    (128, 2048→768), and for the tensor-core route's row tiles, uniform
    offsets with 1, 6, 16, 17, 81 and 130 rows an expert and ragged ones
    mixing 0 to 130, at the path's D/F and at a D and F off the 64 × 128
    tile (200 → 136), and the split-expert layout's strided views (split
    j of a weight viewed (E, s, D, F), on the vector width and off it).
    Every bf16 case also runs the previous CUDA-core route (``_route=CORE``,
    key "bfloat16 previous").  Rows that no expert owns must be exactly
    zero.  Returns ({dtype: max |err|}, case
    count)."""
    import torch
    from repro_torch.kernels import moe_gemm as MG
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(20241233)
    errs, cases = {}, 0

    def counts_offsets(counts):
        c = torch.tensor([0] + counts, device=dev)
        return c.cumsum(0).int()

    def ragged(t, e):
        cuts = torch.randint(0, t + 1, (e - 1,), generator=gen,
                             device=dev).sort().values
        zero = torch.zeros(1, dtype=cuts.dtype, device=dev)
        return torch.cat([zero, cuts, zero + t]).int()

    def uniform(t, e):
        return (torch.arange(e + 1, device=dev) * (t // e)).int()

    cases_def = [((256, 64, 128, 4), ragged), ((512, 128, 64, 8), ragged),
                 ((128, 32, 32, 3), ragged),
                 ((128, 32, 32, 4), lambda t, e: torch.tensor(
                     [0, 0, t, t, t], dtype=torch.int32, device=dev)),
                 ((256, 64, 64, 4), uniform), ((203, 72, 40, 5), ragged),
                 ((1000, 256, 96, 7), ragged), ((1, 64, 64, 2), ragged),
                 ((77, 33, 17, 3), ragged), ((768, 2048, 768, 128), uniform),
                 ((768, 768, 2048, 128), uniform),
                 ((128, 2048, 768, 128), uniform),
                 ((768, 2048, 768, 128), ragged)]
    # the row tiles: E experts with n rows each, and a ragged mix (the
    # plain version gathers a (T, D, F) f32 weight copy, so E stays small
    # where D·F is 1.5 M)
    mix = [0, 1, 6, 16, 17, 81, 130, 0]
    for (d, f, e) in ((2048, 768, 4), (768, 2048, 4), (200, 136, 16)):
        for n in (1, 6, 16, 17, 81, 130):
            cases_def.append(((n * e, d, f, e),
                              lambda t, e_, n=n: counts_offsets([n] * e_)))
        counts = mix * max(1, e // len(mix))
        cases_def.append(((sum(counts), d, f, len(counts)),
                          lambda t, e_, c=counts: counts_offsets(c)))

    def check(dname, what, got, want, rows=slice(None)):
        tol = MOE_TOL[dname.split()[0]]
        torch.cuda.synchronize()
        err, excess = allclose_err(got[rows], want[rows], tol)
        if not excess <= 0.0:
            fail(f"moe_gemm {what} {dname}: kernel differs from the plain "
                 f"version (max |err| {err}, tolerance {tol})")
        errs[dname] = max(errs.get(dname, 0.0), err)

    for dname, td in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for (t, d, f, e), offs in cases_def:
            x = torch.randn(t, d, generator=gen, device=dev).to(td)
            w = (torch.randn(e, d, f, generator=gen, device=dev)
                 / d ** 0.5).to(td)
            off = offs(t, e)
            want = ref.ref_moe_gemm(x.float(), w.float(), off)
            check(dname, (t, d, f, e), ops.moe_gemm(x, w, off), want)
            if dname == "bfloat16":
                check("bfloat16 previous", (t, d, f, e),
                      MG.cuda_moe_gemm(x, w, off, _route=MG.CORE), want)
            cases += 1
        # rows before offsets[0] and from offsets[E] on: exactly zero, on
        # a shape each route takes (72 → 40 on the tensor cores in bf16)
        x = torch.randn(203, 72, generator=gen, device=dev).to(td)
        w = torch.randn(3, 72, 40, generator=gen, device=dev).to(td)
        off = torch.tensor([16, 40, 40, 150], dtype=torch.int32, device=dev)
        want = ref.ref_moe_gemm(x.float(), w.float(), off)
        routes = [(dname, ops.moe_gemm(x, w, off))]
        if dname == "bfloat16":
            routes.append(("bfloat16 previous",
                           MG.cuda_moe_gemm(x, w, off, _route=MG.CORE)))
        for key, got in routes:
            torch.cuda.synchronize()
            if got[:16].any() or got[150:].any():
                fail(f"moe_gemm uncovered rows {key}: want zeros outside "
                     f"[16, 150)")
            check(key, "uncovered rows", got, want, slice(16, 150))
        cases += 1
        # split j of a weight viewed (E, s, D, F): the split-expert
        # layout's up projections, read in place at the view's expert
        # stride s·D·F (the wrapper copies nothing: each (D, F) block is
        # whole); on the vector width and off it, and every bf16 view on
        # both bodies
        for (t, d, f, e), sp, j in (((256, 64, 128, 4), 2, 1),
                                    ((203, 72, 40, 5), 4, 2),
                                    ((77, 33, 17, 3), 2, 1),
                                    ((336, 768, 1024, 8), 2, 1)):
            x = torch.randn(t, d, generator=gen, device=dev).to(td)
            w = (torch.randn(e, sp, d, f, generator=gen, device=dev)
                 / d ** 0.5).to(td)[:, j]
            if w.stride() != (sp * d * f, f, 1):
                fail(f"moe_gemm strided {(t, d, f, e)}: the view's strides "
                     f"{w.stride()} are not a split's")
            off = ragged(t, e)
            want = ref.ref_moe_gemm(x.float(), w.float(), off)
            what = (t, d, f, e, f"split {j} of {sp}")
            routes = [(dname, ops.moe_gemm(x, w, off))]
            if dname == "bfloat16":
                routes.append(("bfloat16 previous",
                               MG.cuda_moe_gemm(x, w, off, _route=MG.CORE)))
            for key, got in routes:
                check(key, what, got, want)
            cases += 1
    return errs, cases


class RouteLog:
    """Within ``with``, records the experts (g, T, k) of every router call
    of the port's MoE layer, in call order."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.mod, self.real, self.calls = MOE, MOE.router, []

        def spy(p, x, cfg):
            import torch
            out = self.real(p, x, cfg)
            # a CUDA graph's capture computes nothing (and a replay never
            # calls the router): only eager calls are recorded
            if not torch.cuda.is_current_stream_capturing():
                self.calls.append(out[1])
            return out
        MOE.router = spy
        return self

    def __exit__(self, *exc):
        self.mod.router = self.real


def routing_agreement(a: list, b: list, n_layers: int) -> list:
    """Per layer, the share of (token, k) choices that the two routes'
    router calls (the same calls in the same order) have in common."""
    if len(a) != len(b):
        fail(f"routing logs differ in length: {len(a)} != {len(b)}")
    same, total = [0] * n_layers, [0] * n_layers
    for i, (x, y) in enumerate(zip(a, b)):
        hit = (x[..., :, None] == y[..., None, :]).any(-1)
        same[i % n_layers] += int(hit.sum())
        total[i % n_layers] += hit.numel()
    return [s_ / t_ for s_, t_ in zip(same, total)]


def teacher_forced(dev, cfg, params, prompt, steps: int,
                   max_seq: int) -> dict:
    """Greedy decoding under ``cfg`` (``"kernel"``) through a
    ``PrefillProgram`` (:func:`program_prefill`) and a ``DecodeProgram``
    (:func:`program_greedy`), then the same tokens through ``"ref"``
    eagerly on the same weights.  Returns the relative RMS of the logit
    difference over the plain logits' RMS (``rms``), the per-layer
    routing agreement (``agree``) over the warm prefill and the eager
    kernel-route steps (the warm step and the checked ones: a capture
    and a replay never call the router in Python), the kernel launches
    of the kernel route's prefills and steps (``launches``), the
    prefills and steps that launched them (``prefill_calls``,
    ``step_calls``), the first prefill's and the steps' seconds and the
    programs' reports, whose eager steps and prefills launch too
    (``report_steps``, ``report_prefills``)."""
    import torch
    from repro_torch.models.model import DecodeProgram, Model, PrefillProgram
    p = prompt.shape[1]
    batch = {"tokens": prompt}
    mk = Model(cfg, dev)
    mr = Model(dataclasses.replace(cfg, attn_impl="ref"), dev)
    before = model_counts()
    program = DecodeProgram(mk, params, mk.init_cache(prompt.shape[0],
                                                      max_seq))
    pp = PrefillProgram(mk, params, program.cache)
    with RouteLog() as lk:
        last, prefill_s = program_prefill(pp, batch, f"prefill {cfg.name}")
        tok = last[:, -1].argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        g = program_greedy(program, tok, p, steps, f"decode {cfg.name}")
        wall = time.perf_counter() - t0
    after = model_counts()
    report = program_report(program, g, p + steps)
    prefill = prefill_report(pp, batch)
    fed = g["fed"]
    outs = [o[:, :cfg.vocab].float() for o in g["outs"]]
    del program, pp
    with RouteLog() as lr:
        _, cache = mr.prefill(params, {"tokens": prompt}, max_seq)
        sq_d = sq_r = 0.0
        for t in range(steps):
            logits, _ = mr.decode_step(params, cache, fed[t], p + t)
            r_ = logits[:, -1, :cfg.vocab].float()
            if not (torch.isfinite(outs[t]).all() and torch.isfinite(r_).all()):
                fail(f"decode {cfg.name}: non-finite logits at step {t}")
            sq_d += float((outs[t] - r_).square().sum())
            sq_r += float(r_.square().sum())
    # the kernel route's router ran eagerly in the warm prefill, the warm
    # step and the checked steps: those against the same calls of "ref"
    agree = routing_agreement(lk.calls, lr.calls[:len(lk.calls)],
                              cfg.n_layers)
    launches = {k: after[k] - before[k] for k in after}
    return dict(rms=(sq_d / sq_r) ** 0.5, agree=agree, launches=launches,
                step_calls=g["step_calls"], prefill_s=prefill_s, wall=wall,
                prefill_calls=PrefillProgram.eager_prefills
                + PrefillProgram.captures, program=report, prefill=prefill,
                report_steps=EAGER_TIMED + 1, report_prefills=PREFILL_TIMED,
                routed_steps=len(lk.calls) // cfg.n_layers - 1)


def phase_moe(dev) -> dict:
    """Phase 16, the moe path at published width and depth
    (qwen3-moe-30b-a3b, 48 layers, bf16, ``attn_impl="kernel"``): served
    as one role by :func:`serve_one_role`, one forward under
    ``set_sync_debug_mode("error")``, greedy decoding at B 8 held against
    ``"ref"`` on the same weights (relative RMS and routing agreement
    reported), then an f32 copy cut to 8 layers decoded on both routes
    and held to DECODE_F32_TOL.  Every model kernel's launches over the
    phase must equal the path's exactly; returns them."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(ARCHS["qwen3-moe-30b-a3b"], attn_impl="kernel")
    z = QWEN3MOE
    torch.cuda.synchronize()
    reset_model_counts()
    forwards = serve_one_role(dev, cfg, z, "QWEN3MOE", 16)
    gen = torch.Generator(device=dev).manual_seed(z["seed"])
    params = Model(cfg, dev).init(gen)
    b, p = z["batch"], z["prompt"]
    prompt = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    mk = Model(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, aux = mk.forward(params, {"tokens": prompt[:1, :z["seq"]]})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    forwards += 1
    if not (bool(torch.isfinite(logits).all()) and float(aux) > 0.0):
        fail(f"moe forward: non-finite logits or aux {float(aux)}")
    say(f"phase16 sync: one (B 1, S {z['seq']}) forward of qwen3-moe ran "
        f"under set_sync_debug_mode('error'); router aux {float(aux):.6f}")
    del logits
    torch.cuda.reset_peak_memory_stats()
    tf = teacher_forced(dev, cfg, params, prompt, z["steps"], z["max_seq"])
    rms, agree, dec_launches = tf["rms"], tf["agree"], tf["launches"]
    say(f"phase16 decode qwen3-moe bf16 B {b}, prompt {p} (the prefill "
        f"program's warm prefill and capture {tf['prefill_s']:.3f} s), "
        f"{z['steps']} greedy steps in "
        f"{tf['wall']:.3f} s (the warm step, the capture and "
        f"{CHECK_REPLAYS} eager checks among them); kernel launches "
        f"{json.dumps(dec_launches)} ({tf['prefill_calls']} prefills' and "
        f"{tf['step_calls']} steps' worth); "
        f"teacher-forced on the same tokens, RMS of the logit difference "
        f"over RMS of the 'ref' logits {rms:.4e}; routing agreement with "
        f"'ref' per layer over the warm prefill and the "
        f"{tf['routed_steps']} "
        f"eager steps (share of (token, k) choices in common): first "
        f"{agree[0]:.4f}, mean {sum(agree) / len(agree):.4f}, min "
        f"{min(agree):.4f}, last {agree[-1]:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated()} B")
    say(f"phase16 routing agreement by layer: "
        f"{json.dumps([round(a, 4) for a in agree])}")
    say(f"phase16 {program_line('qwen3-moe-30b-a3b', b, tf['program'])}")
    say(f"phase16 {prefill_line('qwen3-moe-30b-a3b', tf['prefill'])}")
    DECODE_PROGRAMS["moe qwen3-moe-30b-a3b"] = dict(tf["program"], batch=b)
    PREFILL_PROGRAMS["moe qwen3-moe-30b-a3b"] = tf["prefill"]
    n_k, busy, pre_wall = profile_call(lambda: mk.prefill(
        params, {"tokens": prompt}, z["max_seq"]))
    rk, rbusy, rwall = tf["prefill"]["replay_profile"]
    say(f"phase16 profile of one B {b} × {p} prefill: eager {n_k} device "
        f"kernels, busy {busy:.3f} ms of {pre_wall:.3f} ms wall; one "
        f"replay of the prefill program {rk} device kernels, busy "
        f"{rbusy:.3f} ms of {rwall:.3f} ms wall")
    del params, mk
    torch.cuda.empty_cache()
    bf16_launches, bf16_tc = model_counts(), tc_counts()
    check_tc("moe qwen3-moe bf16 serve + decode", bf16_launches, bf16_tc,
             bf16=True)

    cfg8 = dataclasses.replace(cfg, n_layers=z["f32_layers"],
                               dtype="float32", param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(z["seed"] + 1)
    params = Model(cfg8, dev).init(gen)
    tf8 = teacher_forced(dev, cfg8, params, prompt, z["steps"],
                         z["max_seq"])
    rms8, agree8, launches8, wall8 = (tf8["rms"], tf8["agree"],
                                      tf8["launches"], tf8["wall"])
    if not rms8 <= DECODE_F32_TOL:
        fail(f"decode qwen3-moe f32 {cfg8.n_layers} layers: 'kernel' vs "
             f"'ref' relative RMS {rms8} > {DECODE_F32_TOL}")
    say(f"phase16 decode qwen3-moe f32 {cfg8.n_layers} layers B {b}: "
        f"'kernel' vs 'ref' teacher-forced relative RMS {rms8:.4e} (tol "
        f"{DECODE_F32_TOL}); routing agreement per layer "
        f"{json.dumps([round(a, 4) for a in agree8])}; {z['steps']} steps in "
        f"{wall8:.3f} s; kernel launches {json.dumps(launches8)}")
    del params
    torch.cuda.empty_cache()
    launches = model_counts()
    # the profiled eager prefill beside each run's program prefills
    pre = tf["prefill_calls"] + tf["report_prefills"] + 1
    pre8 = tf8["prefill_calls"] + tf8["report_prefills"]
    want = path_launches(cfg, forwards=forwards, prefills=pre,
                         steps=tf["step_calls"] + tf["report_steps"])
    want8 = path_launches(cfg8, prefills=pre8,
                          steps=tf8["step_calls"] + tf8["report_steps"])
    check_launches("moe qwen3-moe serve + decode", launches,
                   {k: want[k] + want8[k] for k in want})
    check_tc("moe qwen3-moe f32 copy",
             {k: v - bf16_launches[k] for k, v in launches.items()},
             {k: v - bf16_tc[k] for k, v in tc_counts().items()},
             bf16=False)
    say(f"phase16 launches over the phase: {json.dumps(launches)} = "
        f"{forwards} eager forwards and captures, {pre} prefills and "
        f"{tf['step_calls'] + tf['report_steps']} steps at 48 layers (the "
        f"prefill program's warm prefill and capture, the timed eager "
        f"prefills and the profiled one; the step program's warm step, "
        f"capture and checks, the timed eager steps), {pre8} prefills and "
        f"{tf8['step_calls'] + tf8['report_steps']} "
        f"steps at {cfg8.n_layers}, × "
        f"the path's per-call counts; new-body launches of the bf16 "
        f"model {json.dumps(bf16_tc)}: every bf16 flash and moe launch on "
        f"the tensor cores (none of the f32 copy's), every rmsnorm on "
        f"REGS (the f32 copy's too)")
    return launches


def phase_nemotron(dev) -> dict:
    """Phase 18, hd 192 on the path: nemotron-4-340b at its published
    width (d 18432, 96 heads, 8 KV heads, hd 192, d_ff 73728, vocab
    256000, squared ReLU) cut to ``NEMOTRON["layers"]`` layers, bf16,
    ``attn_impl="kernel"``: one (B 1, S 64) forward, then a 64-token
    prefill and greedy decode steps, held against ``attn_impl="ref"`` on
    the same weights (the forward's logits, and the steps teacher-forced
    on the kernel route's tokens) by the relative RMS of the logit
    difference.  The kernel launches must be exactly the path's, every
    flash launch on the tensor cores; returns them."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import DecodeProgram, Model, PrefillProgram
    z = NEMOTRON
    cfg = dataclasses.replace(ARCHS["nemotron-4-340b"], n_layers=z["layers"],
                              attn_impl="kernel")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(z["seed"])
    mk = Model(cfg, dev)
    params = mk.init(gen)
    mr = Model(dataclasses.replace(cfg, attn_impl="ref"), dev)
    tokens = torch.randint(0, cfg.vocab, (1, z["seq"]), generator=gen,
                           device=dev)
    max_seq = z["seq"] + z["steps"]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_model_counts()
    t0 = time.perf_counter()
    fk = mk.forward(params, {"tokens": tokens})[0]
    program = DecodeProgram(mk, params, mk.init_cache(1, max_seq))
    pp = PrefillProgram(mk, params, program.cache)
    batch = {"tokens": tokens}
    last, _ = program_prefill(pp, batch, f"prefill {cfg.name}")
    tok = last[:, -1].argmax(-1, keepdim=True)
    g = program_greedy(program, tok, z["seq"], z["steps"], cfg.name)
    fed, outs = g["fed"], g["outs"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tc = model_counts(), tc_counts()
    prefills = pp.eager_prefills + pp.captures
    check_launches("nemotron-4-340b", launches, path_launches(
        cfg, forwards=1, prefills=prefills, steps=g["step_calls"]))
    check_tc("nemotron-4-340b", launches, tc, bf16=True)
    report = program_report(program, g, z["seq"] + z["steps"])
    prefill = prefill_report(pp, batch)
    del program, pp

    def rel(a, b):
        a, b = a[..., :cfg.vocab].float(), b[..., :cfg.vocab].float()
        return float((a - b).square().sum() / b.square().sum()) ** 0.5

    fr = mr.forward(params, {"tokens": tokens})[0]
    fwd_rms = rel(fk, fr)
    _, cache_r = mr.prefill(params, {"tokens": tokens}, max_seq)
    num = den = 0.0
    agree = 0
    for t in range(z["steps"]):
        lr = mr.decode_step(params, cache_r, fed[t], z["seq"] + t)[0][:, -1]
        num += float((outs[t][..., :cfg.vocab].float()
                      - lr[..., :cfg.vocab].float()).square().sum())
        den += float(lr[..., :cfg.vocab].float().square().sum())
        agree += int(torch.equal(outs[t].argmax(-1), lr.argmax(-1)))
    dec_rms = (num / den) ** 0.5
    finite = bool(torch.isfinite(fk).all()) and all(
        bool(torch.isfinite(o).all()) for o in outs)
    if not (finite and fwd_rms <= NEMOTRON_TOL and dec_rms <= NEMOTRON_TOL):
        fail(f"nemotron-4-340b 'kernel' vs 'ref': finite {finite}, relative "
             f"RMS forward {fwd_rms}, decode {dec_rms} (tol {NEMOTRON_TOL})")
    say(f"phase18 nemotron-4-340b bf16 published width, {cfg.n_layers} "
        f"layers ({cfg.param_count()} parameters, init {init_s:.1f} s, peak "
        f"memory {torch.cuda.max_memory_allocated()} B): forward (B 1, S "
        f"{z['seq']}), prefill and {z['steps']} greedy steps on 'kernel' "
        f"(a PrefillProgram and a DecodeProgram: the warm call, the "
        f"capture, replays) in "
        f"{wall:.3f} s; against 'ref' on the same weights, relative RMS of "
        f"the logit difference: forward {fwd_rms:.4e}, teacher-forced "
        f"decode {dec_rms:.4e} (tol {NEMOTRON_TOL}); greedy tokens equal "
        f"at {agree} of {z['steps']} steps; kernel launches "
        f"{json.dumps(launches)} (= the path's: the forward, {prefills} "
        f"prefills (warm and capture), "
        f"{g['step_calls']} steps' worth; every flash launch on the tensor "
        f"cores)")
    say(f"phase18 {program_line(cfg.name, 1, report)}")
    say(f"phase18 {prefill_line(cfg.name, prefill)}")
    DECODE_PROGRAMS["dense nemotron-4-340b (2 layers)"] = dict(report,
                                                              batch=1)
    PREFILL_PROGRAMS["dense nemotron-4-340b (2 layers)"] = prefill
    del params, cache_r, fk, fr, outs, mk, mr
    torch.cuda.empty_cache()
    return launches


def phase_whisper(dev) -> dict:
    """Phase 23, the encdec path at published width and depth
    (whisper-medium, 24 + 24 layers, bf16, ``attn_impl="kernel"``):
    served as one role by :func:`serve_one_role` (``from_arch`` gives it
    its 1,500 zero frames; one forward is one ``GraphForward``), then a
    48-token prompt over random frames and greedy decoding held against
    the plain and f32 paths.  Every model kernel's launches over the
    phase must equal the path's exactly; then flash attention at the
    encoder's (1, 16, 1500, 64) non-causal shape and flash decode at
    whisper's published decoder context (B 8, W 448, length 440) are
    timed as phase 8 times the others.  Returns the launches and the
    timed rows."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(ARCHS["whisper-medium"], attn_impl="kernel")
    z = WHISPER
    torch.cuda.synchronize()
    reset_model_counts()
    forwards = serve_one_role(dev, cfg, z, "WHISPER", 23)
    serve_counts, serve_tc = model_counts(), tc_counts()
    gen = torch.Generator(device=dev).manual_seed(z["seed"])
    params = Model(cfg, dev).init(gen)
    prompt = torch.randint(0, cfg.vocab, (1, z["prompt"]), generator=gen,
                           device=dev)
    frames = torch.randn((1, cfg.n_frames, cfg.d_model), generator=gen,
                         device=dev)
    r = greedy_vs_yardsticks(dev, cfg, params, prompt, z["steps"],
                             z["max_seq"], extra={"frames": frames})
    launches = {k: serve_counts[k] + r["launches"][k] for k in serve_counts}
    check_launches("encdec whisper-medium serve + decode", launches,
                   path_launches(cfg, forwards=forwards,
                                 prefills=r["prefill_calls"],
                                 steps=r["step_calls"]))
    check_tc("encdec whisper-medium serve + decode", launches,
             {k: serve_tc[k] + r["tc"][k] for k in serve_tc}, bf16=True)
    say(f"phase23 decode whisper-medium bf16 (frames {cfg.n_frames}) "
        f"{decode_line(r, 1, z['prompt'], z['steps'])}")
    say(f"phase23 {program_line('whisper-medium', 1, r['program'])}")
    say(f"phase23 {prefill_line('whisper-medium', r['prefill'])}")
    DECODE_PROGRAMS["encdec whisper-medium"] = dict(r["program"], batch=1)
    PREFILL_PROGRAMS["encdec whisper-medium"] = r["prefill"]
    say(f"phase23 launches over the phase: {json.dumps(launches)} = "
        f"{forwards} eager forwards and captures, {r['prefill_calls']} "
        f"prefills (the program's warm prefill and capture), "
        f"{r['step_calls']} steps (warm, capture, checks) × the path's "
        f"per-call counts (a forward "
        f"{json.dumps(path_launches(cfg, forwards=1))}, a step "
        f"{json.dumps(path_launches(cfg, steps=1))}); every flash launch "
        f"on the tensor cores, every rmsnorm launch on the REGS body")
    del params, prompt, frames
    torch.cuda.empty_cache()
    floor = floor_ms()
    rows = {"flash whisper encoder (1,16,1500,64) non-causal":
            flash_row(dev, 1, 16, 16, cfg.n_frames, cfg.hd, causal=False),
            "decode whisper B8 W448 L440": decode_row(dev, 8, 16, 16, 448,
                                                      cfg.hd, 440)}
    for row in rows.values():
        row["floor"] = floor
    say_times(23, rows)
    return dict(launches=launches, times=rows)


def trees_equal(a: dict, b: dict) -> bool:
    """Every leaf of two parameter or moment trees bitwise equal."""
    import torch
    from repro_torch.train.optimizer import tree_leaves
    return all(torch.equal(x.detach(), y.detach())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def states_match(p1, s1, p2, s2) -> bool:
    """Parameters, moments and step count of two trainings bitwise."""
    return (trees_equal(p1, p2) and trees_equal(s1.mu, s2.mu)
            and trees_equal(s1.nu, s2.nu) and int(s1.step) == int(s2.step))


def check_program(phase: str, prog, state, steps: int, ptr: int) -> None:
    """A program that warmed, captured and replayed every later step,
    its step count read from the state's own tensor."""
    if prog.graph is None or prog.replays != steps - 1:
        fail(f"phase {phase}: the train program replayed {prog.replays} of "
             f"{steps} steps (graph {prog.graph is not None}): every step "
             f"after the first must replay")
    if state.step.data_ptr() != ptr or int(state.step) != steps:
        fail(f"phase {phase}: the step count reads {int(state.step)} "
             f"(want {steps}) or left its storage")


def eager_train(dev, cfg, z: dict) -> dict:
    """``train``'s run without its program: the same init (a generator on
    the card seeded 0), the same ``FastSyntheticLM`` batches, each step
    through ``make_train_step``; the losses, step p50, peak memory and a
    profile of one more step."""
    import torch
    from repro_torch.data.pipeline import FastSyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.train.loop import batch_tensors, make_train_step
    from repro_torch.train.optimizer import AdamW
    torch.cuda.reset_peak_memory_stats()
    model, opt = Model(cfg, dev), AdamW(lr=z["lr"])
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)
    step = make_train_step(model, opt)
    data = FastSyntheticLM(vocab=cfg.vocab, seq_len=z["seq"],
                           batch=z["batch"], seed=0).batches()
    losses, stamps = [], []
    for _ in range(z["steps"]):
        loss, params, state = step(params, state,
                                   batch_tensors(cfg, next(data), dev))
        losses.append(float(loss))
        stamps.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated()
    fb = batch_tensors(cfg, one_more_batch(cfg, z), dev)
    prof = profile_call(lambda: step(params, state, fb))
    step_s = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    return dict(losses=losses, p50=step_s[len(step_s) // 2], peak=peak,
                prof=prof)


def one_more_batch(cfg, z: dict) -> dict:
    """The batch the profile of one more step takes (data seed 1)."""
    from repro_torch.data.pipeline import FastSyntheticLM
    return next(FastSyntheticLM(vocab=cfg.vocab, seq_len=z["seq"],
                                batch=z["batch"], seed=1).batches())


def captured_train(dev, cfg, z: dict, phase: str) -> dict:
    """``train`` as ``launch/train.py --full`` runs it (its program
    captured): the losses, step p50 (steps 2 on: replays), first step,
    peak memory, wall, the capture's numbers and a profile of one more
    replay."""
    import torch
    from repro_torch.train.loop import train
    stamps = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses = train(cfg, steps=z["steps"], batch=z["batch"],
                          seq_len=z["seq"], lr=z["lr"], log_every=1,
                          log=lambda _: stamps.append(time.perf_counter()),
                          device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prog = state.program
    check_program(phase, prog, state.opt_state, z["steps"],
                  state.opt_state.step.data_ptr())
    out = dict(losses=losses, peak=peak, wall=wall, first=stamps[0] - t0,
               nodes=prog.nodes, capture_s=prog.capture_s,
               instantiate_s=prog.instantiate_s)
    out["prof"] = profile_call(lambda: prog(one_more_batch(cfg, z)))
    step_s = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    out["p50"] = step_s[len(step_s) // 2]
    out["steps_ms"] = [round(x * 1e3, 1) for x in step_s]
    del state, prog
    torch.cuda.empty_cache()
    return out


def phase_train_sweep(dev) -> None:
    """Phase 24 (d): each arch's reduced variant (f32, ``"ref"``), 3 steps
    of ``make_train_step`` against a ``TrainProgram``'s warm step and 2
    replays from the same weights and batches: losses, parameters,
    moments and step count bitwise."""
    import torch
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.pipeline import FastSyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.train.loop import (TrainProgram, batch_tensors,
                                        make_train_step)
    from repro_torch.train.optimizer import AdamW
    t0 = time.perf_counter()
    nodes = {}
    for arch in sorted(ARCHS):
        cfg = reduced(ARCHS[arch])
        data = FastSyntheticLM(vocab=cfg.vocab, seq_len=16, batch=2,
                               seed=24).batches()
        raws = [next(data) for _ in range(3)]
        model, opt = Model(cfg, dev), AdamW(lr=3e-3)

        def fresh():
            p = model.init(torch.Generator(device=dev).manual_seed(24))
            return p, opt.init(p)
        params, state = fresh()
        step = make_train_step(model, opt)
        losses = []
        for r in raws:
            loss, params, state = step(params, state,
                                       batch_tensors(cfg, r, dev))
            losses.append(float(loss))
        cparams, cstate = fresh()
        ptr = cstate.step.data_ptr()
        prog = TrainProgram(model, opt, cparams, cstate)
        closses = [float(prog(r)) for r in raws]
        check_program(f"24 (d) {arch}", prog, cstate, len(raws), ptr)
        if closses != losses or not states_match(cparams, cstate, params,
                                                 state):
            fail(f"phase 24 (d) {arch}: the replayed steps differ from the "
                 f"eager ones (losses {closses} vs {losses})")
        nodes[arch] = prog.nodes
        del prog, params, state, cparams, cstate, step
    torch.cuda.empty_cache()
    say(f"phase24 (d) each reduced arch, 3 eager steps = a warm step and 2 "
        f"replays bitwise (losses, parameters, moments, step): graph nodes "
        f"{json.dumps(nodes)}; {time.perf_counter() - t0:.1f} s")


def phase_train(dev) -> dict:
    """Phase 24, the trainer (the ``"ref"`` route, as the JAX package
    trains; no kernel launches): (a) granite-3-2b at full width, 2
    layers, f32, B 2 × S 64, from the golden's numpy weights and
    ``FastSyntheticLM`` batches, ``make_train_step`` for its steps,
    against ``tests/golden/torch_port_train.json``, and a
    ``TrainProgram`` on the same weights and batches bitwise those eager
    steps; (b) granite-3-2b at its published size (40 layers, bf16
    parameters, f32 moments, remat), 10 steps at B 8 × S 128, first
    eagerly (``train``'s init and batches through ``make_train_step``),
    then through ``train`` as ``launch/train.py --full`` runs it, its
    step captured: the two runs' losses bitwise, every loss finite and
    the last below the first, step p50, tokens/s and peak memory of
    each, the capture's seconds and nodes, a profile of one more eager
    step and of one more replay; (c) the same loss on the kernel route
    with parameters that require grad raises the dispatch's forward-only
    error; (d) :func:`phase_train_sweep`.  Returns (b)'s captured run."""
    import torch
    from repro_torch import convert
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.pipeline import FastSyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.train.loop import (TrainProgram, batch_tensors,
                                        make_train_step)
    from repro_torch.train.optimizer import AdamW, tree_leaves
    gold = json.load(open(GOLDEN_TRAIN))
    cfg = dataclasses.replace(
        ARCHS[gold["arch"]], n_layers=gold["n_layers"], dtype=gold["dtype"],
        param_dtype=gold["dtype"], attn_impl="ref")
    reset_model_counts()
    t0 = time.perf_counter()

    def golden_params():
        return convert.params_from_numpy(
            cfg, convert.random_numpy_params(cfg, gold["weight_seed"]), dev)
    params = golden_params()
    model = Model(cfg, dev)
    opt = AdamW(lr=gold["lr"])
    state = opt.init(params)
    data = FastSyntheticLM(vocab=cfg.vocab, seq_len=gold["seq"],
                           batch=gold["batch"],
                           seed=gold["data_seed"]).batches()
    raws = [next(data) for _ in range(gold["steps"])]
    batches = [batch_tensors(cfg, r, dev) for r in raws]
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(model.loss(params, batches[0]), leaves)
    norm = float(sum(g.double().square().sum() for g in grads)) ** 0.5
    del grads
    step = make_train_step(model, opt)
    losses = []
    for b in batches:
        loss, params, state = step(params, state, b)
        losses.append(float(loss))

    def rel(got, want):
        return abs(got - want) / abs(want)

    def golden_errs(losses, params) -> dict:
        errs = dict(loss0=rel(losses[0], gold["losses"][0]),
                    grad_norm=rel(norm, gold["grad_norm"]),
                    later=max(rel(a, b) for a, b in zip(
                        losses[1:], gold["losses"][1:])))
        sums = {}
        for group, sub in params.items():
            for name, t in (sub.items() if isinstance(sub, dict)
                            else [(None, sub)]):
                a = t.detach().double()
                key = f"{group}.{name}" if name else group
                want = gold["param_sums"][key]
                scale = (want["sumsq"] * want["numel"]) ** 0.5
                sums[key] = (rel(float(a.square().sum()), want["sumsq"]),
                             abs(float(a.sum()) - want["sum"]) / scale)
        errs["sumsq"] = max(v[0] for v in sums.values())
        errs["sum"] = max(v[1] for v in sums.values())
        if not (errs["loss0"] <= TRAIN_TOL and errs["grad_norm"] <= TRAIN_TOL
                and errs["later"] <= TRAIN_STEP_TOL
                and errs["sumsq"] <= TRAIN_STEP_TOL
                and errs["sum"] <= TRAIN_STEP_TOL):
            fail(f"train golden: relative errors {json.dumps(errs)} (want "
                 f"loss0 and grad_norm ≤ {TRAIN_TOL}, the rest ≤ "
                 f"{TRAIN_STEP_TOL}); losses {losses} vs {gold['losses']}")
        return errs
    errs = golden_errs(losses, params)
    # the same steps through the program: a warm step, then replays
    cparams = golden_params()
    cstate = opt.init(cparams)
    ptr = cstate.step.data_ptr()
    prog = TrainProgram(model, opt, cparams, cstate)
    closses = [float(prog(r)) for r in raws]
    check_program("24 (a)", prog, cstate, len(raws), ptr)
    cerrs = golden_errs(closses, cparams)
    if closses != losses or not states_match(cparams, cstate, params,
                                             state):
        fail(f"phase 24 (a): the program's steps differ from the eager "
             f"ones (losses {closses} vs {losses})")
    say(f"phase24 (a) train golden {gold['arch']} full width × "
        f"{gold['n_layers']} layers f32 'ref', B {gold['batch']} × S "
        f"{gold['seq']}, {gold['steps']} AdamW steps: losses {losses} "
        f"(JAX {gold['losses']}), step-0 gradient norm {norm} (JAX "
        f"{gold['grad_norm']}); relative errors {json.dumps(errs)}; the "
        f"program ({prog.nodes} graph nodes, capture {prog.capture_s:.3f} "
        f"s, {prog.replays} replays) bitwise the eager steps, its errors "
        f"{json.dumps(cerrs)}; {time.perf_counter() - t0:.1f} s")
    del prog, cparams, cstate

    # (c) on the kernel route the loss refuses autograd
    mk = Model(dataclasses.replace(cfg, attn_impl="kernel"), dev)
    refused = ""
    try:
        mk.loss(params, batches[0])
    except RuntimeError as e:
        refused = str(e)
    if "forward-only" not in refused:
        fail(f"phase 24 (c): a loss on the kernel route with parameters "
             f"that require grad did not raise the forward-only error "
             f"({refused!r})")
    with torch.no_grad():
        fwd = mk.forward(params, batches[0])[0]
    if not bool(torch.isfinite(fwd[..., :cfg.vocab]).all()):
        fail("phase 24 (c): the kernel route's forward under no_grad is "
             "not finite")
    kernel_launches = model_counts()
    reset_model_counts()
    del params, state, batches, model, mk, fwd, step, leaves
    torch.cuda.empty_cache()
    say(f"phase24 (c) the kernel route refused autograd: {refused!r}; its "
        f"forward under no_grad finite, launches {json.dumps(kernel_launches)}")

    # (b) launch/train's --full path at published size: eager, then
    # captured from the same seed
    z = TRAIN_FULL
    full = ARCHS[z["arch"]]
    tokens = z["batch"] * z["seq"]
    t0 = time.perf_counter()
    eager = eager_train(dev, full, z)
    torch.cuda.empty_cache()
    eager_wall = time.perf_counter() - t0
    got = captured_train(dev, full, z, "24 (b)")
    losses = got["losses"]
    train_launches = model_counts()
    ek, ebusy, ewall = eager["prof"]
    ck, cbusy, cwall = got["prof"]
    say(f"phase24 (b) train {z['arch']} --full ({full.param_count()} "
        f"parameters, {full.n_layers} layers, {full.param_dtype} parameters,"
        f" f32 moments, remat {full.remat}) {z['steps']} steps at B "
        f"{z['batch']} × S {z['seq']}, lr {z['lr']}, on 'ref': eager "
        f"losses {eager['losses']}, step p50 {eager['p50'] * 1e3:.1f} ms, "
        f"{tokens / eager['p50']:.1f} tokens/s, peak {eager['peak']} B, "
        f"wall {eager_wall:.1f} s; profile of one more eager step: {ek} "
        f"device kernels, busy {ebusy:.3f} ms of {ewall:.3f} ms wall "
        f"({ebusy / ewall:.3f})")
    say(f"phase24 (b) captured (train(), the launcher's path): losses "
        f"{losses} (bitwise the eager: {losses == eager['losses']}); "
        f"{got['nodes']} graph nodes, capture {got['capture_s']:.3f} s, "
        f"instantiate {got['instantiate_s']:.3f} s, first step (init, warm "
        f"step, capture) {got['first'] * 1e3:.1f} ms; replay p50 "
        f"{got['p50'] * 1e3:.1f} ms (steps 2-{z['steps']}: "
        f"{got['steps_ms']} ms sorted), {tokens / got['p50']:.1f} "
        f"tokens/s, peak memory {got['peak']} B, wall {got['wall']:.1f} s; "
        f"profile of one more replay: {ck} device kernels, busy "
        f"{cbusy:.3f} ms of {cwall:.3f} ms wall ({cbusy / cwall:.3f}); "
        f"model kernel launches {json.dumps(train_launches)}")
    if losses != eager["losses"]:
        fail(f"phase 24 (b): the captured losses {losses} differ from the "
             f"eager {eager['losses']}")
    finite = all(math.isfinite(x) for x in losses)
    if not (finite and losses[-1] < losses[0]):
        fail(f"phase 24 (b): {z['arch']} --full losses {losses}: want all "
             f"finite and the last below the first")
    if any(train_launches.values()):
        fail(f"phase 24: the training path launched model kernels "
             f"{json.dumps(train_launches)}")
    phase_train_sweep(dev)
    return got


def moe_times(dev) -> dict:
    """Phase 17: ``moe_gemm`` at the qwen3-moe path's shapes, bf16, as
    phase 8 times the others — serve (B 1, S 64: C 6, 768 rows) for
    ``we_g`` (2048→768) and ``we_d`` (768→2048), decode (B 8: C 1, 128
    rows) and prefill (B 8 × 128: C 81, 10,368 rows) on uniform offsets,
    and the serve's 512 routed pairs compacted over 128 experts (ragged
    offsets, no padding) — beside the previous CUDA-core bf16 body
    (``_route=CORE``, timed in the same call), the plain version,
    ``torch.bmm`` over the (E, C, D) view (the uniform shapes) and
    ``torch._grouped_mm`` (the ragged one, where the card's torch has
    it); both timed only, the port never calls them."""
    import torch

    from repro_torch.kernels import moe_gemm as MG
    from repro_torch.kernels import ref
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(17)
    e = 128
    out = {}
    floor = floor_ms()
    for key, (c, d, f) in (("serve we_g (768, 2048→768)", (6, 2048, 768)),
                           ("serve we_d (768, 768→2048)", (6, 768, 2048)),
                           ("decode we_g (128, 2048→768)", (1, 2048, 768)),
                           ("prefill we_g (10368, 2048→768)",
                            (81, 2048, 768))):
        t = e * c
        x = torch.randn(t, d, generator=gen, device=dev).to(bf)
        w = (torch.randn(e, d, f, generator=gen, device=dev)
             / d ** 0.5).to(bf)
        off = (torch.arange(e + 1, device=dev) * c).int()
        xe = x.view(e, c, d)
        row = {"kernel": graph_ms(lambda: MG.cuda_moe_gemm(x, w, off),
                                  iters=20),
               "previous": graph_ms(lambda: MG.cuda_moe_gemm(
                   x, w, off, _route=MG.CORE), iters=20),
               "plain": graph_ms(lambda: ref.ref_moe_gemm(x, w, off),
                                 iters=2, replays=3)
               if c <= 6 else None,
               "library": graph_ms(lambda: torch.bmm(xe, w), iters=20)}
        nbytes = 2 * (x.numel() + w.numel() + t * f) + 4 * (e + 1)
        row["bound"], row["bound_by"] = _bound(nbytes, 2 * t * d * f,
                                               BF16_OPS_PER_S)
        row["profile_us"] = _prof_us(lambda: MG.cuda_moe_gemm(x, w, off),
                                     "moe_gemm_tc_kernel")
        out[key] = row
        del x, w, xe
    # ragged: 512 (token, k) pairs of the serve shape, compacted
    counts = torch.bincount(torch.randint(0, e, (512,), generator=gen,
                                          device=dev), minlength=e)
    off = torch.cat([torch.zeros(1, device=dev, dtype=torch.long),
                     counts.cumsum(0)]).int()
    d, f, t = 2048, 768, 512
    x = torch.randn(t, d, generator=gen, device=dev).to(bf)
    w = (torch.randn(e, d, f, generator=gen, device=dev) / d ** 0.5).to(bf)
    row = {"kernel": graph_ms(lambda: MG.cuda_moe_gemm(x, w, off), iters=20),
           "previous": graph_ms(lambda: MG.cuda_moe_gemm(
               x, w, off, _route=MG.CORE), iters=20),
           "plain": graph_ms(lambda: ref.ref_moe_gemm(x, w, off), iters=2,
                             replays=3)}
    used = int((counts > 0).sum())
    if hasattr(torch, "_grouped_mm"):
        ends = off[1:].contiguous()
        got = torch._grouped_mm(x, w, offs=ends)
        want = ref.ref_moe_gemm(x.float(), w.float(), off)
        err = float((got.float() - want).abs().max())
        row["library"] = graph_ms(
            lambda: torch._grouped_mm(x, w, offs=ends), iters=20)
        row["library_note"] = f"torch._grouped_mm, max |err| {err:.3e}"
    else:
        row["library"] = None
        row["library_note"] = "torch._grouped_mm absent"
    # only the experts that own rows need their weights
    nbytes = 2 * (x.numel() + used * d * f + t * f) + 4 * (e + 1)
    row["bound"], row["bound_by"] = _bound(nbytes, 2 * t * d * f,
                                           BF16_OPS_PER_S)
    row["profile_us"] = _prof_us(lambda: MG.cuda_moe_gemm(x, w, off),
                                 "moe_gemm_tc_kernel")
    out[f"ragged 512 pairs over {used} experts (512, 2048→768)"] = row
    for key, row in out.items():
        row["floor"] = floor
        say(f"phase17 moe_gemm {key} (bf16): device ms per call (graph "
            f"replay) kernel {row['kernel']:.6f}, previous (CUDA cores) "
            f"{row['previous']:.6f}, floor {floor:.6f}, plain {row['plain']}, "
            f"library {row['library']} "
            f"({row.get('library_note', 'torch.bmm over (E, C, D)')}); bound "
            f"{row['bound']:.6f} ms ({row['bound_by']}); profile µs per "
            f"launch {row['profile_us']}")
    return out

def phase_mesh(golden: dict, sweep: dict) -> dict:
    """Phase 25: the fleet entry points under a mesh at world size 1.

    ``make_host_mesh()`` starts a one-rank ``nccl`` group and gives the
    ``(1, 1)`` ``("data", "model")`` mesh; a ``(1, 1)`` ``("replica",
    "edge")`` mesh rides the same group.  Phase 20's seed batch and its
    padded ``run_batch``, ``run_registry_sweep(mesh="auto")`` (no mesh at
    world size 1) and the paper-scale DEMS-COOP ``run_fleet(mesh=)`` are
    each held bitwise to the unsharded result (phase 20's golden-checked
    ones; phase 4's golden summary).  A size-1 axis splits nothing: the
    paper-scale mesh run replays the graphs the unsharded run before it
    captured (no new capture) and launches as many ``masked_argext``."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import task
    from repro_torch.kernels import sched_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.obs.prof import CompileCounter
    from repro_torch.obs.trace import TraceSpec
    from repro_torch.scenarios.compile import compile_registry_batch
    from repro_torch.scenarios.runner import fleet_summary, run_registry_sweep
    from repro_torch.sim import fleet as F

    t_phase = time.perf_counter()
    host = make_host_mesh()
    grid = init_device_mesh("cuda", (1, 1),
                            mesh_dim_names=("replica", "edge"))
    gold = json.load(open(GOLDEN_SWEEP))
    dt, dur = gold["dt"], gold["duration_ms"]
    spec = TraceSpec.full(hist_bins=gold["hist_bins"],
                          hist_max_ms=gold["hist_max_ms"])
    pols, seeds = tuple(gold["policies"]), tuple(gold["seeds"])

    # (a) phase 20's seed batch on the (1, 1) grid
    sb = gold["seed_batch"]
    models = [task.TABLE1[n] for n in task.ACTIVE]
    sig = F.stack_signals([F.default_signals(
        len(models), n_edges=sb["n_edges"],
        drones_per_edge=sb["drones_per_edge"], duration_ms=dur, dt=dt,
        seed=s, device="cuda") for s in sb["seeds"]])
    res = F.run_fleet_batch(models, sb["policy"], sig, dt=dt,
                            edge_frac=sb["edge_frac"],
                            cloud_frac=sb["cloud_frac"],
                            cloud_slots=sb["cloud_slots"], trace=spec,
                            mesh=grid, device="cuda")
    if not all(torch.equal(a, b) for a, b in zip(leaves(res),
                                                  leaves(sweep["seed_batch"]))):
        fail("phase 25: the seed batch under the (1, 1) mesh differs from "
             "phase 20's")
    # (b) the padded sweep batch through run_batch on the grid
    batch, _ = compile_registry_batch(None, pols, seeds, dt=dt,
                                      duration_ms=dur, device="cuda")
    got = [a.cpu().numpy() for a in leaves(F.run_batch(batch, dt=dt,
                                                       mesh=grid))]
    if len(got) != len(sweep["padded_plain"]) or not all(
            np.array_equal(a, b)
            for a, b in zip(got, sweep["padded_plain"])):
        fail("phase 25: run_batch under the (1, 1) mesh differs from "
             "phase 20's padded batch")
    del batch, got
    # (c) the traced sweep with mesh="auto"
    rows = run_registry_sweep(None, pols, seeds, dt=dt, duration_ms=dur,
                              trace=spec, mesh="auto", device="cuda")
    for a, b in zip(rows, sweep["padded_rows"]):
        if ({k: v for k, v in a.items() if k != "trace"}
                != {k: v for k, v in b.items() if k != "trace"}
                or not all(np.array_equal(x, y) for x, y in
                           zip(leaves(a["trace"]), leaves(b["trace"])))):
            fail(f"phase 25: run_registry_sweep(mesh='auto') row "
                 f"{a['scenario']} {a['policy']} differs from phase 20's")
    if len(rows) != len(sweep["padded_rows"]):
        fail("phase 25: run_registry_sweep(mesh='auto') lost rows")
    # (d) paper-scale DEMS-COOP: unsharded, then under the host mesh
    coop = next(r for r in golden["runs"] if r["name"] == "paper-dems-coop")
    csig = golden_signals(golden, coop, "cuda")
    kw = dict(dt=golden["dt"], edge_frac=golden["edge_frac"],
              cloud_frac=golden["cloud_frac"],
              cloud_slots=golden["cloud_slots"], device="cuda")
    # the first run captures the program's graphs; the mesh run and a
    # second unsharded run replay them
    walls, finals, launches, captured = {}, {}, {}, {}
    for mode, mesh in (("first", None), ("mesh", host),
                       ("unsharded", None)):
        sched_ops.reset_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CompileCounter() as cc:
            finals[mode] = F.run_fleet(models_of(coop["models"]),
                                       coop["policy"], csig, mesh=mesh,
                                       **kw)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
        launches[mode] = sched_ops.launch_counts()[0]
        captured[mode] = cc.count
        if fleet_summary(finals[mode]) != coop["summary"]:
            fail(f"phase 25 paper-dems-coop {mode}: summary off the golden")
    if not (states_equal(finals["first"], finals["mesh"])
            and states_equal(finals["first"], finals["unsharded"])):
        fail("phase 25: run_fleet under the host mesh differs from the "
             "unsharded run")
    if len(set(launches.values())) != 1 or launches["mesh"] <= 0:
        fail(f"phase 25: masked_argext launches {launches} differ")
    if captured["mesh"] or captured["unsharded"]:
        fail(f"phase 25: graphs captured {captured}: the mesh run must "
             f"replay the unsharded run's graphs")
    prog = F._fleet_program(golden["dt"], golden["edge_frac"],
                            golden["cloud_frac"],
                            F.FleetPolicy.from_name(
                                coop["policy"]).coop_max_transfers,
                            TraceSpec(), False)
    nodes = [g.nodes / F.RUN_WINDOW_TICKS for g in prog.graphs.values()]
    ticks = int(csig.times.shape[0])
    say(f"phase25 mesh at world size 1 ({host}, {grid}): seed batch "
        f"{sb['n_edges']} edges × {len(sb['seeds'])} seeds, padded "
        f"run_batch, run_registry_sweep(mesh='auto') "
        f"({len(rows)} rows) and paper DEMS-COOP run_fleet(mesh=) each "
        f"bitwise the unsharded result; paper DEMS-COOP graphs captured "
        f"{json.dumps(captured)} (the first run's replayed by the mesh "
        f"run), nodes a tick {[round(n, 1) for n in nodes]}; masked_argext "
        f"launches {json.dumps(launches)}; {ticks} ticks: "
        + ", ".join(f"{k} {w:.3f} s ({ticks / w:.2f} ticks/s)"
                    for k, w in walls.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return dict(host=host, launches=launches, walls=walls, nodes=nodes)


def opt_decode_run(dev, host, dtype: str, seed: int) -> dict:
    """One opt_decode comparison of phase 26 in ``dtype``: the base and
    the opt_decode step from copies of one prefill's cache, the base's
    greedy tokens fed to both; per step the logits of both, and the
    caches, step times and launches at the end."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.sharding import sharding_rules
    from repro_torch.models.model import Model
    z = OPT_DECODE
    cfg = dataclasses.replace(ARCHS[z["arch"]], n_layers=z["layers"],
                              dtype=dtype, param_dtype=dtype,
                              attn_impl="kernel")
    base = Model(cfg, dev)
    opt = Model(dataclasses.replace(cfg, opt_decode=True), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = base.init(gen)
    prompt = torch.randint(0, cfg.vocab, (z["batch"], z["prompt"]),
                           generator=gen, device=dev)
    reset_model_counts()
    times = {"base": [], "opt": []}
    logits, counts = [], {}
    with torch.no_grad(), sharding_rules(host):
        last, cache = base.prefill(params, {"tokens": prompt},
                                   z["prompt"] + z["steps"])
        caches = {"base": cache, "opt": {k: v.clone()
                                         for k, v in cache.items()}}
        tok = last[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        pre = model_counts()
        for step in range(z["steps"]):
            pos = z["prompt"] + step
            out = {}
            for name, m in (("base", base), ("opt", opt)):
                before = model_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[name] = m.decode_step(params, caches[name], tok, pos)[0]
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
                after = model_counts()
                for k in after:
                    counts.setdefault(name, {}).setdefault(k, 0)
                    counts[name][k] += after[k] - before[k]
            b, o = (out[n][:, -1, :cfg.vocab].float() for n in ("base",
                                                               "opt"))
            logits.append((b, o))
            tok = b.argmax(-1, keepdim=True)
    if counts["base"].get("decode_attention") != z["layers"] * z["steps"] \
            or counts["opt"].get("decode_attention"):
        fail(f"phase 26 {dtype}: decode_attention launches "
             f"{json.dumps(counts)}; want {z['layers']} a base step, none "
             f"under opt_decode")
    del params
    return dict(logits=logits, caches=caches, times=times, counts=counts,
                pre=pre)


def phase_opt_decode(dev, host) -> dict:
    """Phase 26: ``opt_decode`` against the base decode step on
    qwen2-72b (published width, 2 layers, ``"kernel"``), both under
    ``sharding_rules`` of the host mesh: one 512-token prefill, then 16
    greedy steps (the base's tokens fed to both) from two copies of its
    cache (:func:`opt_decode_run`).  In bf16 layer 0's cache bitwise (its
    inputs are the same), every layer's cache and every step's logits
    within ``OPT_DECODE_TOL`` of the base's largest, and the step times
    (host clock to a synchronize) side by side; then in f32 layer 0's
    cache bitwise and the rest within ``OPT_DECODE_F32_TOL``, the JAX
    test's limits."""
    import torch
    z = OPT_DECODE
    r = opt_decode_run(dev, host, "bfloat16", z["seed"])
    cb, co = r["caches"]["base"], r["caches"]["opt"]
    layer0 = all(torch.equal(cb[k][0], co[k][0]) for k in ("k", "v"))
    cache_err = max(float((co[k].float() - cb[k].float()).abs().max()
                          / cb[k].float().abs().max()) for k in ("k", "v"))
    errs = [float((o - b).abs().max() / b.abs().max())
            for b, o in r["logits"]]
    agree = sum(int((o.argmax(-1) == b.argmax(-1)).sum())
                for b, o in r["logits"])
    if not layer0:
        fail("phase 26: layer 0's cache under opt_decode differs from the "
             "base step's")
    if max(errs) > OPT_DECODE_TOL or cache_err > OPT_DECODE_TOL:
        fail(f"phase 26: opt_decode logits {max(errs):.3e} / cache "
             f"{cache_err:.3e} off the base (tol {OPT_DECODE_TOL})")
    times = r["times"]
    p50 = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    n = z["batch"] * z["steps"]
    say(f"phase26 opt_decode {z['arch']} full width × {z['layers']} layers "
        f"bf16 'kernel', B {z['batch']} from {z['prompt']} tokens, "
        f"{z['steps']} greedy steps under sharding_rules(host mesh): layer "
        f"0's cache bitwise, cache max rel Δ {cache_err:.3e}, logits max "
        f"rel Δ {max(errs):.3e} (tol {OPT_DECODE_TOL}), greedy agreement "
        f"{agree}/{n}; step p50 base {p50['base']:.3f} ms, opt "
        f"{p50['opt']:.3f} ms (ms sorted: base "
        f"{[round(x * 1e3, 2) for x in sorted(times['base'])]}, opt "
        f"{[round(x * 1e3, 2) for x in sorted(times['opt'])]}); prefill "
        f"launches {json.dumps(r['pre'])}, step launches "
        f"{json.dumps(r['counts'])}")
    del r, cb, co
    torch.cuda.empty_cache()

    r = opt_decode_run(dev, host, "float32", z["seed"] + 1)
    cb, co = r["caches"]["base"], r["caches"]["opt"]
    tol = OPT_DECODE_F32_TOL
    layer0 = all(torch.equal(cb[k][0], co[k][0]) for k in ("k", "v"))
    cache32 = [allclose_err(co[k], cb[k], tol["cache"]) for k in ("k", "v")]
    logit32 = [allclose_err(o, b, tol["logits"]) for b, o in r["logits"]]
    if not (layer0 and max(x for _, x in cache32) <= 0.0
            and max(x for _, x in logit32) <= 0.0):
        fail(f"phase 26 f32: opt_decode off the base step: layer 0's cache "
             f"bitwise {layer0}, cache max |Δ| {[e for e, _ in cache32]} "
             f"(tol {tol['cache']}), logits max |Δ| "
             f"{max(e for e, _ in logit32):.3e} (tol {tol['logits']})")
    say(f"phase26 opt_decode f32 copy, same shapes: layer 0's cache "
        f"bitwise, cache max |Δ| {max(e for e, _ in cache32):.3e} (tol "
        f"{tol['cache']}), logits max |Δ| over {z['steps']} steps "
        f"{max(e for e, _ in logit32):.3e} (tol {tol['logits']}); step "
        f"launches {json.dumps(r['counts'])}")
    del r, cb, co
    torch.cuda.empty_cache()
    return dict(p50=p50, err=max(errs), cache_err=cache_err)


def split_blocks(blocks: dict, cfg, sp: int) -> dict:
    """The unsplit moe blocks rearranged to the split-expert layout of
    ``sp`` splits: up (L, E, D, Fe) → (L, E·sp, D, Fe/sp), its columns cut
    in ``sp`` (a copy); down a view (L, E·sp, Fe/sp, D)."""
    n, e, d, fe = (blocks["we_d"].shape[0], cfg.n_experts, cfg.d_model,
                   cfg.d_ff_expert)
    out = dict(blocks)
    out["we_i"] = blocks["we_i"].view(n, e, d, sp, fe // sp).permute(
        0, 1, 3, 2, 4).reshape(n, e * sp, d, fe // sp)
    out["we_d"] = blocks["we_d"].view(n, e * sp, fe // sp, d)
    return out


def phase_split(dev) -> dict:
    """Phase 27: the split-expert layout on grok-1-314b (published width,
    2 layers, bf16, ``"kernel"``): a (B 1, S 64) forward and a prefill
    with ``expert_split=2`` on the weights rearranged from the unsplit
    model's (:func:`split_blocks`), against ``expert_split=1`` within
    ``MOE_TOL["bfloat16"]``.  ``moe_gemm``'s launches are read over the
    phase: 2 a layer unsplit (gelu: ``we_i``, ``we_d``), 3 split (one up
    a split on the strided view, one down), every bf16 one on the tensor
    cores.  Then ``moe_gemm`` at the forward's shapes, split and
    unsplit: each held to the f32 ``torch.bmm`` of the same (bf16) views
    within ``MOE_TOL["bfloat16"]`` and timed beside the bf16
    ``torch.bmm`` over (E, C, D) and the byte bound.  Last, the routes
    held to each other: an f32 copy cut to one layer (the bf16 routes
    round apart, and a router's top-2 may then flip) on ``"kernel"``
    against ``"ref"`` (the JAX package's einsums), split and unsplit,
    the relative RMS of the logit difference within ``MOE_TOL
    ["float32"]`` and the routing the same; its ``moe_gemm`` launches
    (on the CUDA cores, the strided split views too) are counted
    apart."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import moe_gemm as MG
    from repro_torch.models.model import Model
    z = SPLIT
    cfg = dataclasses.replace(ARCHS[z["arch"]], n_layers=z["layers"],
                              dtype="bfloat16", param_dtype="bfloat16",
                              attn_impl="kernel")
    sp = z["split"]
    scfg = dataclasses.replace(cfg, expert_split=sp)
    gen = torch.Generator(device=dev).manual_seed(z["seed"])
    t0 = time.perf_counter()
    unsplit = Model(cfg, dev)
    params = unsplit.init(gen)
    e, d, fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    blocks = params["blocks"]
    sblocks = split_blocks(blocks, cfg, sp)
    sparams = dict(params, blocks=sblocks)
    split = Model(scfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = torch.randint(0, cfg.vocab, (1, z["seq"]), generator=gen,
                        device=dev)
    MG.reset_count()
    out, counts = {}, {}
    with torch.no_grad():
        for name, m, p in (("unsplit", unsplit, params),
                           ("split", split, sparams)):
            c0 = MG.launch_count
            out[name] = (m.forward(p, {"tokens": tok})[0],
                         m.prefill(p, {"tokens": tok}, z["seq"])[0])
            counts[name] = MG.launch_count - c0
    torch.cuda.synchronize()
    want = {"unsplit": 2 * 2 * z["layers"],
            "split": 2 * (sp + 1) * z["layers"]}
    if counts != want or MG.tc_launch_count != MG.launch_count:
        fail(f"phase 27: moe_gemm launches {json.dumps(counts)} "
             f"(tensor cores {MG.tc_launch_count} of {MG.launch_count}); "
             f"the path's {json.dumps(want)}")
    tol = MOE_TOL["bfloat16"]
    errs = []
    for got, ref_ in zip(out["split"], out["unsplit"]):
        g, r = got[..., :cfg.vocab].float(), ref_[..., :cfg.vocab].float()
        if not bool(((g - r).abs() <= tol + tol * r.abs()).all()):
            fail(f"phase 27: split logits off the unsplit's: max |Δ| "
                 f"{float((g - r).abs().max()):.3e} (tol {tol})")
        errs.append(float((g - r).abs().max()))
    # moe_gemm at the forward's shapes: C rows an expert
    c = int(z["seq"] * cfg.top_k / e * cfg.capacity_factor) + 1
    t = e * c
    bf = torch.bfloat16
    x = torch.randn(t, d, generator=gen, device=dev).to(bf)
    h = torch.randn(t, fe, generator=gen, device=dev).to(bf)
    off = (torch.arange(e + 1, device=dev) * c).int()
    w_up, w_dn = blocks["we_i"][0], blocks["we_d"][0]
    w_split = sblocks["we_i"][0].view(e, sp, d, fe // sp)[:, 1]
    rows, gemm_err = {}, {}
    for key, (xx, w, f_out) in (
            (f"unsplit up ({t}, {d}→{fe})", (x, w_up, fe)),
            (f"split up, one of {sp} ({t}, {d}→{fe // sp}, expert stride "
             f"{sp}·D·F)", (x, w_split, fe // sp)),
            (f"down ({t}, {fe}→{d}), split and unsplit", (h, w_dn, d))):
        want_y = torch.bmm(xx.view(e, c, -1).float(), w.float()).view(t, -1)
        err, excess = allclose_err(MG.cuda_moe_gemm(xx, w, off), want_y, tol)
        if not excess <= 0.0:
            fail(f"phase 27: moe_gemm {key} off the f32 torch.bmm of the "
                 f"same views: max |err| {err} (tol {tol})")
        gemm_err[key] = err
        del want_y
        row = {"kernel": graph_ms(lambda: MG.cuda_moe_gemm(xx, w, off),
                                  iters=10),
               "library": graph_ms(lambda: torch.bmm(
                   xx.view(e, c, -1), w), iters=10)}
        nbytes = 2 * (xx.numel() + e * w.shape[1] * f_out + t * f_out) \
            + 4 * (e + 1)
        row["bound"], row["bound_by"] = _bound(
            nbytes, 2 * t * w.shape[1] * f_out, BF16_OPS_PER_S)
        rows[key] = row
    floor = floor_ms()
    for key, row in rows.items():
        row["floor"] = floor
        say(f"phase27 moe_gemm {key} (bf16): max |err| {gemm_err[key]:.3e} "
            f"against the f32 torch.bmm of the same views (tol {tol}); "
            f"device ms per call (graph "
            f"replay) kernel {row['kernel']:.6f}, library torch.bmm "
            f"{row['library']:.6f}, floor {floor:.6f}; bound "
            f"{row['bound']:.6f} ms ({row['bound_by']})")
    say(f"phase27 expert_split {z['arch']} full width × {z['layers']} "
        f"layers bf16 'kernel' (B 1, S {z['seq']}): forward and prefill "
        f"with expert_split={sp} within tol {tol} of expert_split=1 on "
        f"the same weights (max |Δ| {errs}); moe_gemm launches "
        f"{json.dumps(counts)} == the path's, every one on the tensor "
        f"cores; weights and the split copy in {init_s:.1f} s")
    del params, sparams, blocks, sblocks, unsplit, split, x, h, out
    del w_up, w_dn, w_split
    torch.cuda.empty_cache()

    # the routes held to each other, in f32 at one layer
    c32 = dataclasses.replace(cfg, n_layers=1, dtype="float32",
                              param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(z["seed"] + 1)
    p32 = Model(c32, dev).init(gen)
    layouts = (("unsplit", c32, p32),
               ("split", dataclasses.replace(c32, expert_split=sp),
                dict(p32, blocks=split_blocks(p32["blocks"], c32, sp))))
    tc0, f32_launches, f32_rel, logits = MG.tc_launch_count, {}, {}, {}
    with torch.no_grad():
        for name, lay, p in layouts:
            c0 = MG.launch_count
            with RouteLog() as lk:
                kl = Model(lay, dev).forward(p, {"tokens": tok})[0]
            f32_launches[name] = MG.launch_count - c0
            with RouteLog() as lr:
                rl = Model(dataclasses.replace(lay, attn_impl="ref"),
                           dev).forward(p, {"tokens": tok})[0]
            kl, rl = kl[..., :cfg.vocab].float(), rl[..., :cfg.vocab].float()
            rel = float((kl - rl).square().sum().sqrt()
                        / rl.square().sum().sqrt())
            agree = routing_agreement(lk.calls, lr.calls, 1)
            if not (bool(torch.isfinite(kl).all())
                    and rel <= MOE_TOL["float32"] and agree == [1.0]):
                fail(f"phase 27: f32 {name} 'kernel' against 'ref': "
                     f"relative RMS {rel:.3e} (tol {MOE_TOL['float32']}), "
                     f"routing agreement {agree}")
            f32_rel[name], logits[name] = rel, kl
    want32 = {"unsplit": 2, "split": sp + 1}
    if f32_launches != want32 or MG.tc_launch_count != tc0:
        fail(f"phase 27: f32 moe_gemm launches {json.dumps(f32_launches)} "
             f"(tensor cores {MG.tc_launch_count - tc0}); the path's "
             f"{json.dumps(want32)} on the CUDA cores")
    split_rel = float((logits["split"] - logits["unsplit"]).abs().max())
    say(f"phase27 f32 copy, 1 layer (B 1, S {z['seq']}): 'kernel' against "
        f"'ref' relative RMS of the logit difference unsplit "
        f"{f32_rel['unsplit']:.3e}, split {f32_rel['split']:.3e} (tol "
        f"{MOE_TOL['float32']}), routing the same; kernel split against "
        f"unsplit max |Δ| {split_rel:.3e}; moe_gemm launches "
        f"{json.dumps(f32_launches)}, on the CUDA cores")
    del p32, layouts, logits, kl, rl
    torch.cuda.empty_cache()
    return dict(launches=counts["split"],
                rows=rows, err=max(errs + list(gemm_err.values())))


def phase_dots(dev, full: dict) -> dict:
    """Phase 28: phase 24 (b)'s captured training run under remat
    ``"dots"`` (selective checkpointing: ``aten.mm``/``aten.addmm``
    outputs saved; its warm step is its eager step): its losses against
    (b)'s under ``"full"`` within ``DOTS_TOL`` (bitwise expected: the
    saved products are the ones recomputed), the capture's numbers,
    replay p50, tokens/s and peak memory beside (b)'s."""
    from repro_torch.configs.registry import ARCHS
    z = TRAIN_FULL
    cfg = dataclasses.replace(ARCHS[z["arch"]], remat_policy="dots")
    got = captured_train(dev, cfg, z, "28")
    losses, p50 = got["losses"], got["p50"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, full["losses"]))
    tokens = z["batch"] * z["seq"]
    ck, cbusy, cwall = got["prof"]
    say(f"phase28 remat 'dots' {z['arch']} {cfg.n_layers} layers, B "
        f"{z['batch']} × S {z['seq']}, lr {z['lr']}, captured: losses "
        f"{losses} (max rel Δ from 'full' {rel:.3e}; bitwise "
        f"{losses == full['losses']}); {got['nodes']} graph nodes, capture "
        f"{got['capture_s']:.3f} s, instantiate {got['instantiate_s']:.3f} "
        f"s; replay p50 dots {p50 * 1e3:.1f} ms, {tokens / p50:.1f} "
        f"tokens/s, peak {got['peak']} B; profile of one more replay: {ck} "
        f"device kernels, busy {cbusy:.3f} ms of {cwall:.3f} ms wall "
        f"({cbusy / cwall:.3f}); 'full' (phase 24 b) {full['p50'] * 1e3:.1f}"
        f" ms, {tokens / full['p50']:.1f} tokens/s, peak {full['peak']} B; "
        f"wall {got['wall']:.1f} s")
    if rel > DOTS_TOL:
        fail(f"phase 28: 'dots' losses {losses} off 'full' "
             f"{full['losses']} (max rel {rel:.3e} > {DOTS_TOL})")
    return dict(p50=p50, peak=got["peak"], rel=rel)


def start_dryrun() -> list:
    """Phase 29's children: ``python -m repro_torch.launch.dryrun --arch
    granite-3-2b --mesh single`` for each of ``DRYRUN_SHAPES``, started
    together (each a fake group of 256 ranks; host work only).  Returns
    (shape, process, start time, result path) a child."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    kids = []
    for shape in DRYRUN_SHAPES:
        os.makedirs(os.path.join(out_dir, shape), exist_ok=True)
        log = open(os.path.join(out_dir, shape, "log.txt"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "granite-3-2b", "--shape", shape, "--mesh", "single", "--out",
             os.path.join(out_dir, shape)], env=env, cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT)
        log.close()
        kids.append((shape, proc, time.perf_counter(),
                     os.path.join(out_dir, shape,
                                  f"granite-3-2b__{shape}.json")))
    os.makedirs(os.path.join(out_dir, "reduced"), exist_ok=True)
    log = open(os.path.join(out_dir, "reduced", "log.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_REDUCED_CHILD,
         os.path.join(ROOT, "tests", "golden", "torch_port_dryrun.json"),
         os.path.join(out_dir, "reduced", "result.json")], env=env, cwd=ROOT,
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    kids.append(("reduced", proc, time.perf_counter(),
                 os.path.join(out_dir, "reduced", "result.json")))
    # a phase that fails before phase 29 exits: its children go with it
    atexit.register(lambda: [p.kill() for _, p, _, _ in kids
                             if p.poll() is None])
    return kids


# phase 29's reduced child: DRYRUN_REDUCED traced on a (2, 2) fake mesh
# at the golden's cut SHAPES, written as JSON (host work only)
_DRYRUN_REDUCED_CHILD = f"""
import json, sys
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun as D
golden = json.load(open(sys.argv[1]))
D.SHAPES.update({{k: tuple(v) for k, v in golden["reduced_shapes"].items()}})
mesh = D.fake_mesh(tuple(golden["reduced_mesh"]), ("data", "model"))
out = {{}}
for arch, shape in {DRYRUN_REDUCED!r}:
    cfg = D.variant_for(reduced(ARCHS[arch]), shape)
    try:
        out[arch + "|" + shape] = D.compile_combo(cfg, shape, mesh)
    except Exception as e:
        out[arch + "|" + shape] = {{"ok": False,
                                   "error": type(e).__name__ + ": " + str(e)}}
json.dump(out, open(sys.argv[2], "w"))
"""


def phase_dryrun(kids: list) -> dict:
    """Phase 29: the dry run's children (:func:`start_dryrun`) waited for
    and their JSON read back: each granite combo and its roofline must be
    ok (both pass on the host), its memory plan printed, and train_4k's
    must fit 80 GB; each reduced combo must trace, with the JAX dry run's
    argument bytes.  A child past ``DRYRUN_TIMEOUT_S`` is killed and
    fails the phase."""
    res = {}
    for shape, proc, t0, path in kids:
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            for _, p, _, _ in kids:
                p.kill()
                p.wait()
            fail(f"phase 29 {shape}: the dry run passed "
                 f"{DRYRUN_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.isfile(path):
            log = open(os.path.join(os.path.dirname(path), "log.txt")).read()
            fail(f"phase 29 {shape}: the dry run failed (exit "
                 f"{proc.returncode}): {log[-3000:]}")
        if shape == "reduced":
            res[shape] = phase_dryrun_reduced(json.load(open(path)), wall)
            continue
        r = json.load(open(path))
        one, roof = r.get("mesh_single", {}), r.get("roofline", {})
        if not one.get("ok") or "bottleneck" not in roof:
            fail(f"phase 29 {shape}: combo or roofline not ok: "
                 f"{json.dumps(one)[:1500]} {json.dumps(roof)[:1500]}")
        m = one["memory"]
        say(f"phase29 dryrun granite-3-2b × {shape} × single (16×16 fake "
            f"ranks): trace {one['trace_s']} s (child wall {wall:.1f} s, "
            f"roofline included); per device: arguments "
            f"{m['argument_bytes']} B, outputs {m['output_bytes']} B, "
            f"temps {m['temp_bytes']} B (plan: "
            f"{json.dumps(one['plan']['terms'])}), aliases "
            f"{m['alias_bytes']} B, total {m['total_bytes']} B → fits "
            f"80 GB: {m['fits_80gb']}; peak {m['peak_bytes']} B "
            f"({m['peak_note']}), FLOPs {one['flops']}, bytes accessed "
            f"{one['bytes_accessed']} ({one['bytes_accessed_note']}), "
            f"collectives {one['n_collectives']} "
            f"({one['collective_bytes']['total']} B)")
        say(f"phase29 roofline granite-3-2b × {shape}: compute "
            f"{roof['compute_s'] * 1e3:.4f} ms, memory "
            f"{roof['memory_s'] * 1e3:.4f} ms, collective "
            f"{roof['collective_s'] * 1e3:.4f} ms ({roof['collective_note']})"
            f" → {roof['bottleneck']}-bound; model/traced FLOPs "
            f"{roof['model_vs_traced_flops']}")
        if shape == "train_4k" and not m["fits_80gb"]:
            fail(f"phase 29: granite-3-2b train_4k's plan does not fit "
                 f"80 GB a device: {m['total_bytes']} B")
        res[shape] = dict(wall=wall, roofline=roof, memory=m)
    return res


def phase_dryrun_reduced(r: dict, wall: float) -> dict:
    """Phase 29's reduced combos: each traced, with the JAX dry run's
    argument bytes (the golden's), its plan printed."""
    with open(os.path.join(ROOT, "tests", "golden",
                           "torch_port_dryrun.json")) as f:
        ref = json.load(f)["reduced"]
    for arch, shape in DRYRUN_REDUCED:
        key = f"{arch}|{shape}"
        one = r.get(key, {})
        if not one.get("ok"):
            fail(f"phase 29 reduced {key}: did not trace: "
                 f"{json.dumps(one)[:1500]}")
        m, want = one["memory"], ref[key]["memory"]
        if m["argument_bytes"] != want["argument_bytes"]:
            fail(f"phase 29 reduced {key}: arguments {m['argument_bytes']} "
                 f"B, the JAX dry run's {want['argument_bytes']} B")
        say(f"phase29 reduced {key} ((2, 2) fake ranks): trace "
            f"{one['trace_s']} s; arguments {m['argument_bytes']} B (= the "
            f"JAX dry run's), outputs {m['output_bytes']} B (JAX "
            f"{want['output_bytes']}), temps {m['temp_bytes']} B (JAX "
            f"{want['temp_bytes']}), aliases {m['alias_bytes']} B (JAX "
            f"{want['alias_bytes']}), fits 80 GB: {m['fits_80gb']}")
    say(f"phase29 reduced: {len(DRYRUN_REDUCED)} combos traced (child wall "
        f"{wall:.1f} s)")
    return dict(wall=wall)


T_START = time.perf_counter()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (os.path.isdir(os.path.join(SRC, "repro_torch"))
            and all(os.path.isfile(f)
                    for f in (GOLDEN, GOLDEN_MODEL, GOLDEN_ZAMBA2,
                              GOLDEN_QWEN3MOE, GOLDEN_SWEEP, GOLDEN_WHISPER,
                              GOLDEN_TRAIN))):
        fail("run from a checkout of the repository: src/repro_torch and "
             "the golden files are missing")
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.kernels import _build, decode_attention, ref, sched_ops
    from repro_torch.kernels import flash_attention, moe_gemm, rmsnorm
    from repro_torch.kernels import ssm_scan
    from repro_torch.scenarios.runner import fleet_summary
    from repro_torch.sim import fleet as F

    golden = json.load(open(GOLDEN))
    dev = torch.device("cuda")

    def signals_of(run, device, n_edges=None, duration_ms=None):
        return golden_signals(golden, run, device, n_edges, duration_ms)

    def run_on(run, sig, device):
        return golden_run(golden, run, sig, device)

    # ---- phase 1: device and build --------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    say(f"phase1 device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi name, power limit:")
    print(smi_line, flush=True)     # as nvidia-smi gives it, on its own
    # full f32 in matrix products and convolutions: the f32 comparisons
    # below (kernels, model golden) assume it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase1 TF32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    kernel_names = [sched_ops.KERNEL, flash_attention.KERNEL,
                    decode_attention.KERNEL, rmsnorm.KERNEL, ssm_scan.KERNEL,
                    moe_gemm.KERNEL]
    t0 = time.perf_counter()
    builds = _build.build_all(kernel_names)     # one nvcc each, in parallel
    say(f"phase1 build: {time.perf_counter() - t0:.3f} s for "
        f"{len(kernel_names)} sources built at once")
    for kname in kernel_names:
        say(f"phase1 build {kname}: nvcc {builds[kname]['seconds']:.3f} s; "
            f"ptxas per instantiation: "
            f"{' | '.join(ptxas_rows(builds[kname]['ptxas']))}")

    # ---- phase 2: kernel vs plain on the card ---------------------------
    rng = np.random.default_rng(20241230)
    ranks = np.asarray([0.57, 0.43, 0.35, -0.012], np.float32)
    cases = []
    for e in (1, 28, 1024):       # steal_select: ranks + 1e12 steal-only
        s = ranks[rng.integers(0, 4, (e, 64))] + np.where(
            rng.random((e, 64)) < 0.3, 1e12, 0.0)
        cases.append((True, s, rng.random((e, 64)) < 0.5))
        sl = rng.normal(0, 400.0, (e, 32))            # export_select
        sl[rng.random((e, 32)) < 0.4] = sched_ops.POS
        cases.append((False, sl, rng.random((e, 32)) < 0.3))
    for e in (2, 28, 1024):       # peer_offload: loads, POS-filled edges
        ld = np.abs(rng.normal(500.0, 300.0, (1, e)))
        ld[rng.random((1, e)) < 0.2] = sched_ops.POS
        cases.append((False, ld, np.ones((1, e), bool)))
        cases.append((False, ld, rng.random((1, e)) < 0.5))
    for is_max in (True, False):  # all-masked rows
        cases.append((is_max, rng.normal(size=(5, 64)),
                      np.zeros((5, 64), bool)))
    for n in (1, 2, 3, 5, 31, 32, 33, 63, 64, 65, 127, 128, 200, 511, 1024,
              2047, 2048):
        for b in (1, 7, 33):
            for is_max in (True, False):
                s = rng.normal(size=(b, n))
                if (n + b) % 2:
                    s = np.round(s)                   # ties
                m = rng.random((b, n)) < rng.choice([0.05, 0.5, 1.0])
                cases.append((is_max, s, m))
    # the packed key's traps: -0.0 beside +0.0 (the first must win the
    # tie), and enabled scores equal to the fill beside masked entries
    # (a masked entry earlier in the row wins the tie)
    for n in (2, 31, 32, 33, 64, 65, 200):
        for is_max in (True, False):
            z = np.where(rng.random((7, n)) < 0.5, -0.0, 0.0)
            z[1::2, ::5] = -1.0 if is_max else 1.0
            cases.append((is_max, z, rng.random((7, n)) < 0.8))
            f = np.where(rng.random((7, n)) < 0.5,
                         sched_ops.NEG if is_max else sched_ops.POS,
                         rng.normal(size=(7, n)) - (5 if is_max else -5))
            cases.append((is_max, f, rng.random((7, n)) < 0.5))
    max_err = 0.0
    for i, (is_max, s, m) in enumerate(cases):
        st = torch.from_numpy(np.asarray(s, np.float32))
        mt = torch.from_numpy(np.asarray(m))
        want_i, want_v = ref.ref_masked_argext(st, mt, is_max=is_max)
        k0 = sched_ops.launch_counts()[1]
        got = {"key": sched_ops.masked_argext(st.to(dev), mt.to(dev),
                                              is_max=is_max),
               "previous": sched_ops.cuda_masked_argext(
                   st.to(dev), mt.to(dev), is_max=is_max,
                   _route=sched_ops.PREVIOUS)}
        torch.cuda.synchronize()
        if sched_ops.launch_counts()[1] != k0 + 1:
            fail(f"masked_argext case {i}: the launch missed the key body")
        emu = ref.ref_packed_argext(st, mt, is_max=is_max)
        if not all(torch.equal(g.cpu().view(torch.int32), e.view(torch.int32))
                   for g, e in zip(got["key"], emu)):
            fail(f"masked_argext case {i}: the key body differs from "
                 f"ref_packed_argext, the emulation of its arithmetic")
        for body, (got_i, got_v) in got.items():
            got_i, got_v = got_i.cpu(), got_v.cpu()
            if not (torch.equal(got_i, want_i)
                    and same_values(got_v, want_v)):
                fail(f"masked_argext case {i} shape {tuple(st.shape)} "
                     f"is_max={is_max}: the {body} body differs from the "
                     f"plain version")
            max_err = max(max_err, float((got_v.double()
                                          - want_v.double()).abs().max()))
    say(f"phase2 kernels: masked_argext {len(cases)} cases, each on the "
        f"key body and the previous one, equal to the plain version (index "
        f"exactly, value bit for bit, a tie of ±0.0 as numbers; "
        f"max_abs_err {max_err}); the key body bit for bit equal to "
        f"ref_packed_argext, the emulation of its arithmetic")

    # timing at the main path's hottest shape: steal_select over (28, 64)
    e, n = 28, 64
    s = torch.from_numpy((ranks[rng.integers(0, 4, (e, n))] + np.where(
        rng.random((e, n)) < 0.3, 1e12, 0.0)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.random((e, n)) < 0.5).to(dev)
    fns = {"kernel": lambda: sched_ops.cuda_masked_argext(s, m, is_max=True),
           "previous": lambda: sched_ops.cuda_masked_argext(
               s, m, is_max=True, _route=sched_ops.PREVIOUS),
           "plain": lambda: ref.ref_masked_argext(s, m, is_max=True),
           "torch.max(where)": lambda: torch.max(
               torch.where(m, s, sched_ops.NEG), dim=-1)}
    dev_ms = {k: graph_ms(f) for k, f in fns.items()}
    call_ms = {k: eager_ms(f) for k, f in fns.items()}
    dev_ms["floor"], dev_ms["load floor"] = floor_ms(), load_floor_ms()
    k_ms, prev_ms, plain_ms, compo_ms, argext_floor, _ = dev_ms.values()
    # least time for the work: each score and mask byte read once, idx and
    # value written once; a select and a compare per entry in f32
    bytes_ms = (e * n * (4 + 1) + e * (4 + 4)) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * e * n / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    # other main-path shapes: (1, 32) export, (1, 28) peer, (1024, 64)
    shape_ms = {}
    for (b, nn, mx) in ((1, 32, False), (1, 28, False), (1024, 64, True)):
        ss = torch.randn(b, nn, device=dev)
        mm = torch.rand(b, nn, device=dev) < 0.5
        shape_ms[f"{b}x{nn}"] = {body: graph_ms(
            lambda: sched_ops.cuda_masked_argext(ss, mm, is_max=mx,
                                                 _route=route))
            for body, route in (("kernel", sched_ops.KEY),
                                ("previous", sched_ops.PREVIOUS))}
    shape_ms["floor"] = floor_ms()
    att_err, att_cases = check_attention_kernels(dev)
    say(f"phase2 kernels: flash_attention {att_cases['flash_attention']} "
        f"cases, decode_attention {att_cases['decode_attention']} cases "
        f"within tolerance of the plain versions (|Δ| ≤ tol + tol·|want|, tol "
        f"f32 {ATT_TOL['float32']}, bf16 {ATT_TOL['bfloat16']}); max |err| "
        f"{json.dumps(att_err)}")
    ns_err, ns_cases = check_norm_scan_kernels(dev)
    say(f"phase2 kernels: rmsnorm {ns_cases['rmsnorm']} cases (tol f32 "
        f"{RMS_TOL['float32']}, bf16 {RMS_TOL['bfloat16']}), ssm_scan "
        f"{ns_cases['ssm_scan']} cases (tol f32 {SCAN_TOL['float32']}, bf16 "
        f"{SCAN_TOL['bfloat16']}) within tolerance of the plain versions; "
        f"max |err| {json.dumps(ns_err)}")
    moe_err, moe_cases = check_moe_gemm(dev)
    say(f"phase2 kernels: moe_gemm {moe_cases} cases within tolerance of "
        f"the plain version (tol f32 {MOE_TOL['float32']}, bf16 "
        f"{MOE_TOL['bfloat16']} against f32; split-expert strided views "
        f"among them), rows that no expert owns exactly zero; max |err| "
        f"{json.dumps(moe_err)}")
    say(f"phase2 timing (28x64), device ms per call (graph replay): "
        f"{json.dumps(dev_ms)}; issued eagerly, ms per call: "
        f"{json.dumps(call_ms)}; bound {bound_ms:.7f} ms ({bound_by}: bytes "
        f"{bytes_ms:.7f} ms, operations {ops_ms:.7f} ms); kernel and "
        f"previous body at other shapes, device ms: {json.dumps(shape_ms)}")

    # ---- phase 3: small parity, card vs host vs golden ------------------
    phase_small(golden)
    graph_report(3)

    # ---- phase 4: paper-scale fleet (the main path) ---------------------
    sched_ops.reset_count()
    paper = {}
    for run in (r for r in golden["runs"] if r["phase"] == 4):
        sig = signals_of(run, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = run_on(run, sig, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ = fleet_summary(final)
        if summ != run["summary"]:
            fail(f"{run['name']}: summary {summ} != golden "
                 f"{run['summary']}")
        ticks = int(sig.times.shape[0])
        paper[run["name"]] = dict(wall_s=wall, ticks_per_s=ticks / wall,
                                  edge_ticks_per_s=ticks * run["n_edges"]
                                  / wall)
        say(f"phase4 {run['name']}: summary == golden {json.dumps(summ)}; "
            f"{ticks} ticks × {run['n_edges']} edges in {wall:.2f} s = "
            f"{ticks / wall:.2f} ticks/s, "
            f"{ticks * run['n_edges'] / wall:.1f} edge-ticks/s")
    launches, key = sched_ops.launch_counts()
    if launches <= 0:
        fail("phase 4 ran no masked_argext launch")
    if key != launches:
        fail(f"phase 4: {key} of {launches} "
             f"masked_argext launches on the key body")
    say(f"phase4 launches: masked_argext {launches}, every one on the key "
        f"body (first windows eager, the rest replays of their graphs)")
    graph_report(4, detail=True, all_key=True)

    # ---- phase 19: registry scenarios through the port alone ----------
    # before phase 9, whose budgeted horizon absorbs its time
    scenarios = phase_scenarios(golden)
    graph_report(19)

    # ---- phase 20: the traced, batched sweep through the port alone ----
    # before phase 9 too, for the same reason
    sweep = phase_sweep(scenarios)
    graph_report(20, detail=True, all_key=True)

    # ---- phases 5-8: the serve path and its kernels ----------------------
    phase_golden(dev, GOLDEN_MODEL, 5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve_launches = phase_serve(dev)["flash_attention"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    decode_launches = phase_decode(dev)["decode_attention"]
    torch.cuda.empty_cache()
    times = phase_times(dev)
    torch.cuda.empty_cache()

    # ---- phase 9: metropolis fleet -------------------------------------
    coop = next(r for r in golden["runs"] if r["name"] == "paper-dems-coop")
    # phase 4's wall a tick (its first windows' warm-up and capture
    # included) times METRO_TICK_FACTOR bounds a replayed 1024-edge tick
    # (PERF.md §5); fit two runs, whole seconds of horizon, into what the
    # budget leaves
    tick_s = METRO_TICK_FACTOR * paper["paper-dems-coop"]["wall_s"] \
        * golden["dt"] / coop["duration_ms"]
    left = BUDGET_S - RESERVE_S - (time.perf_counter() - T_START)
    fit_ms = 1000.0 * int(left / (2.0 * tick_s) * golden["dt"] / 1000.0)
    metro_ms = min(METRO_MS, max(MIN_METRO_MS, fit_ms))
    metro = []
    for _ in range(2):
        sig = signals_of(coop, "cuda", n_edges=METRO_EDGES,
                         duration_ms=metro_ms)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final = run_on(coop, sig, "cuda")
        torch.cuda.synchronize()
        metro.append((final, time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated()))
    if not states_equal(metro[0][0], metro[1][0]):
        fail("metropolis runs are not deterministic")
    summ = fleet_summary(metro[0][0])
    if not (summ["stolen"] > 0 and summ["peer_offloaded"] > 0):
        fail(f"metropolis run did not steal and peer-offload: {summ}")
    ticks = int(metro_ms / golden["dt"])
    wall = min(w for _, w, _ in metro)
    say(f"phase9 metropolis DEMS-COOP {METRO_EDGES} edges × "
        f"{metro_ms / 1e3:.0f} s: two runs bitwise equal; "
        f"{json.dumps(summ)}; {ticks / wall:.2f} ticks/s, "
        f"{ticks * METRO_EDGES / wall:.1f} edge-ticks/s (best of 2: "
        f"{metro[0][1]:.2f} s, {metro[1][1]:.2f} s); max memory allocated "
        f"{metro[0][2]} B")

    graph_report(9, detail=True)

    # ---- phase 10: the tick never waits on the host; replay == eager ----
    phase_sync(golden)

    # ---- phase 11: profile, eager and replayed -------------------------
    phase_profile(golden, compo_ms)

    # ---- phase 21: the online control plane ----------------------------
    phase_controller(golden, scenarios)

    # ---- phases 12-14: the hybrid path and its kernels -----------------
    torch.cuda.empty_cache()
    phase_golden(dev, GOLDEN_ZAMBA2, 12)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hybrid = phase_hybrid(dev)
    torch.cuda.empty_cache()
    ktimes = kernel_times(dev)
    say(f"phases 1-14 done in {time.perf_counter() - T_START:.1f} s")

    # ---- phases 15-17: the moe path and its kernel --------------------
    torch.cuda.empty_cache()
    phase_golden(dev, GOLDEN_QWEN3MOE, 15)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moe = phase_moe(dev)
    torch.cuda.empty_cache()
    mtimes = moe_times(dev)
    say(f"phases 1-17 done in {time.perf_counter() - T_START:.1f} s")

    # ---- phase 18: hd 192 on the path (nemotron-4-340b) ----------------
    torch.cuda.empty_cache()
    phase_nemotron(dev)
    say(f"phases 1-18 done in {time.perf_counter() - T_START:.1f} s")

    # ---- phases 22-24: the encdec family and the trainer ---------------
    torch.cuda.empty_cache()
    phase_golden(dev, GOLDEN_WHISPER, 22)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whisper = phase_whisper(dev)["launches"]
    torch.cuda.empty_cache()
    full = phase_train(dev)
    torch.cuda.empty_cache()
    say(f"phases 1-24 done in {time.perf_counter() - T_START:.1f} s")

    # ---- phase 28: remat "dots" (right after 24, on an idle host) -------
    phase_dots(dev, full)
    torch.cuda.empty_cache()

    # ---- phase 29 starts: the dry run's children, host work beside ------
    # phases 25-27 (one host core of the machine's)
    dry = start_dryrun()

    # ---- phase 25: the fleet under a mesh at world size 1 --------------
    mesh = phase_mesh(golden, sweep)
    torch.cuda.empty_cache()

    # ---- phase 26: opt_decode on qwen2-72b ----------------------------
    phase_opt_decode(dev, mesh["host"])
    torch.cuda.empty_cache()

    # ---- phase 27: expert_split on grok-1-314b --------------------------
    reset_model_counts()
    split = phase_split(dev)
    torch.cuda.empty_cache()

    # ---- phase 29: the dry run's results --------------------------------
    phase_dryrun(dry)
    import torch.distributed as dist
    dist.destroy_process_group()
    say(f"phases 1-29 done in {time.perf_counter() - T_START:.1f} s")
    say(f"decode programs (replayed and eager step wall p50 in ms, same "
        f"run; {smi_line}): {json.dumps(DECODE_PROGRAMS)}")
    say(f"prefill programs (replayed and eager prefill wall p50 in ms, "
        f"same run; {smi_line}): {json.dumps(PREFILL_PROGRAMS)}")

    flash_t = times["flash serve granite"]
    decode_t = times["decode B8 W1024 L576"]
    rms_t = ktimes["rmsnorm (64, 3584)"]
    scan_t = ktimes["ssm_scan (B1, S64, H112, P64, N64)"]
    moe_t = mtimes["serve we_g (768, 2048→768)"]
    print(json.dumps({"kernels": [{
        "name": "masked_argext", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_argext.cu",
        "replaces": "src/repro/kernels/sched_ops.py:41",
        "launches": launches, "scenario_launches": scenarios["launches"],
        "sweep_launches": sweep["launches"],
        "max_abs_err": max_err, "ms": k_ms,
        "previous_ms": prev_ms, "floor_ms": argext_floor,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": serve_launches,
        "encdec_launches": whisper["flash_attention"],
        "max_abs_err": max(att_err["flash_attention"].values()),
        "ms": flash_t["kernel"], "previous_ms": flash_t["previous"],
        "floor_ms": flash_t["floor"], "plain_ms": flash_t["plain"],
        "bound_ms": flash_t["bound"], "bound_by": flash_t["bound_by"],
        "library_ms": flash_t["library"]}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:24",
        "launches": decode_launches,
        "encdec_launches": whisper["decode_attention"],
        "max_abs_err": max(att_err["decode_attention"].values()),
        "ms": decode_t["kernel"], "previous_ms": decode_t["previous"],
        "floor_ms": decode_t["floor"], "plain_ms": decode_t["plain"],
        "bound_ms": decode_t["bound"], "bound_by": decode_t["bound_by"],
        "library_ms": decode_t["library"]}, {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:22",
        "launches": hybrid["rmsnorm"],
        "encdec_launches": whisper["rmsnorm"],
        "max_abs_err": max(ns_err["rmsnorm"].values()),
        "ms": rms_t["kernel"], "previous_ms": rms_t["previous"],
        "floor_ms": rms_t["floor"], "plain_ms": rms_t["plain"],
        "bound_ms": rms_t["bound"], "bound_by": rms_t["bound_by"],
        "library_ms": rms_t["library"]}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:23",
        "launches": hybrid["ssm_scan"],
        "max_abs_err": max(ns_err["ssm_scan"][k]
                           for k in ("float32", "bfloat16")),
        "ms": scan_t["kernel"], "previous_ms": scan_t["previous"],
        "floor_ms": scan_t["floor"], "plain_ms": scan_t["plain"],
        "bound_ms": scan_t["bound"], "bound_by": scan_t["bound_by"],
        "library_ms": None}, {
        "name": "moe_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:24",
        "launches": moe["moe_gemm"], "split_launches": split["launches"],
        "max_abs_err": max(moe_err["float32"], moe_err["bfloat16"]),
        "ms": moe_t["kernel"], "previous_ms": moe_t["previous"],
        "floor_ms": moe_t["floor"], "plain_ms": moe_t["plain"],
        "bound_ms": moe_t["bound"], "bound_by": moe_t["bound_by"],
        "library_ms": moe_t["library"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
