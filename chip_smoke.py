#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-flash-bf16 LABEL
    python3 chip_smoke.py --time-kernels LABEL
    python3 chip_smoke.py --time-training LABEL
    python3 chip_smoke.py --experiment-api
    python3 chip_smoke.py --server
    python3 chip_smoke.py --bench-run
    python3 chip_smoke.py --hybrid
    python3 chip_smoke.py --moe

Phases, in order; any failure exits non-zero:

1. device   — the card's name, the device count, and ``nvidia-smi``'s name
              and power limit.  No CUDA device: fail.
2. build    — compile the CUDA kernels under ``src/repro_torch/csrc`` with
              ``nvcc`` for sm_90a (one process per source, in parallel);
              print the build time and the ``-Xptxas -v`` summary.
3. kernels  — hold every kernel against its plain PyTorch version on the
              card at the main path's shapes (integer kernels bit-exact,
              float32 attention within rtol 1e-5 / atol 1e-6, bf16
              attention within one bf16 ulp plus ``DECODE_ATOL`` (on the
              short rows of phase 16's shapes ``DECODE_ATOL_SHORT``) or
              ``FLASH_ATOL``, the SSD scan within ``SSD_TOL``, whose limits
              reject a plain version without the diagonal or without the
              state at a chunk boundary), the thrashing CE within
              ``THRASH_LOSS_TOL``/``THRASH_GRAD_TOL`` and the attention
              backward within ``ATTN_BWD_TOL`` (which reject an unmasked
              padded class, a dropped weight and a dropped causal mask),
              and time kernel, plain version and the library call
              (``scaled_dot_product_attention`` and its backward,
              ``cross_entropy`` and its backward) with CUDA events;
              ``evict_select`` also at ``n_evict`` 64, ``thrash_ce`` also as
              a training step (forward and backward through autograd)
              against ``cross_entropy``'s, with one device kernel per
              forward and per backward (read from the profiler), its
              gradient from the saved row statistics equal bit for bit to
              the recomputing backward kernel's, and bit-for-bit repeats;
              the float32 attention forward's output and the backward's
              dQ, dK and dV at the predictor's shape equal, by SHA-256
              (``FA_SHA``), to the serial kernels' they replaced, with one
              device operation per call of each; ``ssd_scan``'s blocks per
              launch of each of its three kernels (read from the profiler;
              at least 132 in the two chunk-parallel ones at the serve
              shape) and its float32 instance timed beside the bf16 one.
4. main     — the paper's online loop, ``repro_torch.uvm.runtime.run_ours``,
              on Hotspot at scale 1.0 and 150% oversubscription with the
              paper-width predictor (``CONFIG``), ``TrainConfig(2048, 0,
              256)`` and the pretrained table ``experiments/torch/
              pretrain_paper.npz``.  Every kernel's launch count is reset
              just before and read just after; ``evict_select``,
              ``freq_update`` and ``flash_attention`` must have launched.
              Stats and top-1 must equal the JAX package's frozen run
              (``experiments/torch/hotspot_paper_ref.json``).  The run
              prints host seconds per stage (observe, run_segment,
              apply_prefetch); a second run under ``torch.profiler`` prints
              the device busy share and each kernel's device time.
5. serve    — the LM serving path, ``repro_torch.serving.engine.Engine``
              (what ``python -m repro_torch.launch.serve`` drives), on
              qwen2-0.5b at full width (24 layers, 494M parameters, bf16)
              with the weights ``numpy_params(lm specs, seed 0)``, batch 2,
              a 1792-token prompt, 256 new tokens, ``pad_to=2048`` and the
              ``learned`` KV offload at ``hbm_fraction=0.5``, against the
              JAX package's run of the same (``experiments/torch/
              serve_qwen2_ref.npz``): teacher-forced logits at the
              reference's top-8 ids within ``SERVE_ATOL`` and page masses
              within ``MASS_RTOL``; the reference's page-mass stream replayed
              through the port's ``learned`` and ``lru`` managers with equal
              stats; a free run whose tokens equal the reference's up to a
              fork to another of the reference's top-8 ids whose logit there
              is within 2 * ``SERVE_ATOL`` of its top-1 and whose page
              masses before the first fork are within ``MASS_RTOL``, with
              ``flash_attention_bf16`` launched once
              per layer, ``decode_attention`` once per layer and step and
              ``freq_update`` once per step; and a profiled run of the
              prefill and the first 64 decode steps.
6. serve mamba2 — the same engine on mamba2-370m at full width (48 layers,
              420M parameters, bf16; no KV cache, so no offload manager),
              batch 2, a 2048-token prompt, 128 new tokens, against the JAX
              package's run with its SSD through the TPU kernel in
              interpret mode (``experiments/torch/serve_mamba2_ref.npz``):
              teacher-forced logits at the reference's top-8 ids within
              ``MAMBA2_ATOL`` and the prefill's final SSM state norms within
              ``STATE_NORM_RTOL``, in bf16 and in float32 (the bf16 model is
              chaotic, so its limits are loose and the float32 ones tight);
              a float32 free run by the fork rule; the bf16 free run with
              ``ssd_scan`` launched once per layer and no other kernel, its
              forks by the fork rule; and a profiled second free run.
7. train    — the training path against the JAX package's runs on a CPU:
              (a) the fine-tune group recorded in ``experiments/torch/
              train_hotspot_ref.npz`` (24 steps of ``TrainConfig()`` at
              ``CONFIG`` from its slot of the pretrained table, params and
              AdamW moments): the first
              steps' loss and gradient norm and the update within the
              ``TRAIN_*`` limits, ``thrash_ce_fwd``/``_bwd`` launched once
              per step and ``flash_attention_bwd`` once per step, block and
              layer, and a second run of the group under ``torch.profiler``;
              (b) the fine-tuned ``run_ours`` on Hotspot x1.5 from the
              pretrained table within the ``RUN_*`` limits, host seconds per
              stage, and a second run that must give identical stats and
              top-1; (c) the ``manager`` KV offload:
              the qwen2 reference's page-mass stream replayed through
              ``LearnedOffloadManager`` from the JAX package's initial slots
              (``experiments/torch/serve_manager_ref.npz``) with equal stats
              and prefetches, then a free qwen2-0.5b run with it (tokens by
              the fork rule, the training kernels launched).
8. tables   — the paper's Tables I-IV and VI through the port's runner
              (``repro_torch.bench.tables``) at the ``paper`` preset (the
              11 benchmarks at scale 1.0, 125% oversubscription), against
              the JAX package's cells and rows (``experiments/torch/
              tables_paper_ref.json``): (a) the five simulator cells of each
              benchmark and its UVMSmart run, every counter equal; (b) the
              frozen ``ours`` (``TrainConfig(2048, 0, 256)``): stats, top-1
              and prediction count equal, and every row of Tables I-IV and
              of Table VI equal; (c) the fine-tuned ``ours`` on the four
              benchmarks of ``TABLES_TUNED`` within phase 7 (b)'s limits;
              (d) each column's host seconds, compressed events and launches
              (``evict_select`` in every column; ``freq_update`` and
              ``flash_attention`` in both ``ours`` columns; the training
              kernels in the fine-tuned one), and a profiled Hotspot
              ``lru`` + ``tree`` cell.
9. concurrent — the paper's Section V-F cells (Tables VII and VIII) through
              the runner at the ``paper`` preset and x1.25 on its four pairs
              (``CONCURRENT_PAIRS``, each tenant's trace cut to 60,000
              accesses, merged by ``trace.concurrent`` in slices of 2,048),
              against the JAX package's runs (``experiments/torch/
              concurrent_paper_ref.json``), with the JAX package's initial
              weights for the slots the pretrained tables lack
              (``experiments/torch/init_paper_slots.npz``): (a) each merge's
              length and SHA-256; (b) the frozen ``run_ours`` under ``mux``
              and ``merged`` on all four pairs: stats, top-1, prediction
              count, each tenant's top-1 and stats, and Table VIII's rows
              equal; (c) the fine-tuned ``mux`` and ``merged`` runs and (d)
              Table VII's ``online_single`` and ``ours`` protocols on the
              two short pairs (``CONCURRENT_TUNED``), equal where the CPU
              rehearsal (``scripts/rehearse_concurrent_cpu.py``) gives equal
              (``CONCURRENT_EQUAL``), else within phase 7 (b)'s limits; (e)
              launches per column (``evict_select``, ``freq_update`` and
              ``flash_attention`` frozen; the attention backward and both
              ``thrash_ce`` kernels fine-tuned), each ``mux`` run's
              ``freq_update`` launches per tenant table (both tenants' in
              ``BOTH_TABLES_RUN``, the fine-tuned StreamTriad+2DCONV), each
              run's host
              seconds and compressed events, a profiled frozen ``mux`` run
              and the host syncs of another.  The long pairs' fine-tuned
              runs and the tables themselves are the runner's
              (``python -m repro_torch.bench.tables --only table7 table8``).
              The full script runs phase 9 in a process of its own
              (``--phase-9``), started with phase 8 and waited for after
              it: it needs no other phase's result.
10. figures — a subset of the paper's Figs. 3, 4, 11, 12, 13 and 14
              through the figure runner (``repro_torch.bench.figures``) at
              the ``paper`` preset against the JAX package's cells and rows
              (``experiments/torch/figures_paper_ref.json``), reading phase
              8's memoised cells: (a) Fig. 3's ``lru`` + ``tree`` at x1.0,
              x1.1 and x1.5 on ``FIG3_BENCH`` (x1.25 is phase 8's), every
              counter and every row equal; (b) UVMSmart at x1.5 on them,
              counters equal, and the IPC of every integer cell Figs. 3, 13
              and 14 read from phases 8 and 10 within ``IPC_RTOL`` of the
              JAX package's float64; (c) the fine-tuned ``ours`` at x1.5
              (Fig. 14) and without the thrashing term (Fig. 12) on
              ``FIG_TUNED``, (d) Fig. 4's ``offline`` and ``online_single``
              and the first link of Fig. 11's chain (from
              ``experiments/torch/pretrain_paper_s123.npz``) on it, each
              within phase 7 (b)'s limits (``scripts/rehearse_figures_cpu.py``
              rehearses them); (e) launches per column (``evict_select`` in
              every simulator column, the attention forward and backward and
              both ``thrash_ce`` kernels in every one that trains,
              ``freq_update`` wherever the prefetch gate opened); (f) each
              column's host seconds, compressed events and gate openings.
              The full figures are the runner's (``python -m
              repro_torch.bench.figures --scale paper``).
11. zoo and QoS — (a) ``predictor.init(s, CONFIG)`` for the slots of
              ``experiments/torch/init_paper_slots.npz`` (the JAX package's
              own initial weights): differing elements and ulp within
              ``WEIGHT_SHARE`` and ``WEIGHT_ULP`` (the CPU test's limits);
              (b) Fig. 10's four predictor kinds (``online_single`` from
              fresh weights) on ``FIG10_BENCH`` at the paper preset against
              ``figures_paper_ref.json``; (c) Table IX's first drift trace
              (x1.25, its SHA-256 equal): the frozen-pattern and 256-fault
              re-classifying managers from the quick memo of Table IX's
              recipe, and ``hpe`` + ``tree`` (counters equal), with the
              reference's asserts (at least 2 switches, fewer pages thrashed
              than ``hpe`` + ``tree``); (d) Table X's StreamTriad +
              RandomScan at x2.5: solo, shared pool and budgeted mux, the
              budgets equal and the well-behaved tenant thrashing no more
              under budgets than alone or shared, ``evict_select`` called on
              four keys; (b)-(d) equal where ``scripts/
              rehearse_zoo_qos_cpu.py`` gives equal (``ZOO_EQUAL``), else
              within phase 7 (b)'s limits, against
              ``experiments/torch/tables_quick_ref.json``; (e) the ``random``
              policy's runs on ATAX and Hotspot, counters and final state
              equal; launches per column.  The full Tables IX and X and Fig.
              10 are the runners' (``--only table9 table10 --scale quick``,
              ``--only fig10 --scale paper``).
12. fault tolerance — against ``experiments/torch/fault_tolerance_ref.json``
              (the JAX package's runs, ``export_torch_reference.py
              --fault-tolerance``): (a) the frozen Hotspot x1.5 run at
              ``CONFIG`` driven by hand, its manager's ``state()`` saved in
              a ``SnapshotStore`` after group ``FT_SNAP_AFTER``, read back
              (hash checked) and restored into a fresh ``manager_for``:
              stats, top-1, warm top-1, per-group accuracies and prediction
              count equal the JAX package's; (b) the same for the fine-tuned
              ATAX x1.5 at the paper preset, equal to the port's own
              uninterrupted run; (c) the Hotspot run without and with
              ``HealthConfig()`` and no fault (host seconds per round of
              each, and of the params check), and under the reference's
              seeded ``ChaosSchedule`` on the trainer and the frequency
              table: the injector's counts, the health counters and every
              round's ``(health, fallback)`` equal the JAX package's; (d)
              the mux on StreamTriad+2DCONV: snapshots with isolated and
              shared tables equal the JAX package's runs, and a chaos run
              on ``evaluate_many`` (every tenant demoted per failure) with
              equal counts and sequence; (e) the KV offload's checkpoint
              and resume, equal to the uninterrupted run; (f) ``lru_clone``,
              ``mru`` and ``tree_clone`` registered and run through
              ``run_batch`` on ATAX, every cell equal to the JAX package's,
              and Hotspot's fault log with the JAX package's SHA-256,
              reading back to the trace.  (b)-(e)'s runs against the JAX
              package's equal where ``scripts/rehearse_fault_tolerance_cpu.py``
              gives equal (``FT_EQUAL``), else within phase 7 (b)'s limits;
              launches and host seconds per column.
13. api     — the experiment surface (``repro_torch.uvm.cli`` in process,
              and ``run_ours_many``) on a temporary run store, against
              ``experiments/torch/cli_quick_ref.json`` and the committed
              table references: (a) ``cli sweep --scale paper`` over ATAX
              and BICG (``lru``/``hpe`` x ``demand``/``tree``, x1.25)
              prints the JAX package's lines and stores Table VI's
              counters, its spec dump has the JAX package's SHA-256, and
              the same sweep again prints ``hits=8 computed=0`` and
              launches nothing; (b) ``sweep --spec`` replays the dump with
              UVMSmart cells on ATAX and BICG added: the sim cells are
              store hits, UVMSmart equals Table VI's; (c) ``cli run
              --strategy ours --scale paper --benchmark ATAX``, fine-tuned
              from ``pretrain_paper.npz``, within phase 7 (b)'s limits of
              Table VI's fine-tuned ATAX; (d) ``run_ours_many`` frozen over
              ATAX, BICG, Pathfinder and StreamTriad+2DCONV (a ``mux``
              lane), each lane equal to its serial ``run_ours`` and to
              Table VI's frozen runs and Table VIII's frozen ``mux`` row;
              (e) ``cli export`` of a phase-drift and a churn log at the
              quick preset (the JAX package's SHA-256), ``cli serve`` over
              each with checkpoints (the JAX package's records, byte for
              byte) and a ``--resume`` from a snapshot after the log's first
              lines (the uninterrupted run's tail); (f) ``cli report``
              lists every stored run.  Host seconds and launches per piece.
14. server  — the async fault-stream server (``repro_torch.uvm.server``)
              against ``cli_quick_ref.json``'s serve streams: (a) an
              in-process ``FaultStreamServer`` in each dispatch mode
              (``serial``, ``fused``, ``vmap``) with ``run_loadgen``'s four
              clients on the drift log and four on the churn log, all
              concurrent: every client's records and summary the JAX
              package's byte for byte, ``health_faults=0 fallbacks=0``, no
              fallback record; ``fused`` and ``vmap`` gather more than one
              lane per tick in fewer ticks than ``serial``, ``vmap`` stacks a
              bucket of four or more lanes and launches ``flash_attention``
              fewer times; (b) ``Trainer(CONFIG).evaluate_many`` over
              ``STACK_BENCH``'s first groups at the paper preset from
              ``pretrain_paper.npz``'s slots: each lane's ``correct`` and
              ``pred`` its serial ``evaluate``'s, its logits by SHA-256, and
              ``flash_attention`` launched ``2 * num_layers * rows`` times
              against four times that serially; and
              ``Trainer(CONFIG, TrainConfig()).train_group_many`` over the
              same groups from the slots' params and AdamW moments, LUCIR
              and E∪T flags on, the third lane cut to ``STACK_CUT`` windows
              (18 steps against the others' 21, so it leaves the stack
              early): each lane's params, moments, ``step`` and
              ``n_updates`` its serial ``train_group``'s by SHA-256,
              ``flash_attention`` launched 8 times and its backward 4 times
              per stacked step (against the lane-steps' sum serially),
              ``thrash_ce`` once per lane-step; the seconds stacked and
              serial and ``thrash_ce``'s share of the stacked host
              seconds; (c) a malformed and a
              transport-chaos client beside two clean ones, whose streams
              stay (a)'s, in a run where the event loop's thread runs no op
              on the card and a profile finds every launch and copy on one
              thread; (d) ``cli server --device cuda`` with checkpoints
              and an AOT cache holding a copy of phase 2's build, killed with
              SIGKILL after a named client's sixth action and restarted with
              ``--resume``: the tail is the uninterrupted ``cli serve`` run's,
              and the restarted process reports one AOT hit, no miss and no
              fallback; (e) (a)'s eight clients per mode, at ``--rate 0``:
              faults/s, p50 and p99 action latency (recorded, not gated).
              The full script runs phase 14 in a second process of its own
              (``--phase-14``), started with phase 10 and waited for after
              phase 13, so its host numbers are taken beside phases 10-13.
              ``--server`` runs it alone, with a fresh ``cli server`` that
              builds into an empty AOT cache (one miss).
15. bench run — the benchmark driver (``python -m repro_torch.bench.run
              --scale quick --only table1 table7``) in process, against
              ``experiments/torch/tables_quick_ref.json``: (a) Table I's
              rows equal; (b) Table VII's ``online_single`` and ``ours``
              (from ``pretrain_quick_s321.npz``) protocol runs equal where
              ``BENCH_RUN_EQUAL`` says, else within phase 7 (b)'s limits;
              (c) ``experiments/bench_torch/*.csv`` the printed rows; (d)
              ``evict_select`` launched in Table I, the float32 attention,
              its backward and both ``thrash_ce`` kernels in Table VII,
              ``freq_update`` in neither; (e) seconds per suite.  The full
              script runs it in a third process (``--phase-15``), started
              with phase 10 and waited for after phase 14.
              ``--bench-run`` runs ``repro_torch.bench.run``'s whole quick
              order but ``fig11`` alone after the build, the integer rows
              and cells held equal and the fine-tuned runs' distances
              printed, then pretrains Fig. 11's quick table on the card and
              runs ``fig11`` from it (recorded, not gated).
16. hybrid  — the serving engine on the hybrid family and the two dense
              configs: (a) zamba2-7b at full width and 15 layers (two
              groups of six Mamba-2 layers, each followed by the shared
              attention block, and three tail layers; 1,604,578,608
              parameters) with the weights ``numpy_params(lm specs, seed
              0)``, batch 2, a 512-token prompt (two SSD chunks), against
              the JAX package's run with its SSD through the TPU kernel in
              interpret mode (``experiments/torch/serve_zamba2_ref.npz``):
              teacher-forced logits at the reference's top-8 ids within
              ``ZAMBA2_ATOL`` and the prefill's final SSM state norms per
              (layer, row) within ``ZAMBA2_NORM_RTOL``, in bf16 (32 new
              tokens) and in float32 (16), whose limits are loose in bf16
              (the random-weight model is chaotic) and tight in float32;
              both free runs by the fork rule, each launching its attention
              kernel (``flash_attention_bf16`` or the float32
              ``flash_attention``) once per application of the shared
              block, ``ssd_scan`` once per layer and ``decode_attention``
              once per application and step, nothing else; a profiled run;
              (b) zamba2-7b at full depth (81 layers, 6,751,130,832
              parameters, bf16 weights drawn on the card), a (2, 512)
              prompt and 16 new tokens: finite logits, launches (13
              flash and 81 ``ssd_scan`` in the prefill, 13 decodes a
              step), prefill seconds, decode ms per step and peak memory
              (recorded, not gated); (c) qwen1.5-4b and granite-3-8b
              at full width and 2 layers (weights drawn on the card), batch
              2, a 256-token prompt, 16 new tokens: finite logits, the
              launches per layer and step, and the bf16 flash and decode
              kernels at each model's attention shapes against their plain
              versions within phase 3's limits, whose decode limit rejects
              a dropped key there.  Phase 3 also holds the kernels'
              instances at zamba2's shapes (bf16 and float32 flash at head
              width 112 at its prefill, decode in both dtypes at T 544, the
              SSD scan at H 112, P 64, N 64 in both dtypes, each with its
              defect controls) against their plain versions, timed beside
              SDPA where there is one (``zamba2_kernel_rows``; one
              ``<kernel>@<instance>`` entry each in the kernels line).  The
              full script runs phase 16 in a fourth process
              (``--phase-16``), started with phase 8 and waited for after
              phase 15.  ``--hybrid`` runs those phase 3 rows and phase 16
              alone after the build.
17. moe     — the serving engine on the mixture-of-experts family
              (expert products as batched matrix products, as in the
              reference; routing recorded by wrapping
              ``repro_torch.models.moe.route``) and on qwen3-0.6b (dense,
              ``qk_norm``): (a) olmoe-1b-7b at full width and 2 layers
              (1,045,703,168 parameters) with the weights ``numpy_params(lm
              specs, seed 0)``, batch 2, a 512-token prompt, ``pad_to``
              1024 and the ``learned`` offload, against the JAX package's
              run (``experiments/torch/serve_olmoe_ref.npz``): teacher-forced
              logits at the reference's top-8 ids within ``MOE_ATOL`` in
              bf16 (32 new tokens, page masses within ``MOE_MASS_RTOL``)
              and float32 (16); the prefill's routes per layer (SHA-256 of
              the expert ids and kept choices, load differences, drops),
              equal in float32 at the layers of ``MOE_ROUTES_EQUAL_F32``,
              recorded in bf16; the reference's page masses replayed
              through the ``learned`` and ``lru`` managers with equal stats;
              both free runs by the fork rule, each launching its attention
              kernel once per layer, ``decode_attention`` once per layer and
              step and ``freq_update`` once per step, nothing else; a
              profiled run; (b) olmoe-1b-7b at full depth (16 layers,
              6,919,624,704 parameters, bf16 weights drawn on the card), a
              (2, 512) prompt, 16 new tokens and the ``learned`` offload:
              finite logits, exact launches, prefill seconds, decode ms per
              step and peak memory (recorded, not gated); (c)
              qwen2-moe-a2.7b and qwen3-0.6b at full width and 2 layers as
              phase 16 (c).  Phase 3 also holds the attention kernels at
              head width 128 at olmoe's shapes (K 16, G 1; bf16 and float32
              flash, decode in both dtypes at T 544) and qwen3's (K 8, G 2;
              bf16) (``moe_kernel_rows``).  The full script runs phase 17
              in a fifth process (``--phase-17``), started with phase 10
              and waited for after phase 16.  ``--moe`` runs those phase 3
              rows and phase 17 alone after the build.

The last lines are the card's ``nvidia-smi`` line, a ``{"kernels": [...]}``
JSON line, and ``{"ok": true, "device": {...}}``.

With ``--time-flash-bf16 LABEL`` the script runs phases 1 and 2, then only
times the bf16 ``flash_attention`` kernel at the serve prefill's shape (the
atol it needs at rtol 2^-7, three CUDA-event timings of 100 calls, the
device time per call) and prints one line headed LABEL.  To compare two
versions of the kernel, unpack the other checkout into a directory that
``.gitignore`` lists and run both from one command, in turns (A, B, B, A).

With ``--time-kernels LABEL`` the script runs phases 1 and 2, then phase
3's rows of ``evict_select``, ``freq_update``/``freq_lookup``, the float32
``flash_attention`` forward and backward, ``ssd_scan`` and ``thrash_ce``
(each time the median of five), the wrappers' host microseconds per step,
and the SHA-256 of ``thrash_ce``'s loss and gradient and of the float32
attention's output and gradients on phase 3's inputs, and prints them as
one JSON line headed LABEL.  Copy this script into the other checkout so
that both versions are timed by the same code, and run them in turns.
``--time-training LABEL`` does the same for the training path: phase 7
(a)'s fine-tune group five times and the fine-tuned ``run_ours`` once, host
seconds per stage.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REF = ROOT / "experiments" / "torch" / "hotspot_paper_ref.json"
WEIGHTS = ROOT / "experiments" / "torch" / "pretrain_paper.npz"
SERVE_REF = ROOT / "experiments" / "torch" / "serve_qwen2_ref.npz"
MAMBA2_REF = ROOT / "experiments" / "torch" / "serve_mamba2_ref.npz"
TRAIN_REF = ROOT / "experiments" / "torch" / "train_hotspot_ref.npz"
SERVE_MANAGER_REF = ROOT / "experiments" / "torch" / "serve_manager_ref.npz"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, bf16 dense tensor cores
FA_RTOL, FA_ATOL = 1e-5, 1e-6
# bf16 decode against its plain version: the same rounding points, float32
# sums in another order, which can flip the bf16 output by one ulp (at most
# 2^-7 of it).  The serve shape's outputs are about 0.03 (N(0,1) inputs,
# std sqrt(e / kv_len)); one dropped key at kv_len 513 moves them by ~2e-3.
DECODE_RTOL, DECODE_ATOL = 2.0 ** -7, 1e-5
# bf16 decode on short rows (phase 16's caches: zamba2-7b's 544 keys at K 32,
# D 112; the dense configs' 272 at K 20 and K 8): the kernel's scores (one
# fmaf chain over d) and the plain version's (einsum) differ in float32
# order, and a score that lands on the other side of a bf16 rounding of p
# moves an output by that ulp of p over l, which is several ulps of the
# output when a row holds a few hundred keys (the serve shape's hold 2,048).
# On an H100 the atol needed at rtol 2^-7 is 2.9e-5 at D 112 (K 32, T 544),
# 6.1e-6 at qwen1.5-4b's shape and 2.2e-5 at granite-3-8b's; the CPU
# emulation of the kernel's order (tests/test_torch_decode_attention.py)
# needs up to 5.7e-5 at D 112.  One dropped key needs 0.026, 0.10 and 0.12
# there.  So 1.5e-4: five times the card's worst, 170 times below a drop
DECODE_ATOL_SHORT = 1.5e-4
# the same at olmoe-1b-7b's decode shape (K 16, G 1, D 128, 513-544 keys):
# phase 3's inputs there need 1.79e-4 on an H100, which the CPU emulation of
# the kernel's order reproduces to the bit (tests/test_torch_decode_
# attention.py; up to 1.26e-4 over 12 other seeds); one dropped key needs
# 0.018 or more.  So 5e-4: 2.8 times the worst need, 36 times below a drop
DECODE_ATOL_D128 = 5e-4
# bf16 flash against its plain version: a one-ulp flip of the output, and
# p rounded against other running maxima (per 64-key tile in the kernel, per
# chunk in the plain version), each p off by up to 2^-9 of itself on either
# side; that moves the short causal rows (few keys, outputs of about +-3)
# most.  On an H100 the tile kernel needs atol 0.0009-0.0011 at rtol 2^-7
# (its CPU emulation 0.0010; a first kernel with a per-key max needed
# 0.0027, when the limit was 4e-3).  A wrong causal offset is off by about
# 3.7, one key dropped from rows of 1700 keys (outputs of a few hundredths)
# by about 0.04
FLASH_RTOL, FLASH_ATOL = 2.0 ** -7, 2e-3
# serve path against the JAX package on a CPU: logits of about +-3 after 24
# bf16 layers whose elementwise chains round at other places in XLA (float32
# intermediates, its own sigmoid) than in PyTorch; 8 bf16 ulps at 2-4
SERVE_ATOL = 0.125
# page mass is a mean of |K| over 24 layers x 2 rows x 2 heads x 64 dims x
# 64 tokens; single-ulp differences in bf16 keys move it by well under 1%
MASS_RTOL = 1e-2
# mamba2 serve path against the JAX package on a CPU (its SSD through the TPU
# kernel in interpret mode), limits set from a rehearsal of this phase on a
# CPU with the plain versions (scripts/rehearse_mamba2_cpu.py).  In bf16 the
# random-weight model is chaotic: swapping F.silu for the port's silu (an
# ulp here and there) moves its prefill logits at the top-8 ids by 0.47 and
# the state norms by 42%; the rehearsal was 0.95 and 0.47 from the
# reference, the reference's own two SSD routes 0.31 and 0.32 apart.  So
# bf16 is held only within 1.5 (logits of 3.7-5.6) and rtol 0.75 (norms),
# and the same run in float32, where the rehearsal was 3.7e-4 and 1.8e-4
# from the reference, within 2e-3 and rtol 1e-3: the card sums in other
# orders than either CPU
MAMBA2_ATOL = {"bfloat16": 1.5, "float32": 2e-3}
STATE_NORM_RTOL = {"bfloat16": 0.75, "float32": 1e-3}
# ssd_scan against its plain version: the same float32 function with sums in
# other orders (at the serve widths outputs reach about +-400 and the plain
# version is off a float64 evaluation by up to 2e-3, the state, of up to
# about 18, by 1.4e-4, and an H100's kernel was 3.1e-4 from the plain
# state), plus in bf16 one ulp of y.  A dropped diagonal or an unread state
# moves y by about 1 or more
SSD_TOL = {"float32": {"y": (1e-5, 4e-3), "state": (1e-5, 1e-3)},
           "bfloat16": {"y": (2.0 ** -7, 4e-3), "state": (1e-5, 1e-3)}}
# thrash_ce against its plain version: the same float32 function, expf
# against torch's exp and sums in other orders; the gradient's elements are
# at most 1/B.  A padded class left unmasked or the weight dropped moves the
# loss or the gradient far past these (tests/test_torch_thrash_ce.py)
THRASH_LOSS_TOL, THRASH_GRAD_TOL = (1e-5, 1e-6), (1e-5, 1e-9)
# SHA-256 (first 16 hex digits, ``tensor_sha``) of the float32 attention
# forward's output and of dQ, dK and dV on phase 3's first inputs at the
# predictor's shape (B 256, S = T = 10, K 2, G 1, D 32), as the first kernels
# (one thread per query row, keys in series) gave them on an H100.  The
# kernels since keep that arithmetic, expression for expression, and change
# only its parallelism, so these bits hold phase 4's exact agreement with JAX
# and phase 7's digits
FA_SHA = {"out": "1e2e8f2a07c933be", "dq": "0ef03c181e0be9bd", "dk": "26c1fb23a5a6156a", "dv": "cfeaaf1833b2959a"}
# the attention backward against autograd through the plain version: float32
# sums in other orders through the softmax's backward (dS = P * (dP - D));
# a causal mask dropped in the backward is off by about 1
ATTN_BWD_TOL = (1e-4, 1e-5)
# phase 7 against the JAX package on a CPU, limits set from a rehearsal on a
# CPU with the plain versions (scripts/rehearse_training_cpu.py; numbers in
# PERF.md section 2).  AdamW steps on gradient elements near the float32
# rounding of a very confident model (nll about 1e-5 at logits of 16), so two
# summation orders drift apart within a group and the online loop amplifies
# it.  (a) one fine-tune group from its slot's params and AdamW moments: the
# first steps' loss and gradient norm (CPU 5.6e-4, 1.2e-3; mu unscaled 0.15;
# LUCIR dropped 0.95) and the update's distance from the reference's over
# the update's own norm (CPU 5.8e-4; the defects 0.18 and 0.99)
TRAIN_STEPS_HELD, TRAIN_STEP_RTOL, TRAIN_UPDATE_RTOL = 4, 1e-2, 0.08
# (b) the fine-tuned run: top-1 and the counters (correct CPU runs that
# differ only in thread count or one ulp of the weights: up to 0.012 and
# 0.42; mu unscaled 0.028 and 0.35; from the moments, CPU 0.011 and 0.18),
# the first groups' accuracies (CPU exact).  Only top-1 separates a defect here; the bias-correction and
# LUCIR defects move (b) no more than summation order does, (a) rejects the
# LUCIR one and (c), whose slots start at step 0, all three
RUN_TOP1_ATOL, RUN_STATS_RTOL, RUN_GROUPS_HELD, RUN_GROUP_ACC_ATOL = 0.02, 0.4, 4, 2.5e-3


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# timings per ``time_cuda`` call, of which it returns the median
# (``--time-kernels`` takes 5: host-bound calls vary from one timing to the next)
TIMING_REPEATS = 1


def time_cuda(fn, iters: int, warmup: int = 10) -> float:
    """Milliseconds per call of ``fn`` on the current stream (CUDA events
    around ``iters`` back-to-back calls, after a warm-up; the median of
    ``TIMING_REPEATS`` such timings)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(TIMING_REPEATS):
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return sorted(times)[len(times) // 2]


def device_times(prof) -> dict:
    """Seconds and count of each operation a ``torch.profiler`` run recorded
    on the device (kernels, copies, fills), by name.  Read from the raw
    Kineto events: ``key_averages()`` builds a Python object per event,
    about 0.1 ms each, minutes for a run of a million launches."""
    import torch

    out: dict = {}
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:  # a PyTorch without the raw events: the averages, slowly
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            t = getattr(ev, "cuda_time_total", 0.0) if t is None else t
            if t and ev.count:
                out[ev.key] = (t / 1e6, ev.count)
        return out
    for ev in results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            t, c = out.get(ev.name(), (0.0, 0))
            out[ev.name()] = (t + ev.duration_ns() / 1e9, c + 1)
    return out


_GRID = re.compile(r'"grid"\s*:\s*\[\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\]')


def launch_grids(prof, kernel: str) -> dict:
    """Blocks per launch of each device symbol of port kernel ``kernel`` in
    a ``torch.profiler`` run, as the profiler recorded each launch's grid:
    ``{symbol: sorted distinct block counts}``.  Read from the raw Kineto
    events' metadata, else from the exported trace; empty if neither
    carries a grid."""
    import torch

    seen: dict = {}

    def add(name: str, meta: str) -> None:
        m = _GRID.search(meta or "")
        if m and is_kernel(kernel, name):
            sym = next(k for k in KERNEL_SYMBOLS[kernel] if k in name)
            seen.setdefault(sym, set()).add(int(m[1]) * int(m[2]) * int(m[3]))

    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is not None:
        for ev in results.events():
            if ev.device_type() == torch.autograd.DeviceType.CUDA and hasattr(ev, "metadata_json"):
                add(ev.name(), ev.metadata_json())
    if not seen:
        path = ROOT / "build" / "launch_grids_trace.json"
        path.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(path))
        for ev in json.loads(path.read_text()).get("traceEvents", []):
            if ev.get("cat") == "kernel":
                add(ev.get("name", ""), json.dumps(ev.get("args", {})))
        path.unlink()
    return {sym: sorted(blocks) for sym, blocks in seen.items()}


PROFILE_PAD_S = 0.02  # idle host seconds at each end of a profiled window of calls


def profiled(fn, iters: int):
    """A ``torch.profiler`` run (CUDA activity) of ``iters`` calls of ``fn``,
    its window padded with ``PROFILE_PAD_S`` of idle host time at each end.
    The profiler keeps only the device events whose time, converted to the
    host's clock, falls inside its window; a window of a few short launches
    (20 calls of 14 us) can lose every one of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return prof


def device_ms(fn, kernel: str, iters: int = 50, grids: dict | None = None) -> float | None:
    """Device time (ms) per call of ``fn`` spent in the port kernel
    ``kernel`` (every device symbol of it, matched by ``is_kernel``: a
    wrapper may launch several kernels per call), from ``torch.profiler``
    over ``iters`` calls; None if the profiler shows no device time for it.
    ``grids``, if given, receives ``launch_grids`` of the same run."""
    try:
        prof = profiled(fn, iters)
    except Exception as exc:  # the profiler is a diagnostic here; the events time stands
        print(f"  (torch.profiler gave no device times: {exc!r})")
        return None
    total = sum(t for name, (t, _) in device_times(prof).items() if is_kernel(kernel, name))
    if grids is not None:
        grids.update(launch_grids(prof, kernel))
    return total / iters * 1e3 if total > 0 else None


# --- phase 3: each kernel against its plain version --------------------------


def bf16_err(got, want, rtol: float) -> tuple[float, float]:
    """The largest |got - want| and the smallest atol that would pass at
    ``rtol`` (the largest |got - want| - rtol * |want|)."""
    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err - rtol * want.float().abs()).max())


def kernel_evict_select(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import evict_select as K

    rng = np.random.default_rng(0)
    worst = 0
    n_cases = 0
    for nb in (1, 33, 256, 300, 512, 600):
        for n_keys in (1, 2, 3, 4):
            for trial in range(6):
                cand = torch.tensor(rng.random(nb) < 0.6, device=dev)
                keys = tuple(torch.tensor(rng.integers(-3, 3, nb, dtype=np.int32), device=dev)
                             for _ in range(n_keys))
                n_cand = int(cand.sum())
                for n in (0, 1, 2, 5, 64, n_cand // 2, n_cand, n_cand + 7):
                    ne = torch.tensor(n, dtype=torch.int32, device=dev)
                    got = K.evict_select(cand, keys, ne)
                    want = K.evict_select_plain(cand, keys, ne)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"evict_select differs from plain at NB={nb}, keys={n_keys}, n={n}")
                    worst = max(worst, int((got.int() - want.int()).abs().max()))
                    n_cases += 1
    print(f"  evict_select: {n_cases} cases at NB 1/33/256/300/512/600, 1-4 tied keys, n_evict 0..candidates+7: "
          f"bit-exact")
    # timing at the main path's shape: NB 256, the learned policy's 3 keys, one victim
    nb = 256
    cand = torch.tensor(rng.random(nb) < 0.6, device=dev)
    keys = (torch.tensor(-rng.integers(0, 3, nb, dtype=np.int32), device=dev),
            torch.tensor(rng.integers(-1, 64, nb, dtype=np.int32), device=dev),
            torch.tensor(rng.integers(0, 50000, nb, dtype=np.int32), device=dev))
    ne = torch.tensor(1, dtype=torch.int32, device=dev)
    ne64 = torch.tensor(64, dtype=torch.int32, device=dev)  # a prefetch-heavy step's evictions
    ne0 = torch.tensor(0, dtype=torch.int32, device=dev)  # most scan steps: nothing to evict
    ms = time_cuda(lambda: K.evict_select(cand, keys, ne), 500)
    plain_ms = time_cuda(lambda: K.evict_select_plain(cand, keys, ne), 200)
    nbytes = nb + 3 * 4 * nb + 4 + nb  # cand, keys, n_evict in; mask out
    return {"name": "evict_select", "route": "cuda", "source": "src/repro_torch/csrc/evict_select.cu",
            "replaces": "src/repro/kernels/evict_select/kernel.py:56", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "device_ms": device_ms(lambda: K.evict_select(cand, keys, ne), "evict_select"),
            "ms_n64": time_cuda(lambda: K.evict_select(cand, keys, ne64), 500),
            "device_ms_n64": device_ms(lambda: K.evict_select(cand, keys, ne64), "evict_select"),
            "device_ms_n0": device_ms(lambda: K.evict_select(cand, keys, ne0), "evict_select"),
            "shape": f"NB {nb}, 3 keys, n_evict 1 (and 64: ms_n64, device_ms_n64; 0: device_ms_n0)"}


def _freq_stream(rng, n: int, n_sets: int):
    """A conflict-heavy block stream: a few hot sets receive many distinct
    blocks (way evictions), long same-block runs saturate counters, -1 pads."""
    import numpy as np

    hot_sets = rng.integers(0, n_sets, 8)
    b = np.where(rng.random(n) < 0.5,
                 hot_sets[rng.integers(0, 8, n)] + n_sets * rng.integers(0, 40, n),
                 rng.integers(0, 160, n))
    b[rng.integers(0, 2, n) == 0] = 7  # a saturating block
    b[rng.integers(0, n, 16)] = -1
    b[-n // 8:] = -1  # padding
    return b.astype(np.int32)


def kernel_freq_table(dev) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.kernels import freq_table as K

    rng = np.random.default_rng(1)
    n_sets, ways, n = 1024, 16, 2048
    tags = torch.full((n_sets, ways), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((n_sets, ways), dtype=torch.int32, device=dev)
    worst_u = worst_l = 0
    for rnd in range(6):  # successive streams through one table: hits, conflicts, saturation
        blocks = torch.tensor(_freq_stream(rng, n, n_sets), device=dev)
        want_t, want_c = K.freq_update_plain(tags, cnt, blocks)
        K.freq_update(tags, cnt, blocks)
        torch.cuda.synchronize()
        check(torch.equal(tags, want_t) and torch.equal(cnt, want_c), f"freq_update differs from plain (round {rnd})")
        worst_u = max(worst_u, int((tags - want_t).abs().max()), int((cnt - want_c).abs().max()))
        q = torch.tensor(np.concatenate([_freq_stream(rng, n, n_sets), [-1, 7, 0]]).astype(np.int32), device=dev)
        got, want = K.freq_lookup(tags, cnt, q), K.freq_lookup_plain(tags, cnt, q)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"freq_lookup differs from plain (round {rnd})")
        worst_l = max(worst_l, int((got - want).abs().max()))
    check(int(cnt.max()) == K.COUNTER_MAX, "the freq_table check never saturated a counter")
    print(f"  freq_update / freq_lookup: 6 rounds of a {n}-block conflict-heavy stream with -1 padding "
          f"through a {n_sets}x{ways} table (counters saturated): bit-exact")
    # timing on the main path's data: one Hotspot group's block stream (the
    # predicted blocks a warm group streams match it at top-1 ~0.99), and on
    # the skewed stream above, where half the blocks fall into one set
    from repro_torch.uvm import trace as T

    hot = torch.tensor((T.get_trace("Hotspot", 1.0).page[4 * n:5 * n] // 16).astype(np.int32), device=dev)
    skewed = torch.tensor(_freq_stream(rng, n, n_sets), device=dev)
    t0, c0 = tags.clone(), cnt.clone()

    def update_from_start(blocks):
        # every timed update starts from the same table: two copies, then the kernel
        tags.copy_(t0)
        cnt.copy_(c0)
        K.freq_update(tags, cnt, blocks)

    # the copies stay in the timed call ("ms" and "device_ms" time one
    # workload, so "ms" cannot fall below "device_ms"); their own time is
    # printed beside it, never subtracted
    copy_ms = time_cuda(lambda: (tags.copy_(t0), cnt.copy_(c0)), 200)
    # bytes the function must move on this stream: every way (int32 tag +
    # int32 counter) of each set the stream touches, read once (and written
    # once by the update), plus the stream in (and the counters out of the
    # lookup).  The set index is a floor modulo, as numpy's %; -1 is a no-op
    # for the update and reads set n_sets-1 in the lookup.
    hb = hot.cpu().numpy()
    set_bytes = ways * 2 * 4
    update_bytes = 2 * np.unique(hb[hb >= 0] % n_sets).size * set_bytes + 4 * n
    lookup_bytes = np.unique(hb % n_sets).size * set_bytes + 4 * n + 4 * n
    ms = time_cuda(lambda: update_from_start(hot), 200)
    upd = {"name": "freq_update", "route": "cuda", "source": "src/repro_torch/csrc/freq_table.cu",
           "replaces": "src/repro/kernels/freq_table/kernel.py:77", "max_abs_err": worst_u,
           "ms": ms, "copy_ms": copy_ms, "copy_share": copy_ms / ms,
           "plain_ms": time_cuda(lambda: K.freq_update_plain(t0, c0, hot), 20, warmup=3),
           "bound_ms": update_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": None,
           "device_ms": device_ms(lambda: update_from_start(hot), "freq_update"),
           "skewed_ms": time_cuda(lambda: update_from_start(skewed), 200),
           "skewed_device_ms": device_ms(lambda: update_from_start(skewed), "freq_update"),
           "shape": f"{n_sets}x{ways} table, {n} blocks of one Hotspot group, each update from the same table "
                    f"(two table copies in every timed call)"}
    q = hot
    lk = {"name": "freq_lookup", "route": "cuda", "source": "src/repro_torch/csrc/freq_table.cu",
          "replaces": "src/repro/kernels/freq_table/kernel.py:125", "max_abs_err": worst_l,
          "ms": time_cuda(lambda: K.freq_lookup(tags, cnt, q), 500),
          "plain_ms": time_cuda(lambda: K.freq_lookup_plain(tags, cnt, q), 200),
          "bound_ms": lookup_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
          "device_ms": device_ms(lambda: K.freq_lookup(tags, cnt, q), "freq_lookup"),
          "shape": f"{n_sets}x{ways} table, {n} blocks of one Hotspot group"}
    return [upd, lk]


def instance_row(base: str, instance, row: dict) -> dict:
    """``row`` named ``base``, or for an instance of that kernel at another
    shape (``instance`` = (suffix, the paths that launch that shape)) named
    ``base + suffix`` and tagged with both, so that its launches are counted
    on those paths only."""
    if instance is None:
        return {"name": base, **row}
    suffix, paths = instance
    return {"name": base + suffix, "instance_of": base, "paths": list(paths), **row}


def bound_of(nbytes: int, flops: int, peak: float) -> dict:
    b, o = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(b, o) * 1e3, "bound_by": "bytes" if b >= o else "operations"}


# (B, S, T, K, G, D) and keywords of the flash forward's cases; the first is
# timed.  The predictor's shapes (float32), the serve prefill's (bf16), and
# zamba2-7b's prefill at head width 112 with a causal offset, a kv_len and a
# fully masked row (both dtypes)
FA_CASES = [((256, 10, 10, 2, 1, 32), {}), ((3, 37, 37, 2, 3, 64), {}), ((2, 5, 70, 1, 2, 16), {"q_offset": 65}),
            ((2, 10, 10, 2, 1, 32), {"causal": False, "kv_len": 7}), ((1, 1, 40, 2, 4, 128), {"q_offset": 39})]
FLASH_BF16_CASES = [((2, 1792, 1792, 2, 7, 64), {}), ((2, 100, 130, 2, 7, 64), {"q_offset": 30}),
                    ((1, 33, 33, 1, 4, 32), {"kv_len": 20, "causal": False})]
ZAMBA2_FLASH_CASES = [((2, 512, 512, 32, 1, 112), {}), ((1, 100, 130, 4, 3, 112), {"q_offset": 30}),
                      ((1, 65, 63, 2, 1, 112), {"kv_len": 40, "causal": False}),
                      ((1, 20, 20, 2, 1, 112), {"kv_len": 0})]


def kernel_flash_attention(dev, cases=FA_CASES, instance=None) -> dict:
    """The float32 flash forward against its plain version at ``cases``
    (phase 3's own: the first output equal by SHA-256 to the serial
    kernel's), a causal mask one key off rejected, one device operation
    per call, timed at the first case beside SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as K

    rng = np.random.default_rng(2)

    def inputs(B, S, T, Kh, G, D):
        mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev)
        return mk(B, S, Kh, G, D), mk(B, T, Kh, D), mk(B, T, Kh, D)

    worst = 0.0
    for shape, kw in cases:
        q, k, v = inputs(*shape)
        got = K.flash_attention(q, k, v, **kw)
        want = K.attend_chunked(q, k, v, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"flash_attention gave non-finite values at {shape} {kw}")
        check(torch.allclose(got, want, rtol=FA_RTOL, atol=FA_ATOL),
              f"flash_attention differs from plain at {shape} {kw}: max |err| {float((got - want).abs().max())}")
        worst = max(worst, float((got - want).abs().max()))
        if shape == cases[0][0]:
            sha = tensor_sha(got)
    if instance is None:
        check(sha == FA_SHA["out"],
              f"flash_attention's output SHA-256 {sha} is not the serial kernel's {FA_SHA['out']}")
    B, S, T, Kh, G, D = cases[0][0]
    q, k, v = inputs(B, S, T, Kh, G, D)
    off = K.flash_attention(q, k, v, q_offset=1)  # each row one key more than the plain version's
    check(not torch.allclose(off, K.attend_chunked(q, k, v), rtol=FA_RTOL, atol=FA_ATOL),
          "the float32 limits pass a causal mask one key off")
    name = "flash_attention" + (instance[0] if instance else "")
    print(f"  {name}: {len(cases)} shapes (B {B} S=T {S} K {Kh} G {G} D {D} first), rtol {FA_RTOL} atol {FA_ATOL}: "
          f"max |err| {worst:.3g}, a causal mask one key off rejected; output SHA-256 {sha}"
          + (", the serial kernel's" if instance is None else ""))
    ops, all_ms = device_ops(lambda: K.flash_attention(q, k, v))
    check(ops == 1.0, f"flash_attention ran {ops} device operations per call, not 1")
    qh, kh, vh = _sdpa_layout(q, k, v)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
    sd = sdpa().transpose(1, 2).reshape(B, S, Kh, G, D)
    check(torch.allclose(sd, K.attend_chunked(q, k, v), rtol=1e-4, atol=1e-5),
          "the SDPA yardstick computes another function")
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 2 * 2 * B * Kh * G * (S * (S + 1) // 2) * D  # causal, S == T: query i sees keys 0..i
    return instance_row("flash_attention", instance, {
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:71", "max_abs_err": worst,
        "ms": time_cuda(lambda: K.flash_attention(q, k, v), 500),
        "plain_ms": time_cuda(lambda: K.attend_chunked(q, k, v), 200),
        **bound_of(nbytes, flops, FP32_FLOPS), "library_ms": time_cuda(sdpa, 500),
        "device_ms": device_ms(lambda: K.flash_attention(q, k, v), "flash_attention"),
        "device_ops_per_call": ops, "device_ms_all_ops": all_ms, "sha": {"out": sha},
        "shape": f"B {B}, S=T {S}, K {Kh}, G {G}, D {D}, float32"})


def _sdpa_layout(q, k, v):
    """(B, S, K, G, D) q and (B, T, K, D) k, v in SDPA's (B, heads, len, D)
    layout; query head k * G + g reads kv head k (``enable_gqa``)."""
    B, S, K, G, D = q.shape
    return (q.reshape(B, S, K * G, D).transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous())


def kernel_flash_attention_bf16(dev, cases=FLASH_BF16_CASES, drop_kv_len: int = 1700, instance=None) -> dict:
    """The bf16 flash forward against its plain version at ``cases``; the
    limits reject a key dropped from rows of ``drop_kv_len`` keys at the
    first case's shape (outputs of a few hundredths) and a causal mask one
    key off at the second's (its ``q_offset`` one more in the plain
    version); repeats bit for bit; timed at the first case beside SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as K

    rng = np.random.default_rng(5)

    def inputs(B, S, T, Kh, G, D):
        mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev).bfloat16()
        return mk(B, S, Kh, G, D), mk(B, T, Kh, D), mk(B, T, Kh, D)

    worst = need = 0.0
    for shape, kw in cases:
        q, k, v = inputs(*shape)
        got = K.flash_attention(q, k, v, **kw)
        want = K.attend_chunked(q, k, v, **kw)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all()),
              f"flash_attention (bf16) gave a non-bf16 or non-finite result at {shape} {kw}")
        err, n = bf16_err(got, want, FLASH_RTOL)
        check(torch.allclose(got.float(), want.float(), rtol=FLASH_RTOL, atol=FLASH_ATOL),
              f"flash_attention (bf16) differs from plain at {shape} {kw}: max |err| {err}, atol needed {n}")
        worst, need = max(worst, err), max(need, n)
    (B, S, T, Kh, G, D), (shape1, kw1) = cases[0][0], cases[1]
    q, k, v = inputs(B, S, T, Kh, G, D)
    long_off = K.flash_attention(q, k, v, causal=False, kv_len=drop_kv_len).float()
    long_want = K.attend_chunked(q, k, v, causal=False, kv_len=drop_kv_len + 1).float()
    check(not torch.allclose(long_off, long_want, rtol=FLASH_RTOL, atol=FLASH_ATOL),
          f"the bf16 limits pass a key dropped from rows of {drop_kv_len} keys")
    q1, k1, v1 = inputs(*shape1)
    off = K.flash_attention(q1, k1, v1, **kw1).float()
    want = K.attend_chunked(q1, k1, v1, **{**kw1, "q_offset": kw1["q_offset"] + 1}).float()
    check(not torch.allclose(off, want, rtol=FLASH_RTOL, atol=FLASH_ATOL), "the bf16 limits pass a key dropped per row")
    again = K.flash_attention(q1, k1, v1, **kw1)
    check(all(torch.equal(K.flash_attention(q1, k1, v1, **kw1), again) for _ in range(3)),
          "flash_attention (bf16) does not repeat bit for bit")
    name = "flash_attention_bf16" + (instance[0] if instance else "")
    print(f"  {name}: {len(cases)} shapes (B {B} S=T {S} K {Kh} G {G} D {D} first), rtol 2^-7 atol {FLASH_ATOL}: "
          f"max |err| {worst:.3g}, atol needed at rtol 2^-7 {need:.3g}; one key dropped per row: max |err| "
          f"{float((off - want).abs().max()):.3g}, one key dropped at kv_len {drop_kv_len}: "
          f"{float((long_off - long_want).abs().max()):.3g}, both rejected; repeats bit for bit")
    qh, kh, vh = _sdpa_layout(q, k, v)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
    sd = sdpa().transpose(1, 2).reshape(B, S, Kh, G, D)
    check(torch.allclose(sd.float(), K.attend_chunked(q, k, v).float(), rtol=2e-2, atol=2e-2),
          "the SDPA yardstick computes another function")
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 2 * 2 * B * Kh * G * (S * (S + 1) // 2) * D  # causal pairs, QK and PV
    return instance_row("flash_attention_bf16", instance, {
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention_bf16.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:71", "max_abs_err": worst, "atol_needed": need,
        "ms": time_cuda(lambda: K.flash_attention(q, k, v), 20, warmup=3),
        "plain_ms": time_cuda(lambda: K.attend_chunked(q, k, v), 10, warmup=2),
        **bound_of(nbytes, flops, BF16_FLOPS), "library_ms": time_cuda(sdpa, 50),
        "device_ms": device_ms(lambda: K.flash_attention(q, k, v), "flash_attention_bf16", iters=10),
        "shape": f"B {B}, S=T {S}, K {Kh}, G {G}, D {D}, bf16, causal"})


def time_flash_bf16(dev, label: str) -> None:
    """The ``--time-flash-bf16`` run: the bf16 flash kernel alone at the
    serve prefill's shape, for comparing versions of it."""
    import torch

    from repro_torch.kernels import flash_attention as K

    g = torch.Generator(device="cpu").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev).bfloat16()
    q, k, v = mk(2, 1792, 2, 7, 64), mk(2, 1792, 2, 64), mk(2, 1792, 2, 64)
    _, need = bf16_err(K.flash_attention(q, k, v), K.attend_chunked(q, k, v), FLASH_RTOL)
    ms = [time_cuda(lambda: K.flash_attention(q, k, v), 100, warmup=5) for _ in range(3)]
    dev_ms = device_ms(lambda: K.flash_attention(q, k, v), "flash_attention_bf16", iters=50)
    print(f"{label}: atol needed {need:.4g}, ms/call {[round(x, 5) for x in ms]}, device ms/call {dev_ms} "
          f"({nvidia_smi_line()})")


TIMED_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err", "ms_n64", "device_ms_n64",
              "device_ms_n0", "copy_ms", "copy_share", "skewed_ms", "skewed_device_ms", "ms_f32", "device_ms_f32",
              "blocks", "device_ops_per_call",
              "device_ms_all_ops", "step_ms", "step_library_ms", "step_device_ops_per_call", "step_device_ms_all_ops",
              "loss_sha", "grad_sha", "sha")


def time_kernels(dev, label: str) -> None:
    """The ``--time-kernels`` run: phase 3's rows of the kernels of the
    simulator and the training step, and the wrappers' host steps, for
    comparing versions of them (each time the median of five)."""
    global TIMING_REPEATS
    TIMING_REPEATS = 5
    rows = [kernel_evict_select(dev), *kernel_freq_table(dev), kernel_flash_attention(dev),
            kernel_flash_attention_bwd(dev), kernel_ssd_scan(dev), *kernel_thrash_ce(dev)]
    out = {r["name"]: {k: r[k] for k in TIMED_KEYS if k in r} for r in rows}
    print(f"{label}: " + json.dumps({"rows": out, "host_us": wrapper_host_us(dev), "card": nvidia_smi_line()}))


def time_training(dev, label: str) -> None:
    """The ``--time-training`` run: phase 7 (a)'s fine-tune group five times
    (host seconds of its 24 steps each) and the fine-tuned ``run_ours`` once
    (host seconds per stage), for comparing versions of the training path."""
    groups = [train_group_run(dev)["wall_s"] for _ in range(5)]
    spent = {"observe": 0.0, "run_segment": 0.0, "train_group": 0.0}
    t0 = time.perf_counter()
    res = fine_tuned_run(dev, spent)
    _sync(dev)
    print(f"{label}: " + json.dumps({"group_24_steps_s": groups, "fine_tuned_wall_s": time.perf_counter() - t0,
                                     "stage_s": spent, "stats": res.stats, "top1": res.top1,
                                     "card": nvidia_smi_line()}))


# (dtype, (B, K, G, D, T), kv_len) of the decode kernel's cases: the serve
# path's shape at kv_len 0..2048, G 1 at D 128 and G 4 at D 32 (phase 3's
# own), and zamba2-7b's at head width 112 (B 2, K 32, T 544: the prefill's
# last key, block edges, the longest cache) and G 9 (G * D 1,008)
DECODE_CASES = ([(dt, (2, 2, 7, 64, 2048), n) for dt in ("float32", "bfloat16")
                 for n in (0, 1, 511, 512, 513, 1800, 2048)]
                + [(dt, shape, n) for dt in ("float32", "bfloat16")
                   for shape, n in (((1, 2, 1, 128, 520), 520), ((2, 2, 4, 32, 64), 40))])
ZAMBA2_DECODE_CASES = [((2, 32, 1, 112, 544), n) for n in (1, 512, 513, 544)] + [((1, 3, 9, 112, 70), 65)]


def decode_drop_control(q, k, v, kv_len: int, rtol: float, atol: float, label: str) -> float:
    """The decode kernel told ``kv_len - 1`` keys against the plain version
    at ``kv_len``: one key dropped, which the limits must reject.  Returns
    the atol that would pass it at ``rtol``."""
    from repro_torch.kernels import decode_attention as K

    off = K.decode_attention_kernelcall(q, k, v, kv_len - 1)
    err, need = bf16_err(off, K.decode_attention_plain(q, k, v, kv_len), rtol)
    check(need > atol, f"{label}: the limits (rtol {rtol}, atol {atol}) pass a dropped key (max |err| {err}, atol "
                       f"needed {need})")
    return need


def kernel_decode_attention(dev, cases=DECODE_CASES, dtype: str = "bfloat16", atol: float = DECODE_ATOL,
                            drop_at: int = 513, instance=None) -> dict:
    """The decode kernel against its plain version at ``cases`` (bf16
    within rtol 2^-7 and ``atol``, float32 within ``FA_RTOL``/``FA_ATOL``);
    at the first case's shape in ``dtype``, key ``drop_at`` dropped rejected, bit-for-bit
    repeats, the split-K's blocks per launch, and times beside SDPA at its
    longest cache."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as K

    rng = np.random.default_rng(6)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    limits = {"float32": (FA_RTOL, FA_ATOL), "bfloat16": (DECODE_RTOL, atol)}
    cases = [c if len(c) == 3 else (dtype, *c) for c in cases]

    def inputs(dt, B, Kh, G, D, T):
        mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev).to(dtypes[dt])
        return mk(B, Kh, G, D), mk(B, T, Kh, D), mk(B, T, Kh, D)

    worst = {dt: 0.0 for dt in dtypes}
    need = 0.0
    for dt, shape, kv_len in cases:
        q, k, v = inputs(dt, *shape)
        got = K.decode_attention_kernelcall(q, k, v, kv_len)
        want = K.decode_attention_plain(q, k, v, kv_len)
        torch.cuda.synchronize()
        rtol, atol_ = limits[dt]
        err, n = bf16_err(got, want, rtol)
        check(got.dtype == q.dtype and torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol_),
              f"decode_attention ({dt}) differs from plain at {shape} kv_len {kv_len}: max |err| {err}, "
              f"atol needed {n}")
        worst[dt] = max(worst[dt], err)
        if dt == dtype:
            need = max(need, n)
    B, Kh, G, D, T = cases[0][1]
    q, k, v = inputs(dtype, B, Kh, G, D, T)
    name = "decode_attention" + (instance[0] if instance else "")
    dropped_need = decode_drop_control(q, k, v, drop_at, *limits[dtype], f"{name} at {cases[0][1]}")
    # split-K: no float atomics, so a call repeats bit for bit
    again = K.decode_attention_kernelcall(q, k, v, T - 1)
    check(all(torch.equal(K.decode_attention_kernelcall(q, k, v, T - 1), again) for _ in range(3)),
          "decode_attention does not repeat bit for bit")
    used = sorted({dt for dt, _, _ in cases})
    print(f"  {name}: {len(cases)} cases ({', '.join(used)}; B {B} K {Kh} G {G} D {D} T {T} first): max |err| "
          f"{json.dumps({dt: worst[dt] for dt in used})} (float32 rtol {FA_RTOL} atol {FA_ATOL}, bf16 rtol 2^-7 atol "
          f"{atol}); {dtype} atol needed at rtol {limits[dtype][0]:.3g}: {need:.3g}, "
          f"with key {drop_at} dropped {dropped_need:.3g} (rejected); repeats bit for bit")
    qh, kh, vh = _sdpa_layout(q[:, None], k, v)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)
    sd = sdpa().transpose(1, 2).reshape(B, Kh, G, D)
    check(torch.allclose(sd.float(), K.decode_attention_plain(q, k, v, T).float(), rtol=2e-2, atol=2e-2),
          "the SDPA yardstick computes another function")
    nbytes = q.element_size() * (2 * q.numel() + 2 * B * T * Kh * D)
    flops = 2 * 2 * B * Kh * G * T * D
    grids: dict = {}
    dev_ms = device_ms(lambda: K.decode_attention_kernelcall(q, k, v, T), "decode_attention", grids=grids)
    if grids:  # split-K spreads the cache over the SMs: at least 64 blocks per kernel
        check(set(grids) == set(KERNEL_SYMBOLS["decode_attention"]) and min(min(b) for b in grids.values()) >= 64,
              f"decode_attention launched {grids} blocks per kernel at kv_len {T}")
    print(f"  {name}: blocks per launch at kv_len {T}, from the profiler: {grids or 'not recorded'}")
    return instance_row("decode_attention", instance, {
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:59", "max_abs_err": max(worst.values()),
        "atol_needed": need, "dropped_key_atol_needed": dropped_need,
        "ms": time_cuda(lambda: K.decode_attention_kernelcall(q, k, v, T), 500),
        "plain_ms": time_cuda(lambda: K.decode_attention_plain(q, k, v, T), 100),
        **bound_of(nbytes, flops, FP32_FLOPS if dtype == "float32" else BF16_FLOPS),
        "library_ms": time_cuda(sdpa, 500), "device_ms": dev_ms, "blocks": grids or None,
        "shape": f"B {B}, K {Kh}, G {G}, D {D}, T {T}, kv_len {T}, {dtype}"})


def _ssd_inputs(dev, dtype, B, L, H, P, N, seed):
    """x, b, c ~ N(0, 1), dt = softplus(N(0, 1)), A_log ~ N(0, 0.25) float32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    x, dt, A_log, b, c = mk(B, L, H, P), mk(B, L, H), 0.5 * mk(H), mk(B, L, N), mk(B, L, N)
    dt = torch.nn.functional.softplus(dt)
    return x.to(dtype), dt.to(dtype), A_log, b.to(dtype), c.to(dtype)


def _ssd_err(got, want, dtype) -> tuple[float, float, bool]:
    """Max |err| of y and of the state, and whether both are within SSD_TOL."""
    import torch

    tol = SSD_TOL[dtype]
    ok = (torch.allclose(got[0].float(), want[0].float(), rtol=tol["y"][0], atol=tol["y"][1])
          and torch.allclose(got[1], want[1], rtol=tol["state"][0], atol=tol["state"][1]))
    return float((got[0].float() - want[0].float()).abs().max()), float((got[1] - want[1]).abs().max()), ok


def _ssd_defects(S):
    """Two defective plain versions: one drops key j = i from query i's sum,
    one carries no state into the second chunk."""
    import torch

    def no_diagonal(x, dt, A_log, b, c, chunk):
        a = -torch.exp(A_log.float())
        state = torch.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]), device=x.device)
        mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril(-1)
        ys = []
        for c0 in range(0, x.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            state, y = S.ssd_chunk_plain(state, x[:, sl].float(), dt[:, sl].float(), a, b[:, sl].float(),
                                         c[:, sl].float(), mask)
            ys.append(y.to(x.dtype))
        return torch.cat(ys, 1), state

    def no_carry(x, dt, A_log, b, c, chunk):
        y0, _ = S.ssd_scan_plain(x[:, :chunk], dt[:, :chunk], A_log, b[:, :chunk], c[:, :chunk], chunk)
        y1, state = S.ssd_scan_plain(x[:, chunk:], dt[:, chunk:], A_log, b[:, chunk:], c[:, chunk:], chunk)
        return torch.cat([y0, y1], 1), state

    return {"no_diagonal": no_diagonal, "no_carry": no_carry}


# (B, L, H, P, N, chunk) of the SSD scan's cases, the first timed, the
# defective plain versions at the last: one layer of the mamba2-370m prefill
# and a small one (N 128), one of zamba2-7b's (N 64, H 112, two chunks)
SSD_SHAPES = ((2, 2048, 32, 64, 128, 256), (1, 512, 4, 64, 128, 256))
ZAMBA2_SSD_SHAPES = ((2, 512, 112, 64, 64, 256),)


def kernel_ssd_scan(dev, shapes=SSD_SHAPES, instance=None) -> dict:
    """The SSD scan against its plain version at ``shapes`` in float32 and
    bf16 within ``SSD_TOL``; the limits reject the defective plain versions
    at the last shape; blocks per launch, and bf16 and float32 times at the
    first."""
    import torch

    from repro_torch.kernels import ssd_scan as S

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {"y": 0.0, "state": 0.0}
    for shape in shapes:
        B, L, H, P, N, Q = shape
        for dtype in dtypes:
            args = _ssd_inputs(dev, dtypes[dtype], B, L, H, P, N, seed=L + H)
            got = S.ssd_scan(*args, chunk=Q)
            want = S.ssd_scan_plain(*args, Q)
            torch.cuda.synchronize()
            check(got[0].dtype == args[0].dtype and bool(torch.isfinite(got[0].float()).all())
                  and bool(torch.isfinite(got[1]).all()), f"ssd_scan gave a wrong dtype or non-finite values at {shape}")
            ey, es, ok = _ssd_err(got, want, dtype)
            check(ok, f"ssd_scan ({dtype}) differs from plain at {shape}: max |err| y {ey}, state {es}")
            worst = {"y": max(worst["y"], ey), "state": max(worst["state"], es)}
    # the limits reject a plain version that drops the diagonal or the state at a chunk boundary
    B, L, H, P, N, Q = shapes[-1]
    args = _ssd_inputs(dev, torch.bfloat16, B, L, H, P, N, seed=7)
    got = S.ssd_scan(*args, chunk=Q)
    defects = {}
    for name, bad in _ssd_defects(S).items():
        ey, es, ok = _ssd_err(got, bad(*args, Q), "bfloat16")
        check(not ok, f"the ssd_scan limits pass a plain version with the defect {name} at {shapes[-1]}")
        defects[name] = ey
    name = "ssd_scan" + (instance[0] if instance else "")
    print(f"  {name}: (B, L, H, P, N, chunk) {', '.join(map(str, shapes))}, float32 and bf16: max |err| y "
          f"{worst['y']:.3g}, state {worst['state']:.3g} (limits {SSD_TOL}); defective plain versions at "
          f"{shapes[-1]}: y off by {json.dumps(defects)}, rejected")
    B, L, H, P, N, Q = shapes[0]
    x, dt, A_log, b, c = _ssd_inputs(dev, torch.bfloat16, B, L, H, P, N, seed=11)
    run = lambda: S.ssd_scan(x, dt, A_log, b, c, chunk=Q)
    nbytes = 2 * (2 * x.numel() + dt.numel() + b.numel() + c.numel()) + 4 * (A_log.numel() + B * H * P * N)
    nc = L // Q
    # C . B^T once per (batch, chunk), causal pairs; per head the causal w . x,
    # C . state and the state update
    flops = B * nc * (Q * (Q + 1) * N + H * (Q * (Q + 1) * P + 4 * Q * N * P))
    grids: dict = {}
    dev_ms = device_ms(run, "ssd_scan", iters=10, grids=grids)
    if grids:  # the chunks run in parallel: every kernel but the pass over the chunks fills the 132 SMs
        chunk_parallel = [k for k in KERNEL_SYMBOLS["ssd_scan"] if k != "ssd_pass_kernel"]
        check(set(grids) == set(KERNEL_SYMBOLS["ssd_scan"]) and min(min(grids[k]) for k in chunk_parallel) >= 132,
              f"ssd_scan launched {grids} blocks per kernel at {shapes[0]}")
    print(f"  {name}: blocks per launch at {shapes[0]}, from the profiler: {grids or 'not recorded'}")
    # the float32 instance at the same shape (the float32 serve runs')
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    run_f32 = lambda: S.ssd_scan(xf, dtf, A_log, bf, cf, chunk=Q)
    return instance_row("ssd_scan", instance, {
        "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:67", "max_abs_err": worst["y"],
        "ms": time_cuda(run, 20, warmup=3),
        "plain_ms": time_cuda(lambda: S.ssd_scan_plain(x, dt, A_log, b, c, Q), 5, warmup=2),
        **bound_of(nbytes, flops, FP32_FLOPS), "library_ms": None, "device_ms": dev_ms,
        "blocks": grids or None, "ms_f32": time_cuda(run_f32, 20, warmup=3),
        "device_ms_f32": device_ms(run_f32, "ssd_scan", iters=10),
        "shape": f"B {B}, L {L}, H {H}, P {P}, N {N}, chunk {Q}, bf16 (and float32: ms_f32, device_ms_f32)"})


# phase 3's instances at zamba2-7b's shapes (head width 112 in the attention
# kernels, N 64 in the SSD scan), each counted on the paths that run it
ZAMBA2_PATHS = {"bfloat16": ("serve_zamba2", "serve_zamba2_81"), "float32": ("serve_zamba2_f32",)}


def zamba2_kernel_rows(dev) -> list[dict]:
    """The attention kernels at head width 112 and the SSD scan at N 64 at
    zamba2-7b's prefill and decode shapes, in each dtype its serve runs
    use; bf16 decode's short rows within ``DECODE_ATOL_SHORT``."""
    bf, f32 = ZAMBA2_PATHS["bfloat16"], ZAMBA2_PATHS["float32"]
    return [kernel_flash_attention(dev, ZAMBA2_FLASH_CASES, ("@D112", f32)),
            kernel_flash_attention_bf16(dev, ZAMBA2_FLASH_CASES, drop_kv_len=500, instance=("@D112", bf)),
            kernel_decode_attention(dev, ZAMBA2_DECODE_CASES, "bfloat16", DECODE_ATOL_SHORT, drop_at=544,
                                    instance=("@D112", bf)),
            kernel_decode_attention(dev, ZAMBA2_DECODE_CASES, "float32", drop_at=544, instance=("@D112_f32", f32)),
            kernel_ssd_scan(dev, ZAMBA2_SSD_SHAPES, ("@N64", bf + f32))]


THRASH_SHAPES = ((256, 1024, 700), (32, 32, 20))  # (B, V, n_active): CONFIG's fine-tune, the serving manager's


def _thrash_inputs(dev, B, V, n_active, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    logits = torch.tensor((3 * rng.standard_normal((B, V))).astype(np.float32), device=dev)
    labels = torch.tensor(rng.integers(0, n_active, B).astype(np.int32), device=dev)
    et = torch.tensor((rng.random(B) < 0.3).astype(np.int32), device=dev)  # int32, as the trainer's flags
    return logits, labels, et


def _thrash_defects(K):
    """Two defective plain versions: the padded classes unmasked, the
    thrashing weight dropped."""
    import torch

    return {"no_mask": lambda lg, lab, et, na, mu: K.thrash_ce_plain(lg, lab, et, lg.shape[-1], mu),
            "no_weight": lambda lg, lab, et, na, mu: K.thrash_ce_plain(lg, lab, torch.zeros_like(et), na, mu)}


def kernel_thrash_ce(dev) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import thrash_ce as K

    mu = 0.5
    worst = {"loss": 0.0, "grad": 0.0}
    defects = {}
    for B, V, n_active in THRASH_SHAPES:
        logits, labels, et = _thrash_inputs(dev, B, V, n_active, seed=V)
        lg = logits.clone().requires_grad_(True)
        loss = K.thrash_ce(lg, labels, et, n_active, mu)
        (grad,) = torch.autograd.grad(loss, lg)
        plain_lg = logits.clone().requires_grad_(True)
        want = K.thrash_ce_plain(plain_lg, labels, et, n_active, mu)
        (want_grad,) = torch.autograd.grad(want, plain_lg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()), f"thrash_ce gave non-finite values at B {B} V {V}")
        ok = lambda l, g: (torch.allclose(l, want, rtol=THRASH_LOSS_TOL[0], atol=THRASH_LOSS_TOL[1])
                           and torch.allclose(g, want_grad, rtol=THRASH_GRAD_TOL[0], atol=THRASH_GRAD_TOL[1]))
        check(ok(loss.detach(), grad), f"thrash_ce differs from plain at B {B} V {V}: loss {float(loss.detach())} vs "
              f"{float(want.detach())}, grad max |err| {float((grad - want_grad).abs().max())}")
        check(bool((grad[:, n_active:] == 0).all()), "thrash_ce's backward sent a gradient to a padded class")
        worst = {"loss": max(worst["loss"], float((loss - want).abs())),
                 "grad": max(worst["grad"], float((grad - want_grad).abs().max()))}
        for name, bad in _thrash_defects(K).items():
            bad_lg = logits.clone().requires_grad_(True)
            bl = bad(bad_lg, labels, et, n_active, mu)
            (bg,) = torch.autograd.grad(bl, bad_lg)
            check(not ok(bl.detach(), bg), f"the thrash_ce limits pass a plain version with the defect {name}")
            defects[f"{name} B{B}"] = max(float((bl - want).abs()), float((bg - want_grad).abs().max()))
    print(f"  thrash_ce: B256 V1024 and B32 V32, loss within rtol/atol {THRASH_LOSS_TOL}, grad {THRASH_GRAD_TOL}: "
          f"max |err| loss {worst['loss']:.3g}, grad {worst['grad']:.3g}; padded classes get no gradient; defective "
          f"plain versions off by {json.dumps(defects)}, rejected")
    B, V, n_active = THRASH_SHAPES[0]
    logits, labels, et = _thrash_inputs(dev, B, V, n_active, seed=1)
    zero = torch.zeros_like(et)
    masked = torch.where(torch.arange(V, device=dev) >= n_active, torch.full_like(logits, -1e30), logits)
    labels64 = labels.long()
    # the library yardstick computes the in_et = 0 case on the masked logits
    check(torch.allclose(F.cross_entropy(masked, labels64), K.thrash_ce_plain(logits, labels, zero, n_active, mu),
                         rtol=1e-5, atol=1e-6), "the cross_entropy yardstick computes another function")
    # the backward is timed alone through autograd: one forward kept, its graph's backward timed
    lg = logits.clone().requires_grad_(True)
    loss = K.thrash_ce(lg, labels, et, n_active, mu)
    plain_lg = logits.clone().requires_grad_(True)
    plain_loss = K.thrash_ce_plain(plain_lg, labels, et, n_active, mu)
    lib_lg = masked.clone().requires_grad_(True)
    lib_loss = F.cross_entropy(lib_lg, labels64)
    g = torch.ones((), device=dev)  # the seed gradient, made once (autograd would fill one per call)
    fwd = lambda: K.thrash_ce(logits, labels, et, n_active, mu)
    bwd = lambda: torch.autograd.grad(loss, lg, g, retain_graph=True)
    step = lambda: torch.autograd.grad(K.thrash_ce(lg, labels, et, n_active, mu), lg, g)
    lib_step = lambda: torch.autograd.grad(F.cross_entropy(lib_lg, labels64), lib_lg, g)
    fwd_bytes = 4 * B * V + 2 * 4 * B + 4  # logits, labels, flags in; one loss out
    bwd_bytes = 2 * 4 * B * V + 2 * 4 * B + 4  # logits, labels, flags, g in; dlogits out
    # a max, a sum of exponentials and the label pick per element; the backward's exp, divide and weight
    fwd_flops, bwd_flops = 4 * B * V, 6 * B * V
    common = {"route": "cuda", "source": "src/repro_torch/csrc/thrash_ce.cu", "shape": f"B {B}, V {V}, float32"}
    (grad,) = step()
    (fwd_ops, fwd_all_ms), (bwd_ops, bwd_all_ms), (step_ops, step_all_ms) = map(device_ops, (fwd, bwd, step))
    fwd_row = {"name": "thrash_ce_fwd", **common, "replaces": "src/repro/kernels/thrash_ce/kernel.py:50",
               "max_abs_err": worst["loss"], "ms": time_cuda(fwd, 500),
               "plain_ms": time_cuda(lambda: K.thrash_ce_plain(logits, labels, et, n_active, mu), 200),
               "bound_ms": max(fwd_bytes / HBM_BYTES_PER_S, fwd_flops / FP32_FLOPS) * 1e3,
               "bound_by": "bytes" if fwd_bytes / HBM_BYTES_PER_S >= fwd_flops / FP32_FLOPS else "operations",
               "library_ms": time_cuda(lambda: F.cross_entropy(masked, labels64), 500),
               "device_ms": device_ms(fwd, "thrash_ce_fwd"),
               "device_ops_per_call": fwd_ops, "device_ms_all_ops": fwd_all_ms,
               # forward + backward through autograd, against cross_entropy's on the masked logits
               "step_ms": time_cuda(step, 500), "step_library_ms": time_cuda(lib_step, 500),
               "step_device_ops_per_call": step_ops, "step_device_ms_all_ops": step_all_ms,
               # phase 3's loss and gradient, bit for bit, to compare two versions of the kernels
               "loss_sha": tensor_sha(fwd()), "grad_sha": tensor_sha(grad)}
    bwd_row = {"name": "thrash_ce_bwd", **common, "replaces": "src/repro/kernels/thrash_ce/kernel.py:71",
               "max_abs_err": worst["grad"], "ms": time_cuda(bwd, 500),
               "plain_ms": time_cuda(lambda: torch.autograd.grad(plain_loss, plain_lg, g, retain_graph=True), 200),
               "bound_ms": max(bwd_bytes / HBM_BYTES_PER_S, bwd_flops / FP32_FLOPS) * 1e3,
               "bound_by": "bytes" if bwd_bytes / HBM_BYTES_PER_S >= bwd_flops / FP32_FLOPS else "operations",
               "library_ms": time_cuda(lambda: torch.autograd.grad(lib_loss, lib_lg, g, retain_graph=True), 500),
               "device_ms": device_ms(bwd, "thrash_ce_bwd"), "device_ops_per_call": bwd_ops,
               "device_ms_all_ops": bwd_all_ms}
    return [fwd_row, bwd_row]


def thrash_ce_checks(dev, rows: list) -> None:
    """What the redesigned ``thrash_ce`` promises beyond its limits: one
    device kernel per forward (the mean inside, no flag cast) and one per
    backward (read from the profiler in the phase-3 rows); the gradient from
    the forward's saved (m, s) equal, bit for bit, to the backward kernel
    recomputing them (the first version's formula) on phase 3's inputs;
    bit-for-bit repeats; ``in_et=None`` as all-zero flags and int64 labels as
    int32 labels, bit for bit."""
    import torch

    from repro_torch.kernels import thrash_ce as K

    by = {r["name"]: r for r in rows}
    for name, key in (("thrash_ce_fwd", "device_ops_per_call"), ("thrash_ce_bwd", "device_ops_per_call"),
                      ("thrash_ce_fwd", "step_device_ops_per_call")):
        want = 2.0 if key.startswith("step") else 1.0
        check(by[name][key] == want, f"{name} ran {by[name][key]} device operations per call ({key}), not {want}")
    B, V, n_active = THRASH_SHAPES[0]
    logits, labels, et = _thrash_inputs(dev, B, V, n_active, seed=1)

    def run(lab, flags):
        lg = logits.clone().requires_grad_(True)
        loss = K.thrash_ce(lg, lab, flags, n_active, 0.5)
        (grad,) = torch.autograd.grad(loss, lg)
        return loss.detach(), grad

    loss, grad = run(labels, et)
    check(torch.equal(grad, K.thrash_ce_bwd(logits, labels, et, n_active, 0.5, torch.ones((), device=dev))),
          "the gradient from the saved (m, s) differs from the recomputing backward kernel's")
    for _ in range(3):
        again = run(labels, et)
        check(torch.equal(again[0], loss) and torch.equal(again[1], grad), "thrash_ce did not repeat bit for bit")
    zero = run(labels, torch.zeros_like(et))
    for lab, flags in ((labels, None), (labels.long(), torch.zeros_like(et))):
        got = run(lab, flags)
        check(torch.equal(got[0], zero[0]) and torch.equal(got[1], zero[1]),
              "in_et=None or int64 labels changed thrash_ce's loss or gradient")
    print(f"  thrash_ce: one device kernel per forward and per backward; the gradient from the saved (m, s) is the "
          f"recomputing kernel's, bit for bit; repeats bit for bit; in_et=None and int64 labels as zeros and int32")


def tensor_sha(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def device_ops(fn, iters: int = 20) -> tuple:
    """Operations (kernels, copies, fills) the device ran per call of
    ``fn`` and their device milliseconds per call, from ``torch.profiler``;
    (None, None) if the profiler recorded none."""
    times = device_times(profiled(fn, iters)).values()
    n = sum(c for _, c in times)
    return (n / iters, sum(t for t, _ in times) / iters * 1e3) if n else (None, None)


def wrapper_host_us(dev) -> dict:
    """Host microseconds per call of each step a kernel wrapper takes, at
    phase 3's timing shapes (``time.perf_counter`` over 2,000 calls each,
    no synchronise inside): the whole wrapper, its input checks, and the
    generic steps it may take (a no-op dtype cast and ``contiguous``, an
    output allocation, the stream lookup, a ``mean`` launch, a trivial
    autograd ``Function``); for the float32 attention also the forward with
    a gradient, the backward through autograd and alone, three allocations
    against one carved in three, the cached shape arguments and the bare
    launcher."""
    import numpy as np
    import torch

    from repro_torch.kernels import evict_select as ES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import thrash_ce as TC
    from repro_torch.kernels._lib import LIBRARY, stream_handle

    class Identity(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x

        @staticmethod
        def backward(ctx, g):
            return g

    def us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    B, V, n_active = THRASH_SHAPES[0]
    logits, labels, et32 = _thrash_inputs(dev, B, V, n_active, seed=1)
    et, row = et32.bool(), torch.zeros(B, device=dev)
    lg = logits.clone().requires_grad_(True)
    rng = np.random.default_rng(0)
    cand = torch.tensor(rng.random(256) < 0.6, device=dev)
    keys = tuple(torch.tensor(rng.integers(0, 9, 256, dtype=np.int32), device=dev) for _ in range(3))
    ne = torch.tensor(1, dtype=torch.int32, device=dev)
    with torch.enable_grad():
        grad_call = us(lambda: TC.thrash_ce(lg, labels, et32, n_active, 0.5))
        trivial = us(lambda: Identity.apply(lg))
    # the float32 attention at the predictor's shape
    mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    q, k, v, do = mk(256, 10, 2, 1, 32), mk(256, 10, 2, 32), mk(256, 10, 2, 32), mk(256, 10, 2, 1, 32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        fwd_grad = us(lambda: FA.flash_attention(*leaves))
        out = FA.flash_attention(*leaves)
    nq, nk = q.numel(), k.numel()

    def carve():
        buf = torch.empty(nq + 2 * nk, device=dev)
        return (buf.as_strided(q.shape, q.stride()), buf.as_strided(k.shape, k.stride(), nq),
                buf.as_strided(k.shape, k.stride(), nq + nk))

    flash = {"wrapper": us(lambda: FA.flash_attention(q, k, v)), "wrapper_grad": fwd_grad,
             "backward_through_autograd": us(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)),
             "bwd_wrapper": us(lambda: FA.flash_attention_bwd(q, k, v, do)),
             "check": us(lambda: FA._check(q, k, v)),
             "dtype_contiguity": us(lambda: k.dtype == q.dtype and v.dtype == q.dtype and q.is_contiguous()
                                    and k.is_contiguous() and v.is_contiguous()),
             "empty_like": us(lambda: torch.empty_like(q)),
             "empty_like_x3": us(lambda: (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))),
             "one_empty_as_strided_x3": us(carve),
             "stream_handle": us(lambda: stream_handle(dev))}
    if hasattr(FA, "_shape_args"):
        fn, args = LIBRARY.function("repro_flash_attention_f32"), FA._shape_args(q, 10, True, 0, None)[1]
        o = torch.empty_like(q)
        flash["shape_args"] = us(lambda: FA._shape_args(q, 10, True, 0, None))
        flash["launcher"] = us(lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), args,
                                          stream_handle(dev)))
    return {
        "flash_attention": flash,
        "thrash_ce": {"wrapper_bool_flags": us(lambda: TC.thrash_ce(logits, labels, et, n_active, 0.5)),
                      "wrapper_int32_flags": us(lambda: TC.thrash_ce(logits, labels, et32, n_active, 0.5)),
                      "wrapper_int32_flags_grad": grad_call,
                      "check": us(lambda: TC._check(logits, labels, et32, n_active)),
                      "noop_cast_contiguous_x3": us(lambda: (logits.contiguous(), labels.to(torch.int32).contiguous(),
                                                             et32.to(torch.int32).contiguous())),
                      "bool_to_int32_cast": us(lambda: et.to(torch.int32)),
                      "empty": us(lambda: torch.empty(B, dtype=torch.float32, device=dev)),
                      "stream_handle": us(lambda: stream_handle(dev)),
                      "mean": us(lambda: row.mean()),
                      "trivial_function_grad": trivial},
        "evict_select": {"wrapper": us(lambda: ES.evict_select(cand, keys, ne)),
                         "check": us(lambda: ES._check(cand, keys, ne)),
                         "empty_like": us(lambda: torch.empty_like(cand)),
                         "stream_handle": us(lambda: stream_handle(dev))}}


def kernel_flash_attention_bwd(dev) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as K

    rng = np.random.default_rng(8)

    def inputs(B, S, T, Kh, G, D):
        mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev)
        return mk(B, S, Kh, G, D), mk(B, T, Kh, D), mk(B, T, Kh, D), mk(B, S, Kh, G, D)

    def within(got, want):
        return all(torch.allclose(a, b, rtol=ATTN_BWD_TOL[0], atol=ATTN_BWD_TOL[1]) for a, b in zip(got, want))

    worst = 0.0
    cases = [((256, 10, 10, 2, 1, 32), {}), ((256, 10, 10, 2, 1, 8), {}), ((3, 37, 37, 2, 3, 64), {}),
             ((2, 5, 70, 1, 2, 16), {"q_offset": 65}), ((4, 10, 10, 2, 1, 32), {"causal": False, "kv_len": 7}),
             ((2, 9, 9, 2, 1, 128), {"kv_len": 6})]
    for shape, kw in cases:
        q, k, v, do = inputs(*shape)
        got = K.flash_attention_bwd(q, k, v, do, **kw)
        want = K.attention_grads_plain(q, k, v, do, **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got), f"flash_attention_bwd gave non-finite values at {shape} {kw}")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(within(got, want), f"flash_attention_bwd differs from plain at {shape} {kw}: max |err| {err}")
        worst = max(worst, err)
        if shape == cases[0][0]:
            sha = {name: tensor_sha(g) for name, g in zip(("dq", "dk", "dv"), got)}
    for name, got_sha in sha.items():
        check(got_sha == FA_SHA[name], f"flash_attention_bwd's {name} SHA-256 {got_sha} is not the serial kernel's "
                                       f"{FA_SHA[name]}")
    # through autograd: the wrapper's gradient is the backward kernel's
    q, k, v, do = inputs(8, 10, 10, 2, 1, 32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    K.flash_attention(*leaves).backward(do)
    check(all(torch.equal(t.grad, g) for t, g in zip(leaves, K.flash_attention_bwd(q, k, v, do))),
          "autograd through flash_attention did not give the backward kernel's gradient")
    # the limits reject a plain version whose backward drops the causal mask
    q, k, v, do = inputs(256, 10, 10, 2, 1, 32)
    got = K.flash_attention_bwd(q, k, v, do)
    with torch.enable_grad():
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = (K.attend_chunked(qq, kk, vv).detach() + K.attend_chunked(qq, kk, vv, causal=False)
               - K.attend_chunked(qq, kk, vv, causal=False).detach())
        bad = torch.autograd.grad(out, (qq, kk, vv), do)
    check(not within(got, bad), "the attention backward limits pass a dropped causal mask")
    off = max(float((a - b).abs().max()) for a, b in zip(got, bad))
    print(f"  flash_attention_bwd: {len(cases)} shapes (the predictor's CONFIG and SMOKE shapes first), rtol/atol "
          f"{ATTN_BWD_TOL}: max |err| {worst:.3g}; autograd reaches the kernel; causal mask dropped: off by "
          f"{off:.3g}, rejected; SHA-256 of dQ, dK, dV {sha}, the serial kernel's")
    B, S, T, Kh, G, D = 256, 10, 10, 2, 1, 32
    q, k, v, do = inputs(B, S, T, Kh, G, D)
    ops, all_ms = device_ops(lambda: K.flash_attention_bwd(q, k, v, do))
    check(ops == 1.0, f"flash_attention_bwd ran {ops} device operations per call, not 1")
    with torch.enable_grad():
        pl = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain_out = K.attend_chunked(*pl)
        lib = [t.clone().requires_grad_(True) for t in _sdpa_layout(q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
    lib_do = do.reshape(B, S, Kh * G, D).transpose(1, 2).contiguous()
    lib_grads = torch.autograd.grad(lib_out, lib, lib_do, retain_graph=True)
    check(torch.allclose(lib_grads[0].transpose(1, 2).reshape(B, S, Kh, G, D), K.flash_attention_bwd(q, k, v, do)[0],
                         rtol=1e-3, atol=1e-4), "the SDPA backward yardstick computes another function")
    pairs = S * (S + 1) // 2
    nbytes = 4 * (2 * q.numel() + 2 * k.numel()) + 4 * (q.numel() + 2 * k.numel())  # q, do, k, v in; dq, dk, dv out
    flops = 5 * 2 * B * Kh * G * pairs * D  # scores, dP, dQ, dK, dV over the causal pairs
    return {"name": "flash_attention_bwd", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71", "max_abs_err": worst,
            "ms": time_cuda(lambda: K.flash_attention_bwd(q, k, v, do), 500),
            "plain_ms": time_cuda(lambda: torch.autograd.grad(plain_out, pl, do, retain_graph=True), 200),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations",
            "library_ms": time_cuda(lambda: torch.autograd.grad(lib_out, lib, lib_do, retain_graph=True), 500),
            "device_ms": device_ms(lambda: K.flash_attention_bwd(q, k, v, do), "flash_attention_bwd"),
            "device_ops_per_call": ops, "device_ms_all_ops": all_ms, "sha": sha,
            "shape": f"B {B}, S=T {S}, K {Kh}, G {G}, D {D}, float32, causal"}


# --- phase 4: the main path ------------------------------------------------------


def main_path(dev) -> tuple[dict, dict]:
    import torch

    from repro_torch import kernels
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import simulator as S
    from repro_torch.uvm import trace as T
    from repro_torch.uvm.manager import OversubscriptionManager

    ref = json.loads(REF.read_text())
    check(ref["benchmark"] == "Hotspot" and ref["scale"] == 1.0 and ref["oversubscription"] == 1.5,
          "the reference file is not the Hotspot x1.5 run")
    tcfg = TrainConfig(**ref["train"])
    trace = T.get_trace("Hotspot", 1.0)
    table = R.load_pretrained(WEIGHTS, CONFIG, dev)

    # host-clock breakdown of the loop's stages (each ends in a host sync:
    # evaluate and run_segment read their results back)
    spent = {"observe": 0.0, "run_segment": 0.0, "apply_prefetch": 0.0}
    originals = {"observe": OversubscriptionManager.observe, "run_segment": S.run_segment,
                 "apply_prefetch": S.apply_prefetch}

    OversubscriptionManager.observe = timed(spent, "observe", originals["observe"])
    S.run_segment = timed(spent, "run_segment", originals["run_segment"])
    S.apply_prefetch = timed(spent, "apply_prefetch", originals["apply_prefetch"])
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = R.run_ours(trace, CONFIG, tcfg, oversubscription=1.5, table=table, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        OversubscriptionManager.observe = originals["observe"]
        S.run_segment = originals["run_segment"]
        S.apply_prefetch = originals["apply_prefetch"]
    full = ref["full"]
    out = {"benchmark": "Hotspot", "scale": 1.0, "oversubscription": 1.5, "accesses": len(trace),
           "stats": res.stats, "top1": res.top1, "n_predictions": res.n_predictions, "ipc": res.ipc(),
           "wall_s": wall, "stage_s": spent, "launches": launches}
    print("  main path: " + json.dumps(out))
    check(res.stats == full["stats"], f"stats {res.stats} != JAX reference {full['stats']}")
    check(res.top1 == full["top1"], f"top-1 {res.top1!r} != JAX reference {full['top1']!r}")
    check(res.n_predictions == full["n_predictions"], "prediction count differs from the JAX reference")
    check(math.isfinite(res.ipc()) and res.ipc() > 0, "non-finite IPC")
    for name in ("evict_select", "freq_update", "flash_attention"):
        check(launches[name] > 0, f"the main path never launched {name}")
    print(f"  main path: stats, top-1 ({res.top1}) and prediction count equal the JAX reference; "
          f"wall {wall:.3f} s")
    res = profile_run("main path", lambda: R.run_ours(trace, CONFIG, tcfg, oversubscription=1.5,
                                                       table=R.load_pretrained(WEIGHTS, CONFIG, dev), device=dev))
    check(res.stats == full["stats"], "the profiled main-path run gave other stats")
    return out, launches


# the device symbols each port kernel's wrapper launches
KERNEL_SYMBOLS = {"evict_select": ("evict_select_kernel",), "freq_update": ("freq_update_kernel",),
                  "freq_lookup": ("freq_lookup_kernel",), "flash_attention": ("fa_fwd_kernel",),
                  "flash_attention_bf16": ("fa_wgmma_fwd_kernel",), "flash_attention_bwd": ("fa_bwd_kernel",),
                  "decode_attention": ("decode_scores_kernel", "decode_pv_kernel"),
                  "ssd_scan": ("ssd_states_kernel", "ssd_pass_kernel", "ssd_y_kernel"),
                  "thrash_ce_fwd": ("thrash_ce_fwd_kernel",),
                  "thrash_ce_bwd": ("thrash_ce_bwd_kernel",)}


def is_kernel(name: str, symbol: str) -> bool:
    """Whether a profiler key is a device symbol of port kernel ``name``."""
    return any(k in symbol for k in KERNEL_SYMBOLS[name])


def profile_run(label: str, run):
    """Run a path once more under ``torch.profiler`` (CUDA activity), print
    where the device time goes (the summed time of every kernel, one stream,
    so kernels do not overlap; its share of the run's wall time; each port
    kernel's device time and count; the top kernels by time) and return the
    run's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_times(prof)
    busy = sum(t for t, _ in by_name.values())
    port = {name: {"device_s": sum(t for k, (t, _) in by_name.items() if is_kernel(name, k)),
                   "count": sum(c for k, (_, c) in by_name.items() if is_kernel(name, k))}
            for name in KERNEL_SYMBOLS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print(f"  {label} profile: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall if busy else None,
        "port_kernels": port,
        "top_kernels": [{"name": k[:100], "device_s": t, "count": c} for k, (t, c) in top]}))
    return res


# --- phases 5 and 6: the serving path ----------------------------------------------


def load_ref(path) -> tuple[dict, dict]:
    """A reference ``.npz``'s arrays (float32 byte planes decoded) and its
    ``run`` record."""
    from repro_torch.convert import arrays_from_npz

    ref = arrays_from_npz(path)
    return ref, json.loads(str(ref["run"]))


def logit_checker(ref, atol: float, dev):
    """``compare(step, logits)`` holds one step's last-position logits to
    the reference's at its top-8 ids within ``atol``, and the top-1 to the
    reference's wherever its top-1/top-2 margin exceeds ``2 * atol``; the
    returned dict collects each step's max |err| and the (row, step)s whose
    top-1 was checked."""
    import numpy as np
    import torch

    seen = {"errs": [], "top1_checked": 0}

    def compare(step, logits):
        lg = logits[:, -1].float()
        ids = torch.tensor(ref["top_ids"][step], device=dev, dtype=torch.long)
        err = float((lg.gather(1, ids) - torch.tensor(ref["top_logits"][step], device=dev)).abs().max())
        seen["errs"].append(err)
        check(err <= atol, f"teacher-forced step {step}: logits differ from the reference by {err} > {atol}")
        top1 = lg.argmax(-1).cpu().numpy()
        sure = ref["margin"][step] > 2 * atol
        check(np.array_equal(top1[sure], ref["top_ids"][step][sure, 0]),
              f"teacher-forced step {step}: top-1 differs where the reference's margin exceeds {2 * atol}")
        seen["top1_checked"] += int(sure.sum())

    return compare, seen


def fork_check(tokens, ref, atol: float) -> list[dict]:
    """Where a row's free-run tokens first differ from the reference's, the
    port chose another of the reference's top-8 ids: with every logit within
    ``atol`` of the reference's, that id can outrank the reference's top-1
    only if the reference has it at most ``2 * atol`` below.  Returns the
    forks; fails on one that breaks the rule."""
    import numpy as np

    forks = []
    for row in range(len(tokens)):
        diff = np.nonzero(tokens[row] != ref["tokens"][row])[0]
        if diff.size == 0:
            continue
        step, tok = int(diff[0]), int(tokens[row, diff[0]])
        ids, lg = ref["top_ids"][step, row], ref["top_logits"][step, row]
        gap = float(lg[0] - lg[ids == tok][0]) if (ids == tok).any() else math.inf
        forks.append({"row": row, "step": step, "token": tok, "ref_token": int(ref["tokens"][row, step]),
                      "ref_gap": gap})
    for f in forks:
        check(f["ref_gap"] <= 2 * atol, f"row {f['row']}: tokens fork from the reference at step {f['step']} "
              f"to {f['token']}, {f['ref_gap']} below the reference's top-1 there (more than {2 * atol})")
    return forks


def timed(spent: dict, name: str, fn):
    """``fn`` with its host seconds, up to a synchronise, added to ``spent[name]``."""
    import torch

    def wrapper(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spent[name] += time.perf_counter() - t
        return out
    return wrapper


def serve_path(dev):
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import numpy_params
    from repro_torch.serving.engine import OFFLOAD_KINDS, Engine

    ref, run = load_ref(SERVE_REF)
    cfg = get_config(run["arch"])
    S, n_new, pad_to = run["prompt_len"], run["n_new"], run["pad_to"]
    prompt = np.random.default_rng(run["prompt_seed"]).integers(0, cfg.vocab_size, (run["batch"], S))
    check(np.array_equal(prompt, ref["prompt"]), "the reference's prompt is not default_rng(1)'s")
    t0 = time.perf_counter()
    weights = numpy_params(lm.param_specs(cfg), run["seed"])
    eng = Engine(cfg, {k: torch.from_numpy(v) for k, v in weights.items()}, offload=run["offload"],
                 hbm_fraction=run["hbm_fraction"], device=dev)
    del weights
    torch.cuda.synchronize()
    print(f"  engine: {cfg.name}, {lm.param_count(cfg):,} parameters, {cfg.dtype}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    mgr = eng.make_manager(pad_to)
    n_pages, cap = mgr.n_pages, mgr.capacity
    check((n_pages, cap) == (int(ref["n_pages"]), int(ref["capacity"])), "the KV page pool differs from the reference's")

    # 1. teacher-forced: prefill + n_new decode steps fed the reference's tokens
    tokens = torch.tensor(prompt, device=dev)
    ref_tok = ref["tokens"]
    mass_err = 0.0
    compare, seen = logit_checker(ref, SERVE_ATOL, dev)

    with torch.no_grad():
        logits, cache = eng.prefill(eng.params, {"tokens": tokens})
        cache = eng._grow_cache(cache, pad_to)
        compare(0, logits)
        for i in range(n_new):
            logits, cache = eng.decode(eng.params, {"token": torch.tensor(ref_tok[:, i], device=dev), "pos": S + i},
                                       cache)
            compare(i + 1, logits)
            mass, _ = eng.page_mass(cache, S + i, n_pages)
            want = ref["page_mass"][i]
            rel = np.abs(mass - want) / np.maximum(np.abs(want), 1e-30)
            mass_err = max(mass_err, float(rel[want > 0].max()))
            check(bool(np.all(np.abs(mass - want) <= MASS_RTOL * np.abs(want))),
                  f"step {i}: page mass differs from the reference's by rtol {mass_err} > {MASS_RTOL}")
    del cache, logits
    errs = seen["errs"]
    print(f"  teacher-forced: {n_new + 1} steps, logits at the reference's top-8 ids within {max(errs):.4g} "
          f"(atol {SERVE_ATOL}; mean of per-step max {np.mean(errs):.4g}); top-1 equal at {seen['top1_checked']} of "
          f"{(n_new + 1) * len(prompt)} (row, step)s whose margin exceeds {2 * SERVE_ATOL}; page mass within rtol "
          f"{mass_err:.3g} ({MASS_RTOL})")

    # 2. the reference's mass stream replayed through the port's managers
    replay = {}
    for kind in ("learned", "lru"):
        m = OFFLOAD_KINDS[kind](n_pages, cap, device=dev)
        for mass, touched in zip(ref["page_mass"], ref["touched"]):
            m.on_attention(mass, np.nonzero(touched)[0])
        got = dataclasses.asdict(m.stats)
        want = dict(zip(ref["stat_keys"].tolist(), ref[f"{kind}_stats"].tolist()))
        check(got == want, f"replayed {kind} stats {got} != JAX reference {want}")
        replay[kind] = got
    print(f"  replay: offload stats equal the JAX reference's exactly: {json.dumps(replay)}")

    # 3. the free run, as launch/serve drives it; launch counts from here only
    spent = {"prefill": 0.0, "decode": 0.0, "offload": 0.0}
    originals = {"prefill": eng.prefill, "decode": eng.decode, "offload": eng._drive_offload}
    free_mass = []  # the page masses the free run hands its manager, one per step

    def recorded(cache, pos, n):
        mass, touched = Engine.page_mass(cache, pos, n)
        free_mass.append(mass)
        return mass, touched

    eng.prefill, eng.decode, eng._drive_offload = (timed(spent, k, f) for k, f in originals.items())
    eng.page_mass = recorded
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            res = eng.generate({"tokens": prompt}, n_new, pad_to=pad_to)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        eng.prefill, eng.decode, eng._drive_offload = originals.values()
        del eng.page_mass
    forks = fork_check(res.tokens, ref, SERVE_ATOL)
    # until the first fork the free run feeds its manager the reference's
    # tokens, so its page masses are held to the reference's as above
    n_same = min([f["step"] for f in forks], default=n_new)
    check(len(free_mass) == n_new, f"the free run computed {len(free_mass)} page masses, not {n_new}")
    want = ref["page_mass"][:n_same]
    free_err = max([float((np.abs(m - w) / np.maximum(np.abs(w), 1e-30))[w > 0].max())
                    for m, w in zip(free_mass, want)], default=0.0)
    out = {"prefill_s": spent["prefill"], "decode_ms_per_step": spent["decode"] / n_new * 1e3,
           "offload_ms_per_step": spent["offload"] / n_new * 1e3, "wall_s": wall,
           "tokens_per_s": res.tokens.size / wall, "offload_stats": res.offload_stats,
           "forks": forks, "mass_steps_checked": n_same, "mass_rtol": free_err, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("  free run: " + json.dumps(out))
    check(free_err <= MASS_RTOL, f"the free run's page mass before its first fork differs from the reference's "
          f"by rtol {free_err} > {MASS_RTOL}")
    L = cfg.num_layers
    want = {"flash_attention_bf16": L, "decode_attention": L * n_new, "freq_update": n_new}
    for name, n in want.items():
        check(launches[name] == n, f"the serve path launched {name} {launches[name]} times, not {n}")
    check(all(launches[k] == 0 for k in launches if k not in want), f"the serve path launched other kernels: {launches}")
    # 4. where the device time goes: prefill and the first 64 decode steps, to keep the phase short
    res2 = profile_run("serve", lambda: eng.generate({"tokens": prompt}, 64, pad_to=pad_to))
    check(np.array_equal(res2.tokens, res.tokens[:, :64]), "the profiled serve run gave other tokens")
    return launches, eng, prompt


def teacher_forced_ssm(eng, ref, prompt, atol: float, norm_rtol: float, dev, label: str) -> None:
    """Prefill the prompt and decode the reference's tokens; hold every
    step's logits to the reference's (``logit_checker``) and the prefill's
    final SSM state norms within ``norm_rtol``: per (layer, row, head), or
    per (layer, row) where the reference records those (the hybrid's)."""
    import numpy as np
    import torch

    compare, seen = logit_checker(ref, atol, dev)
    S, n_new = prompt.shape[1], ref["tokens"].shape[1]
    with torch.no_grad():
        logits, cache = eng.prefill(eng.params, {"tokens": torch.tensor(prompt, device=dev)})
        cache = eng._grow_cache(cache, S + n_new)  # the hybrid's keys and values; nothing else grows
        compare(0, logits)
        dims = tuple(range(ref["state_norm"].ndim, cache["ssm"].dim()))  # (layers, rows, heads, P, N)
        norms = torch.linalg.vector_norm(cache["ssm"], dim=dims).cpu().numpy()
        norm_err = float(np.max(np.abs(norms / ref["state_norm"] - 1)))
        check(norm_err <= norm_rtol, f"{label}: prefill's final SSM state norms differ from the reference's by rtol "
              f"{norm_err} > {norm_rtol}")
        for i in range(n_new):
            logits, cache = eng.decode(eng.params, {"token": torch.tensor(ref["tokens"][:, i], device=dev),
                                                    "pos": S + i}, cache)
            compare(i + 1, logits)
    errs = seen["errs"]
    print(f"  teacher-forced {label}: {n_new + 1} steps, logits at the reference's top-8 ids within {max(errs):.4g} "
          f"(atol {atol}; mean of per-step max {np.mean(errs):.4g}); top-1 equal at {seen['top1_checked']} of "
          f"{(n_new + 1) * len(prompt)} (row, step)s whose margin exceeds {2 * atol}; final-state norms within rtol "
          f"{norm_err:.3g} ({norm_rtol})")


def mamba2_reference_checks(dev):
    """Phase 6 up to its free run: build the bf16 and float32 engines, hold
    both to the reference teacher-forced and the float32 free run to its
    forks.  Returns (the bf16 engine, the reference, the prompt)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import numpy_params
    from repro_torch.serving.engine import Engine

    ref, run = load_ref(MAMBA2_REF)
    cfg = get_config(run["arch"])
    S, n_new = run["prompt_len"], run["n_new"]
    prompt = np.random.default_rng(run["prompt_seed"]).integers(0, cfg.vocab_size, (run["batch"], S))
    check(np.array_equal(prompt, ref["prompt"]), "the reference's prompt is not default_rng(1)'s")
    t0 = time.perf_counter()
    masters = {k: torch.from_numpy(v) for k, v in numpy_params(lm.param_specs(cfg), run["seed"]).items()}
    eng = Engine(cfg, masters, offload=run["offload"], hbm_fraction=run["hbm_fraction"], device=dev)
    eng32 = Engine(cfg.replace(dtype="float32"), masters, device=dev)
    del masters
    torch.cuda.synchronize()
    print(f"  engines: {cfg.name}, {lm.param_count(cfg):,} parameters, {cfg.dtype} and float32, built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(eng.make_manager(S + n_new) is None and json.loads(str(ref["offload_stats"])) is None,
          "an offload manager for a family without a KV cache")

    # 1. teacher-forced, bf16 and float32: prefill + decode steps fed the reference's tokens
    ref32 = {k[4:]: v for k, v in ref.items() if k.startswith("f32_")}
    teacher_forced_ssm(eng, ref, prompt, MAMBA2_ATOL["bfloat16"], STATE_NORM_RTOL["bfloat16"], dev, "bf16")
    teacher_forced_ssm(eng32, ref32, prompt, MAMBA2_ATOL["float32"], STATE_NORM_RTOL["float32"], dev, "float32")
    # the float32 free run: the reference's float32 tokens up to a fork, by the fork rule
    with torch.no_grad():
        res32 = eng32.generate({"tokens": prompt}, ref32["tokens"].shape[1])
    forks32 = fork_check(res32.tokens, ref32, MAMBA2_ATOL["float32"])
    print(f"  float32 free run: {res32.tokens.shape[1]} tokens, forks {json.dumps(forks32)}")
    return eng, ref, prompt


def serve_mamba2_path(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch import kernels

    eng, ref, prompt = mamba2_reference_checks(dev)
    n_new = ref["tokens"].shape[1]
    # 2. the free run, as launch/serve drives it; launch counts from here only
    spent = {"prefill": 0.0, "decode": 0.0}
    originals = {"prefill": eng.prefill, "decode": eng.decode}
    eng.prefill, eng.decode = (timed(spent, k, f) for k, f in originals.items())
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            res = eng.generate({"tokens": prompt}, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        eng.prefill, eng.decode = originals.values()
    out = {"prefill_s": spent["prefill"], "decode_ms_per_step": spent["decode"] / n_new * 1e3, "wall_s": wall,
           "tokens_per_s": res.tokens.size / wall, "offload_stats": res.offload_stats, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("  free run: " + json.dumps(out))
    forks = fork_check(res.tokens, ref, MAMBA2_ATOL["bfloat16"])
    print("  forks: " + json.dumps(forks))
    check(res.offload_stats is None, f"the ssm family reported offload stats {res.offload_stats}")
    L = eng.cfg.num_layers
    check(launches["ssd_scan"] == L, f"the mamba2 serve path launched ssd_scan {launches['ssd_scan']} times, not {L}")
    check(all(n == 0 for k, n in launches.items() if k != "ssd_scan"),
          f"the mamba2 serve path launched other kernels: {launches}")
    # 3. where the device time goes: prefill and the first 32 decode steps, to keep the phase short
    res2 = profile_run("serve mamba2", lambda: eng.generate({"tokens": prompt}, 32))
    check(np.array_equal(res2.tokens, res.tokens[:, :32]), "the profiled mamba2 serve run gave other tokens")
    return launches


# --- phase 7: the training path ------------------------------------------------------


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def train_group_run(dev) -> dict:
    """Phase 7 (a) up to its checks: the reference's recorded fine-tune group
    (``TrainConfig()`` at ``CONFIG``: 24 steps, LUCIR and the thrashing term
    on) from its slot of the pretrained table, params and AdamW moments, on
    ``dev``.  Returns each step's loss and gradient norm, the distance of
    the update from the reference's and the launches."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.core.features import FeatureSet
    from repro_torch.core.incremental import TrainConfig, Trainer
    from repro_torch.core.model_table import Entry, clone_tree
    from repro_torch.uvm import runtime as R

    ref, meta = load_ref(TRAIN_REF)
    slot = R.load_pretrained(WEIGHTS, CONFIG, dev).slots[meta["slot"]]
    check(slot.step == meta["step"] and slot.opt_state is not None,
          "the table's slot is not the reference group's start (its step and moments)")
    fs = FeatureSet(*(ref[f"group/{f}"] for f in ("page", "delta", "pc", "tb", "label", "label_page", "t_index")))
    trainer = Trainer(CONFIG, TrainConfig(**meta["train"]), device=dev)
    metrics = []
    step = trainer._train_step

    def recording(*a):
        out = step(*a)
        metrics.append(out[2])
        return out

    trainer._train_step = recording
    entry = Entry(params=clone_tree(slot.params), prev_params=clone_tree(slot.params),
                  opt_state=clone_tree(slot.opt_state), step=slot.step)
    _sync(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.train_group(entry, fs, meta["n_active"], in_et=ref["in_et"], use_lucir=meta["use_lucir"])
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    loss = np.array([float(m["total"]) for m in metrics])
    gnorm = np.array([float(m["grad_norm"]) for m in metrics])
    num = den = 0.0
    max_abs = 0.0
    for k, p in entry.params.items():
        got, start, want = p.double().cpu().numpy(), slot.params[k].double().cpu().numpy(), ref[f"final/{k}"]
        num += float(np.sum((got - want) ** 2))
        den += float(np.sum((want - start) ** 2))
        max_abs = max(max_abs, float(np.abs(got - want).max()))
    rel = lambda a, b: np.abs(a - b) / np.abs(b)
    held = slice(0, TRAIN_STEPS_HELD)
    return {"n_steps": len(metrics), "want_steps": meta["n_steps"], "wall_s": wall, "launches": launches,
            "loss": loss.tolist(), "grad_norm": gnorm.tolist(),
            "loss_rtol_held": float(rel(loss, ref["step_loss"])[held].max()),
            "grad_norm_rtol_held": float(rel(gnorm, ref["step_grad_norm"])[held].max()),
            "loss_rtol_all": float(rel(loss, ref["step_loss"]).max()),
            "update_rel": (num / den) ** 0.5, "params_max_abs": max_abs}


def train_group_check(dev) -> dict:
    from repro_torch.configs.predictor_paper import CONFIG

    res = train_group_run(dev)
    print("  train_group: " + json.dumps({k: v for k, v in res.items() if k not in ("loss", "grad_norm")}))
    again = profile_run("train_group", lambda: train_group_run(dev))
    check(again["n_steps"] == res["n_steps"], f"the profiled group took {again['n_steps']} steps")
    n = res["want_steps"]
    check(res["n_steps"] == n, f"the group took {res['n_steps']} steps, not {n}")
    check(res["loss_rtol_held"] <= TRAIN_STEP_RTOL and res["grad_norm_rtol_held"] <= TRAIN_STEP_RTOL,
          f"the first {TRAIN_STEPS_HELD} steps' loss or gradient norm differ from the reference's by rtol "
          f"{res['loss_rtol_held']} / {res['grad_norm_rtol_held']} > {TRAIN_STEP_RTOL}")
    check(res["update_rel"] <= TRAIN_UPDATE_RTOL, f"the group's update differs from the reference's by "
          f"{res['update_rel']} of its norm > {TRAIN_UPDATE_RTOL}")
    want = {"thrash_ce_fwd": n, "thrash_ce_bwd": n, "flash_attention_bwd": n * 2 * CONFIG.num_layers}
    for name, count in want.items():
        check(res["launches"][name] == count, f"train_group launched {name} {res['launches'][name]} times, not {count}")
    print(f"  train_group: {n} steps in {res['wall_s']:.3f} s; the first {TRAIN_STEPS_HELD} steps' loss and gradient "
          f"norm within rtol {max(res['loss_rtol_held'], res['grad_norm_rtol_held']):.3g} ({TRAIN_STEP_RTOL}); the "
          f"update within {res['update_rel']:.3g} of its norm ({TRAIN_UPDATE_RTOL}); launches {json.dumps(want)}")
    return res["launches"]


def fine_tuned_run(dev, spent: dict | None = None):
    """The reference's fine-tuned ``run_ours`` (Hotspot x1.5, ``TrainConfig()``,
    ``CONFIG``) from the pretrained table, every slot with its AdamW
    moments, on ``dev``; with ``spent``, host seconds per stage."""
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.core.incremental import TrainConfig, Trainer
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import simulator as S
    from repro_torch.uvm import trace as T
    from repro_torch.uvm.manager import OversubscriptionManager

    _, meta = load_ref(TRAIN_REF)
    trace = T.get_trace(meta["benchmark"], meta["scale"])
    table = R.load_pretrained(WEIGHTS, CONFIG, dev)
    stages = {"observe": (OversubscriptionManager, "observe"), "run_segment": (S, "run_segment"),
              "train_group": (Trainer, "train_group")}
    originals = {k: getattr(o, a) for k, (o, a) in stages.items()}
    if spent is not None:
        for k, (o, a) in stages.items():
            setattr(o, a, timed(spent, k, originals[k]))
    try:
        return R.run_ours(trace, CONFIG, TrainConfig(**meta["train"]), oversubscription=meta["oversubscription"],
                          table=table, device=dev)
    finally:
        for k, (o, a) in stages.items():
            setattr(o, a, originals[k])


def run_distances(res) -> dict:
    """How far the fine-tuned Hotspot run is from the reference's
    (``run_distance``), with its per-group accuracies."""
    ref, meta = load_ref(TRAIN_REF)
    return {**run_distance(res, {**meta["run"], "per_group_acc": ref["per_group_acc"].tolist()}),
            "per_group_acc": res.per_group_acc}


def fine_tuned_check(dev) -> dict:
    import torch

    from repro_torch import kernels

    spent = {"observe": 0.0, "run_segment": 0.0, "train_group": 0.0}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = fine_tuned_run(dev, spent)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    d = run_distances(res)
    print("  fine-tuned run: " + json.dumps({**{k: v for k, v in d.items() if k != "per_group_acc"},
                                              "wall_s": wall, "stage_s": spent, "launches": launches}))
    check(d["n_predictions_equal"] and d["occupancy_equal"], "prediction count or occupancy differ from the reference")
    check(d["top1_diff"] <= RUN_TOP1_ATOL, f"top-1 {res.top1} is {d['top1_diff']} from the reference's (> {RUN_TOP1_ATOL})")
    for k, r in d["stats_rtol"].items():
        check(r <= RUN_STATS_RTOL, f"{k} {res.stats[k]} differs from the reference's by rtol {r} > {RUN_STATS_RTOL}")
    check(d["first_groups_acc_diff"] <= RUN_GROUP_ACC_ATOL, f"the first {RUN_GROUPS_HELD} groups' accuracies differ "
          f"from the reference's by {d['first_groups_acc_diff']} > {RUN_GROUP_ACC_ATOL}")
    for name in ("evict_select", "freq_update", "flash_attention", "flash_attention_bwd", "thrash_ce_fwd",
                 "thrash_ce_bwd"):
        check(launches[name] > 0, f"the fine-tuned run never launched {name}")
    again = fine_tuned_run(dev)
    check(again.stats == res.stats and again.top1 == res.top1,
          f"a second fine-tuned run gave other results: {again.stats} {again.top1} (not deterministic)")
    print(f"  fine-tuned run: within the limits; a second run gave identical stats and top-1; wall {wall:.3f} s")
    return launches


def manager_replay(dev) -> dict:
    """The qwen2 reference's page-mass stream through the port's
    ``LearnedOffloadManager`` started from the JAX package's initial slots:
    its stats and each observed batch's prefetch blocks."""
    import dataclasses

    import numpy as np

    from repro_torch import convert
    from repro_torch.core.model_table import ModelTable
    from repro_torch.serving.offload import LearnedOffloadManager, _default_serving_manager

    ref, meta = load_ref(SERVE_MANAGER_REF)
    serve, _ = load_ref(SERVE_REF)
    init = {}
    for key, v in ref.items():
        if key.startswith("init/"):
            _, slot, name = key.split("/", 2)
            init.setdefault(int(slot[len("slot"):]), {})[name] = v
    table = ModelTable(lambda s: convert.params_from_jax(init[s], dev), n_slots=len(init))
    n_pages, cap = meta["n_pages"], meta["capacity"]
    m = LearnedOffloadManager(n_pages, cap, manager=_default_serving_manager(n_pages, cap, table=table, device=dev))
    prefetched = []
    observe = m._observe_batch

    def recording():
        observe()
        prefetched.append(np.asarray(m.last_actions.prefetch_blocks, np.int64))

    m._observe_batch = recording
    for mass, touched in zip(serve["page_mass"], serve["touched"]):
        m.on_attention(mass, np.nonzero(touched)[0])
    off = ref["prefetch_offsets"]
    want_pf = [ref["prefetch_blocks"][a:b] for a, b in zip(off[:-1], off[1:])]
    same_pf = len(prefetched) == len(want_pf) and all(np.array_equal(a, b) for a, b in zip(prefetched, want_pf))
    return {"stats": dataclasses.asdict(m.stats), "want": meta["stats"], "n_batches": len(prefetched),
            "want_batches": meta["n_batches"], "prefetch_blocks_equal": same_pf,
            "top1": m.manager.top1, "want_top1": meta["top1"],
            "per_group_acc_diff": max([abs(a - b) for a, b in zip(m.manager.per_group, ref["per_group_acc"])],
                                      default=0.0)}


def serve_manager_check(dev, eng, prompt) -> dict:
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serving.engine import Engine

    t0 = time.perf_counter()
    rep = manager_replay(dev)
    print(f"  manager replay ({time.perf_counter() - t0:.1f} s): " + json.dumps(rep))
    check(rep["n_batches"] == rep["want_batches"] and rep["stats"] == rep["want"] and rep["prefetch_blocks_equal"],
          f"the replayed manager's stats {rep['stats']} (or its prefetches) differ from the JAX manager's {rep['want']}")
    ref, run = load_ref(SERVE_REF)
    n_new, pad_to = run["n_new"], run["pad_to"]
    eng7 = Engine(eng.cfg, eng.params, offload="manager", hbm_fraction=run["hbm_fraction"], device=dev)
    spent = {"decode": 0.0, "offload": 0.0}
    originals = {"decode": eng7.decode, "offload": eng7._drive_offload}
    eng7.decode, eng7._drive_offload = (timed(spent, k, f) for k, f in originals.items())
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            res = eng7.generate({"tokens": prompt}, n_new, pad_to=pad_to)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        eng7.decode, eng7._drive_offload = originals.values()
    forks = fork_check(res.tokens, ref, SERVE_ATOL)
    out = {"decode_ms_per_step": spent["decode"] / n_new * 1e3, "offload_ms_per_step": spent["offload"] / n_new * 1e3,
           "wall_s": wall, "tokens_per_s": res.tokens.size / wall, "offload_stats": res.offload_stats,
           "forks": forks, "launches": launches}
    print("  manager free run: " + json.dumps(out))
    L = eng.cfg.num_layers
    check(launches["flash_attention_bf16"] == L and launches["decode_attention"] == L * n_new,
          f"the manager free run's attention launches differ from phase 5's: {launches}")
    for name in ("flash_attention", "flash_attention_bwd", "thrash_ce_fwd", "thrash_ce_bwd"):
        check(launches[name] > 0, f"the manager offload never launched {name}")
    check(sum(res.offload_stats.values()) > 0 and np.isfinite(out["decode_ms_per_step"]), "the manager offload idled")
    return launches


# --- phase 8: the paper's tables ---------------------------------------------------

TABLES_REF = ROOT / "experiments" / "torch" / "tables_paper_ref.json"
# (c): the fine-tuned ``ours`` on four of the nine benchmarks of at most
# 8,192 accesses (all but Hotspot and Srad-v2; three of these four open the
# prefetch gate, so the frequency table trains too; the runner's Table VI
# fine-tunes all 11), within phase 7 (b)'s limits; a counter whose reference
# is 0 must be 0.  Cut from nine to four to make room for phase 9.
TABLES_TUNED = ("ATAX", "Pathfinder", "StreamTriad", "AddVectors")


def _rel(got: int, want: int) -> float:
    return abs(got - want) / want if want else float(got != want)


def run_distance(res, want: dict) -> dict:
    """How far a fine-tuned ``run_ours`` is from the reference's, by phase 7
    (b)'s measures (``check_tuned`` reads them)."""
    return {"stats": res.stats, "top1": res.top1, "top1_diff": abs(res.top1 - want["top1"]),
            "stats_rtol": {k: _rel(res.stats[k], want["stats"][k]) for k in ("pages_thrashed", "faults",
                                                                            "migrated_blocks")},
            "n_predictions_equal": res.n_predictions == want["n_predictions"],
            "occupancy_equal": res.stats["occupancy"] == want["stats"]["occupancy"],
            "first_groups_acc_diff": max(abs(x - y) for x, y in zip(res.per_group_acc[:RUN_GROUPS_HELD],
                                                                    want["per_group_acc"][:RUN_GROUPS_HELD])),
            "equal": (res.stats, res.top1, res.per_group_acc) == (want["stats"], want["top1"], want["per_group_acc"])}


def protocol_distance(res, want: dict) -> dict:
    """How far a protocol run is from the reference's, by the same measures
    (phases 9 and 10)."""
    return {"top1": res.top1, "top1_diff": abs(res.top1 - want["top1"]),
            "n_predictions_equal": (res.n_samples, res.n_models, res.n_classes) == (want["n_samples"],
                                                                                   want["n_models"],
                                                                                   want["n_classes"]),
            "first_groups_acc_diff": max(abs(x - y) for x, y in zip(res.per_group[:RUN_GROUPS_HELD],
                                                                    want["per_group"][:RUN_GROUPS_HELD])),
            "equal": (res.top1, list(res.per_group)) == (want["top1"], want["per_group"])}


def tables_columns(dev, ctx, tuned) -> dict:
    """Phase 8's columns, each over its benchmarks with every launch count
    set to 0 just before and read just after: host seconds (up to a
    synchronise), compressed events walked, launches."""
    from repro_torch import kernels
    from repro_torch.bench import tables as TB
    from repro_torch.uvm import simulator as S

    walked = [0]
    scan = S._scan_events

    def counting(state, ev, *a):
        walked[0] += len(ev.blk)
        return scan(state, ev, *a)

    columns = {}

    def column(name, benches, fn):
        _sync(dev)
        kernels.reset_launches()
        walked[0] = 0
        t0 = time.perf_counter()
        for b in benches:
            fn(b)
        _sync(dev)
        columns[name] = {"host_s": time.perf_counter() - t0, "events": walked[0], "benchmarks": len(benches),
                         "launches": dict(kernels.LAUNCHES)}

    S._scan_events = counting
    try:
        for p, f in TB.STANDARD_CELLS:
            column(f"{p}+{f}", ctx.benches, lambda b, p=p, f=f: ctx.sim(b, p, f))
        column("uvmsmart", ctx.benches, ctx.uvmsmart)
        column("ours_frozen", ctx.benches, ctx.ours)
        column("ours_fine_tuned", tuned.benches, tuned.ours)
    finally:
        S._scan_events = scan
    return columns


def table_launch_checks(columns: dict) -> None:
    """Every column launched ``evict_select``; both ``ours`` columns the
    frequency table's update and the attention; the fine-tuned one the
    training kernels."""
    for name, col in columns.items():
        check(col["launches"]["evict_select"] > 0, f"the {name} column never launched evict_select")
    for name in ("ours_frozen", "ours_fine_tuned"):
        for k in ("freq_update", "flash_attention"):
            check(columns[name]["launches"][k] > 0, f"the {name} column never launched {k}")
    for k in ("thrash_ce_fwd", "thrash_ce_bwd", "flash_attention_bwd"):
        check(columns["ours_fine_tuned"]["launches"][k] > 0, f"the fine-tuned ours never launched {k}")


def tables_path(dev) -> dict:
    """Phase 8: the port's table runner at the paper preset and x1.25 over the
    11 benchmarks against the JAX package's cells and rows
    (``experiments/torch/tables_paper_ref.json``).  Returns the launches of
    all its columns together, and its frozen and fine-tuned contexts, whose
    memoised cells phase 10 reads."""
    from repro_torch.bench import tables as TB
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.uvm import simulator as S

    ref = json.loads(TABLES_REF.read_text())
    check((ref["preset"], ref["scale"], ref["cap"], ref["oversubscription"]) == ("paper", *TB.SCALE_PRESETS["paper"], 1.25),
          "the reference file is not the paper preset at x1.25")
    ctx = TB.Context("paper", frozen=True, fresh=FRESH, device=dev)
    tuned = ctx.with_train(TrainConfig(**ref["train"]["fine_tuned"]), benches=list(TABLES_TUNED))
    check(list(ref["benchmarks"]) == ctx.benches and dataclasses.asdict(ctx.tcfg) == ref["train"]["frozen"],
          "the reference's benchmarks or frozen schedule are not the runner's")
    columns = tables_columns(dev, ctx, tuned)
    print("  columns: " + json.dumps({k: {f: v[f] for f in ("host_s", "events", "benchmarks")}
                                       for k, v in columns.items()}))
    # (a) every simulator cell and UVMSmart, every counter
    bad = []
    for b in ctx.benches:
        want = ref["benchmarks"][b]
        bad += [(b, cell, st, want["sim"][cell]) for cell, st in ctx.sims(b).items() if st != want["sim"][cell]]
        if ctx.uvmsmart(b) != want["uvmsmart"]:
            bad.append((b, "uvmsmart", ctx.uvmsmart(b), want["uvmsmart"]))
    check(not bad, f"simulator or UVMSmart cells differ from the JAX package's: {bad}")
    # (b) the frozen ours: stats, top-1 and prediction count equal
    for b in ctx.benches:
        r, w = ctx.ours(b), ref["benchmarks"][b]["ours_frozen"]
        if (r.stats, r.top1, r.n_predictions) != (w["stats"], w["top1"], w["n_predictions"]):
            bad.append((b, r.stats, r.top1, r.n_predictions, w))
    check(not bad, f"the frozen ours differs from the JAX package's: {bad}")
    print(f"  (a) {len(ctx.benches)} x {len(TB.STANDARD_CELLS)} simulator cells and {len(ctx.benches)} UVMSmart "
          f"runs, (b) {len(ctx.benches)} frozen ours: equal to the JAX package's")
    for name in ("table1", "table2", "table3", "table4"):
        check(getattr(TB, name)(ctx) == ref["tables"][name], f"{name}'s rows differ from the JAX package's")
    check(TB.table6(ctx) == ref["tables"]["table6_frozen"], "Table VI's rows (frozen ours) differ from the JAX package's")
    # (c) the fine-tuned ours on the subset, within phase 7 (b)'s limits
    dist = {b: run_distance(tuned.ours(b), ref["benchmarks"][b]["ours_fine_tuned"]) for b in tuned.benches}
    print("  (c) fine-tuned ours: " + json.dumps(dist))
    for b, d in dist.items():
        check(d["n_predictions_equal"] and d["occupancy_equal"], f"{b}: prediction count or occupancy differ")
        check(d["top1_diff"] <= RUN_TOP1_ATOL, f"{b}: top-1 {d['top1']} is {d['top1_diff']} from the reference's")
        check(max(d["stats_rtol"].values()) <= RUN_STATS_RTOL, f"{b}: counters off by rtol {d['stats_rtol']}")
        check(d["first_groups_acc_diff"] <= RUN_GROUP_ACC_ATOL, f"{b}: the first groups' accuracies differ by "
              f"{d['first_groups_acc_diff']}")
    rows = TB.table6(tuned)
    want_red = [1 - ref["benchmarks"][b]["ours_fine_tuned"]["stats"]["pages_thrashed"] / r["baseline"]
                for b, r in zip(tuned.benches, rows[1:]) if r["baseline"] > 0]
    print(f"  (c) Table VI over {tuned.benches}, fine-tuned: average reduction {rows[0]['ours']} (the JAX package's "
          f"on the same rows {round(sum(want_red) / max(len(want_red), 1), 3)}); frozen over all 11: "
          f"{ref['tables']['table6_frozen'][0]['ours']}")
    # (d) launches per column, and where the device time of one tree cell goes
    print("  launches: " + json.dumps({k: {n: c for n, c in v["launches"].items() if c}
                                        for k, v in columns.items()}))
    table_launch_checks(columns)
    got = profile_run("Hotspot lru+tree", lambda: S.run_batch(ctx.trace("Hotspot"), [("lru", "tree", 1.25)],
                                                                device=dev))
    check(got == [ref["benchmarks"]["Hotspot"]["sim"]["lru+tree"]], "the profiled Hotspot lru+tree cell differs")
    launches = {k: sum(c["launches"][k] for c in columns.values()) for k in next(iter(columns.values()))["launches"]}
    return launches, ctx, tuned


# --- phase 9: concurrent workloads (Section V-F) -------------------------------------

CONCURRENT_REF = ROOT / "experiments" / "torch" / "concurrent_paper_ref.json"
# the JAX package's initial weights of the slots the reference's runs create
# (the port's own fresh slots draw from torch.Generator)
FRESH = ROOT / "experiments" / "torch" / "init_paper_slots.npz"
# (c) and (d): the fine-tuned runs and Table VII on the two short pairs
CONCURRENT_TUNED = ("StreamTriad+2DCONV", "NW+2DCONV")
# the runs of (c) and (d) that scripts/rehearse_concurrent_cpu.py gives equal
# to the JAX package's, to the last digit: held equal here, the others within
# phase 7 (b)'s limits
CONCURRENT_EQUAL = ("StreamTriad+2DCONV|mux", "NW+2DCONV|mux", "NW+2DCONV|merged", "NW+2DCONV|ours")
# the mux run whose two tenants both open the prefetch gate (the rehearsal
# updates each tenant's table: 1 and 3 times), so both tables must launch
# freq_update; in the frozen runs only Hotspot's gate opens
BOTH_TABLES_RUN = "StreamTriad+2DCONV|mux|tuned"


def merge_sha256(trace) -> str:
    """The SHA-256 of a trace's page, pc, tb and kernel arrays and, for a
    merge, its tenant tags (int32, in that order), as
    ``scripts/export_torch_reference.py`` hashes the JAX package's."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (trace.page, trace.pc, trace.tb, trace.kernel) + (() if trace.tenant is None else (trace.tenant,)):
        h.update(np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()


def run_fields(res) -> dict:
    """What the reference records of a ``run_ours`` and phase 9 holds exactly."""
    return {"stats": res.stats, "top1": res.top1, "n_predictions": res.n_predictions,
            "per_tenant_top1": res.per_tenant_top1, "per_tenant_stats": res.per_tenant_stats}


def tuned_distance(res, want: dict) -> dict:
    """How far a tenant-tagged fine-tuned ``run_ours`` is from the
    reference's run, by phase 7 (b)'s measures; equal counts each tenant's
    top-1 and stats too."""
    return {**run_distance(res, want), "equal": run_fields(res) == {k: want[k] for k in run_fields(res)}
            and res.per_group_acc == want["per_group_acc"]}


def check_tuned(name: str, d: dict, equal: tuple = CONCURRENT_EQUAL) -> None:
    """A fine-tuned run: equal where the rehearsal gave equal (``equal``),
    else within phase 7 (b)'s limits."""
    if name in equal:
        check(d["equal"], f"{name}: not equal to the JAX package's run, as the CPU rehearsal was: {d}")
        return
    check(within_limits(d), f"{name}: outside phase 7 (b)'s limits (counts equal, top-1 {RUN_TOP1_ATOL}, counters "
          f"rtol {RUN_STATS_RTOL}, the first groups' accuracies {RUN_GROUP_ACC_ATOL}): {d}")


def within_limits(d: dict) -> bool:
    """Phase 7 (b)'s limits on a run's distance from the reference's."""
    return (d["n_predictions_equal"] and d.get("occupancy_equal", True) and d["top1_diff"] <= RUN_TOP1_ATOL
            and max(d.get("stats_rtol", {"-": 0}).values()) <= RUN_STATS_RTOL
            and d["first_groups_acc_diff"] <= RUN_GROUP_ACC_ATOL)


def count_syncs(dev, run) -> tuple:
    """Run ``run`` once, counting the operations PyTorch's sync debug mode
    flags as synchronizing (``torch.cuda.set_sync_debug_mode``), in all and
    by the source line that called them (the ten most frequent); on the CPU
    there are none to count."""
    import collections
    import warnings

    import torch

    if dev.type != "cuda":
        return run(), None
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            res = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    hits = [w for w in seen if "synchronizing" in str(w.message)]
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in hits)
    return res, {"total": len(hits), "by_line": dict(where.most_common(10))}


def concurrent_launch_checks(columns: dict, tables: dict) -> None:
    """Every column launched the attention, the ``run_ours`` columns
    ``evict_select`` and ``freq_update``, the fine-tuned ones the training
    kernels; ``BOTH_TABLES_RUN``'s two tenant tables ``freq_update``."""
    for name, col in columns.items():
        for k in ("evict_select", "freq_update", "flash_attention") if name != "table7" else ("flash_attention",):
            check(col["launches"][k] > 0, f"the {name} column never launched {k}")
    for name in ("fine_tuned", "table7"):
        for k in ("flash_attention_bwd", "thrash_ce_fwd", "thrash_ce_bwd"):
            check(columns[name]["launches"][k] > 0, f"the {name} column never launched {k}")
    check(len(tables[BOTH_TABLES_RUN]) == 2 and min(tables[BOTH_TABLES_RUN]) > 0,
          f"a tenant's frequency table of {BOTH_TABLES_RUN} never launched freq_update: {tables[BOTH_TABLES_RUN]}")


def concurrent_path(dev) -> dict:
    """Phase 9: Tables VII and VIII's cells through the port's runner at the
    paper preset and x1.25 against the JAX package's
    (``experiments/torch/concurrent_paper_ref.json``).  Returns the launches
    of all its columns together."""
    from repro_torch import kernels
    from repro_torch.bench import tables as TB
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.core.policy import PredictionFrequencyTable
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import simulator as S

    ref = json.loads(CONCURRENT_REF.read_text())
    check((ref["preset"], ref["scale"], ref["cap"], ref["oversubscription"], ref["seed"])
          == ("paper", *TB.SCALE_PRESETS["paper"], 1.25, 0), "the reference file is not the paper preset at x1.25")
    check([tuple(p) for p in ref["pairs"]] == list(TB.CONCURRENT_PAIRS), "the reference's pairs are not the runner's")
    ctx = TB.Context("paper", frozen=True, fresh=FRESH, device=dev)
    tuned = ctx.with_train(TrainConfig(**ref["train"]["fine_tuned"]))
    check(dataclasses.asdict(ctx.tcfg) == ref["train"]["frozen"] and ctx.tcfg.group_size == ref["slice_len"],
          "the reference's frozen schedule is not the runner's")
    merges = {"+".join(p): ctx.concurrent(p, slice_len=ref["slice_len"]) for p in TB.CONCURRENT_PAIRS}
    # (a) the merges
    for key, w in merges.items():
        want = ref["pairs_ref"][key]
        check((len(w), merge_sha256(w)) == (want["n_accesses"], want["sha256"]),
              f"{key}: the merge differs from the JAX package's ({len(w)} accesses, want {want['n_accesses']})")
    print("  (a) " + json.dumps({k: {"accesses": len(w), "blocks": w.n_blocks, "capacity": S.capacity_for(
        w.n_blocks, 1.25)} for k, w in merges.items()}) + ": SHA-256 equal to the JAX package's")

    walked, made, per_table = [0], [], {}
    scan, mux_for, update = S._scan_events, R.mux_for, PredictionFrequencyTable.update

    def counting(state, ev, *a):
        walked[0] += len(ev.blk)
        return scan(state, ev, *a)

    def recording_mux_for(*a, **kw):
        made.append(mux_for(*a, **kw))
        return made[-1]

    def counting_update(self, blocks):
        before = kernels.LAUNCHES["freq_update"]
        update(self, blocks)
        per_table[id(self)] = per_table.get(id(self), 0) + kernels.LAUNCHES["freq_update"] - before

    columns, runs, muxes = {}, {}, {}

    def column(name, items):
        _sync(dev)
        kernels.reset_launches()
        t_col = time.perf_counter()
        for run_name, fn in items:
            walked[0] = 0
            n_made = len(made)
            t0 = time.perf_counter()
            runs[run_name] = fn()
            _sync(dev)
            runs[run_name + ":cost"] = {"host_s": time.perf_counter() - t0, "events": walked[0]}
            if len(made) > n_made:
                muxes[run_name] = made[-1]
        _sync(dev)
        columns[name] = {"host_s": time.perf_counter() - t_col, "runs": len(items),
                         "launches": dict(kernels.LAUNCHES)}

    S._scan_events, R.mux_for, PredictionFrequencyTable.update = counting, recording_mux_for, counting_update
    try:
        column("frozen", [(f"{k}|{t}", lambda w=w, t=t: ctx.ours(w, tenancy=t))
                          for k, w in merges.items() for t in ("mux", "merged")])
        column("fine_tuned", [(f"{k}|{t}|tuned", lambda w=merges[k], t=t: tuned.ours(w, tenancy=t))
                              for k in CONCURRENT_TUNED for t in ("mux", "merged")])
        column("table7", [(f"{k}|{m}", lambda w=merges[k], m=m: tuned.protocol(
            w, m, table=tuned.pretrained("table7") if m == "ours" else None))
            for k in CONCURRENT_TUNED for m in ("online_single", "ours")])
    finally:
        S._scan_events, R.mux_for, PredictionFrequencyTable.update = scan, mux_for, update
    cost = {k[:-5]: v for k, v in runs.items() if k.endswith(":cost")}
    print("  runs: " + json.dumps({k: {**v, "ms_per_event": 1e3 * v["host_s"] / max(v["events"], 1)}
                                   for k, v in cost.items()}))
    # (b) the frozen Table VIII, every run and row exact
    bad = []
    for key in merges:
        for t in ("mux", "merged"):
            got, want = run_fields(runs[f"{key}|{t}"]), ref["pairs_ref"][key]["runs"][f"{t}_frozen"]
            if got != {k: want[k] for k in got}:
                bad.append((key, t, got, {k: want[k] for k in got}))
    check(not bad, f"the frozen runs differ from the JAX package's: {bad}")
    check(TB.table8(ctx) == ref["tables"]["table8_frozen"], "Table VIII's rows (frozen) differ from the JAX package's")
    print(f"  (b) {len(merges)} pairs x mux and merged, frozen: stats, top-1, prediction count, each tenant's top-1 "
          f"and stats, and Table VIII's rows equal to the JAX package's")
    # (c) the fine-tuned runs on the short pairs; (d) Table VII's protocols on them
    dist = {}
    for key in CONCURRENT_TUNED:
        for t in ("mux", "merged"):
            dist[f"{key}|{t}"] = tuned_distance(runs[f"{key}|{t}|tuned"], ref["pairs_ref"][key]["runs"][f"{t}_fine_tuned"])
        for m in ("online_single", "ours"):
            dist[f"{key}|{m}"] = protocol_distance(runs[f"{key}|{m}"], ref["pairs_ref"][key]["runs"][f"table7_{m}"])
    print("  (c), (d) " + json.dumps(dist))
    for name, d in dist.items():
        check_tuned(name, d)
    print(f"  (c), (d): {sum(d['equal'] for d in dist.values())} of {len(dist)} runs equal to the JAX package's "
          f"(held equal: {list(CONCURRENT_EQUAL)}), the rest within phase 7 (b)'s limits")
    # (e) launches per column; freq_update per tenant table of every mux run
    print("  launches: " + json.dumps({k: {n: c for n, c in v["launches"].items() if c} for k, v in columns.items()}))
    tables = {k: [per_table.get(id(m.freq_table), 0) for m in mux.managers.values()] for k, mux in muxes.items()}
    print(f"  freq_update launches per tenant table of each mux run: {json.dumps(tables)}")
    concurrent_launch_checks(columns, tables)
    # where the time goes: one frozen mux run profiled, one counted for host syncs
    w = merges["NW+2DCONV"]
    again = profile_run("NW+2DCONV mux, frozen", lambda: R.run_ours(
        w, ctx.pcfg, ctx.tcfg, oversubscription=1.25, table=ctx.pretrained(), device=dev))
    check(run_fields(again) == run_fields(runs["NW+2DCONV|mux"]), "the profiled frozen mux run gave other results")
    w = merges["StreamTriad+2DCONV"]
    again, syncs = count_syncs(dev, lambda: R.run_ours(w, ctx.pcfg, ctx.tcfg, oversubscription=1.25,
                                                       table=ctx.pretrained(), device=dev))
    check(run_fields(again) == run_fields(runs["StreamTriad+2DCONV|mux"]), "a second frozen mux run gave other results")
    groups = -(-len(w) // ctx.tcfg.group_size)
    print(f"  synchronizing operations of the frozen StreamTriad+2DCONV mux run ({groups} groups): {json.dumps(syncs)}")
    return {k: sum(c["launches"][k] for c in columns.values()) for k in next(iter(columns.values()))["launches"]}


# --- phase 10: the paper's figures ------------------------------------------------------

FIGURES_REF = ROOT / "experiments" / "torch" / "figures_paper_ref.json"
# (a), (b): Fig. 3's lru + tree at x1.0, x1.1 and x1.5 and UVMSmart at x1.5
# on these (the short benchmarks of FEATURED; x1.25 and UVMSmart at x1.25:
# phase 8's cells of all 11), chosen by scripts/rehearse_figures_cpu.py's
# events per cell
FIG3_BENCH = ("ATAX", "BICG", "NW")
FIG3_OVERSUBS = (1.0, 1.1, 1.5)
# (c), (d): the fine-tuned ours at x1.5 (Fig. 14) and without the
# thrashing term (Fig. 12), Fig. 4's offline and online_single and Fig. 11's
# chain up to its link, all on this benchmark (FEATURED's first, so the
# chain's first link, and its shortest but one)
FIG_TUNED = "ATAX"
# the IPC of an integer cell: the same float64 operations as the JAX
# package's timing.ipc on equal counters
IPC_RTOL = 1e-12


def figures_path(dev, ctx, tuned) -> dict:
    """Phase 10: a subset of the paper's Figs. 3, 4, 11, 12, 13 and 14
    through the port's figure runner (``repro_torch.bench.figures``) at the
    paper preset against the JAX package's cells and rows
    (``experiments/torch/figures_paper_ref.json``), reading phase 8's
    memoised cells (``ctx`` frozen, ``tuned`` fine-tuned).  Returns the
    launches of all its columns together."""
    from repro_torch import kernels
    from repro_torch.bench import figures as FG
    from repro_torch.bench import tables as TB
    from repro_torch.uvm import simulator as S
    from repro_torch.uvm.manager import OversubscriptionManager

    ref = json.loads(FIGURES_REF.read_text())
    check((ref["preset"], ref["scale"], ref["cap"]) == ("paper", *TB.SCALE_PRESETS["paper"])
          and ref["featured"] == TB.FEATURED and ref["benchmarks"] == ctx.benches
          and ref["train"] == dataclasses.asdict(tuned.tcfg), "the reference file is not the runner's paper preset")
    cells = ref["cells"]
    walked, gates = [0], [0]
    scan, observe = S._scan_events, OversubscriptionManager.observe

    def counting(state, ev, *a):
        walked[0] += len(ev.blk)
        return scan(state, ev, *a)

    def gate_counting(self, batch):
        a = observe(self, batch)
        gates[0] += a.counters is not None
        return a

    columns, got = {}, {}

    def column(name, items):
        _sync(dev)
        kernels.reset_launches()
        walked[0] = gates[0] = 0
        t0 = time.perf_counter()
        for key, fn in items:
            got[key] = fn()
        _sync(dev)
        columns[name] = {"host_s": time.perf_counter() - t0, "events": walked[0], "gates_open": gates[0],
                         "runs": len(items), "launches": dict(kernels.LAUNCHES)}

    S._scan_events, OversubscriptionManager.observe = counting, gate_counting
    try:
        column("fig3 lru+tree", [(f"sim|{b}|lru+tree|{os_}", lambda b=b, os_=os_: ctx.sim(b, "lru", "tree", os_))
                                 for os_ in FIG3_OVERSUBS for b in FIG3_BENCH])
        column("uvmsmart x1.5", [(f"uvmsmart|{b}|1.5", lambda b=b: ctx.uvmsmart(b, 1.5)) for b in FIG3_BENCH])
        column("ours x1.5", [(f"ours|{FIG_TUNED}|1.5|thrash=True", lambda: tuned.ours(FIG_TUNED, 1.5))])
        column("ours, no thrashing term", [(f"ours|{FIG_TUNED}|1.25|thrash=False",
                                            lambda: tuned.ours(FIG_TUNED, use_thrash_term=False))])
        link = TB.FEATURED.index(FIG_TUNED)  # Fig. 11's chain up to FIG_TUNED's link
        column("protocols", [
            (f"protocol|{FIG_TUNED}|offline", lambda: tuned.protocol(FIG_TUNED, "offline")),
            (f"protocol|{FIG_TUNED}|online_single", lambda: tuned.protocol(FIG_TUNED, "online_single")),
            (f"protocol|{FIG_TUNED}|ours|chain_seed0=123|link{link}",
             lambda: tuned.protocol_chain(TB.FEATURED[:link + 1], "ours", table=tuned.pretrained("fig11"))[-1])])
    finally:
        S._scan_events, OversubscriptionManager.observe = scan, observe
    print("  columns: " + json.dumps({k: {f: v[f] for f in ("host_s", "events", "gates_open", "runs")}
                                       for k, v in columns.items()}))
    # (a) Fig. 3's cells and rows on the subset
    bad = [(k, got[k], cells[k]["stats"]) for k in got if k.startswith(("sim|", "uvmsmart|"))
           and got[k] != cells[k]["stats"]]
    check(not bad, f"Fig. 3's or UVMSmart's cells differ from the JAX package's: {bad}")
    rows = FG.fig3(ctx.with_train(ctx.tcfg, benches=list(FIG3_BENCH)))
    want_rows = {r["benchmark"]: r for r in ref["figures_rows"]["fig3"]}
    check(rows == [want_rows[b] for b in FIG3_BENCH], f"Fig. 3's rows differ from the JAX package's: {rows}")
    # (b) the IPC of every integer cell Figs. 3, 13 and 14 read from phases 8 and 10
    ipcs = {f"sim|{b}|lru+tree|1.25": ctx.sim(b, "lru", "tree") for b in ctx.benches}
    ipcs.update({f"uvmsmart|{b}|1.25": ctx.uvmsmart(b) for b in TB.FEATURED})
    ipcs.update({k: v for k, v in got.items() if k.startswith(("sim|", "uvmsmart|"))})
    worst = 0.0
    for k, st in ipcs.items():
        check(st == cells[k]["stats"], f"{k}: the counters differ from the JAX package's")
        want = cells[k]["ipc"]
        worst = max(worst, abs(ctx.ipc(k.split("|")[1], st) - want) / want)
    check(worst <= IPC_RTOL, f"an IPC differs from the JAX package's by rtol {worst} > {IPC_RTOL}")
    print(f"  (a), (b) Fig. 3's lru+tree at x{', x'.join(map(str, FIG3_OVERSUBS))} and UVMSmart at x1.5 on "
          f"{len(FIG3_BENCH)} benchmarks: counters and rows equal; {len(ipcs)} integer cells' IPC within rtol "
          f"{worst:.3g} of the JAX package's float64 ({IPC_RTOL})")
    # (c) the fine-tuned ours at x1.5 and without the thrashing term; (d) the protocols
    dist = {k: run_distance(got[k], cells[k]) for k in got if k.startswith("ours|")}
    dist.update({k: protocol_distance(got[k], cells[k]) for k in got if k.startswith("protocol|")})
    print("  (c), (d) " + json.dumps(dist))
    for k, d in dist.items():
        check_tuned(k, d)
    for k in dist:
        if k.startswith("ours|") and got[k].stats == cells[k]["stats"]:
            for us, want in cells[k]["ipc"].items():
                check(abs(got[k].ipc(pred_overhead_us=float(us)) - want) <= IPC_RTOL * want,
                      f"{k}: the IPC at {us} us differs from the JAX package's on equal counters")
    print(f"  (c), (d): {sum(d['equal'] for d in dist.values())} of {len(dist)} runs equal to the JAX package's, "
          f"the rest within phase 7 (b)'s limits")
    # (e) launches per column
    print("  launches: " + json.dumps({k: {n: c for n, c in v["launches"].items() if c} for k, v in columns.items()}))
    figure_launch_checks(columns)
    return {k: sum(c["launches"][k] for c in columns.values()) for k in next(iter(columns.values()))["launches"]}


def figure_launch_checks(columns: dict) -> None:
    """Every simulator column launched ``evict_select``, every column that
    trains the attention forward and backward and both ``thrash_ce``
    kernels, every column whose prefetch gate opened ``freq_update``."""
    training = ("flash_attention", "flash_attention_bwd", "thrash_ce_fwd", "thrash_ce_bwd")
    for name, col in columns.items():
        need = {"fig3 lru+tree": ("evict_select",), "uvmsmart x1.5": ("evict_select",),
                "protocols": training}.get(name, ("evict_select",) + training)
        if col["gates_open"]:
            need += ("freq_update",)
        for k in need:
            check(col["launches"][k] > 0, f"the {name} column never launched {k}")


# --- phase 11: the predictor zoo, drift, QoS budgets and the random policy ---------------

TABLES_QUICK_REF = ROOT / "experiments" / "torch" / "tables_quick_ref.json"
# (a): the JAX package's draws at CONFIG, by tests/test_torch_random.py's
# limits (on this host's CPU 7-9 of 632,066 elements differ, by at most
# 3 ulp; the draws are made on the host, so the card's are the same)
WEIGHT_ULP, WEIGHT_SHARE = 3, 5e-5
# (b): Fig. 10's kinds on its shortest benchmark at the paper preset
FIG10_BENCH = "ATAX"
# (b)-(d): the runs scripts/rehearse_zoo_qos_cpu.py gives equal to the JAX
# package's, held equal on the card; the others (the mlp kind, 0.0003 off
# in top-1 on the CPU) within phase 7 (b)'s limits
ZOO_EQUAL = ("protocol|ATAX|online_single", "protocol|ATAX|online_single|kind=lstm",
             "protocol|ATAX|online_single|kind=cnn", "table9|frozen", "table9|reclass256", "table10|solo",
             "table10|shared", "table10|budgeted")


def _ulp_diff(got, want) -> tuple[int, int, int]:
    """(elements, differing elements, largest ulp) of two float32 arrays."""
    import numpy as np

    a = np.ascontiguousarray(got, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(want, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    d = np.abs(a - b)
    return d.size, int(np.count_nonzero(d)), int(d.max(initial=0))


def state_sha256(state) -> str:
    """The SHA-256 of a simulator state's resident, evicted-once and
    last-access arrays, as the export hashes the JAX package's."""
    import hashlib

    h = hashlib.sha256()
    for a in (state.resident, state.evicted_once, state.last_access):
        h.update(a.cpu().numpy().tobytes())
    return h.hexdigest()


def zoo_qos_path(dev) -> dict:
    """Phase 11: (a) the JAX package's initial weights drawn by the port;
    (b) Fig. 10's four predictor kinds on ``FIG10_BENCH`` at the paper
    preset (``figures_paper_ref.json``); (c) Table IX's first drift trace:
    the frozen-pattern and the 256-fault re-classifying managers and
    ``hpe`` + ``tree``; (d) Table X's StreamTriad + RandomScan at x2.5:
    solo, shared pool and budgeted mux (``evict_select`` on four keys);
    (e) the ``random`` policy on ATAX and Hotspot.  (c)-(e) against
    ``tables_quick_ref.json``.  Returns the launches of all its columns."""
    import numpy as np

    from repro_torch import convert, kernels
    from repro_torch.bench import figures as FG
    from repro_torch.bench import tables as TB
    from repro_torch.configs.predictor_paper import CONFIG, CONFIG_QUICK
    from repro_torch.core import predictor
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.kernels import evict_select as ES
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import simulator as S
    from repro_torch.uvm import trace as T

    figs, quick = json.loads(FIGURES_REF.read_text()), json.loads(TABLES_QUICK_REF.read_text())
    check((quick["preset"], quick["scale"], quick["cap"]) == ("quick", *TB.SCALE_PRESETS["quick"]),
          "tables_quick_ref.json is not the quick preset")
    # (a) the initial weights, drawn on the host and moved to the card
    t0 = time.perf_counter()
    for s, want in convert.fresh_slots(FRESH).items():
        got = predictor.init(s, CONFIG, dev)
        n = n_diff = worst = 0
        for k, v in want.items():
            a, b, c = _ulp_diff(got[k].cpu().numpy(), v)
            n, n_diff, worst = n + a, n_diff + b, max(worst, c)
        print(f"  (a) slot {s}: {n_diff} of {n} elements differ from the JAX package's, by at most {worst} ulp")
        check(worst <= WEIGHT_ULP and n_diff <= WEIGHT_SHARE * n, f"slot {s}'s initial weights are off: {n_diff} "
              f"elements, {worst} ulp (limits {WEIGHT_SHARE} of them, {WEIGHT_ULP} ulp)")
    print(f"      in {time.perf_counter() - t0:.1f} s")
    columns, got, n_keys = {}, {}, []

    def column(name, items):
        _sync(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        for key, fn in items:
            got[key] = fn()
        _sync(dev)
        columns[name] = {"host_s": time.perf_counter() - t0, "runs": len(items), "launches": dict(kernels.LAUNCHES)}

    ctx = TB.Context("paper", fresh=FRESH, device=dev)
    qctx = TB.Context("quick", device=dev)
    tcfg = TrainConfig(256, 2, 128)
    w9, os9 = TB.TABLE9_SUITE[0]
    ref9 = quick["tables_rows"]["table9"]["traces"][0]
    check(ref9["oversub"] == os9 and ref9["sha256"] == merge_sha256(qctx.trace(w9)),
          "Table IX's first drift trace differs from the JAX package's")

    def learned(**kw):
        tr = qctx.trace(w9)
        mgr = R.manager_for(tr, CONFIG_QUICK, tcfg, oversubscription=os9,
                            table=qctx.pretrain(CONFIG_QUICK, tcfg, scale=0.24), device=dev, **kw)
        res = R.run_ours(tr, CONFIG_QUICK, tcfg, oversubscription=os9, manager=mgr)
        return res, mgr.n_pattern_switches

    ref10 = quick["tables_rows"]["table10"]["scenarios"][0]
    solo_tr, merged = TB.table10_traces(ref10["good"])
    check((ref10["solo_sha256"], ref10["merged_sha256"]) == (merge_sha256(solo_tr),
                                                             merge_sha256(merged)),
          "Table X's traces differ from the JAX package's")
    run10 = lambda tr, **kw: R.run_ours(tr, CONFIG_QUICK, tcfg, oversubscription=ref10["oversub"], device=dev, **kw)
    select = S.evict_select

    def counting(cand, keys, n_evict):
        n_keys.append(len(keys))
        return select(cand, keys, n_evict)

    def random_run(r):
        tr = T.get_trace(r["benchmark"], 1.0)
        tr = tr.slice(0, min(len(tr), r["n_accesses"]))
        return S.run(tr, policy="random", prefetch=r["prefetch"], oversubscription=r["oversub"], seed=r["seed"],
                     device=dev)

    column("fig10 " + FIG10_BENCH, [(k, lambda k=k: ctx.protocol(FIG10_BENCH, "online_single", kind=k))
                                    for k in FG.FIG10_KINDS])
    column("table9 drift", [("frozen", lambda: learned(reclass_interval=1 << 30)),
                            ("reclass256", lambda: learned(reclass_interval=256, reclass_hysteresis=2)),
                            ("rule", lambda: qctx.sim(w9, "hpe", "tree", os9))])
    S.evict_select = counting
    try:
        column("table10 " + ref10["good"], [("solo", lambda: run10(solo_tr)), ("shared", lambda: run10(merged)),
                                            ("budgeted", lambda: run10(merged, qos=TB.table10_qos(ref10["good"])))])
    finally:
        S.evict_select = select
    runs = quick["tables_rows"]["random_policy"]
    column("random", [(f"random|{i}", lambda r=r: random_run(r)) for i, r in enumerate(runs)])
    print("  columns: " + json.dumps({k: {f: v[f] for f in ("host_s", "runs")} for k, v in columns.items()}))
    dist = {}
    # (b) Fig. 10's kinds: each a protocol run from fresh weights
    for kind in FG.FIG10_KINDS:
        key = f"protocol|{FIG10_BENCH}|online_single" + ("" if kind == "transformer" else f"|kind={kind}")
        dist[key] = protocol_distance(got[kind], figs["cells"][key])
    row = {"benchmark": FIG10_BENCH, **{k: round(got[k].top1, 3) for k in FG.FIG10_KINDS}}
    want_row = next(r for r in figs["figures_rows"]["fig10"] if r["benchmark"] == FIG10_BENCH)
    print(f"  (b) Fig. 10's row on {FIG10_BENCH}: {json.dumps(row)}; the JAX package's {json.dumps(want_row)}")
    # (c) Table IX: the rule column exact, the learned runs by the rehearsal's limits, the reference's asserts
    (froz, _), (r256, switches), rule = got["frozen"], got["reclass256"], got["rule"]
    check(rule == ref9["rule"], f"Table IX's hpe + tree counters differ: {rule} against {ref9['rule']}")
    check(switches >= 2, f"the 256-fault re-classifier switched {switches} times (< 2)")
    check(r256.stats["pages_thrashed"] < rule["pages_thrashed"], "the re-classifier thrashes no less than hpe + tree")
    dist["table9|frozen"] = run_distance(froz, ref9["frozen"])
    dist["table9|reclass256"] = run_distance(r256, ref9["reclass256"])
    print(f"  (c) {ref9['name']} x{os9}: switches {switches} (JAX {ref9['switches']}), pages thrashed frozen "
          f"{froz.stats['pages_thrashed']}, reclass-256 {r256.stats['pages_thrashed']}, hpe + tree "
          f"{rule['pages_thrashed']} (equal)")
    # (d) Table X: the fairness claim, the budgets, the per-tenant counters
    solo, shared, budgeted = got["solo"], got["shared"], got["budgeted"]
    g = lambda res: res.per_tenant_stats["0"]["pages_thrashed"]
    check(g(budgeted) <= solo.stats["pages_thrashed"] and g(budgeted) <= g(shared),
          f"budgets did not keep {ref10['good']} whole: budgeted {g(budgeted)}, solo "
          f"{solo.stats['pages_thrashed']}, shared {g(shared)}")
    check(budgeted.budgets == ref10["budgeted"]["budgets"], f"the budgets {budgeted.budgets} differ from the JAX "
          f"package's {ref10['budgeted']['budgets']}")
    check(4 in n_keys, "the budgeted run never selected victims on four keys")
    dist["table10|solo"] = run_distance(solo, ref10["solo"])
    for name in ("shared", "budgeted"):
        dist[f"table10|{name}"] = tuned_distance(got[name], ref10[name])
    print(f"  (d) {ref10['good']}+RandomScan x{ref10['oversub']}: {ref10['good']} thrashes solo "
          f"{solo.stats['pages_thrashed']}, shared {g(shared)}, budgeted {g(budgeted)}; budgets {budgeted.budgets}; "
          f"evict_select calls by key count {json.dumps({n: n_keys.count(n) for n in sorted(set(n_keys))})}")
    print("  (b)-(d) " + json.dumps(dist))
    for k, d in dist.items():
        check_tuned(k, d, ZOO_EQUAL)
    print(f"  (b)-(d): {sum(d['equal'] for d in dist.values())} of {len(dist)} runs equal to the JAX package's, "
          f"the rest within phase 7 (b)'s limits")
    # (e) the random policy: every counter and the final state
    for i, r in enumerate(runs):
        res = got[f"random|{i}"]
        check(res.stats == r["stats"] and state_sha256(res.state) == r["state_sha256"],
              f"the random policy on {r['benchmark']} {r['prefetch']} x{r['oversub']} differs: {res.stats} against "
              f"{r['stats']}")
    print(f"  (e) the random policy: {len(runs)} runs on ATAX and Hotspot, counters and final state equal")
    print("  launches: " + json.dumps({k: {n: c for n, c in v["launches"].items() if c} for k, v in columns.items()}))
    zoo_launch_checks(columns)
    return {k: sum(c["launches"][k] for c in columns.values()) for k in next(iter(columns.values()))["launches"]}


def zoo_launch_checks(columns: dict) -> None:
    """Every column that trains launched both ``thrash_ce`` kernels, the
    transformer's the attention forward and backward, every simulator
    column ``evict_select``."""
    training = ("thrash_ce_fwd", "thrash_ce_bwd")
    need = {"fig10 " + FIG10_BENCH: training + ("flash_attention", "flash_attention_bwd"),
            "table9 drift": training + ("flash_attention", "flash_attention_bwd", "evict_select"),
            "random": ("evict_select",)}
    for name, col in columns.items():
        for k in need.get(name, training + ("flash_attention", "flash_attention_bwd", "evict_select")):
            check(col["launches"][k] > 0, f"the {name} column never launched {k}")


# --- phase 12: the fault-tolerant manager ------------------------------------------------

FT_REF = ROOT / "experiments" / "torch" / "fault_tolerance_ref.json"
# the runs scripts/rehearse_fault_tolerance_cpu.py gives equal to the JAX
# package's, held equal on the card; the others within phase 7 (b)'s limits
# ((c)'s and (d)'s chaos counts, counters and health sequences are always
# held equal; the snapshot runs are always held equal to their uninterrupted
# twins)
FT_EQUAL = ("atax_tuned", "chaos", "health_on", "mux_chaos", "offload")
# (a) snapshots Hotspot after its second group (as the reference's test does
# on ATAX), (b) ATAX, which has two groups at the paper preset, after its first
FT_SNAP_AFTER = {"hotspot": 1, "atax_tuned": 0, "mux": 1}


def drive_ours(make, trace, snap_after: int | None = None, store=None, restore_into=None) -> tuple:
    """``run_ours``'s loop by hand over ``make()``'s manager or mux, as the
    reference's ``test_golden_pinned_snapshot_restore_real_predictor``
    drives it; after group ``snap_after`` the manager's ``state()`` is saved
    in ``store`` (a ``SnapshotStore``), read back (hash checked) and
    restored into ``restore_into()``, a fresh one, which finishes the run.
    Returns the result and the seconds the snapshot took (state, save,
    read, restore)."""
    import numpy as np

    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import simulator as S
    from repro_torch.uvm.manager import Outcomes, TenantMux

    mgr = make()
    nb, cap = mgr.cfg.n_blocks, mgr.cfg.capacity
    state = S.init_state(nb, mgr.device)
    blocks, nxt = trace.block.astype(np.int32), S.next_use_for(trace)
    ledger = R._TenantLedger(trace, mgr) if trace.tenant is not None else None
    G, snap_s = mgr.cfg.train.group_size, None
    for i, g0 in enumerate(range(0, len(trace), G)):
        g1 = min(g0 + G, len(trace))
        actions = mgr.observe(R._group_batch(trace, g0, g1))
        ep = mgr.evict_pref(state.resident) if isinstance(mgr, TenantMux) else None
        state = R._apply_actions(state, actions, nb, cap, evict_pref=ep)
        state, outs = S.run_segment(state, blocks[g0:g1], nxt[g0:g1], capacity=cap, policy="learned",
                                    prefetch="demand", n_valid=trace.n_blocks, evict_pref=ep)
        mgr.feedback(Outcomes(was_evicted=outs["was_evicted"], fault_count=int(state.fault_count)))
        if ledger is not None:
            ledger.account(g0, g1, outs)
        if i == snap_after:
            t0 = time.perf_counter()
            store.save(i + 1, mgr.state(), extra={"group": i})
            step, snap, extra = store.restore()
            check((step, extra) == (i + 1, {"group": i}), "the snapshot store returned another snapshot")
            mgr = restore_into()
            mgr.restore(snap)
            snap_s = time.perf_counter() - t0
    return R._result(mgr, state, len(trace), None if ledger is None else ledger.result()), snap_s


def ft_fields(res) -> dict:
    """What phase 12 holds of a ``run_ours`` (the reference's record)."""
    out = {"stats": res.stats, "top1": res.top1, "warm_top1": res.warm_top1, "n_predictions": res.n_predictions,
           "per_group_acc": res.per_group_acc}
    if res.per_tenant_top1 is not None:
        out.update(per_tenant_top1=res.per_tenant_top1, per_tenant_stats=res.per_tenant_stats)
    return out


def chaos_run(mgr, trace, schedule: dict, oversub: float, tcfg) -> dict:
    """One ``run_ours`` through ``mgr`` (health on) with a ``FaultInjector``
    of ``schedule`` wrapping its trainer (and a manager's frequency table):
    the result, the injector's counts, the health counters and every
    round's ``(health, fallback)`` (a mux's per tenant), as the export
    records the JAX package's."""
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm.manager import ChaosSchedule, FaultInjector, TenantMux

    inj = FaultInjector(ChaosSchedule(**schedule))
    mgr.trainer = inj.wrap_trainer(mgr.trainer)
    if not isinstance(mgr, TenantMux):
        mgr.freq_table = inj.wrap_freq_table(mgr.freq_table)
    seq, observe = [], mgr.observe

    def recording(batch):
        a = observe(batch)
        seq.append({str(k): [t.health, t.fallback] for k, t in a.per_tenant.items()}
                   if isinstance(mgr, TenantMux) else [a.health, a.fallback])
        return a

    mgr.observe = recording
    res = R.run_ours(trace, CONFIG, tcfg, oversubscription=oversub, manager=mgr)
    return {"counts": dict(inj.counts), "n_health_faults": mgr.n_health_faults, "n_fallbacks": mgr.n_fallbacks,
            "n_recoveries": mgr.n_recoveries, "sequence": seq, "run": res}


def fault_tolerance_path(dev) -> dict:
    """Phase 12: the fault-tolerant manager against
    ``experiments/torch/fault_tolerance_ref.json``: (a) a snapshot of the
    frozen Hotspot x1.5 manager at ``CONFIG`` through ``SnapshotStore``,
    restored into a fresh ``manager_for``, equal to the JAX package's run;
    (b) the same for the fine-tuned ATAX run, equal to the port's own
    uninterrupted run; (c) the health machine under a seeded chaos
    schedule, and with health on and no chaos; (d) the mux on
    StreamTriad+2DCONV: snapshots with isolated and shared tables equal to
    the JAX package's runs, and a chaos run on ``evaluate_many``; (e) the KV
    offload's checkpoint and resume; (f) registered policies and a
    registered prefetcher through ``run_batch``, and Hotspot's fault log,
    in a temporary directory that is removed after.  Returns the launches
    of all its columns."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ft_"))
    try:
        return _fault_tolerance(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fault_tolerance(dev, tmp: Path) -> dict:
    import hashlib

    import numpy as np

    from repro_torch import convert, kernels
    from repro_torch.bench import tables as TB
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.serving.offload import LearnedOffloadManager
    from repro_torch.uvm import registry as REG
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import simulator as S
    from repro_torch.uvm import trace as T
    from repro_torch.uvm.manager import HealthConfig, SnapshotStore
    from repro_torch.uvm.manager import core as MC

    ref = json.loads(FT_REF.read_text())
    frozen, tuned = TrainConfig(**ref["train"]["frozen"]), TrainConfig(**ref["train"]["fine_tuned"])
    check(dataclasses.asdict(HealthConfig()) == ref["health"], "HealthConfig's defaults are not the reference's")
    hot = T.get_trace("Hotspot", ref["scale"])
    ctx = TB.Context("paper", fresh=FRESH, device=dev)
    atax = ctx.trace("ATAX")
    check(len(atax) == ref["atax_tuned"]["n_accesses"], "ATAX's paper-preset trace is not the reference's")
    empty = lambda fresh=None: convert.fresh_table(CONFIG, dev, 8, fresh)
    hot_mgr = lambda table, **kw: R.manager_for(hot, CONFIG, frozen, oversubscription=ref["hotspot_oversub"],
                                                table=table, device=dev, **kw)
    walked, finite = [0], [0, 0.0]
    scan, tree_finite = S._scan_events, MC._tree_finite

    def counting(state, ev, *a):
        walked[0] += len(ev.blk)
        return scan(state, ev, *a)

    def timed_finite(tree):
        t0 = time.perf_counter()
        try:
            return tree_finite(tree)
        finally:
            finite[0] += 1
            finite[1] += time.perf_counter() - t0

    columns, runs = {}, {}

    def column(name, items):
        _sync(dev)
        kernels.reset_launches()
        t_col = time.perf_counter()
        for key, fn in items:
            walked[0] = 0
            t0 = time.perf_counter()
            runs[key] = fn()
            _sync(dev)
            runs[key + ":cost"] = {"host_s": time.perf_counter() - t0, "events": walked[0]}
        _sync(dev)
        columns[name] = {"host_s": time.perf_counter() - t_col, "runs": len(items), "launches": dict(kernels.LAUNCHES)}

    def store(name):
        return SnapshotStore(tmp / name, keep=1)

    pair = ctx.with_train(frozen).concurrent(tuple(ref["pair"]), slice_len=frozen.group_size)
    check(merge_sha256(pair) == ref["mux"]["sha256"], "the StreamTriad+2DCONV merge differs from the JAX package's")
    mux = lambda shared, table, **kw: R.mux_for(pair, CONFIG, frozen, oversubscription=ref["pair_oversub"],
                                                table=table, shared_freq_table=shared, device=dev, **kw)
    atax_mgr = lambda table: R.manager_for(atax, CONFIG, tuned, oversubscription=ref["atax_oversub"], table=table,
                                           device=dev)

    def offload_runs():
        def drive(m, steps, rng):
            for _ in range(steps):
                touched = rng.integers(0, 64, 16)
                mass = np.zeros(64)
                mass[touched] = 1.0
                m.on_attention(mass, touched)

        whole = LearnedOffloadManager(64, 16, group=32, device=dev)
        drive(whole, 20, np.random.default_rng(9))
        m1 = LearnedOffloadManager(64, 16, group=32, checkpoint_dir=tmp / "offload", checkpoint_every=2, device=dev)
        rng = np.random.default_rng(9)
        drive(m1, 10, rng)
        m2 = LearnedOffloadManager(64, 16, group=32, checkpoint_dir=tmp / "offload", resume=True, device=dev)
        check(m2._observed_batches == SnapshotStore(tmp / "offload").latest_step() == 4,
              f"the offload resumed at batch {m2._observed_batches}, not its last snapshot's (4)")
        m2.restore(m1.state())  # roll forward to the live position, as the reference's test does
        drive(m2, 10, rng)
        return whole, m2

    def plugin_runs():
        with REG.scoped():
            REG.register_policy("lru_clone", lambda st, i, t: (st.last_access,))
            REG.register_policy("mru", lambda st, i, t: (-st.last_access,))
            REG.register_prefetcher("tree_clone", S._tree_mask)
            return S.run_batch(atax, [tuple(c) for c in ref["plugins"]["cells"]], device=dev)

    S._scan_events, MC._tree_finite = counting, timed_finite
    try:
        column("snapshots", [
            ("hotspot", lambda: drive_ours(lambda: hot_mgr(R.load_pretrained(WEIGHTS, CONFIG, dev)), hot,
                                           FT_SNAP_AFTER["hotspot"], store("a"), lambda: hot_mgr(empty()))),
            ("atax_whole", lambda: drive_ours(lambda: atax_mgr(ctx.pretrained()), atax)),
            ("atax_tuned", lambda: drive_ours(lambda: atax_mgr(ctx.pretrained()), atax, FT_SNAP_AFTER["atax_tuned"],
                                              store("b"), lambda: atax_mgr(empty(ctx.fresh)))),
            ("mux", lambda: drive_ours(lambda: mux(False, ctx.pretrained()), pair, FT_SNAP_AFTER["mux"], store("d0"),
                                       lambda: mux(False, empty(ctx.fresh)))),
            ("mux_shared", lambda: drive_ours(lambda: mux(True, ctx.pretrained()), pair, FT_SNAP_AFTER["mux"],
                                              store("d1"), lambda: mux(True, empty(ctx.fresh))))])
        column("health", [
            ("health_off", lambda: R.run_ours(hot, CONFIG, frozen, oversubscription=ref["hotspot_oversub"],
                                              manager=hot_mgr(R.load_pretrained(WEIGHTS, CONFIG, dev)))),
            ("health_on", lambda: R.run_ours(hot, CONFIG, frozen, oversubscription=ref["hotspot_oversub"],
                                             manager=hot_mgr(R.load_pretrained(WEIGHTS, CONFIG, dev),
                                                             health=HealthConfig()))),
            ("chaos", lambda: chaos_run(hot_mgr(R.load_pretrained(WEIGHTS, CONFIG, dev), health=HealthConfig()), hot,
                                        ref["chaos"]["schedule"], ref["hotspot_oversub"], frozen)),
            ("mux_chaos", lambda: chaos_run(mux(False, ctx.pretrained(), health=HealthConfig()), pair,
                                            ref["mux"]["chaos"]["schedule"], ref["pair_oversub"], frozen))])
        n_finite, finite_s = finite
        column("offload", [("offload", offload_runs)])
        column("plugins", [("plugins", plugin_runs)])
    finally:
        S._scan_events, MC._tree_finite = scan, tree_finite
    cost = {k[:-5]: v for k, v in runs.items() if k.endswith(":cost")}
    print("  runs: " + json.dumps({k: {**v, "ms_per_event": 1e3 * v["host_s"] / v["events"] if v["events"] else None}
                                   for k, v in cost.items()}))
    print("  columns: " + json.dumps({k: {f: v[f] for f in ("host_s", "runs")} for k, v in columns.items()}))
    dist = {}
    # (a) Hotspot through a snapshot: the JAX package's run (phase 4's), bit for bit
    res, snap_s = runs["hotspot"]
    check(ft_fields(res) == {k: ref["hotspot"][k] for k in ft_fields(res)},
          f"(a) the restored Hotspot run differs from the JAX package's: {ft_fields(res)['stats']}")
    print(f"  (a) Hotspot x{ref['hotspot_oversub']} snapshotted after group {FT_SNAP_AFTER['hotspot']} "
          f"({snap_s:.3f} s to snapshot, save, read and restore): stats, top-1 {res.top1}, warm top-1, per-group "
          f"accuracies and prediction count equal the JAX package's")
    # (b) ATAX fine-tuned: the restored run is the uninterrupted one; that one is near JAX's
    (whole, _), (res, snap_s) = runs["atax_whole"], runs["atax_tuned"]
    check(ft_fields(res) == ft_fields(whole), f"(b) the restored fine-tuned ATAX run differs from the uninterrupted "
          f"one: {ft_fields(res)} against {ft_fields(whole)}")
    dist["atax_tuned"] = run_distance(whole, ref["atax_tuned"])
    print(f"  (b) ATAX x{ref['atax_oversub']} fine-tuned, snapshotted after group {FT_SNAP_AFTER['atax_tuned']} "
          f"({snap_s:.3f} s): equal to the uninterrupted run (top-1 {whole.top1}; JAX {ref['atax_tuned']['top1']})")
    # (c) the health machine: no fault absorbed without chaos; under chaos JAX's counts and sequence
    check(ft_fields(runs["health_off"]) == {k: ref["hotspot"][k] for k in ft_fields(runs["health_off"])},
          "(c) the Hotspot run without the health machine differs from the JAX package's")
    dist["health_on"] = run_distance(runs["health_on"], ref["hotspot"])
    ch, want = runs["chaos"], ref["chaos"]
    got = {k: ch[k] for k in ("counts", "n_health_faults", "n_fallbacks", "n_recoveries", "sequence")}
    check(got == {k: want[k] for k in got}, f"(c) the chaos run's health record differs from the JAX package's: "
          f"{json.dumps({k: got[k] for k in got if k != 'sequence'})} against "
          f"{json.dumps({k: want[k] for k in got if k != 'sequence'})}")
    check(all(want["counts"].get(k, 0) >= 2 for k in ("trainer_exc", "nan_output", "train_exc", "nan_params",
                                                      "drop_freq_update")) and want["n_recoveries"] >= 1,
          "(c) the reference's schedule does not fire every site twice and recover")
    dist["chaos"] = run_distance(ch["run"], want["run"])
    n_rounds = len(hot) // frozen.group_size + 1
    per_round = {k: cost[k]["host_s"] / n_rounds for k in ("health_off", "health_on", "chaos")}
    print(f"  (c) health on, no chaos: {json.dumps({k: dist['health_on'][k] for k in ('stats', 'top1', 'equal')})}; "
          f"chaos {json.dumps(want['schedule'])}: fired {json.dumps(ch['counts'])}, health faults "
          f"{ch['n_health_faults']}, fallbacks {ch['n_fallbacks']}, recoveries {ch['n_recoveries']}, every round's "
          f"(health, fallback) equal to the JAX package's; params checks {n_finite} in {finite_s:.4f} s "
          f"({1e3 * finite_s / max(n_finite, 1):.3f} ms each); host s per round "
          + json.dumps(per_round))
    # (d) the mux: snapshots with isolated and shared tables equal to JAX's; chaos on evaluate_many
    for name in ("mux", "mux_shared"):
        res, snap_s = runs[name]
        check(ft_fields(res) == {k: ref["mux"][name][k] for k in ft_fields(res)},
              f"(d) the restored {name} run differs from the JAX package's: {ft_fields(res)['stats']}")
    mc, want = runs["mux_chaos"], ref["mux"]["chaos"]
    got = {k: mc[k] for k in ("counts", "n_health_faults", "n_fallbacks", "n_recoveries", "sequence")}
    check(got == {k: want[k] for k in got}, f"(d) the mux chaos run's health record differs from the JAX package's: "
          f"{json.dumps({k: got[k] for k in got if k != 'sequence'})}")
    dist["mux_chaos"] = tuned_distance(mc["run"], want["run"])
    print(f"  (d) {'+'.join(ref['pair'])}: snapshots with isolated and shared tables equal the JAX package's runs "
          f"(top-1 {runs['mux'][0].top1}, {runs['mux_shared'][0].top1}); chaos {json.dumps(want['schedule'])}: fired "
          f"{json.dumps(mc['counts'])}, health faults {mc['n_health_faults']} (every tenant of a failed dispatch), "
          f"recoveries {mc['n_recoveries']}, sequence equal")
    # (e) the KV offload: the resumed stream is the uninterrupted one; that one against JAX's
    whole, resumed = runs["offload"]
    check((dataclasses.asdict(resumed.stats), resumed.resident.tolist(), resumed.manager.top1)
          == (dataclasses.asdict(whole.stats), whole.resident.tolist(), whole.manager.top1),
          "(e) the resumed offload stream differs from the uninterrupted one")
    ws, wo = dataclasses.asdict(whole.stats), ref["offload"]
    dist["offload"] = {"stats": ws, "top1": whole.manager.top1, "top1_diff": abs(whole.manager.top1 - wo["top1"]),
                       "stats_rtol": {k: _rel(ws[k], wo["stats"][k]) for k in ws}, "n_predictions_equal": True,
                       "first_groups_acc_diff": 0.0,
                       "equal": (ws, np.flatnonzero(whole.resident).tolist(), whole.manager.top1)
                       == (wo["stats"], wo["resident"], wo["top1"])}
    print(f"  (e) offload checkpoint every 2 batches, resumed at 4: equal to the uninterrupted run ({json.dumps(ws)})")
    # (f) plug-ins: the clones equal the builtins, every cell equal to JAX's; the fault log
    stats = runs["plugins"]
    check(stats[0] == stats[1] == stats[4], f"(f) the clones differ from the builtins: {stats}")
    check(stats == ref["plugins"]["stats"], f"(f) run_batch with registered strategies differs from the JAX "
          f"package's: {stats} against {ref['plugins']['stats']}")
    log = tmp / "hotspot.jsonl"
    lines = T.to_fault_log(hot, log, batch=ref["fault_log"]["batch"])
    back = T.from_fault_log(log)
    fl = ref["fault_log"]
    check((lines, hashlib.sha256(log.read_bytes()).hexdigest()) == (fl["lines"], fl["sha256"]),
          "(f) Hotspot's fault log differs from the JAX package's")
    check(merge_sha256(back) == merge_sha256(hot) == fl["read_back_sha256"] == fl["trace_sha256"],
          "(f) the fault log does not read back to phase 4's trace")
    print(f"  (f) run_batch on ATAX: lru_clone and tree_clone equal the builtins, mru's counters and every cell equal "
          f"the JAX package's ({json.dumps(stats[2])}); evict_select launched "
          f"{columns['plugins']['launches']['evict_select']} times; Hotspot's fault log ({lines} lines, "
          f"{log.stat().st_size} bytes) has the JAX package's SHA-256 and reads back to the trace")
    print("  (b)-(e) " + json.dumps(dist))
    for k, d in dist.items():
        check_tuned(k, d, FT_EQUAL)
    print(f"  (b)-(e): {sum(d['equal'] for d in dist.values())} of {len(dist)} runs equal to the JAX package's, "
          f"the rest within phase 7 (b)'s limits")
    print("  launches: " + json.dumps({k: {n: c for n, c in v["launches"].items() if c} for k, v in columns.items()}))
    ft_launch_checks(columns)
    return {k: sum(c["launches"][k] for c in columns.values()) for k in next(iter(columns.values()))["launches"]}


def ft_launch_checks(columns: dict) -> None:
    """The snapshot and health columns launch the predictor's attention,
    ``evict_select`` and ``freq_update`` (the gate opens on Hotspot); the
    snapshot column's fine-tuned ATAX also the attention backward and both
    ``thrash_ce`` kernels, as does the offload column (whose prefetch gate
    stays shut, as the JAX package's does: no ``freq_update``); the
    plug-in column ``evict_select``."""
    need = {"snapshots": ("evict_select", "freq_update", "flash_attention", "flash_attention_bwd", "thrash_ce_fwd",
                          "thrash_ce_bwd"),
            "health": ("evict_select", "freq_update", "flash_attention"),
            "offload": ("flash_attention", "flash_attention_bwd", "thrash_ce_fwd", "thrash_ce_bwd"),
            "plugins": ("evict_select",)}
    for name, col in columns.items():
        for k in need[name]:
            check(col["launches"][k] > 0, f"the {name} column never launched {k}")


# --- phase 13: the experiment surface -------------------------------------------------------

CLI_REF = ROOT / "experiments" / "torch" / "cli_quick_ref.json"
# the learned runs (d) drives through run_ours_many: three of Table VI's benchmarks and Table VIII's first pair
API_LANES = ("ATAX", "BICG", "Pathfinder")
API_PAIR = ("StreamTriad", "2DCONV")
_CELL_LINE = re.compile(r"^\s*(\S+)\s+(\S+)\s+@(\S+)\s+thrash=(\d+) faults=(\d+) migrated=(\d+)(?: top1=\S+)?\s+key=(\w+)$")


def cli_lines(argv: list) -> list[str]:
    """``repro_torch.uvm.cli.main(argv)`` in this process: its standard
    output, line by line (it must exit 0)."""
    import contextlib
    import io

    from repro_torch.uvm import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    check(rc == 0, f"cli {argv[0]} exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue().splitlines()


def first_difference(got: list, want: list) -> str:
    """Where two record streams part (for a failure message)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return f"record {i}: {g} against {w}"
    return f"lengths {len(got)} against {len(want)}"


def experiment_api_path(dev, ctx=None) -> dict:
    """Phase 13: the port's CLI, run store, ``Session`` and ``run_ours_many``
    on the card, against ``experiments/torch/cli_quick_ref.json`` (the JAX
    package's CLI), ``tables_paper_ref.json`` and
    ``concurrent_paper_ref.json``, in a temporary directory that is removed
    after.  ``ctx`` is phase 8's frozen context, whose serial runs (d)
    compares with (a new one when phase 13 runs alone).  Returns the
    launches of all its pieces."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_api_"))
    try:
        return _experiment_api(dev, ctx, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _experiment_api(dev, ctx, tmp: Path) -> dict:
    import hashlib

    from repro_torch import kernels
    from repro_torch.bench import tables as TB
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm.api import CellSpec, ExperimentSpec, PolicySpec, PrefetchSpec, RunStore, WorkloadSpec

    ref = json.loads(CLI_REF.read_text())
    tables = json.loads(TABLES_REF.read_text())
    conc = json.loads(CONCURRENT_REF.read_text())
    if ctx is None:
        ctx = TB.Context("paper", frozen=True, fresh=FRESH, device=dev)
    runs = tmp / "runs"
    pieces = {}

    def piece(name, fn):
        _sync(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        pieces[name] = {"host_s": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES)}
        return out

    def stored(key: str) -> dict:
        rec = json.loads((runs / key[:2] / f"{key}.json").read_text())
        check(rec["key"] == key, f"the stored record {key} is another spec's")
        return rec["result"]

    # (a) the sweep at the paper preset, its spec dump, and the same sweep again
    cli = ref["cli"]
    on = ["--device", dev]  # every command but report runs on the phase's device
    dump = tmp / "spec.json"
    lines = piece("sweep", lambda: cli_lines(["sweep", *cli["sweep"], *on, "--runs-dir", runs, "--dump-spec", dump]))
    strip = lambda ls: [ln.split(" store=")[0] for ln in ls if not ln.startswith("# wrote")]
    check(strip(lines) == ref["keys"]["sweep_lines"], "(a) the sweep's lines differ from the JAX package's: "
          + first_difference(strip(lines), ref["keys"]["sweep_lines"]))
    check(hashlib.sha256(dump.read_bytes()).hexdigest() == ref["keys"]["dump_sha256"],
          "(a) the dumped spec differs from the JAX package's")
    bad = []
    for ln in lines[1:-1]:
        bench, label, _, *_, key = _CELL_LINE.match(ln).groups()
        if stored(key) != tables["benchmarks"][bench]["sim"][label]:
            bad.append((bench, label, stored(key)))
    check(not bad and len(lines) == 10, f"(a) stored sim cells differ from Table VI's: {bad}")
    again = piece("sweep_again", lambda: cli_lines(["sweep", *cli["sweep"], *on, "--runs-dir", runs]))
    check(again[:-1] == lines[1:-1] and again[-1].startswith("# sweep cells=8 hits=8 computed=0 "),
          f"(a) the second sweep was not served from the store: {again[-1]}")
    check(not any(pieces["sweep_again"]["launches"].values()), "(a) the second sweep launched a kernel")
    # (b) the dump replayed with UVMSmart cells added: the sim cells are hits
    spec = ExperimentSpec.from_json(dump.read_text())
    extra = [CellSpec(WorkloadSpec(b, *TB.SCALE_PRESETS["paper"]), "uvmsmart", PolicySpec("adaptive"),
                      PrefetchSpec("adaptive"), os_) for b, os_ in cli["extra"]]
    replay = ExperimentSpec.from_dict({**spec.to_dict(), "extra_cells": [c.to_dict() for c in extra]})
    check(replay.key == ref["keys"]["replay"] and [c.key for c in replay.cells()] == ref["keys"]["replay_cells"],
          "(b) the replayed spec's keys differ from the JAX package's")
    (tmp / "replay.json").write_text(replay.to_json())
    lines = piece("replay", lambda: cli_lines(["sweep", "--spec", tmp / "replay.json", *on, "--runs-dir", runs]))
    check(lines[-1].startswith("# sweep cells=10 hits=8 computed=2 "), f"(b) {lines[-1]}")
    smart = {c.workload.benchmark: stored(c.key) for c in extra}
    check(all(smart[b] == tables["benchmarks"][b]["uvmsmart"] for b in smart),
          f"(b) UVMSmart differs from Table VI's: {smart}")
    # (c) the fine-tuned ours cell from the paper preset's table
    lines = piece("run_ours", lambda: cli_lines(["run", *cli["run"], *on, "--runs-dir", runs]))
    check(lines[0].rstrip().endswith(f"key={ref['keys']['run_ours']}"), f"(c) {lines[0]}")
    tuned = R.LearnedRunResult(**stored(ref["keys"]["run_ours"]))
    dist = run_distance(tuned, tables["benchmarks"]["ATAX"]["ours_fine_tuned"])
    check_tuned("cli_run_ATAX", dist, ())
    # (d) run_ours_many, frozen, against the serial runs and the references
    frozen = TrainConfig(**tables["train"]["frozen"])
    pair = ctx.concurrent(API_PAIR, slice_len=frozen.group_size)
    traces = [ctx.trace(b) for b in API_LANES] + [pair]
    many = piece("run_ours_many", lambda: R.run_ours_many(traces, CONFIG, frozen, oversubscription=1.25,
                                                          tables=[ctx.pretrained() for _ in traces], device=dev))
    serial = piece("run_ours_serial", lambda: [ctx.ours(b) for b in API_LANES] + [ctx.ours(pair)])
    for tr, m, s in zip(traces, many, serial):
        check(dataclasses.asdict(m) == dataclasses.asdict(s), f"(d) {tr.name}'s lane differs from its serial run_ours")
    for b, m in zip(API_LANES, many):
        w = tables["benchmarks"][b]["ours_frozen"]
        check((m.stats, m.top1, m.n_predictions) == (w["stats"], w["top1"], w["n_predictions"]),
              f"(d) {b}'s lane differs from Table VI's frozen ours")
    key = "+".join(API_PAIR)
    want = conc["pairs_ref"][key]["runs"]["mux_frozen"]
    check(run_fields(many[-1]) == {k: want[k] for k in run_fields(many[-1])},
          f"(d) the {key} lane differs from Table VIII's frozen mux run")
    [row] = [r for r in conc["tables"]["table8_frozen"] if r["workloads"] == key]
    m = many[-1]
    check((row["mux_top1"], row["tenant0_top1"], row["tenant1_top1"])
          == (round(m.top1, 3), round(m.per_tenant_top1["0"], 3), round(m.per_tenant_top1["1"], 3)),
          f"(d) Table VIII's frozen row differs: {row}")
    # (e) the fault logs, serve over each with checkpoints, and a resume from the middle
    served = {}

    def serve_logs():
        for name, argv in cli["logs"].items():
            want = ref["logs"][name]
            log = tmp / f"{name}.jsonl"
            cli_lines(["export", *argv, *on, "--no-store", "--out", log])
            text = log.read_text()
            check(hashlib.sha256(text.encode()).hexdigest() == want["sha256"],
                  f"(e) the {name} log differs from the JAX package's")
            ck = ["--checkpoint-every", cli["checkpoint_every"]]
            lines = cli_lines(["serve", "--input", log, "--checkpoint-dir", tmp / f"{name}_ck", *ck, *on])
            recs = [ln for ln in lines if ln.startswith("{")]
            check(recs == want["records"], f"(e) the {name} stream differs from the JAX package's: "
                  + first_difference(recs, want["records"]))
            check(lines[-1] == want["summary"], f"(e) {lines[-1]} against {want['summary']}")
            head = tmp / f"{name}_head.jsonl"
            head.write_text("".join(text.splitlines(keepends=True)[: cli["resume_after"][name]]))
            resume_ck = ["--checkpoint-dir", tmp / f"{name}_resume", *ck, *on]
            cli_lines(["serve", "--input", head, *resume_ck])
            res = cli_lines(["serve", "--input", log, *resume_ck, "--resume"])
            at = int(res[0].split("batch=")[1].split()[0])
            tail = [ln for ln in res if ln.startswith("{")]
            check(at == want["resumed"]["batch"] and tail == recs[at:] and res[-1] == lines[-1],
                  f"(e) the {name} stream resumed at batch {at} differs from the uninterrupted run's tail")
            served[name] = {"batches": len(recs), "resumed_at": at,
                            "prefetching": sum(bool(json.loads(r)["prefetch_blocks"]) for r in recs)}

    piece("serve", serve_logs)
    # (f) the report lists every stored run
    lines = piece("report", lambda: cli_lines(["report", "--runs-dir", runs]))
    n = len(list(RunStore(runs).records()))
    check(n == 11 and lines[-1].startswith(f"# {n} stored runs in ") and len(lines) == n + 2,
          f"(f) the report lists {len(lines) - 2} runs of {n}: {lines[-1]}")
    print(f"  (a) sweep at the paper preset: 8 cells equal to Table VI's, lines and spec dump the JAX package's; "
          f"again: hits=8 computed=0, no launch; (b) replay: 8 hits, UVMSmart on ATAX and BICG equal; (c) cli run "
          f"ours ATAX fine-tuned: top-1 {tuned.top1} (JAX {tables['benchmarks']['ATAX']['ours_fine_tuned']['top1']}, "
          f"equal: {dist['equal']}); (d) run_ours_many over {', '.join(tr.name for tr in traces)}: every lane equal "
          f"to its serial run and to Tables VI and VIII; (e) {json.dumps(served)}: streams the JAX package's, byte "
          f"for byte, and the resumed tails the uninterrupted runs'; (f) report: {n} runs")
    print("  host s: " + json.dumps({k: v["host_s"] for k, v in pieces.items()}))
    print("  launches: " + json.dumps({k: {n: c for n, c in v["launches"].items() if c} for k, v in pieces.items()}))
    api_launch_checks(pieces)
    # the launches of the new path: every piece but the serial runs it is compared with
    return {k: sum(v["launches"][k] for name, v in pieces.items() if name != "run_ours_serial")
            for k in kernels.LAUNCHES}


def api_launch_checks(pieces: dict) -> None:
    """The sweeps launch ``evict_select``; the fine-tuned ``run`` the
    training kernels as well; ``run_ours_many`` the frozen path's
    (``evict_select``, the attention); ``serve`` fine-tunes on every batch
    and opens the prefetch gate (no simulator: no ``evict_select``)."""
    need = {"sweep": ("evict_select",), "replay": ("evict_select",),
            "run_ours": ("evict_select", "flash_attention", "flash_attention_bwd", "thrash_ce_fwd", "thrash_ce_bwd"),
            "run_ours_many": ("evict_select", "flash_attention"),
            "serve": ("flash_attention", "flash_attention_bwd", "thrash_ce_fwd", "thrash_ce_bwd", "freq_update")}
    for name, ks in need.items():
        for k in ks:
            check(pieces[name]["launches"][k] > 0, f"phase 13's {name} never launched {k}")


# phase 14: the async fault-stream server.  Event-loop passes per tick (the
# reference's default; scripts/rehearse_server_cpu.py prints how many
# lanes a tick gathers with it)
SERVER_GATHER_SPINS = 2
SERVER_MODES = ("serial", "fused", "vmap")
SERVER_CHAOS = "drop_batch=0.4,dup_batch=0.3,lose_feedback=0.5,seed=11"
# (b): four benchmarks' first groups at the paper preset, stacked at CONFIG
STACK_BENCH = ("ATAX", "BICG", "Hotspot", "StreamTriad")
_LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")  # runtime calls that put work on the card


def _ops_on(device_type: str):
    """A dispatch mode that counts, by name, the ops run on tensors of
    ``device_type`` by the thread that enters it (dispatch modes are
    thread-local, so other threads' ops pass it by)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.device.type == device_type
                   for t in tree_flatten((args, kwargs, out))[0]):
                self.ops[str(func)] = self.ops.get(str(func), 0) + 1
            return out

    return Ops()


def _spawn_server(sock: str, extra: list, dev):
    """Start ``python -m repro_torch.uvm.cli server`` in a fresh process;
    :func:`_listening` waits for it to announce its socket."""
    import os

    return subprocess.Popen([sys.executable, "-m", "repro_torch.uvm.cli", "server", "--socket", sock,
                             "--device", str(dev.type), *map(str, extra)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT),
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def _listening(proc) -> None:
    import select

    deadline = time.time() + 180
    banner = ""
    while time.time() < deadline and not banner:
        if select.select([proc.stdout], [], [], 1.0)[0]:
            banner = proc.stdout.readline()
        elif proc.poll() is not None:
            break
    if "# server listening" not in banner:
        proc.kill()
        rest = proc.communicate()[0]
        raise SmokeFailure(f"cli server did not start: {banner}{rest[-2000:]}")


def _stop_server(proc, sig) -> str:
    """Signal a spawned server and return the rest of its output."""
    proc.send_signal(sig)
    try:
        out = proc.communicate(timeout=120)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
    return out


def _aot_stats(line: str) -> dict:
    """The counts of a ``# aot cache=DIR {...}`` line."""
    return json.loads(line[line.index("{"):])


async def _drive_named(sock: str, lines: list, *, n_actions=None) -> list:
    """``hello job`` and ``lines`` on one connection; every output line (at
    EOF, or once ``n_actions`` action records arrived)."""
    import asyncio

    reader, writer = await asyncio.open_unix_connection(sock)
    writer.write((json.dumps({"hello": {"session": "job"}}) + "\n").encode())
    for ln in lines:
        writer.write((ln + "\n").encode())
    await writer.drain()
    if n_actions is None:
        writer.write_eof()
    out, acts = [], 0
    try:
        while True:
            raw = await asyncio.wait_for(reader.readline(), timeout=120)
            if not raw:
                break
            out.append(raw.decode().rstrip("\n"))
            acts += out[-1].startswith('{"batch"')
            if n_actions is not None and acts >= n_actions:
                break
    finally:
        writer.close()
    return out


STACK_CUT = 1600  # (b)'s third lane in windows: 18 steps at TrainConfig() against the others' 21


def stack_groups():
    """``STACK_BENCH``'s first groups (2,048 accesses) at ``CONFIG``'s
    vocabularies: one ``(FeatureSet, n_active)`` per lane."""
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.core.features import DeltaVocab, FeatureStream
    from repro_torch.uvm import trace as T

    out = []
    for b in STACK_BENCH:
        vocab = DeltaVocab(CONFIG.delta_vocab)
        stream = FeatureStream(T.get_trace(b, 1.0), vocab, CONFIG.history, page_vocab=CONFIG.page_vocab,
                               pc_vocab=CONFIG.pc_vocab, tb_vocab=CONFIG.tb_vocab)
        out.append((stream.windows(0, 2048), max(vocab.n_classes, 2)))
    return out


def entry_sha(entry) -> str:
    """The SHA-256 (first 16 hex digits) of an entry's params and AdamW
    moments, in sorted key order, and its step and update counts."""
    import hashlib

    h = hashlib.sha256()
    for tree in (entry.params, *(() if entry.opt_state is None else (entry.opt_state.m, entry.opt_state.v))):
        for k in sorted(tree):
            h.update(tree[k].detach().contiguous().cpu().numpy().tobytes())
    h.update(f"{entry.step} {entry.n_updates}".encode())
    return h.hexdigest()[:16]


def stacked_fine_tune(dev, table) -> dict:
    """Phase 14 (b)'s fine-tune half: ``Trainer(CONFIG, TrainConfig())``
    over ``STACK_BENCH``'s first groups from ``table``'s slots, params and
    moments, LUCIR (each slot its own previous model) and E∪T flags on, the
    third lane cut to ``STACK_CUT`` windows.  The stacked bucket against
    the lanes' serial ``train_group``: each lane's SHA-256, the launches
    per stacked step, the host seconds of each (after a warm stacked run),
    and the share of the stacked run's host seconds spent inside
    ``thrash_ce``'s forward and backward wrappers."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.core.incremental import TrainConfig, Trainer
    from repro_torch.core.model_table import Entry, clone_tree
    from repro_torch.kernels import thrash_ce as TCE

    trainer = Trainer(CONFIG, TrainConfig(), device=dev)
    groups = stack_groups()
    fs_list = [fs.slice(0, STACK_CUT) if i == 2 else fs for i, (fs, _) in enumerate(groups)]
    na = [n for _, n in groups]
    rng = np.random.default_rng(0)
    flags = [rng.random(len(fs)) < 0.3 for fs in fs_list]
    slots = sorted(table.slots)
    start = [table.slots[slots[i % len(slots)]] for i in range(len(fs_list))]
    steps = [len(trainer._train_schedule(len(fs), np.random.default_rng(0))) for fs in fs_list]
    check(steps == [21, 21, 18, 21], f"(b) the fine-tune lanes' steps: {steps}")

    def run(stacked: bool):
        es = [Entry(params=clone_tree(e.params), prev_params=clone_tree(e.params), opt_state=clone_tree(e.opt_state),
                    step=e.step, n_updates=e.n_updates) for e in start]
        _sync(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        if stacked:
            trainer.train_group_many(es, fs_list, na, in_et_list=flags, use_lucir=True)
        else:
            for e, fs, n, f in zip(es, fs_list, na, flags):
                trainer.train_group(e, fs, n, in_et=f, use_lucir=True)
        _sync(dev)
        return [entry_sha(e) for e in es], time.perf_counter() - t0, dict(kernels.LAUNCHES)

    run(True)  # shapes and allocator warm
    serial, serial_s, ls = run(False)
    stacked, stacked_s, lm = run(True)
    check(stacked == serial, f"(b) a stacked fine-tune lane differs from its serial train_group: {stacked} {serial}")
    per = 2 * CONFIG.num_layers if dev.type == "cuda" else 0
    want_m = {"flash_attention": 2 * per * max(steps), "flash_attention_bwd": per * max(steps),
              "thrash_ce_fwd": sum(steps) * bool(per), "thrash_ce_bwd": sum(steps) * bool(per)}
    want_s = {"flash_attention": 2 * per * sum(steps), "flash_attention_bwd": per * sum(steps),
              "thrash_ce_fwd": want_m["thrash_ce_fwd"], "thrash_ce_bwd": want_m["thrash_ce_bwd"]}
    got_m, got_s = ({k: d[k] for k in want_m} for d in (lm, ls))
    check(got_m == want_m and got_s == want_s, f"(b) fine-tune launches stacked {got_m} (want {want_m}), serial "
          f"{got_s} (want {want_s})")
    inside = [0.0]

    def clocked(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                inside[0] += time.perf_counter() - t
        return call

    fwd, bwd = TCE._forward, TCE._backward
    TCE._forward, TCE._backward = clocked(fwd), clocked(bwd)
    try:
        clocked_sha, clocked_s, _ = run(True)
    finally:
        TCE._forward, TCE._backward = fwd, bwd
    check(clocked_sha == serial, "(b) the clocked stacked fine-tune differs")
    return {"lanes": [len(fs) for fs in fs_list], "steps": steps, "serial_s": serial_s, "stacked_s": stacked_s,
            "launches": {"serial": got_s, "stacked": got_m}, "sha256": stacked,
            "thrash_ce_host_share": inside[0] / clocked_s, "clocked_s": clocked_s}


def server_path(dev, aot_miss: bool = False) -> dict:
    """Phase 14: ``FaultStreamServer``, ``run_loadgen`` and ``cli server``
    on the card, against ``experiments/torch/cli_quick_ref.json``'s serve
    streams, in a temporary directory that is removed after.  With
    ``aot_miss`` (``--server``) a fresh ``cli server`` also builds the
    kernel library into an empty AOT cache.  Returns the launches of the
    server runs."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_server_"))
    try:
        return _server(dev, tmp, aot_miss)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _server(dev, tmp: Path, aot_miss: bool) -> dict:
    import shutil
    import signal

    from repro_torch.kernels._lib import LIBRARY

    ref = json.loads(CLI_REF.read_text())
    on = ["--device", str(dev.type)]
    # (d)'s two cli server processes start now, so that importing torch and
    # reaching the card overlap (a)-(c); the second binds its session (and
    # reads the first one's snapshot) only when its client says hello
    aot = []
    if dev.type == "cuda":
        (tmp / "aot").mkdir()
        shutil.copy2(LIBRARY.path(), tmp / "aot" / LIBRARY.path().name)
        aot = ["--aot-cache", tmp / "aot"]
    ck = ["--checkpoint-dir", tmp / "ck"]
    t_spawn = time.perf_counter()
    procs = [_spawn_server(str(tmp / "k1.sock"), [*ck, "--checkpoint-every", 4, *aot], dev),
             _spawn_server(str(tmp / "k2.sock"), [*ck, "--resume", *aot], dev)]
    try:
        return _server_checks(dev, tmp, aot_miss, ref, on, aot, procs, t_spawn)
    finally:
        for proc in procs:
            if proc.poll() is None:
                _stop_server(proc, signal.SIGKILL)


def _server_checks(dev, tmp: Path, aot_miss: bool, ref: dict, on: list, aot: list, procs: list, t_spawn: float):
    import asyncio
    import hashlib
    import signal
    import threading

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.predictor_paper import CONFIG
    from repro_torch.core import predictor as P
    from repro_torch.core.incremental import TrainConfig, Trainer
    from repro_torch.uvm import cli
    from repro_torch.uvm.manager import ChaosSchedule, FaultInjector, SnapshotStore
    from repro_torch.uvm.runtime import load_pretrained
    from repro_torch.uvm.server import FaultStreamServer, ServerConfig, make_connector, run_loadgen

    logs = {}
    for name, argv in ref["cli"]["logs"].items():
        path = tmp / f"{name}.jsonl"
        cli_lines(["export", *argv, *on, "--no-store", "--out", path])
        check(hashlib.sha256(path.read_bytes()).hexdigest() == ref["logs"][name]["sha256"],
              f"the {name} log differs from the JAX package's")
        logs[name] = [ln for ln in path.read_text().splitlines() if ln.strip() and not ln.startswith("#")]
    mcfg = cli._manager_config(cli.build_parser().parse_args(["server", "--socket", "-", *on]))
    runs = {}

    def run(label, mode, clients, *, watch_threads=False):
        """One in-process server in ``mode``; ``clients``: (log name, count,
        run_loadgen keywords) groups, all concurrent.  Returns each group's
        LoadStats and records the run's ticks, lanes, stacked buckets,
        launches and seconds under ``label``.  With ``watch_threads`` the
        event loop's thread counts every op it runs on the device (it must
        run none), and on the card a profile of the run counts the threads
        that launch or copy (there must be one)."""
        cfg = ServerConfig(manager=mcfg, microbatch=mode != "serial", exec_mode="auto" if mode == "serial" else mode,
                           gather_spins=SERVER_GATHER_SPINS)
        stacked = []
        stage = {"evaluate_many": 0.0, "train_group_many": 0.0}  # host seconds on the worker

        def timed(name, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    stage[name] += time.perf_counter() - t
            return call

        loop_ops = _ops_on(dev.type) if watch_threads else contextlib.nullcontext()

        async def main():
            with loop_ops:
                return await serve()

        async def serve():
            server = FaultStreamServer(cfg, device=dev)
            tr = server.trainer
            inner = tr._evaluate_bucket
            tr._evaluate_bucket = lambda p, f, n: len(p) > 1 and stacked.append(len(p)) or inner(p, f, n)
            tr.evaluate_many, tr.train_group_many = (timed(k, getattr(tr, k)) for k in stage)
            sock = str(tmp / f"{label}.sock")
            await server.start(path=sock)
            worker = await server.dispatcher.call(threading.get_native_id)
            try:
                _sync(dev)
                kernels.reset_launches()
                t0 = time.perf_counter()
                stats = await asyncio.gather(*(run_loadgen(make_connector(f"unix:{sock}"), logs[name], n, **kw)
                                               for name, n, kw in clients))
                await server.dispatcher.call(_sync, dev)
                wall = time.perf_counter() - t0
                launches = dict(kernels.LAUNCHES)
            finally:
                await server.shutdown()
            return stats, server.dispatcher, launches, wall, worker

        prof = None
        if watch_threads and dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = asyncio.run(main())
        else:
            out = asyncio.run(main())
        stats, d, launches, wall, worker = out
        runs[label] = {"ticks": d.n_ticks, "max_eval_lanes": d.max_eval_lanes, "stacked": stacked,
                       "host_s": wall, "stage_s": stage, "launches": launches}
        if watch_threads:
            runs[label]["loop_ops"] = loop_ops.ops
            check(not loop_ops.ops, f"({label}) the event loop's thread ran ops on the {dev.type}: {loop_ops.ops}")
        if prof is not None:
            # the raw events' runtime calls on the host (parsing them into
            # FunctionEvents takes seconds); the profiler numbers threads its
            # own way, not as the threading module does
            events = [e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CPU and any(k in e.name() for k in _LAUNCH_CALLS)]
            threads = {e.start_thread_id() for e in events}
            runs[label]["launching_threads"] = {"calls": len(events), "threads": sorted(threads), "worker": worker,
                                                "loop": threading.get_native_id()}
            check(events and len(threads) == 1,
                  f"({label}) work reached the card from threads {threads} ({len(events)} calls)")
        return stats

    def held(label, client, name, *, clean=True) -> None:
        want = ref["logs"][name]
        check(client.actions == want["records"], f"({label}) client {client.idx}'s {name} stream differs from the "
              "JAX package's: " + first_difference(client.actions, want["records"]))
        if clean:
            check(client.errors == 0 and client.comments[-1] == want["summary"]
                  and "health_faults=0 fallbacks=0" in client.comments[-1]
                  and not any('"fallback": true' in a for a in client.actions),
                  f"({label}) client {client.idx}: {client.comments[-1:]} against {want['summary']}")

    # (a) every mode, four clients on each log, all concurrent
    a_stats = {}
    for mode in SERVER_MODES:
        stats = a_stats[mode] = run(mode, mode, [("drift", 4, {}), ("churn", 4, {})])
        for name, st in zip(("drift", "churn"), stats):
            for c in st.per_client:
                held(f"a/{mode}", c, name)
    a = {m: runs[m] for m in SERVER_MODES}
    print("  (a) 4 drift + 4 churn clients per mode, every stream the JAX package's byte for byte, "
          "health_faults=0 fallbacks=0: " + json.dumps({m: {k: v for k, v in a[m].items() if k != "launches"}
                                                        for m in SERVER_MODES}))
    print("      launches: " + json.dumps({m: {k: c for k, c in a[m]["launches"].items() if c} for m in SERVER_MODES}))
    for mode in ("fused", "vmap"):
        check(a[mode]["max_eval_lanes"] > 1 and a[mode]["ticks"] < a["serial"]["ticks"],
              f"(a) {mode} gathered nothing: {a[mode]['ticks']} ticks, {a[mode]['max_eval_lanes']} lanes at most")
    check(max(a["vmap"]["stacked"], default=0) >= 4 and not a["fused"]["stacked"],
          f"(a) vmap stacked no bucket of four lanes: {a['vmap']['stacked']}")
    if dev.type == "cuda":
        fa = {m: a[m]["launches"]["flash_attention"] for m in SERVER_MODES}
        check(fa["vmap"] < fa["fused"] == fa["serial"], f"(a) flash_attention launches per mode: {fa}")
    # (b) a stacked bucket at the paper width
    table = load_pretrained(WEIGHTS, CONFIG, dev)
    slots = sorted(table.slots)
    fs_list, na = map(list, zip(*stack_groups()))
    params = [table.slots[slots[i % len(slots)]].params for i in range(len(fs_list))]
    trainer = Trainer(CONFIG, TrainConfig(2048, 0, 256), device=dev)

    def timed_launches(fn):
        _sync(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0, kernels.LAUNCHES["flash_attention"]

    trainer.evaluate_many(params, fs_list, na)  # first call: shapes and allocator warm
    serial, serial_s, serial_fa = timed_launches(lambda: [trainer.evaluate(*x) for x in zip(params, fs_list, na)])
    many, many_s, many_fa = timed_launches(lambda: trainer.evaluate_many(params, fs_list, na))
    for b, (sc, sp), (mc, mp) in zip(STACK_BENCH, serial, many):
        check(np.array_equal(sc, mc) and np.array_equal(sp, mp) and sp.dtype == mp.dtype,
              f"(b) {b}'s stacked lane differs from its serial evaluate")
    n_rows = -(-len(fs_list[0]) // 256)
    want_fa = 2 * CONFIG.num_layers * n_rows if dev.type == "cuda" else 0
    check(many_fa == want_fa and serial_fa == len(STACK_BENCH) * want_fa,
          f"(b) flash_attention launched {many_fa} times stacked and {serial_fa} serially (want {want_fa})")
    digests = {"stacked": [], "serial": []}
    with torch.no_grad():
        staged = [trainer._stage(fs) for fs in fs_list]
        sched = [trainer._eval_schedule(len(fs)) for fs in fs_list]
        per_lane = {k: [[] for _ in fs_list] for k in digests}
        for r in range(n_rows):
            batches = [{k: v[torch.as_tensor(s[r], device=dev)] for k, v in st[0].items()}
                       for st, s in zip(staged, sched)]
            for j, (lg, _) in enumerate(P.forward_many(params, batches, CONFIG)):
                per_lane["stacked"][j].append(lg)
            for j, (p, bt) in enumerate(zip(params, batches)):
                per_lane["serial"][j].append(P.forward(p, bt, CONFIG)[0])
        for k in digests:
            digests[k] = [tensor_sha(torch.cat(ls)) for ls in per_lane[k]]
    check(digests["stacked"] == digests["serial"], f"(b) stacked logits differ from the serial ones: {digests}")
    print(f"  (b) evaluate_many at CONFIG over {', '.join(STACK_BENCH)}: " + json.dumps({
        "lanes": [len(fs) for fs in fs_list], "rows": n_rows, "serial_s": serial_s, "stacked_s": many_s,
        "flash_attention": {"serial": serial_fa, "stacked": many_fa}, "logits_sha256": digests["stacked"],
        "top1": [float(c.mean()) for c, _ in many]}))
    tuned = stacked_fine_tune(dev, table)
    print(f"      and train_group_many at CONFIG and TrainConfig(), LUCIR and E∪T flags on, the third lane cut to "
          f"{STACK_CUT} windows: every lane's params, moments and counts its serial train_group's by SHA-256: "
          + json.dumps(tuned))
    # (c) isolation: a malformed client and a transport-chaos client beside two clean ones
    [st] = run("isolation", "fused", [("drift", 4, {"malformed_every": 3, "malformed_client": 2,
                                                    "chaos_schedules": {3: FaultInjector(ChaosSchedule.parse(
                                                        SERVER_CHAOS))}})], watch_threads=True)
    per = st.per_client
    for c in per[:2]:
        held("c", c, "drift")
    held("c", per[2], "drift", clean=False)
    check(per[2].malformed_sent > 0 and per[2].errors == per[2].malformed_sent and st.errors == per[2].errors,
          f"(c) malformed client: sent {per[2].malformed_sent}, errors {per[2].errors} (all clients {st.errors})")
    check(per[3].actions and all(json.loads(x)["batch"] > 0 for x in per[3].actions), "(c) the chaos client's stream")
    print(f"  (c) isolation: 2 clean clients the JAX package's, malformed client {per[2].errors} errors for "
          f"{per[2].malformed_sent} malformed lines and its stream undisturbed, chaos client {len(per[3].actions)} "
          f"records; {runs['isolation']['host_s']:.2f} s; ops of the event loop's thread on the {dev.type}: "
          f"{json.dumps(runs['isolation']['loop_ops'])}; launches and copies by thread: "
          f"{json.dumps(runs['isolation'].get('launching_threads'))}")
    # (d) kill -9 and --resume of a cli server subprocess, its AOT cache a copy of this process's build
    stream, clock = [], 0
    for ln in logs["drift"]:
        clock += len(json.loads(ln)["pages"])
        stream += [ln, json.dumps({"feedback": {"fault_count": clock}})]
    (tmp / "fb.jsonl").write_text("\n".join(stream) + "\n")
    whole = cli_lines(["serve", "--input", tmp / "fb.jsonl", *on])
    acts = [ln for ln in whole if ln.startswith("{")]
    t0 = time.perf_counter()
    _listening(procs[0])
    t_up = time.perf_counter() - t_spawn
    try:
        first = asyncio.run(_drive_named(str(tmp / "k1.sock"), stream[:11], n_actions=6))
    finally:
        _stop_server(procs[0], signal.SIGKILL)
    t_killed = time.perf_counter() - t0
    check(sum(ln.startswith('{"batch"') for ln in first) == 6 and SnapshotStore(str(tmp / "ck" / "job")).latest_step()
          == 4, f"(d) the killed server's snapshot: {SnapshotStore(str(tmp / 'ck' / 'job')).latest_step()}")
    _listening(procs[1])
    try:
        res = asyncio.run(_drive_named(str(tmp / "k2.sock"), stream))
    finally:
        rest = _stop_server(procs[1], signal.SIGTERM).splitlines()
    check(any(ln.startswith("# resumed batch=4 ") for ln in res)
          and [ln for ln in res if ln.startswith("{")] == acts[4:] and res[-1] == whole[-1],
          "(d) the resumed stream differs from the uninterrupted run's tail")
    aot_line = [ln for ln in rest if ln.startswith("# aot cache=")]
    if aot:
        check(len(aot_line) == 1 and _aot_stats(aot_line[0]) == {"hits": 1, "misses": 0, "fallbacks": 0},
              f"(d) the restarted server's AOT line: {aot_line}")
    check(rest and rest[-1].startswith("# server sessions=1 refused=0 idle_closed=0 resumed=1 "),
          f"(d) the restarted server's summary: {rest[-1:]}")
    d_out = {"resumed_at": 4, "records": len(acts), "aot": aot_line[0] if aot_line else None,
             "listening_after_s": t_up, "killed_at_s": t_killed, "host_s": time.perf_counter() - t0}
    if aot_miss and dev.type == "cuda":
        t0 = time.perf_counter()
        proc = _spawn_server(str(tmp / "m.sock"), ["--aot-cache", tmp / "aot_fresh"], dev)
        _listening(proc)
        rest = _stop_server(proc, signal.SIGTERM).splitlines()
        miss = [ln for ln in rest if ln.startswith("# aot cache=")]
        check(len(miss) == 1 and _aot_stats(miss[0]) == {"hits": 0, "misses": 1, "fallbacks": 0}
              and len(list((tmp / "aot_fresh").glob("librepro_torch_kernels_*.so"))) == 1,
              f"(d) a fresh AOT cache: {miss}")
        d_out["aot_miss"] = {"line": miss[0], "host_s": time.perf_counter() - t0}
    print("  (d) kill -9 and --resume: " + json.dumps(d_out))
    # (e) load: (a)'s eight concurrent clients per mode, every one sending its whole log at once
    e_out = {}
    for mode in SERVER_MODES:
        faults, wall = sum(st.faults for st in a_stats[mode]), max(st.wall_s for st in a_stats[mode])
        lat = [x for st in a_stats[mode] for c in st.per_client for x in c.latencies_ms]
        e_out[mode] = {"faults": faults, "wall_s": wall, "faults_per_s": faults / wall,
                       "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
                       "stage_s": runs[mode]["stage_s"]}
    print(f"  (e) load, (a)'s 4 drift + 4 churn clients, --rate 0 "
          f"({nvidia_smi_line() if dev.type == 'cuda' else 'cpu'}): " + json.dumps(e_out))
    launches = {k: sum(v["launches"][k] for v in runs.values()) for k in kernels.LAUNCHES}
    if dev.type == "cuda":
        for k in ("freq_update", "flash_attention", "flash_attention_bwd", "thrash_ce_fwd", "thrash_ce_bwd"):
            check(all(v["launches"][k] > 0 for v in runs.values()), f"phase 14: a server run never launched {k}")
    return launches


# --- phase 15: the benchmark driver ------------------------------------------------------

FIGURES_QUICK_REF = ROOT / "experiments" / "torch" / "figures_quick_ref.json"
BENCH_RUN_ONLY = ("table1", "table7")
# (b): Table VII's quick protocol runs that the CPU rehearsal
# (``scripts/rehearse_bench_run_cpu.py``) gives equal to the JAX package's:
# all but Hotspot+Srad-v2's online_single (0.0018 off in top-1), which is
# held within phase 7 (b)'s limits
BENCH_RUN_EQUAL = tuple(f"{p}|{m}" for p in ("StreamTriad+2DCONV", "Hotspot+Srad-v2", "NW+2DCONV", "ATAX+Srad-v2")
                        for m in ("online_single", "ours") if (p, m) != ("Hotspot+Srad-v2", "online_single"))
#: the suites whose rows come from integer cells alone (--bench-run holds them equal)
EXACT_SUITES = ("table1", "table2", "table3", "table4", "fig3")
_CELL_OF = re.compile(r"benchmark='([^']+)'")


def bench_run(dev, names) -> dict:
    """``python -m repro_torch.bench.run --scale quick --only <names>`` on
    ``dev``, in process: each suite's host seconds and launches (every count
    set to 0 just before it and read just after), its printed rows, which
    must equal the rows it returned and its CSV's, every protocol run it
    made by ``(suite, trace, mode, from a table, kind)`` (``current[0]``
    names the suite), and the context."""
    import csv
    import io

    from repro_torch import kernels
    from repro_torch.bench import run as BR

    suites, per, protocols, ctxs, current = dict(BR.SUITES), {}, {}, [], [None]

    def measured(name):
        def suite(ctx):
            if not ctxs:
                ctxs.append(ctx)
                plain = ctx.protocol

                def recording(w, mode, table=None, kind="transformer"):
                    res = plain(w, mode, table=table, kind=kind)
                    protocols[(current[0], getattr(w, "name", w), mode, table is not None, kind)] = res
                    return res

                ctx.protocol = recording
            current[0] = name
            _sync(dev)
            kernels.reset_launches()
            t0 = time.perf_counter()
            rows = suites[name](ctx)
            _sync(dev)
            per[name] = {"seconds": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES)}
            return rows
        return suite

    out = io.StringIO()
    BR.SUITES = {n: measured(n) for n in suites}
    try:
        with contextlib.redirect_stdout(out):
            rows = BR.main(["--scale", "quick", "--only", *names, "--device", dev.type])
    finally:
        BR.SUITES = suites
    printed, head = {}, None
    for ln in out.getvalue().splitlines():
        if ln.startswith("{"):
            printed[head].append(json.loads(ln))
        elif not ln.startswith("#"):
            head = ln.split(",", 1)[0]
            printed[head] = []
            print("  " + ln)
        else:
            print("  " + ln)
    check(list(printed.values()) == [json.loads(json.dumps(rows[n])) for n in names],
          "the printed rows are not the rows the driver returned")
    for head, n in zip(printed, names):
        with (BR.OUT_DIR / f"{head}.csv").open(newline="") as f:
            got = list(csv.DictReader(f))
        check(got == [{k: "" if v is None else str(v) for k, v in r.items()} for r in rows[n]],
              f"{head}.csv is not the printed rows")
    return {"rows": rows, "suites": per, "protocols": protocols, "ctx": ctxs[0], "current": current}


def ref_cells(*refs) -> dict:
    """The references' cells by ``(kind, workload, ...)``, a merge's
    ``WorkloadSpec`` by its benchmark name."""
    out = {}
    for ref in refs:
        for key, cell in ref["cells"].items():
            kind, w, *rest = key.split("|")
            m = _CELL_OF.search(w)
            out[(kind, m.group(1) if m else w, *rest)] = cell
    return out


def table7_distances(protocols: dict, cells: dict, suite: str = "table7") -> dict:
    """Table VII's protocol runs against the reference's cells."""
    from repro_torch.bench.tables import CONCURRENT_PAIRS

    out = {}
    for a, b in CONCURRENT_PAIRS:
        for mode, tail in (("online_single", ()), ("ours", ("chain_seed0=321", "link0"))):
            want = cells[("protocol", f"{a}+{b}", mode, *tail)]
            res = protocols[(suite, f"{a}+{b}", mode, mode == "ours", "transformer")]
            out[f"{a}+{b}|{mode}"] = protocol_distance(res, want)
    return out


def bench_run_path(dev) -> dict:
    """Phase 15: the driver (``repro_torch.bench.run``) at the quick preset on
    ``BENCH_RUN_ONLY`` against ``tables_quick_ref.json``: (a) Table I's rows
    equal; (b) Table VII's protocol runs equal where ``BENCH_RUN_EQUAL``
    says, else within phase 7 (b)'s limits; (c) the CSVs the printed rows;
    (d) ``evict_select`` launched in Table I, the attention, its backward and
    ``thrash_ce`` in Table VII, ``freq_update`` in neither; (e) seconds per
    suite.  Returns the launches of both suites together."""
    quick = json.loads(TABLES_QUICK_REF.read_text())
    got = bench_run(dev, BENCH_RUN_ONLY)
    check(got["rows"]["table1"] == quick["tables_rows"]["table1"], "Table I's quick rows differ from the JAX package's")
    dist = table7_distances(got["protocols"], ref_cells(quick))
    print("  (b) Table VII: " + json.dumps({k: {f: d[f] for f in ("top1", "top1_diff", "first_groups_acc_diff",
                                                                   "equal")} for k, d in dist.items()}))
    for name, d in dist.items():
        check_tuned(name, d, BENCH_RUN_EQUAL)
    suites = got["suites"]
    print("  (d), (e) " + json.dumps({n: {"seconds": v["seconds"], "launches": {k: c for k, c in v["launches"].items()
                                                                               if c}} for n, v in suites.items()}))
    bench_launch_checks(suites)
    return {k: sum(v["launches"][k] for v in suites.values()) for k in suites["table1"]["launches"]}


def bench_launch_checks(suites: dict) -> None:
    """Phase 15 (d)."""
    check(suites["table1"]["launches"]["evict_select"] > 0, "Table I never launched evict_select")
    for k in ("flash_attention", "flash_attention_bwd", "thrash_ce_fwd", "thrash_ce_bwd"):
        check(suites["table7"]["launches"][k] > 0, f"Table VII never launched {k}")
    check(all(v["launches"]["freq_update"] == 0 for v in suites.values()), "phase 15 launched freq_update")


def slot_sha256(params: dict) -> str:
    """``export_torch_reference.slot_params_sha256`` of a port slot."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(np.ascontiguousarray(params[k].detach().cpu().numpy(), "<f4").tobytes())
    return h.hexdigest()


def bench_run_all(dev) -> None:
    """``--bench-run``: ``repro_torch.bench.run``'s default order at the
    quick preset less ``fig11`` against ``tables_quick_ref.json`` and
    ``figures_quick_ref.json``
    (the rows of ``EXACT_SUITES`` and every simulator and UVMSmart cell
    equal, or it fails; every fine-tuned ``ours`` and protocol run's distance
    printed, those beyond phase 7 (b)'s limits listed), seconds per suite;
    then Fig. 11's route: the port pretrains ``PretrainSpec(0.24,
    seed0=123)`` itself and runs ``fig11`` from it, each slot and row
    against the JAX package's (recorded, not gated)."""
    from repro_torch.bench import figures as FG
    from repro_torch.bench import run as BR
    from repro_torch.uvm.api.session import pretrained_table
    from repro_torch.uvm.api.specs import PretrainSpec

    quick, figq = json.loads(TABLES_QUICK_REF.read_text()), json.loads(FIGURES_QUICK_REF.read_text())
    refs = {**quick["tables_rows"], **figq["figures_rows"]}
    cells = ref_cells(quick, figq)
    t0 = time.perf_counter()
    got = bench_run(dev, [n for n in BR.ORDER if n != "fig11"])
    total = time.perf_counter() - t0
    ctx, rows = got["ctx"], got["rows"]
    for n in EXACT_SUITES:
        check(rows[n] == refs[n], f"{n}'s rows differ from the JAX package's")
    bad = [(k, st) for k, st in ctx._sims.items() if isinstance(k[0], str)
           and st != cells.get(("sim", k[0], f"{k[1]}+{k[2]}", str(k[3])), {}).get("stats")]
    bad += [(k, st) for k, st in ctx._smart.items() if st != cells.get(("uvmsmart", k[0], str(k[1])), {}).get("stats")]
    check(not bad, f"simulator or UVMSmart cells differ from the JAX package's: {bad}")
    dist = {}
    for (name, _, os_, tenancy, thrash), res in ctx._ours.items():
        key = ("ours", name, str(os_), f"thrash={thrash}") + (() if tenancy == "mux" else (f"tenancy={tenancy}",))
        dist["|".join(key)] = run_distance(res, cells[key])
    for (suite, name, mode, tabled, kind), res in got["protocols"].items():
        key = ("protocol", name, mode) + (("chain_seed0=321", "link0") if tabled else ()) + (
            () if kind == "transformer" else (f"kind={kind}",))
        dist["|".join(key)] = protocol_distance(res, cells[key])
    outside = sorted(k for k, d in dist.items() if not d["equal"] and not within_limits(d))
    equal = sum(d["equal"] for d in dist.values())
    print(f"  {len(ctx._sims)} simulator cells, {len(ctx._smart)} UVMSmart runs and the rows of "
          f"{', '.join(EXACT_SUITES)} equal; fine-tuned runs: {equal} of {len(dist)} equal, outside phase 7 (b)'s "
          f"limits: {outside}")
    print("  distances: " + json.dumps({k: {f: d[f] for f in ("top1_diff", "first_groups_acc_diff", "equal")}
                                        for k, d in dist.items()}))
    for n in rows:
        want = refs[n]["rows"] if isinstance(refs[n], dict) else refs[n]  # Tables IX and X keep their runs beside
        if rows[n] != want:
            print(f"  {n}: rows differ (got, JAX's): " + json.dumps([[g, w] for g, w in zip(rows[n], want) if g != w]))
    print("  seconds: " + json.dumps({n: round(v["seconds"], 3) for n, v in got["suites"].items()})
          + f", total {total:.1f}")
    # Fig. 11's route: the port pretrains the quick table itself
    spec = figq["fig11_quick"]
    _sync(dev)
    t0 = time.perf_counter()
    table = pretrained_table(PretrainSpec(**spec["pretrain"]), ctx.pcfg, ctx.train, memo_dir=None, device=dev)
    _sync(dev)
    pretrain_s = time.perf_counter() - t0
    slots = {str(s): {"sha256_equal": slot_sha256(e.params) == spec["slots"][str(s)]["sha256"], "step": e.step,
                      "last_acc": e.last_acc, "jax": {k: spec["slots"][str(s)][k] for k in ("step", "last_acc")}}
             for s, e in sorted(table.slots.items())}
    print(f"  Fig. 11's table pretrained on {dev.type} in {pretrain_s:.1f} s (JAX on a CPU "
          f"{spec['pretrain_seconds']:.1f} s): " + json.dumps(slots))
    ctx._tables["fig11"] = table
    got["current"][0] = "fig11"
    t0 = time.perf_counter()
    fig11 = FG.fig11(ctx)
    links = [(k[1], r) for k, r in got["protocols"].items() if k[0] == "fig11" and k[3]]
    chain = {b: protocol_distance(r, cells[("protocol", b, "ours", "chain_seed0=123", f"link{i}")])
             for i, (b, r) in enumerate(links)}
    print(f"  fig11 from it in {time.perf_counter() - t0:.1f} s; rows: "
          + json.dumps([{k: [g[k], w[k]] for k in g if g[k] != w[k]} for g, w in zip(fig11, refs["fig11"])])
          + "; chain links: " + json.dumps({b: {f: d[f] for f in ("top1_diff", "first_groups_acc_diff", "equal")}
                                             for b, d in chain.items()}))


# --- phase 16: the hybrid family (zamba2-7b) and the two dense configs ---------------

ZAMBA2_REF = ROOT / "experiments" / "torch" / "serve_zamba2_ref.npz"
# phase 16 (a): the 15-layer zamba2 against the JAX package on a CPU (its SSD
# through the TPU kernel in interpret mode), limits set from a rehearsal of
# (a) on a CPU with the plain versions (scripts/rehearse_hybrid_cpu.py).  In
# bf16 the random-weight model is chaotic: swapping F.silu for the port's
# silu moves its prefill logits at the top-8 ids by 0.16 (0.34 anywhere) and
# the state norms per (layer, row) by 3.4%; the rehearsal was 0.34 and 1.5%
# from the reference, the reference's own two SSD routes 0.094 and 2.0%
# apart.  So bf16 is held within 0.75 (logits of about +-4) and rtol 0.1, and
# the same run in float32, where the rehearsal was 9.7e-5 and 3.1e-5 from the
# reference, within 1e-3 and rtol 5e-4: the card sums in other orders, and
# its float32 keys round to the bf16 cache on either side of an ulp
ZAMBA2_ATOL = {"bfloat16": 0.75, "float32": 1e-3}
ZAMBA2_NORM_RTOL = {"bfloat16": 0.1, "float32": 5e-4}
# (b): zamba2 at full depth, weights drawn on the card; (c): the dense configs
# at full width and two layers, weights drawn on the card
ZAMBA2_FULL = {"seed": 0, "prompt_seed": 1, "batch": 2, "prompt_len": 512, "n_new": 16}
DENSE_ARCHS = ("qwen1.5-4b", "granite-3-8b")
DENSE_RUN = {"num_layers": 2, "seed": 0, "prompt_seed": 1, "batch": 2, "prompt_len": 256, "n_new": 16}


def device_params(specs: dict, dev, seed: int) -> dict:
    """bf16 weights for ``specs``, drawn on ``dev`` from a ``torch.Generator``
    of that device in sorted key order with ``numpy_params``' initialisers
    (other numbers): for a model whose float32 masters are too large to draw
    on the host (zamba2-7b's largest tensor has 2.0 G elements)."""
    import torch

    from repro_torch.models.params import _std

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for path in sorted(specs):
        spec = specs[path].check(path)
        if spec.init in ("zeros", "ones"):
            out[path] = (torch.zeros if spec.init == "zeros" else torch.ones)(spec.shape, dtype=torch.bfloat16,
                                                                              device=dev)
        else:
            out[path] = torch.randn(spec.shape, generator=gen, dtype=torch.bfloat16, device=dev).mul_(_std(spec))
    return out


def launch_check(label: str, launches: dict, want: dict) -> None:
    """``launches`` has each of ``want``'s counts, and no other kernel launched."""
    for name, n in want.items():
        check(launches[name] == n, f"{label} launched {name} {launches[name]} times, not {n}")
    check(all(n == 0 for k, n in launches.items() if k not in want), f"{label} launched other kernels: {launches}")


def hybrid_launch_check(label: str, launches: dict, cfg, n_new: int, attn: str) -> None:
    """A hybrid serve run's launches: the attention kernel ``attn`` once per
    application of the shared block, ``ssd_scan`` once per Mamba-2 layer and
    ``decode_attention`` once per application and step, nothing else."""
    n_apps = cfg.num_layers // cfg.attn_every
    launch_check(label, launches, {attn: n_apps, "ssd_scan": cfg.num_layers, "decode_attention": n_apps * n_new})


def zamba2_reference_checks(dev):
    """Phase 16 (a) up to its bf16 free run: build the bf16 and float32
    engines of the reference's 15-layer zamba2, hold both to the reference
    teacher-forced, and the float32 free run to its forks.  Returns (the bf16
    engine, the reference, the prompt, the float32 free run's launches)."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import numpy_params
    from repro_torch.serving.engine import Engine

    ref, run = load_ref(ZAMBA2_REF)
    cfg = get_config(run["arch"]).replace(num_layers=run["num_layers"])
    S, n_new = run["prompt_len"], run["n_new"]
    prompt = np.random.default_rng(run["prompt_seed"]).integers(0, cfg.vocab_size, (run["batch"], S))
    check(hashlib.sha256(prompt.astype(np.int32).tobytes()).hexdigest() == str(ref["prompt_sha256"]),
          "the reference's prompt is not default_rng(1)'s")
    t0 = time.perf_counter()
    masters = {k: torch.from_numpy(v) for k, v in numpy_params(lm.param_specs(cfg), run["seed"]).items()}
    eng = Engine(cfg, masters, offload=run["offload"], hbm_fraction=run["hbm_fraction"], device=dev)
    eng32 = Engine(cfg.replace(dtype="float32"), masters, device=dev)
    del masters
    _sync(dev)
    print(f"  engines: {cfg.name} at {cfg.num_layers} layers (layout {cfg.num_layers // cfg.attn_every} x "
          f"{cfg.attn_every} + {cfg.num_layers % cfg.attn_every}), {lm.param_count(cfg):,} parameters, {cfg.dtype} "
          f"and float32, built in {time.perf_counter() - t0:.1f} s")
    check(eng.make_manager(S + n_new) is None and json.loads(str(ref["offload_stats"])) is None,
          "an offload manager for the hybrid family")

    # 1. teacher-forced, bf16 and float32: prefill + decode steps fed the reference's tokens
    ref32 = {k[4:]: v for k, v in ref.items() if k.startswith("f32_")}
    teacher_forced_ssm(eng, ref, prompt, ZAMBA2_ATOL["bfloat16"], ZAMBA2_NORM_RTOL["bfloat16"], dev, "bf16")
    teacher_forced_ssm(eng32, ref32, prompt, ZAMBA2_ATOL["float32"], ZAMBA2_NORM_RTOL["float32"], dev, "float32")
    # 2. the float32 free run: the reference's float32 tokens up to a fork, by the fork rule; launches from here only
    _sync(dev)
    kernels.reset_launches()
    with torch.no_grad():
        res32 = eng32.generate({"tokens": prompt}, ref32["tokens"].shape[1])
    _sync(dev)
    launches32 = dict(kernels.LAUNCHES)
    forks32 = fork_check(res32.tokens, ref32, ZAMBA2_ATOL["float32"])
    print(f"  float32 free run: {res32.tokens.shape[1]} tokens, forks {json.dumps(forks32)}")
    return eng, ref, prompt, launches32


def _recording_finite(fn, seen: list):
    """``fn`` (a prefill or decode step) with whether its logits are all
    finite appended to ``seen``."""
    import torch

    def wrapper(*a):
        logits, cache = fn(*a)
        seen.append(bool(torch.isfinite(logits).all()))
        return logits, cache
    return wrapper


def serve_timed(eng, prompt, n_new: int, pad_to: int | None = None) -> tuple:
    """``eng.generate`` as ``launch.serve`` drives it, with launch counts from
    its start, host seconds of its prefill and decode steps, and every
    step's logits checked finite.  Returns (the result, the launches, the
    numbers to print)."""
    import torch

    from repro_torch import kernels

    spent = {"prefill": 0.0, "decode": 0.0}
    finite: list = []
    originals = {"prefill": eng.prefill, "decode": eng.decode}
    eng.prefill, eng.decode = (_recording_finite(timed(spent, k, f), finite) for k, f in originals.items())
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            res = eng.generate({"tokens": prompt}, n_new, pad_to=pad_to)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        eng.prefill, eng.decode = originals.values()
    check(len(finite) == n_new + 1 and all(finite), f"{eng.cfg.name}: non-finite logits in a serve run ({finite})")
    return res, launches, {"prefill_s": spent["prefill"], "decode_ms_per_step": spent["decode"] / n_new * 1e3,
                           "wall_s": wall, "tokens_per_s": res.tokens.size / wall, "launches": launches}


def zamba2_full_depth(dev, num_layers: int = 81) -> dict:
    """Phase 16 (b): zamba2-7b at full width and depth (81 layers; fewer
    only to rehearse it), bf16 weights drawn on the card, a (2, 512) prompt
    and 16 decode steps."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg, run = get_config("zamba2-7b").replace(num_layers=num_layers), ZAMBA2_FULL
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, device_params(lm.param_specs(cfg), dev, run["seed"]), device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    prompt = np.random.default_rng(run["prompt_seed"]).integers(0, cfg.vocab_size, (run["batch"], run["prompt_len"]))
    res, launches, out = serve_timed(eng, prompt, run["n_new"])
    out.update({"layers": cfg.num_layers, "parameters": lm.param_count(cfg), "weights_gb": sum(
        t.numel() * t.element_size() for t in eng.params.values()) / 1e9, "draw_s": draw_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "first_tokens": res.tokens[:, :4].tolist()})
    print("  (b) full depth: " + json.dumps(out))
    hybrid_launch_check("the 81-layer zamba2 run", launches, cfg, run["n_new"], "flash_attention_bf16")
    return launches


def dense_config_run(dev, arch: str) -> dict:
    """Phase 16 (c) and 17 (c): a config at full width and ``DENSE_RUN``'s
    depth, bf16 weights drawn on the card, served without an offload
    manager; then the bf16 flash and decode kernels at its attention
    shapes against their plain versions, and a dropped key rejected by the
    decode limit."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    run = DENSE_RUN
    cfg = get_config(arch).replace(num_layers=run["num_layers"])
    eng = Engine(cfg, device_params(lm.param_specs(cfg), dev, run["seed"]), device=dev)
    B, S, n_new = run["batch"], run["prompt_len"], run["n_new"]
    prompt = np.random.default_rng(run["prompt_seed"]).integers(0, cfg.vocab_size, (B, S))
    res, launches, out = serve_timed(eng, prompt, n_new)
    L = cfg.num_layers
    launch_check(f"the {arch} serve run", launches, {"flash_attention_bf16": L, "decode_attention": L * n_new})
    del eng
    # the kernels at this model's shapes (the comparisons launch them; they count nowhere)
    Kh, G, D = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(7)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=torch.bfloat16)  # noqa: E731
    q, k, v = mk(B, S, Kh, G, D), mk(B, S, Kh, D), mk(B, S, Kh, D)
    flash_err, flash_need = bf16_err(FA.flash_attention(q, k, v), FA.attend_chunked(q, k, v), FLASH_RTOL)
    check(flash_need <= FLASH_ATOL, f"{arch}: flash_attention (bf16) at (B {B}, S {S}, K {Kh}, G {G}, D {D}) differs "
          f"from plain: max |err| {flash_err}, atol needed {flash_need} > {FLASH_ATOL}")
    T = S + n_new
    q, k, v = mk(B, Kh, G, D), mk(B, T, Kh, D), mk(B, T, Kh, D)
    dec_err, dec_need = bf16_err(DA.decode_attention_kernelcall(q, k, v, T), DA.decode_attention_plain(q, k, v, T),
                                 DECODE_RTOL)
    check(dec_need <= DECODE_ATOL_SHORT, f"{arch}: decode_attention (bf16) at (B {B}, K {Kh}, G {G}, D {D}, T {T}) "
          f"differs from plain: max |err| {dec_err}, atol needed {dec_need} > {DECODE_ATOL_SHORT}")
    dropped_need = decode_drop_control(q, k, v, T, DECODE_RTOL, DECODE_ATOL_SHORT, f"{arch}: decode_attention (bf16)")
    out.update({"arch": arch, "layers": L, "parameters": lm.param_count(cfg), "K": Kh, "G": G, "D": D,
                "flash_max_abs_err": flash_err, "flash_atol_needed": flash_need, "decode_max_abs_err": dec_err,
                "decode_atol_needed": dec_need, "decode_dropped_key_atol_needed": dropped_need,
                "first_tokens": res.tokens[:, :4].tolist()})
    print(f"  (c) {arch}: " + json.dumps(out))
    return launches


def hybrid_path(dev) -> dict:
    """Phase 16: (a) the 15-layer zamba2 against ``serve_zamba2_ref.npz``,
    (b) zamba2 at full depth, (c) the two dense configs.  Returns the
    launches of each serve run, by path."""
    import gc

    import numpy as np
    import torch

    eng, ref, prompt, launches32 = zamba2_reference_checks(dev)
    cfg = eng.cfg
    hybrid_launch_check("the float32 free run", launches32, cfg, int(ref["f32_tokens"].shape[1]), "flash_attention")
    # 3. the bf16 free run, as launch/serve drives it
    n_new = ref["tokens"].shape[1]
    torch.cuda.reset_peak_memory_stats(dev)
    res, launches, out = serve_timed(eng, prompt, n_new)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print("  free run: " + json.dumps(out))
    forks = fork_check(res.tokens, ref, ZAMBA2_ATOL["bfloat16"])
    print("  forks: " + json.dumps(forks))
    check(res.offload_stats is None, f"the hybrid family reported offload stats {res.offload_stats}")
    hybrid_launch_check("the bf16 free run", launches, cfg, n_new, "flash_attention_bf16")
    res2 = profile_run("serve zamba2", lambda: eng.generate({"tokens": prompt}, 8))
    check(np.array_equal(res2.tokens, res.tokens[:, :8]), "the profiled zamba2 serve run gave other tokens")
    del eng
    gc.collect()
    by_path = {"serve_zamba2": launches, "serve_zamba2_f32": launches32,
               "serve_zamba2_81": zamba2_full_depth(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    for arch in DENSE_ARCHS:
        by_path[f"serve_{arch}"] = dense_config_run(dev, arch)
    return by_path


# --- phase 17: the mixture-of-experts family and qk_norm ----------------------------

OLMOE_REF = ROOT / "experiments" / "torch" / "serve_olmoe_ref.npz"
# (a): the 2-layer olmoe against the JAX reference; limits from
# scripts/rehearse_moe_cpu.py (PERF.md §2)
MOE_ATOL = {"bfloat16": 1.0, "float32": 2e-3}
MOE_MASS_RTOL = 1e-2
# the prefill layers whose float32 routes equal JAX's by SHA-256 in the CPU rehearsal: the card must too
MOE_ROUTES_EQUAL_F32 = (0, 1)
# (b): olmoe at full depth, bf16 weights drawn on the card; (c): at DENSE_RUN
MOE_FULL = {"seed": 0, "prompt_seed": 1, "batch": 2, "prompt_len": 512, "n_new": 16}
MOE_CONFIGS = ("qwen2-moe-a2.7b", "qwen3-0.6b")
# phase 3's instances at head width 128 (the MoE family's and qwen3's
# attention), each counted on the paths that run it
MOE_PATHS = {"bfloat16": ("serve_olmoe", "serve_olmoe_16", "serve_qwen2-moe-a2.7b"), "float32": ("serve_olmoe_f32",),
             "g2": ("serve_qwen3-0.6b",)}
MOE_FLASH_CASES = [((2, 512, 512, 16, 1, 128), {}), ((1, 100, 130, 4, 1, 128), {"q_offset": 30}),
                   ((1, 65, 63, 2, 1, 128), {"kv_len": 40, "causal": False})]
QWEN3_FLASH_CASES = [((2, 256, 256, 8, 2, 128), {}), ((1, 100, 130, 4, 2, 128), {"q_offset": 30}),
                     ((1, 65, 63, 2, 2, 128), {"kv_len": 40, "causal": False})]
MOE_DECODE_CASES = [((2, 16, 1, 128, 544), n) for n in (1, 512, 513, 544)]
QWEN3_DECODE_CASES = [((2, 8, 2, 128, 272), n) for n in (1, 256, 257, 272)]


def moe_kernel_rows(dev) -> list[dict]:
    """The attention kernels at head width 128 at olmoe-1b-7b's prefill and
    decode shapes (K 16, G 1) in each dtype its serve runs use, and the bf16
    ones at qwen3-0.6b's (K 8, G 2); bf16 decode within ``DECODE_ATOL_D128``
    and ``DECODE_ATOL_SHORT``."""
    bf, f32, g2 = MOE_PATHS["bfloat16"], MOE_PATHS["float32"], MOE_PATHS["g2"]
    return [kernel_flash_attention(dev, MOE_FLASH_CASES, ("@D128", f32)),
            kernel_flash_attention_bf16(dev, MOE_FLASH_CASES, drop_kv_len=500, instance=("@D128", bf)),
            kernel_flash_attention_bf16(dev, QWEN3_FLASH_CASES, drop_kv_len=250, instance=("@D128G2", g2)),
            kernel_decode_attention(dev, MOE_DECODE_CASES, "bfloat16", DECODE_ATOL_D128, drop_at=544,
                                    instance=("@D128", bf)),
            kernel_decode_attention(dev, QWEN3_DECODE_CASES, "bfloat16", DECODE_ATOL_SHORT, drop_at=272,
                                    instance=("@D128G2", g2)),
            kernel_decode_attention(dev, MOE_DECODE_CASES, "float32", drop_at=544, instance=("@D128_f32", f32))]


@contextlib.contextmanager
def port_routes():
    """While open, every call of the port's MoE routing appends its (expert
    ids (T, k), kept (T*k,)) as host arrays to the yielded list."""
    from repro_torch.models import moe

    rec, route = [], moe.route

    def recording(router, xf, cfg):
        r = route(router, xf, cfg)
        rec.append((r.idx.cpu().numpy(), r.keep.cpu().numpy()))
        return r

    moe.route = recording
    try:
        yield rec
    finally:
        moe.route = route


def route_distances(routes, ref, prefix: str, n_experts: int) -> list[dict]:
    """Each prefill layer's routing against the reference's: its SHA-256 of
    (ids as int32, kept as uint8) equal or not, the summed |load
    difference| over the experts and both counts of dropped choices."""
    import hashlib

    import numpy as np

    out = []
    for layer, (idx, keep) in enumerate(routes):
        sha = hashlib.sha256(idx.astype(np.int32).tobytes() + keep.astype(np.uint8).tobytes()).hexdigest()
        loads = np.bincount(idx.reshape(-1), minlength=n_experts)
        out.append({"layer": layer, "sha_equal": sha == str(ref[f"{prefix}route_sha256"][layer]),
                    "load_diff": int(np.abs(loads - ref[f"{prefix}route_loads"][layer]).sum()),
                    "dropped": int((~keep).sum()), "ref_dropped": int(ref[f"{prefix}route_dropped"][layer])})
    return out


def teacher_forced_moe(eng, ref, prompt, pad_to: int, atol: float, dev, label: str, mass: bool) -> list[dict]:
    """Prefill the prompt (its routing recorded) and decode the reference's
    tokens; hold every step's logits to the reference's (``logit_checker``)
    and, with ``mass``, each step's page masses within ``MOE_MASS_RTOL``.
    Returns the prefill's route distances."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    prefix = "" if label == "bf16" else "f32_"
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)} if prefix else ref
    compare, seen = logit_checker(want, atol, dev)
    S, n_new, mass_err = prompt.shape[1], want["tokens"].shape[1], 0.0
    with torch.no_grad(), port_routes() as rec:
        logits, cache = eng.prefill(eng.params, {"tokens": torch.tensor(prompt, device=dev)})
        routes = rec[:eng.cfg.num_layers]
    with torch.no_grad():
        cache = eng._grow_cache(cache, pad_to)
        compare(0, logits)
        for i in range(n_new):
            logits, cache = eng.decode(eng.params, {"token": torch.tensor(want["tokens"][:, i], device=dev),
                                                    "pos": S + i}, cache)
            compare(i + 1, logits)
            if mass:
                got, _ = eng.page_mass(cache, S + i, int(ref["n_pages"]))
                w = ref["page_mass"][i].astype(np.float64)
                mass_err = max(mass_err, float((np.abs(got - w) / np.maximum(np.abs(w), 1e-30))[w > 0].max()))
    check(mass_err <= MOE_MASS_RTOL, f"{label}: page mass differs from the reference's by rtol {mass_err} > "
          f"{MOE_MASS_RTOL}")
    dist = route_distances(routes, ref, prefix, moe.padded_experts(eng.cfg))
    errs = seen["errs"]
    print(f"  {label} teacher-forced: {n_new + 1} steps, logits at the reference's top-8 ids within "
          f"{max(errs):.4g} (atol {atol}; mean of per-step max {np.mean(errs):.4g}), top-1 equal at "
          f"{seen['top1_checked']} of {(n_new + 1) * len(prompt)} (row, step)s whose margin exceeds {2 * atol}"
          + (f"; page mass within rtol {mass_err:.3g} ({MOE_MASS_RTOL})" if mass else "")
          + "; prefill routes " + json.dumps(dist))
    return dist


def moe_reference_checks(dev):
    """Phase 17 (a) up to its bf16 free run: the bf16 and float32 engines of
    the reference's 2-layer olmoe held teacher-forced, routes compared, the
    reference's page masses replayed through the ``learned`` and ``lru``
    managers, and the float32 free run by the fork rule.  Returns (the bf16
    engine, the reference, its run record, the prompt, the float32 free
    run's launches)."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import numpy_params
    from repro_torch.serving.engine import OFFLOAD_KINDS, Engine

    ref, run = load_ref(OLMOE_REF)
    cfg = get_config(run["arch"]).replace(num_layers=run["num_layers"])
    S, pad_to = run["prompt_len"], run["pad_to"]
    prompt = np.random.default_rng(run["prompt_seed"]).integers(0, cfg.vocab_size, (run["batch"], S))
    check(hashlib.sha256(prompt.astype(np.int32).tobytes()).hexdigest() == str(ref["prompt_sha256"]),
          "the reference's prompt is not default_rng(1)'s")
    t0 = time.perf_counter()
    masters = {k: torch.from_numpy(v) for k, v in numpy_params(lm.param_specs(cfg), run["seed"]).items()}
    eng = Engine(cfg, masters, offload=run["offload"], hbm_fraction=run["hbm_fraction"], device=dev)
    eng32 = Engine(cfg.replace(dtype="float32"), masters, offload=run["offload"], hbm_fraction=run["hbm_fraction"],
                   device=dev)
    del masters
    _sync(dev)
    print(f"  engines: {cfg.name} at {cfg.num_layers} layers, {lm.param_count(cfg):,} parameters, bf16 and float32, "
          f"built in {time.perf_counter() - t0:.1f} s")
    mgr = eng.make_manager(pad_to)
    check((mgr.n_pages, mgr.capacity) == (int(ref["n_pages"]), int(ref["capacity"])),
          "the KV page pool differs from the reference's")
    dist = teacher_forced_moe(eng, ref, prompt, pad_to, MOE_ATOL["bfloat16"], dev, "bf16", mass=True)
    dist32 = teacher_forced_moe(eng32, ref, prompt, pad_to, MOE_ATOL["float32"], dev, "float32", mass=False)
    for layer in MOE_ROUTES_EQUAL_F32:
        check(dist32[layer]["sha_equal"], f"float32 prefill layer {layer}: routes differ from the reference's "
              f"({dist32[layer]})")
    replay = {}
    for kind in ("learned", "lru"):
        m = OFFLOAD_KINDS[kind](mgr.n_pages, mgr.capacity, device=dev)
        for mass, touched in zip(ref["page_mass"].astype(np.float64), ref["touched"]):
            m.on_attention(mass, np.nonzero(touched)[0])
        got, want = dataclasses.asdict(m.stats), dict(zip(ref["stat_keys"].tolist(), ref[f"{kind}_stats"].tolist()))
        check(got == want, f"replayed {kind} stats {got} != JAX reference {want}")
        replay[kind] = got
    print(f"  replay: offload stats equal the JAX reference's exactly: {json.dumps(replay)}")
    n32 = ref["f32_tokens"].shape[1]
    _sync(dev)
    kernels.reset_launches()
    with torch.no_grad():
        res32 = eng32.generate({"tokens": prompt}, n32, pad_to=pad_to)
    _sync(dev)
    launches32 = dict(kernels.LAUNCHES)
    forks32 = fork_check(res32.tokens, {k[4:]: v for k, v in ref.items() if k.startswith("f32_")}, MOE_ATOL["float32"])
    stats_equal = res32.offload_stats == dict(zip(ref["stat_keys"].tolist(), ref["f32_learned_stats"].tolist()))
    print(f"  float32 free run: {n32} tokens, forks {json.dumps(forks32)}, offload stats {res32.offload_stats} "
          f"({'equal to' if stats_equal else 'other than'} the reference's)")
    return eng, ref, run, prompt, launches32


def olmoe_full_depth(dev, num_layers: int = 16) -> dict:
    """Phase 17 (b): olmoe-1b-7b at full width and depth (16 layers; fewer
    only to rehearse it), bf16 weights drawn on the card, a (2, 512) prompt
    and 16 decode steps with the ``learned`` offload."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg, run = get_config("olmoe-1b-7b").replace(num_layers=num_layers), MOE_FULL
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, device_params(lm.param_specs(cfg), dev, run["seed"]), offload="learned", device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    prompt = np.random.default_rng(run["prompt_seed"]).integers(0, cfg.vocab_size, (run["batch"], run["prompt_len"]))
    res, launches, out = serve_timed(eng, prompt, run["n_new"])
    out.update({"layers": cfg.num_layers, "parameters": lm.param_count(cfg), "weights_gb": sum(
        t.numel() * t.element_size() for t in eng.params.values()) / 1e9, "draw_s": draw_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "offload_stats": res.offload_stats,
        "first_tokens": res.tokens[:, :4].tolist()})
    print("  (b) full depth: " + json.dumps(out))
    L, n_new = cfg.num_layers, run["n_new"]
    launch_check(f"the {L}-layer olmoe run", launches, {"flash_attention_bf16": L, "decode_attention": L * n_new,
                                                        "freq_update": n_new})
    return launches


def moe_path(dev) -> dict:
    """Phase 17: (a) the 2-layer olmoe against ``serve_olmoe_ref.npz``, (b)
    olmoe at full depth, (c) qwen2-moe-a2.7b and qwen3-0.6b at two layers.
    Returns the launches of each serve run, by path."""
    import gc

    import numpy as np
    import torch

    eng, ref, run, prompt, launches32 = moe_reference_checks(dev)
    L, pad_to = eng.cfg.num_layers, run["pad_to"]
    n32, n_new = ref["f32_tokens"].shape[1], ref["tokens"].shape[1]
    launch_check("the float32 free run", launches32, {"flash_attention": L, "decode_attention": L * n32,
                                                      "freq_update": n32})
    torch.cuda.reset_peak_memory_stats(dev)
    res, launches, out = serve_timed(eng, prompt, n_new, pad_to=pad_to)
    out.update({"peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "offload_stats": res.offload_stats,
                "forks": fork_check(res.tokens, ref, MOE_ATOL["bfloat16"])})
    print("  bf16 free run: " + json.dumps(out))
    launch_check("the bf16 free run", launches, {"flash_attention_bf16": L, "decode_attention": L * n_new,
                                                 "freq_update": n_new})
    res2 = profile_run("serve olmoe", lambda: eng.generate({"tokens": prompt}, 8, pad_to=pad_to))
    check(np.array_equal(res2.tokens, res.tokens[:, :8]), "the profiled olmoe serve run gave other tokens")
    del eng
    gc.collect()
    by_path = {"serve_olmoe": launches, "serve_olmoe_f32": launches32, "serve_olmoe_16": olmoe_full_depth(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    for arch in MOE_CONFIGS:
        by_path[f"serve_{arch}"] = dense_config_run(dev, arch)
    return by_path


class PhaseProcess:
    """Phase ``n`` in a process of its own (``chip_smoke.py --phase-<n>``), so
    that it runs beside later phases of this one; its output goes to a
    temporary file until :meth:`result`, which waits for it."""

    def __init__(self, n: int):
        import tempfile

        self.n, self.key = n, f"phase_{n}_launches"
        self.log = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), f"--phase-{n}"],
                                     stdout=self.log, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT))

    def result(self, timeout: float = 600) -> tuple[dict, float]:
        """Wait, relay its phase lines, and return its launches and seconds;
        raises :class:`SmokeFailure` if it failed."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            self.kill()
        self.log.seek(0)
        lines = self.log.read().splitlines()
        self.log.close()
        body = lines[next((i + 1 for i, ln in enumerate(lines) if ln.startswith("[2/17]")), 0):]
        for ln in body:
            if not ln.startswith("{") and f"phase {self.n} alone took" not in ln:
                print(ln)
        last = json.loads(lines[-1]) if rc == 0 and lines and lines[-1].startswith("{") else {}
        check(self.key in last, f"phase {self.n}'s process exited with {rc}: " + "\n".join(lines[-20:]))
        return last[self.key], last["seconds"]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--time-flash-bf16", metavar="LABEL",
                    help="after the build, only time the bf16 flash kernel and print one line headed LABEL")
    ap.add_argument("--time-kernels", metavar="LABEL",
                    help="after the build, only run phase 3's rows of evict_select, freq_table, the float32 "
                         "flash_attention forward and backward, ssd_scan and thrash_ce, and the wrappers' host steps, "
                         "and print one JSON line headed LABEL")
    ap.add_argument("--time-training", metavar="LABEL",
                    help="after the build, only time phase 7's fine-tune group (five times) and the fine-tuned "
                         "run_ours (once) and print one JSON line headed LABEL")
    ap.add_argument("--experiment-api", action="store_true",
                    help="after the build, run phase 13 alone (no result line)")
    ap.add_argument("--server", action="store_true",
                    help="after the build, run phase 14 alone, and a cli server that builds the kernels into an "
                         "empty AOT cache (no result line)")
    ap.add_argument("--bench-run", action="store_true",
                    help="after the build, run repro_torch.bench.run's quick order less fig11 against the quick "
                         "references, then Fig. 11's route (no result line)")
    ap.add_argument("--phase-9", action="store_true",
                    help="after the build, run phase 9 alone and print its launches as the last line (the full "
                         "script runs this beside phase 8)")
    ap.add_argument("--phase-15", action="store_true",
                    help="after the build, run phase 15 alone and print its launches as the last line (the full "
                         "script runs this beside phases 10-14)")
    ap.add_argument("--hybrid", action="store_true",
                    help="after the build, run phase 3's rows at zamba2-7b's shapes and phase 16 alone (no result "
                         "line)")
    ap.add_argument("--phase-16", action="store_true",
                    help="after the build, run phase 16 alone and print its launches as the last line (the full "
                         "script runs this beside phases 8-15)")
    ap.add_argument("--moe", action="store_true",
                    help="after the build, run phase 3's rows at head width 128 and phase 17 alone (no result line)")
    ap.add_argument("--phase-17", action="store_true",
                    help="after the build, run phase 17 alone and print its launches as the last line (the full "
                         "script runs this beside phases 10-16)")
    ap.add_argument("--phase-14", action="store_true",
                    help="after the build, run phase 14 alone and print its launches as the last line (the full "
                         "script runs this beside phases 10-13)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels._lib import LIBRARY
    except ImportError as exc:
        print(f"chip_smoke: the port (src/repro_torch) is not next to this script: {exc}", file=sys.stderr)
        return 2
    start = time.perf_counter()
    phase9 = phase14 = phase15 = phase16 = phase17 = None
    try:
        dev = torch.device("cuda", 0)
        name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = nvidia_smi_line()
        print(f"[1/17] device: {name} (count {count}); nvidia-smi: {smi}")
        print(f"      torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

        t0 = time.perf_counter()
        LIBRARY.cdll()
        how = "built" if LIBRARY.build_seconds is not None else "loaded the existing build"
        print(f"[2/17] build: {how} {LIBRARY.path().name} in {time.perf_counter() - t0:.1f} s")
        for line in LIBRARY.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line or line.startswith("=="):
                print("      " + line.strip())
        if args.time_flash_bf16 is not None:
            time_flash_bf16(dev, args.time_flash_bf16)
            return 0
        if args.time_kernels is not None:
            time_kernels(dev, args.time_kernels)
            return 0
        if args.time_training is not None:
            time_training(dev, args.time_training)
            return 0
        if args.experiment_api:
            t13 = time.perf_counter()
            launches = experiment_api_path(dev)
            print(f"      phase 13 alone took {time.perf_counter() - t13:.1f} s; launches "
                  + json.dumps({k: c for k, c in launches.items() if c}))
            return 0

        if args.bench_run:
            bench_run_all(dev)
            print(smi)
            return 0
        if args.server or args.phase_14:
            t14 = time.perf_counter()
            launches = server_path(dev, aot_miss=args.server)
            print(f"      phase 14 alone took {time.perf_counter() - t14:.1f} s; launches "
                  + json.dumps({k: c for k, c in launches.items() if c}))
            if args.phase_14:
                print(json.dumps({"phase_14_launches": launches, "seconds": time.perf_counter() - t14}))
            return 0
        if args.hybrid or args.phase_16:
            t16 = time.perf_counter()
            if args.hybrid:
                for r in zamba2_kernel_rows(dev):
                    print(f"  {r['name']:24s} {r['shape']}: kernel {r['ms']:.4f} ms/call (device {r['device_ms']}), "
                          f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
            launches = hybrid_path(dev)
            print(f"      phase 16 alone took {time.perf_counter() - t16:.1f} s; launches " + json.dumps(
                {path: {k: c for k, c in counts.items() if c} for path, counts in launches.items()}))
            if args.phase_16:
                print(json.dumps({"phase_16_launches": launches, "seconds": time.perf_counter() - t16}))
            return 0
        if args.moe or args.phase_17:
            t17 = time.perf_counter()
            if args.moe:
                for r in moe_kernel_rows(dev):
                    print(f"  {r['name']:24s} {r['shape']}: kernel {r['ms']:.4f} ms/call (device {r['device_ms']}), "
                          f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
            launches = moe_path(dev)
            print(f"      phase 17 alone took {time.perf_counter() - t17:.1f} s; launches " + json.dumps(
                {path: {k: c for k, c in counts.items() if c} for path, counts in launches.items()}))
            if args.phase_17:
                print(json.dumps({"phase_17_launches": launches, "seconds": time.perf_counter() - t17}))
            return 0
        if args.phase_9:
            t9 = time.perf_counter()
            launches = concurrent_path(dev)
            print(f"      phase 9 alone took {time.perf_counter() - t9:.1f} s")
            print(json.dumps({"phase_9_launches": launches, "seconds": time.perf_counter() - t9}))
            return 0
        if args.phase_15:
            t15 = time.perf_counter()
            launches = bench_run_path(dev)
            print(f"      phase 15 alone took {time.perf_counter() - t15:.1f} s")
            print(json.dumps({"phase_15_launches": launches, "seconds": time.perf_counter() - t15}))
            return 0

        print(f"[3/17] kernels against their plain versions on the card (at {time.perf_counter() - start:.0f} s)")
        rows = [kernel_evict_select(dev), *kernel_freq_table(dev), kernel_flash_attention(dev),
                kernel_flash_attention_bf16(dev), kernel_flash_attention_bwd(dev), kernel_decode_attention(dev),
                kernel_ssd_scan(dev), *kernel_thrash_ce(dev), *zamba2_kernel_rows(dev), *moe_kernel_rows(dev)]
        thrash_ce_checks(dev, rows)
        for r in rows:
            print(f"  {r['name']:24s} {r['shape']}: kernel {r['ms']:.4f} ms/call (device {r['device_ms']}), "
                  f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
        by_name = {r["name"]: r for r in rows}
        es, tf = by_name["evict_select"], by_name["thrash_ce_fwd"]
        print(f"  evict_select at n_evict 64: {es['ms_n64']:.4f} ms/call (device {es['device_ms_n64']}); at 0: "
              f"device {es['device_ms_n0']}")
        ss = by_name["ssd_scan"]
        print(f"  ssd_scan in float32 at the same shape: {ss['ms_f32']:.4f} ms/call (device {ss['device_ms_f32']})")
        print(f"  thrash_ce step (forward + backward through autograd): {tf['step_ms']:.4f} ms, cross_entropy's "
              f"{tf['step_library_ms']:.4f} ms; device operations per forward {tf['device_ops_per_call']}, per "
              f"step {tf['step_device_ops_per_call']}")

        by_path = {}
        print(f"[4/17] main path: run_ours, Hotspot x1.5, CONFIG, frozen table, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        _, by_path["run_ours"] = main_path(dev)
        print(f"[5/17] serve: Engine.generate, qwen2-0.5b full width, bf16, learned KV offload, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        by_path["serve"], qwen2_engine, qwen2_prompt = serve_path(dev)
        print(f"[6/17] serve mamba2: Engine.generate, mamba2-370m full width, bf16, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        by_path["serve_mamba2"] = serve_mamba2_path(dev)
        print(f"[7/17] train: one train_group, the fine-tuned run_ours (Hotspot x1.5, CONFIG, TrainConfig()) and the "
              f"manager KV offload (qwen2-0.5b full width), on the card (at {time.perf_counter() - start:.0f} s)")
        by_path["train_group"] = train_group_check(dev)
        print(f"      (b) at {time.perf_counter() - start:.0f} s")
        by_path["run_ours_fine_tuned"] = fine_tuned_check(dev)
        print(f"      (c) at {time.perf_counter() - start:.0f} s")
        by_path["serve_manager"] = serve_manager_check(dev, qwen2_engine, qwen2_prompt)
        del qwen2_engine
        t16 = time.perf_counter()
        phase9, phase16 = PhaseProcess(9), PhaseProcess(16)
        print(f"[8/17] tables: the table runner at the paper preset, x1.25, 11 benchmarks (five simulator cells, "
              f"UVMSmart, frozen ours; fine-tuned ours on {len(TABLES_TUNED)}), on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        by_path["table6"], tables_ctx, tables_tuned = tables_path(dev)
        t9 = time.perf_counter()
        print(f"[9/17] concurrent: Tables VII and VIII's cells, four pairs at the paper preset, x1.25 (frozen mux and "
              f"merged on all four; fine-tuned and Table VII on {', '.join(CONCURRENT_TUNED)}), on the card, in a "
              f"process started with phase 8 (at {time.perf_counter() - start:.0f} s)")
        by_path["concurrent"], seconds = phase9.result()
        print(f"      phase 9 took {seconds:.1f} s beside phase 8, and {time.perf_counter() - t9:.1f} s more here")
        t10 = time.perf_counter()
        phase14, phase15, phase17 = PhaseProcess(14), PhaseProcess(15), PhaseProcess(17)
        print(f"[10/17] figures: Figs. 3, 12, 13 and 14's cells on {', '.join(FIG3_BENCH)} and Figs. 4 and 11's "
              f"protocols on {FIG_TUNED} at the paper preset, on the card (at {t10 - start:.0f} s)")
        by_path["figures"] = figures_path(dev, tables_ctx, tables_tuned)
        print(f"      phase 10 took {time.perf_counter() - t10:.1f} s")
        t11 = time.perf_counter()
        print(f"[11/17] zoo and QoS: the JAX package's initial weights, Fig. 10's four predictor kinds on "
              f"{FIG10_BENCH}, Table IX's first drift trace, Table X's StreamTriad+RandomScan under budgets and the "
              f"random policy, on the card (at {t11 - start:.0f} s)")
        by_path["zoo_qos"] = zoo_qos_path(dev)
        print(f"      phase 11 took {time.perf_counter() - t11:.1f} s; launches "
              + json.dumps({k: c for k, c in by_path["zoo_qos"].items() if c}))
        t12 = time.perf_counter()
        print(f"[12/17] fault tolerance: snapshots of the manager (Hotspot frozen, ATAX fine-tuned), the mux "
              f"(StreamTriad+2DCONV) and the KV offload, the health machine under chaos, plug-ins through run_batch "
              f"and the fault log, on the card (at {t12 - start:.0f} s)")
        by_path["fault_tolerance"] = fault_tolerance_path(dev)
        print(f"      phase 12 took {time.perf_counter() - t12:.1f} s; launches "
              + json.dumps({k: c for k, c in by_path["fault_tolerance"].items() if c}))
        t13 = time.perf_counter()
        print(f"[13/17] experiment API: cli sweep, sweep --spec, run, export, serve (checkpoint and resume) and "
              f"report on a temporary run store, and run_ours_many over {', '.join(API_LANES)} and "
              f"{'+'.join(API_PAIR)}, on the card (at {t13 - start:.0f} s)")
        by_path["experiment_api"] = experiment_api_path(dev, tables_ctx)
        print(f"      phase 13 took {time.perf_counter() - t13:.1f} s; launches "
              + json.dumps({k: c for k, c in by_path["experiment_api"].items() if c}))
        t14 = time.perf_counter()
        print(f"[14/17] server: FaultStreamServer in every dispatch mode with run_loadgen's clients on the drift and "
              f"churn logs, a stacked evaluate_many and train_group_many at CONFIG, isolation, kill -9 and --resume of "
              f"cli server with its AOT cache, and load, on the card, in a process started with phase 10 (at "
              f"{t14 - start:.0f} s)")
        by_path["server"], seconds = phase14.result()
        print(f"      phase 14 took {seconds:.1f} s beside phases 10-13, and {time.perf_counter() - t14:.1f} s more "
              "here; launches " + json.dumps({k: c for k, c in by_path["server"].items() if c}))
        t15 = time.perf_counter()
        print(f"[15/17] benchmark driver: python -m repro_torch.bench.run --scale quick --only "
              f"{' '.join(BENCH_RUN_ONLY)}, on the card, in a process started with phase 10 (at {t15 - start:.0f} s)")
        by_path["bench_run"], seconds = phase15.result()
        print(f"      phase 15 took {seconds:.1f} s beside phases 10-14, and {time.perf_counter() - t15:.1f} s more "
              "here; launches " + json.dumps({k: c for k, c in by_path["bench_run"].items() if c}))
        t16w = time.perf_counter()
        print(f"[16/17] hybrid: Engine.generate, zamba2-7b at 15 layers against its JAX reference (bf16 and float32) "
              f"and at 81, qwen1.5-4b and granite-3-8b at 2 layers, full width, on the card, in a process started "
              f"with phase 8 (at {t16 - start:.0f} s)")
        paths16, seconds = phase16.result()
        print(f"      phase 16 took {seconds:.1f} s beside phases 8-15, and {time.perf_counter() - t16w:.1f} s more "
              "here; launches " + json.dumps({path: {k: c for k, c in counts.items() if c}
                                               for path, counts in paths16.items()}))
        by_path.update(paths16)
        t17 = time.perf_counter()
        print(f"[17/17] mixture of experts: Engine.generate, olmoe-1b-7b at 2 layers against its JAX reference (bf16 "
              f"and float32) and at 16, qwen2-moe-a2.7b and qwen3-0.6b at 2 layers, full width, learned offload, on "
              f"the card, in a process started with phase 10 (at {t17 - start:.0f} s)")
        paths17, seconds = phase17.result()
        print(f"      phase 17 took {seconds:.1f} s beside phases 10-16, and {time.perf_counter() - t17:.1f} s more "
              "here; launches " + json.dumps({path: {k: c for k, c in counts.items() if c}
                                               for path, counts in paths17.items()}))
        by_path.update(paths17)
        for r in rows:
            # an instance at zamba2-7b's or the MoE family's shapes counts its launches on the paths that run it
            r["launches_by_path"] = {path: counts[r.get("instance_of", r["name"])] for path, counts in by_path.items()
                                     if path in r.get("paths", by_path)}
            r["launches"] = sum(r["launches_by_path"].values())
        check(set(by_path["run_ours"]) == {r["name"] for r in rows if "instance_of" not in r}, "a kernel has no row")
        check(all(r["launches"] > 0 for r in rows if "instance_of" in r), "a kernel instance at another shape never "
              "launched")
        print(f"      all phases passed in {time.perf_counter() - start:.0f} s")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        for proc in (phase9, phase14, phase15, phase16, phase17):
            if proc is not None:
                proc.kill()
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
