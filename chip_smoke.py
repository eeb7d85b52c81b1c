#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-flash-bf16 LABEL
    python3 chip_smoke.py --time-kernels LABEL
    python3 chip_smoke.py --time-training LABEL

Phases, in order; any failure exits non-zero:

1. device   — the card's name, the device count, and ``nvidia-smi``'s name
              and power limit.  No CUDA device: fail.
2. build    — compile the CUDA kernels under ``src/repro_torch/csrc`` with
              ``nvcc`` for sm_90a (one process per source, in parallel);
              print the build time and the ``-Xptxas -v`` summary.
3. kernels  — hold every kernel against its plain PyTorch version on the
              card at the main path's shapes (integer kernels bit-exact,
              float32 attention within rtol 1e-5 / atol 1e-6, bf16
              attention within one bf16 ulp plus ``DECODE_ATOL`` or
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
              ``CONFIG`` from its slot of the pretrained table): the first
              steps' loss and gradient norm and the update within the
              ``TRAIN_*`` limits, ``thrash_ce_fwd``/``_bwd`` launched once
              per step and ``flash_attention_bwd`` once per step, block and
              layer; (b) the fine-tuned ``run_ours`` on Hotspot x1.5 from
              the pretrained table within the ``RUN_*`` limits, host seconds
              per stage, and a second run under ``torch.profiler`` that must
              give identical stats and top-1; (c) the ``manager`` KV offload:
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
# it.  (a) one fine-tune group: the first steps' loss and gradient norm
# (CPU 9.2e-4, 1.2e-3; mu unscaled 0.13; LUCIR dropped 1.0) and the update's
# distance from the reference's over the update's own norm (CPU 0.018; the
# defects 0.25 and 1.25)
TRAIN_STEPS_HELD, TRAIN_STEP_RTOL, TRAIN_UPDATE_RTOL = 4, 1e-2, 0.08
# (b) the fine-tuned run: top-1 and the counters (correct CPU runs that
# differ only in thread count or one ulp of the weights: up to 0.012 and
# 0.42; mu unscaled 0.028 and 0.35), the first groups' accuracies (CPU
# exact).  Only top-1 separates a defect here; the bias-correction and
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


def kernel_flash_attention(dev) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as K

    rng = np.random.default_rng(2)

    def inputs(B, S, T, Kh, G, D):
        mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev)
        return mk(B, S, Kh, G, D), mk(B, T, Kh, D), mk(B, T, Kh, D)

    worst = 0.0
    cases = [((256, 10, 10, 2, 1, 32), {}), ((3, 37, 37, 2, 3, 64), {}), ((2, 5, 70, 1, 2, 16), {"q_offset": 65}),
             ((2, 10, 10, 2, 1, 32), {"causal": False, "kv_len": 7}), ((1, 1, 40, 2, 4, 128), {"q_offset": 39})]
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
    check(sha == FA_SHA["out"], f"flash_attention's output SHA-256 {sha} is not the serial kernel's {FA_SHA['out']}")
    print(f"  flash_attention: {len(cases)} shapes (the predictor's B256 S=T=10 K2 G1 D32 first), "
          f"rtol {FA_RTOL} atol {FA_ATOL}: max |err| {worst:.3g}; output SHA-256 {sha}, the serial kernel's")
    B, S, T, Kh, G, D = 256, 10, 10, 2, 1, 32
    q, k, v = inputs(B, S, T, Kh, G, D)
    ops, all_ms = device_ops(lambda: K.flash_attention(q, k, v))
    check(ops == 1.0, f"flash_attention ran {ops} device operations per call, not 1")
    # the library yardstick on the same numbers, in its (B, H, S, D) layout
    qh, kh, vh = (x.reshape(B, x.shape[1], Kh * (G if x is q else 1), D).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    sd = sdpa().transpose(1, 2).reshape(B, S, Kh, G, D)
    check(torch.allclose(sd, K.attend_chunked(q, k, v), rtol=1e-4, atol=1e-5), "the SDPA yardstick computes another function")
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + q.numel())
    pairs = S * (S + 1) // 2  # causal, S == T: query i sees keys 0..i
    flops = 2 * 2 * B * Kh * G * pairs * D
    return {"name": "flash_attention", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71", "max_abs_err": worst,
            "ms": time_cuda(lambda: K.flash_attention(q, k, v), 500),
            "plain_ms": time_cuda(lambda: K.attend_chunked(q, k, v), 200),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations",
            "library_ms": time_cuda(sdpa, 500),
            "device_ms": device_ms(lambda: K.flash_attention(q, k, v), "flash_attention"),
            "device_ops_per_call": ops, "device_ms_all_ops": all_ms, "sha": {"out": sha},
            "shape": f"B {B}, S=T {S}, K {Kh}, G {G}, D {D}, float32"}


def _sdpa_layout(q, k, v):
    """(B, S, K, G, D) q and (B, T, K, D) k, v in SDPA's (B, heads, len, D)
    layout; query head k * G + g reads kv head k (``enable_gqa``)."""
    B, S, K, G, D = q.shape
    return (q.reshape(B, S, K * G, D).transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous())


def kernel_flash_attention_bf16(dev) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as K

    rng = np.random.default_rng(5)

    def inputs(B, S, T, Kh, G, D):
        mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev).bfloat16()
        return mk(B, S, Kh, G, D), mk(B, T, Kh, D), mk(B, T, Kh, D)

    worst = need = 0.0
    cases = [((2, 1792, 1792, 2, 7, 64), {}), ((2, 100, 130, 2, 7, 64), {"q_offset": 30}),
             ((1, 33, 33, 1, 4, 32), {"kv_len": 20, "causal": False})]
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
    # the limits reject a causal mask one key off (each row one key short),
    # and one key dropped from long rows (1700 keys, outputs of a few hundredths)
    q, k, v = inputs(2, 1792, 1792, 2, 7, 64)
    long_off = K.flash_attention(q, k, v, causal=False, kv_len=1700).float()
    long_want = K.attend_chunked(q, k, v, causal=False, kv_len=1701).float()
    check(not torch.allclose(long_off, long_want, rtol=FLASH_RTOL, atol=FLASH_ATOL),
          "the bf16 limits pass a key dropped from rows of 1700 keys")
    q, k, v = inputs(2, 100, 130, 2, 7, 64)
    off = K.flash_attention(q, k, v, q_offset=30).float()
    want = K.attend_chunked(q, k, v, q_offset=31).float()
    check(not torch.allclose(off, want, rtol=FLASH_RTOL, atol=FLASH_ATOL), "the bf16 limits pass a key dropped per row")
    again = K.flash_attention(q, k, v, q_offset=30)
    check(all(torch.equal(K.flash_attention(q, k, v, q_offset=30), again) for _ in range(3)),
          "flash_attention (bf16) does not repeat bit for bit")
    print(f"  flash_attention bf16: {len(cases)} shapes (the serve prefill's B2 S=T=1792 K2 G7 D64 first), "
          f"rtol 2^-7 atol {FLASH_ATOL}: max |err| {worst:.3g}, atol needed at rtol 2^-7 {need:.3g}; one key "
          f"dropped per row: max |err| {float((off - want).abs().max()):.3g}, one key dropped at kv_len 1700: "
          f"{float((long_off - long_want).abs().max()):.3g}, both rejected; repeats bit for bit")
    B, S, T, Kh, G, D = 2, 1792, 1792, 2, 7, 64
    q, k, v = inputs(B, S, T, Kh, G, D)
    qh, kh, vh = _sdpa_layout(q, k, v)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
    sd = sdpa().transpose(1, 2).reshape(B, S, Kh, G, D)
    check(torch.allclose(sd.float(), K.attend_chunked(q, k, v).float(), rtol=2e-2, atol=2e-2),
          "the SDPA yardstick computes another function")
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 2 * 2 * B * Kh * G * (S * (S + 1) // 2) * D  # causal pairs, QK and PV
    return {"name": "flash_attention_bf16", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention_bf16.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71", "max_abs_err": worst,
            "ms": time_cuda(lambda: K.flash_attention(q, k, v), 20, warmup=3),
            "plain_ms": time_cuda(lambda: K.attend_chunked(q, k, v), 10, warmup=2),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
            "library_ms": time_cuda(sdpa, 50),
            "device_ms": device_ms(lambda: K.flash_attention(q, k, v), "flash_attention_bf16", iters=10),
            "shape": f"B {B}, S=T {S}, K {Kh}, G {G}, D {D}, bf16, causal"}


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


def kernel_decode_attention(dev) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as K

    rng = np.random.default_rng(6)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def inputs(dtype, B, Kh, G, D, T):
        mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev).to(dtypes[dtype])
        return mk(B, Kh, G, D), mk(B, T, Kh, D), mk(B, T, Kh, D)

    cases = [(dt, (2, 2, 7, 64, 2048), n) for dt in dtypes for n in (0, 1, 511, 512, 513, 1800, 2048)]
    cases += [(dt, shape, n) for dt in dtypes for shape, n in (((1, 2, 1, 128, 520), 520), ((2, 2, 4, 32, 64), 40))]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    need = 0.0
    for dtype, shape, kv_len in cases:
        q, k, v = inputs(dtype, *shape)
        got = K.decode_attention_kernelcall(q, k, v, kv_len)
        want = K.decode_attention_plain(q, k, v, kv_len)
        torch.cuda.synchronize()
        rtol, atol = (FA_RTOL, FA_ATOL) if dtype == "float32" else (DECODE_RTOL, DECODE_ATOL)
        err, n = bf16_err(got, want, DECODE_RTOL)
        check(got.dtype == q.dtype and torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
              f"decode_attention ({dtype}) differs from plain at {shape} kv_len {kv_len}: max |err| {err}")
        worst[dtype] = max(worst[dtype], err)
        if dtype == "bfloat16":
            need = max(need, n)
    # the limits reject one dropped key: the kernel told kv_len 512 where the plain version has 513
    q, k, v = inputs("bfloat16", 2, 2, 7, 64, 2048)
    off = K.decode_attention_kernelcall(q, k, v, 512).float()
    want = K.decode_attention_plain(q, k, v, 513).float()
    check(not torch.allclose(off, want, rtol=DECODE_RTOL, atol=DECODE_ATOL), "the bf16 limits pass a dropped key")
    # split-K: no float atomics, so a call repeats bit for bit
    again = K.decode_attention_kernelcall(q, k, v, 1800)
    check(all(torch.equal(K.decode_attention_kernelcall(q, k, v, 1800), again) for _ in range(3)),
          "decode_attention does not repeat bit for bit")
    print(f"  decode_attention: {len(cases)} cases (float32 and bf16 B2 K2 G7 D64 T2048 at kv_len 0..2048, "
          f"G1 D128 T520 and G4 D32 T64): max |err| float32 {worst['float32']:.3g} "
          f"(rtol {FA_RTOL} atol {FA_ATOL}), bf16 {worst['bfloat16']:.3g} (rtol 2^-7 atol {DECODE_ATOL}; atol "
          f"needed at rtol 2^-7 {need:.3g}); key 513 dropped: max |err| {float((off - want).abs().max()):.3g}, "
          f"rejected; repeats bit for bit")
    # timing at the serve path's shape and its longest cache
    B, Kh, G, D, T = 2, 2, 7, 64, 2048
    kv_len = T
    q, k, v = inputs("bfloat16", B, Kh, G, D, T)
    qh, kh, vh = _sdpa_layout(q[:, None], k[:, :kv_len], v[:, :kv_len])
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)
    sd = sdpa().transpose(1, 2).reshape(B, Kh, G, D)
    check(torch.allclose(sd.float(), K.decode_attention_plain(q, k, v, kv_len).float(), rtol=2e-2,
                         atol=2e-2), "the SDPA yardstick computes another function")
    nbytes = 2 * (2 * q.numel() + 2 * B * kv_len * Kh * D)
    flops = 2 * 2 * B * Kh * G * kv_len * D
    grids: dict = {}
    dev_ms = device_ms(lambda: K.decode_attention_kernelcall(q, k, v, kv_len), "decode_attention", grids=grids)
    if grids:  # split-K spreads the cache over the SMs: at least 64 blocks per kernel at kv_len 2048
        check(set(grids) == set(KERNEL_SYMBOLS["decode_attention"]) and min(min(b) for b in grids.values()) >= 64,
              f"decode_attention launched {grids} blocks per kernel at kv_len {kv_len}")
    print(f"  decode_attention: blocks per launch at kv_len {kv_len}, from the profiler: {grids or 'not recorded'}")
    return {"name": "decode_attention", "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:59", "max_abs_err": max(worst.values()),
            "ms": time_cuda(lambda: K.decode_attention_kernelcall(q, k, v, kv_len), 500),
            "plain_ms": time_cuda(lambda: K.decode_attention_plain(q, k, v, kv_len), 100),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
            "library_ms": time_cuda(sdpa, 500),
            "device_ms": dev_ms, "blocks": grids or None,
            "shape": f"B {B}, K {Kh}, G {G}, D {D}, T {T}, kv_len {kv_len}, bf16"}


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


def kernel_ssd_scan(dev) -> dict:
    import torch

    from repro_torch.kernels import ssd_scan as S

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    serve = (2, 2048, 32, 64, 128, 256)  # one layer of the mamba2-370m prefill
    worst = {"y": 0.0, "state": 0.0}
    for shape in (serve, (1, 512, 4, 64, 128, 256)):
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
    args = _ssd_inputs(dev, torch.bfloat16, 1, 512, 4, 64, 128, seed=7)
    got = S.ssd_scan(*args, chunk=256)
    defects = {}
    for name, bad in _ssd_defects(S).items():
        ey, es, ok = _ssd_err(got, bad(*args, 256), "bfloat16")
        check(not ok, f"the ssd_scan limits pass a plain version with the defect {name}")
        defects[name] = ey
    print(f"  ssd_scan: B2 L2048 H32 P64 N128 chunk 256 (a serve prefill layer) and B1 L512 H4, float32 and bf16: "
          f"max |err| y {worst['y']:.3g}, state {worst['state']:.3g} (limits {SSD_TOL}); defective plain "
          f"versions: y off by {json.dumps(defects)}, rejected")
    B, L, H, P, N, Q = serve
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
              f"ssd_scan launched {grids} blocks per kernel at the serve shape")
    print(f"  ssd_scan: blocks per launch at the serve shape, from the profiler: {grids or 'not recorded'}")
    # the float32 instance at the same shape (phase 6's float32 run)
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    run_f32 = lambda: S.ssd_scan(xf, dtf, A_log, bf, cf, chunk=Q)
    return {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:67", "max_abs_err": worst["y"],
            "ms": time_cuda(run, 20, warmup=3),
            "plain_ms": time_cuda(lambda: S.ssd_scan_plain(x, dt, A_log, b, c, Q), 5, warmup=2),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations",
            "library_ms": None, "device_ms": dev_ms, "blocks": grids or None,
            "ms_f32": time_cuda(run_f32, 20, warmup=3), "device_ms_f32": device_ms(run_f32, "ssd_scan", iters=10),
            "shape": f"B {B}, L {L}, H {H}, P {P}, N {N}, chunk {Q}, bf16 (and float32: ms_f32, device_ms_f32)"}


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
    import numpy as np

    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
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
    final SSM state norm per (layer, row, head) within ``norm_rtol``."""
    import numpy as np
    import torch

    compare, seen = logit_checker(ref, atol, dev)
    S, n_new = prompt.shape[1], ref["tokens"].shape[1]
    with torch.no_grad():
        logits, cache = eng.prefill(eng.params, {"tokens": torch.tensor(prompt, device=dev)})
        compare(0, logits)
        norms = torch.linalg.vector_norm(cache["ssm"], dim=(3, 4)).cpu().numpy()  # (layers, rows, heads)
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
    on) from its slot of the pretrained table with fresh moments, on
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
    check(slot.step == meta["step"] and slot.opt_state is None, "the table's slot is not the reference group's start")
    fs = FeatureSet(*(ref[f"group/{f}"] for f in ("page", "delta", "pc", "tb", "label", "label_page", "t_index")))
    trainer = Trainer(CONFIG, TrainConfig(**meta["train"]), device=dev)
    metrics = []
    step = trainer._train_step

    def recording(*a):
        out = step(*a)
        metrics.append(out[2])
        return out

    trainer._train_step = recording
    entry = Entry(params=clone_tree(slot.params), prev_params=clone_tree(slot.params), step=slot.step)
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
    ``CONFIG``) from the pretrained table, whose slots have no optimizer
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
    """How far a fine-tuned run is from the reference's."""
    ref, meta = load_ref(TRAIN_REF)
    want = meta["run"]
    rel = {k: abs(res.stats[k] - want["stats"][k]) / want["stats"][k]
           for k in ("pages_thrashed", "faults", "migrated_blocks")}
    first = [abs(a - b) for a, b in zip(res.per_group_acc[:RUN_GROUPS_HELD], ref["per_group_acc"][:RUN_GROUPS_HELD])]
    return {"stats": res.stats, "top1": res.top1, "top1_diff": abs(res.top1 - want["top1"]), "stats_rtol": rel,
            "n_predictions_equal": res.n_predictions == want["n_predictions"],
            "occupancy_equal": res.stats["occupancy"] == want["stats"]["occupancy"],
            "first_groups_acc_diff": max(first), "per_group_acc": res.per_group_acc}


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
    t0 = time.perf_counter()
    again = profile_run("fine-tuned run", lambda: fine_tuned_run(dev))
    print(f"  fine-tuned run: the profiled run and its report took {time.perf_counter() - t0:.1f} s")
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
    all its columns together."""
    from repro_torch.bench import tables as TB
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.uvm import simulator as S

    ref = json.loads(TABLES_REF.read_text())
    check((ref["preset"], ref["scale"], ref["cap"], ref["oversubscription"]) == ("paper", *TB.SCALE_PRESETS["paper"], 1.25),
          "the reference file is not the paper preset at x1.25")
    ctx = TB.Context("paper", frozen=True, device=dev)
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
    dist = {}
    for b in tuned.benches:
        r, w = tuned.ours(b), ref["benchmarks"][b]["ours_fine_tuned"]
        dist[b] = {"stats": r.stats, "top1": r.top1, "top1_diff": abs(r.top1 - w["top1"]),
                   "stats_rtol": {k: _rel(r.stats[k], w["stats"][k]) for k in ("pages_thrashed", "faults",
                                                                                "migrated_blocks")},
                   "n_predictions_equal": r.n_predictions == w["n_predictions"],
                   "occupancy_equal": r.stats["occupancy"] == w["stats"]["occupancy"],
                   "first_groups_acc_diff": max(abs(x - y) for x, y in zip(r.per_group_acc[:RUN_GROUPS_HELD],
                                                                           w["per_group_acc"][:RUN_GROUPS_HELD]))}
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
    return {k: sum(c["launches"][k] for c in columns.values()) for k in next(iter(columns.values()))["launches"]}


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
CONCURRENT_EQUAL = ("StreamTriad+2DCONV|mux", "StreamTriad+2DCONV|online_single", "NW+2DCONV|mux", "NW+2DCONV|ours")
# the mux run whose two tenants both open the prefetch gate (the rehearsal
# updates each tenant's table: 1 and 3 times), so both tables must launch
# freq_update; in the frozen runs only Hotspot's gate opens
BOTH_TABLES_RUN = "StreamTriad+2DCONV|mux|tuned"


def merge_sha256(trace) -> str:
    """The SHA-256 of a merge's page, pc, tb, kernel and tenant arrays (int32,
    in that order), as ``scripts/export_torch_reference.py --concurrent``
    hashes the JAX package's."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (trace.page, trace.pc, trace.tb, trace.kernel, trace.tenant):
        h.update(np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()


def run_fields(res) -> dict:
    """What the reference records of a ``run_ours`` and phase 9 holds exactly."""
    return {"stats": res.stats, "top1": res.top1, "n_predictions": res.n_predictions,
            "per_tenant_top1": res.per_tenant_top1, "per_tenant_stats": res.per_tenant_stats}


def tuned_distance(res, want: dict) -> dict:
    """How far a fine-tuned ``run_ours`` is from the reference's run, by
    phase 7 (b)'s measures."""
    return {"top1": res.top1, "top1_diff": abs(res.top1 - want["top1"]),
            "stats_rtol": {k: _rel(res.stats[k], want["stats"][k]) for k in ("pages_thrashed", "faults",
                                                                            "migrated_blocks")},
            "n_predictions_equal": res.n_predictions == want["n_predictions"],
            "occupancy_equal": res.stats["occupancy"] == want["stats"]["occupancy"],
            "first_groups_acc_diff": max(abs(x - y) for x, y in zip(res.per_group_acc[:RUN_GROUPS_HELD],
                                                                    want["per_group_acc"][:RUN_GROUPS_HELD])),
            "equal": run_fields(res) == {k: want[k] for k in run_fields(res)}
            and res.per_group_acc == want["per_group_acc"]}


def check_tuned(name: str, d: dict) -> None:
    """A fine-tuned run of (c) or (d): equal where the rehearsal gave equal,
    else within phase 7 (b)'s limits."""
    if name in CONCURRENT_EQUAL:
        check(d["equal"], f"{name}: not equal to the JAX package's run, as the CPU rehearsal was: {d}")
        return
    check(d["n_predictions_equal"] and d.get("occupancy_equal", True), f"{name}: prediction count or occupancy differ")
    check(d["top1_diff"] <= RUN_TOP1_ATOL, f"{name}: top-1 {d['top1']} is {d['top1_diff']} from the reference's")
    check(max(d.get("stats_rtol", {"-": 0}).values()) <= RUN_STATS_RTOL, f"{name}: counters off by rtol {d}")
    check(d["first_groups_acc_diff"] <= RUN_GROUP_ACC_ATOL, f"{name}: the first groups' accuracies differ by "
          f"{d['first_groups_acc_diff']}")


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
            r, want = runs[f"{key}|{m}"], ref["pairs_ref"][key]["runs"][f"table7_{m}"]
            dist[f"{key}|{m}"] = {
                "top1": r.top1, "top1_diff": abs(r.top1 - want["top1"]),
                "n_predictions_equal": (r.n_samples, r.n_models, r.n_classes) == (want["n_samples"], want["n_models"],
                                                                                  want["n_classes"]),
                "first_groups_acc_diff": max(abs(x - y) for x, y in zip(r.per_group[:RUN_GROUPS_HELD],
                                                                        want["per_group"][:RUN_GROUPS_HELD])),
                "equal": (r.top1, r.per_group) == (want["top1"], want["per_group"])}
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
    try:
        dev = torch.device("cuda", 0)
        name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = nvidia_smi_line()
        print(f"[1/9] device: {name} (count {count}); nvidia-smi: {smi}")
        print(f"      torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

        t0 = time.perf_counter()
        LIBRARY.cdll()
        how = "built" if LIBRARY.build_seconds is not None else "loaded the existing build"
        print(f"[2/9] build: {how} {LIBRARY.path().name} in {time.perf_counter() - t0:.1f} s")
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

        print(f"[3/9] kernels against their plain versions on the card (at {time.perf_counter() - start:.0f} s)")
        rows = [kernel_evict_select(dev), *kernel_freq_table(dev), kernel_flash_attention(dev),
                kernel_flash_attention_bf16(dev), kernel_flash_attention_bwd(dev), kernel_decode_attention(dev),
                kernel_ssd_scan(dev), *kernel_thrash_ce(dev)]
        thrash_ce_checks(dev, rows)
        for r in rows:
            print(f"  {r['name']:20s} {r['shape']}: kernel {r['ms']:.4f} ms/call (device {r['device_ms']}), "
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
        print(f"[4/9] main path: run_ours, Hotspot x1.5, CONFIG, frozen table, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        _, by_path["run_ours"] = main_path(dev)
        print(f"[5/9] serve: Engine.generate, qwen2-0.5b full width, bf16, learned KV offload, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        by_path["serve"], qwen2_engine, qwen2_prompt = serve_path(dev)
        print(f"[6/9] serve mamba2: Engine.generate, mamba2-370m full width, bf16, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        by_path["serve_mamba2"] = serve_mamba2_path(dev)
        print(f"[7/9] train: one train_group, the fine-tuned run_ours (Hotspot x1.5, CONFIG, TrainConfig()) and the "
              f"manager KV offload (qwen2-0.5b full width), on the card (at {time.perf_counter() - start:.0f} s)")
        by_path["train_group"] = train_group_check(dev)
        print(f"      (b) at {time.perf_counter() - start:.0f} s")
        by_path["run_ours_fine_tuned"] = fine_tuned_check(dev)
        print(f"      (c) at {time.perf_counter() - start:.0f} s")
        by_path["serve_manager"] = serve_manager_check(dev, qwen2_engine, qwen2_prompt)
        del qwen2_engine
        print(f"[8/9] tables: the table runner at the paper preset, x1.25, 11 benchmarks (five simulator cells, "
              f"UVMSmart, frozen ours; fine-tuned ours on {len(TABLES_TUNED)}), on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        by_path["table6"] = tables_path(dev)
        print(f"[9/9] concurrent: Tables VII and VIII's cells, four pairs at the paper preset, x1.25 (frozen mux and "
              f"merged on all four; fine-tuned and Table VII on {', '.join(CONCURRENT_TUNED)}), on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        by_path["concurrent"] = concurrent_path(dev)
        for r in rows:
            r["launches_by_path"] = {path: counts[r["name"]] for path, counts in by_path.items()}
            r["launches"] = sum(r["launches_by_path"].values())
        check(set(by_path["run_ours"]) == {r["name"] for r in rows}, "a kernel has no row")
        print(f"      all phases passed in {time.perf_counter() - start:.0f} s")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
