#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

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
              state at a chunk boundary), and time kernel,
              plain version and (for attention) ``scaled_dot_product_
              attention`` with CUDA events.
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
              ``freq_update`` once per step; and a profiled second free run.
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

The last lines are the card's ``nvidia-smi`` line, a ``{"kernels": [...]}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REF = ROOT / "experiments" / "torch" / "hotspot_paper_ref.json"
WEIGHTS = ROOT / "experiments" / "torch" / "pretrain_paper.npz"
SERVE_REF = ROOT / "experiments" / "torch" / "serve_qwen2_ref.npz"
MAMBA2_REF = ROOT / "experiments" / "torch" / "serve_mamba2_ref.npz"

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
# p rounded against other running maxima (per key in the kernel, per chunk
# in the plain version), each p off by up to 2^-9 of itself on either side;
# that moves the short causal rows (few keys, outputs of about +-3) most.
# An H100 needed atol 0.0027 at rtol 2^-7 on these inputs and the GPU
# tests'; a wrong causal offset is off by about 3.7
FLASH_RTOL, FLASH_ATOL = 2.0 ** -7, 4e-3
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


def time_cuda(fn, iters: int, warmup: int = 10) -> float:
    """Milliseconds per call of ``fn`` on the current stream (CUDA events
    around ``iters`` back-to-back calls, after a warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, kernel: str, iters: int = 50) -> float | None:
    """Mean device time (ms) of the port kernel ``kernel`` (its device
    symbol matched by ``is_kernel``), from ``torch.profiler``; None if the
    profiler shows no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    except Exception as exc:  # the profiler is a diagnostic here; the events time stands
        print(f"  (torch.profiler gave no device times: {exc!r})")
        return None
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if is_kernel(kernel, ev.key):
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            total += t
            count += ev.count
    return total / count / 1e3 if count and total > 0 else None


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
    for nb in (256, 512):
        for n_keys in (1, 2, 3, 4):
            for trial in range(6):
                cand = torch.tensor(rng.random(nb) < 0.6, device=dev)
                keys = tuple(torch.tensor(rng.integers(-3, 3, nb, dtype=np.int32), device=dev)
                             for _ in range(n_keys))
                n_cand = int(cand.sum())
                for n in (0, 1, 2, 5, n_cand // 2, n_cand, n_cand + 7):
                    ne = torch.tensor(n, dtype=torch.int32, device=dev)
                    got = K.evict_select(cand, keys, ne)
                    want = K.evict_select_plain(cand, keys, ne)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"evict_select differs from plain at NB={nb}, keys={n_keys}, n={n}")
                    worst = max(worst, int((got.int() - want.int()).abs().max()))
                    n_cases += 1
    print(f"  evict_select: {n_cases} cases at NB 256/512, 1-4 tied keys, n_evict 0..candidates+7: bit-exact")
    # timing at the main path's shape: NB 256, the learned policy's 3 keys, one victim
    nb = 256
    cand = torch.tensor(rng.random(nb) < 0.6, device=dev)
    keys = (torch.tensor(-rng.integers(0, 3, nb, dtype=np.int32), device=dev),
            torch.tensor(rng.integers(-1, 64, nb, dtype=np.int32), device=dev),
            torch.tensor(rng.integers(0, 50000, nb, dtype=np.int32), device=dev))
    ne = torch.tensor(1, dtype=torch.int32, device=dev)
    ms = time_cuda(lambda: K.evict_select(cand, keys, ne), 500)
    plain_ms = time_cuda(lambda: K.evict_select_plain(cand, keys, ne), 200)
    nbytes = nb + 3 * 4 * nb + 4 + nb  # cand, keys, n_evict in; mask out
    return {"name": "evict_select", "route": "cuda", "source": "src/repro_torch/csrc/evict_select.cu",
            "replaces": "src/repro/kernels/evict_select/kernel.py:56", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "device_ms": device_ms(lambda: K.evict_select(cand, keys, ne), "evict_select"),
            "shape": f"NB {nb}, 3 keys, n_evict 1"}


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

    def upd(blocks):
        tags.copy_(t0)
        cnt.copy_(c0)
        K.freq_update(tags, cnt, blocks)

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
    upd = {"name": "freq_update", "route": "cuda", "source": "src/repro_torch/csrc/freq_table.cu",
           "replaces": "src/repro/kernels/freq_table/kernel.py:77", "max_abs_err": worst_u,
           "ms": time_cuda(lambda: upd(hot), 200) - copy_ms,
           "plain_ms": time_cuda(lambda: K.freq_update_plain(t0, c0, hot), 20, warmup=3),
           "bound_ms": update_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": None,
           "device_ms": device_ms(lambda: K.freq_update(tags, cnt, hot), "freq_update"),
           "skewed_ms": time_cuda(lambda: upd(skewed), 200) - copy_ms,
           "shape": f"{n_sets}x{ways} table, {n} blocks of one Hotspot group"}
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
    print(f"  flash_attention: {len(cases)} shapes (the predictor's B256 S=T=10 K2 G1 D32 first), "
          f"rtol {FA_RTOL} atol {FA_ATOL}: max |err| {worst:.3g}")
    B, S, T, Kh, G, D = 256, 10, 10, 2, 1, 32
    q, k, v = inputs(B, S, T, Kh, G, D)
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
    # the limits reject a causal mask one key off (each row one key short)
    q, k, v = inputs(2, 100, 130, 2, 7, 64)
    off = K.flash_attention(q, k, v, q_offset=30).float()
    want = K.attend_chunked(q, k, v, q_offset=31).float()
    check(not torch.allclose(off, want, rtol=FLASH_RTOL, atol=FLASH_ATOL), "the bf16 limits pass a key dropped per row")
    print(f"  flash_attention bf16: {len(cases)} shapes (the serve prefill's B2 S=T=1792 K2 G7 D64 first), "
          f"rtol 2^-7 atol {FLASH_ATOL}: max |err| {worst:.3g}, atol needed at rtol 2^-7 {need:.3g}; one key "
          f"dropped per row: max |err| {float((off - want).abs().max()):.3g}, rejected")
    B, S, T, Kh, G, D = 2, 1792, 1792, 2, 7, 64
    q, k, v = inputs(B, S, T, Kh, G, D)
    qh, kh, vh = _sdpa_layout(q, k, v)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
    sd = sdpa().transpose(1, 2).reshape(B, S, Kh, G, D)
    check(torch.allclose(sd.float(), K.attend_chunked(q, k, v).float(), rtol=2e-2, atol=2e-2),
          "the SDPA yardstick computes another function")
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 2 * 2 * B * Kh * G * (S * (S + 1) // 2) * D  # causal pairs, QK and PV
    return {"name": "flash_attention_bf16", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71", "max_abs_err": worst,
            "ms": time_cuda(lambda: K.flash_attention(q, k, v), 20, warmup=3),
            "plain_ms": time_cuda(lambda: K.attend_chunked(q, k, v), 10, warmup=2),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
            "library_ms": time_cuda(sdpa, 50),
            "device_ms": device_ms(lambda: K.flash_attention(q, k, v), "flash_attention_bf16", iters=10),
            "shape": f"B {B}, S=T {S}, K {Kh}, G {G}, D {D}, bf16, causal"}


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

    cases = [("bfloat16", (2, 2, 7, 64, 2048), n) for n in (1, 511, 512, 513, 1800, 2048)]
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
    print(f"  decode_attention: {len(cases)} cases (bf16 B2 K2 G7 D64 T2048 at kv_len 1..2048; float32 and "
          f"bf16 at G1 D128 T520 and G4 D32 T64): max |err| float32 {worst['float32']:.3g} "
          f"(rtol {FA_RTOL} atol {FA_ATOL}), bf16 {worst['bfloat16']:.3g} (rtol 2^-7 atol {DECODE_ATOL}; atol "
          f"needed at rtol 2^-7 {need:.3g}); key 513 dropped: max |err| {float((off - want).abs().max()):.3g}, "
          f"rejected")
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
    return {"name": "decode_attention", "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:59", "max_abs_err": max(worst.values()),
            "ms": time_cuda(lambda: K.decode_attention_kernelcall(q, k, v, kv_len), 500),
            "plain_ms": time_cuda(lambda: K.decode_attention_plain(q, k, v, kv_len), 100),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
            "library_ms": time_cuda(sdpa, 500),
            "device_ms": device_ms(lambda: K.decode_attention_kernelcall(q, k, v, kv_len), "decode_attention"),
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
    return {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:67", "max_abs_err": worst["y"],
            "ms": time_cuda(run, 20, warmup=3),
            "plain_ms": time_cuda(lambda: S.ssd_scan_plain(x, dt, A_log, b, c, Q), 5, warmup=2),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations",
            "library_ms": None, "device_ms": device_ms(run, "ssd_scan", iters=10),
            "shape": f"B {B}, L {L}, H {H}, P {P}, N {N}, chunk {Q}, bf16"}


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


KERNEL_SYMBOLS = {"evict_select": "evict_select_kernel", "freq_update": "freq_update_kernel",
                  "freq_lookup": "freq_lookup_kernel", "flash_attention": "fa_fwd_kernel",
                  "flash_attention_bf16": "fa_fwd_kernel", "decode_attention": "decode_attention_kernel",
                  "ssd_scan": "ssd_scan_kernel"}


def is_kernel(name: str, symbol: str) -> bool:
    """Whether a profiler key is the device symbol of port kernel ``name``
    (flash attention's two instantiations differ by their element type)."""
    if KERNEL_SYMBOLS[name] not in symbol:
        return False
    if name.startswith("flash_attention"):
        return ("bfloat16" in symbol) == name.endswith("bf16")
    return True


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
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and ev.count:
            by_name[ev.key] = (t / 1e6, ev.count)
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


def load_serve_ref(path) -> tuple[dict, dict]:
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


def serve_path(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import numpy_params
    from repro_torch.serving.engine import OFFLOAD_KINDS, Engine

    ref, run = load_serve_ref(SERVE_REF)
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
    # 4. where the device time goes
    res2 = profile_run("serve", lambda: eng.generate({"tokens": prompt}, n_new, pad_to=pad_to))
    check(np.array_equal(res2.tokens, res.tokens), "the profiled serve run gave other tokens")
    return launches


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

    ref, run = load_serve_ref(MAMBA2_REF)
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


def main() -> int:
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
        print(f"[1/6] device: {name} (count {count}); nvidia-smi: {smi}")
        print(f"      torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

        t0 = time.perf_counter()
        LIBRARY.cdll()
        how = "built" if LIBRARY.build_seconds is not None else "loaded the existing build"
        print(f"[2/6] build: {how} {LIBRARY.path().name} in {time.perf_counter() - t0:.1f} s")
        for line in LIBRARY.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line or line.startswith("=="):
                print("      " + line.strip())

        print(f"[3/6] kernels against their plain versions on the card (at {time.perf_counter() - start:.0f} s)")
        rows = [kernel_evict_select(dev), *kernel_freq_table(dev), kernel_flash_attention(dev),
                kernel_flash_attention_bf16(dev), kernel_decode_attention(dev), kernel_ssd_scan(dev)]
        for r in rows:
            print(f"  {r['name']:16s} {r['shape']}: kernel {r['ms']:.4f} ms/call (device {r['device_ms']}), "
                  f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")

        print(f"[4/6] main path: run_ours, Hotspot x1.5, CONFIG, frozen table, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        _, run_ours_launches = main_path(dev)
        print(f"[5/6] serve: Engine.generate, qwen2-0.5b full width, bf16, learned KV offload, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        serve_launches = serve_path(dev)
        print(f"[6/6] serve mamba2: Engine.generate, mamba2-370m full width, bf16, on the card "
              f"(at {time.perf_counter() - start:.0f} s)")
        mamba2_launches = serve_mamba2_path(dev)
        for r in rows:
            by_path = {"run_ours": run_ours_launches[r["name"]], "serve": serve_launches[r["name"]],
                       "serve_mamba2": mamba2_launches[r["name"]]}
            r["launches"] = sum(by_path.values())
            r["launches_by_path"] = by_path
        check(set(run_ours_launches) == {r["name"] for r in rows}, "a kernel has no row")
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
