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
              attention within rtol 1e-5 / atol 1e-6), and time kernel,
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

The last lines are the card's ``nvidia-smi`` line, a ``{"kernels": [...]}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REF = ROOT / "experiments" / "torch" / "hotspot_paper_ref.json"
WEIGHTS = ROOT / "experiments" / "torch" / "pretrain_paper.npz"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
FA_RTOL, FA_ATOL = 1e-5, 1e-6


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


def device_ms(fn, kernel_symbol: str, iters: int = 50) -> float | None:
    """Mean device time (ms) of the CUDA kernel whose name contains
    ``kernel_symbol``, from ``torch.profiler``; None if the profiler shows
    no device time for it."""
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
        if kernel_symbol in ev.key:
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            total += t
            count += ev.count
    return total / count / 1e3 if count and total > 0 else None


# --- phase 3: each kernel against its plain version --------------------------


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
            "device_ms": device_ms(lambda: K.evict_select(cand, keys, ne), KERNEL_SYMBOLS["evict_select"]),
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
           "device_ms": device_ms(lambda: K.freq_update(tags, cnt, hot), KERNEL_SYMBOLS["freq_update"]),
           "skewed_ms": time_cuda(lambda: upd(skewed), 200) - copy_ms,
           "shape": f"{n_sets}x{ways} table, {n} blocks of one Hotspot group"}
    q = hot
    lk = {"name": "freq_lookup", "route": "cuda", "source": "src/repro_torch/csrc/freq_table.cu",
          "replaces": "src/repro/kernels/freq_table/kernel.py:125", "max_abs_err": worst_l,
          "ms": time_cuda(lambda: K.freq_lookup(tags, cnt, q), 500),
          "plain_ms": time_cuda(lambda: K.freq_lookup_plain(tags, cnt, q), 200),
          "bound_ms": lookup_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
          "device_ms": device_ms(lambda: K.freq_lookup(tags, cnt, q), KERNEL_SYMBOLS["freq_lookup"]),
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
            "device_ms": device_ms(lambda: K.flash_attention(q, k, v), KERNEL_SYMBOLS["flash_attention"]),
            "shape": f"B {B}, S=T {S}, K {Kh}, G {G}, D {D}, float32"}


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

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrapper

    OversubscriptionManager.observe = timed("observe", originals["observe"])
    S.run_segment = timed("run_segment", originals["run_segment"])
    S.apply_prefetch = timed("apply_prefetch", originals["apply_prefetch"])
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
    profile_main_path(lambda: R.run_ours(trace, CONFIG, tcfg, oversubscription=1.5,
                                         table=R.load_pretrained(WEIGHTS, CONFIG, dev), device=dev),
                      full["stats"])
    return out, launches


KERNEL_SYMBOLS = {"evict_select": "evict_select_kernel", "freq_update": "freq_update_kernel",
                  "freq_lookup": "freq_lookup_kernel", "flash_attention": "fa_fwd_kernel"}


def profile_main_path(run, want_stats) -> None:
    """Run the main path once more under ``torch.profiler`` (CUDA activity)
    and print where the device time goes: the summed time of every kernel
    (one stream, so kernels do not overlap), its share of the run's wall time,
    each port kernel's device time and count, and the top kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(res.stats == want_stats, "the profiled main-path run gave other stats")
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and ev.count:
            by_name[ev.key] = (t / 1e6, ev.count)
    busy = sum(t for t, _ in by_name.values())
    port = {name: {"device_s": sum(t for k, (t, _) in by_name.items() if sym in k),
                   "count": sum(c for k, (_, c) in by_name.items() if sym in k)}
            for name, sym in KERNEL_SYMBOLS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print("  main path profile: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall if busy else None,
        "port_kernels": port,
        "top_kernels": [{"name": k[:100], "device_s": t, "count": c} for k, (t, c) in top]}))


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
    try:
        dev = torch.device("cuda", 0)
        name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = nvidia_smi_line()
        print(f"[1/4] device: {name} (count {count}); nvidia-smi: {smi}")
        print(f"      torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

        t0 = time.perf_counter()
        LIBRARY.cdll()
        how = "built" if LIBRARY.build_seconds is not None else "loaded the existing build"
        print(f"[2/4] build: {how} {LIBRARY.path().name} in {time.perf_counter() - t0:.1f} s")
        for line in LIBRARY.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line or line.startswith("=="):
                print("      " + line.strip())

        print("[3/4] kernels against their plain versions on the card")
        rows = [kernel_evict_select(dev), *kernel_freq_table(dev), kernel_flash_attention(dev)]
        for r in rows:
            print(f"  {r['name']:16s} {r['shape']}: kernel {r['ms']:.4f} ms/call (device {r['device_ms']}), "
                  f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")

        print("[4/4] main path: run_ours, Hotspot x1.5, CONFIG, frozen table, on the card")
        _, launches = main_path(dev)
        for r in rows:
            r["launches"] = launches[r["name"]]
        check(set(launches) == {r["name"] for r in rows}, "a kernel has no row")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
