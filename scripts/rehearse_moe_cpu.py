"""Rehearse phase 17 of ``chip_smoke.py`` (the MoE family and qwen3 served)
on a CPU, where every kernel wrapper computes its plain PyTorch version,
and print the distances its limits are set from.

    PYTHONPATH=src python scripts/rehearse_moe_cpu.py [--threads 6] [--full-depth-layers 2]

1. Phase 17 (a)'s comparisons of the 2-layer olmoe (bf16 and float32)
   against ``experiments/torch/serve_olmoe_ref.npz``: the teacher-forced
   logits at the reference's top-8 ids, the page masses, the prefill's
   routes per layer (SHA-256 equal or not, load differences, drops), the
   replayed offload stats and both free runs' forks, with the phase's
   logit limits widened to 1e9 and its float32 route gate off, so that it
   prints every distance instead of stopping at the first over a limit.
2. Phase 17 (b)'s code at ``--full-depth-layers`` layers (16 on the card)
   and (c) as on the card; the launch counts are not checked (a CPU tensor
   launches nothing).

It takes a few minutes and about 12 GB of memory.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--full-depth-layers", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    # the phase synchronises and reads the card's memory and profiler; none of that on a CPU
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    C.profile_run = lambda label, run: run()
    C.launch_check = lambda *a, **k: None
    C.MOE_ATOL = dict.fromkeys(C.MOE_ATOL, 1e9)
    C.MOE_MASS_RTOL = 1e9
    C.MOE_ROUTES_EQUAL_F32 = ()
    dev = torch.device("cpu")
    t0 = time.perf_counter()
    eng, ref, run, prompt, _ = C.moe_reference_checks(dev)
    print(f"  phase 17 (a) reference checks: {time.perf_counter() - t0:.1f} s")
    res, _, out = C.serve_timed(eng, prompt, ref["tokens"].shape[1], pad_to=run["pad_to"])
    forks = C.fork_check(res.tokens, ref, C.MOE_ATOL["bfloat16"])
    print(f"  bf16 free run: {out}; offload {res.offload_stats}; forks {forks}")
    del eng
    t0 = time.perf_counter()
    C.olmoe_full_depth(dev, args.full_depth_layers)
    for arch in C.MOE_CONFIGS:
        C.dense_config_run(dev, arch)
    print(f"  phase 17 (b) at {args.full_depth_layers} layers and (c): {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
