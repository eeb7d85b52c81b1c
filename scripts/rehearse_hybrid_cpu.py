"""Rehearse phase 16 of ``chip_smoke.py`` (zamba2-7b and the two dense
configs served) on a CPU, where every kernel wrapper computes its plain
PyTorch version, and measure how far one rounding moved in the bf16 model
carries.

    PYTHONPATH=src python scripts/rehearse_hybrid_cpu.py [--threads 6] [--full-depth-layers 12]

1. Phase 16 (a)'s teacher-forced comparisons of the 15-layer zamba2 (bf16
   and float32) against ``experiments/torch/serve_zamba2_ref.npz`` and both
   free runs' forks, with the phase's limits widened to 1e9 so that it
   prints every distance instead of stopping at the first over a limit.
2. The bf16 prefill of the port as it is against the same prefill with
   ``F.silu`` (one rounding) in place of the port's silu (the reference's
   rounding points): the largest logit change at the reference's top-8 ids
   and the largest relative change of a final-state norm.
3. Phase 16 (b)'s code at ``--full-depth-layers`` layers (81 on the card)
   and (c) as on the card; the launch counts are not checked (a CPU tensor
   launches nothing).

It takes about ten minutes and about 15 GB of memory.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def silu_sensitivity(ref: dict, run: dict, prompt) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid as H
    from repro_torch.models import lm
    from repro_torch.models import mamba2 as M
    from repro_torch.models.params import cast_tree, numpy_params

    cfg = get_config(run["arch"]).replace(num_layers=run["num_layers"])
    params = cast_tree({k: torch.tensor(v) for k, v in numpy_params(lm.param_specs(cfg), run["seed"]).items()},
                       lm.compute_dtype(cfg))

    def prefill():
        with torch.no_grad():
            logits, cache = H.prefill(params, {"tokens": torch.tensor(prompt)}, cfg)
        return logits[:, -1].float().numpy(), torch.linalg.vector_norm(cache["ssm"], dim=(2, 3, 4)).numpy()

    base = prefill()
    silu = M.silu
    M.silu = torch.nn.functional.silu
    try:
        swapped = prefill()
    finally:
        M.silu = silu
    ids = ref["top_ids"][0]
    return {"top8_logit_change": float(np.abs(np.take_along_axis(base[0] - swapped[0], ids, 1)).max()),
            "logit_change": float(np.abs(base[0] - swapped[0]).max()),
            "state_norm_rel_change": float(np.abs(swapped[1] / base[1] - 1).max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--full-depth-layers", type=int, default=12)
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
    C.ZAMBA2_ATOL = dict.fromkeys(C.ZAMBA2_ATOL, 1e9)
    C.ZAMBA2_NORM_RTOL = dict.fromkeys(C.ZAMBA2_NORM_RTOL, 1e9)
    dev = torch.device("cpu")
    t0 = time.perf_counter()
    eng, ref, prompt, _ = C.zamba2_reference_checks(dev)
    print(f"  phase 16 (a) reference checks: {time.perf_counter() - t0:.1f} s")
    res, _, out = C.serve_timed(eng, prompt, ref["tokens"].shape[1])
    print(f"  bf16 free run: {out}; forks {C.fork_check(res.tokens, ref, C.ZAMBA2_ATOL['bfloat16'])}")
    del eng
    _, run = C.load_ref(C.ZAMBA2_REF)
    print(f"  bf16 prefill, F.silu against the port's silu: {silu_sensitivity(ref, run, prompt)}")
    print(f"  the reference's two SSD routes at the prefill: top-8 logits up to "
          f"{float(np.abs(ref['default_top_logits'] - ref['top_logits'][0]).max()):.4g} apart where the ids agree "
          f"({bool((ref['default_top_ids'] == ref['top_ids'][0]).all())} for all), state norms rtol "
          f"{float(np.abs(ref['default_state_norm'] / ref['state_norm'] - 1).max()):.4g}")
    t0 = time.perf_counter()
    C.zamba2_full_depth(dev, args.full_depth_layers)
    for arch in C.DENSE_ARCHS:
        C.dense_config_run(dev, arch)
    print(f"  phase 16 (b) at {args.full_depth_layers} layers and (c): {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
