"""Rehearse phase 6 of ``chip_smoke.py`` (mamba2-370m served at full width
against its JAX reference) on a CPU, where every kernel wrapper computes its
plain PyTorch version, and measure how far one rounding moved anywhere in
the bf16 model carries.

    PYTHONPATH=src python scripts/rehearse_mamba2_cpu.py [--threads 6]

1. Phase 6's teacher-forced comparisons (bf16 and float32) and the float32
   free run's forks, with the phase's limits widened to 1e9 so that it
   prints every distance instead of stopping at the first over a limit.
2. The bf16 prefill of the port as it is against the same prefill with
   ``F.silu`` (one rounding) in place of the port's silu (the reference's
   rounding points): the largest logit change at the reference's top-8 ids
   and the largest relative change of a final-state norm.

It takes a few minutes and a few GB of memory.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def silu_sensitivity(ref: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models import mamba2 as M
    from repro_torch.models.params import cast_tree, numpy_params

    run_cfg = get_config("mamba2-370m")
    params = cast_tree({k: torch.tensor(v) for k, v in numpy_params(lm.param_specs(run_cfg), 0).items()},
                       lm.compute_dtype(run_cfg))
    prompt = torch.tensor(ref["prompt"]).long()

    def prefill():
        with torch.no_grad():
            logits, cache = M.prefill(params, {"tokens": prompt}, run_cfg)
        return logits[:, -1].float().numpy(), torch.linalg.vector_norm(cache["ssm"], dim=(3, 4)).numpy()

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
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    torch.cuda.synchronize = lambda *a: None  # noqa: E731 (the phase synchronises the card)
    C.MAMBA2_ATOL = dict.fromkeys(C.MAMBA2_ATOL, 1e9)
    C.STATE_NORM_RTOL = dict.fromkeys(C.STATE_NORM_RTOL, 1e9)
    t0 = time.perf_counter()
    _, ref, _ = C.mamba2_reference_checks(torch.device("cpu"))
    print(f"  phase 6 reference checks: {time.perf_counter() - t0:.1f} s")
    print(f"  bf16 prefill, F.silu against the port's silu: {silu_sensitivity(ref)}")


if __name__ == "__main__":
    main()
