"""Batched serving entry point with the paper's KV-offload manager (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
        --batch 4 --prompt-len 64 --new-tokens 32 --offload learned [--device cpu]

The flags are the reference's, plus ``--device`` (default ``cuda``: the
card).  The weights (``lm.init``) and the prompt come from
``torch.Generator``s seeded with ``--seed`` and ``--seed + 1``; their
numbers differ from ``jax.random``'s, so the tokens differ from the
reference script's.  The output is the same JSON object.  ``--offload
manager`` runs the full streaming manager, which fine-tunes its ``SMOKE``
predictor on the KV touch stream (the attention backward and ``thrash_ce``
kernels on the card).

``--arch mamba2-370m`` (the ssm family) runs too; it has no KV cache, so
``--offload`` builds no manager and ``"offload"`` is null, as in the
reference.  Its SSD scan takes only prompts whose length is a multiple of
``ssm_chunk`` (256 at full width, 16 at ``--smoke``): any other length
raises ``ValueError``, in both packages, so the default ``--prompt-len 64``
fails at full width; pass e.g. ``--prompt-len 2048``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--offload", choices=["none", "lru", "learned", "manager"], default="none")
    ap.add_argument("--hbm-fraction", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    total = args.prompt_len + args.new_tokens
    params = lm.init(args.seed, cfg, max_seq=total, device=dev)
    gen = torch.Generator().manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen).to(dev)}

    eng = Engine(cfg, params, offload=None if args.offload == "none" else args.offload,
                 hbm_fraction=args.hbm_fraction, device=dev)
    res = eng.generate(batch, args.new_tokens, pad_to=total)
    out = {
        "arch": cfg.name,
        "generated_shape": list(res.tokens.shape),
        "first_seq": res.tokens[0, :8].tolist(),
        "offload": res.offload_stats,
    }
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
