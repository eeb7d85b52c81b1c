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

``--arch mamba2-370m`` (the ssm family) and ``--arch zamba2-7b`` (the
hybrid: Mamba-2 layers and one shared attention block every 6 of them, 81
layers, 6.75B parameters, about 13.5 GB of bf16 weights on the card beside
its float32 masters) run too; neither gets an offload manager (mamba2 has no
KV cache, and the reference offloads no hybrid), so ``"offload"`` is null,
as in the reference.  Their SSD scan takes only prompts whose length is a
multiple of ``ssm_chunk`` (256 at full width, 16 at ``--smoke``): any other
length raises ``ValueError``, in both packages, so the default
``--prompt-len 64`` fails at full width; pass e.g. ``--prompt-len 2048``
(mamba2) or ``--prompt-len 512`` (zamba2).  ``--arch qwen1.5-4b``,
``--arch granite-3-8b`` and ``--arch qwen3-0.6b`` (with ``qk_norm``) are
dense, as qwen2.

``--arch olmoe-1b-7b`` and ``--arch qwen2-moe-a2.7b`` are the
mixture-of-experts family, offloaded as the dense family is.  As in the
reference, ``lm.init`` draws float32 masters on the host and the engine
keeps them beside their bf16 cast on the card: olmoe (6.9B parameters)
then holds about 27.7 GB of masters and 13.8 GB of bf16 weights, and
qwen2-moe (15.1B) would need about 60.6 GB and 30.3 GB, more than one 80
GB card holds.
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
