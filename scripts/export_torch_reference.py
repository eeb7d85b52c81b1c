"""Export the JAX package's paper-scale weights and a frozen reference run
for the PyTorch port (``src/repro_torch``).

The port cannot import JAX, and the machine that runs it on the GPU has
none, so this script carries both across as plain files:

* ``experiments/torch/pretrain_paper.npz`` — the Section V-A pretrained
  model table of ``Session.paper()`` (``CONFIG``, 632,066 parameters per
  slot): every slot's params as float32 under ``slot<s>/<param key>``, plus
  ``slot<s>/step``, ``slot<s>/n_updates``, ``slot<s>/last_acc`` and
  ``n_slots``.  Optimizer moments are left out: a frozen run re-initialises
  them to zeros, exactly as ``Trainer.train_group`` does when they are
  missing.
* ``experiments/torch/hotspot_paper_ref.json`` — the JAX package's frozen
  ``run_ours`` (``TrainConfig(2048, 0, 256)``, so no weight ever changes)
  on Hotspot at scale 1.0 and 150% oversubscription from that table: the
  stats, top-1, prediction count, per-group accuracy, the number of groups
  whose prefetch gate opened, and the same numbers for the first 8 groups.

    PYTHONPATH=src python scripts/export_torch_reference.py [--cache-dir DIR]

Pretraining takes about a minute on a CPU.  ``--cache-dir`` memoises it in
DIR (default: no memo, nothing is written outside ``experiments/torch``).

    PYTHONPATH=src python scripts/export_torch_reference.py --serve

writes ``experiments/torch/serve_qwen2_ref.npz`` instead: the JAX serving
engine (its default XLA path) on ``qwen2-0.5b`` at full width, with the
weights of ``repro_torch.models.params.numpy_params`` (seed 0) and the
prompt ``default_rng(1).integers(0, 151936, (2, 1792))``:
``Engine(offload="learned", hbm_fraction=0.5).generate(n_new=256,
pad_to=2048)`` (32 KV pages of 64 tokens, 16 resident).  It records the
prompt, the generated tokens, the top-8 ids and logits of every step
(prefill first) per row with the top-1/top-2 margin, each step's page mass
and touched pages as handed to the offload manager, the ``learned``
manager's final stats, and the stats of the JAX ``LRUOffloadManager`` fed
the same stream (the tokens do not depend on the offload kind).  It takes
about 4.5 minutes and 14 GB on a CPU.

    PYTHONPATH=src python scripts/export_torch_reference.py --serve-mamba2

writes ``experiments/torch/serve_mamba2_ref.npz`` instead: the JAX serving
engine on ``mamba2-370m`` at full width (48 layers, 420,136,448
parameters, bf16), with the weights of ``numpy_params`` (seed 0) and the
prompt ``default_rng(1).integers(0, 50280, (2, 2048))`` (8 SSD chunks of
256): ``Engine(offload="learned", hbm_fraction=0.5).generate(n_new=128)``,
for which neither package builds an offload manager (no KV cache).  In
this script's process only, the engine's SSD goes through the TPU kernel
in interpret mode (``ssd_pallas(..., interpret=True)``, by reassigning
``repro.kernels.ssd_scan.ops.ssd``): the port's kernel computes that
function, which in bf16 differs from the default path (``ssd_ref`` rounds
the state, its weights and ``decay*dt`` to bf16).  It records the prompt,
the tokens, the top-8 ids and logits of every step with the top-1/top-2
margin, the norm over (P, N) of the prefill's final SSM state per (layer,
row, head), the offload stats (null), and the default path's prefill top-8
ids and logits and state norms, so that the gap between the reference's
two routes is measured.  In bf16 this random-weight model is chaotic: one
ulp moved anywhere in a layer moves its logits by tenths, so the same run
in float32 (``f32_*``: the prompt, then 32 new tokens) is recorded beside
it, for a tight comparison.  It takes about 9 minutes and 4 GB on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "experiments" / "torch"
GROUP = 2048
CUT_GROUPS = 8


def _frozen_run(trace, table, oversub: float) -> dict:
    from repro.configs.predictor_paper import CONFIG
    from repro.core.incremental import TrainConfig
    from repro.uvm import runtime as R

    tcfg = TrainConfig(group_size=GROUP, epochs=0, batch_size=256)
    mgr = R.manager_for(trace, CONFIG, tcfg, oversubscription=oversub, table=table)
    gates, patterns, streamed = [], [], 0
    observe = mgr.observe

    def recording_observe(batch):
        nonlocal streamed
        a = observe(batch)
        gates.append(a.counters is not None)
        patterns.append(int(a.pattern))
        if a.counters is not None:
            streamed += a.n_samples
        return a

    mgr.observe = recording_observe
    res = R.run_ours(trace, CONFIG, tcfg, oversubscription=oversub, manager=mgr)
    return {
        "n_accesses": len(trace),
        "stats": res.stats,
        "top1": res.top1,
        "n_predictions": res.n_predictions,
        "per_group_acc": res.per_group_acc,
        "n_groups": len(gates),
        "n_gate_open": int(sum(gates)),
        "predicted_blocks_streamed": streamed,
        "patterns": patterns,
        "ipc": res.ipc(),
    }


SERVE = {"arch": "qwen2-0.5b", "seed": 0, "prompt_seed": 1, "batch": 2, "prompt_len": 1792, "n_new": 256,
         "pad_to": 2048, "offload": "learned", "hbm_fraction": 0.5}
TOPK = 8


def _topk(logits) -> tuple:
    """Top-8 ids (ties: lowest id first, as argmax) and values of the last
    position's logits, and the top-1/top-2 margin, per row."""
    import numpy as np

    x = np.asarray(logits[:, -1], np.float32)
    ids = np.argsort(-x, axis=-1, kind="stable")[:, :TOPK]
    vals = np.take_along_axis(x, ids, axis=-1)
    return ids.astype(np.int32), vals, vals[:, 0] - vals[:, 1]


def serve_reference(cfg, *, seed, prompt_seed, batch, prompt_len, n_new, pad_to, offload, hbm_fraction) -> dict:
    """One JAX engine run with every step recorded (see the module docstring)."""
    import dataclasses
    import time

    import jax.numpy as jnp
    import numpy as np

    from repro.models import lm
    from repro.serving.engine import Engine
    from repro.serving.offload import LRUOffloadManager
    from repro_torch.models.params import numpy_params

    t0 = time.perf_counter()
    params = {k: jnp.asarray(v) for k, v in numpy_params(lm.param_specs(cfg), seed).items()}
    prompt = np.random.default_rng(prompt_seed).integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    eng = Engine(cfg, params, offload=offload, hbm_fraction=hbm_fraction)
    steps, masses, touched, mgrs = [], [], [], []
    prefill, decode, drive = eng.prefill, eng.decode, eng._drive_offload

    def rec_prefill(p, b):
        logits, cache = prefill(p, b)
        steps.append(_topk(logits))
        return logits, cache

    def rec_decode(p, b, cache):
        logits, cache = decode(p, b, cache)
        steps.append(_topk(logits))
        return logits, cache

    def rec_drive(mgr, cache, pos):
        if not mgrs:
            on_attention = mgr.on_attention

            def rec_on_attention(mass, tch):
                masses.append(np.array(mass, np.float64))
                touched.append(np.array(tch, np.int64))
                return on_attention(mass, tch)

            mgr.on_attention = rec_on_attention
            mgrs.append(mgr)
        return drive(mgr, cache, pos)

    eng.prefill, eng.decode, eng._drive_offload = rec_prefill, rec_decode, rec_drive
    res = eng.generate({"tokens": jnp.asarray(prompt)}, n_new=n_new, pad_to=pad_to)
    seconds = time.perf_counter() - t0
    n_pages = mgrs[0].n_pages
    lru = LRUOffloadManager(n_pages, mgrs[0].capacity)
    mask = np.zeros((len(masses), n_pages), bool)
    for i, (m, t) in enumerate(zip(masses, touched)):
        lru.on_attention(m, t)
        mask[i, t] = True
    stat_keys = list(dataclasses.asdict(lru.stats))
    return {
        "prompt": prompt, "tokens": np.asarray(res.tokens, np.int32),
        "top_ids": np.stack([s[0] for s in steps]), "top_logits": np.stack([s[1] for s in steps]),
        "margin": np.stack([s[2] for s in steps]),
        "page_mass": np.stack(masses), "touched": mask,
        "stat_keys": np.array(stat_keys),
        "learned_stats": np.array([res.offload_stats[k] for k in stat_keys], np.int64),
        "lru_stats": np.array([dataclasses.asdict(lru.stats)[k] for k in stat_keys], np.int64),
        "n_pages": np.int64(n_pages), "capacity": np.int64(mgrs[0].capacity),
        "seconds": np.float64(seconds),
    }


SERVE_MAMBA2 = {"arch": "mamba2-370m", "seed": 0, "prompt_seed": 1, "batch": 2, "prompt_len": 2048, "n_new": 128,
                "offload": "learned", "hbm_fraction": 0.5, "f32_new": 32}


def _ssd_interpret(x, dt, A_log, b, c, *, chunk, initial_state=None):
    """The engine's SSD through the TPU kernel in interpret mode."""
    from repro.kernels.ssd_scan import kernel

    return kernel.ssd_pallas(x, dt, A_log, b, c, chunk=chunk, initial_state=initial_state, interpret=True)


def ssm_serve_reference(cfg, *, seed, prompt_seed, batch, prompt_len, n_new, offload, hbm_fraction,
                        default_route=True) -> dict:
    """One JAX engine run of an ssm-family model with every step recorded,
    its SSD through ``ssd_pallas(interpret=True)``, and (``default_route``)
    the default path's prefill beside it (see the module docstring)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.kernels.ssd_scan import ops
    from repro.models import lm
    from repro.serving.engine import Engine
    from repro_torch.models.params import numpy_params

    t0 = time.perf_counter()
    params = {k: jnp.asarray(v) for k, v in numpy_params(lm.param_specs(cfg), seed).items()}
    prompt = np.random.default_rng(prompt_seed).integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)

    def state_norms(cache):
        return np.sqrt(np.sum(np.square(np.asarray(cache["ssm"], np.float64)), axis=(3, 4))).astype(np.float32)

    default_ssd = ops.ssd
    ops.ssd = _ssd_interpret
    try:
        eng = Engine(cfg, params, offload=offload, hbm_fraction=hbm_fraction)
        steps, norms = [], []
        prefill, decode = eng.prefill, eng.decode

        def rec_prefill(p, b):
            logits, cache = prefill(p, b)
            steps.append(_topk(logits))
            norms.append(state_norms(cache))
            return logits, cache

        def rec_decode(p, b, cache):
            logits, cache = decode(p, b, cache)
            steps.append(_topk(logits))
            return logits, cache

        eng.prefill, eng.decode = rec_prefill, rec_decode
        res = eng.generate({"tokens": jnp.asarray(prompt)}, n_new=n_new)
    finally:
        ops.ssd = default_ssd
    out = {
        "prompt": prompt, "tokens": np.asarray(res.tokens, np.int32),
        "top_ids": np.stack([s[0] for s in steps]), "top_logits": np.stack([s[1] for s in steps]),
        "margin": np.stack([s[2] for s in steps]), "state_norm": norms[0],
        "offload_stats": np.array(json.dumps(res.offload_stats)), "seconds": np.float64(time.perf_counter() - t0),
    }
    if default_route:
        logits, cache = jax.jit(lm.make_prefill(cfg))(params, {"tokens": jnp.asarray(prompt)})
        out["default_top_ids"], out["default_top_logits"], _ = _topk(logits)
        out["default_state_norm"] = state_norms(cache)
    return out


def export_serve_mamba2() -> None:
    import numpy as np

    from repro.configs import get_config

    cfg = get_config(SERVE_MAMBA2["arch"])
    kw = {k: v for k, v in SERVE_MAMBA2.items() if k not in ("arch", "f32_new")}
    ref = ssm_serve_reference(cfg, **kw)
    f32 = ssm_serve_reference(cfg.replace(dtype="float32"), **{**kw, "n_new": SERVE_MAMBA2["f32_new"]},
                              default_route=False)
    ref.update({f"f32_{k}": v for k, v in f32.items() if k not in ("prompt", "offload_stats")})
    OUT.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT / "serve_mamba2_ref.npz", run=np.array(json.dumps(SERVE_MAMBA2)), **ref)
    # the gap between the reference's two SSD routes at the prefill
    same = ref["default_top_ids"] == ref["top_ids"][0]
    gap = np.abs(ref["default_top_logits"] - ref["top_logits"][0])[same]
    sgap = np.abs(ref["default_state_norm"] / ref["state_norm"] - 1)
    print(json.dumps({"first_tokens": ref["tokens"][:, :8].tolist(), "offload": json.loads(str(ref["offload_stats"])),
                      "routes_top8_ids_equal": bool(same.all()), "routes_max_logit_gap": float(gap.max()),
                      "routes_max_state_norm_rel_gap": float(sgap.max()), "seconds": float(ref["seconds"]),
                      "f32_first_tokens": ref["f32_tokens"][:, :8].tolist(), "f32_seconds": float(ref["f32_seconds"])}))


def export_serve() -> None:
    import json

    import numpy as np

    from repro.configs import get_config

    ref = serve_reference(get_config(SERVE["arch"]), **{k: v for k, v in SERVE.items() if k != "arch"})
    OUT.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT / "serve_qwen2_ref.npz", run=np.array(json.dumps(SERVE)), **ref)
    print(json.dumps({"learned": dict(zip(ref["stat_keys"].tolist(), ref["learned_stats"].tolist())),
                      "lru": dict(zip(ref["stat_keys"].tolist(), ref["lru_stats"].tolist())),
                      "first_tokens": ref["tokens"][:, :8].tolist(), "seconds": float(ref["seconds"])}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache-dir", default=None, help="memoise the pretraining in this directory")
    ap.add_argument("--serve", action="store_true", help="write serve_qwen2_ref.npz (and nothing else)")
    ap.add_argument("--serve-mamba2", action="store_true", help="write serve_mamba2_ref.npz (and nothing else)")
    args = ap.parse_args()
    if args.serve:
        export_serve()
        return
    if args.serve_mamba2:
        export_serve_mamba2()
        return
    if args.cache_dir is None:
        os.environ["REPRO_PRETRAIN_CACHE"] = "0"

    import numpy as np

    from repro.uvm import runtime as R
    from repro.uvm import trace as T
    from repro.uvm.api.session import Session

    if args.cache_dir is not None:
        R.PRETRAIN_CACHE_DIR = Path(args.cache_dir)
    table = Session.paper().pretrained()
    OUT.mkdir(parents=True, exist_ok=True)
    arrays = {"n_slots": np.int64(table.n_slots)}
    for s, e in sorted(table.slots.items()):
        for k, v in e.params.items():
            arrays[f"slot{s}/{k}"] = np.asarray(v, np.float32)
        arrays[f"slot{s}/step"] = np.int64(e.step)
        arrays[f"slot{s}/n_updates"] = np.int64(e.n_updates)
        arrays[f"slot{s}/last_acc"] = np.float64(e.last_acc)
    np.savez_compressed(OUT / "pretrain_paper.npz", **arrays)

    trace = T.get_trace("Hotspot", 1.0)
    ref = {
        "benchmark": "Hotspot", "scale": 1.0, "oversubscription": 1.5,
        "train": {"group_size": GROUP, "epochs": 0, "batch_size": 256},
        "full": _frozen_run(trace, table.clone(), 1.5),
        f"first_{CUT_GROUPS}_groups": _frozen_run(trace.slice(0, CUT_GROUPS * GROUP), table.clone(), 1.5),
    }
    (OUT / "hotspot_paper_ref.json").write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps({k: ref["full"][k] for k in ("stats", "top1", "n_gate_open", "patterns")}))


if __name__ == "__main__":
    main()
