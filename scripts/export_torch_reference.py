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

    PYTHONPATH=src python scripts/export_torch_reference.py --train

writes ``experiments/torch/train_hotspot_ref.npz`` instead: the JAX
package's fine-tuned ``run_ours`` (``TrainConfig()``: groups of 2,048,
3 epochs of batches of 256, lr 3e-3; ``CONFIG``) on Hotspot at scale 1.0
and 150% oversubscription, started from ``pretrain_paper.npz``'s table with
every slot's optimizer moments unset (``opt_state=None``; each slot keeps
its ``step``), because the npz carries no moments and the port's table
from it has none: its stats, top-1, prediction count, per-group accuracy,
gates and patterns.  Beside it, the run's third fine-tune call (the
first on slot 3, whose entry is then the npz slot itself with fresh
moments and ``prev_params`` equal to its params, and whose group has 1,824
of 2,048 samples flagged E∪T): the group's features, flags and
``n_active``, each of its 24 steps' loss and gradient global norm (before
clipping), taken step by step with the package's own jitted
``train_step`` (equal to the scanned ``train_group`` to the last bit,
checked), and the final params (632,066 float32).  It takes about 2.5
minutes on a CPU and writes 2.4 MB.

    PYTHONPATH=src python scripts/export_torch_reference.py --serve-manager

writes ``experiments/torch/serve_manager_ref.npz`` instead: the JAX
package's ``LearnedOffloadManager`` (the ``manager`` offload kind: a fresh
``SMOKE`` manager, one epoch of batches of 32 per group of 64 touches) fed
the page-mass and touched-page stream that ``serve_qwen2_ref.npz`` recorded
(32 pages, 16 resident, 256 steps), so no LM runs: its stats, every
observed batch's prefetch blocks, pattern and accuracy, and the initial
params of all 8 slots its table could draw (``jax.random.key(s)``), which
the port, whose fresh slots draw from ``torch.Generator``s, starts from.
It takes about 15 seconds on a CPU and writes 0.3 MB.

    PYTHONPATH=src python scripts/export_torch_reference.py --tables

writes ``experiments/torch/tables_paper_ref.json`` instead: the JAX
package's cells of the paper's Tables I-IV and VI at the ``paper`` preset
(trace scale 1.0, each trace cut to its first 60,000 accesses) and 125%
oversubscription, for each of the 11 benchmarks: ``run_batch``'s stats of
the five standard cells (``lru``/``hpe`` x ``tree``/``demand``,
``belady`` + ``demand``), ``run_uvmsmart``'s stats, the frozen ``run_ours``
(``TrainConfig(2048, 0, 256)``) and the fine-tuned one (``TrainConfig()``,
the paper's schedule) from ``pretrain_paper.npz``'s table with every slot's
optimizer moments unset (as the port loads it), each with its stats, top-1,
prediction count and per-group accuracies, and the host seconds of each.
Beside them, the rows that ``benchmarks/tables.py``'s ``table1``-``table4``
and ``table6`` build from those cells (``table6`` once with each ``ours``).
It takes about 30 minutes on a CPU, most of it the fine-tuned runs; the
JAX compile cache goes to a temporary directory.

    PYTHONPATH=src python scripts/export_torch_reference.py --concurrent

writes ``experiments/torch/concurrent_paper_ref.json``,
``pretrain_paper_s321.npz`` and ``init_paper_slots.npz`` instead: the
Section V-F cells of ``benchmarks/tables.py``'s ``table7`` and ``table8`` at
the ``paper`` preset (each tenant's trace at scale 1.0 cut to its first
60,000 accesses, merged by ``trace.concurrent`` in slices of 2,048 with
seed 0; the merge is not cut, as in ``Session.trace``) and 125%
oversubscription.  For each of the four pairs: the merge's length and the
SHA-256 of its page, pc, tb, kernel and tenant arrays (int32, in that
order); the frozen (``TrainConfig(2048, 0, 256)``) and fine-tuned
(``TrainConfig()``) ``run_ours`` under ``mux`` and ``merged`` from
``pretrain_paper.npz``'s table with the moments unset (as the port loads
it), each with its stats, top-1, prediction count, per-tenant top-1 and
stats, per-group accuracies, the table's misses and the slots it created;
and Table VII's ``online_single`` (fresh weights) and ``ours`` protocol
runs at ``TrainConfig()``, ``ours`` from Table VII's own Section V-A table
(``PretrainSpec(scale=0.6, seed0=321)`` at ``CONFIG``, two rounds, written
to ``pretrain_paper_s321.npz`` as ``pretrain_paper.npz`` is, and loaded
back the same way).  Beside them, the rows ``table7`` and ``table8`` (once
frozen, once fine-tuned) build from those runs.  ``init_paper_slots.npz``
holds ``Trainer.new_params(s)`` (float32) for exactly the slots those runs
created, which the port, whose fresh slots draw from ``torch.Generator``,
starts from when asked (``fresh=``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "experiments" / "torch"
GROUP = 2048
CUT_GROUPS = 8


def _recorded_run(trace, table, oversub: float, tcfg=None) -> dict:
    """One JAX ``run_ours`` at ``CONFIG`` (frozen unless ``tcfg`` trains),
    with its results and each group's gate and pattern."""
    from repro.configs.predictor_paper import CONFIG
    from repro.core.incremental import TrainConfig
    from repro.uvm import runtime as R

    tcfg = tcfg or TrainConfig(group_size=GROUP, epochs=0, batch_size=256)
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


TRAIN = {"benchmark": "Hotspot", "scale": 1.0, "oversubscription": 1.5, "group_call": 2,
         "train": {"group_size": 2048, "epochs": 3, "batch_size": 256, "lr": 3e-3}}


def _npz_table(trainer, path: Path = OUT / "pretrain_paper.npz"):
    """The JAX model table of ``pretrain_paper.npz`` (or ``path``) with every
    slot's optimizer moments unset (``opt_state=None``), each keeping its
    ``step``."""
    import jax.numpy as jnp

    from repro.core.model_table import Entry, ModelTable
    from repro_torch import convert

    blob = convert.blob_from_npz(path)
    table = ModelTable(lambda s: trainer.new_params(s), n_slots=blob["n_slots"])
    for s, e in blob["slots"].items():
        table.slots[s] = Entry(params={k: jnp.asarray(v) for k, v in e["params"].items()}, step=e["step"],
                               n_updates=e["n_updates"], last_acc=e["last_acc"])
    return table, blob


def _train_steps(trainer, entry, fs, n_active: int, in_et, use_lucir: bool, rng) -> tuple[dict, list, list]:
    """``Trainer.train_group``'s steps one by one with the JAX package's own
    jitted ``train_step``, recording each step's loss and the global norm of
    its gradient before clipping."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core import losses
    from repro.optim import adamw

    pcfg = trainer.pcfg
    idx_mat, _, n_steps = trainer._train_schedule(len(fs), rng)
    feats, labels = trainer._stage(fs)
    et = trainer._stage_et(in_et, len(fs))
    use_l = use_lucir and entry.prev_params is not None
    params = entry.params
    opt = entry.opt_state if entry.opt_state is not None else trainer.opt.init(params)

    def lf(p, batch, lab, f_old, bet):
        logits, f = trainer.forward(p, batch)
        return losses.total_loss(logits, f, lab, n_active=n_active, f_old=f_old,
                                 in_et=None if in_et is None else bet, lam=pcfg.lucir_lambda, mu=pcfg.thrash_mu)[0]

    gnorm = jax.jit(lambda *a: adamw.global_norm(jax.grad(lf)(*a)))
    step_loss, step_gnorm = [], []
    for i in range(n_steps):
        idx = jnp.asarray(idx_mat[i])
        batch = {k: v[idx] for k, v in feats.items()}
        f_old = trainer.forward(entry.prev_params, batch)[1] if use_l else None
        bet = et[idx] if in_et is not None else jnp.zeros((idx.shape[0],), bool)
        step_gnorm.append(float(gnorm(params, batch, labels[idx], f_old, bet)))
        params, opt, metrics = trainer._train_step(
            params, opt, batch, labels[idx], n_active, jnp.asarray(entry.step + i, jnp.int32),
            f_old if use_l else jnp.zeros((idx.shape[0], pcfg.d_model)), bet,
            use_lucir=use_l, use_thrash=in_et is not None)
        step_loss.append(float(metrics["total"]))
    return {k: np.asarray(v) for k, v in params.items()}, step_loss, step_gnorm


def export_train() -> None:
    """The fine-tuned Hotspot run and one of its fine-tune groups (see the
    module docstring)."""
    import time

    import numpy as np

    from repro.configs.predictor_paper import CONFIG
    from repro.core.incremental import TrainConfig, Trainer
    from repro.uvm import trace as T

    t0 = time.perf_counter()
    tcfg = TrainConfig(**TRAIN["train"])
    trainer = Trainer(CONFIG, tcfg)
    trace = T.get_trace(TRAIN["benchmark"], TRAIN["scale"])
    table, blob = _npz_table(trainer)
    calls = []
    train_group = Trainer.train_group

    def recording(self, entry, fs, n_active, *, in_et=None, use_lucir=False, rng=None):
        call = None
        if len(calls) == TRAIN["group_call"]:  # the entry before it trains, and its inputs
            slot = next(s for s, e in table.slots.items() if e is entry)
            same = lambda a, b: all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b)
            call = {"slot": slot, "step": entry.step, "fresh_moments": entry.opt_state is None,
                    "params_are_npz": same(entry.params, blob["slots"][slot]["params"]),
                    "prev_is_params": entry.prev_params is not None and same(entry.prev_params, entry.params),
                    "fs": fs, "n_active": int(n_active), "use_lucir": use_lucir,
                    "in_et": None if in_et is None else np.asarray(in_et, bool)}
        calls.append(call)
        return train_group(self, entry, fs, n_active, in_et=in_et, use_lucir=use_lucir, rng=rng)

    Trainer.train_group = recording
    try:
        run = _recorded_run(trace, table, TRAIN["oversubscription"], tcfg)
    finally:
        Trainer.train_group = train_group
    run_s = time.perf_counter() - t0
    g = calls[TRAIN["group_call"]]
    assert g["params_are_npz"] and g["prev_is_params"] and g["fresh_moments"] and g["in_et"] is not None, \
        "the recorded group does not start from the npz slot's params with fresh moments"
    # the recorded group again, step by step, from the npz slot (prev_params = params, as snapshot_prev leaves it)
    from repro.core.model_table import Entry

    import jax.numpy as jnp
    start = {k: jnp.asarray(v) for k, v in blob["slots"][g["slot"]]["params"].items()}
    entry = Entry(params=start, prev_params=start, step=g["step"])
    final, step_loss, step_gnorm = _train_steps(trainer, entry, g["fs"], g["n_active"], g["in_et"], g["use_lucir"],
                                                np.random.default_rng(tcfg.seed))
    scanned = trainer.train_group(Entry(params=start, prev_params=start, step=g["step"]), g["fs"], g["n_active"],
                                  in_et=g["in_et"], use_lucir=g["use_lucir"])
    scan_gap = max(float(np.abs(np.asarray(scanned.params[k]) - v).max()) for k, v in final.items())
    fs = g["fs"]
    meta = {**TRAIN, "slot": g["slot"], "step": g["step"], "n_active": g["n_active"], "use_lucir": g["use_lucir"],
            "n_steps": len(step_loss), "n_in_et": int(g["in_et"].sum()), "step_by_step_vs_scan_max_abs": scan_gap,
            "run": {k: run[k] for k in ("stats", "top1", "n_predictions", "n_groups", "n_gate_open", "patterns",
                                         "ipc")},
            "run_seconds": run_s, "seconds": time.perf_counter() - t0}
    arrays = {f"group/{f}": np.asarray(getattr(fs, f)) for f in ("page", "delta", "pc", "tb", "label", "label_page",
                                                                  "t_index")}
    arrays.update({f"final/{k}": v.astype(np.float32) for k, v in final.items()})
    np.savez_compressed(OUT / "train_hotspot_ref.npz", run=np.array(json.dumps(meta)), in_et=g["in_et"],
                        step_loss=np.array(step_loss, np.float32), step_grad_norm=np.array(step_gnorm, np.float32),
                        per_group_acc=np.array(run["per_group_acc"], np.float64), **arrays)
    print(json.dumps({k: v for k, v in meta.items()}))


def export_serve_manager() -> None:
    """The JAX ``LearnedOffloadManager`` fed the recorded qwen2 stream, and
    its fresh slots (see the module docstring)."""
    import dataclasses
    import time

    import numpy as np

    from repro.configs.predictor_paper import SMOKE
    from repro.core.incremental import TrainConfig, Trainer
    from repro.serving.offload import LearnedOffloadManager

    t0 = time.perf_counter()
    with np.load(OUT / "serve_qwen2_ref.npz") as z:
        masses, touched = z["page_mass"], z["touched"]
        n_pages, cap = int(z["n_pages"]), int(z["capacity"])
    m = LearnedOffloadManager(n_pages, cap)
    prefetched, batches = [], []
    observe = m._observe_batch

    def recording():
        before = m.stats.prefetches
        observe()
        a = m.last_actions
        prefetched.append(np.asarray(a.prefetch_blocks, np.int64))
        batches.append((int(a.pattern), -1.0 if a.accuracy is None else float(a.accuracy), m.stats.prefetches - before))

    m._observe_batch = recording
    for mass, t in zip(masses, touched):
        m.on_attention(mass, np.nonzero(t)[0])
    mgr = m.manager
    tc = mgr.cfg.train
    assert (tc.group_size, tc.epochs, tc.batch_size) == (64, 1, 32) and mgr.cfg.predictor == SMOKE
    # every slot the manager could reach, as its table's init_fn draws it
    init = Trainer(SMOKE, TrainConfig()).new_params
    arrays = {f"init/slot{s}/{k}": np.asarray(v, np.float32) for s in range(tc.table_slots)
              for k, v in init(s).items()}
    stats = dataclasses.asdict(m.stats)
    meta = {"n_pages": n_pages, "capacity": cap, "stats": stats, "n_batches": len(batches),
            "slots_used": sorted(mgr.table.slots), "top1": mgr.top1, "n_predictions": mgr.n_predictions,
            "seconds": time.perf_counter() - t0}
    np.savez_compressed(OUT / "serve_manager_ref.npz", run=np.array(json.dumps(meta)),
                        prefetch_blocks=np.concatenate(prefetched or [np.zeros(0, np.int64)]),
                        prefetch_offsets=np.cumsum([0] + [len(p) for p in prefetched]),
                        batch_pattern=np.array([b[0] for b in batches], np.int32),
                        batch_accuracy=np.array([b[1] for b in batches], np.float64),
                        batch_prefetched=np.array([b[2] for b in batches], np.int32),
                        per_group_acc=np.array(mgr.per_group, np.float64), **arrays)
    print(json.dumps(meta))


TABLES = {"preset": "paper", "scale": 1.0, "cap": 60_000, "oversubscription": 1.25,
          "cells": [["lru", "tree"], ["lru", "demand"], ["hpe", "demand"], ["hpe", "tree"], ["belady", "demand"]]}


class _TableContext:
    """What ``benchmarks/tables.py``'s ``table1``-``table4`` and ``table6``
    read of a ``Session``, served from cells computed beforehand."""

    def __init__(self, benches, traces, cells, ours, pcfg, tcfg):
        self.benches, self._traces, self._cells, self._ours = benches, traces, cells, ours
        self.pcfg, self.tcfg = pcfg, tcfg

    def trace(self, b):
        return self._traces[b]

    def sim(self, b, policy, prefetch, oversub=1.25):
        return self._cells[b]["sim"][f"{policy}+{prefetch}"]

    def uvmsmart(self, b, oversub=1.25):
        return self._cells[b]["uvmsmart"]

    def ours(self, b, oversub=1.25):
        return self._ours[b]

    def uvmsmart_many(self, names, oversub=1.25):
        return [self.uvmsmart(n) for n in names]

    def ours_many(self, names, oversub=1.25):
        return [self.ours(n) for n in names]


def export_tables() -> None:
    """The JAX package's Table I-IV and VI cells at the paper preset (see
    the module docstring)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="repro_tables_")
    os.environ["REPRO_JAX_CACHE"] = tmp  # read when repro.uvm.api is imported
    try:
        _export_tables(Path(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_tables(tmp: Path) -> None:
    import dataclasses
    import time

    sys.path.insert(0, str(ROOT))  # the benchmarks package
    import benchmarks.common as BC
    import benchmarks.tables as BT
    from repro.configs.predictor_paper import CONFIG
    from repro.core.features import unique_deltas_per_phase
    from repro.core.incremental import TrainConfig, Trainer
    from repro.uvm import runtime as R
    from repro.uvm import simulator as S
    from repro.uvm import trace as T
    from repro.uvm.uvmsmart import run_uvmsmart

    BC.OUT_DIR = tmp  # the tables' CSVs
    t_start = time.perf_counter()
    cells = [tuple(c) for c in TABLES["cells"]]
    frozen_cfg = TrainConfig(group_size=GROUP, epochs=0, batch_size=256)
    tuned_cfg = TrainConfig()
    table, _ = _npz_table(Trainer(CONFIG, tuned_cfg))
    benches = list(T.BENCHMARKS)
    traces, out = {}, {}
    ours = {"frozen": {}, "fine_tuned": {}}
    for b in benches:
        tr = T.get_trace(b, TABLES["scale"])
        tr = traces[b] = tr.slice(0, min(len(tr), TABLES["cap"]))
        rec = {"n_accesses": len(tr), "n_blocks": tr.n_blocks, "seconds": {}}
        t0 = time.perf_counter()
        stats = S.run_batch(tr, [(p, f, TABLES["oversubscription"]) for p, f in cells])
        rec["sim"] = {f"{p}+{f}": st for (p, f), st in zip(cells, stats)}
        rec["seconds"]["sim"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["uvmsmart"] = run_uvmsmart(tr, oversubscription=TABLES["oversubscription"])
        rec["seconds"]["uvmsmart"] = time.perf_counter() - t0
        for kind, tcfg in (("frozen", frozen_cfg), ("fine_tuned", tuned_cfg)):
            t0 = time.perf_counter()
            res = R.run_ours(tr, CONFIG, tcfg, oversubscription=TABLES["oversubscription"], table=table.clone())
            rec["seconds"][f"ours_{kind}"] = time.perf_counter() - t0
            ours[kind][b] = res
            rec[f"ours_{kind}"] = {"stats": res.stats, "top1": res.top1, "n_predictions": res.n_predictions,
                                   "per_group_acc": res.per_group_acc}
        rec["table3"] = unique_deltas_per_phase(tr, 3)
        out[b] = rec
        print(json.dumps({"benchmark": b, **{k: rec[k] for k in ("n_accesses", "seconds")},
                          "ours_fine_tuned_top1": rec["ours_fine_tuned"]["top1"]}), flush=True)
    ctx = _TableContext(benches, traces, out, ours["fine_tuned"], CONFIG, tuned_cfg)
    rows = {name: getattr(BT, name)(ctx) for name in ("table1", "table2", "table3", "table4", "table6")}
    rows["table6_frozen"] = BT.table6(_TableContext(benches, traces, out, ours["frozen"], CONFIG, frozen_cfg))
    ref = {**TABLES, "train": {"frozen": dataclasses.asdict(frozen_cfg), "fine_tuned": dataclasses.asdict(tuned_cfg)},
           "benchmarks": out, "tables": rows, "seconds": time.perf_counter() - t_start}
    (OUT / "tables_paper_ref.json").write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps({"seconds": ref["seconds"], "table6": rows["table6"][0], "table6_frozen": rows["table6_frozen"][0]}))


def _write_table_npz(table, path: Path) -> None:
    """A model table's params as ``pretrain_paper.npz`` stores them."""
    import numpy as np

    arrays = {"n_slots": np.int64(table.n_slots)}
    for s, e in sorted(table.slots.items()):
        for k, v in e.params.items():
            arrays[f"slot{s}/{k}"] = np.asarray(v, np.float32)
        arrays[f"slot{s}/step"] = np.int64(e.step)
        arrays[f"slot{s}/n_updates"] = np.int64(e.n_updates)
        arrays[f"slot{s}/last_acc"] = np.float64(e.last_acc)
    np.savez_compressed(path, **arrays)


CONCURRENT = {"preset": "paper", "scale": 1.0, "cap": 60_000, "oversubscription": 1.25, "slice_len": GROUP,
              "seed": 0, "pairs": [["StreamTriad", "2DCONV"], ["Hotspot", "Srad-v2"], ["NW", "2DCONV"],
                                   ["ATAX", "Srad-v2"]],
              "table7_pretrain": {"scale": 0.6, "seed0": 321, "max_rounds": 2}}


def merge_sha256(trace) -> str:
    """The SHA-256 of a merge's page, pc, tb, kernel and tenant arrays
    (int32, in that order); ``chip_smoke.py`` hashes the port's the same way."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (trace.page, trace.pc, trace.tb, trace.kernel, trace.tenant):
        h.update(np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()


class _ConcurrentContext:
    """What ``benchmarks/tables.py``'s ``table7`` and ``table8`` read of a
    ``Session``, served from runs made beforehand."""

    def __init__(self, tcfg, merges, ours, protocols):
        from repro.uvm.api.specs import PretrainSpec

        self.tcfg, self._merges, self._ours, self._protocols = tcfg, merges, ours, protocols
        self.default_pretrain = PretrainSpec(scale=0.6)

    def concurrent(self, tenants, *, slice_len=256, seed=0):
        assert slice_len == CONCURRENT["slice_len"] and seed == CONCURRENT["seed"]
        return "+".join(tenants)

    def ours(self, w, tenancy="mux"):
        return self._ours[w][tenancy]

    def protocol(self, w, mode, pretrain=None):
        assert (pretrain is None) == (mode == "online_single")
        if pretrain is not None:
            assert (pretrain.scale, pretrain.seed0) == (0.6, 321)
        return self._protocols[w][mode]


def export_concurrent() -> None:
    """The JAX package's Table VII and VIII cells at the paper preset (see
    the module docstring)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="repro_concurrent_")
    os.environ["REPRO_JAX_CACHE"] = tmp  # read when repro.uvm.api is imported
    os.environ["REPRO_PRETRAIN_CACHE"] = "0"
    try:
        _export_concurrent(Path(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_concurrent(tmp: Path) -> None:
    import dataclasses
    import time

    import numpy as np

    sys.path.insert(0, str(ROOT))  # the benchmarks package
    import benchmarks.common as BC
    import benchmarks.tables as BT
    from repro.configs.predictor_paper import CONFIG
    from repro.core.incremental import TrainConfig, Trainer, run_protocol
    from repro.core.model_table import ModelTable
    from repro.uvm import runtime as R
    from repro.uvm import trace as T
    from repro.uvm.api.session import Session
    from repro.uvm.api.specs import PretrainSpec

    BC.OUT_DIR = tmp  # the tables' CSVs
    t_start = time.perf_counter()
    c = CONCURRENT
    frozen_cfg = TrainConfig(group_size=GROUP, epochs=0, batch_size=256)
    tuned_cfg = TrainConfig()
    trainer = Trainer(CONFIG, tuned_cfg)
    base, _ = _npz_table(trainer)
    base_slots = set(base.slots)
    # Table VII's own Section V-A table, written and loaded back as the port loads it
    t0 = time.perf_counter()
    pspec = dataclasses.replace(Session.paper().default_pretrain, seed0=c["table7_pretrain"]["seed0"])
    assert (pspec.scale, pspec.max_rounds) == (c["table7_pretrain"]["scale"], c["table7_pretrain"]["max_rounds"])
    _write_table_npz(Session.paper().pretrained(pspec), OUT / "pretrain_paper_s321.npz")
    t7, _ = _npz_table(trainer, OUT / "pretrain_paper_s321.npz")
    pretrain_s = time.perf_counter() - t0
    created: set = set()

    def tables_of(mgr) -> list:
        return [m.table for m in mgr.managers.values()] if hasattr(mgr, "managers") else [mgr.table]

    def new_slots(tables, start: set) -> list:
        return sorted({s for tb in tables for s in tb.slots} - start)

    out, merges, ours, protocols = {}, {}, {}, {}
    for a, b in c["pairs"]:
        key = f"{a}+{b}"
        parts = []
        for n in (a, b):
            tr = T.get_trace(n, c["scale"])
            parts.append(tr.slice(0, min(len(tr), c["cap"])))
        w = merges[key] = T.concurrent(parts, seed=c["seed"], slice_len=c["slice_len"])
        rec = {"n_accesses": len(w), "n_blocks": w.n_blocks, "parts": [len(p) for p in parts],
               "tenant_names": list(w.tenant_names), "sha256": merge_sha256(w), "runs": {}}
        ours[key] = {}
        for kind, tcfg in (("frozen", frozen_cfg), ("fine_tuned", tuned_cfg)):
            for tenancy in ("mux", "merged"):
                build = R.mux_for if tenancy == "mux" else R.manager_for
                mgr = build(w, CONFIG, tcfg, oversubscription=c["oversubscription"], table=base.clone())
                t0 = time.perf_counter()
                res = R.run_ours(w, CONFIG, tcfg, oversubscription=c["oversubscription"], manager=mgr)
                tables = tables_of(mgr)
                made = new_slots(tables, base_slots)
                created |= set(made)
                rec["runs"][f"{tenancy}_{kind}"] = {
                    "stats": res.stats, "top1": res.top1, "n_predictions": res.n_predictions,
                    "per_tenant_top1": res.per_tenant_top1, "per_tenant_stats": res.per_tenant_stats,
                    "per_group_acc": res.per_group_acc, "warm_top1": res.warm_top1, "n_models": res.n_models,
                    "n_classes": res.n_classes, "misses": sum(tb.misses for tb in tables), "created_slots": made,
                    "seconds": time.perf_counter() - t0}
                ours[key].setdefault(kind, {})[tenancy] = res
                print(json.dumps({"pair": key, "run": f"{tenancy}_{kind}", "top1": res.top1,
                                  "seconds": rec["runs"][f"{tenancy}_{kind}"]["seconds"]}), flush=True)
        protocols[key] = {}
        for mode in ("online_single", "ours"):
            table = (ModelTable(lambda s: trainer.new_params(s), n_slots=tuned_cfg.table_slots)
                     if mode == "online_single" else t7.clone())
            start = set(table.slots)
            t0 = time.perf_counter()
            res = protocols[key][mode] = run_protocol(w, CONFIG, tuned_cfg, mode=mode, table=table)
            made = new_slots([table], start)
            created |= set(made)
            rec["runs"][f"table7_{mode}"] = {"top1": res.top1, "per_group": res.per_group, "n_classes": res.n_classes,
                                             "n_models": res.n_models, "n_samples": res.n_samples,
                                             "misses": table.misses, "created_slots": made,
                                             "seconds": time.perf_counter() - t0}
            print(json.dumps({"pair": key, "run": f"table7_{mode}", "top1": res.top1}), flush=True)
        out[key] = rec
    rows = {"table7": BT.table7(_ConcurrentContext(tuned_cfg, merges, protocols, protocols)),
            "table8": BT.table8(_ConcurrentContext(tuned_cfg, merges,
                                                   {k: v["fine_tuned"] for k, v in ours.items()}, protocols)),
            "table8_frozen": BT.table8(_ConcurrentContext(frozen_cfg, merges,
                                                          {k: v["frozen"] for k, v in ours.items()}, protocols))}
    init = {s: trainer.new_params(s) for s in sorted(created)}
    arrays = {"n_slots": np.int64(tuned_cfg.table_slots)}
    arrays.update({f"slot{s}/{k}": np.asarray(v, np.float32) for s, p in init.items() for k, v in p.items()})
    np.savez_compressed(OUT / "init_paper_slots.npz", **arrays)
    ref = {**c, "train": {"frozen": dataclasses.asdict(frozen_cfg), "fine_tuned": dataclasses.asdict(tuned_cfg)},
           "base_slots": sorted(base_slots), "table7_slots": sorted(t7.slots), "init_slots": sorted(created),
           "pairs_ref": out, "tables": rows, "pretrain_seconds": pretrain_s,
           "seconds": time.perf_counter() - t_start}
    (OUT / "concurrent_paper_ref.json").write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps({"seconds": ref["seconds"], "init_slots": ref["init_slots"], "table7_slots": ref["table7_slots"],
                      "table8": rows["table8"][0], "table8_frozen": rows["table8_frozen"][0]}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache-dir", default=None, help="memoise the pretraining in this directory")
    ap.add_argument("--serve", action="store_true", help="write serve_qwen2_ref.npz (and nothing else)")
    ap.add_argument("--serve-mamba2", action="store_true", help="write serve_mamba2_ref.npz (and nothing else)")
    ap.add_argument("--train", action="store_true", help="write train_hotspot_ref.npz (and nothing else)")
    ap.add_argument("--serve-manager", action="store_true", help="write serve_manager_ref.npz (and nothing else)")
    ap.add_argument("--tables", action="store_true", help="write tables_paper_ref.json (and nothing else)")
    ap.add_argument("--concurrent", action="store_true", help="write concurrent_paper_ref.json, "
                    "pretrain_paper_s321.npz and init_paper_slots.npz (and nothing else)")
    args = ap.parse_args()
    if args.concurrent:
        export_concurrent()
        return
    if args.train:
        export_train()
        return
    if args.serve_manager:
        export_serve_manager()
        return
    if args.tables:
        export_tables()
        return
    if args.serve:
        export_serve()
        return
    if args.serve_mamba2:
        export_serve_mamba2()
        return
    if args.cache_dir is None:
        os.environ["REPRO_PRETRAIN_CACHE"] = "0"

    from repro.uvm import runtime as R
    from repro.uvm import trace as T
    from repro.uvm.api.session import Session

    if args.cache_dir is not None:
        R.PRETRAIN_CACHE_DIR = Path(args.cache_dir)
    table = Session.paper().pretrained()
    OUT.mkdir(parents=True, exist_ok=True)
    _write_table_npz(table, OUT / "pretrain_paper.npz")

    trace = T.get_trace("Hotspot", 1.0)
    ref = {
        "benchmark": "Hotspot", "scale": 1.0, "oversubscription": 1.5,
        "train": {"group_size": GROUP, "epochs": 0, "batch_size": 256},
        "full": _recorded_run(trace, table.clone(), 1.5),
        f"first_{CUT_GROUPS}_groups": _recorded_run(trace.slice(0, CUT_GROUPS * GROUP), table.clone(), 1.5),
    }
    (OUT / "hotspot_paper_ref.json").write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps({k: ref["full"][k] for k in ("stats", "top1", "n_gate_open", "patterns")}))


if __name__ == "__main__":
    main()
