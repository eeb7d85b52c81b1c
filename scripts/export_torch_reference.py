"""Export the JAX package's paper-scale weights and a frozen reference run
for the PyTorch port (``src/repro_torch``).

The port cannot import JAX, and the machine that runs it on the GPU has
none, so this script carries both across as plain files:

* ``experiments/torch/pretrain_paper.npz`` — the Section V-A pretrained
  model table of ``Session.paper()`` (``CONFIG``, 632,066 parameters per
  slot): every slot's params as float32 under ``slot<s>/<param key>``, its
  AdamW moments under ``slot<s>/opt/m/<param key>`` and
  ``slot<s>/opt/v/<param key>`` (float32), its LUCIR snapshot under
  ``slot<s>/prev/<param key>`` where set (pretraining sets none), plus
  ``slot<s>/step``, ``slot<s>/n_updates``, ``slot<s>/last_acc`` and
  ``n_slots``.  Writing it asserts that the params equal the file's already
  there (if any) bit for bit, that the file read back equals the in-memory
  table (params, moments, counters), and that one fine-tune group of its
  most trained slot from the file's table equals one from the in-memory
  table, bit for bit.  Its float32 arrays are stored as byte planes in an
  LZMA zip (``_savez_planes``, as is ``init_paper_slots.npz``); read them
  with ``repro_torch.convert.blob_from_npz``.
* ``experiments/torch/hotspot_paper_ref.json`` — the JAX package's frozen
  ``run_ours`` (``TrainConfig(2048, 0, 256)``, so no weight ever changes)
  on Hotspot at scale 1.0 and 150% oversubscription from that table: the
  stats, top-1, prediction count, per-group accuracy, the number of groups
  whose prefetch gate opened, and the same numbers for the first 8 groups.

    PYTHONPATH=src python scripts/export_torch_reference.py [--cache-dir DIR]

Pretraining takes about a minute on a CPU.  ``--cache-dir`` memoises it in
DIR (default: no memo, nothing is written outside ``experiments/torch``).
``--pretrained`` writes ``pretrain_paper.npz`` only (about 75 seconds).

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
and 150% oversubscription, started from ``pretrain_paper.npz``'s table,
every slot with its AdamW moments: its stats, top-1, prediction count,
per-group accuracy, gates and patterns.  Beside it, the run's third
fine-tune call (the first on slot 3, whose entry is then the npz slot
itself, params and moments, with ``prev_params`` equal to its params, and
whose group has 1,824 of 2,048 samples flagged E∪T): the group's features, flags and
``n_active``, each of its 24 steps' loss and gradient global norm (before
clipping), taken step by step with the package's own jitted
``train_step`` (equal to the scanned ``train_group`` to the last bit,
checked), and the final params (632,066 float32).  It takes about 2.5
minutes on a CPU (4 with other exports beside it) and writes 2.2 MB, its
float32 arrays as byte planes (``_savez_planes``; ``chip_smoke.load_ref``
reads them through ``convert.arrays_from_npz``).

    PYTHONPATH=src python scripts/export_torch_reference.py --serve-manager

writes ``experiments/torch/serve_manager_ref.npz`` instead: the JAX
package's ``LearnedOffloadManager`` (the ``manager`` offload kind: a fresh
``SMOKE`` manager, one epoch of batches of 32 per group of 64 touches) fed
the page-mass and touched-page stream that ``serve_qwen2_ref.npz`` recorded
(32 pages, 16 resident, 256 steps), so no LM runs: its stats, every
observed batch's prefetch blocks, pattern and accuracy, and the initial
params of all 8 slots its table could draw (``jax.random.key(s)``), which
the port starts from (its own draws of them are a few ulp apart here and there).
It takes about 15 seconds on a CPU and writes 0.3 MB.

    PYTHONPATH=src python scripts/export_torch_reference.py --tables

writes ``experiments/torch/tables_paper_ref.json`` instead: the JAX
package's cells of the paper's Tables I-IV and VI at the ``paper`` preset
(trace scale 1.0, each trace cut to its first 60,000 accesses) and 125%
oversubscription, for each of the 11 benchmarks: ``run_batch``'s stats of
the five standard cells (``lru``/``hpe`` x ``tree``/``demand``,
``belady`` + ``demand``), ``run_uvmsmart``'s stats, the frozen ``run_ours``
(``TrainConfig(2048, 0, 256)``) and the fine-tuned one (``TrainConfig()``,
the paper's schedule) from ``pretrain_paper.npz``'s table (moments and
all, as ``Session.paper()`` holds it), each with its stats, top-1,
prediction count and per-group accuracies, and the host seconds of each.
Beside them, the rows that ``benchmarks/tables.py``'s ``table1``-``table4``
and ``table6`` build from those cells (``table6`` once with each ``ours``).
It takes about 4 minutes on a CPU alone (7.5 beside other exports), most
of it the fine-tuned runs; the JAX compile cache goes to a temporary
directory.

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
``pretrain_paper.npz``'s table (moments and all), each with its stats, top-1, prediction count, per-tenant top-1 and
stats, per-group accuracies, the table's misses and the slots it created;
and Table VII's ``online_single`` (fresh weights) and ``ours`` protocol
runs at ``TrainConfig()``, ``ours`` from Table VII's own Section V-A table
(``PretrainSpec(scale=0.6, seed0=321)`` at ``CONFIG``, two rounds, written
to ``pretrain_paper_s321.npz`` as ``pretrain_paper.npz`` is, with the same
checks, and loaded back the same way).  Beside them, the rows ``table7`` and ``table8`` (once
frozen, once fine-tuned) build from those runs.  ``init_paper_slots.npz``
holds ``Trainer.new_params(s)`` (float32) for the slots those runs
created, and for those it held already, which the port (whose own draws
of them are a few ulp apart here and there) starts from when asked
(``fresh=``).

    PYTHONPATH=src python scripts/export_torch_reference.py --figures

writes ``experiments/torch/figures_paper_ref.json`` and
``pretrain_paper_s123.npz`` instead, and adds to ``init_paper_slots.npz``
the slots the figure runs draw fresh weights for (a table's miss, or the
``offline`` protocol's one model, ``Trainer.new_params(tcfg.seed)``): the
reference's ``benchmarks/figures.py`` ``fig3``, ``fig4``, ``fig6``,
``fig11``, ``fig12``, ``fig13`` and ``fig14``, called unchanged on a
``Session.paper(store=RunStore(enabled=False))`` whose default pretrained
table is asserted equal to ``pretrain_paper.npz``'s and whose Fig. 11 table
(``PretrainSpec(scale=0.6, seed0=123)``) is written to
``pretrain_paper_s123.npz`` as ``pretrain_paper.npz`` is.  It records the
figures' rows and seconds, and every cell they read, under readable keys:
each simulator cell's and UVMSmart run's stats and unrounded IPC
(``sim|<benchmark>|<policy>+<prefetch>|<oversubscription>``,
``uvmsmart|<benchmark>|<oversubscription>``), each ``ours``'s stats,
top-1, prediction count, per-group accuracy and IPC at every prediction
overhead (``ours|<benchmark>|<oversubscription>|thrash=<bool>``), each
protocol run's top-1, per-group accuracy and counts
(``protocol|<benchmark>|<mode>``, a chain's links
``...|chain_seed0=123|link<i>``; another predictor kind's
``...|kind=<kind>``).  It takes tens of minutes on a CPU.

    PYTHONPATH=src python scripts/export_torch_reference.py --quick

writes ``experiments/torch/tables_quick_ref.json`` and
``figures_quick_ref.json``, and adds Fig. 10's rows and cells to
``figures_paper_ref.json``: the reference's tables (``table1``-``table4``,
``table6``, ``table8``) and figures (``fig3``, ``fig4``, ``fig6``,
``fig10``, ``fig12``-``fig14``) called unchanged on a quick
``Session(store=RunStore(enabled=False))``, every cell recorded as for the
figures, its ``ours`` from the committed memo of ``Session().pretrained()``
(``experiments/cache/pretrain_0e86a9ef3a27bb0d.pkl``); Table VII and Fig.
11 need quick tables that are not committed and are left out.  Tables IX
and X are computed by the calls ``table9`` and ``table10`` make (those two
functions also rewrite ``BENCH_sim.json``, so they are not called): each
drift trace's SHA-256, each run's stats, top-1, per-group accuracy,
per-tenant stats and budgets, and the rows.  Beside them
(``random_policy``), the ``random`` eviction policy's ``simulator.run`` on
ATAX and Hotspot at the paper preset's scale (``RANDOM_RUNS``): stats and
the SHA-256 of the final state's resident, evicted-once and last-access
arrays.  The pretraining memos are read from a temporary copy, so nothing
under ``experiments/cache/`` is written.  It takes about 4.5 minutes on a
CPU, 2 of them Fig. 10 at the paper preset.  It rewrites both files whole,
so run the two below after it.

    PYTHONPATH=src python scripts/export_torch_reference.py --quick-table7
    PYTHONPATH=src python scripts/export_torch_reference.py --quick-fig11

``--quick-table7`` writes ``experiments/torch/pretrain_quick_s321.npz``, the
quick preset's Table VII table (``PretrainSpec(scale=0.24, seed0=321)`` at
``CONFIG_QUICK``, ``TrainConfig(1024, 2, 128)``, two rounds) as
``pretrain_paper.npz`` is written, with the same checks, and adds to
``tables_quick_ref.json`` the rows of ``benchmarks/tables.py``'s ``table7``
on a recording quick ``Session``, its protocol cells (each pair's
``online_single`` and the ``ours`` from that table: top-1, per-group
accuracies, counts), and ``table7_quick``: the recipe, every slot's
``step``, ``n_updates`` and ``last_acc``, and the SHA-256 of every array of
the file (:func:`table_sha256`).  ``--quick-fig11`` adds to
``figures_quick_ref.json`` Fig. 11's quick rows and cells and
``fig11_quick``: its table's recipe (``seed0=123``; the table is not
written) and every slot's SHA-256 over its params
(:func:`slot_params_sha256`), ``step``, ``n_updates`` and ``last_acc``.  Each
asserts that no key already in its file changes, reads the memos from a
temporary copy, and takes about 40 seconds on a CPU.  Every JSON reference
is written as one line without spaces (:func:`_write_compact`).

    PYTHONPATH=src python scripts/export_torch_reference.py --fault-tolerance

writes ``experiments/torch/fault_tolerance_ref.json`` instead (no parameter
array; about 30 KB): what ``chip_smoke.py`` phase 12 compares, from the JAX
package on a CPU.  (a) The frozen ``run_ours`` on Hotspot x1.5 at
``CONFIG`` from ``pretrain_paper.npz`` (asserted equal to
``hotspot_paper_ref.json``'s), with its warm top-1.  (b) The fine-tuned
``run_ours`` (``TrainConfig()``) on ATAX at the paper preset (scale 1.0,
cut to 60,000 accesses) x1.5 from the same table, moments and all.  (c)
The same frozen Hotspot run with ``HealthConfig()`` and a
``FaultInjector`` wrapping the trainer and the frequency table
(``CHAOS``: ``trainer_exc=0.15, nan_output=0.15, train_exc=0.1,
nan_params=0.1, drop_freq_update=0.2`` with the last three raised to 0.2,
0.2 and 0.5, since under the former no seed of 7-399 fires every site
twice: a quarantined slot restarts cold, its prefetch gate stays shut and
no frequency-table update is left to drop; seed 388, the first from 7 on
under which each of the five sites fires at least twice and the manager
recovers at least once, which the search checks): the injector's counts, the health counters and every round's
``(health, fallback)``.  (d) On StreamTriad+2DCONV (Table VIII's merge at
the paper preset, x1.25, frozen): the ``mux`` run with isolated tables
(asserted equal to ``concurrent_paper_ref.json``'s) and with a shared
table, and the isolated run under ``HealthConfig()`` with ``trainer_exc``
injected into ``evaluate_many`` (``MUX_CHAOS``; seeds searched likewise:
two fires and a recovery): counts, counters, every round's per-tenant
``(health, fallback)``.  (e) The ``LearnedOffloadManager(64, 16,
group=32)`` drive of ``tests/test_fault_tolerance.py`` (``default_rng(9)``,
20 steps): stats, residency, top-1.  (f) ``run_batch`` on ATAX at the paper
preset over ``PLUGIN_CELLS`` with ``lru_clone``, ``mru`` and
``tree_clone`` registered, and Hotspot's fault log (``to_fault_log``,
batches of 256): its SHA-256, line count and the read-back trace's
SHA-256.  It takes a few minutes on a CPU.

    PYTHONPATH=src python scripts/export_torch_reference.py --cli

writes ``experiments/torch/cli_quick_ref.json`` instead (about 30 KB):
what ``chip_smoke.py`` phase 13 compares, from the JAX package's own
``python -m repro.uvm.cli`` run in process on a CPU (``CLI`` holds every
argument list).  Two fault logs written by ``cli export --scale quick``, a
phase-drift one (StreamTriad then PtrChase) and a churn one (StreamTriad
and 2DCONV as tenants): each log's SHA-256, lines and bytes; ``cli serve``
over each at the reference's defaults, every record it prints and its
summary line (the same with ``--checkpoint-every``, asserted equal); and a
``--resume`` from a snapshot taken after the log's first
``CLI["resume_after"]`` lines (a run over that head with
``--checkpoint-dir``): the batch it resumed at and its records.  Beside
them the keys of every spec phase 13 builds: the cells of ``cli sweep
--scale paper`` over ATAX and BICG (and the lines it prints, without the
store's path), the SHA-256 of its ``--dump-spec`` file, that experiment
with UVMSmart cells on ATAX and BICG added, and the ``ours`` cell of ``cli
run --strategy ours --scale paper --benchmark ATAX``.  It takes about a
minute on a CPU.
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


def _write_compact(path: Path, ref: dict) -> None:
    """A JSON reference as one line without spaces (the tracked tree sits
    near the size the driver can copy)."""
    path.write_text(json.dumps(ref, separators=(",", ":")) + "\n")


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
                        default_route=True, norm_axes=(3, 4)) -> dict:
    """One JAX engine run of an ssm- or hybrid-family model with every step
    recorded, its SSD through ``ssd_pallas(interpret=True)``, and
    (``default_route``) the default path's prefill beside it (see the module
    docstring).  The prefill's final SSM states (layer, row, head, P, N) are
    recorded as their norms over ``norm_axes``."""
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
        return np.sqrt(np.sum(np.square(np.asarray(cache["ssm"], np.float64)), axis=norm_axes)).astype(np.float32)

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


SERVE_ZAMBA2 = {"arch": "zamba2-7b", "num_layers": 15, "seed": 0, "prompt_seed": 1, "batch": 2, "prompt_len": 512,
                "n_new": 32, "offload": "learned", "hbm_fraction": 0.5, "f32_new": 16}


def export_serve_zamba2() -> None:
    import hashlib

    import numpy as np

    from repro.configs import get_config

    cfg = get_config(SERVE_ZAMBA2["arch"]).replace(num_layers=SERVE_ZAMBA2["num_layers"])
    kw = {k: v for k, v in SERVE_ZAMBA2.items() if k not in ("arch", "num_layers", "f32_new")}
    ref = ssm_serve_reference(cfg, **kw, norm_axes=(2, 3, 4))
    f32 = ssm_serve_reference(cfg.replace(dtype="float32"), **{**kw, "n_new": SERVE_ZAMBA2["f32_new"]},
                              default_route=False, norm_axes=(2, 3, 4))
    ref.update({f"f32_{k}": v for k, v in f32.items() if k not in ("prompt", "offload_stats")})
    prompt = ref.pop("prompt")
    ref["prompt_sha256"] = np.array(hashlib.sha256(np.ascontiguousarray(prompt, np.int32).tobytes()).hexdigest())
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "serve_zamba2_ref.npz"
    np.savez_compressed(path, run=np.array(json.dumps(SERVE_ZAMBA2)), **ref)
    same = ref["default_top_ids"] == ref["top_ids"][0]
    gap = np.abs(ref["default_top_logits"] - ref["top_logits"][0])[same]
    sgap = np.abs(ref["default_state_norm"] / ref["state_norm"] - 1)
    print(json.dumps({"bytes": path.stat().st_size, "first_tokens": ref["tokens"][:, :8].tolist(),
                      "offload": json.loads(str(ref["offload_stats"])),
                      "routes_top8_ids_equal": bool(same.all()), "routes_max_logit_gap": float(gap.max(initial=0)),
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
    """The JAX model table of ``pretrain_paper.npz`` (or ``path``): every
    slot's params, AdamW moments, LUCIR snapshot where set, ``step``,
    ``n_updates`` and ``last_acc``, as the file stores them."""
    import jax.numpy as jnp

    from repro.core.model_table import Entry, ModelTable
    from repro.optim.adamw import OptState
    from repro_torch import convert

    as_jax = lambda tree: None if tree is None else {k: jnp.asarray(v) for k, v in tree.items()}
    blob = convert.blob_from_npz(path)
    table = ModelTable(lambda s: trainer.new_params(s), n_slots=blob["n_slots"])
    for s, e in blob["slots"].items():
        opt = e["opt_state"]
        table.slots[s] = Entry(params=as_jax(e["params"]), prev_params=as_jax(e["prev_params"]),
                               opt_state=None if opt is None else OptState(m=as_jax(opt.m), v=as_jax(opt.v)),
                               step=e["step"], n_updates=e["n_updates"], last_acc=e["last_acc"])
    return table, blob


def _trees_equal(a, b) -> bool:
    """Two flat dicts of arrays (or two ``OptState``s of them, or two
    ``None``) equal key for key, bit for bit."""
    import numpy as np

    if a is None or b is None:
        return a is None and b is None
    if not isinstance(a, dict):
        return all(_trees_equal(x, y) for x, y in zip(a, b))
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
        for k in a)


def _tables_equal(a, b) -> bool:
    """Two JAX model tables with the same slots, each slot's params, moments,
    snapshot and counters bit for bit."""
    return sorted(a.slots) == sorted(b.slots) and all(
        _trees_equal(x.params, y.params) and _trees_equal(x.opt_state, y.opt_state)
        and _trees_equal(x.prev_params, y.prev_params)
        and (x.step, x.n_updates, x.last_acc) == (y.step, y.n_updates, y.last_acc)
        for x, y in ((a.slots[s], b.slots[s]) for s in a.slots))


def _one_group(trainer, table, slot: int) -> tuple:
    """One JAX fine-tune group (``run_protocol``'s ``ours`` step: snapshot,
    then ``train_group`` with LUCIR) of ``slot`` of a clone of ``table`` on
    Hotspot's first 2,048 accesses at scale 1.0: the params and moments
    after it."""
    from repro.core.features import DeltaVocab, FeatureStream
    from repro.uvm import trace as T

    pcfg = trainer.pcfg
    vocab = DeltaVocab(pcfg.delta_vocab)
    stream = FeatureStream(T.get_trace("Hotspot", 1.0), vocab, pcfg.history, page_vocab=pcfg.page_vocab,
                           pc_vocab=pcfg.pc_vocab, tb_vocab=pcfg.tb_vocab)
    fs = stream.windows(0, GROUP)
    t = table.clone()
    t.slots[slot].prev_params = t.slots[slot].params
    e = trainer.train_group(t.slots[slot], fs, max(vocab.n_classes, 2), use_lucir=True)
    return e.params, e.opt_state


def _export_table(table, path: Path, trainer) -> dict:
    """Write ``table`` (the JAX package's in-memory pretrained table) to
    ``path`` as ``_write_table_npz`` stores it, after asserting that its
    params equal those of the file already there, if any, bit for bit; read
    it back and assert that every slot's params, moments and snapshot equal
    the in-memory table's and that one fine-tune group of its most trained
    slot from the file's table equals one from the in-memory table, bit for
    bit.  Returns what was checked."""
    import numpy as np

    from repro_torch import convert

    kept = None
    if path.exists():
        old = convert.blob_from_npz(path)
        kept = sorted(old["slots"]) == sorted(table.slots) and all(
            _trees_equal(old["slots"][s]["params"], {k: np.asarray(v) for k, v in e.params.items()})
            for s, e in table.slots.items())
        assert kept, f"{path.name}: the pretrained params differ from the committed file's"
    _write_table_npz(table, path)
    back, _ = _npz_table(trainer, path)
    assert _tables_equal(back, table), f"{path.name}: the table read back differs from the in-memory one"
    assert all(e.opt_state is not None for e in back.slots.values()), f"{path.name}: a slot has no moments"
    slot = max(table.slots, key=lambda s: table.slots[s].step)
    got, want = _one_group(trainer, back, slot), _one_group(trainer, table, slot)
    assert _trees_equal(got[0], want[0]) and _trees_equal(got[1], want[1]), \
        f"{path.name}: a fine-tune group from the file's table differs from one from the in-memory table"
    return {"file": path.name, "slots": sorted(table.slots), "params_as_committed": kept,
            "group_equal_slot": slot, "bytes": path.stat().st_size}


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
            call = {"slot": slot, "step": entry.step,
                    "npz_moments": _trees_equal(entry.opt_state, blob["slots"][slot]["opt_state"]),
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
    assert g["params_are_npz"] and g["prev_is_params"] and g["npz_moments"] and g["in_et"] is not None, \
        "the recorded group does not start from the npz slot's params and moments"
    # the recorded group again, step by step, from the npz slot (prev_params = params, as snapshot_prev leaves it)
    from repro.core.model_table import Entry
    from repro.optim.adamw import OptState

    import jax.numpy as jnp
    as_jax = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    start = as_jax(blob["slots"][g["slot"]]["params"])
    moments = blob["slots"][g["slot"]]["opt_state"]
    opt = lambda: OptState(m=as_jax(moments.m), v=as_jax(moments.v))
    entry = Entry(params=start, prev_params=start, opt_state=opt(), step=g["step"])
    final, step_loss, step_gnorm = _train_steps(trainer, entry, g["fs"], g["n_active"], g["in_et"], g["use_lucir"],
                                                np.random.default_rng(tcfg.seed))
    scanned = trainer.train_group(Entry(params=start, prev_params=start, opt_state=opt(), step=g["step"]), g["fs"],
                                  g["n_active"], in_et=g["in_et"], use_lucir=g["use_lucir"])
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
    # float32 arrays as byte planes (``convert.arrays_from_npz`` reads them): 0.21 MB less than deflate
    _savez_planes(OUT / "train_hotspot_ref.npz", {
        "run": np.array(json.dumps(meta)), "in_et": g["in_et"], "step_loss": np.array(step_loss, np.float32),
        "step_grad_norm": np.array(step_gnorm, np.float32),
        "per_group_acc": np.array(run["per_group_acc"], np.float64), **arrays})
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
    _write_compact(OUT / "tables_paper_ref.json", ref)
    print(json.dumps({"seconds": ref["seconds"], "table6": rows["table6"][0], "table6_frozen": rows["table6_frozen"][0]}))


def _savez_planes(path: Path, arrays: dict) -> None:
    """``arrays`` as one ``.npz`` (a zip of ``.npy`` members, LZMA-compressed),
    each float32 array of rank >= 1 as its four byte planes: a uint8 array of
    shape ``(4, *shape)``, least significant byte first, which compresses
    about a tenth better than the float32 bytes.  ``convert.blob_from_npz``
    reads them back bit for bit."""
    import zipfile

    import numpy as np

    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_LZMA) as zf:
        for key, a in arrays.items():
            a = np.asarray(a)
            if a.dtype == np.float32 and a.ndim:
                a = np.ascontiguousarray(np.moveaxis(a.astype("<f4").view(np.uint8).reshape(*a.shape, 4), -1, 0))
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a)


def _write_table_npz(table, path: Path) -> None:
    """A model table as ``pretrain_paper.npz`` stores it: every slot's
    params under ``slot<s>/<param key>``, its AdamW moments under
    ``slot<s>/opt/m/<param key>`` and ``slot<s>/opt/v/<param key>`` and its
    LUCIR snapshot under ``slot<s>/prev/<param key>`` where set (float32),
    ``slot<s>/{step,n_updates,last_acc}`` and ``n_slots``; one compressed
    file (``_savez_planes``)."""
    import numpy as np

    def put(prefix, tree):
        for k, v in tree.items():
            a = np.asarray(v)
            assert a.dtype == np.float32, (prefix, k, a.dtype)
            arrays[prefix + k] = a

    arrays = {"n_slots": np.int64(table.n_slots)}
    for s, e in sorted(table.slots.items()):
        put(f"slot{s}/", e.params)
        if e.opt_state is not None:
            put(f"slot{s}/opt/m/", e.opt_state.m)
            put(f"slot{s}/opt/v/", e.opt_state.v)
        if e.prev_params is not None:
            put(f"slot{s}/prev/", e.prev_params)
        arrays[f"slot{s}/step"] = np.int64(e.step)
        arrays[f"slot{s}/n_updates"] = np.int64(e.n_updates)
        arrays[f"slot{s}/last_acc"] = np.float64(e.last_acc)
    _savez_planes(path, arrays)


def _write_init_slots(trainer, created) -> list:
    """Write ``Trainer.new_params(s)`` (float32) to ``init_paper_slots.npz``
    (``_savez_planes``) for every slot in ``created`` and every slot the file
    already holds, one array set per slot; returns the slots."""
    import numpy as np

    from repro_torch import convert

    path = OUT / "init_paper_slots.npz"
    slots = sorted(set(created) | (set(convert.fresh_slots(path)) if path.exists() else set()))
    arrays = {"n_slots": np.int64(trainer.tcfg.table_slots)}
    arrays.update({f"slot{s}/{k}": np.asarray(v, np.float32) for s in slots
                   for k, v in trainer.new_params(s).items()})
    _savez_planes(path, arrays)
    return slots


CONCURRENT = {"preset": "paper", "scale": 1.0, "cap": 60_000, "oversubscription": 1.25, "slice_len": GROUP,
              "seed": 0, "pairs": [["StreamTriad", "2DCONV"], ["Hotspot", "Srad-v2"], ["NW", "2DCONV"],
                                   ["ATAX", "Srad-v2"]],
              "table7_pretrain": {"scale": 0.6, "seed0": 321, "max_rounds": 2}}


def trace_sha256(trace) -> str:
    """The SHA-256 of a trace's page, pc, tb and kernel arrays and, for a
    merge, its tenant tags (int32, in that order); ``chip_smoke.py`` hashes
    the port's the same way."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (trace.page, trace.pc, trace.tb, trace.kernel) + (() if trace.tenant is None else (trace.tenant,)):
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
    print(json.dumps(_export_table(Session.paper().pretrained(pspec), OUT / "pretrain_paper_s321.npz", trainer)))
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
               "tenant_names": list(w.tenant_names), "sha256": trace_sha256(w), "runs": {}}
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
    _write_init_slots(trainer, created)
    ref = {**c, "train": {"frozen": dataclasses.asdict(frozen_cfg), "fine_tuned": dataclasses.asdict(tuned_cfg)},
           "base_slots": sorted(base_slots), "table7_slots": sorted(t7.slots), "init_slots": sorted(created),
           "pairs_ref": out, "tables": rows, "pretrain_seconds": pretrain_s,
           "seconds": time.perf_counter() - t_start}
    _write_compact(OUT / "concurrent_paper_ref.json", ref)
    print(json.dumps({"seconds": ref["seconds"], "init_slots": ref["init_slots"], "table7_slots": ref["table7_slots"],
                      "table8": rows["table8"][0], "table8_frozen": rows["table8_frozen"][0]}))


FIGURES = {"preset": "paper", "scale": 1.0, "cap": 60_000,
           "figures": ["fig3", "fig4", "fig6", "fig11", "fig12", "fig13", "fig14"],
           "fig11_pretrain": {"scale": 0.6, "seed0": 123, "max_rounds": 2}, "overheads_us": [1, 10, 20, 50, 100]}


def _recording_session(Session):
    """A ``Session`` subclass that records, under readable keys, every cell
    the reference's figures read of it: each simulator cell's and UVMSmart
    run's stats and IPC; each ``ours``'s stats, top-1, prediction count,
    per-group accuracy and IPC at every prediction overhead; each protocol
    run's top-1, per-group accuracy and counts (a chain's links by index)."""

    class RecordingSession(Session):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.cells = {}

        def sims(self, w, cells):
            out = super().sims(w, cells)
            for (p, f, os_), st in zip(cells, out):
                self.cells[f"sim|{w}|{p}+{f}|{os_}"] = {"stats": st, "ipc": self.ipc(w, st)}
            return out

        def uvmsmart(self, w, oversub=1.25):
            st = super().uvmsmart(w, oversub)
            self.cells[f"uvmsmart|{w}|{oversub}"] = {"stats": st, "ipc": self.ipc(w, st)}
            return st

        def ours(self, w, oversub=1.25, seed=0, **kw):
            res = super().ours(w, oversub, seed, **kw)
            key = f"ours|{w}|{oversub}|thrash={kw.get('use_thrash_term', True)}"
            key += f"|tenancy={kw['tenancy']}" if kw.get("tenancy", "mux") != "mux" else ""
            self.cells[key] = {
                "stats": res.stats, "top1": res.top1, "n_predictions": res.n_predictions,
                "per_group_acc": res.per_group_acc, "n_accesses": res.n_accesses,
                "ipc": {str(us): res.ipc(pred_overhead_us=us) for us in FIGURES["overheads_us"]}}
            return res

        def protocol_chain(self, workloads, mode, *, kind="transformer", pretrain=None):
            out = super().protocol_chain(workloads, mode, kind=kind, pretrain=pretrain)
            for i, (w, r) in enumerate(zip(workloads, out)):
                key = f"protocol|{w}|{mode}" + ("" if pretrain is None else f"|chain_seed0={pretrain.seed0}|link{i}")
                key += "" if kind == "transformer" else f"|kind={kind}"
                self.cells[key] = {"top1": r.top1, "per_group": list(r.per_group), "n_classes": r.n_classes,
                                   "n_models": r.n_models, "n_samples": r.n_samples}
            return out

    return RecordingSession


def export_figures() -> None:
    """The JAX package's cells and rows of the paper's Figs. 3, 4, 6 and
    11-14 at the paper preset (see the module docstring)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="repro_figures_")
    os.environ["REPRO_JAX_CACHE"] = tmp  # read when repro.uvm.api is imported
    os.environ["REPRO_PRETRAIN_CACHE"] = "0"
    try:
        _export_figures(Path(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_figures(tmp: Path) -> None:
    import dataclasses
    import time

    sys.path.insert(0, str(ROOT))  # the benchmarks package
    import benchmarks.common as BC
    import benchmarks.figures as BF
    from repro.configs.predictor_paper import CONFIG
    from repro.core.incremental import TrainConfig, Trainer
    from repro.uvm.api.session import FEATURED, Session
    from repro.uvm.api.store import RunStore

    BC.OUT_DIR = tmp  # the figures' CSVs
    t_start = time.perf_counter()
    f = FIGURES
    sess = _recording_session(Session).paper(store=RunStore(enabled=False))
    assert (sess.scale, sess.cap) == (f["scale"], f["cap"])
    trainer = Trainer(CONFIG, TrainConfig())
    # the pretrained tables, before any figure runs: the default one equals
    # pretrain_paper.npz's (params, moments and counters), Fig. 11's is
    # written to pretrain_paper_s123.npz and read back the same way
    t0 = time.perf_counter()
    assert _tables_equal(sess.pretrained(), _npz_table(trainer)[0]), \
        "Session.paper().pretrained() differs from pretrain_paper.npz"
    pspec = dataclasses.replace(sess.default_pretrain, seed0=f["fig11_pretrain"]["seed0"])
    assert (pspec.scale, pspec.max_rounds) == (f["fig11_pretrain"]["scale"], f["fig11_pretrain"]["max_rounds"])
    exported = _export_table(sess.pretrained(pspec), OUT / "pretrain_paper_s123.npz", trainer)
    print(json.dumps(exported), flush=True)
    pretrain_s = time.perf_counter() - t0
    # every slot a figure run draws fresh weights for (a table miss, or the
    # offline protocol's own model): Trainer.new_params's calls
    created: set = set()
    new_params = Trainer.new_params

    def recording(self, seed):
        created.add(int(seed))
        return new_params(self, seed)

    rows, seconds = {}, {}
    Trainer.new_params = recording
    try:
        for name in f["figures"]:
            t0 = time.perf_counter()
            rows[name] = getattr(BF, name)(sess)
            seconds[name] = time.perf_counter() - t0
            print(json.dumps({"figure": name, "seconds": seconds[name], "first_row": rows[name][0]}), flush=True)
    finally:
        Trainer.new_params = new_params
    init_slots = _write_init_slots(trainer, created)
    ref = {**f, "featured": list(FEATURED), "benchmarks": list(sess.benches), "train": dataclasses.asdict(TrainConfig()),
           "fig11_table": exported, "created_slots": sorted(created), "init_slots": init_slots, "cells": sess.cells,
           "figures_rows": rows, "figure_seconds": seconds, "pretrain_seconds": pretrain_s,
           "seconds": time.perf_counter() - t_start}
    _write_compact(OUT / "figures_paper_ref.json", ref)
    print(json.dumps({"seconds": ref["seconds"], "figure_seconds": seconds, "created_slots": ref["created_slots"],
                      "init_slots": init_slots}))

QUICK = {"preset": "quick", "scale": 0.4, "cap": 6000,
         "tables": ["table1", "table2", "table3", "table4", "table6", "table8"],
         "figures": ["fig3", "fig4", "fig6", "fig10", "fig12", "fig13", "fig14"],
         "memos": ["pretrain_0e86a9ef3a27bb0d.pkl", "pretrain_78abbd28fc2f0c99.pkl"]}


def _run_record(res) -> dict:
    return {"stats": res.stats, "top1": res.top1, "n_predictions": res.n_predictions,
            "per_group_acc": list(res.per_group_acc), "per_tenant_stats": res.per_tenant_stats,
            "per_tenant_top1": res.per_tenant_top1, "budgets": res.budgets}


def _table9(sess) -> dict:
    """Table IX's runs and rows, by the calls ``benchmarks/tables.py``'s
    ``table9`` makes (which also rewrites ``BENCH_sim.json``, so it is not
    called): per drift trace the frozen-pattern, 256- and 512-fault
    re-classifying managers from ``PretrainSpec(scale=0.24)``'s table at
    ``TrainSpec(256, 2, 128)``, and ``hpe`` + ``tree``."""
    import numpy as np

    from repro.configs.predictor_paper import CONFIG_QUICK
    from repro.uvm import runtime as R
    from repro.uvm.api.specs import PretrainSpec, TrainSpec

    frozen = 1 << 30
    train = TrainSpec(group_size=256, epochs=2, batch_size=128)
    tcfg = train.to_train_config()
    pretrain = PretrainSpec(scale=0.24)

    def learned(tr, oversub, **kw):
        mgr = R.manager_for(tr, CONFIG_QUICK, tcfg, oversubscription=oversub,
                            table=sess.pretrained(pretrain, pcfg=CONFIG_QUICK, train=train), **kw)
        res = R.run_ours(tr, CONFIG_QUICK, tcfg, oversubscription=oversub, manager=mgr)
        return res, mgr.n_pattern_switches

    cycle = ("StreamTriad", "RandomScan")
    suite = [(dict(phases=cycle + ("StreamTriad",), cap=6000, segment=1024), 1.25),
             (dict(phases=cycle * 2 + ("StreamTriad",), cap=6400, segment=1280), 1.2),
             (dict(phases=cycle * 2 + ("StreamTriad",), cap=6000, segment=1024), 1.3)]
    traces, rows, d_top1, d_thrash = [], [], [], []
    for spec, oversub in suite:
        w = sess.drifting(spec["phases"], scale=0.4, cap=spec["cap"], segment=spec["segment"])
        tr = sess.trace(w)
        froz, _ = learned(tr, oversub, reclass_interval=frozen)
        r256, switches = learned(tr, oversub, reclass_interval=256, reclass_hysteresis=2)
        r512, _ = learned(tr, oversub, reclass_interval=512, reclass_hysteresis=2)
        rule = sess.sim(w, "hpe", "tree", oversub)
        traces.append({**spec, "phases": list(spec["phases"]), "oversub": oversub, "name": tr.name,
                       "n_accesses": len(tr), "sha256": trace_sha256(tr), "switches": switches,
                       "frozen": _run_record(froz), "reclass256": _run_record(r256),
                       "reclass512": _run_record(r512), "rule": rule})
        rows.append({
            "trace": tr.name.replace("drift:", ""), "oversub": oversub,
            "frozen_top1": round(froz.top1, 3), "frozen_thrash": froz.stats["pages_thrashed"],
            "reclass256_top1": round(r256.top1, 3), "reclass256_thrash": r256.stats["pages_thrashed"],
            "switches": switches,
            "reclass512_top1": round(r512.top1, 3), "reclass512_thrash": r512.stats["pages_thrashed"],
            "rule_thrash": rule["pages_thrashed"], "derived": f"dtop1={r256.top1 - froz.top1:+.3f}",
        })
        d_top1.append(r256.top1 - froz.top1)
        d_thrash.append(r256.stats["pages_thrashed"] - froz.stats["pages_thrashed"])
    avg_t1, avg_thr = float(np.mean(d_top1)), float(np.mean(d_thrash))
    rows.insert(0, {"trace": "AVG_RECLASS_VS_FROZEN", "oversub": "", "frozen_top1": "", "frozen_thrash": "",
                    "reclass256_top1": "", "reclass256_thrash": "", "switches": "", "reclass512_top1": "",
                    "reclass512_thrash": "", "rule_thrash": "",
                    "derived": f"dtop1={avg_t1:+.3f} dthrash={avg_thr:+.0f}"})
    return {"train": {"group_size": 256, "epochs": 2, "batch_size": 128}, "traces": traces, "rows": rows}


def _table10() -> dict:
    """Table X's runs and rows, by the calls ``benchmarks/tables.py``'s
    ``table10`` makes (which also rewrites ``BENCH_sim.json``, so it is not
    called): per scenario the well-behaved tenant alone, the shared pool
    and the budgeted mux, from fresh weights."""
    from repro.configs.predictor_paper import CONFIG_QUICK
    from repro.uvm import runtime as R
    from repro.uvm import timing
    from repro.uvm import trace as T
    from repro.uvm import zoo as Z
    from repro.uvm.api.specs import QosSpec, QosTierSpec, TrainSpec

    tcfg = TrainSpec(group_size=256, epochs=2, batch_size=128).to_train_config()
    cut = lambda tr: tr.slice(0, min(len(tr), 3000))

    def tenant_ipc(stats):
        return timing.ipc({"faults": stats["faults"], "pages_thrashed": stats["pages_thrashed"],
                           "migrated_blocks": stats["faults"], "zero_copy": 0}, stats["accesses"])

    scenarios, rows = [], []
    for good, oversub in (("StreamTriad", 2.5), ("Hotspot", 1.6)):
        qos = QosSpec(tiers=(QosTierSpec(good, floor=0.5, share=1.0),
                             QosTierSpec("RandomScan", floor=0.05, share=1.0)))
        solo_tr = cut(T.get_trace(good, scale=0.4))
        merged = T.concurrent([cut(T.get_trace(good, scale=0.4)), cut(Z.get_trace("RandomScan", scale=0.4))],
                              seed=0, slice_len=256)
        solo = R.run_ours(solo_tr, CONFIG_QUICK, tcfg, oversubscription=oversub)
        shared = R.run_ours(merged, CONFIG_QUICK, tcfg, oversubscription=oversub)
        budgeted = R.run_ours(merged, CONFIG_QUICK, tcfg, oversubscription=oversub, qos=qos)
        scenarios.append({"good": good, "oversub": oversub, "solo_sha256": trace_sha256(solo_tr),
                          "merged_sha256": trace_sha256(merged), "solo": _run_record(solo),
                          "shared": _run_record(shared), "budgeted": _run_record(budgeted)})
        for name, res in (("shared", shared), ("budgeted", budgeted)):
            g, sc = res.per_tenant_stats["0"], res.per_tenant_stats["1"]
            ipc_g, ipc_s = tenant_ipc(g), tenant_ipc(sc)
            rows.append({"scenario": f"{good}+RandomScan", "oversub": oversub, "pool": name,
                         "good_thrash": g["pages_thrashed"], "scan_thrash": sc["pages_thrashed"],
                         "solo_thrash": solo.stats["pages_thrashed"], "good_ipc": round(ipc_g, 4),
                         "scan_ipc": round(ipc_s, 4),
                         "ipc_spread": round(max(ipc_g, ipc_s) / max(min(ipc_g, ipc_s), 1e-9), 3),
                         "budgets": res.budgets or ""})
    return {"train": {"group_size": 256, "epochs": 2, "batch_size": 128}, "scenarios": scenarios, "rows": rows}


#: the random policy's runs: (benchmark, prefetch, oversubscription, seed)
#: at the paper preset's scale and cap
RANDOM_RUNS = [["ATAX", "tree", 1.25, 0], ["ATAX", "demand", 1.5, 0], ["Hotspot", "tree", 1.25, 0],
               ["Hotspot", "demand", 1.5, 0]]


def _random_policy() -> list:
    """The ``random`` eviction policy's ``run`` on ``RANDOM_RUNS``: stats
    and the SHA-256 of the final resident, evicted-once and last-access
    arrays."""
    import hashlib

    import numpy as np

    from repro.uvm import simulator as S
    from repro.uvm import trace as T

    out = []
    for b, pf, os_, seed in RANDOM_RUNS:
        tr = T.get_trace(b, 1.0)
        tr = tr.slice(0, min(len(tr), 60_000))
        res = S.run(tr, policy="random", prefetch=pf, oversubscription=os_, seed=seed)
        st = res.state
        h = hashlib.sha256()
        for a in (st.resident, st.evicted_once, st.last_access):
            h.update(np.ascontiguousarray(a).tobytes())
        out.append({"benchmark": b, "prefetch": pf, "oversub": os_, "seed": seed, "n_accesses": len(tr),
                    "stats": {"pages_thrashed": int(st.thrash_events) * 16, "faults": int(st.faults),
                              "migrated_blocks": int(st.migrations), "zero_copy": int(st.zero_copy),
                              "occupancy": int(st.occupancy)},
                    "state_sha256": h.hexdigest()})
    return out


def export_quick() -> None:
    """The JAX package's quick preset, Tables IX and X, and Fig. 10 at the
    paper preset (see the module docstring)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="repro_quick_"))
    os.environ["REPRO_JAX_CACHE"] = str(tmp)  # read when repro.uvm.api is imported
    try:
        _export_quick(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_quick(tmp: Path) -> None:
    import dataclasses
    import shutil
    import time

    sys.path.insert(0, str(ROOT))  # the benchmarks package
    import benchmarks.common as BC
    import benchmarks.figures as BF
    import benchmarks.tables as BT
    from repro.core.incremental import TrainConfig
    from repro.uvm import runtime as R
    from repro.uvm.api.session import Session
    from repro.uvm.api.store import RunStore

    BC.OUT_DIR = tmp  # the tables' and figures' CSVs
    # the committed memos, copied: a recipe without one would pretrain and
    # write its memo into this temporary directory, never experiments/cache/
    R.PRETRAIN_CACHE_DIR = tmp / "pretrain"
    R.PRETRAIN_CACHE_DIR.mkdir()
    for name in QUICK["memos"]:
        shutil.copy(ROOT / "experiments" / "cache" / name, R.PRETRAIN_CACHE_DIR / name)
    Recording = _recording_session(Session)
    t_start = time.perf_counter()
    sess = Recording(store=RunStore(enabled=False))
    assert (sess.scale, sess.cap) == (QUICK["scale"], QUICK["cap"])
    rows, seconds = {}, {}
    for name in QUICK["tables"]:
        t0 = time.perf_counter()
        rows[name] = getattr(BT, name)(sess)
        seconds[name] = time.perf_counter() - t0
    for name, fn in (("table9", lambda: _table9(sess)), ("table10", _table10), ("random_policy", _random_policy)):
        t0 = time.perf_counter()
        rows[name] = fn()
        seconds[name] = time.perf_counter() - t0
        print(json.dumps({"table": name, "seconds": seconds[name], "rows": rows[name]}), flush=True)
    ref = {**QUICK, "train": dataclasses.asdict(TrainConfig(1024, 2, 128)), "benchmarks": list(sess.benches),
           "cells": sess.cells, "tables_rows": rows, "table_seconds": seconds,
           "seconds": time.perf_counter() - t_start}
    _write_compact(OUT / "tables_quick_ref.json", ref)
    t_start = time.perf_counter()
    sess = Recording(store=RunStore(enabled=False))
    rows, seconds = {}, {}
    for name in QUICK["figures"]:
        t0 = time.perf_counter()
        rows[name] = getattr(BF, name)(sess)
        seconds[name] = time.perf_counter() - t0
    ref = {**QUICK, "featured": list(BF.FEATURED), "cells": sess.cells,
           "figures_rows": rows, "figure_seconds": seconds, "seconds": time.perf_counter() - t_start}
    _write_compact(OUT / "figures_quick_ref.json", ref)
    # Fig. 10 at the paper preset, added to figures_paper_ref.json
    path = OUT / "figures_paper_ref.json"
    paper = json.loads(path.read_text())
    sess = Recording.paper(store=RunStore(enabled=False))
    t0 = time.perf_counter()
    paper["figures_rows"]["fig10"] = BF.fig10(sess)
    paper["figure_seconds"]["fig10"] = time.perf_counter() - t0
    paper["cells"].update({k: v for k, v in sess.cells.items() if "|kind=" in k})
    if "fig10" not in paper["figures"]:
        paper["figures"].append("fig10")
    _write_compact(path, paper)
    print(json.dumps({"fig10": paper["figures_rows"]["fig10"], "seconds": paper["figure_seconds"]["fig10"]}))


#: the quick preset's Section V-A tables of Table VII (written to
#: ``pretrain_quick_s321.npz``) and Fig. 11 (measured, not written)
QUICK_TABLE7 = {"scale": 0.24, "seed0": 321, "max_rounds": 2}
QUICK_FIG11 = {"scale": 0.24, "seed0": 123, "max_rounds": 2}


def array_sha256(a) -> str:
    """The SHA-256 of a float32 array's little-endian bytes (C order)."""
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(np.asarray(a), "<f4").tobytes()).hexdigest()


def table_sha256(table) -> dict:
    """Every array of a model table as ``_write_table_npz`` names it
    (``slot<s>/<key>``, ``slot<s>/opt/{m,v}/<key>``, ``slot<s>/prev/<key>``)
    -> its :func:`array_sha256`."""
    out = {}
    for s, e in sorted(table.slots.items()):
        trees = [("", e.params)]
        if e.opt_state is not None:
            trees += [("opt/m/", e.opt_state.m), ("opt/v/", e.opt_state.v)]
        if e.prev_params is not None:
            trees.append(("prev/", e.prev_params))
        out.update({f"slot{s}/{prefix}{k}": array_sha256(v) for prefix, tree in trees for k, v in sorted(tree.items())})
    return out


def slot_params_sha256(params: dict) -> str:
    """One SHA-256 over a slot's params, key by key in sorted order (each
    key's UTF-8 name, then its float32 little-endian bytes);
    ``chip_smoke.py`` hashes the port's slots the same way."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(np.ascontiguousarray(np.asarray(params[k]), "<f4").tobytes())
    return h.hexdigest()


def _unchanged(old, new, path: str = "") -> None:
    """Assert that every key of ``old`` (recursively) holds the same value in
    ``new``: a reference file only gains keys."""
    if isinstance(old, dict):
        assert isinstance(new, dict), path
        for k, v in old.items():
            assert k in new, f"{path}/{k} went missing"
            _unchanged(v, new[k], f"{path}/{k}")
    else:
        assert old == new, f"{path} changed"


def _add_keys(path: Path, add) -> None:
    """Rewrite the JSON file at ``path`` with ``add(ref)``'s new keys, after
    asserting that no key already there changed."""
    import copy

    old = json.loads(path.read_text())
    new = copy.deepcopy(old)
    add(new)
    _unchanged(old, new)
    _write_compact(path, new)


def _quick_session(tmp: Path):
    """A recording quick ``Session(store=RunStore(enabled=False))`` whose
    pretraining memos come from a temporary copy of the committed ones (a
    recipe without one pretrains and writes its memo there, never under
    ``experiments/cache/``)."""
    import shutil

    sys.path.insert(0, str(ROOT))  # the benchmarks package
    import benchmarks.common as BC
    from repro.uvm import runtime as R
    from repro.uvm.api.session import Session
    from repro.uvm.api.store import RunStore

    BC.OUT_DIR = tmp  # the tables' and figures' CSVs
    R.PRETRAIN_CACHE_DIR = tmp / "pretrain"
    R.PRETRAIN_CACHE_DIR.mkdir()
    for name in QUICK["memos"]:
        shutil.copy(ROOT / "experiments" / "cache" / name, R.PRETRAIN_CACHE_DIR / name)
    sess = _recording_session(Session)(store=RunStore(enabled=False))
    assert (sess.scale, sess.cap) == (QUICK["scale"], QUICK["cap"])
    return sess


def export_quick_table7() -> None:
    """Table VII's quick table and cells (see the module docstring)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="repro_quick_table7_"))
    os.environ["REPRO_JAX_CACHE"] = str(tmp)  # read when repro.uvm.api is imported
    try:
        _export_quick_table7(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_quick_table7(tmp: Path) -> None:
    import dataclasses
    import time

    sess = _quick_session(tmp)
    import benchmarks.tables as BT
    from repro.configs.predictor_paper import CONFIG_QUICK
    from repro.core.incremental import TrainConfig, Trainer

    c = QUICK_TABLE7
    pspec = dataclasses.replace(sess.default_pretrain, seed0=c["seed0"])
    assert (pspec.scale, pspec.max_rounds) == (c["scale"], c["max_rounds"]), pspec
    trainer = Trainer(CONFIG_QUICK, TrainConfig(1024, 2, 128))
    t0 = time.perf_counter()
    table = sess.pretrained(pspec)
    pretrain_s = time.perf_counter() - t0
    exported = _export_table(table, OUT / "pretrain_quick_s321.npz", trainer)
    print(json.dumps(exported), flush=True)
    t0 = time.perf_counter()
    rows = BT.table7(sess)
    seconds = time.perf_counter() - t0
    assert len(sess.cells) == 8 and all(k.endswith(("|online_single", f"|ours|chain_seed0={c['seed0']}|link0"))
                                        for k in sess.cells), sorted(sess.cells)

    def add(ref):
        ref["tables_rows"]["table7"] = rows
        ref["table_seconds"]["table7"] = seconds
        assert not set(sess.cells) & set(ref["cells"])
        ref["cells"].update(sess.cells)
        ref["table7_quick"] = {
            "pretrain": c, "train": dataclasses.asdict(trainer.tcfg), "table": exported,
            "slots": {str(s): {"step": e.step, "n_updates": e.n_updates, "last_acc": e.last_acc}
                      for s, e in sorted(table.slots.items())},
            "sha256": table_sha256(table), "pretrain_seconds": pretrain_s}

    _add_keys(OUT / "tables_quick_ref.json", add)
    print(json.dumps({"table7": rows, "seconds": seconds, "pretrain_seconds": pretrain_s}))


def export_quick_fig11() -> None:
    """Fig. 11's quick rows and its table's fingerprint (see the module
    docstring)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="repro_quick_fig11_"))
    os.environ["REPRO_JAX_CACHE"] = str(tmp)  # read when repro.uvm.api is imported
    try:
        _export_quick_fig11(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_quick_fig11(tmp: Path) -> None:
    import dataclasses
    import time

    sess = _quick_session(tmp)
    import benchmarks.figures as BF

    c = QUICK_FIG11
    pspec = dataclasses.replace(sess.default_pretrain, seed0=c["seed0"])
    assert (pspec.scale, pspec.max_rounds) == (c["scale"], c["max_rounds"]), pspec
    t0 = time.perf_counter()
    table = sess.pretrained(pspec)
    pretrain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = BF.fig11(sess)
    seconds = time.perf_counter() - t0

    def add(ref):
        ref["figures_rows"]["fig11"] = rows
        ref["figure_seconds"]["fig11"] = seconds
        for k, v in sess.cells.items():  # fig4's offline and online_single cells are there already
            assert ref["cells"].get(k, v) == v, k
            ref["cells"][k] = v
        ref["fig11_quick"] = {
            "pretrain": c, "slots": {str(s): {"sha256": slot_params_sha256(e.params), "step": e.step,
                                              "n_updates": e.n_updates, "last_acc": e.last_acc}
                                     for s, e in sorted(table.slots.items())},
            "pretrain_seconds": pretrain_s}

    _add_keys(OUT / "figures_quick_ref.json", add)
    print(json.dumps({"fig11": rows, "seconds": seconds, "pretrain_seconds": pretrain_s}))


FAULT_TOLERANCE = {"scale": 1.0, "cap": 60_000, "hotspot_oversub": 1.5, "atax_oversub": 1.5,
                   "pair": ["StreamTriad", "2DCONV"], "pair_oversub": 1.25}
# seed 388 is the first from 7 on that fires every site twice and recovers
# under these probabilities (a stub predictor with the frozen model's
# per-group accuracies, which draws exactly as the real run does, screened
# seeds 7-399; under the starting ones, 0.15/0.15/0.1/0.1/0.2, none does)
CHAOS = {"seed": 388, "trainer_exc": 0.15, "nan_output": 0.15, "train_exc": 0.2, "nan_params": 0.2,
         "drop_freq_update": 0.5}
CHAOS_SITES = ("trainer_exc", "nan_output", "train_exc", "nan_params", "drop_freq_update")
# seed 20 is the first from 7 on with two fires and a recovery (the search checks it)
MUX_CHAOS = {"seed": 20, "trainer_exc": 0.3}
PLUGIN_CELLS = [["lru", "tree", 1.25], ["lru_clone", "tree", 1.25], ["mru", "tree", 1.25], ["mru", "demand", 1.5],
                ["lru", "tree_clone", 1.25]]


def _ft_run(res) -> dict:
    out = {"stats": res.stats, "top1": res.top1, "warm_top1": res.warm_top1, "n_predictions": res.n_predictions,
           "per_group_acc": res.per_group_acc}
    if res.per_tenant_top1 is not None:
        out.update(per_tenant_top1=res.per_tenant_top1, per_tenant_stats=res.per_tenant_stats)
    return out


def _chaos_run(build, trace, oversub, schedule, tcfg) -> dict:
    """One frozen ``run_ours`` through ``build()``'s manager (or mux) with
    ``HealthConfig()`` on, its trainer (and a manager's frequency table)
    wrapped by a ``FaultInjector(schedule)``: the run, the injector's
    counts, the health counters and every round's ``(health, fallback)``
    (a mux's per tenant)."""
    from repro.configs.predictor_paper import CONFIG
    from repro.uvm import runtime as R
    from repro.uvm.manager import ChaosSchedule, FaultInjector, TenantMux

    inj = FaultInjector(ChaosSchedule(**schedule))
    mgr = build()
    mgr.trainer = inj.wrap_trainer(mgr.trainer)
    if not isinstance(mgr, TenantMux):
        mgr.freq_table = inj.wrap_freq_table(mgr.freq_table)
    seq, observe = [], mgr.observe

    def recording(batch):
        a = observe(batch)
        if isinstance(mgr, TenantMux):
            seq.append({str(k): [t.health, t.fallback] for k, t in a.per_tenant.items()})
        else:
            seq.append([a.health, a.fallback])
        return a

    mgr.observe = recording
    res = R.run_ours(trace, CONFIG, tcfg, oversubscription=oversub, manager=mgr)
    return {"schedule": dict(schedule), "counts": dict(inj.counts), "n_health_faults": mgr.n_health_faults,
            "n_fallbacks": mgr.n_fallbacks, "n_recoveries": mgr.n_recoveries, "sequence": seq, "run": _ft_run(res)}


def _search_chaos(build, trace, oversub, schedule, tcfg, sites, tries: int = 60) -> dict:
    """The first seed from ``schedule["seed"]`` on whose run fires each of
    ``sites`` at least twice and recovers at least once."""
    for seed in range(schedule["seed"], schedule["seed"] + tries):
        rec = _chaos_run(build, trace, oversub, dict(schedule, seed=seed), tcfg)
        print(json.dumps({"seed": seed, "counts": rec["counts"], "recoveries": rec["n_recoveries"]}), flush=True)
        if all(rec["counts"].get(k, 0) >= 2 for k in sites) and rec["n_recoveries"] >= 1:
            return rec
    raise RuntimeError(f"no seed in {tries} fires every site twice and recovers")


def export_fault_tolerance() -> None:
    """The JAX package's runs that phase 12 compares (see the module
    docstring)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="repro_ft_")
    os.environ["REPRO_JAX_CACHE"] = tmp
    os.environ["REPRO_PRETRAIN_CACHE"] = "0"
    try:
        _export_fault_tolerance(Path(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_fault_tolerance(tmp: Path) -> None:
    import dataclasses
    import hashlib
    import time

    import numpy as np

    from repro.configs.predictor_paper import CONFIG
    from repro.core.incremental import TrainConfig, Trainer
    from repro.serving.offload import LearnedOffloadManager
    from repro.uvm import registry as REG
    from repro.uvm import runtime as R
    from repro.uvm import simulator as S
    from repro.uvm import trace as T
    from repro.uvm.manager import HealthConfig

    t_start = time.perf_counter()
    c = FAULT_TOLERANCE
    frozen = TrainConfig(group_size=GROUP, epochs=0, batch_size=256)
    tuned = TrainConfig()
    trainer = Trainer(CONFIG, tuned)
    base, _ = _npz_table(trainer)
    cut = lambda name: (lambda tr: tr.slice(0, min(len(tr), c["cap"])))(T.get_trace(name, c["scale"]))
    out = {**c, "train": {"frozen": dataclasses.asdict(frozen), "fine_tuned": dataclasses.asdict(tuned)},
           "health": dataclasses.asdict(HealthConfig())}
    # (a) the frozen Hotspot run
    hot = T.get_trace("Hotspot", c["scale"])
    t0 = time.perf_counter()
    res = R.run_ours(hot, CONFIG, frozen, oversubscription=c["hotspot_oversub"], table=base.clone())
    out["hotspot"] = {**_ft_run(res), "seconds": time.perf_counter() - t0}
    full = json.loads((OUT / "hotspot_paper_ref.json").read_text())["full"]
    assert {k: full[k] for k in ("stats", "top1", "n_predictions", "per_group_acc")} == \
        {k: out["hotspot"][k] for k in ("stats", "top1", "n_predictions", "per_group_acc")}, "(a) != hotspot ref"
    print(json.dumps({"a": out["hotspot"]["stats"], "top1": res.top1}), flush=True)
    # (b) the fine-tuned ATAX run
    atax = cut("ATAX")
    t0 = time.perf_counter()
    res = R.run_ours(atax, CONFIG, tuned, oversubscription=c["atax_oversub"], table=base.clone())
    out["atax_tuned"] = {**_ft_run(res), "n_accesses": len(atax), "seconds": time.perf_counter() - t0}
    print(json.dumps({"b": out["atax_tuned"]["stats"], "top1": res.top1}), flush=True)
    # (c) the health machine under chaos, frozen Hotspot
    build = lambda: R.manager_for(hot, CONFIG, frozen, oversubscription=c["hotspot_oversub"], table=base.clone(),
                                  health=HealthConfig())
    out["chaos"] = _search_chaos(build, hot, c["hotspot_oversub"], CHAOS, frozen, CHAOS_SITES)
    # (d) the mux on StreamTriad+2DCONV
    parts = [cut(n) for n in c["pair"]]
    w = T.concurrent(parts, seed=CONCURRENT["seed"], slice_len=CONCURRENT["slice_len"])
    key = "+".join(c["pair"])
    conc = json.loads((OUT / "concurrent_paper_ref.json").read_text())["pairs_ref"][key]
    assert trace_sha256(w) == conc["sha256"]
    mux = {"sha256": trace_sha256(w), "n_accesses": len(w)}
    for name, shared in (("mux", False), ("mux_shared", True)):
        m = R.mux_for(w, CONFIG, frozen, oversubscription=c["pair_oversub"], table=base.clone(),
                      shared_freq_table=shared)
        mux[name] = _ft_run(R.run_ours(w, CONFIG, frozen, oversubscription=c["pair_oversub"], manager=m))
    want = conc["runs"]["mux_frozen"]
    assert {k: want[k] for k in ("stats", "top1", "per_tenant_top1", "per_tenant_stats")} == \
        {k: mux["mux"][k] for k in ("stats", "top1", "per_tenant_top1", "per_tenant_stats")}, "(d) != concurrent ref"
    build = lambda: R.mux_for(w, CONFIG, frozen, oversubscription=c["pair_oversub"], table=base.clone(),
                              health=HealthConfig())
    mux["chaos"] = _search_chaos(build, w, c["pair_oversub"], MUX_CHAOS, frozen, ("trainer_exc",))
    out["mux"] = mux
    print(json.dumps({"d": {k: v["stats"] for k, v in mux.items() if k in ("mux", "mux_shared")}}), flush=True)
    # (e) the KV offload drive
    off = LearnedOffloadManager(64, 16, group=32)
    rng = np.random.default_rng(9)
    for _ in range(20):
        touched = rng.integers(0, 64, 16)
        mass = np.zeros(64)
        mass[touched] = 1.0
        off.on_attention(mass, touched)
    out["offload"] = {"stats": dataclasses.asdict(off.stats), "resident": np.flatnonzero(off.resident).tolist(),
                      "top1": off.manager.top1, "observed_batches": 20 * 16 // 32}
    # (f) plug-ins through run_batch, and the fault log
    from repro.uvm.simulator import _tree_mask

    with REG.scoped():
        REG.register_policy("lru_clone", lambda st, i, t: (st.last_access,))
        REG.register_policy("mru", lambda st, i, t: (-st.last_access,))
        REG.register_prefetcher("tree_clone", _tree_mask)
        stats = S.run_batch(atax, [tuple(x) for x in PLUGIN_CELLS])
    out["plugins"] = {"cells": PLUGIN_CELLS, "stats": stats, "n_accesses": len(atax)}
    log = tmp / "hotspot.jsonl"
    lines = T.to_fault_log(hot, log)
    back = T.from_fault_log(log)
    out["fault_log"] = {"batch": 256, "lines": lines, "sha256": hashlib.sha256(log.read_bytes()).hexdigest(),
                        "bytes": log.stat().st_size, "trace_sha256": trace_sha256(hot),
                        "read_back_sha256": trace_sha256(back)}
    out["seconds"] = time.perf_counter() - t_start
    _write_compact(OUT / "fault_tolerance_ref.json", out)
    print(json.dumps({"seconds": out["seconds"], "chaos_seed": out["chaos"]["schedule"]["seed"],
                      "mux_chaos_seed": mux["chaos"]["schedule"]["seed"], "plugins": stats}))


#: phase 13's command lines (``cli_quick_ref.json`` carries them)
CLI = {
    "logs": {"drift": ["--scale", "quick", "--phases", "StreamTriad", "PtrChase"],
             "churn": ["--scale", "quick", "--phases", "StreamTriad", "2DCONV", "--drift-kind", "churn"]},
    "checkpoint_every": 4,
    "resume_after": {"drift": 7, "churn": 8},  # lines of the log (its header included) before the snapshot
    "sweep": ["--scale", "paper", "--benchmarks", "ATAX", "BICG", "--policies", "lru", "hpe", "--prefetchers",
              "demand", "tree", "--oversubs", "1.25"],
    "extra": [["ATAX", 1.25], ["BICG", 1.25]],  # UVMSmart cells added to the dumped spec
    "run": ["--strategy", "ours", "--scale", "paper", "--benchmark", "ATAX"],
}


def _cli_lines(cli, argv: list) -> list[str]:
    """``cli.main(argv)``'s standard output, line by line (it must exit 0)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0, argv
    return buf.getvalue().splitlines()


def export_cli() -> None:
    """The JAX package's CLI runs that phase 13 compares (see the module
    docstring)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="repro_cli_")
    os.environ["REPRO_JAX_CACHE"] = tmp
    try:
        _export_cli(Path(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export_cli(tmp: Path) -> None:
    import argparse as ap_mod
    import hashlib
    import time

    from repro.uvm import cli
    from repro.uvm.api import CellSpec, ExperimentSpec, PolicySpec, PrefetchSpec, WorkloadSpec

    t_start = time.perf_counter()
    out = {"cli": CLI, "logs": {}}
    for name, argv in CLI["logs"].items():
        log = tmp / f"{name}.jsonl"
        _cli_lines(cli, ["export", *argv, "--no-store", "--out", str(log)])
        text = log.read_text()
        rec = {"sha256": hashlib.sha256(text.encode()).hexdigest(), "lines": len(text.splitlines()),
               "bytes": len(text.encode())}
        lines = _cli_lines(cli, ["serve", "--input", str(log)])
        rec["records"], rec["summary"] = [l for l in lines if l.startswith("{")], lines[-1]
        assert len(lines) == len(rec["records"]) + 1
        ck = ["--checkpoint-dir", str(tmp / f"{name}_ck"), "--checkpoint-every", str(CLI["checkpoint_every"])]
        assert _cli_lines(cli, ["serve", "--input", str(log), *ck]) == lines
        head = tmp / f"{name}_head.jsonl"
        head.write_text("".join(text.splitlines(keepends=True)[: CLI["resume_after"][name]]))
        ck = ["--checkpoint-dir", str(tmp / f"{name}_resume"), "--checkpoint-every", str(CLI["checkpoint_every"])]
        _cli_lines(cli, ["serve", "--input", str(head), *ck])
        res = _cli_lines(cli, ["serve", "--input", str(log), *ck, "--resume"])
        at = int(res[0].split("batch=")[1].split()[0])
        rec["resumed"] = {"batch": at, "records": [l for l in res if l.startswith("{")], "summary": res[-1]}
        assert rec["resumed"]["records"] == rec["records"][at:] and res[-1] == rec["summary"]
        out["logs"][name] = rec
        print(json.dumps({name: {k: rec[k] for k in ("sha256", "lines")}, "batches": len(rec["records"]),
                          "resumed_at": at}), flush=True)
    runs = tmp / "runs"
    spec_path = tmp / "spec.json"
    lines = _cli_lines(cli, ["sweep", *CLI["sweep"], "--runs-dir", str(runs), "--dump-spec", str(spec_path)])
    spec = ExperimentSpec.from_json(spec_path.read_text())
    extra = tuple(CellSpec(WorkloadSpec(b, 1.0, 60_000), "uvmsmart", PolicySpec("adaptive"), PrefetchSpec("adaptive"),
                           os_) for b, os_ in CLI["extra"])
    replay = ExperimentSpec.from_dict({**spec.to_dict(), "extra_cells": [c.to_dict() for c in extra]})
    strip = lambda ls: [l.split(" store=")[0] for l in ls if not l.startswith("# wrote")]
    session = cli._session(ap_mod.Namespace(scale="paper", cap=None, runs_dir=None, no_store=True))
    [ours] = ExperimentSpec(name="run", workloads=(session.workload("ATAX"),), strategy="ours",
                            policies=(PolicySpec("lru"),), prefetchers=(PrefetchSpec("tree"),),
                            oversubscriptions=(1.25,),
                            model=cli._strategy_model(session, "ours", "transformer")).cells()
    out["keys"] = {
        "sweep": spec.key, "sweep_cells": [c.key for c in spec.cells()], "sweep_lines": strip(lines),
        "dump_sha256": hashlib.sha256(spec_path.read_bytes()).hexdigest(),
        "replay": replay.key, "replay_cells": [c.key for c in replay.cells()], "run_ours": ours.key,
        "run_ours_model": ours.model.key,
    }
    out["seconds"] = time.perf_counter() - t_start
    _write_compact(OUT / "cli_quick_ref.json", out)
    print(json.dumps({"seconds": out["seconds"], "keys": {k: v for k, v in out["keys"].items() if "cells" not in k
                                                          and k != "sweep_lines"}}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache-dir", default=None, help="memoise the pretraining in this directory")
    ap.add_argument("--pretrained", action="store_true", help="write pretrain_paper.npz (and nothing else)")
    ap.add_argument("--figures", action="store_true", help="write figures_paper_ref.json, pretrain_paper_s123.npz "
                    "and the figure runs' slots in init_paper_slots.npz (and nothing else)")
    ap.add_argument("--serve", action="store_true", help="write serve_qwen2_ref.npz (and nothing else)")
    ap.add_argument("--serve-mamba2", action="store_true", help="write serve_mamba2_ref.npz (and nothing else)")
    ap.add_argument("--serve-zamba2", action="store_true", help="write serve_zamba2_ref.npz (and nothing else)")
    ap.add_argument("--train", action="store_true", help="write train_hotspot_ref.npz (and nothing else)")
    ap.add_argument("--serve-manager", action="store_true", help="write serve_manager_ref.npz (and nothing else)")
    ap.add_argument("--tables", action="store_true", help="write tables_paper_ref.json (and nothing else)")
    ap.add_argument("--concurrent", action="store_true", help="write concurrent_paper_ref.json, "
                    "pretrain_paper_s321.npz and init_paper_slots.npz (and nothing else)")
    ap.add_argument("--quick", action="store_true", help="write tables_quick_ref.json, figures_quick_ref.json "
                    "and Fig. 10's rows in figures_paper_ref.json (and nothing else)")
    ap.add_argument("--fault-tolerance", action="store_true", help="write fault_tolerance_ref.json (and nothing "
                    "else)")
    ap.add_argument("--cli", action="store_true", help="write cli_quick_ref.json (and nothing else)")
    ap.add_argument("--quick-table7", action="store_true", help="write pretrain_quick_s321.npz and add Table VII's "
                    "rows and cells to tables_quick_ref.json (and nothing else)")
    ap.add_argument("--quick-fig11", action="store_true", help="add Fig. 11's rows and cells and its table's "
                    "fingerprint to figures_quick_ref.json (and nothing else)")
    args = ap.parse_args()
    if args.quick_table7:
        export_quick_table7()
        return
    if args.quick_fig11:
        export_quick_fig11()
        return
    if args.cli:
        export_cli()
        return
    if args.fault_tolerance:
        export_fault_tolerance()
        return
    if args.quick:
        export_quick()
        return
    if args.figures:
        export_figures()
        return
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
    if args.serve_zamba2:
        export_serve_zamba2()
        return
    if args.cache_dir is None:
        os.environ["REPRO_PRETRAIN_CACHE"] = "0"

    from repro.uvm import runtime as R
    from repro.uvm import trace as T
    from repro.uvm.api.session import Session

    from repro.configs.predictor_paper import CONFIG
    from repro.core.incremental import TrainConfig, Trainer

    if args.cache_dir is not None:
        R.PRETRAIN_CACHE_DIR = Path(args.cache_dir)
    table = Session.paper().pretrained()
    OUT.mkdir(parents=True, exist_ok=True)
    print(json.dumps(_export_table(table, OUT / "pretrain_paper.npz", Trainer(CONFIG, TrainConfig()))))
    if args.pretrained:
        return

    trace = T.get_trace("Hotspot", 1.0)
    ref = {
        "benchmark": "Hotspot", "scale": 1.0, "oversubscription": 1.5,
        "train": {"group_size": GROUP, "epochs": 0, "batch_size": 256},
        "full": _recorded_run(trace, table.clone(), 1.5),
        f"first_{CUT_GROUPS}_groups": _recorded_run(trace.slice(0, CUT_GROUPS * GROUP), table.clone(), 1.5),
    }
    _write_compact(OUT / "hotspot_paper_ref.json", ref)
    print(json.dumps({k: ref["full"][k] for k in ("stats", "top1", "n_gate_open", "patterns")}))


if __name__ == "__main__":
    main()
