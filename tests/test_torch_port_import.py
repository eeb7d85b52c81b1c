"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package, and its entry points run on the card unless the
caller asks for the CPU."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"

_CHILD = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": len(names), "leaked": leaked}))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 46
    assert res["leaked"] == []


_SERVE_CHILD = """
import json, sys
import repro_torch.launch.serve, repro_torch.serving.engine, repro_torch.models.mamba2, repro_torch.kernels.ssd_scan
import repro_torch.core.losses, repro_torch.kernels.thrash_ce, repro_torch.optim.adamw, repro_torch.serving.offload
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print(json.dumps(leaked))
"""


def test_serving_entry_point_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _SERVE_CHILD], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_tables_entry_point_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    child = _SERVE_CHILD.replace("import repro_torch.launch.serve", "import repro_torch.bench.tables, "
                                 "repro_torch.uvm.uvmsmart, repro_torch.launch.serve")
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_multi_tenant_modules_import_no_jax():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    child = _SERVE_CHILD.replace("import repro_torch.launch.serve", "import repro_torch.uvm.manager.multi, "
                                 "repro_torch.bench.tables, repro_torch.launch.serve")
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_figures_entry_point_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    child = _SERVE_CHILD.replace("import repro_torch.launch.serve", "import repro_torch.bench.figures, "
                                 "repro_torch.launch.serve")
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_bench_driver_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    child = _SERVE_CHILD.replace("import repro_torch.launch.serve", "import repro_torch.bench.run, "
                                 "repro_torch.launch.serve")
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_figures_entry_point_defaults_to_the_card():
    from repro_torch.bench import figures
    from repro_torch.configs.predictor_paper import SMOKE
    from repro_torch.core.incremental import TrainConfig, run_protocol
    from repro_torch.uvm import trace as T

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        figures.main(["--only", "fig3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_protocol(T.get_trace("AddVectors", 0.1), SMOKE, TrainConfig(), mode="offline")
    assert figures.Context(device="cpu").device.type == "cpu"


def test_experiment_surface_imports_no_jax():
    """``repro_torch.uvm.cli`` and ``repro_torch.uvm.api`` (Session, the run
    store, the specs) and the serve state machine stand alone."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    child = _SERVE_CHILD.replace("import repro_torch.launch.serve", "import repro_torch.uvm.cli, repro_torch.uvm.api, "
                                 "repro_torch.uvm.server, repro_torch.uvm.sweeps, repro_torch.launch.serve")
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_experiment_surface_defaults_to_the_card(tmp_path):
    from repro_torch.configs.predictor_paper import SMOKE
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.uvm import cli
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import trace as T
    from repro_torch.uvm.api import RunStore, Session

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    store = RunStore(tmp_path, enabled=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(store=store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session.paper(store=store)
    tr = T.get_trace("AddVectors", 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.run_ours_many([tr], SMOKE, TrainConfig(epochs=0))
    for argv in (["run", "--benchmark", "ATAX", "--no-store"], ["sweep", "--benchmarks", "ATAX", "--no-store"],
                 ["export", "--benchmark", "ATAX", "--no-store"], ["serve", "--input", str(tmp_path / "none")]):
        assert cli.build_parser().parse_args(argv).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert Session(store=store, device="cpu").device.type == "cpu"
    assert R.run_ours_many([tr], SMOKE, TrainConfig(group_size=256, epochs=0), device="cpu")[0].n_accesses == len(tr)


def test_port_sources_name_no_jax_import():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.", "from repro.", "from repro import")), \
                f"{path}: {s}"


def test_entry_points_default_to_the_card():
    from repro_torch.configs.predictor_paper import SMOKE
    from repro_torch.core import predictor
    from repro_torch.core.incremental import TrainConfig, Trainer
    from repro_torch.core.policy import PredictionFrequencyTable
    from repro_torch.models.params import init_params
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import simulator as S
    from repro_torch.uvm import trace as T
    from repro_torch.uvm.manager import ManagerConfig, OversubscriptionManager

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    tr = T.get_trace("AddVectors", 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.run_ours(tr, SMOKE, TrainConfig(epochs=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.manager_for(tr, SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OversubscriptionManager(ManagerConfig(predictor=SMOKE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(SMOKE, TrainConfig())
    # the public functions below the manager default to the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.init_state(64)
    # the tables' path: run, run_batch, UVMSmart and the table runner
    from repro_torch.bench import tables
    from repro_torch.uvm.uvmsmart import run_uvmsmart

    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.run(tr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.run_batch(tr, [("lru", "tree", 1.25)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_uvmsmart(tr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tables.Context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tables.main(["--only", "table6"])
    assert S.run(tr, device="cpu").state.device.type == "cpu"
    assert tables.Context(device="cpu").device.type == "cpu"
    # the tenant path: mux_for, the tagged run_ours, TenantMux
    from repro_torch.uvm.manager import TenantMux

    merge = T.concurrent([tr, T.get_trace("ATAX", 0.1)], slice_len=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.mux_for(merge, SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.run_ours(merge, SMOKE, TrainConfig(epochs=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.run_ours(merge, SMOKE, TrainConfig(epochs=0), multi_tenant=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TenantMux(ManagerConfig(predictor=SMOKE), (0, 1))
    assert R.mux_for(merge, SMOKE, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictionFrequencyTable()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predictor.init(0, SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(0, predictor.param_specs(SMOKE))
    # the serving path: the engine, its managers, the paged cache, lm.init
    from repro_torch.configs.qwen2_0_5b import SMOKE as LM_SMOKE
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_cache import PagedKV
    from repro_torch.serving.offload import KVOffloadManager

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--new-tokens", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(LM_SMOKE, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(0, LM_SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVOffloadManager(4, 2)
    # the training path: pretraining, the protocols, the manager offload
    from repro_torch.core.incremental import run_protocol
    from repro_torch.serving.offload import LearnedOffloadManager

    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.pretrain_table([tr], SMOKE, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_protocol(tr, SMOKE, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnedOffloadManager(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--new-tokens", "2", "--offload", "manager"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKV.create(1, 2, 1, 4, 1, 2)
    from repro_torch.configs.mamba2_370m import SMOKE as SSM_SMOKE

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-370m", "--smoke", "--prompt-len", "16", "--new-tokens", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(SSM_SMOKE, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(0, SSM_SMOKE)
    assert Engine(LM_SMOKE, lm.init(0, LM_SMOKE, device="cpu"), device="cpu").device.type == "cpu"
    # the same entry points run when the caller asks for the CPU
    assert OversubscriptionManager(ManagerConfig(predictor=SMOKE), device="cpu").device.type == "cpu"
    assert S.init_state(64, "cpu").device.type == "cpu"
    assert PredictionFrequencyTable(device="cpu").tags.device.type == "cpu"
    assert predictor.init(0, SMOKE, "cpu")["embed/page"].device.type == "cpu"


def test_unported_options_raise():
    from repro_torch.configs.predictor_paper import SMOKE
    from repro_torch.core.incremental import TrainConfig, Trainer
    from repro_torch.core.model_table import Entry
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import trace as T
    from repro_torch.uvm.manager import ManagerConfig, OversubscriptionManager

    with pytest.raises(KeyError, match="unknown predictor kind 'gru'"):  # not in the predictor registry
        Trainer(SMOKE, TrainConfig(epochs=1), kind="gru", device="cpu").train_group(Entry(params={}), None, 2)
    # the health machine is ported; an unregistered component raises what
    # the reference's registry raises
    from repro_torch.uvm.manager import HealthConfig

    assert OversubscriptionManager(ManagerConfig(predictor=SMOKE, health=HealthConfig()),
                                   device="cpu").health_state == "healthy"
    with pytest.raises(KeyError, match="unknown freq-table"):
        OversubscriptionManager(ManagerConfig(predictor=SMOKE, freq_table="lru"), device="cpu")
    tr = T.get_trace("AddVectors", 0.1)
    tagged = T.Trace(tr.name, tr.page, tr.pc, tr.tb, tr.kernel, tr.n_pages, tenant=tr.page * 0)
    # QoS budgets partition a multi-tenant run only
    with pytest.raises(ValueError, match="tenant-tagged multi-tenant run"):
        R.run_ours(tagged, SMOKE, TrainConfig(epochs=0), qos=object(), multi_tenant=False, device="cpu")


def test_server_imports_no_jax_and_loadgen_no_torch():
    """``repro_torch.uvm.server`` (the async server, the AOT cache) and
    ``cli server`` stand alone; the load generator is a client, and its
    module loads without torch."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    child = _SERVE_CHILD.replace("import repro_torch.launch.serve", "import repro_torch.uvm.server.core, "
                                 "repro_torch.uvm.server.aot, repro_torch.uvm.server.loadgen, repro_torch.uvm.cli, "
                                 "repro_torch.launch.serve")
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    loadgen = SRC / "repro_torch" / "uvm" / "server" / "loadgen.py"
    child = ("import importlib.util, json, sys\n"
             f"spec = importlib.util.spec_from_file_location('loadgen', {str(loadgen)!r})\n"
             "mod = sys.modules['loadgen'] = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
             "print(json.dumps([m for m in sys.modules if m == 'torch' or m.startswith(('torch.', 'jax', 'repro'))]"
             " + [callable(mod.run_loadgen)]))")
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True]


def test_server_defaults_to_the_card(tmp_path):
    from repro_torch.configs.predictor_paper import SMOKE
    from repro_torch.uvm import cli
    from repro_torch.uvm.manager import ManagerConfig
    from repro_torch.uvm.server import FaultStreamServer, ServerConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaultStreamServer(ServerConfig(manager=ManagerConfig(predictor=SMOKE)))
    argv = ["server", "--socket", str(tmp_path / "s.sock")]
    assert cli.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    srv = FaultStreamServer(ServerConfig(manager=ManagerConfig(predictor=SMOKE)), device="cpu")
    assert srv.trainer.device.type == "cpu" and srv.dispatcher.engine == "fused"


def test_hybrid_model_imports_no_jax():
    """The hybrid family (zamba2-7b) and its config modules stand alone."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    child = _SERVE_CHILD.replace("import repro_torch.launch.serve", "import repro_torch.models.hybrid, "
                                 "repro_torch.configs.zamba2_7b, repro_torch.configs.qwen1_5_4b, "
                                 "repro_torch.configs.granite_3_8b, repro_torch.launch.serve")
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_hybrid_serve_defaults_to_the_card():
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-7b", "--smoke", "--prompt-len", "16", "--new-tokens", "1"])
