"""The port's host-side modules against the JAX package: the 11 benchmark
traces, feature windows (whole-trace and streaming), the DFA classifier and
the pretrain memo key — all bit-equal."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.configs import predictor_paper as JC
from repro.core import features as JF
from repro.core import pattern as JP
from repro.core.incremental import TrainConfig as JTrainConfig
from repro.uvm import runtime as JR
from repro.uvm import trace as JT
from repro.uvm.manager import stream as JS
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import features as PF
from repro_torch.core import pattern as PP
from repro_torch.core.incremental import TrainConfig as PTrainConfig
from repro_torch.uvm import runtime as PR
from repro_torch.uvm import trace as PT
from repro_torch.uvm.manager import stream as PS
from repro_torch.util import pow2_bucket

SCALE = 0.4
NAMES = sorted(JT.BENCHMARKS)


@pytest.fixture(scope="module")
def traces():
    return {n: (JT.get_trace(n, SCALE), PT.get_trace(n, SCALE)) for n in NAMES}


def test_benchmark_sets_match():
    assert sorted(PT.BENCHMARKS) == NAMES
    assert PT.CATEGORY == JT.CATEGORY
    assert PT.PAGES_PER_BLOCK == JT.PAGES_PER_BLOCK


@pytest.mark.parametrize("name", NAMES)
def test_trace_equal(traces, name):
    j, p = traces[name]
    assert (j.name, j.n_pages, j.n_blocks) == (p.name, p.n_pages, p.n_blocks)
    for f in ("page", "pc", "tb", "kernel"):
        a, b = getattr(j, f), getattr(p, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(j.block, p.block)


def _assert_fs_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("name", ["Hotspot", "NW", "ATAX", "StreamTriad"])
def test_feature_windows_equal(traces, name):
    j, p = traces[name]
    cfg = JC.CONFIG_QUICK
    kw = dict(page_vocab=cfg.page_vocab, pc_vocab=cfg.pc_vocab, tb_vocab=cfg.tb_vocab)
    jv, pv = JF.DeltaVocab(cfg.delta_vocab), PF.DeltaVocab(cfg.delta_vocab)
    jfs, pfs = JF.FeatureStream(j, jv, cfg.history, **kw), PF.FeatureStream(p, pv, cfg.history, **kw)
    jo, po = JS.OnlineFeatureStream(JF.DeltaVocab(cfg.delta_vocab), cfg.history, **kw), \
        PS.OnlineFeatureStream(PF.DeltaVocab(cfg.delta_vocab), cfg.history, **kw)
    rng = np.random.default_rng(3)
    g0 = 0
    while g0 < len(j):
        g1 = min(g0 + int(rng.integers(1, 1500)), len(j))
        _assert_fs_equal(jfs.windows(g0, g1), pfs.windows(g0, g1))
        assert jo.append(j.page[g0:g1], j.pc[g0:g1], j.tb[g0:g1]) == po.append(p.page[g0:g1], p.pc[g0:g1], p.tb[g0:g1])
        _assert_fs_equal(jo.windows(g0, g1), po.windows(g0, g1))
        g0 = g1
    assert jv.table == pv.table and jo.vocab.table == po.vocab.table
    _assert_fs_equal(JF.extract(j, JF.DeltaVocab(32), 10, page_vocab=64, pc_vocab=16, tb_vocab=16),
                     PF.extract(p, PF.DeltaVocab(32), 10, page_vocab=64, pc_vocab=16, tb_vocab=16))


@pytest.mark.parametrize("group", [512, 2048])
def test_pattern_ids_equal(traces, group):
    for name in NAMES:
        j, p = traces[name]
        jc, pc = JP.PatternClassifier(), PP.PatternClassifier()
        for g0 in range(0, len(j), group):
            g1 = min(g0 + group, len(j))
            assert jc.classify(j.block[g0:g1], j.kernel[g0:g1]) == pc.classify(p.block[g0:g1], p.kernel[g0:g1]), \
                (name, g0)


def test_pretrain_cache_key_equal(traces):
    corpus_j = [traces[n][0] for n in ("Hotspot", "NW")]
    corpus_p = [traces[n][1] for n in ("Hotspot", "NW")]
    for jc, pc in ((JC.CONFIG, PC.CONFIG), (JC.CONFIG_QUICK, PC.CONFIG_QUICK), (JC.SMOKE, PC.SMOKE)):
        assert repr(jc) == repr(pc)
        for tc in ({}, {"group_size": 512, "epochs": 0}):
            assert JR._pretrain_cache_key(corpus_j, jc, JTrainConfig(**tc), "transformer", 0.85, 4) == \
                PR._pretrain_cache_key(corpus_p, pc, PTrainConfig(**tc), "transformer", 0.85, 4)


def test_pow2_bucket_equal():
    from repro.util import pow2_bucket as jb

    for n in (0, 1, 2, 3, 63, 64, 65, 1000, 4097):
        for m in (1, 8, 64, 128, 1024):
            assert pow2_bucket(n, m) == jb(n, m)
