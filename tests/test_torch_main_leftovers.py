"""The main path's leftovers in the port, against the JAX reference: the
environment overrides, the on-disk CostDB cache, ``sched.enumerate_paths``
and ``sched.combine_candidates``, and the telemetry exporters (CPU)."""
import copy
import os
import pickle
import types

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.scheduler as RS
import repro.core.sched as RSched
import repro.obs as robs
import repro_torch.core as T
import repro_torch.core.scheduler as TS
import repro_torch.core.sched as TSched
from repro_torch import obs
from repro_torch.core.evaluator import AUTO_WORK_THRESHOLD, resolve_backend
from repro_torch.core.paths import frontier_paths
from repro_torch.launch import platform

CPU = torch.device("cpu")
SMALL = dict(pattern="het_cross", rows=3, cols=3, n_pe=1024)


def plans_of(outcome):
    return [[(p.model_idx, p.seg_ends, p.chiplets) for p in wr.plan.plans]
            for wr in outcome.windows]


# ------------------------------ env overrides -------------------------------

def test_eval_backend_env_override(monkeypatch):
    monkeypatch.delenv("SCAR_EVAL_BACKEND", raising=False)
    monkeypatch.delenv("SCAR_EVAL_AUTO_THRESHOLD", raising=False)
    assert resolve_backend(None, AUTO_WORK_THRESHOLD - 1, CPU) == "torch"
    assert resolve_backend(None, AUTO_WORK_THRESHOLD, CPU) == "torch_ref"
    monkeypatch.setenv("SCAR_EVAL_BACKEND", "torch_ref")
    assert resolve_backend(None, 1, CPU) == "torch_ref"        # env beats auto
    assert resolve_backend("auto", 1, CPU) == "torch_ref"
    assert resolve_backend("torch", 1, CPU) == "torch"   # explicit beats env
    monkeypatch.setenv("SCAR_EVAL_BACKEND", "cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        resolve_backend(None, 1, CPU)
    monkeypatch.setenv("SCAR_EVAL_BACKEND", "jax_ref")  # the reference's name
    with pytest.raises(KeyError):
        resolve_backend(None, 1, CPU)


def test_eval_auto_threshold_env_override(monkeypatch):
    monkeypatch.delenv("SCAR_EVAL_BACKEND", raising=False)
    monkeypatch.setenv("SCAR_EVAL_AUTO_THRESHOLD", "2")
    assert resolve_backend(None, 1, CPU) == "torch"
    assert resolve_backend(None, 2, CPU) == "torch_ref"


def test_eval_backend_env_reaches_schedule(monkeypatch):
    """The override flips a whole schedule's scoring, read per call."""
    sc = T.get_scenario("xr8_outdoors")
    mcm = T.make_mcm(**SMALL)
    cfg = T.SearchConfig(path_cap=32, seg_cap=64)
    monkeypatch.delenv("SCAR_EVAL_BACKEND", raising=False)
    obs.reset()
    T.schedule(sc, mcm, cfg, device="cpu")
    assert obs.counters("evaluator.")["evaluator.eval_calls.torch_ref"] == 0
    monkeypatch.setenv("SCAR_EVAL_BACKEND", "torch_ref")
    obs.reset()
    T.schedule(sc, mcm, cfg, device="cpu")
    calls = obs.counters("evaluator.")
    assert calls["evaluator.eval_calls.torch"] == 0
    assert calls["evaluator.eval_calls.torch_ref"] > 0


def test_search_backend_env_override(monkeypatch):
    sc = T.get_scenario("xr7_ar_gaming")
    mcm = T.make_mcm("het_sides", n_pe=256)
    monkeypatch.delenv("SCAR_SEARCH_BACKEND", raising=False)
    host = T.schedule(sc, mcm, T.SearchConfig(algo="beam"), device="cpu")
    monkeypatch.setenv("SCAR_SEARCH_BACKEND", "beam_jax")
    platform.reset_sync_count()
    dev = T.schedule(sc, mcm, T.SearchConfig(algo="beam"), device="cpu")
    assert platform.sync_count() == len(dev.windows)
    assert plans_of(host) == plans_of(dev)
    # the stochastic engines ignore it
    assert type(T.scheduler.get_engine(T.SearchConfig(algo="anneal"))
                ).__name__ == "AnnealEngine"
    monkeypatch.setenv("SCAR_SEARCH_BACKEND", "beam_pallas")
    with pytest.raises(KeyError):
        T.schedule(sc, mcm, T.SearchConfig(algo="beam"), device="cpu")


# ------------------------------ disk CostDB cache ---------------------------

def _dc1():
    return T.get_scenario("dc1_lms"), T.make_mcm(**SMALL)


def test_costdb_disk_cache_miss_then_hit(tmp_path, monkeypatch):
    monkeypatch.setenv("SCAR_COSTDB_CACHE", str(tmp_path))
    sc, mcm = _dc1()
    T.clear_caches()
    built = TS.get_cost_db(sc, mcm)
    c = obs.counters("costdb.")
    assert (c["costdb.disk_miss"], c["costdb.disk_hit"]) == (1, 0)
    files = [p for p in os.listdir(tmp_path) if p.endswith(".pkl")]
    assert len(files) == 1
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".costdb")]
    T.clear_caches()                    # a fresh process's memory
    assert obs.counters("costdb.")["costdb.disk_miss"] == 0
    loaded = TS.get_cost_db(sc, mcm)
    c = obs.counters("costdb.")
    assert (c["costdb.disk_miss"], c["costdb.disk_hit"]) == (0, 1)
    for f in ("lat", "energy", "w_bytes", "in_bytes", "out_bytes"):
        assert np.array_equal(getattr(loaded, f), getattr(built, f))
    out = T.schedule(sc, mcm, T.SearchConfig(path_cap=32), device="cpu")
    T.clear_caches()
    monkeypatch.delenv("SCAR_COSTDB_CACHE")
    fresh = T.schedule(sc, mcm, T.SearchConfig(path_cap=32), device="cpu")
    assert plans_of(out) == plans_of(fresh)
    assert out.result.edp == fresh.result.edp


def test_costdb_disk_cache_corrupt_or_foreign_file_rebuilds(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("SCAR_COSTDB_CACHE", str(tmp_path))
    sc, mcm = _dc1()
    path = TS._disk_cache_path(str(tmp_path), TS.cost_db_key(sc, mcm))
    for junk in (b"not a pickle", pickle.dumps({"a": 1})):
        with open(path, "wb") as fh:
            fh.write(junk)
        T.clear_caches()
        db = TS.get_cost_db(sc, mcm)
        assert isinstance(db, T.CostDB)
        assert obs.counters("costdb.")["costdb.disk_miss"] == 1
    with open(path, "rb") as fh:                  # republished, readable
        assert isinstance(pickle.load(fh), T.CostDB)


def test_costdb_disk_key_is_salted_with_the_package(tmp_path, monkeypatch):
    """A directory shared with the reference: each package reads only its
    own pickles, under the same content key."""
    monkeypatch.setenv("SCAR_COSTDB_CACHE", str(tmp_path))
    sc, mcm = _dc1()
    key = TS.cost_db_key(sc, mcm)
    rsc, rmcm = R.get_scenario("dc1_lms"), R.make_mcm(**SMALL)
    assert repr(key) == repr(RS.cost_db_key(rsc, rmcm))
    assert TS._disk_cache_path(str(tmp_path), key) != \
        RS._disk_cache_path(str(tmp_path), RS.cost_db_key(rsc, rmcm))
    RS.clear_caches()
    RS.get_cost_db(rsc, rmcm)                     # the reference's pickle
    T.clear_caches()
    TS.get_cost_db(sc, mcm)
    assert obs.counters("costdb.")["costdb.disk_miss"] == 1
    assert len(os.listdir(tmp_path)) == 2


def test_costdb_disk_cache_off_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv("SCAR_COSTDB_CACHE", raising=False)
    assert TS.costdb_cache_dir() is None
    T.clear_caches()
    TS.get_cost_db(*_dc1())
    c = obs.counters("costdb.")
    assert (c["costdb.disk_miss"], c["costdb.disk_hit"]) == (0, 0)


def test_costdb_disk_publish_is_atomic(tmp_path, monkeypatch):
    """A failed write leaves neither a torn file nor a temp file behind."""
    sc, mcm = _dc1()
    db = TS.get_cost_db(sc, mcm)
    path = str(tmp_path / "sub" / "costdb_x.pkl")

    def broken_dump(obj, fh, protocol=None):
        fh.write(b"half")
        raise OSError("disk full")
    monkeypatch.setattr(TS.pickle, "dump", broken_dump)
    TS._disk_cache_store(path, db)
    assert os.listdir(tmp_path / "sub") == []
    monkeypatch.undo()
    TS._disk_cache_store(path, db)
    assert os.listdir(tmp_path / "sub") == ["costdb_x.pkl"]


# ------------------------- enumerate_paths / combine ------------------------

@pytest.mark.parametrize("rows,cols", [(3, 3), (4, 4), (6, 6), (2, 5)])
def test_enumerate_paths_equals_reference_and_frontier(rows, cols):
    tm = T.make_mcm("het_cross", rows=rows, cols=cols)
    rm = R.make_mcm("het_cross", rows=rows, cols=cols)
    ports = list(tm.dram_ports())
    for length in (1, 2, 3, 5):
        for starts in (ports, [4 % (rows * cols)] + ports, ports[:1]):
            for cap in (1, 7, 64):
                ours = TSched.enumerate_paths(tm, length, list(starts),
                                              cap=cap)
                assert ours == RSched.enumerate_paths(rm, length,
                                                      list(starts), cap=cap)
                got, _ = frontier_paths(rows, cols, length, starts, cap=cap)
                assert [tuple(int(c) for c in r) for r in got] == ours


@pytest.mark.parametrize("scenario", ["dc4_lms_seg_image", "xr7_ar_gaming"])
def test_combine_candidates_equals_reference(scenario):
    from repro_torch.core.engine import DeviceBeamEngine
    sc, mcm = T.get_scenario(scenario), T.make_mcm(**SMALL)
    rsc, rmcm = R.get_scenario(scenario), R.make_mcm(**SMALL)
    cfg, rcfg = T.SearchConfig(path_cap=32), R.SearchConfig(path_cap=32)
    db, rdb = TS.get_cost_db(sc, mcm), RS.get_cost_db(rsc, rmcm)
    ranges = T.greedy_pack(db, mcm.class_counts(), cfg.n_splits).ranges[0]
    sets = TS.build_window_sets(db, mcm, cfg, ranges, {}, device="cpu")
    rsets = RS.build_window_sets(rdb, rmcm, rcfg, ranges, {})
    for beam, max_exp in ((64, 20000), (8, 50)):
        ours = TSched.combine_candidates(db, mcm, sets, {}, beam=beam,
                                         max_expansions=max_exp)
        ref = RSched.combine_candidates(rdb, rmcm, rsets, {}, beam=beam,
                                        max_expansions=max_exp)
        assert [(p.model_idx, p.seg_ends, p.chiplets)
                for p in ours.plan.plans] == \
            [(p.model_idx, p.seg_ends, p.chiplets) for p in ref.plan.plans]
        assert (ours.result.latency, ours.result.energy) == \
            (ref.result.latency, ref.result.energy)
        assert ours.explored == ref.explored
    dev = TSched.combine_candidates(db, mcm, sets, {},
                                    engine=DeviceBeamEngine(device="cpu"))
    host = TSched.combine_candidates(db, mcm, sets, {})
    assert dev.plan == host.plan


# ------------------------------ telemetry export ----------------------------

def _same_registry(monkeypatch, counters, gauges):
    stub = types.SimpleNamespace(counters=lambda prefix="": dict(counters),
                                 gauges=lambda prefix="": dict(gauges))
    from repro.obs import export as ref_export
    from repro_torch.obs import export as our_export
    monkeypatch.setattr(ref_export, "registry", stub)
    monkeypatch.setattr(our_export, "registry", stub)
    return ref_export, our_export


def test_exporters_equal_reference_on_the_same_spans(monkeypatch, tmp_path):
    obs.reset()
    tracer = obs.enable()
    try:
        T.schedule(T.get_scenario("xr8_outdoors"), T.make_mcm(**SMALL),
                   T.SearchConfig(path_cap=16), device="cpu")
        obs.event("reconfig", cat="online", from_pattern="a", to_pattern="b")
        counters, gauges = obs.counters(), obs.gauges()
    finally:
        obs.disable()
    ref_tracer = robs.Tracer()
    ref_tracer.events = copy.deepcopy(tracer.events)
    ref_tracer.pid = tracer.pid
    ref_export, our_export = _same_registry(monkeypatch, counters, gauges)
    assert len(tracer.events) > 10
    ours = our_export.chrome_trace(tracer, path=str(tmp_path / "t.json"))
    assert ours == ref_export.chrome_trace(ref_tracer)
    assert (tmp_path / "t.json").read_text().startswith('{"traceEvents"')
    assert our_export.summary(tracer) == ref_export.summary(ref_tracer)
    assert our_export.format_summary(tracer, max_rows=5) == \
        ref_export.format_summary(ref_tracer, max_rows=5)
    assert our_export.bench_dump(tracer) == ref_export.bench_dump(ref_tracer)
    assert our_export.bench_dump(None) == ref_export.bench_dump(None)


def test_snapshot_merge_and_views():
    obs.disable()
    assert obs.snapshot() is None and obs.summary() == []
    assert obs.format_summary() == "(tracing disabled)"
    with pytest.raises(RuntimeError):
        obs.chrome_trace()
    obs.reset()
    worker = obs.Tracer()
    with obs.Span(worker, "replan", "online", {}):
        pass
    snap = {"pid": 7, "wall0": worker.wall0, "events": list(worker.events),
            "counters": {"online.replan.memo_hit": 3}, "gauges": {"g": 2.0}}
    tr = obs.enable()
    try:
        with obs.span("epoch", cat="online"):
            pass
        obs.merge_snapshot(snap, pid=1)
        obs.merge_snapshot(None)
        assert {ev["pid"] for ev in tr.events} == {tr.pid, 1}
        assert obs.registry.value("online.replan.memo_hit") == 3
        assert obs.gauges()["g"] == 2.0
        assert {r["name"] for r in obs.summary()} == {"epoch", "replan"}
        assert set(obs.bench_dump()["spans"]) == {"online.epoch",
                                                  "online.replan"}
        mine = obs.snapshot()
        assert mine["pid"] == tr.pid and len(mine["events"]) == 2
    finally:
        obs.disable()
        obs.reset()
