"""The port's fused device search (``algo="beam_jax"``) against the JAX
reference.

* The float32 quantiser that orders candidates on the device equals the
  reference's compiled ``quantize_scores_jax`` bit for bit.
* ``split_words_u32`` and ``bucket_size`` equal the reference's.
* The protocol form, ``DeviceBeamEngine.combine`` in float64, is
  bit-identical to the JAX package's ``engine.reference_combine`` on every
  window of the ten 3x3 scenarios and at tight expansion budgets: the
  cases of the reference's own device-search tests, held against the
  oracle those tests use.  Candidate sets are built by the reference and
  carried across field by field, so both sides see the same inputs.
* The fused form, ``schedule(..., SearchConfig(algo="beam_jax"))``, equals
  the port's host beam and the reference's fused search, with one counted
  fetch per window, and meets the committed golden file.
* No function of the window program reads a device value on the host.

Everything runs on the CPU: the kernels' plain versions stand in for the
CUDA kernels.
"""
import ast
import dataclasses
import inspect
import json
import pathlib
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.engine import reference_combine
from repro.core.reconfig import greedy_pack as ref_greedy_pack
from repro.core.scheduler import build_window_sets as ref_window_sets
from repro.core.scheduler import get_cost_db as ref_get_cost_db
from repro_torch.core import device_search as ds
from repro_torch.core import engine as port_engine
from repro_torch.core.engine import DeviceBeamEngine, ModelCandidateSet
from repro_torch.core.maestro import cost_db_from_arrays
from repro_torch.core.quantize import SCORE_SIG, quantize_scores_torch
from repro_torch.launch import platform

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_golden as golden  # noqa: E402

# the float32 score tolerance of the reference's evaluator tests
F32_SCORE_RTOL = 2e-4


def n_pe_of(scn):
    return 4096 if scn.startswith("dc") else 256


def plan_tuples(plan):
    return [(p.model_idx, p.seg_ends, p.chiplets, p.pipelined)
            for p in plan.plans]


# ------------------------------ quantiser ----------------------------------

def test_float32_quantiser_matches_compiled_reference():
    """Bitwise against ``jax.jit(quantize_scores_jax)`` in float32, whose
    compiled program multiplies by the inverse power of ten."""
    import jax
    import jax.numpy as jnp
    from repro.core.quantize import quantize_scores_jax
    rng = np.random.default_rng(0)
    sweep = (10.0 ** rng.uniform(-20, 3, 200_000)).astype(np.float32)
    base = np.float32(1.2345678)
    extra = np.array([0.0, np.inf, base, base * (1 + np.float32(1e-7))],
                     np.float32)
    x = np.concatenate([sweep, extra])
    want = np.asarray(jax.jit(
        lambda v: quantize_scores_jax(v, sig=SCORE_SIG))(jnp.asarray(x)))
    got = quantize_scores_torch(torch.from_numpy(x), sig=SCORE_SIG).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-4:-2], [0.0, np.inf])
    assert got[-2] == got[-1]             # float32 noise stays in its bucket


# ------------------------------ helpers ------------------------------------

def test_split_words_and_bucket_size_match_reference():
    from repro.core.device_search import bucket_size, split_words_u32
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2 ** 63, (33, 4), dtype=np.int64).astype(
        np.uint64) * np.uint64(2) + np.uint64(1)
    words[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    ours = ds.split_words_u32(words)
    assert ours.dtype == np.uint32
    np.testing.assert_array_equal(ours, split_words_u32(words))
    for n in (1, 100, 255, 256, 257, 5000, 8192, 8193, 40000, 47104, 100000):
        assert ds.bucket_size(n) == bucket_size(n)


# -------------------------- protocol form ----------------------------------

def reference_windows(scn, beam=48, max_expansions=20000):
    """Per window: the reference's candidate sets and anchors, and its
    ``reference_combine`` result, along the reference's trajectory."""
    sc = R.get_scenario(scn)
    mcm = R.make_mcm("het_sides", n_pe=n_pe_of(scn))
    cfg = R.SearchConfig()
    db = ref_get_cost_db(sc, mcm)
    prev_end: dict[int, int] = {}
    out = []
    for ranges in ref_greedy_pack(db, mcm.class_counts(),
                                  cfg.n_splits).ranges:
        sets = ref_window_sets(db, mcm, cfg, ranges, prev_end)
        ref = reference_combine(db, mcm, sets, prev_end, metric=cfg.metric,
                                beam=beam, max_expansions=max_expansions)
        out.append((sets, dict(prev_end), ref))
        prev_end = dict(prev_end)
        prev_end.update(ref.result.end_chiplet)
    tdb = cost_db_from_arrays({f.name: getattr(db, f.name)
                               for f in dataclasses.fields(db)})
    return tdb, T.make_mcm("het_sides", n_pe=n_pe_of(scn)), out


def as_port_sets(sets):
    return [ModelCandidateSet(**{f.name: getattr(cs, f.name)
                                 for f in dataclasses.fields(cs)})
            for cs in sets]


def assert_same_window(ours, ref):
    assert plan_tuples(ours.plan) == plan_tuples(ref.plan)
    assert ours.result.latency == ref.result.latency
    assert ours.result.energy == ref.result.energy
    assert ours.explored == ref.explored


@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_protocol_combine_bit_identical_to_reference(scn):
    tdb, tmcm, windows = reference_windows(scn)
    engine = DeviceBeamEngine(beam=48, device="cpu")
    for sets, prev_end, ref in windows:
        ours = engine.combine(tdb, tmcm, as_port_sets(sets), prev_end,
                              metric="edp")
        assert_same_window(ours, ref)


@pytest.mark.parametrize("budget", [1, 7, 50])
def test_protocol_combine_budget_parity(budget):
    tdb, tmcm, windows = reference_windows("xr10_vr_gaming",
                                           max_expansions=budget)
    engine = DeviceBeamEngine(beam=48, max_expansions=budget, device="cpu")
    for sets, prev_end, ref in windows:
        ours = engine.combine(tdb, tmcm, as_port_sets(sets), prev_end,
                              metric="edp")
        assert_same_window(ours, ref)


@pytest.mark.parametrize("metric", ["latency", "energy"])
def test_protocol_combine_other_metrics(metric):
    """The scan's score is the metric's own float64 value, not EDP."""
    for scn in ("xr10_vr_gaming", "dc4_lms_seg_image"):
        tdb, tmcm, windows = reference_windows(scn)
        engine = DeviceBeamEngine(beam=48, device="cpu")
        mcm = R.make_mcm("het_sides", n_pe=n_pe_of(scn))
        db = ref_get_cost_db(R.get_scenario(scn), mcm)
        for sets, prev_end, _ in windows:
            ref = reference_combine(db, mcm, sets, prev_end, metric=metric,
                                    beam=48)
            ours = engine.combine(tdb, tmcm, as_port_sets(sets), prev_end,
                                  metric=metric)
            assert_same_window(ours, ref)


def test_protocol_combine_no_disjoint_failure_matches_reference():
    """Two models whose every candidate needs chiplet 0: the device scan
    flags the second stage and the engine raises the reference's error."""
    def sets(cls):
        return [cls(model_idx=m, start=0, end=1,
                    lat=np.array([1.0 + m, 2.0 + m]),
                    energy=np.array([1.0, 1.0]), seg_ends_abs=[(1,), (1,)],
                    paths=[(0,), (0,)], masks=[1, 1]) for m in range(2)]
    mcm_r, mcm_t = R.make_mcm("het_sides"), T.make_mcm("het_sides")
    db = ref_get_cost_db(R.get_scenario("xr10_vr_gaming"), mcm_r)
    with pytest.raises(RuntimeError) as ref_err:
        reference_combine(db, mcm_r, sets(R.engine.ModelCandidateSet), {})
    tdb = cost_db_from_arrays({f.name: getattr(db, f.name)
                               for f in dataclasses.fields(db)})
    with pytest.raises(RuntimeError) as ours:
        DeviceBeamEngine(device="cpu").combine(tdb, mcm_t,
                                               sets(ModelCandidateSet), {})
    assert str(ours.value) == str(ref_err.value)


def test_protocol_combine_refuses_kernel_on_cpu():
    tdb, tmcm, windows = reference_windows("xr10_vr_gaming")
    sets, prev_end, _ = windows[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBeamEngine(use_kernel=True, device="cpu").combine(
            tdb, tmcm, as_port_sets(sets), prev_end)


# ---------------------------- fused form -----------------------------------

def test_fused_schedule_matches_host_beam_reference_and_syncs():
    """dc4 on the 3x3 ``het_cb`` package: the fused search's window plans
    and metrics equal the port's host beam and the reference's fused
    search, with exactly one counted fetch per window."""
    scn = "dc4_lms_seg_image"
    platform.reset_sync_count()
    fused = T.schedule(T.get_scenario(scn), T.make_mcm("het_cb", n_pe=4096),
                       T.SearchConfig(algo="beam_jax"), device="cpu")
    assert platform.sync_count() == len(fused.windows)
    host = T.schedule(T.get_scenario(scn), T.make_mcm("het_cb", n_pe=4096),
                      T.SearchConfig(algo="beam"), device="cpu")
    for f, h in zip(fused.windows, host.windows, strict=True):
        assert plan_tuples(f.plan) == plan_tuples(h.plan)
        assert f.result.latency == h.result.latency
        assert f.result.energy == h.result.energy
    ref = R.schedule(R.get_scenario(scn), R.make_mcm("het_cb", n_pe=4096),
                     R.SearchConfig(algo="beam_jax"))
    assert [plan_tuples(w.plan) for w in fused.windows] == \
        [plan_tuples(w.plan) for w in ref.windows]
    assert (fused.result.latency, fused.result.energy, fused.edp) == \
        (ref.result.latency, ref.result.energy, ref.edp)
    # the explored cloud is float32 beam arithmetic over float32 scores,
    # which differ from the reference's in the last ulp (ROADMAP.md,
    # "Faults found in the port")
    assert len(fused.explored) == len(ref.explored)
    np.testing.assert_allclose(np.array(fused.explored),
                               np.array(ref.explored), rtol=F32_SCORE_RTOL)


with open(golden.GOLDEN) as fh:
    GOLDEN = json.load(fh)["cases"]

# the golden cases of the beam family (analytic and congestion): the
# reference's fused search gives their plans too
BEAM_CASES = sorted(k for k, c in GOLDEN.items()
                    if c["config"].get("algo", "brute") in ("brute", "beam")
                    and not c["config"].get("refine_iters"))


def golden_mcm(case):
    from repro_torch.core.scenarios import noc_config
    return T.make_mcm(case["pattern"], rows=case["rows"], cols=case["cols"],
                      n_pe=case["n_pe"],
                      noc=noc_config(case["noc"]) if case["noc"] else None)


def fused_config(case):
    return T.SearchConfig(**{**golden.case_config(case), "algo": "beam_jax"})


@pytest.mark.parametrize("key", BEAM_CASES)
def test_fused_schedule_meets_golden(key):
    """The reference's fused search gives the golden plans and metrics on
    every golden case of the beam family, congestion included; so must
    the port's, with one fetch per window."""
    case = GOLDEN[key]
    platform.reset_sync_count()
    out = T.schedule(T.get_scenario(case["scenario"]), golden_mcm(case),
                     fused_config(case), device="cpu")
    assert platform.sync_count() == len(out.windows)
    assert golden.outcome_record(out) == {
        k: case[k] for k in ("plans", "latency", "energy", "edp")}


def test_fused_congestion_raises():
    """The congestion chain needs the mesh rows and the NoC parameters in
    the window batch (``DeviceBeamEngine.window_inputs`` puts them
    there); a batch without them is refused."""
    case = GOLDEN[PROD_KEY]
    engine = DeviceBeamEngine(device="cpu", comm_model="congestion")
    mcm = golden_mcm(case)
    db = T.build_cost_db(T.get_scenario(case["scenario"]), mcm.classes,
                         mcm.pkg)
    ranges = T.greedy_pack(db, mcm.class_counts(), 4).ranges[-1]
    (batch, words, tiers), _, n_pad = engine.window_inputs(
        db, mcm, T.SearchConfig(path_cap=64), ranges, {})
    with pytest.raises(ValueError, match="NoC"):
        ds.fused_program((batch._replace(noc=None), words, tiers), beam=4,
                         keep=4, metric="edp", max_exp=10, n_pad=n_pad,
                         use_kernel=False, congestion=True)


@pytest.mark.parametrize("scn", ["dc5_lms_seg_image_wide", "xr6_ar_assistant"])
def test_fused_congestion_matches_host_beam(scn):
    """6x6 ``het_cross`` under the narrow NoC: the fused congestion search
    (models scored one at a time against the earlier models' greedy-best
    link bytes) gives the host beam's plans and metrics, fetching once a
    window."""
    from repro_torch.core.scenarios import noc_config
    mcm = T.make_mcm("het_cross", rows=6, cols=6, n_pe=n_pe_of(scn),
                     noc=noc_config("narrow"))
    host = T.schedule(T.get_scenario(scn), mcm, T.SearchConfig(
        algo="beam", comm_model="congestion"), device="cpu")
    platform.reset_sync_count()
    fused = T.schedule(T.get_scenario(scn), mcm, T.SearchConfig(
        algo="beam_jax", comm_model="congestion"), device="cpu")
    assert platform.sync_count() == len(fused.windows)
    assert [plan_tuples(w.plan) for w in fused.windows] == \
        [plan_tuples(w.plan) for w in host.windows]
    assert (fused.result.latency, fused.result.energy) == \
        (host.result.latency, host.result.energy)


# ----------------------------- no syncs ------------------------------------

BLOCKING = {"item", "tolist", "cpu", "numpy"}


def blocking_calls(source: str) -> list[str]:
    found = []
    for node in ast.walk(ast.parse(textwrap.dedent(source))):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            name = node.func.attr
            owner = node.func.value
            if name in BLOCKING or (name == "nonzero" and isinstance(
                    owner, ast.Name) and owner.id == "torch"):
                found.append(f"line {node.lineno}: .{name}()")
    return found


def test_window_program_reads_nothing_back():
    """``core/device_search.py`` (the congestion chain included) and the
    ``combine_window`` body call none of ``.item``, ``.tolist``, ``.cpu``,
    ``.numpy`` or ``torch.nonzero``: the window's only device-to-host copy
    is its counted fetch."""
    assert blocking_calls((ROOT / "src" / "repro_torch" / "core" /
                           "device_search.py").read_text()) == []
    # that file holds the congestion chain too
    for fn in (ds.congestion_scores, ds._cand_link_bytes):
        assert inspect.getsourcefile(fn) == inspect.getsourcefile(ds)
        assert blocking_calls(inspect.getsource(fn)) == []
    for fn in (DeviceBeamEngine.combine_window,
               DeviceBeamEngine._combine_window):
        assert blocking_calls(inspect.getsource(fn)) == [], fn.__name__
    # the check itself finds what it looks for
    assert len(blocking_calls("x.item(); y.cpu(); torch.nonzero(z)")) == 3
    assert port_engine.get_engine(T.SearchConfig(algo="beam_jax")) \
        .combine_window


# ------------------------------ op budget ----------------------------------

# Torch ops that the 16x16 production schedule's window builds and window
# programs dispatch outside the two plain-kernel calls (each counted as
# one op).  With one scar_eval launch a window and one scar_search launch
# a beam stage, doing the work of the ops around them, this count is 479;
# before, it was 2 716, about 150 a model building the comm terms and
# about 40 a beam stage around a popcount-only kernel.
OP_CEILING = 600


class _OpCount:
    """Counts the non-view aten ops dispatched while ``on`` (a
    ``TorchDispatchMode``), with each plain-kernel call counted as one."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if counter.on and not counter.in_kernel and not func.is_view:
                    counter.ops += 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        self.ops = 0
        self.on = False
        self.in_kernel = False

    def kernel(self, fn):
        def call(*args, **kwargs):
            if self.on and not self.in_kernel:
                self.ops += 1
            outer, self.in_kernel = self.in_kernel, True
            try:
                return fn(*args, **kwargs)
            finally:
                self.in_kernel = outer
        return call

    def counted(self, fn):
        def call(*args, **kwargs):
            outer, self.on = self.on, True
            try:
                return fn(*args, **kwargs)
            finally:
                self.on = outer
        return call


def count_window_ops(monkeypatch, key):
    """The golden case ``key`` under ``beam_jax``: its outcome, the torch
    ops its window builds and programs dispatch outside the plain kernels,
    and the models of each ``scar_eval`` call."""
    from repro_torch.kernels.scar_eval import ops as eval_ops
    from repro_torch.kernels.scar_search import ops as search_ops
    count = _OpCount()
    evals = []
    real_eval = eval_ops.scar_eval_window_plain

    def eval_plain(batch, model=None):
        evals.append(len(batch.models) if model is None else 1)
        return real_eval(batch, model)

    monkeypatch.setattr(eval_ops, "scar_eval_window_plain",
                        count.kernel(eval_plain))
    monkeypatch.setattr(search_ops, "scar_search_plain",
                        count.kernel(search_ops.scar_search_plain))
    monkeypatch.setattr(DeviceBeamEngine, "window_inputs",
                        count.counted(DeviceBeamEngine.window_inputs))
    monkeypatch.setattr(ds, "fused_program", count.counted(ds.fused_program))
    case = GOLDEN[key]
    with count.mode:
        out = T.schedule(T.get_scenario(case["scenario"]), golden_mcm(case),
                         fused_config(case), device="cpu")
    assert golden.outcome_record(out) == {
        k: case[k] for k in ("plans", "latency", "energy", "edp")}
    return out, count.ops, evals


PROD_KEY = "het_cb_16x16_cap1024/dc4_lms_seg_image"
CONGESTION_KEY = "het_cb_16x16_cap1024_congestion_narrow/dc4_lms_seg_image"


def test_window_ops_within_budget(monkeypatch):
    """The 16x16 ``beam_jax`` schedule's ``window_inputs`` and window
    programs dispatch at most ``OP_CEILING`` torch ops outside the plain
    kernels, and make one ``scar_eval`` call per window."""
    out, ops, evals = count_window_ops(monkeypatch, PROD_KEY)
    assert len(evals) == len(out.windows) == 5 and sum(evals) == 11
    print(f"torch ops of the 16x16 window builds and programs: {ops}")
    assert 0 < ops <= OP_CEILING


# The same count under the congestion model (16x16, narrow NoC): the
# window programs score the models one at a time (11 scar_eval calls for
# 11 models) and, between them, make each model's link costs and its
# greedy best's link bytes.  Measured 1 219 when run alone and 1 224
# after this file's other tests (CPU counts); pinned 25% above the larger.
CONGESTION_OP_CEILING = 1530


def test_congestion_window_ops_within_budget(monkeypatch):
    out, ops, evals = count_window_ops(monkeypatch, CONGESTION_KEY)
    assert len(out.windows) == 5 and evals == [1] * 11
    print(f"torch ops of the 16x16 congestion window builds and programs: "
          f"{ops}")
    assert 0 < ops <= CONGESTION_OP_CEILING
