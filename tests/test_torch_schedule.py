"""The port's whole schedule against the JAX reference, and its guards.

``repro_torch.core.schedule(..., device="cpu")`` must return the plans of
``repro.core.schedule`` with float64 latency, energy and EDP that compare
``==``, on all ten Table II scenarios at 3x3 (``brute``) and on the
paper's 6x6 ``het_cross`` package.  On the CPU the large 6x6 batches go
through the plain float32 version of the kernel, as the reference's go
through its jax_ref form.

The guards pin the no-fallback contract: no device without CUDA raises and
the ``cuda`` backend on a CPU device raises.  The search options the port
reached last (the congestion comm model, with the fused ``beam_jax``
search as with the host beam, the stochastic engines and refinement) run
and give the reference's plans; what still raises is what the reference
refuses too.  The import guard checks that the port (and
``chip_smoke.py``) import neither ``jax`` nor ``repro``.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.core as R
import repro_torch.core as T

ROOT = pathlib.Path(__file__).resolve().parents[1]


def n_pe_of(scn):
    return 4096 if scn.startswith("dc") else 256


def plan_tuples(outcome):
    return [[(p.model_idx, p.seg_ends, p.chiplets, p.pipelined)
             for p in wr.plan.plans] for wr in outcome.windows]


@pytest.mark.parametrize("rows,pattern", [(3, "het_sides"), (6, "het_cross")])
@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_schedule_matches_reference(scn, rows, pattern):
    ref = R.schedule(R.get_scenario(scn),
                     R.make_mcm(pattern, rows=rows, cols=rows,
                                n_pe=n_pe_of(scn)),
                     R.SearchConfig(algo="brute"))
    ours = T.schedule(T.get_scenario(scn),
                      T.make_mcm(pattern, rows=rows, cols=rows,
                                 n_pe=n_pe_of(scn)),
                      T.SearchConfig(algo="brute"), device="cpu")
    assert plan_tuples(ours) == plan_tuples(ref)
    assert ours.result.latency == ref.result.latency
    assert ours.result.energy == ref.result.energy
    assert ours.edp == ref.edp
    assert ours.assignment.ranges == ref.assignment.ranges


# With every batch scored in float32, dc5's window 0 breaks an exact tie
# the other way (ROADMAP.md, "Faults found in the port"): model 1 takes an
# equal-metric segmentation.  Metrics must still be equal everywhere.
F32_TIE_SCENARIOS = {"dc5_lms_seg_image_wide"}


@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_all_float32_schedule_is_score_equivalent(scn):
    """Every batch on the plain float32 kernel version (the GPU's ``cuda``
    backend computes the same bits) against the reference's default run."""
    mcm_r = R.make_mcm("het_cross", rows=6, cols=6, n_pe=n_pe_of(scn))
    mcm_t = T.make_mcm("het_cross", rows=6, cols=6, n_pe=n_pe_of(scn))
    ref = R.schedule(R.get_scenario(scn), mcm_r)
    ours = T.schedule(T.get_scenario(scn), mcm_t,
                      T.SearchConfig(eval_backend="torch_ref"), device="cpu")
    assert (ours.result.latency, ours.result.energy, ours.edp) == \
        (ref.result.latency, ref.result.energy, ref.edp)
    if scn not in F32_TIE_SCENARIOS:
        assert plan_tuples(ours) == plan_tuples(ref)


def test_incremental_and_memo_match_reference():
    """Warm re-planning with carried anchors and a window memo."""
    scn = "dc2_lms_image_light"
    mcm_r = R.make_mcm("het_cb", n_pe=4096)
    mcm_t = T.make_mcm("het_cb", n_pe=4096)
    prior_r = R.schedule(R.get_scenario(scn), mcm_r)
    prior_t = T.schedule(T.get_scenario(scn), mcm_t, device="cpu")
    assert T.final_anchors(prior_t) == R.final_anchors(prior_r)
    persisting = {0: 0, 1: 1}
    ref = R.schedule_incremental(R.get_scenario("dc1_lms"), mcm_r,
                                 prior=prior_r, persisting=persisting)
    memo = {}
    for _ in range(2):                    # cold, then every window memoised
        ours = T.schedule_incremental(T.get_scenario("dc1_lms"), mcm_t,
                                      prior=prior_t, persisting=persisting,
                                      window_memo=memo, device="cpu")
        assert plan_tuples(ours) == plan_tuples(ref)
        assert ours.edp == ref.edp


def test_standalone_matches_reference():
    for scn in ("dc3_lms_image_heavy", "xr9_social"):
        ref = R.standalone_schedule(R.get_scenario(scn),
                                    R.make_mcm("het_cross", n_pe=4096))
        ours = T.standalone_schedule(T.get_scenario(scn),
                                     T.make_mcm("het_cross", n_pe=4096))
        assert ours.edp == ref.edp
        assert plan_tuples(ours) == plan_tuples(ref)


# ------------------------------ guards -------------------------------------

def small_case():
    return T.get_scenario("xr10_vr_gaming"), T.make_mcm("het_sides", n_pe=256)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc, mcm = small_case()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.schedule(sc, mcm)
    with pytest.raises(RuntimeError):
        T.schedule(sc, mcm, device="cuda")


def test_cuda_backend_on_cpu_raises():
    sc, mcm = small_case()
    with pytest.raises(RuntimeError, match="CUDA device"):
        T.schedule(sc, mcm, T.SearchConfig(eval_backend="cuda"),
                   device="cpu")


@pytest.mark.parametrize("change", [
    dict(algo="beam_jax", comm_model="congestion"), dict(algo="evolutionary"),
    dict(algo="anneal"), dict(refine_iters=10),
    dict(comm_model="congestion")])
def test_unported_options_raise(change):
    """Each option that raised ``NotImplementedError`` before the port
    reached it now gives the reference's schedule; the one refusal left
    is the reference's own: ``refine_iters`` with warm-start anchors."""
    sc, mcm = small_case()
    ref = R.schedule(R.get_scenario(sc.name),
                     R.make_mcm("het_sides", n_pe=256),
                     R.SearchConfig(**change))
    ours = T.schedule(sc, mcm, T.SearchConfig(**change), device="cpu")
    assert plan_tuples(ours) == plan_tuples(ref)
    assert ours.edp == ref.edp
    if change.get("refine_iters"):
        with pytest.raises(NotImplementedError, match="warm-start"):
            T.schedule(sc, mcm, T.SearchConfig(**change), prev_end={0: 0},
                       device="cpu")


# --------------------------- import guard ----------------------------------

def port_modules():
    src = ROOT / "src"
    return sorted(".".join(p.relative_to(src).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (src / "repro_torch").rglob("*.py"))


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            f"for m in {port_modules()!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_no_jax_or_repro_import_statements():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "repro"), f"{path}: {name}"
