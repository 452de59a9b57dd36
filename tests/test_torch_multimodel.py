"""The port's multi-model orchestrator against the JAX reference (CPU).

* ``arch_to_workload``: the reference's layer graph for every config;
* the pod-as-MCM: the reference's package constants, chiplet classes and
  class map (the cost model's inputs, copied bit for bit);
* ``plan`` on the 16x16 ``het_sides`` pod with the reference test's three
  requests gives the reference's placements, templates and float64
  metrics (``==``), through the committed record of
  ``scripts/make_torch_portfolio_golden.py``, regenerated here; and the
  reference example's 4x2 plan;
* ``realize(reduced_archs=True, device="cpu")`` builds each placed model
  and its prefill runs; over the same numpy weights, in float32, its
  last-token logits are the reference's reduced prefill's (within
  ``5e-5`` of the largest logit, as ``tests/test_torch_models.py`` holds
  whole models);
* the entry point ``python -m repro_torch.launch.multimodel_serve``.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_portfolio_golden as golden  # noqa: E402

import repro.models as RM  # noqa: E402
import repro.multimodel as RMM  # noqa: E402
from repro.core.scheduler import SearchConfig as RSearchConfig  # noqa: E402
from repro.models.testing import reduced as ref_reduced  # noqa: E402
from repro.multimodel import orchestrator as RO  # noqa: E402

import repro_torch.multimodel as TMM  # noqa: E402
from repro_torch.core.scheduler import SearchConfig  # noqa: E402
from repro_torch.launch import multimodel_serve  # noqa: E402
from repro_torch.models import get_arch, list_archs  # noqa: E402
from repro_torch.models.testing import (numpy_tree, reduced,  # noqa: E402
                                        synth_batch)
from repro_torch.multimodel import orchestrator as TO  # noqa: E402

with open(golden.GOLDEN) as fh:
    POD = json.load(fh)["pod"]

EXAMPLE = [("minitron-8b", 4, 64), ("qwen2-moe-a2.7b", 4, 64),
           ("xlstm-350m", 4, 64)]
EXAMPLE_CFG = dict(metric="edp", n_splits=0, max_nodes_per_model=4)


def plain(obj):
    """A dataclass tree as plain values (enums by value)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [plain(x) for x in obj]
    return getattr(obj, "value", obj)


@pytest.mark.parametrize("arch", list_archs())
def test_arch_to_workload_is_the_reference_graph(arch):
    ref = RO.arch_to_workload(RM.get_arch(arch), batch=4, seq=1024)
    ours = TO.arch_to_workload(get_arch(arch), batch=4, seq=1024)
    assert plain(ours) == plain(ref)
    assert ours.total_macs == ref.total_macs


def test_pod_mcm_has_the_reference_constants():
    ref, ours = RMM.make_pod_mcm(16, 16, "het_sides"), \
        TMM.make_pod_mcm(16, 16, "het_sides")
    assert plain(TMM.TPU_PKG) == plain(RO.TPU_PKG)
    assert TMM.TPU_NPE == RO.TPU_NPE == 131072
    assert plain(TMM.tpu_chip_classes()) == plain(RO.tpu_chip_classes())
    assert ours.name == ref.name and ours.n_chiplets == 256
    assert list(ours.class_map) == list(ref.class_map)
    assert ours.pkg.nop_bw == 50e9
    assert ours.classes[0].n_pe == 131072


def test_committed_pod_plan_is_current():
    assert golden.reference_pod() == {k: POD[k] for k in
                                      ("placements", "latency", "energy",
                                       "edp")}


def test_pod_plan_16x16_equals_reference():
    reqs = [TMM.ServeRequest(*r) for r in POD["requests"]]
    pod = TMM.plan(reqs, rows=POD["rows"], cols=POD["cols"],
                   pattern=POD["pattern"],
                   cfg=SearchConfig(metric=POD["metric"]), device="cpu")
    rec = golden.pod_record(pod)
    assert rec == {k: POD[k] for k in rec}
    assert {p.arch for p in pod.placements} == {r.arch for r in reqs}
    mcm = TMM.make_pod_mcm(16, 16, "het_sides")
    used = {}
    for p in pod.placements:
        assert not used.setdefault(p.window, set()) & set(p.chips)
        used[p.window].update(p.chips)
        for a, b in zip(p.chips, p.chips[1:]):
            assert mcm.hops(a, b) == 1


def _example_plans():
    ref = RMM.plan([RMM.ServeRequest(*r) for r in EXAMPLE], rows=4, cols=2,
                   pattern="het_sides", cfg=RSearchConfig(**EXAMPLE_CFG))
    reqs = [TMM.ServeRequest(*r) for r in EXAMPLE]
    ours = TMM.plan(reqs, rows=4, cols=2, pattern="het_sides",
                    cfg=SearchConfig(**EXAMPLE_CFG), device="cpu")
    return ref, ours, reqs


def test_example_plan_4x2_equals_reference():
    ref, ours, _ = _example_plans()
    assert golden.pod_record(ours) == golden.pod_record(ref)


def test_realize_reduced_prefills_equal_reference():
    _, pod, reqs = _example_plans()
    weights = {r.arch: numpy_tree(reduced(get_arch(r.arch)), seed=5)
               for r in reqs}
    built = TMM.realize(pod, reqs, device="cpu", reduced_archs=True,
                        weights=weights, dtype="float32")
    assert sorted(built) == sorted(p.arch for p in pod.placements
                                   if p.window == 0)
    for arch, (dev, prefill) in built.items():
        assert dev.type == "cpu"
        req = next(r for r in reqs if r.arch == arch)
        last, _ = prefill()
        assert tuple(last.shape) == (req.batch, 512)
        jcfg = dataclasses.replace(ref_reduced(RM.get_arch(arch)),
                                   dtype="float32")
        jdims = RM.ModelDims.create(jcfg, tp=1)
        toks = synth_batch(reduced(get_arch(arch)), batch=req.batch,
                           seq=req.seq, seed=0)["tokens"].numpy()
        jlast, _ = jax.jit(RM.make_prefill_step(
            jcfg, jdims, max_cache_len=req.seq))(
            jax.tree.map(jnp.asarray, weights[arch]),
            {"tokens": jnp.asarray(toks)})
        ref = np.asarray(jlast, np.float32)
        err = np.abs(last.numpy() - ref).max()
        assert err <= 5e-5 * np.abs(ref).max(), (arch, err)


def test_realize_raises_without_a_card_unless_asked():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pod, reqs = _example_plans()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMM.realize(pod, reqs, reduced_archs=True)


def test_multimodel_serve_entry_point_on_the_cpu(capsys):
    out = multimodel_serve.main(["--device", "cpu", "--reduced"])
    text = capsys.readouterr().out
    assert "realized and executed" in text
    assert sorted(out["logits"]) == sorted(a for a, _, _ in EXAMPLE)
    for last in out["logits"].values():
        assert tuple(last.shape) == (4, 512)
        assert bool(np.isfinite(last.float().numpy()).all())
