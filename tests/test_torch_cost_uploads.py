"""Host-to-device copies of the ``torch`` scoring backend (``core.cost``).

A copy from pageable host memory blocks the host, as a fetch does.  Each
scored batch of ``eval_model_candidates`` uploads its host arrays through
``launch.platform.device_upload``, one copy per dtype (int64 ids and
float64 terms: two, whatever the comm model); the bandwidth constants are
filled on the device; the mesh route tables of the congestion model are
uploaded once per mesh and device and kept (``cost.route_tables``), as
the quantiser's powers of ten are.

The copies are counted on the ``meta`` device, where every copy from the
host shows as an ``aten._to_copy`` / ``aten.copy_`` from a CPU tensor
(on the CPU device such a copy is a no-op and dispatches nothing), with a
``TorchDispatchMode`` as ``test_window_ops_within_budget`` counts ops.
The values are held on the CPU: the batches stay bitwise equal to the
reference's numpy oracle under both comm models.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core as R
from repro.core import cost as RC
from repro.core.provision import provision as ref_provision
from repro.core.reconfig import greedy_pack as ref_greedy_pack
from repro.core.sched import assemble_candidates as ref_assemble
from repro.core.scheduler import get_cost_db as ref_get_cost_db
from repro.core.segmentation import top_k_segmentations as ref_top_k

import repro_torch.core as T
from repro_torch.core import cost as TC
from repro_torch.core.chiplet import NoCConfig
from repro_torch.core.evaluator import eval_candidates
from repro_torch.core.maestro import cost_db_from_arrays
from repro_torch.core.scheduler import clear_caches
from repro_torch.launch import platform

CPU = torch.device("cpu")
META = torch.device("meta")
HET_NOC = dict(h_bw=40e9, v_bw=25e9, congestion_alpha=0.7)
SCN = "xr8_outdoors"


class HostCopies(TorchDispatchMode):
    """Count copies from a CPU tensor to another device."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name.startswith("aten._to_copy"):
            dst = kwargs.get("device")
            if args[0].device.type == "cpu" and dst is not None \
                    and torch.device(dst).type != "cpu":
                self.n += 1
        elif name.startswith("aten.copy_"):
            if args[1].device.type == "cpu" and args[0].device.type != "cpu":
                self.n += 1
        return func(*args, **kwargs)


def batches(noc=None):
    """Window 0's production candidate batches on 3x3 ``het_sides``
    (reference and port twins), cold and anchored."""
    rmcm = R.make_mcm("het_sides", rows=3, cols=3, n_pe=256,
                      noc=R.chiplet.NoCConfig(**noc) if noc else None)
    tmcm = T.make_mcm("het_sides", rows=3, cols=3, n_pe=256,
                      noc=NoCConfig(**noc) if noc else None)
    db = ref_get_cost_db(R.get_scenario(SCN), rmcm)
    tdb = cost_db_from_arrays({f.name: getattr(db, f.name)
                               for f in dataclasses.fields(db)})
    ranges = ref_greedy_pack(db, rmcm.class_counts(), 4).ranges[0]
    alloc = ref_provision(db, rmcm.class_counts(), ranges, rmcm.n_chiplets,
                          metric="edp", max_nodes_per_model=6)
    for mi, (s, e) in sorted(ranges.items()):
        segs = ref_top_k(db, rmcm, s, e, alloc[mi], k=4, cap=128,
                         metric="edp")
        for prev in (None, mi % 9):
            cand, _, _ = ref_assemble(rmcm, mi, (s, e), segs, prev,
                                      path_cap=64)
            tcand = TC.BatchedModelCandidates(
                **{f.name: getattr(cand, f.name)
                   for f in dataclasses.fields(cand)})
            yield (db, rmcm, cand), (tdb, tmcm, tcand), prev, len(ranges)


def _kw(comm_model, n_active, prev, n_links):
    kw = dict(n_active=n_active, prev_end=prev, comm_model=comm_model)
    if comm_model == "congestion":
        kw["link_occ"] = np.random.default_rng(3).uniform(0.0, 5e7, n_links)
    return kw


@pytest.mark.parametrize("comm_model", ["analytic", "congestion"])
def test_scored_batch_uploads_once_per_dtype(comm_model):
    """Two host copies a scored batch (int64, float64); the congestion
    model's route tables add two (bool masks, int64 index) once per mesh,
    none on later batches.  Before, each array, constant and route mask
    was a copy of its own."""
    noc = HET_NOC if comm_model == "congestion" else None
    clear_caches()
    counts = []
    for _, (tdb, tmcm, tcand), prev, na in batches(noc):
        kw = _kw(comm_model, na, prev, TC.n_interposer_links(3, 3))
        with HostCopies() as m:
            lat, energy = TC.eval_model_candidates(tdb, tmcm, tcand, **kw,
                                                   device=META)
        assert lat.device == energy.device == META
        counts.append(m.n)
    first = 4 if comm_model == "congestion" else 2
    assert counts == [first] + [2] * (len(counts) - 1)


@pytest.mark.parametrize("terms", ["comm_terms", "congestion_terms"])
def test_batch_terms_upload_once_per_dtype(terms):
    _, (tdb, tmcm, tcand), prev, na = next(batches(HET_NOC))
    clear_caches()
    TC.route_tables(3, 3, META)                  # uploaded once, kept
    with HostCopies() as m:
        if terms == "comm_terms":
            TC.comm_terms(tdb, tmcm, tcand, na, prev_end=prev, device=META)
        else:
            TC.congestion_terms(tdb, tmcm, tcand, prev_end=prev,
                                link_occ=np.ones(12), device=META)
    assert m.n == 2


@pytest.mark.parametrize("comm_model", ["analytic", "congestion"])
def test_scored_batches_stay_bitwise_equal_to_reference(comm_model):
    """The repaired uploads change no bit: the float64 batch equals the
    reference's numpy oracle, directly and through the ``torch`` backend
    of ``eval_candidates`` (one counted fetch a batch)."""
    noc = HET_NOC if comm_model == "congestion" else None
    platform.reset_sync_count()
    n = 0
    for (db, rmcm, cand), (tdb, tmcm, tcand), prev, na in batches(noc):
        kw = _kw(comm_model, na, prev, TC.n_interposer_links(3, 3))
        rl, re = RC.eval_model_candidates(db, rmcm, cand, **kw)
        tl, te = TC.eval_model_candidates(tdb, tmcm, tcand, **kw,
                                          device=CPU)
        np.testing.assert_array_equal(tl.numpy(), rl)
        np.testing.assert_array_equal(te.numpy(), re)
        bl, be = eval_candidates(tdb, tmcm, tcand, backend="torch",
                                 device=CPU, **kw)
        np.testing.assert_array_equal(bl, rl)
        np.testing.assert_array_equal(be, re)
        n += 1
    assert platform.sync_count() == n > 0


@pytest.mark.parametrize("fdt", [torch.float32, torch.float64])
def test_bandwidth_constants_filled_on_device(fdt):
    """``_per_bandwidth`` builds its constants with a device fill, no
    host tensor, and they keep the bits of the host values."""
    pkg = T.make_mcm("het_sides", rows=3, cols=3, n_pe=256).pkg
    sz = torch.tensor([1.0, 3.0e6, 7.5e9], dtype=fdt)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as m:
        per_dram, per_nop = TC._per_bandwidth(pkg, fdt, CPU)
    # a host value made a tensor shows as ``lift_fresh`` on the CPU
    assert not [op for op in m.ops if "lift_fresh" in op or "copy" in op]
    if fdt == torch.float32:
        inv_d = torch.tensor(np.float32(1) / np.float32(pkg.dram_bw))
        inv_n = torch.tensor(np.float32(1) / np.float32(pkg.nop_bw))
        want = (sz * inv_d, sz * inv_n)
    else:
        want = (sz / torch.tensor(pkg.dram_bw, dtype=fdt),
                sz / torch.tensor(pkg.nop_bw, dtype=fdt))
    assert torch.equal(per_dram(sz), want[0])
    assert torch.equal(per_nop(sz), want[1])


def test_route_tables_kept_per_mesh_and_cleared():
    clear_caches()
    a = TC.route_tables(3, 4, CPU)
    assert TC.route_tables(3, 4, CPU) is a
    assert TC.route_tables(4, 3, CPU) is not a
    np.testing.assert_array_equal(a["h_mask"].numpy(),
                                  TC._span_bottleneck_mask(4))
    np.testing.assert_array_equal(a["v_mask"].numpy(),
                                  TC._span_bottleneck_mask(3))
    for name, want in zip(("r", "c", "edge"), TC._mesh_route_index(3, 4)):
        np.testing.assert_array_equal(a[name].numpy(), want)
    cost = np.random.default_rng(0).uniform(0, 1e-6,
                                            TC.n_interposer_links(3, 4))
    wp, wd = TC.route_wait_tables(cost, 3, 4)
    rp, rd = RC.route_wait_tables(np, cost, 3, 4)
    np.testing.assert_array_equal(wp, rp)
    np.testing.assert_array_equal(wd, rd)
    clear_caches()
    assert TC.route_tables(3, 4, CPU) is not a
