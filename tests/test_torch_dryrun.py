"""The port's dry-run (``repro_torch.launch.dryrun``) and hill-climb
(``launch.hillclimb``) against the JAX reference's.

* Dot FLOPs of reduced cells: the port's trace on ``meta`` against the
  reference's compiled HLO, walked with ``hlo_cost``'s trip counts and
  counting only ``dot`` and ``convolution`` (the one figure that compares
  across XLA and eager).  The reference's ``build_cell`` takes the reduced
  config and small shapes through monkeypatches of its modules'
  ``get_arch`` and ``SHAPES``, and runs on one device.  Prefill and decode
  are equal, but for xLSTM's normaliser; training departs by what the
  port's backward recomputes (``TRAIN``, ``_train_gap``; ROADMAP
  section 3).
* Collectives: rank 0 of a fake world against rank 0 of a real gloo run
  of the same reduced cells on a 2 x 2 mesh (``torch_dryrun_worker``),
  also under the ``seq_parallel`` and ``expert_axes="model_major"``
  overrides, whose records show their reduce-scatters and all-to-alls;
  sequence parallelism leaves a rank's dot FLOPs as they were.
* The CLI (one record, resumed, the skip list) and the hill-climb's rows
  that use those overrides, traced on a small mesh (terms, no error,
  resumed).
"""
import concurrent.futures
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import hlo_cost
from repro.launch import cells as rcells
from repro.launch.mesh import mesh_context
from repro.models import get_arch as rget
from repro.models.testing import reduced as rreduced

from repro_torch.distributed import collectives as coll
from repro_torch.launch import cells, dryrun, hillclimb
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models import get_arch
from repro_torch.models.testing import reduced

sys.path.insert(0, os.path.dirname(__file__))
import torch_dryrun_worker as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"train_s256": dict(kind="train", seq=256, batch=4),
         "prefill_s256": dict(kind="prefill", seq=256, batch=4),
         "decode_s256": dict(kind="decode", seq=256, batch=4)}
ARCHS = ["minitron-8b", "qwen2-moe-a2.7b", "zamba2-2.7b", "xlstm-350m"]
FAST_CODEGEN = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rdry():
    jax.devices()       # the device count is fixed from here on
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _ref_dot_flops(text: str) -> float:
    """``hlo_cost.analyze``'s walk (loop trip counts multiplied in, fusions
    and calls entered), counting ``dot`` and ``convolution`` only."""
    comps = hlo_cost.parse_module(text)
    entry = next(re.search(r"ENTRY\s+%?([\w.\-]+)", line).group(1)
                 for line in text.splitlines() if line.startswith("ENTRY"))
    total = [0.0]

    def walk(name, mult, stack):
        comp = comps.get(name)
        if comp is None or name in stack:
            return
        for op in comp.ops:
            if op.opcode == "while":
                cond = hlo_cost._attr(op.line, "condition")
                trips = hlo_cost._trip_count(comps[cond]) \
                    if cond in comps else 1
                walk(hlo_cost._attr(op.line, "body"), mult * trips,
                     stack | {name})
                continue
            for key in ("calls", "to_apply", "true_computation",
                        "false_computation", "branch_computations"):
                called = hlo_cost._attr(op.line, key)
                if called:
                    walk(called, mult, stack | {name})
            if op.opcode == "dot":
                total[0] += mult * hlo_cost._dot_flops(op, comp)
            elif op.opcode == "convolution":
                total[0] += mult * hlo_cost._conv_flops(op, comp)
    walk(entry, 1.0, frozenset())
    return total[0]


def _qk(B, H, S, hd):
    """One attention layer's q k^T over the whole sequence."""
    return 2 * B * H * S * S * hd


# the reference's and the port's dot FLOPs of the reduced training cells
# (batch 4 x 256, accumulation 2, remat "nothing"), and what the port's
# backward adds (the reference's autodiff reads its rematerialised
# forward's values where the port recomputes them):
# * minitron-8b: each attention layer's q k^T, recomputed by the attention
#   backward (the plain version, as the flash_attention_bwd kernel does);
# * qwen2-moe-a2.7b: that, and each MoE layer's combine einsum
#   (gtec,gecd->gtd), which torch.utils.checkpoint re-runs to reach the
#   shared experts' saved inputs after it, while XLA's remat drops a
#   product whose output the backward never reads;
# * zamba2-2.7b: the shared attention's q k^T, and each Mamba-2 layer's
#   chunk scores and states, recomputed by the SSD backward (as
#   ssd_scan_bwd does);
# * xlstm-350m: the normaliser's second scan repeats the first one's
#   q k^T, which XLA computes once (forward and recompute), and the
#   normalised scan's backward runs as one pass over P + 1 columns with its
#   chunk states and scores recomputed (1 572 864).
TRAIN = {"minitron-8b": (1207959552, 1275068416),
         "qwen2-moe-a2.7b": (10217324544, 11358175232),
         "zamba2-2.7b": (4202692608, 4353687552),
         "xlstm-350m": (1075576832, 1085538304)}


def _train_gap(name, cfg, B, S):
    hd, H = cfg.hd, cfg.n_heads
    n_super = cfg.n_super_blocks
    qk = _qk(B, H, S, hd)
    if name == "minitron-8b":
        return n_super * qk
    if name == "qwen2-moe-a2.7b":
        m = cfg.moe
        E, T, d = m.n_experts, B * S, cfg.d_model
        cap = 512          # moe_capacity at a group of 512: g itself
        return n_super * qk + n_super * 2 * T * E * cap * d
    if name == "zamba2-2.7b":
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        n_chunks = S // s.chunk
        per_chunk = (2 * s.chunk * s.chunk * s.d_state
                     + 2 * s.d_state * s.head_dim * s.chunk)
        n_mamba = n_super * sum(k.value == "mamba2"
                                for k in cfg.block_pattern)
        return n_super * qk + n_mamba * B * heads * n_chunks * per_chunk
    return 2 * _norm_gap(cfg, B, S) + 1572864


def _norm_gap(cfg, B, S):
    """xLSTM's normaliser: its scan's q k^T, once per chunk and head, in
    every mLSTM layer."""
    c, N = cfg.ssm.chunk, cfg.d_model // cfg.n_heads
    return cfg.n_super_blocks * B * cfg.n_heads * (S // c) * 2 * c * c * N


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ARCHS)
def test_dot_flops_against_the_reference(rdry, monkeypatch, name, kind):
    rcfg, cfg = rreduced(rget(name)), reduced(get_arch(name))
    shape = f"{kind}_s256"
    monkeypatch.setattr(rcells, "SHAPES", {**rcells.SHAPES, **SMALL})
    monkeypatch.setattr(cells, "SHAPES", {**cells.SHAPES, **SMALL})
    for mod in (rcells, rdry):
        monkeypatch.setattr(mod, "get_arch", lambda n: rcfg)
    for mod in (cells, dryrun):
        monkeypatch.setattr(mod, "get_arch", lambda n: cfg)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    fn, args, in_sh, out_sh, donate = rdry.build_cell(
        rcells.Cell(name, shape), mesh)
    with mesh_context(mesh):
        lowered = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                          donate_argnums=donate).lower(*args)
    # XLA compiles (outside the interpreter lock) while the port traces;
    # its HLO passes, whose output is walked, run in full, the machine
    # code is left unoptimised
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        text = pool.submit(lambda: lowered.compile(
            compiler_options=FAST_CODEGEN).as_text())
        rec = dryrun.run_cell(cells.Cell(name, shape),
                              make_mesh((1, 1), ("data", "model")), "1x1")
        want = _ref_dot_flops(text.result())
    got = rec["cost"]["dot_flops"]
    B, S = 4, 256
    if kind == "train":
        assert (want, got) == TRAIN[name]
        assert got - want == _train_gap(name, cfg, B, S)
    elif name == "xlstm-350m" and kind == "prefill":
        assert got - want == _norm_gap(cfg, B, S)
        assert abs(got / want - 1) < 0.02
    else:
        assert got == want
    assert rec["cost"]["flops"] >= got > 0


def test_full_loops_give_the_same_record(monkeypatch):
    """``run_cell(loop_shortcut=False)`` (``--full-loops``) traces every
    loop in full: the reduced xLSTM prefill's record (96 sLSTM positions,
    6 SSD chunks) is the shortcut's, counts and peak."""
    cfg = reduced(get_arch("xlstm-350m"))
    monkeypatch.setattr(cells, "SHAPES", {**cells.SHAPES, "prefill_s96": dict(
        kind="prefill", seq=96, batch=1)})
    for mod in (cells, dryrun):
        monkeypatch.setattr(mod, "get_arch", lambda n: cfg)
    mesh = make_mesh((1, 1), ("data", "model"))
    short, full = (dryrun.run_cell(cells.Cell("xlstm-350m", "prefill_s96"),
                                   mesh, "1x1", loop_shortcut=s)
                   for s in (True, False))
    assert short["collectives"]["loops"] and not full["collectives"]["loops"]
    for key in ("cost", "memory"):
        assert short[key] == full[key]


CASES = [{"arch": a, "full_name": f, "shape": s}
         for a, f in (("minitron-8b", False), ("qwen2.5-32b", True))
         for s in ("train_s32", "prefill_s32")]

_BY_KIND = {"all_reduce": "all-reduce", "fsdp_all_reduce": "all-reduce",
            "all_gather": "all-gather", "fsdp_all_gather": "all-gather",
            "sp_all_gather": "all-gather",
            "sp_reduce_scatter": "reduce-scatter",
            "expert_all_to_all": "all-to-all",
            "broadcast": "broadcast", "send_recv": "collective-permute"}


def _by_kind(stats: dict) -> dict:
    out: dict = {}
    for label, s in stats.items():
        c = out.setdefault(_BY_KIND[label], [0, 0])
        c[0] += s["calls"]
        c[1] += s["bytes"]
    return out


def _fake_against_real(monkeypatch, cases, real):
    """Each case traced on a fake world: its counts by label `==` the real
    rank's, its record's by kind `==` them; the real labels."""
    monkeypatch.setattr(cells, "SHAPES", {**cells.SHAPES, **W.SHAPES})
    for case, want in zip(cases, real):
        cfg = W.config(case["arch"], case["full_name"])
        for mod in (cells, dryrun):
            monkeypatch.setattr(mod, "get_arch", lambda n, cfg=cfg: cfg)
        coll.reset_stats()
        rec = dryrun.run_cell(cells.Cell(case["arch"], case["shape"]),
                              W.MESH, "2x2", case.get("overrides"))
        got = coll.stats()
        assert not dist.is_initialized()
        assert got == want, case
        traced: dict = {}
        for key, d in rec["collectives"]["by_group"].items():
            c = traced.setdefault(key.split(":")[0], [0, 0])
            c[0] += d["count"]
            c[1] += d["operand"]
        assert traced == _by_kind(want), case
        assert want, case
    return {k for s in real for k in s}


def test_fake_ranks_count_the_collectives_of_real_ranks(monkeypatch):
    """A tensor-parallel config and an FSDP one (qwen2.5-32b reduced under
    its own name, so its layers gather over 'data'), trained and
    prefilled: rank 0's calls and bytes, by label, on a fake world of 4
    equal those of rank 0 of 4 gloo ranks; the trace's records per kind
    agree with them."""
    real = spawn(W.run, 4, CASES, timeout_s=240)[0]
    kinds = _fake_against_real(monkeypatch, CASES, real)
    assert {"all_reduce", "all_gather", "fsdp_all_gather",
            "fsdp_all_reduce"} <= kinds


def test_cli_writes_a_record_resumes_and_lists_the_skips(tmp_path, capsys):
    """The command line once, then ``main`` again in this process (it
    resumes past the record, tracing nothing)."""
    out = tmp_path / "dry.jsonl"
    argv = ["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(out)]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    runs = [subprocess.run([sys.executable, "-m",
                            "repro_torch.launch.dryrun", *argv], env=env,
                           capture_output=True, text=True, timeout=300,
                           check=True).stdout]
    capsys.readouterr()
    dryrun.main(argv)
    runs.append(capsys.readouterr().out)
    assert not dist.is_initialized()
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (
        "xlstm-350m", "decode_32k", "single_pod_16x16")
    assert {"cost", "collectives", "memory", "analytic_memory",
            "trace_s"} <= set(rec)
    assert "lower_s" not in rec and "compile_s" not in rec
    skips = [f"  SKIP {c.arch} x {c.shape}: {rcells.cell_valid(c)[1]}"
             for c in rcells.all_cells(include_skipped=True)
             if not rcells.cell_valid(c)[0]]
    for r in runs:
        tail = r.splitlines()
        assert tail[-len(skips) - 1] == ("[dryrun] complete; 0 failures; "
                                         "9 cells skipped by validity "
                                         "rules:")
        assert tail[-len(skips):] == skips
    assert "[dryrun] xlstm-350m x decode_32k" in runs[0]
    assert "[dryrun] xlstm-350m x decode_32k" not in runs[1]


OVERRIDE_CASES = [
    {"arch": "qwen2.5-32b", "full_name": True, "shape": s,
     "overrides": {"seq_parallel": True}} for s in ("train_s32",
                                                     "prefill_s32")] + [
    {"arch": "arctic-480b", "full_name": True, "shape": "train_s32",
     "overrides": ov} for ov in ({"expert_axes": "model_major"},
                                 {"expert_axes": "model_major",
                                  "seq_parallel": True})]


def test_override_cells_trace_on_a_fake_world_as_real_ranks_run_them(
        monkeypatch):
    """The ``seq_parallel`` and ``expert_axes="model_major"`` overrides of
    reduced qwen2.5-32b and arctic-480b (under their published names: FSDP
    over 'data'), trained and prefilled on a fake 2 x 2 world: rank 0's
    collectives by label `==` rank 0 of 4 gloo ranks running the same
    steps, and the records show the reduce-scatters of sequence
    parallelism and the model-major all-to-alls."""
    real = spawn(W.run, 4, OVERRIDE_CASES, timeout_s=240)[0]
    kinds = _fake_against_real(monkeypatch, OVERRIDE_CASES, real)
    assert {"sp_all_gather", "sp_reduce_scatter",
            "expert_all_to_all"} <= kinds
    sp_only = real[1]                   # qwen's SP prefill
    assert "all_reduce" not in sp_only


@pytest.mark.parametrize("shape", ["train_s32", "prefill_s32"])
def test_seq_parallel_leaves_a_ranks_dot_flops(monkeypatch, shape):
    """Rank 0 of a 2 x 2 fake world multiplies the same products with the
    sequence split over 'model' between blocks as without: every product
    runs on the gathered sequence.  Its collectives are not the same."""
    cfg = W.config("qwen2.5-32b", True)
    monkeypatch.setattr(cells, "SHAPES", {**cells.SHAPES, **W.SHAPES})
    for mod in (cells, dryrun):
        monkeypatch.setattr(mod, "get_arch", lambda n: cfg)
    cell = cells.Cell("qwen2.5-32b", shape)
    plain, sp = (dryrun.run_cell(cell, W.MESH, "2x2", ov)
                 for ov in (None, {"seq_parallel": True}))
    assert sp["cost"]["dot_flops"] == plain["cost"]["dot_flops"] > 0
    assert "reduce-scatter:g2" in sp["collectives"]["by_group"]
    assert "reduce-scatter:g2" not in plain["collectives"]["by_group"]


def test_hillclimb_rows_with_sp_and_model_major_write_terms_and_resume(
        monkeypatch, tmp_path):
    """The 10 rows asking for Megatron-SP or the model-major expert
    layout, on the configs reduced under their published names, their
    shapes cut and a 2 x 2 mesh for the production one: each row written
    with its three roofline terms and no ``error``, and later runs resume
    past the rows written.  The rows run at train 4 x 32 and decode 4 over
    a 64-row cache, but ``sp+grad_check``, whose ``accum_steps=16`` needs
    16 rows a data rank: it runs in the second pass, at train 32 x 16."""
    rows = [r for r in hillclimb.PLAN if r[3].get("seq_parallel")
            or r[3].get("expert_axes") == "model_major"]
    assert len(rows) == 10
    by_name = {a: W.config(a, True) for a in {r[0] for r in rows}}
    monkeypatch.setattr(hillclimb, "make_production_mesh", lambda: W.MESH)
    for mod in (cells, dryrun):
        monkeypatch.setattr(mod, "get_arch", lambda n: by_name[n])
    path = tmp_path / "hill.jsonl"
    deep = [r for r in rows if r[3].get("accum_steps")]
    for plan, train in (([r for r in rows if r not in deep], (32, 4)),
                        (rows, (16, 32)), (rows, (16, 32))):
        monkeypatch.setattr(hillclimb, "PLAN", plan)
        monkeypatch.setattr(cells, "SHAPES", {
            **cells.SHAPES,
            "train_4k": dict(kind="train", seq=train[0], batch=train[1]),
            "decode_32k": dict(kind="decode", seq=64, batch=4)})
        hillclimb.main(str(path))
    got = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(deep) == 1
    assert [(r["arch"], r["variant"]) for r in got] == [
        (r[0], r[2]) for r in rows if r not in deep] + [
        (deep[0][0], deep[0][2])]
    for r in got:
        assert "error" not in r, r
        assert all(r[k] > 0 for k in ("compute_s", "memory_s",
                                      "collective_s")), r
    assert not dist.is_initialized()


def test_dry_run_modules_import_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hillclimb\n"
            "import repro_torch.launch.cells\n"
            "import repro_torch.analysis.roofline\n"
            "import repro_torch.analysis.trace_cost\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.')))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)

