"""``repro_torch.analysis.trace_cost`` (the port's stand-in for the
reference's ``analysis/hlo_cost.py``) on its own: product counts, loops of
layers, checkpoint recompute, the collective formulas against
``hlo_cost._collective_stats``, the collectives read from the port's own
counted calls on a fake world, a known allocation sequence's peak, and the
loop shortcut against the full loops it stands for.
"""
import pytest
import torch
import torch.distributed as dist
from torch.utils import checkpoint

from repro.analysis import hlo_cost

from repro_torch import trace_hooks
from repro_torch.analysis.trace_cost import CostTrace, collective_stats
from repro_torch.distributed import collectives as coll
from repro_torch.kernels.slstm import scan as slstm_scan
from repro_torch.kernels.ssd_scan import scan as ssd_scan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ModelDims, get_arch, init_params
from repro_torch.models.steps import make_prefill_step, make_train_step
from repro_torch.models.testing import reduced
from repro_torch.optim import AdamWConfig, adamw

META = torch.device("meta")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def _trace(fn, *args, shortcut=True):
    with CostTrace(loop_shortcut=shortcut) as t:
        fn(*args)
    return t.result


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_products_count_2mnk(device):
    a, b = (torch.zeros(s, device=device) for s in ((64, 128), (128, 32)))
    r = _trace(torch.matmul, a, b)
    assert r.dot_flops == r.flops == 2 * 64 * 128 * 32
    assert r.bytes_accessed == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    x = torch.zeros((3, 64, 128), device=device)
    r = _trace(torch.bmm, x, torch.zeros((3, 128, 32), device=device))
    assert r.dot_flops == 3 * 2 * 64 * 128 * 32
    lin = torch.nn.functional.linear
    r = _trace(lin, a, torch.zeros((32, 128), device=device),
               torch.zeros(32, device=device))
    assert r.dot_flops == 2 * 64 * 128 * 32
    assert r.flops == r.dot_flops          # the bias rides in addmm


def test_pointwise_and_reductions_count_elements():
    x = _meta(16, 32)
    r = _trace(lambda: torch.tanh(x) + 1.0)
    assert (r.flops, r.dot_flops) == (2 * 16 * 32, 0)
    r = _trace(lambda: x.sum(-1))
    assert r.flops == 16 * 32
    assert r.by_op["aten.sum"][0] == 1
    r = _trace(lambda: x.t().reshape(-1))   # a view, then a copy
    assert r.by_op.get("aten.t") is None
    assert r.bytes_accessed == 2 * 4 * 16 * 32


def test_a_loop_of_layers_counts_each_call():
    ws = [_meta(256, 256) for _ in range(8)]
    x = _meta(32, 256)

    def stack(n):
        h = x
        for w in ws[:n]:
            h = torch.tanh(h @ w)
        return h
    one, eight = _trace(stack, 1), _trace(stack, 8)
    for f in ("flops", "dot_flops", "bytes_accessed"):
        assert getattr(eight, f) == 8 * getattr(one, f)
    assert eight.dot_flops == 8 * 2 * 32 * 256 * 256


def test_a_checkpointed_block_counts_its_recompute():
    w1, w2 = _meta(64, 128, grad=True), _meta(128, 64, grad=True)
    x = _meta(32, 64, grad=True)

    def block(x):
        return torch.tanh(x @ w1) @ w2

    def step(remat):
        y = checkpoint.checkpoint(block, x, use_reentrant=False) if remat \
            else block(x)
        y.sum().backward()
    plain, remat = _trace(step, False), _trace(step, True)
    mm = 2 * 32 * 64 * 128                  # each of the block's products
    assert plain.dot_flops == 6 * mm        # forward, and two per product
    # the backward recomputes x @ w1 (tanh's output, which the second
    # product saved, is the last activation it needs: torch stops there)
    assert remat.dot_flops == plain.dot_flops + mm


@pytest.mark.parametrize("group", [2, 4, 16])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_collective_formulas_match_hlo_cost(kind, group):
    ranks = ",".join(str(i) for i in range(group))
    for groups in (f"[{256 // group},{group}]<=[256]",
                   "{{" + ranks + "}}"):
        line = (f"  %c = bf16[8,{1024 * group}]{{1,0}} {kind}(bf16[8,1024]"
                f"{{1,0}} %p), replica_groups={groups}")
        op = hlo_cost.Op(name="c", opcode=kind,
                         result_shapes=[f"bf16[8,{1024 * group}]{{1,0}}"],
                         operands=["p"], line=line)
        operand, link, g = hlo_cost._collective_stats(op)
        assert g == group
        assert collective_stats(kind, op.result_bytes(), g) == (operand,
                                                                link)


def test_trace_reads_the_ports_collectives_on_a_fake_world():
    """Each counted call with its group's size, as the reference keys its
    HLO collectives; the fake world is gone afterwards."""
    mesh = make_mesh((2, 4), ("data", "model"))
    with dryrun.fake_world(mesh) as rm:
        t = _meta(8, 16, dtype=torch.bfloat16)
        with CostTrace() as tr:
            coll.all_reduce(t, rm.axis("model").group)
            coll.all_gather(t, rm.axis("data"))
            coll.broadcast(t, 0, rm.axis("model"))
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_world(mesh):
                pass
    assert not dist.is_initialized()
    n = 8 * 16 * 2
    r = tr.result
    assert r.by_collective == {
        "all-reduce:g4": {"operand": n, "link": 2.0 * n * 3 / 4,
                          "count": 1.0},
        "all-gather:g2": {"operand": n, "link": 2.0 * n / 2, "count": 1.0},
        "broadcast:g4": {"operand": n, "link": n, "count": 1.0}}
    assert r.collective_operand_bytes == 3 * n
    assert r.flops == r.bytes_accessed == 0      # no arithmetic counted


def test_peak_of_a_known_allocation_sequence():
    def run():
        a = torch.empty(1000, device=META)           # 4 000 B
        b = torch.zeros(500, device=META)            # 2 000 B: 6 000 live
        del a                                        # 2 000
        c = torch.ones(2000, device=META)            # 8 000: 10 000 live
        d = b.view(50, 10)                           # a view: no storage
        del b, c, d                                  # 0
        e = torch.empty(2500, dtype=torch.float64, device=META)  # 20 000
        return e
    r = _trace(run)
    assert r.peak_bytes == 20_000
    pre = _meta(10_000)                # an argument: not the trace's own
    r = _trace(lambda: (pre + 1.0, torch.empty(100, device=META)))
    assert r.peak_bytes == 40_000 + 400
    # written in place (a KV cache's rows): still the argument's storage
    r = _trace(lambda: (pre[:100].copy_(torch.ones(100, device=META)),
                        pre.mul_(2.0)))
    assert r.peak_bytes == 400


def _reduced(name):
    cfg = reduced(get_arch(name))
    dims = ModelDims.create(cfg)
    params = init_params(cfg, dims, generator=torch.Generator().manual_seed(
        0), device=META)
    return cfg, dims, params


def _tokens(B, S):
    return _meta(B, S, dtype=torch.long)


def _same(a, b):
    """The counts and the memory peak equal."""
    assert (a.flops, a.dot_flops, a.bytes_accessed, a.by_op,
            a.by_collective, a.peak_bytes) == (
                b.flops, b.dot_flops, b.bytes_accessed, b.by_op,
                b.by_collective, b.peak_bytes)


def test_loop_shortcut_equals_the_full_recurrences():
    """The sLSTM forward and backward (per position) and the SSD scan with
    and without its normaliser, forward and backward (per chunk)."""
    def slstm():
        ys, out = slstm_scan(_meta(2, 40, 2, 64, grad=True), _meta(2, 16, 64),
                             tuple(_meta(2, 2, 16) for _ in range(4)))
        (ys.sum() + out[0].sum()).backward()

    def ssd(norm):
        q = _meta(2, 96, 2, 16, grad=True)
        o = ssd_scan(q, q, _meta(2, 96, 2, 16), _meta(2, 96, 2), chunk=16,
                     norm=norm)
        (o[0].sum() + o[1].sum() if norm else o.sum()).backward()
    for fn, args in ((slstm, ()), (ssd, (False,)), (ssd, (True,))):
        full, short = (_trace(fn, *args, shortcut=s) for s in (False, True))
        _same(full, short)
        assert short.loops and not full.loops
        assert all(trips >= trace_hooks.SHORTCUT_MIN
                   for _, trips in short.loops)


def test_loop_shortcut_equals_the_full_model_steps():
    """Reduced xLSTM prefill (96 sLSTM positions, 6 SSD chunks), and a
    training step over 8 microbatches, the memory peak included."""
    cfg, dims, params = _reduced("xlstm-350m")
    prefill = make_prefill_step(cfg, dims, 96)
    tokens = _tokens(1, 96)
    full, short = (_trace(prefill, params, {"tokens": tokens}, shortcut=s)
                   for s in (False, True))
    _same(full, short)
    assert ("slstm_scan_plain", 96) in short.loops
    cfg, dims, params = _reduced("minitron-8b")
    opt = AdamWConfig()
    state = adamw.init_state(opt, params)
    step = make_train_step(cfg, dims, opt, accum_steps=8, device=META)
    batch = {"tokens": _tokens(8, 16), "labels": _tokens(8, 16)}
    full, short = (_trace(step, params, state, batch, shortcut=s)
                   for s in (False, True))
    _same(full, short)
    assert [t for n, t in short.loops if "train_step" in n] == [8]


def test_meta_takes_the_plain_path_only_inside_a_trace():
    """Outside a trace a ``meta`` tensor stands for a device with no
    kernel (the tests of the card's routing use it so); a CUDA tensor
    never takes the plain version."""
    q = _meta(1, 32, 2, 16)
    assert not trace_hooks.plain_device(q)
    with pytest.raises(ValueError, match="no kernel for meta"):
        ssd_scan(q, q, q, _meta(1, 32, 2))
    with CostTrace():
        assert trace_hooks.plain_device(q)
        ssd_scan(q, q, q, _meta(1, 32, 2))
    assert not trace_hooks.plain_device(torch.empty(0, device=META))
    assert trace_hooks.TRACE is None
