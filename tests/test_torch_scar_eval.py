"""The port's ``scar_eval`` plain versions against the JAX reference.

The kernel scores every model of a scheduling window in one launch, comm
terms included, from the raw integers the host holds.  Its plain version
(``scar_eval_window_plain``) is held:

* against the reference's ``kernels.scar_eval.ops.evaluate`` (the jitted
  ``evaluate_traceable``, ``use_kernel=False``) at the reference's 2e-4,
  on seeded random batches (with and without an anchor, pipelined or not)
  and on the real batches of 6x6 scenario windows;
* bit for bit against its own definition, ``core.cost.comm_from_parts``
  plus ``scar_eval_plain``, composed here per model as the port composed
  them before the kernel took the comm terms in;
* bit for bit between one multi-model launch and one call per model.

``scar_eval_plain``, the scoring half in the compact form, stays held
against the Pallas kernel (``interpret=True``) and the jnp oracle
``scar_eval_ref`` at rtol 2e-5, the repo's float32 kernel tolerance
(``tests/test_kernels.py``): both sides are float32 and differ only in
summation order.

Inputs are made from a numpy seed.  The CUDA kernel itself runs only on a
GPU: the tests marked ``cuda`` skip elsewhere (``python -m pytest -m cuda
tests/test_torch_scar_eval.py`` on the card) and hold it bitwise against
its plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.scar_eval import (ModelInputs, blocked_cumsum,
                                           pack_window, scar_eval,
                                           scar_eval_plain,
                                           scar_eval_window_plain)

# The JAX reference is imported inside the tests that compare against it,
# so the ``cuda`` tests also run where JAX is not installed.

RTOL = 2e-5
REF_RTOL = 2e-4           # the reference's float32 evaluator tolerance
COLS = 6
N_CHIPLETS = 36

# (B, Lw, S, C): single candidate/layer, ragged batches, the 6x6 and 16x16
# main-path widths (Lw 56..80, S 6, C 2), a deep window and 3 classes.
SHAPES = [(1, 1, 1, 2), (7, 11, 6, 2), (24, 56, 6, 2), (33, 80, 8, 3),
          (16, 300, 6, 3)]


def compact_batch(rng, B, Lw, S, C):
    """Seeded compact inputs, incl. padding rows and single-segment rows."""
    lat_tab = rng.lognormal(-9, 2, (Lw, C)).astype(np.float32)
    e_tab = rng.lognormal(-5, 2, (Lw, C)).astype(np.float32)
    n_segs = rng.integers(0, min(S, Lw) + 1, B)
    n_segs[0] = min(1, Lw)                       # a single-segment row
    if B > 1:
        n_segs[-1] = 0                           # a padding row
    last = np.full((B, S), -1, np.int32)
    for b in range(B):
        k = int(n_segs[b])
        if k:
            cuts = np.sort(rng.choice(Lw - 1, k - 1, replace=False))
            last[b, :k] = np.concatenate([cuts, [Lw - 1]])
    seg_cls = rng.integers(0, C, (B, S)).astype(np.int32)
    comm_lat = rng.lognormal(-10, 1, (B, S)).astype(np.float32)
    comm_e = rng.lognormal(-6, 1, (B, S)).astype(np.float32)
    return lat_tab, e_tab, seg_cls, last, n_segs.astype(np.int32), \
        comm_lat, comm_e


def random_model(rng, B, Lw, S, C, *, prev_end=None, pipelined=True,
                 n_chiplets=N_CHIPLETS):
    """Seeded raw inputs of one model: some zero byte counts (the comm
    formulas' ``sz > 0`` branches), a single-segment row, a padding row."""
    def logn(mu, shape, zeros=0.0):
        a = rng.lognormal(mu, 2, shape).astype(np.float32)
        return np.where(rng.random(shape) < zeros, np.float32(0), a)

    n_segs = rng.integers(1, min(S, Lw) + 1, B)
    n_segs[0] = 1
    if B > 1:
        n_segs[-1] = 0
    # k - 1 strictly increasing cuts in [0, Lw - 2], then the window end
    j = np.arange(S)
    u = np.sort(rng.random((B, S)), axis=1)
    cuts = np.floor(u * (Lw - n_segs[:, None] + 1)).astype(np.int64) + j
    last = np.where(j < n_segs[:, None] - 1, cuts,
                    np.where(j == n_segs[:, None] - 1, Lw - 1, -1))
    chips = np.where(j < n_segs[:, None],
                     rng.integers(0, n_chiplets, (B, S)), -1)
    return ModelInputs(logn(-9, (Lw, C)), logn(-5, (Lw, C)),
                       logn(12, Lw, 0.1), logn(10, Lw, 0.1),
                       float(np.float32(rng.lognormal(10, 1))),
                       chips.astype(np.int32), last.astype(np.int32),
                       n_segs.astype(np.int32), prev_end, pipelined)


def class_map_of(rng, C, n_chiplets=N_CHIPLETS):
    return rng.integers(0, C, n_chiplets).astype(np.int32)


def port_pkg():
    from repro_torch.core.chiplet import PackageParams
    return PackageParams()


def window(models, class_map, n_active, device="cpu", pkg=None):
    return pack_window(models, class_map, pkg or port_pkg(), COLS,
                       n_active, device=torch.device(device))


def reference_scores(m: ModelInputs, class_map, n_active, cols=COLS,
                     pkg=None):
    """The reference's jitted float32 evaluator on the same inputs."""
    import jax.numpy as jnp
    from repro.core.chiplet import PackageParams
    from repro.kernels.scar_eval.ops import evaluate
    S = max(1, int(m.n_segs.max()))
    f = np.float32
    args = [jnp.asarray(a) for a in (
        np.asarray(m.lat_tab, f), np.asarray(m.e_tab, f),
        np.asarray(m.w_bytes, f), np.asarray(m.out_bytes, f),
        np.asarray(class_map, np.int32),
        np.asarray(m.chips[:, :S], np.int32),
        np.zeros((m.n_segs.shape[0], 1), np.int32),
        np.asarray(m.last[:, :S], np.int32), np.asarray(m.n_segs, np.int32),
        f(m.act_in), np.int32(m.prev_end or 0),
        np.zeros((1, 1), f), np.zeros(1, f))]
    return np.asarray(evaluate(
        *args, pkg=pkg or PackageParams(), mcm_cols=cols, n_active=n_active,
        pipelined=m.pipelined, has_prev=m.prev_end is not None,
        congestion=False, noc=None, use_kernel=False))


def composed_scores(m: ModelInputs, class_map, pkg, cols, n_active):
    """``comm_from_parts`` + ``scar_eval_plain`` on one model's inputs."""
    from repro_torch.core.cost import comm_from_parts
    S = max(1, int(m.n_segs.max()))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
        ("lat", np.asarray(m.lat_tab, np.float32)),
        ("e", np.asarray(m.e_tab, np.float32)),
        ("w", np.asarray(m.w_bytes, np.float32)),
        ("out", np.asarray(m.out_bytes, np.float32)),
        ("chips", np.asarray(m.chips[:, :S], np.int32)),
        ("last", np.asarray(m.last[:, :S], np.int32)),
        ("n", np.asarray(m.n_segs, np.int32)),
        ("cls", np.asarray(class_map, np.int32)))}
    Lw = t["lat"].shape[0]
    cpos = t["chips"].clamp(min=0)
    exists = torch.arange(S)[None, :] < t["n"][:, None]
    hi = t["last"].long().clamp(0, Lw - 1)
    lo = torch.cat([torch.zeros_like(hi[:, :1]),
                    t["last"][:, :-1].long().clamp(min=-1) + 1], dim=1)
    zero = torch.zeros(())
    seg_last_out = torch.where(exists, t["out"][hi], zero)
    cw = torch.cat([torch.zeros(1), blocked_cumsum(t["w"])])
    seg_w = torch.where(exists, cw[hi + 1] - cw[lo], zero)
    ip_lat, ip_e, op_lat, op_e = comm_from_parts(
        pkg, cols, cpos, seg_w, seg_last_out, t["n"], n_active, m.act_in,
        m.prev_end)
    return scar_eval_plain(t["lat"], t["e"], t["cls"][cpos.long()],
                           t["last"], t["n"], ip_lat + op_lat,
                           ip_e + op_e, m.pipelined).numpy()


# ---------------------------- scoring half ---------------------------------

def dense_inputs(lat_tab, e_tab, seg_cls, last, n_segs, comm_lat, comm_e,
                 pipelined):
    """The Pallas kernel's dense one-hot inputs for the same batch."""
    import jax.numpy as jnp
    Lw, C = lat_tab.shape
    B, S = seg_cls.shape
    seg_id = np.full((B, Lw), -1)
    for b in range(B):
        lo = 0
        for s in range(int(n_segs[b])):
            seg_id[b, lo:last[b, s] + 1] = s
            lo = last[b, s] + 1
    live = seg_id >= 0
    layer_cls = np.take_along_axis(seg_cls, np.maximum(seg_id, 0), axis=1)
    cls_oh = (layer_cls[..., None] == np.arange(C)) & live[..., None]
    seg_oh = seg_id[..., None] == np.arange(S)
    valid = np.arange(S)[None, :] < n_segs[:, None]
    pipe = np.full((B, 1), 1.0 if pipelined else 0.0, np.float32)
    f = np.float32
    return (jnp.asarray(lat_tab), jnp.asarray(e_tab), jnp.asarray(cls_oh, f),
            jnp.asarray(seg_oh, f), jnp.asarray(comm_lat),
            jnp.asarray(comm_e), jnp.asarray(valid, f), jnp.asarray(pipe))


@pytest.mark.parametrize("B,Lw,S,C", SHAPES)
@pytest.mark.parametrize("pipelined", [True, False])
def test_plain_matches_pallas_kernel_and_ref(B, Lw, S, C, pipelined):
    from repro.kernels.scar_eval import scar_eval as pallas_scar_eval
    from repro.kernels.scar_eval import scar_eval_ref
    rng = np.random.default_rng(B * 1000 + Lw * 10 + S + C)
    batch = compact_batch(rng, B, Lw, S, C)
    dense = dense_inputs(*batch, pipelined)
    ours = scar_eval_plain(*(torch.from_numpy(a) for a in batch),
                           pipelined).numpy()
    pallas = np.asarray(pallas_scar_eval(*dense, block_b=B, interpret=True))
    ref = np.asarray(scar_eval_ref(*dense))
    np.testing.assert_allclose(ours, pallas, rtol=RTOL)
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    # padding rows score (0, 0), as in the reference
    assert (ours[batch[4] == 0] == 0).all()


@pytest.mark.parametrize("n", [1, 11, 16, 17, 56, 80, 300, 1000, 5000])
def test_blocked_cumsum_matches_reference_float32_bits(n):
    """``blocked_cumsum`` sums in the association of the reference's
    float32 evaluator (``jnp.cumsum`` on the CPU), bit for bit."""
    import jax.numpy as jnp
    x = np.random.default_rng(n).lognormal(0, 3, (n, 2)).astype(np.float32)
    ours = blocked_cumsum(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
    np.testing.assert_array_equal(ours, theirs)


# ----------------------- the whole window's scores -------------------------

@pytest.mark.parametrize("B,Lw,S,C", SHAPES)
@pytest.mark.parametrize("anchor", [None, 14])
@pytest.mark.parametrize("pipelined", [True, False])
def test_window_plain_matches_reference_evaluate(B, Lw, S, C, anchor,
                                                 pipelined):
    """Seeded random batches: the plain version against the reference's
    jitted ``evaluate(..., use_kernel=False)`` at its 2e-4, and bitwise
    against ``comm_from_parts`` + ``scar_eval_plain``."""
    rng = np.random.default_rng(B * 7 + Lw * 3 + S + C)
    cmap = class_map_of(rng, C)
    m = random_model(rng, B, Lw, S, C, prev_end=anchor, pipelined=pipelined)
    ours = scar_eval_window_plain(window([m], cmap, 3)).numpy()
    assert ours.dtype == np.float32 and ours.shape == (B, 2)
    np.testing.assert_allclose(ours, reference_scores(m, cmap, 3),
                               rtol=REF_RTOL)
    np.testing.assert_array_equal(
        ours, composed_scores(m, cmap, port_pkg(), COLS, 3))
    assert (ours[m.n_segs == 0] == 0).all()


def scenario_windows(scn):
    """Per window of the port's 6x6 ``het_cross`` schedule of ``scn``:
    every model's ``ModelInputs`` (anchored from the window before) and
    the window's size."""
    import repro_torch.core as T
    from repro_torch.core.provision import provision
    from repro_torch.core.reconfig import greedy_pack
    from repro_torch.core.sched import assemble_candidates
    from repro_torch.core.scheduler import get_cost_db
    from repro_torch.core.segmentation import top_k_segmentations
    from repro_torch.kernels.scar_eval import model_inputs
    n_pe = 4096 if scn.startswith("dc") else 256
    mcm = T.make_mcm("het_cross", rows=6, cols=6, n_pe=n_pe)
    cfg = T.SearchConfig()
    sc = T.get_scenario(scn)
    plan = T.schedule(sc, mcm, cfg, device="cpu")
    db = get_cost_db(sc, mcm)
    anchors: dict[int, int] = {}
    out = []
    for w, ranges in enumerate(greedy_pack(db, mcm.class_counts(),
                                           cfg.n_splits).ranges):
        alloc = provision(db, mcm.class_counts(), ranges, mcm.n_chiplets,
                          metric=cfg.metric,
                          max_nodes_per_model=cfg.max_nodes_per_model)
        models = []
        for mi, (s, e) in sorted(ranges.items()):
            segs = top_k_segmentations(db, mcm, s, e, alloc[mi],
                                       k=cfg.seg_top_k, cap=cfg.seg_cap,
                                       metric=cfg.metric)
            cand, _, _ = assemble_candidates(
                mcm, mi, (s, e), segs, anchors.get(mi),
                path_cap=cfg.path_cap, frontier_cap=cfg.frontier_cap)
            models.append(model_inputs(db, cand, anchors.get(mi)))
        out.append((models, len(ranges)))
        anchors.update(plan.windows[w].result.end_chiplet)
    return mcm, out


@pytest.mark.parametrize("scn", ["xr10_vr_gaming", "dc4_lms_seg_image"])
def test_window_plain_matches_reference_on_scenario_windows(scn):
    """Real batches: every window of a 6x6 schedule, cold and anchored
    models, scored in one multi-model batch, against the reference model
    by model (2e-4) and bitwise against the composed definition."""
    import repro.core as R
    mcm, windows = scenario_windows(scn)
    ref_pkg = R.make_mcm("het_cross", rows=6, cols=6).pkg
    anchored = 0
    for models, n_active in windows:
        batch = pack_window(models, mcm.class_map, mcm.pkg, mcm.cols,
                            n_active, device=torch.device("cpu"))
        ours = scar_eval_window_plain(batch).numpy()
        for m, slot in zip(models, batch.models):
            part = ours[slot.cand_off:slot.cand_off + slot.n_cand]
            np.testing.assert_allclose(
                part, reference_scores(m, mcm.class_map, n_active,
                                       cols=mcm.cols, pkg=ref_pkg),
                rtol=REF_RTOL)
            np.testing.assert_array_equal(
                part, composed_scores(m, mcm.class_map, mcm.pkg, mcm.cols,
                                      n_active))
            anchored += m.prev_end is not None
    assert anchored > 0


def four_models(rng, B, Lw, S, C):
    """Four models of one window: other widths and batch sizes, cold and
    anchored, pipelined and not."""
    return [random_model(rng, max(1, B >> i), max(1, Lw - 7 * i), S, C,
                         prev_end=None if i % 2 == 0 else 5 * i,
                         pipelined=i != 3) for i in range(4)]


def test_segmented_launch_equals_one_call_per_model():
    rng = np.random.default_rng(11)
    models = four_models(rng, 40, 30, 6, 3)
    cmap = class_map_of(rng, 3)
    whole = scar_eval_window_plain(window(models, cmap, 4))
    parts = torch.cat([scar_eval_window_plain(window([m], cmap, 4))
                       for m in models])
    assert torch.equal(whole, parts)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    batch = window(four_models(rng, 9, 20, 4, 2), class_map_of(rng, 2), 2)
    before = scar_eval.launches
    out = scar_eval(batch)
    assert scar_eval.launches == before
    assert torch.equal(out, scar_eval_window_plain(batch))


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(4)
    batch = window([random_model(rng, 9, 20, 4, 2)], class_map_of(rng, 2), 1)
    with pytest.raises(TypeError):
        scar_eval(batch._replace(last=batch.last.long()))
    with pytest.raises(ValueError):
        scar_eval(batch._replace(act_in=batch.lat_tab[:2, 0].contiguous()))
    with pytest.raises(ValueError):
        scar_eval(batch._replace(chips=torch.cat(
            [batch.chips, batch.chips], dim=1)[:, ::2]))
    with pytest.raises(ValueError):
        scar_eval(batch._replace(models=(batch.models[0]._replace(
            cand_off=1),)))


def test_kernel_request_on_cpu_raises():
    from repro_torch.kernels.scar_eval import evaluate
    rng = np.random.default_rng(5)
    batch = window([random_model(rng, 3, 5, 2, 2)], class_map_of(rng, 2), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(batch, use_kernel=True)


# ------------------------------ on the card --------------------------------

# B, Lw (2 400 needs 54 KB of shared memory at C = 2 and 74 KB at C = 3,
# above the 48 KB a launch gets without opting in; 5 000 needs a third
# carry level of the blocked prefix), S
CARD_B = (1, 127, 128, 4672, 65536)
CARD_LW = (1, 16, 17, 56, 300, 2400, 5000)
CARD_S = (1, 6, 8)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("n_models", [1, 4])
def test_cuda_kernel_matches_plain_bitwise(C, n_models):
    """On the card: the CUDA kernel against its plain version, bit for
    bit, over every (B, Lw, S), one launch per case."""
    needs_card()
    rng = np.random.default_rng(C * 10 + n_models)
    cmap = class_map_of(rng, C)
    for B in CARD_B:
        for Lw in CARD_LW:
            for S in CARD_S:
                models = (four_models(rng, B, Lw, S, C) if n_models == 4
                          else [random_model(rng, B, Lw, S, C,
                                             prev_end=B % 7)])
                batch = window(models, cmap, n_models, device="cuda")
                before = scar_eval.launches
                out = scar_eval(batch)
                plain = scar_eval_window_plain(batch)
                torch.cuda.synchronize()
                assert scar_eval.launches == before + 1
                assert torch.isfinite(out).all()
                assert torch.equal(out, plain), (B, Lw, S, C, n_models)


@pytest.mark.cuda
def test_cuda_segmented_launch_equals_one_launch_per_model():
    needs_card()
    rng = np.random.default_rng(12)
    models = four_models(rng, 5000, 60, 6, 2)
    cmap = class_map_of(rng, 2)
    whole = scar_eval(window(models, cmap, 4, device="cuda"))
    parts = torch.cat([scar_eval(window([m], cmap, 4, device="cuda"))
                       for m in models])
    torch.cuda.synchronize()
    assert torch.equal(whole, parts)
