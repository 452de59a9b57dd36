"""Layer graphs for the models used in the paper's ten scenarios (Table II).

Dims follow the published architectures; transformer models use the
5-layers-per-block decomposition of ``workload.transformer_layers`` so that
layer counts line up with the paper's Table III accounting (GPT-L: 120,
BERT-L: 60, U-Net: 23, ResNet-50: ~66).

Where the paper leaves a model under-specified (XRBench perception models) we
use compact published configurations of the cited networks; only relative
compute/communication magnitudes matter for the scheduling study.
"""
from __future__ import annotations

import functools
from typing import Callable

from .workload import Layer, Model, OpType, conv, dwconv, gemm, transformer_layers


# ---------------------------------------------------------------------------
# Datacenter / MLPerf models
# ---------------------------------------------------------------------------

def gpt_l(batch: int = 1, seq: int = 128) -> Model:
    # 24 blocks x 5 layers = 120 layers (Table III).  d_model per GPT-2 family.
    layers = transformer_layers("gptl", n_blocks=24, d_model=1280, n_heads=20,
                                d_ff=5120, seq=seq, batch=batch)
    return Model("GPT-L", tuple(layers), batch)


def bert_l(batch: int = 1, seq: int = 128) -> Model:
    # 12 blocks x 5 = 60 layers, matching the paper's Table III count.
    layers = transformer_layers("bertl", n_blocks=12, d_model=1024, n_heads=16,
                                d_ff=4096, seq=seq, batch=batch)
    return Model("BERT-L", tuple(layers), batch)


def bert_base(batch: int = 1, seq: int = 128) -> Model:
    layers = transformer_layers("bertb", n_blocks=12, d_model=768, n_heads=12,
                                d_ff=3072, seq=seq, batch=batch)
    return Model("BERT-base", tuple(layers), batch)


def _bottleneck(prefix: str, N: int, cin: int, cmid: int, cout: int, y: int,
                x: int, stride: int, downsample: bool) -> list[Layer]:
    ls = [
        conv(f"{prefix}.c1", N, cin, cmid, y, x, R=1, stride=1),
        conv(f"{prefix}.c2", N, cmid, cmid, y, x, R=3, stride=stride),
        conv(f"{prefix}.c3", N, cmid, cout, y, x, R=1, stride=1),
    ]
    if downsample:
        ls.append(conv(f"{prefix}.ds", N, cin, cout, y, x, R=1, stride=stride))
    return ls


def resnet50(batch: int = 1, res: int = 224) -> Model:
    N = batch
    layers: list[Layer] = [conv("r50.stem", N, 3, 64, res // 2, res // 2, R=7, stride=2)]
    layers.append(Layer("r50.maxpool", OpType.POOL, N=N, K=64, C=64,
                        Y=res // 4, X=res // 4, stride=2))
    cfg = [(3, 64, 256, res // 4), (4, 128, 512, res // 8),
           (6, 256, 1024, res // 16), (3, 512, 2048, res // 32)]
    cin = 64
    for si, (blocks, cmid, cout, y) in enumerate(cfg):
        for b in range(blocks):
            stride = 2 if (b == 0 and si > 0) else 1
            layers += _bottleneck(f"r50.s{si}.b{b}", N, cin, cmid, cout, y, y,
                                  stride, downsample=(b == 0))
            cin = cout
    layers.append(Layer("r50.avgpool", OpType.POOL, N=N, K=2048, C=2048, Y=1, X=1))
    layers.append(gemm("r50.fc", M=1, N=1000, K=2048, B=N))
    return Model("ResNet-50", tuple(layers), batch)


def unet(batch: int = 1, res: int = 512) -> Model:
    """Classic 23-conv U-Net (512x512x1 input, Table II)."""
    N = batch
    layers: list[Layer] = []
    ch = [64, 128, 256, 512]
    y = res
    cin = 1
    for i, c in enumerate(ch):  # encoder: 2 convs per level (8 convs)
        layers.append(conv(f"unet.e{i}.c1", N, cin, c, y, y, R=3))
        layers.append(conv(f"unet.e{i}.c2", N, c, c, y, y, R=3))
        cin = c
        y //= 2
    layers.append(conv("unet.mid.c1", N, 512, 1024, y, y, R=3))   # bottleneck (2)
    layers.append(conv("unet.mid.c2", N, 1024, 1024, y, y, R=3))
    cin = 1024
    for i, c in enumerate(reversed(ch)):  # decoder: upconv + 2 convs (12 convs)
        y *= 2
        layers.append(conv(f"unet.d{i}.up", N, cin, c, y, y, R=2))
        layers.append(conv(f"unet.d{i}.c1", N, 2 * c, c, y, y, R=3))
        layers.append(conv(f"unet.d{i}.c2", N, c, c, y, y, R=3))
        cin = c
    layers.append(conv("unet.out", N, 64, 2, y, y, R=1))          # 1x1 head (1)
    return Model("U-Net", tuple(layers), batch)  # 8+2+12+1 = 23 convs


def googlenet(batch: int = 1, res: int = 224) -> Model:
    N = batch
    layers: list[Layer] = [
        conv("gn.stem1", N, 3, 64, res // 2, res // 2, R=7, stride=2),
        conv("gn.stem2", N, 64, 64, res // 4, res // 4, R=1),
        conv("gn.stem3", N, 64, 192, res // 4, res // 4, R=3),
    ]
    # (cin, 1x1, 3r, 3x3, 5r, 5x5, pool_proj, y)
    inc = [
        (192, 64, 96, 128, 16, 32, 32, 28), (256, 128, 128, 192, 32, 96, 64, 28),
        (480, 192, 96, 208, 16, 48, 64, 14), (512, 160, 112, 224, 24, 64, 64, 14),
        (512, 128, 128, 256, 24, 64, 64, 14), (512, 112, 144, 288, 32, 64, 64, 14),
        (528, 256, 160, 320, 32, 128, 128, 14), (832, 256, 160, 320, 32, 128, 128, 7),
        (832, 384, 192, 384, 48, 128, 128, 7),
    ]
    scale = res / 224.0
    for i, (cin, c1, c3r, c3, c5r, c5, pp, y) in enumerate(inc):
        y = int(y * scale)
        p = f"gn.inc{i}"
        layers += [
            conv(f"{p}.b1", N, cin, c1, y, y, R=1),
            conv(f"{p}.b3r", N, cin, c3r, y, y, R=1),
            conv(f"{p}.b3", N, c3r, c3, y, y, R=3),
            conv(f"{p}.b5r", N, cin, c5r, y, y, R=1),
            conv(f"{p}.b5", N, c5r, c5, y, y, R=5),
            conv(f"{p}.bp", N, cin, pp, y, y, R=1),
        ]
    layers.append(gemm("gn.fc", M=1, N=1000, K=1024, B=N))
    return Model("GoogleNet", tuple(layers), batch)


# ---------------------------------------------------------------------------
# XRBench / AR-VR models
# ---------------------------------------------------------------------------

def _inverted_residual(prefix: str, N: int, cin: int, cout: int, y: int,
                       expand: int, stride: int, k: int = 3) -> list[Layer]:
    cmid = cin * expand
    return [
        conv(f"{prefix}.pw1", N, cin, cmid, y, y, R=1),
        dwconv(f"{prefix}.dw", N, cmid, y // stride, y // stride, R=k, stride=stride),
        conv(f"{prefix}.pw2", N, cmid, cout, y // stride, y // stride, R=1),
    ]


def d2go(batch: int = 1, res: int = 224) -> Model:
    """D2Go object detection: FBNet-style mobile backbone + detection head."""
    N = batch
    layers: list[Layer] = [conv("d2go.stem", N, 3, 16, res // 2, res // 2, R=3, stride=2)]
    y = res // 2
    cfg = [(16, 24, 2, 4), (24, 32, 2, 4), (32, 64, 2, 4), (64, 96, 1, 4),
           (96, 160, 2, 6), (160, 240, 1, 6)]
    for i, (cin, cout, stride, ex) in enumerate(cfg):
        layers += _inverted_residual(f"d2go.ir{i}", N, cin, cout, y, ex, stride)
        y //= stride
    for i in range(4):  # detection head convs
        layers.append(conv(f"d2go.head{i}", N, 240, 240, y, y, R=3))
    layers.append(conv("d2go.cls", N, 240, 80, y, y, R=1))
    layers.append(conv("d2go.reg", N, 240, 16, y, y, R=1))
    return Model("D2GO", tuple(layers), batch)


def planercnn(batch: int = 1, res: int = 256) -> Model:
    """PlaneRCNN: ResNet50-FPN backbone + plane detection heads (compact)."""
    base = resnet50(batch, res)
    N = batch
    y = res // 32
    extra: list[Layer] = []
    for i, (cin, yy) in enumerate([(2048, y), (1024, y * 2), (512, y * 4), (256, y * 8)]):
        extra.append(conv(f"prcnn.fpn{i}.lat", N, cin, 256, yy, yy, R=1))
        extra.append(conv(f"prcnn.fpn{i}.out", N, 256, 256, yy, yy, R=3))
    for i in range(4):
        extra.append(conv(f"prcnn.mask{i}", N, 256, 256, y * 4, y * 4, R=3))
    extra.append(conv("prcnn.depth", N, 256, 64, y * 8, y * 8, R=3))
    extra.append(conv("prcnn.plane", N, 64, 3, y * 8, y * 8, R=1))
    return Model("PlaneRCNN", tuple(base.layers) + tuple(extra), batch)


def midas(batch: int = 1, res: int = 256) -> Model:
    """MiDaS monocular depth: ResNet-ish encoder + refinement decoder."""
    base = resnet50(batch, res)
    N = batch
    extra: list[Layer] = []
    y = res // 32
    cin = 2048
    for i, c in enumerate([512, 256, 128, 64]):
        extra.append(conv(f"midas.ref{i}.c1", N, cin, c, y, y, R=3))
        y *= 2
        extra.append(conv(f"midas.ref{i}.c2", N, c, c, y, y, R=3))
        cin = c
    extra.append(conv("midas.out", N, 64, 1, y, y, R=3))
    return Model("MiDaS", tuple(base.layers) + tuple(extra), batch)


def emformer(batch: int = 1, seq: int = 128) -> Model:
    """Emformer streaming ASR: 20 transformer blocks, d=512."""
    layers = transformer_layers("emf", n_blocks=20, d_model=512, n_heads=8,
                                d_ff=2048, seq=seq, batch=batch)
    return Model("Emformer", tuple(layers), batch)


def hrvit(batch: int = 1, res: int = 224) -> Model:
    """HRViT-b1 semantic segmentation: conv stem + multi-scale attn blocks."""
    N = batch
    layers: list[Layer] = [
        conv("hrvit.stem1", N, 3, 32, res // 2, res // 2, R=3, stride=2),
        conv("hrvit.stem2", N, 32, 64, res // 4, res // 4, R=3, stride=2),
    ]
    for stage, (c, blocks, red) in enumerate([(64, 2, 4), (128, 2, 8), (256, 6, 16), (512, 2, 32)]):
        y = res // red
        seq = y * y
        layers += transformer_layers(f"hrvit.s{stage}", n_blocks=blocks,
                                     d_model=c, n_heads=max(1, c // 64),
                                     d_ff=c * 4, seq=seq, batch=N)
        if stage < 3:
            layers.append(conv(f"hrvit.down{stage}", N, c, c * 2, y // 2, y // 2, R=3, stride=2))
    layers.append(conv("hrvit.seghead", N, 512, 19, res // 8, res // 8, R=1))
    return Model("HRViT", tuple(layers), batch)


def hand_sp(batch: int = 1, res: int = 224) -> Model:
    """3D hand shape/pose: ResNet-lite encoder + graph-conv decoder (GEMMs)."""
    N = batch
    layers: list[Layer] = [conv("hand.stem", N, 3, 64, res // 2, res // 2, R=7, stride=2)]
    y, cin = res // 4, 64
    for i, c in enumerate([64, 128, 256, 512]):
        stride = 1 if i == 0 else 2
        layers.append(conv(f"hand.s{i}.c1", N, cin, c, y // stride, y // stride, R=3, stride=stride))
        layers.append(conv(f"hand.s{i}.c2", N, c, c, y // stride, y // stride, R=3))
        y //= stride
        cin = c
    for i in range(6):  # graph-conv mesh decoder as dense GEMMs over 778 verts
        layers.append(gemm(f"hand.gcn{i}", M=778, N=64, K=64, B=N))
    layers.append(gemm("hand.pose", M=1, N=63, K=512, B=N))
    return Model("HandSP", tuple(layers), batch)


def eyecod(batch: int = 1, res: int = 128) -> Model:
    """EyeCod gaze estimation: compact CNN on eye crops."""
    N = batch
    layers: list[Layer] = [conv("eye.stem", N, 1, 32, res // 2, res // 2, R=5, stride=2)]
    y, cin = res // 2, 32
    for i, c in enumerate([64, 128, 256]):
        layers.append(conv(f"eye.c{i}a", N, cin, c, y // 2, y // 2, R=3, stride=2))
        layers.append(conv(f"eye.c{i}b", N, c, c, y // 2, y // 2, R=3))
        y //= 2
        cin = c
    layers.append(gemm("eye.fc1", M=1, N=256, K=256 * (y // 2) * (y // 2), B=N))
    layers.append(gemm("eye.fc2", M=1, N=3, K=256, B=N))
    return Model("EyeCod", tuple(layers), batch)


def sp2dense(batch: int = 1, res: int = 224) -> Model:
    """Sparse-to-dense depth refinement: encoder-decoder CNN."""
    N = batch
    layers: list[Layer] = [conv("s2d.stem", N, 4, 64, res // 2, res // 2, R=7, stride=2)]
    y, cin = res // 2, 64
    for i, c in enumerate([128, 256, 512]):
        layers.append(conv(f"s2d.e{i}", N, cin, c, y // 2, y // 2, R=3, stride=2))
        y //= 2
        cin = c
    for i, c in enumerate([256, 128, 64]):
        y *= 2
        layers.append(conv(f"s2d.d{i}.up", N, cin, c, y, y, R=2))
        layers.append(conv(f"s2d.d{i}.c", N, c, c, y, y, R=3))
        cin = c
    layers.append(conv("s2d.out", N, 64, 1, y * 2, y * 2, R=3))
    return Model("Sp2Dense", tuple(layers), batch)


REGISTRY: dict[str, Callable[..., Model]] = {
    "gpt-l": gpt_l,
    "bert-l": bert_l,
    "bert-base": bert_base,
    "resnet-50": resnet50,
    "u-net": unet,
    "googlenet": googlenet,
    "d2go": d2go,
    "planercnn": planercnn,
    "midas": midas,
    "emformer": emformer,
    "hrvit": hrvit,
    "hand-sp": hand_sp,
    "eyecod": eyecod,
    "sp2dense": sp2dense,
}


@functools.lru_cache(maxsize=256)
def get_model(name: str, batch: int = 1) -> Model:
    """Build (or return the cached) model graph for ``name`` at ``batch``.

    ``Model``/``Layer`` are frozen dataclasses, so instances are safely
    shared.  The cache matters online: ``rescheduler.active_scenario``
    resolves every active tenant's model each epoch, which on
    million-event fleet traces is millions of calls that would otherwise
    rebuild identical layer graphs.
    """
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name](batch=batch)
