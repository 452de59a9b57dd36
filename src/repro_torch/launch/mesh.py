"""Meshes of ranks (counterpart of ``repro.launch.mesh``).

The reference builds ``jax.sharding.Mesh``es over devices; the port runs
one process a rank (``torchrun``, or a spawn helper) and names the mesh in
two parts:

* ``MeshSpec``: axis names and shape, and the world ranks it covers in
  row-major order.  The sharding rules (``distributed.sharding``) read
  only ``axis_names`` and ``devices.shape``, so the 16x16 ``(data,
  model)`` and 2x16x16 ``(pod, data, model)`` production meshes can be
  reasoned about without 256 processes.
* ``RankMesh``: a ``MeshSpec`` on launched ranks, with one process group
  for every set of its axes (``axis(name)``, ``axes(names)``).  Every rank
  of the world builds every ``RankMesh``, also one it is not in (a pod's
  sub-mesh): ``torch.distributed.new_group`` is collective over the world.

``sharded_setup`` is the serve and train drivers' ``--mesh``: the
rank's ``Parallel``, device, padded dims and shard function.
``device_mesh(spec)`` builds a ``torch.distributed.device_mesh.DeviceMesh``
over the launched ranks.  ``init_ranks`` joins (or starts) the process
group of a ``torchrun`` launch, with a timeout of its own so that a rank
that fails makes the others fail instead of hanging.  ``spawn`` is the
launcher for a single process (tests, ``chip_smoke.py``): it starts the
ranks itself, with a wall limit, and kills them all when one fails.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Axis", "MeshSpec", "RankMesh", "TIMEOUT_S", "device_mesh",
           "init_ranks", "make_mesh", "make_production_mesh",
           "make_test_mesh", "rank_device", "sharded_setup", "spawn"]

# A process group's timeout: a collective a peer never enters fails after
# this many seconds (torch's default is 30 minutes).
TIMEOUT_S = 60


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names and shape of a mesh, over ``ranks`` (row-major; default
    ``0 .. size - 1``)."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    ranks: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape {self.shape}")
        if self.ranks is not None and len(self.ranks) != self.size:
            raise ValueError(f"{len(self.ranks)} ranks for a mesh of "
                             f"{self.size}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def devices(self) -> np.ndarray:
        """The ranks laid out in the mesh's shape (the reference's
        ``mesh.devices``)."""
        ranks = self.ranks if self.ranks is not None else range(self.size)
        return np.asarray(list(ranks), dtype=np.int64).reshape(self.shape)

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def coords(self, rank: int) -> Optional[dict[str, int]]:
        """``rank``'s index along each axis, or None outside the mesh."""
        hit = np.argwhere(self.devices == rank)
        if not len(hit):
            return None
        return dict(zip(self.axis_names, (int(i) for i in hit[0])))

    def groups(self, names: tuple[str, ...]) -> list[list[int]]:
        """The rank lists that vary only along ``names`` (row-major over
        ``names``), one per index of the other axes."""
        keep = [self.axis_names.index(n) for n in names]
        rest = [i for i in range(len(self.shape)) if i not in keep]
        grid = np.transpose(self.devices, rest + keep)
        return [list(map(int, g.reshape(-1)))
                for g in grid.reshape(-1, int(np.prod(
                    [self.shape[i] for i in keep], dtype=np.int64)))]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              ranks: Optional[tuple[int, ...]] = None) -> MeshSpec:
    return MeshSpec(tuple(axes), tuple(int(s) for s in shape),
                    None if ranks is None else tuple(ranks))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 ``(data, model)``, or 2x16x16 ``(pod, data, model)``."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_test_mesh(n_devices: Optional[int] = None) -> MeshSpec:
    """``(data, model)`` over ``n_devices`` ranks (default: the world, or
    1 without a process group), the model axis 4, else 2, else 1, as the
    reference chooses."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return make_mesh((n // model, model), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class Axis:
    """One rank's place along a set of mesh axes: their joint size, its
    index (row-major), the group of ranks it shares them with (None when
    the size is 1) and their world ranks in index order.  A process
    group numbers its ranks in ascending world order, which a sub-mesh's
    order need not follow: ``distributed.collectives`` maps between the
    two."""
    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    ranks: tuple[int, ...] = ()


class RankMesh:
    """A ``MeshSpec`` on launched ranks, with a process group for every
    subset of its axes whose size is above 1.  Built by every rank of the
    world, in the same order; ``member`` tells whether this rank is in
    it."""

    def __init__(self, spec: MeshSpec):
        self.spec = spec
        self.rank = dist.get_rank()
        self.coords = spec.coords(self.rank)
        self.member = self.coords is not None
        self._axes: dict[tuple[str, ...], Axis] = {}
        names = spec.axis_names
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                self._axes[sub] = self._build(sub)

    def _build(self, names: tuple[str, ...]) -> Axis:
        groups = self.spec.groups(names)
        if len(groups[0]) == 1:
            return Axis()
        mine = None
        for ranks in groups:
            g = dist.new_group(ranks, timeout=datetime.timedelta(
                seconds=TIMEOUT_S))
            if self.rank in ranks:
                mine = Axis(len(ranks), ranks.index(self.rank), g,
                            tuple(ranks))
        return mine if mine is not None else Axis()

    def axes(self, names) -> Axis:
        """This rank's ``Axis`` over ``names`` (in the mesh's order; empty
        or all of size 1: a size-1 axis)."""
        names = tuple(n for n in self.spec.axis_names if n in names)
        return self._axes.get(names, Axis()) if names else Axis()

    def axis(self, name: str) -> Axis:
        return self.axes((name,))

    @property
    def all(self) -> Axis:
        return self.axes(self.spec.axis_names)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` if given, else its card
    (``cuda:<LOCAL_RANK mod the card count>``; several ranks share a card
    when there are fewer cards than ranks); raises without one."""
    from repro_torch.launch.platform import resolve_device
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        return resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device,
                local_world: Optional[int] = None) -> str:
    """NCCL where every one of the host's ``local_world`` ranks (default:
    ``torchrun``'s count) has a card of its own, gloo otherwise (CPU
    tensors, or ranks sharing a card: NCCL refuses two ranks on one
    device)."""
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", 1)))
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_ranks(device=None) -> torch.device:
    """Join the process group of a ``torchrun`` launch (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment)
    unless one is up, with a ``TIMEOUT_S`` timeout; returns this rank's
    device (``rank_device``), made current on a card."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend_for(dev), timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def sharded_setup(cfg, mesh: Optional[str], device, batch: int):
    """``(par, device, dims, shard)`` of a serve or train driver: on one
    device without ``mesh``; else this rank's ``Parallel`` on the ``test``
    or ``prod`` mesh of the launched ranks (joining the process group of a
    ``torchrun`` launch unless one is up), its device, the dims padded to
    the mesh's model axis in the ``tp`` style, and ``init_params``' shard
    function."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.launch.platform import resolve_device
    from repro_torch.models import ModelDims
    if mesh is None:
        return None, resolve_device(device), ModelDims.create(cfg), None
    dev = init_ranks(device)
    spec = make_production_mesh() if mesh == "prod" else make_test_mesh()
    world = dist.get_world_size()
    if spec.size != world:
        raise ValueError(f"--mesh {mesh} is {spec.shape}: {spec.size} "
                         f"ranks, but {world} were launched")
    par = tpl.make_parallel(cfg, RankMesh(spec), batch)
    tp = spec.axis_size("model") if shd.style_for(cfg) == "tp" else 1
    return par, dev, ModelDims.create(cfg, tp), (
        lambda path, tree: tpl.shard_params(cfg, tree, par, path))


def device_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """A ``torch.distributed.device_mesh.DeviceMesh`` of ``spec``'s shape
    and axis names over the launched ranks; raises if the world's size is
    not the mesh's."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if world != spec.size:
        raise ValueError(f"a {spec.shape} mesh needs {spec.size} ranks; "
                         f"{world} were launched")
    return DeviceMesh(device_type, torch.as_tensor(spec.devices),
                      mesh_dim_names=spec.axis_names)


def _rank_main(rank: int, world: int, init: str, backend: str,
               fn: Callable, args: tuple, results) -> None:
    try:
        torch.set_num_threads(1)
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out = fn(rank, *args)
        results.put((rank, True, out))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, *args, timeout_s: float = 300.0,
          backend: str = "gloo") -> list:
    """Run ``fn(rank, *args)`` on ``world`` new processes (``spawn``
    start method) that form one process group (``backend``, a ``file://``
    rendezvous in a fresh directory, ``TIMEOUT_S`` a collective); returns
    their results in rank order.  ``fn`` must be importable by name.  The
    first rank that raises, or the wall limit ``timeout_s``, kills every
    rank and raises ``RuntimeError`` with the traceback."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rendezvous-")
    init = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, init, backend, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=min(max(left, 0.1),
                                                          1.0))
            except queue.Empty:
                if left <= 0:
                    raise RuntimeError(f"spawn: {world - len(out)} of "
                                       f"{world} ranks still running after "
                                       f"{timeout_s} s") from None
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead:
                    raise RuntimeError(f"spawn: a rank exited with {dead}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
