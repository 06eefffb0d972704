"""Meshes of ranks for the port's multi-device permanents.

The port of the reference package's ``launch/mesh.py`` to
``torch.distributed``: one process (a *rank*) per device, as the paper's
MPI runs have one per GPU, started by ``torchrun`` on each host of a
cluster (``python -m torch.distributed.run --nproc-per-node K ...``) or
by :func:`run_world` on this host.  A :class:`Mesh` is the named grid of
the world's global ranks, one gloo group per axis, and this rank's
compute device, held apart from the communication mesh:

* what crosses ranks is tiny -- one twofloat ``(hi, lo)`` pair a slice,
  or one value a matrix -- so every collective carries **host tensors
  over gloo**; the kernels run on each rank's own card.  The same code
  runs as gloo processes on a CPU, as several ranks sharing one card,
  and on a cluster.  NCCL is not used: it refuses two ranks on one card
  ("Duplicate GPU detected"), and nothing here needs its bandwidth;
* a rank's device is ``cuda:(LOCAL_RANK // ranks_per_device)`` unless
  the caller names one (``device="cpu"`` for the tests).  A world that
  puts more ranks on a card than ``ranks_per_device`` allows raises
  ``ValueError`` naming both counts (``init_device_mesh("cuda", ...)``
  would quietly map rank r to card r mod the card count); no card at all
  raises ``RuntimeError``: nothing falls back to the CPU.

Functions only: importing this module touches no ``torch.distributed``
state.  :func:`init_from_env` creates the default process group (gloo,
with a timeout, so a dead rank becomes an error and never a hang) and
:func:`shutdown` destroys it; :func:`world` does both around a block.

APIs (the reference's names):
  ``make_mesh``             a mesh of any shape over the world
  ``make_batch_mesh``       ("data",): buckets sharded over their batch axis
  ``make_campaign_mesh``    a ``CampaignMesh``: the ("batch", "step") grid,
                            its first column as the ("batch",) mesh of the
                            service's buckets and its first row as the
                            ("step",) mesh of its campaign
  ``make_local_mesh``       ("data", "model") over the world
  ``make_production_mesh``  (16, 16) / (2, 16, 16) for 256 / 512 ranks
  ``mesh_device_count``     the ranks of a mesh
  ``ctx_mesh``              the mesh of a distributed context, or None
"""

from __future__ import annotations

import contextlib
import math
import os
import pickle
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["Mesh", "CampaignMesh", "DEFAULT_TIMEOUT_S", "make_mesh",
           "make_batch_mesh", "make_campaign_mesh", "make_local_mesh",
           "make_production_mesh", "mesh_device_count", "ctx_mesh",
           "rank_device", "init_from_env", "shutdown", "world",
           "world_size", "launched_by_torchrun", "run_world"]

DEFAULT_TIMEOUT_S = 600.0   # the most a collective waits, then it raises


def _dist():
    import torch.distributed as dist
    return dist


@dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of the world's global ranks and this rank's place in
    it.  ``group`` is a gloo group over every rank of the mesh (the
    collectives of ``core/distributed.py``'s mesh functions), ``groups``
    this rank's gloo group along each axis; ``device`` is where this
    rank's kernels run."""
    axis_names: tuple[str, ...]
    ranks: np.ndarray                 # global ranks, shape = the mesh's
    device: torch.device
    group: Any
    groups: dict = field(default_factory=dict)
    ranks_per_device: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.ranks.shape)

    @property
    def size(self) -> int:
        """Ranks in the mesh: its shards (several may share one card)."""
        return int(self.ranks.size)

    @property
    def index(self) -> int:
        """This rank's shard: its position in the row-major order of the
        grid, the order in which shards own slices and matrices."""
        return int(np.flatnonzero(self.ranks.ravel()
                                  == _dist().get_rank())[0])

    @property
    def root(self) -> int:
        """The global rank of shard 0 (it writes checkpoints)."""
        return int(self.ranks.ravel()[0])

    def describe(self) -> str:
        axes = ",".join(f"{a}={k}" for a, k in zip(self.axis_names,
                                                   self.shape))
        return (f"mesh({axes}) rank {_dist().get_rank()} shard {self.index} "
                f"device {self.device} ranks_per_device "
                f"{self.ranks_per_device}")


def mesh_device_count(mesh: Mesh) -> int:
    """The ranks of ``mesh`` (the reference counts devices; a port rank
    is one shard, and several may share a card)."""
    return mesh.size


def ctx_mesh(ctx) -> Mesh | None:
    """The mesh of a distributed context: a :class:`Mesh`, or an object
    with a ``.mesh`` (``DistributedPermanent``, ``CampaignMesh``); else
    None."""
    mesh = getattr(ctx, "mesh", ctx)
    return mesh if isinstance(mesh, Mesh) else None


def _local_placement() -> tuple[int, int]:
    """(LOCAL_RANK, LOCAL_WORLD_SIZE) from ``torchrun``'s environment; a
    world started without it (``run_world``, a file store) is one host:
    the global rank and world size."""
    dist = _dist()
    rank, size = dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", size)))


def rank_device(local_rank: int, local_world: int, ranks_per_device: int,
                device_count: int) -> torch.device:
    """The card of a rank: ``cuda:(local_rank // ranks_per_device)``.
    ``local_world`` ranks on a host of ``device_count`` cards put
    ceil(local_world / device_count) ranks on a card; more than
    ``ranks_per_device`` raises ``ValueError``, no card ``RuntimeError``."""
    if ranks_per_device < 1:
        raise ValueError(f"ranks_per_device must be >= 1, got "
                         f"{ranks_per_device}")
    if device_count < 1:
        raise RuntimeError(
            "no CUDA card on this host: a mesh rank runs on a card unless "
            "the caller passes device='cpu'")
    need = -(-local_world // device_count)
    if need > ranks_per_device:
        raise ValueError(
            f"{local_world} ranks on this host over {device_count} card(s) "
            f"put {need} ranks on a card, but ranks_per_device="
            f"{ranks_per_device} allows {ranks_per_device}; pass "
            f"ranks_per_device={need} to time-slice the cards")
    return torch.device("cuda", local_rank // ranks_per_device)


def _new_group(ranks: list[int]):
    return _dist().new_group(ranks=ranks, backend="gloo",
                             timeout=timedelta(seconds=DEFAULT_TIMEOUT_S))


def make_mesh(shape, names, *, device=None,
              ranks_per_device: int = 1) -> Mesh:
    """A mesh of ``shape`` (its product the world size) with axes
    ``names`` over the ranks in order; every rank of the world calls it
    (group creation is collective).  ``device`` None maps this rank to
    its card (``rank_device``); ``"cpu"`` or ``"cuda:k"`` names it.  A
    card becomes the process's current device, so ``"cuda"`` anywhere in
    the process means the mesh's."""
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "repro_torch.launch.mesh.init_from_env() first")
    shape, names = tuple(int(k) for k in shape), tuple(names)
    if len(shape) != len(names) or not shape or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} and axis names {names} "
                         f"must pair up, each extent >= 1")
    size = dist.get_world_size()
    if math.prod(shape) != size:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, "
                         f"the world has {size}: a mesh spans the world")
    if device is None:
        local_rank, local_world = _local_placement()
        dev = rank_device(local_rank, local_world, ranks_per_device,
                          torch.cuda.device_count())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)       # "cuda" in this process is dev
    grid = np.arange(size).reshape(shape)
    me = dist.get_rank()
    everyone = _new_group(list(range(size)))
    groups = {}
    for k, name in enumerate(names):
        if len(shape) == 1:
            groups[name] = everyone
            continue
        lines = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
        for line in lines:               # every rank creates every group
            g = _new_group([int(r) for r in line])
            if me in line:
                groups[name] = g
    return Mesh(axis_names=names, ranks=grid, device=dev, group=everyone,
                groups=groups, ranks_per_device=ranks_per_device)


def make_batch_mesh(num_devices: int | None = None, **kw) -> Mesh:
    """One-axis ("data",) mesh for batch-axis sharding over the world;
    ``num_devices`` must be the world size when given."""
    size = _dist().get_world_size()
    n = size if num_devices is None else int(num_devices)
    if n != size:
        raise ValueError(f"a mesh spans the world: need num_devices = "
                         f"{size}, got {n}")
    return make_mesh((n,), ("data",), **kw)


@dataclass(frozen=True, eq=False)
class CampaignMesh:
    """2D (batch x step) grid of ranks for mixed serving and campaign
    traffic, as the reference's: ``mesh`` is the full ``("batch",
    "step")`` grid; ``batch_mesh`` (the grid's first column) serves the
    ``distributed_batch`` buckets and ``step_mesh`` (the grid's first
    row) runs the campaign's waves.  The two overlap only at grid[0, 0],
    which time-slices between the roles; in a grid of 2 x 2 or more some
    ranks (grid[1, 1] at 2 x 2) have neither and only follow the
    service's broadcasts.  On a rank outside a sub-mesh that sub-mesh is
    None."""
    mesh: Mesh
    batch_mesh: Mesh | None
    step_mesh: Mesh | None


def _sub_mesh(full: Mesh, name: str, ranks: np.ndarray) -> Mesh | None:
    """A 1-D mesh ``(name,)`` over ``ranks`` of ``full`` with a gloo group
    of its own; every rank of the world calls it (group creation is
    collective), and those outside get None."""
    g = _new_group([int(r) for r in ranks])
    if _dist().get_rank() not in ranks:
        return None
    return Mesh(axis_names=(name,), ranks=np.array(ranks), device=full.device,
                group=g, groups={name: g},
                ranks_per_device=full.ranks_per_device)


def make_campaign_mesh(batch: int, step: int, **kw) -> CampaignMesh:
    """Carve the world into a ``batch x step`` grid (``batch * step`` must
    be the world size) whose step row runs a resumable campaign while the
    batch column keeps serving buckets: a :class:`CampaignMesh`."""
    if batch < 1 or step < 1:
        raise ValueError(f"need batch >= 1 and step >= 1, got "
                         f"{batch}x{step}")
    full = make_mesh((batch, step), ("batch", "step"), **kw)
    return CampaignMesh(mesh=full,
                        batch_mesh=_sub_mesh(full, "batch", full.ranks[:, 0]),
                        step_mesh=_sub_mesh(full, "step", full.ranks[0, :]))


def make_local_mesh(model_axis: int | None = None, **kw) -> Mesh:
    """("data", "model") over the world: the model axis the largest power
    of two up to sqrt(world size), as the reference picks it."""
    n = _dist().get_world_size()
    if model_axis is None:
        model_axis = 1
        while model_axis * 2 <= int(math.sqrt(n)):
            model_axis *= 2
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {n} ranks")
    return make_mesh((n // model_axis, model_axis), ("data", "model"), **kw)


def make_production_mesh(multi_pod: bool = False, **kw) -> Mesh:
    """(16, 16) ("data", "model") over 256 ranks, or (2, 16, 16) ("pod",
    "data", "model") over 512; any other world raises ``ValueError``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = _dist().get_world_size()
    if size != math.prod(shape):
        raise ValueError(f"the production mesh needs {math.prod(shape)} "
                         f"ranks, the world has {size}")
    return make_mesh(shape, names, **kw)


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------

def world_size() -> int:
    """Ranks in the default process group."""
    return _dist().get_world_size()


def launched_by_torchrun() -> bool:
    """True when ``torchrun`` (or another launcher) set the world's
    environment: ``RANK`` and ``WORLD_SIZE``."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(init_method: str | None = None, *, rank: int | None = None,
                  world_size: int | None = None) -> bool:
    """Create the default process group (gloo, ``DEFAULT_TIMEOUT_S`` a
    collective) unless one exists; True when this call created it.

    Under ``torchrun``: ``RANK``, ``WORLD_SIZE`` and the rendezvous from
    the environment (``env://``).  With ``init_method`` (a ``file://``
    store, as the tests and ``run_world`` use): ``rank`` and
    ``world_size`` as given.  Neither: a world of one rank over an
    in-process store.  Every rank on one host (``LOCAL_WORLD_SIZE`` =
    ``WORLD_SIZE``, or a file store) binds gloo to the loopback interface
    unless ``GLOO_SOCKET_IFNAME`` names another."""
    dist = _dist()
    if dist.is_initialized():
        return False
    timeout = timedelta(seconds=DEFAULT_TIMEOUT_S)
    if init_method is None and not launched_by_torchrun():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
        return True
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        one_host = os.environ.get("LOCAL_WORLD_SIZE") == str(world_size)
    else:
        if rank is None or world_size is None:
            raise ValueError(f"init_method {init_method!r} needs rank and "
                             "world_size")
        one_host = init_method.startswith("file://")
    if one_host:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return True


def shutdown() -> None:
    """Destroy the default process group (and every group of its meshes)
    if one exists."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def world(init_method: str | None = None, **kw):
    """``init_from_env(...)`` around a block; the group is destroyed on
    the way out if this block created it."""
    created = init_from_env(init_method, **kw)
    try:
        yield
    finally:
        if created:
            shutdown()


def _world_main(rank: int, fn: Callable, world_size: int, store: str,
                out_dir: str, args: tuple) -> None:
    """One rank of ``run_world``: the group, ``fn``, its result pickled
    to ``out_dir``, the group destroyed."""
    with world(f"file://{store}", rank=rank, world_size=world_size):
        result = fn(rank, world_size, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(fn: Callable, world_size: int, work_dir: str, *,
              args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S
              ) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes of this host, each rank in a gloo world over a ``file://``
    store under ``work_dir`` (a fresh directory of the caller's), and
    return each rank's result in rank order.  ``fn`` must be importable
    (module level) and its result picklable.  A rank that raises or exits
    non-zero, or a world that outlives ``timeout_s``, raises
    ``RuntimeError``; every rank still alive is killed first."""
    import torch.multiprocessing as mp
    os.makedirs(work_dir, exist_ok=True)
    store = os.path.join(work_dir, "store")
    ctx = mp.start_processes(
        _world_main, args=(fn, world_size, store, work_dir, args),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise RuntimeError(f"world of {world_size} ranks outlived "
                                   f"its timeout of {timeout_s:.0f} s")
    except mp.ProcessRaisedException as e:
        raise RuntimeError(f"a rank of a world of {world_size} raised:\n"
                           f"{e}") from None
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"a rank of a world of {world_size} exited: "
                           f"{e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    out = []
    for r in range(world_size):
        with open(os.path.join(work_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
