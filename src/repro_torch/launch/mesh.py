"""Meshes of ranks over ``torch.distributed``.

The port of ``repro/launch/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the current process
group, ranks laid out row-major over ``shape`` (rank = d * tp + m on a
(data, model) mesh), with the JAX package's axis names. ``AbstractMesh``
is the same (axis names, axis sizes) with no ranks behind it: the
sharding rules (``sharding/rules.py``) read nothing else, so they run
without a process group.

Rank bootstrap (``init_ranks``): a process launched by ``torchrun`` finds
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` in its environment; otherwise
the launcher spawns the ranks itself (``spawn``) and hands each its rank
and the rendezvous address. The backend is explicit: NCCL puts rank r on
``cuda:r`` and refuses a world larger than the cards; gloo with
``device="cuda"`` puts rank r on ``cuda:(r % device_count)``, ranks
sharing a card, only because the caller asked for it.

``fake_world(world)`` is a world without its ranks: this process joins
PyTorch's fake process group as one rank of ``world``, whose collectives
return at once and move nothing, so the production mesh
(``make_production_mesh``) can be built and a step run on it on
``meta`` tensors (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from math import prod
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class AbstractMesh:
    """(axis names, axis sizes) with no ranks: what ``ShardingRules``
    reads of a mesh, like ``jax.sharding.AbstractMesh``."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an ``AbstractMesh``, a ``DeviceMesh`` or a
    JAX mesh."""
    if hasattr(mesh, "mesh_dim_names"):                  # DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def parse_mesh(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``"2x2:data,model"`` -> ((2, 2), ("data", "model"))."""
    try:
        dims, axes = spec.split(":")
        shape = tuple(int(x) for x in dims.split("x"))
        names = tuple(axes.split(","))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: want e.g. '2x2:data,model'")
    if len(shape) != len(names) or min(shape) < 1:
        raise ValueError(f"--mesh {spec!r}: {len(shape)} sizes for "
                         f"{len(names)} axes")
    return shape, names


def rank_device(backend: str, device: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, ``cuda:rank`` under NCCL, or
    ``cuda:(rank % device_count)`` under gloo (ranks sharing cards)."""
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on cards: pass --device cuda or "
                             "--dist-backend gloo")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu "
                           "--dist-backend gloo to run the ranks on the CPU")
    n = torch.cuda.device_count()
    if backend == "nccl":
        if rank >= n:
            raise ValueError(f"NCCL puts rank r on cuda:r, and this machine "
                             f"has {n} card(s): rank {rank} has none (ranks "
                             "may share a card only under --dist-backend "
                             "gloo)")
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % n)


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """Inside, this process is rank ``rank`` of a fake process group of
    ``world`` ranks (``torch.testing._internal.distributed.fake_pg``):
    its collectives take tensors on any device, ``meta`` ones too, and
    return without moving data. The group is destroyed on exit. Raises
    if a process group exists already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def check_world(backend: str, device: str, local_world: int):
    """Raises where ``backend`` cannot put this host's ``local_world``
    ranks on its cards (``device``); the fake backend has no cards."""
    if device != "cpu" and backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available for NCCL")
        n = torch.cuda.device_count()
        if local_world > n:
            raise ValueError(f"NCCL needs a card a rank: {local_world} ranks "
                             f"on this host, {n} card(s) (pass "
                             "--dist-backend gloo to share cards)")


def default_backend(device: str) -> str:
    return "gloo" if device == "cpu" else "nccl"


def sharing_note(backend: str, device: str, world: int) -> Optional[str]:
    """The launcher's first log line when ranks share cards, else None."""
    if device == "cpu" or backend != "gloo" or not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    return (f"{world} ranks over gloo on {n} card(s): rank r uses "
            f"cuda:(r % {n}), as asked by --dist-backend gloo")


def init_ranks(backend: str, device: str, local_rank: int, world: int,
               init_method: str, rank: Optional[int] = None,
               local_world: Optional[int] = None) -> torch.device:
    """Joins the process group as ``rank`` (``local_rank`` unless given)
    of ``world``, ``local_world`` of them on this host (all unless
    given), and returns the device of ``local_rank`` (``rank_device``);
    a CUDA rank's device becomes the current one."""
    import torch.distributed as dist
    check_world(backend, device,
                world if local_world is None else local_world)
    dev = rank_device(backend, device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            rank=local_rank if rank is None else rank,
                            world_size=world, **kw)
    return dev


def env_rank() -> Optional[Tuple[int, int, int, int]]:
    """(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) of a ``torchrun``
    launch, else None. Without the local variables every rank is on this
    host."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return (rank, world, int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def spawn(fn: Callable, world: int, args: Sequence = ()):
    """Runs ``fn(rank, *args)`` in ``world`` new processes (the ``spawn``
    start method) and joins them; raises if one fails."""
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=tuple(args), nprocs=world, join=True,
                       start_method="spawn")


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` over the current process group: ``prod(shape)``
    ranks, row-major, with axis names ``axes``, on the cards under NCCL
    and on the CPU under gloo or the fake group (``fake_world``). Raises
    unless the world size is ``prod(shape)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(launch/mesh.py::init_ranks)")
    world = dist.get_world_size()
    if prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{prod(shape)} ranks; the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh: (16, 16) over (data, model),
    or (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the current process group (256 or 512
    ranks; ``fake_world`` gives them without their ranks); raises when
    the world size differs."""
    return make_mesh(*production_shape(multi_pod))
