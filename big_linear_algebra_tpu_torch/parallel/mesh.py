"""Rank meshes over ``torch.distributed``, the counterpart of
``big_linear_algebra_tpu/parallel/mesh.py``.

JAX's mesh is a named grid of devices that one program drives. Here every
rank is a process that drives one device, so a mesh is a named grid of
*ranks*: ``make_mesh({"data": 2, "model": 2})`` lays the ranks of the
process group out row-major on those axes and makes one
``torch.distributed`` subgroup for every line of every axis. A rank's
collectives over an axis (``parallel/spmd.py``) run on the subgroup of its
own line.

- ``distributed_init`` joins the process group, with the single-host no-op
  of ``jax.distributed.initialize``: nothing happens unless a launcher
  (``torchrun``, or ``spawn_ranks`` below) set ``RANK``/``WORLD_SIZE``/
  ``MASTER_ADDR`` or the caller passes an ``init_method``. It is safe to
  call twice.
- Each rank has an explicit device: ``cuda:(LOCAL_RANK mod
  device_count)``, or the CPU when the caller asks for it. Without a CUDA
  device a rank asked for the card raises: it never moves to the CPU.
- The backend follows one rule, printed once by rank 0: NCCL when every
  rank of the node owns its own card, gloo when ranks share a card or run
  on the CPU. It is never switched after a failure.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# This process's device and backend, set by ``distributed_init``.
_state = {"device": None, "backend": None}


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """Ranks on this node: ``LOCAL_WORLD_SIZE`` as launchers set it, else
    the world size (one node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def local_device_count() -> int:
    """The cards this node offers its ranks (0 without CUDA). JAX's count of
    the devices one process drives; here each rank drives one of them."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def rank_device(kind: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK mod device_count)`` for
    ``kind="cuda"``, which raises without a CUDA device, or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device kind must be cuda or cpu, got {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a rank asked for the card, but no CUDA device is "
                           "available (pass --device=cpu to run on the CPU)")
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def select_backend(device: torch.device,
                   ranks_on_node: int) -> tuple[str, str]:
    """(backend, why): the one rule. NCCL when every rank of the node owns
    its own card; gloo when ranks share a card (NCCL refuses two ranks on
    one device) or run on the CPU."""
    if device.type == "cpu":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if ranks_on_node <= cards and dist.is_nccl_available():
        return "nccl", f"{ranks_on_node} ranks, one card each"
    return "gloo", (f"{ranks_on_node} ranks share {cards} card"
                    f"{'s' * (cards != 1)}")


def current_device() -> torch.device:
    """The device ``distributed_init`` gave this rank (the CPU before it)."""
    return _state["device"] or torch.device("cpu")


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def distributed_init(init_method: Optional[str] = None,
                     world: Optional[int] = None,
                     rank_id: Optional[int] = None,
                     device: str = "cuda",
                     timeout: Optional[float] = None) -> int:
    """Join the process group, with ``jax.distributed.initialize``'s
    single-host no-op: without launcher variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``) and without ``init_method`` it does
    nothing. Safe to call twice. ``device``: "cuda" or "cpu", the kind of
    this rank's device (``rank_device``). ``timeout``: seconds a collective
    may wait (default: the backend's). Returns this process's rank (0 when
    nothing was joined)."""
    if dist.is_initialized():
        return dist.get_rank()
    launched = any(v in os.environ
                   for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if init_method is None and not launched:
        return 0
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    rank_id = int(os.environ["RANK"]) if rank_id is None else rank_id
    dev = rank_device(device)
    ranks_on_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    name, why = select_backend(dev, ranks_on_node)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    extra = ({} if timeout is None
             else {"timeout": datetime.timedelta(seconds=timeout)})
    dist.init_process_group(name, init_method=init_method or "env://",
                            world_size=world, rank=rank_id, **extra)
    _state.update(device=dev, backend=name)
    if rank_id == 0:
        print(f"torch.distributed: {world} ranks, backend {name} ({why})",
              flush=True)
    return rank_id


class Mesh:
    """A named grid of ranks (JAX's ``Mesh`` of devices). ``devices`` is the
    grid of global ranks, ``shape`` maps each axis name to its size, and
    ``device`` is this rank's torch device. ``group(axis)`` is the
    subgroup of this rank's line along ``axis`` (None on a line of one rank
    or outside a process group: collectives there are the identity).
    ``whole`` is the group of every rank of the mesh (None: the whole
    process group)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 groups: Mapping[str, object], device: torch.device,
                 whole=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.device = device
        self.rank = rank()
        where = np.argwhere(devices == self.rank)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self._groups = dict(groups)
        self.whole = whole

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (JAX's ``axis_index``)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        return self.coords[axis]

    def group(self, axis: str):
        self.index(axis)
        return self._groups[axis]

    def line(self, axis: str) -> list:
        """The global ranks of this rank's line along ``axis``, in axis
        order."""
        i = self.axis_names.index(axis)
        at = [self.coords[a] for a in self.axis_names]
        at[i] = slice(None)
        return [int(r) for r in self.devices[tuple(at)]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, {self.device})"


def make_mesh(axes: Mapping[str, int],
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A named mesh, e.g. ``make_mesh({"data": 4, "model": 2})``, over the
    ranks ``devices`` (default: every rank of the group, in order). Axis
    sizes must multiply to their count. Every rank of the group must call
    it, in the same order: making the subgroups is collective. A mesh over
    fewer ranks than the group's also gets a group of its own
    (``Mesh.whole``)."""
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    if devices is None:
        devices = range(world_size())
    devices = list(devices)
    n = int(np.prod(shape))
    if n != len(devices):
        raise ValueError(
            f"mesh shape {dict(axes)} needs {n} devices, have {len(devices)}"
        )
    grid = np.asarray(devices, dtype=np.int64).reshape(shape)
    groups = {}
    for i, name in enumerate(names):
        groups[name] = None
        if shape[i] == 1 or not dist.is_initialized():
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:  # every rank makes every line's group, in order
            group = dist.new_group([int(r) for r in line])
            if rank() in line:
                groups[name] = group
    whole = (dist.new_group([int(r) for r in devices])
             if dist.is_initialized() and n < world_size() else None)
    return Mesh(grid, names, groups, current_device(), whole)


def default_mesh(data_axis: str = "data") -> Mesh:
    """Every rank of the group on one data-parallel axis."""
    return make_mesh({data_axis: world_size()})


def make_hybrid_mesh(dcn_axes: Mapping[str, int],
                     ici_axes: Mapping[str, int]) -> Mesh:
    """A mesh whose leading (DCN) axes map to nodes and whose trailing
    (ICI) axes map to the cards within a node. Launchers number ranks node
    by node, so the row-major grid of (dcn..., ici...) puts each ICI line
    on one node. On a single node the DCN axes must have size 1 (JAX's
    single-slice fallback)."""
    names = tuple(dcn_axes.keys()) + tuple(ici_axes.keys())
    if len(set(names)) != len(names):
        dup = sorted(n for n in set(names) if names.count(n) > 1)
        raise ValueError(f"axis names appear in both dcn_axes and "
                         f"ici_axes: {dup}")
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    n_dcn = int(np.prod(tuple(dcn_axes.values())))
    n_nodes = world_size() // local_world_size()
    if n_nodes > 1:
        if n_dcn != n_nodes:
            raise ValueError(f"dcn_axes {dict(dcn_axes)} need {n_dcn} nodes, "
                             f"the group spans {n_nodes}")
        return make_mesh(dict(zip(names, shape)))
    if n_dcn != 1:
        raise ValueError(
            f"dcn_axes {dict(dcn_axes)} need {n_dcn} slices but all "
            f"{world_size()} devices are in one slice")
    return make_mesh(dict(zip(names, shape)))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local: int, fn: Callable, n: int, port: int, args) -> None:
    os.environ.update(RANK=str(local), LOCAL_RANK=str(local),
                      WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    rc = fn(*args)
    if rc:
        raise SystemExit(rc)


def spawn_ranks(fn: Callable, n: int, *args) -> None:
    """Run ``fn(*args)`` in ``n`` new processes on this node, as ``torchrun
    --nproc-per-node=n`` would: each with ``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE`` and a rendezvous on a free localhost port in its
    environment (``distributed_init`` joins from them). ``fn`` must be
    importable by name. Raises when a rank fails or returns non-zero."""
    mp.spawn(_rank_entry, args=(fn, n, _free_port(), args), nprocs=n,
             join=True)
