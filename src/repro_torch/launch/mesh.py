"""The client mesh of the shard_map engine and the device slots of the
async runtime (port of ``repro.launch.mesh``).

* ``make_client_mesh`` is the counterpart of the reference's one-axis
  ``"clients"`` mesh: a one-dimensional ``DeviceMesh`` over the ranks of
  the default ``torch.distributed`` process group, one process per device
  (NCCL on the card, gloo on the CPU).  Under ``torchrun`` the ranks join
  the group from the environment; with no group and no launcher, a
  one-rank group is made in process, as the reference's mesh over one
  device.  ``dp_axes`` and ``axis_size`` read its dimension names and
  sizes.
* ``SubmeshPool`` carves the visible devices into slots so that up to
  ``max_inflight_cohorts`` cohorts train at once, each on its own device:
  one slot per visible CUDA device (``torch.cuda.device_count()``), or the
  one CPU device.  A pool asked for more slots than there are devices has
  one per device, so on one H100 a pool has one slot and later cohorts
  wait in the runtime's launch queue, as the reference's do on one device.
  ``RankPool`` is the shard_map engine's: one width-1 slot per rank of its
  mesh.
* ``make_production_mesh`` / ``make_host_mesh`` / ``make_mesh_override``
  are the sharded-model meshes: a ``DeviceMesh`` named ``("data",
  "model")``, or ``("pod", "data", "model")``, over every rank of the
  default group (row-major: rank ``d * model + m``, as the reference's
  ``jax.make_mesh``).  ``MeshShape`` carries only a mesh's names and
  sizes, which is all the sharding rules (``launch.sharding``) and the
  dry run's reckoning read.
"""

from __future__ import annotations

import atexit
import dataclasses
import math
import os
import shutil
import tempfile
import threading
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

CLIENT_AXIS = "clients"        # the mesh's one dimension
MESH_AXES = ("data", "model")                   # the sharded-model mesh
MULTI_POD_AXES = ("pod", "data", "model")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
FAKE_BACKEND = "fake"          # the dry run's in-process group of N ranks
# how long a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def _init_default_group(device_type: str) -> None:
    """Join the ranks ``torchrun`` started (``RANK`` / ``WORLD_SIZE`` in the
    environment; each on ``cuda:LOCAL_RANK``), or make a one-rank group
    from a ``FileStore`` in a temporary directory.  Either way the group is
    destroyed at exit (before its store is removed), unless the caller
    destroyed it first."""
    backend = BACKENDS[device_type]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device_type == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend, timeout=COLLECTIVE_TIMEOUT)
    else:
        tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        atexit.register(shutil.rmtree, tmp, True)
        dist.init_process_group(backend,
                                store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, timeout=COLLECTIVE_TIMEOUT)
    atexit.register(_destroy_group)      # runs before the rmtree above


def _destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_client_mesh(devices: int = 0, device_type: str = "cuda") -> DeviceMesh:
    """One-dimensional ``DeviceMesh`` named ``("clients",)`` over every rank
    of the default process group, which is initialised here when it is not
    (see ``_init_default_group``).

    ``devices=0`` takes every rank.  More devices than ranks raises
    ``ValueError``; so does a count between 0 and the world size, where the
    reference would mesh the first ``devices`` devices (a rank outside the
    mesh would have nothing to run).  A CUDA mesh needs an NCCL group and a
    CPU one a gloo group: a collective never falls back to another
    backend."""
    if device_type not in BACKENDS:
        raise ValueError(f"unsupported device type {device_type!r}; expected cuda or cpu")
    if not dist.is_initialized():
        _init_default_group(device_type)
    world = dist.get_world_size()
    n = world if devices in (0, None) else int(devices)
    if n > world:
        raise ValueError(
            f"requested {devices} mesh devices but the process group has {world} "
            f"rank(s); start one process per device, e.g. torchrun "
            f"--nproc-per-node {n} -m repro_torch.launch.fedtrain ... "
            f"--engine shard_map --sim-devices {n}")
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices over a group of {world} ranks: the client mesh "
            "spans every rank (sim_devices 0 or the world size)")
    backend = dist.get_backend()
    if BACKENDS[device_type] not in backend:
        raise ValueError(f"a {device_type} client mesh needs a "
                         f"{BACKENDS[device_type]} process group, the default "
                         f"group's backend is {backend!r}")
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(CLIENT_AXIS,))


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dimension names and sizes, without devices or a process
    group: what ``dp_axes``, ``axis_size`` and the sharding rules read, with
    ``DeviceMesh``'s ``mesh_dim_names`` / ``size(dim)`` / ``shape``."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...] = MESH_AXES

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} for axes {self.mesh_dim_names}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: int | None = None) -> int:
        return math.prod(self.shape) if mesh_dim is None else self.shape[mesh_dim]


def _sharded_mesh(dims: tuple[int, ...], names: tuple[str, ...],
                  device_type: str) -> DeviceMesh:
    """A ``DeviceMesh`` of ``dims`` named ``names`` over every rank of the
    default group (initialised here when it is not, as ``make_client_mesh``
    does).  The group's backend is the device's (NCCL, gloo) or the dry
    run's ``"fake"``; its world size must be the product of ``dims``."""
    if device_type not in BACKENDS:
        raise ValueError(f"unsupported device type {device_type!r}; expected cuda or cpu")
    if not dist.is_initialized():
        _init_default_group(device_type)
    n, world = math.prod(dims), dist.get_world_size()
    shape = "x".join(map(str, dims))
    if n != world:
        raise ValueError(
            f"a {shape} mesh needs {n} ranks but the process group has {world}; start "
            f"one process per device, e.g. torchrun --nproc-per-node {n} ...")
    backend = dist.get_backend()
    if BACKENDS[device_type] not in backend and backend != FAKE_BACKEND:
        raise ValueError(f"a {device_type} mesh needs a {BACKENDS[device_type]} process "
                         f"group, the default group's backend is {backend!r}")
    return DeviceMesh(device_type, torch.arange(n).reshape(dims), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh: 16 x 16 ``("data", "model")``, or
    2 x 16 x 16 ``("pod", "data", "model")`` (256 / 512 ranks)."""
    if multi_pod:
        return _sharded_mesh((2, 16, 16), MULTI_POD_AXES, device_type)
    return _sharded_mesh((16, 16), MESH_AXES, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A small ``("data", "model")`` mesh over the group's ranks (tests,
    local runs; ``(1, 1)`` over a one-rank group on one card)."""
    return _sharded_mesh((data, model), MESH_AXES, device_type)


def mesh_override_shape(shape_str: str) -> MeshShape:
    """``"32,8"`` -> 32 x 8 ``("data", "model")``; ``"2,16,16"`` adds
    ``"pod"`` in front."""
    dims = tuple(int(x) for x in shape_str.split(","))
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"mesh {shape_str!r}: one to three positive sizes, e.g. 32,8")
    return MeshShape(dims, MULTI_POD_AXES[-len(dims):])


def make_mesh_override(shape_str: str, device_type: str = "cuda") -> DeviceMesh:
    """The dry run's ``--mesh``: ``mesh_override_shape``'s mesh over the
    group's ranks."""
    m = mesh_override_shape(shape_str)
    return _sharded_mesh(m.shape, m.mesh_dim_names, device_type)


def dp_axes(mesh: DeviceMesh | MeshShape) -> tuple[str, ...]:
    """The data-parallel axes (FL-client axes): ("pod", "data") when present."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh: DeviceMesh | MeshShape, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return 1
    return mesh.size(names.index(name))


def dp_size(mesh: DeviceMesh | MeshShape) -> int:
    """The number of data-parallel ranks: the product of the DP axes' sizes."""
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


def visible_devices(device_type: str = "cuda") -> tuple[torch.device, ...]:
    """The devices a pool may use: every visible CUDA device, or the CPU."""
    if device_type == "cpu":
        return (torch.device("cpu"),)
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


@dataclasses.dataclass(frozen=True)
class Submesh:
    """One slot of a pool: its index, its devices and, for a ``RankPool``
    slot, the mesh rank that trains its cohorts."""

    index: int
    devices: tuple
    ranks: tuple = ()

    @property
    def width(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device a width-1 slot's cohort runs on."""
        return self.devices[0]


class _SlotPool:
    """Exclusive leases over ``self.submeshes``:

    * exclusive lease: an acquired slot cannot be acquired again until
      released, and releasing a free or foreign slot raises;
    * bounded: ``acquire`` on an exhausted pool returns ``None`` (the
      caller queues)."""

    submeshes: tuple[Submesh, ...]

    def _init_slots(self) -> None:
        self._free: list[int] = list(range(len(self.submeshes) - 1, -1, -1))  # pop -> index 0 first
        self._lock = threading.Lock()

    @property
    def num_submeshes(self) -> int:
        return len(self.submeshes)

    @property
    def width(self) -> int:
        return self.submeshes[0].width

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def acquire(self) -> Submesh | None:
        """Lowest-index free slot, or ``None`` when exhausted."""
        with self._lock:
            if not self._free:
                return None
            return self.submeshes[self._free.pop()]

    def release(self, sub: Submesh) -> None:
        with self._lock:
            if not (0 <= sub.index < len(self.submeshes)
                    and self.submeshes[sub.index] == sub):
                raise ValueError(f"submesh {sub.index} is not from this pool")
            if sub.index in self._free:
                raise ValueError(f"submesh {sub.index} released twice")
            self._free.append(sub.index)
            self._free.sort(reverse=True)   # keep index-0-first acquire order


class SubmeshPool(_SlotPool):
    """Disjoint-slot allocator over ``visible_devices(device_type)``: the
    slots partition a prefix of the device list (no device in two slots),
    leased as ``_SlotPool`` says.

    ``devices`` (0 = all) caps the devices used; every slot has ``width``
    devices (``total // num_submeshes`` by default)."""

    def __init__(self, num_submeshes: int, devices: int = 0,
                 width: int | None = None, *, device_type: str = "cuda"):
        avail = visible_devices(device_type)
        n = len(avail) if devices in (0, None) else int(devices)
        if n < 1 or n > len(avail):
            raise ValueError(f"requested {devices} devices but only {len(avail)} "
                             f"{device_type} devices are visible")
        devs = avail[:n]
        if num_submeshes < 1:
            raise ValueError(f"num_submeshes must be >= 1, got {num_submeshes}")
        num = min(num_submeshes, len(devs))
        w = (len(devs) // num) if width is None else int(width)
        if w < 1 or num * w > len(devs):
            raise ValueError(
                f"cannot cut {num} submeshes of width {w} from {len(devs)} devices")
        self.submeshes: tuple[Submesh, ...] = tuple(
            Submesh(index=i, devices=devs[i * w: (i + 1) * w]) for i in range(num))
        seen: set = set()
        for sm in self.submeshes:
            for d in sm.devices:
                assert d not in seen, f"device {d} in two submeshes"
                seen.add(d)
        self._init_slots()


class RankPool(_SlotPool):
    """The shard_map engine's slots: one width-1 slot per rank of its client
    mesh, at most ``num_submeshes``.  A slot's cohort trains on its rank and
    is broadcast from there, so on every rank its result lands on
    ``device``, the rank's own device (each slot's ``devices``)."""

    def __init__(self, num_submeshes: int, mesh: DeviceMesh, device: torch.device):
        if num_submeshes < 1:
            raise ValueError(f"num_submeshes must be >= 1, got {num_submeshes}")
        num = min(num_submeshes, mesh.size())
        self.submeshes = tuple(Submesh(index=i, devices=(device,), ranks=(i,))
                               for i in range(num))
        self._init_slots()
