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

Not ported: ``make_production_mesh`` and ``make_host_mesh``, the
XLA-sharded training meshes (ROADMAP Queue 1 item 15.5).
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
import threading
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

CLIENT_AXIS = "clients"        # the mesh's one dimension
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
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


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The data-parallel axes (FL-client axes): ("pod", "data") when present."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return 1
    return mesh.size(names.index(name))


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
