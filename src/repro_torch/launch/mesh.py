"""Device slots for the async runtime's concurrent cohorts (port of
``repro.launch.mesh``'s ``Submesh`` / ``SubmeshPool``).

The reference carves its JAX devices into disjoint submeshes so that up to
``max_inflight_cohorts`` cohorts train at once, each on its own devices.
The port's counterpart is a pool of torch devices: one slot per visible
CUDA device (``torch.cuda.device_count()``), or the one CPU device.  A pool
asked for more slots than there are devices has one per device, so on one
H100 a pool has one slot and later cohorts wait in the runtime's launch
queue, as the reference's do on one device.  The mesh builders of the
shard_map engine are not ported (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import threading

import torch


def visible_devices(device_type: str = "cuda") -> tuple[torch.device, ...]:
    """The devices a pool may use: every visible CUDA device, or the CPU."""
    if device_type == "cpu":
        return (torch.device("cpu"),)
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


@dataclasses.dataclass(frozen=True)
class Submesh:
    """One slot of a ``SubmeshPool``: its index and its devices."""

    index: int
    devices: tuple

    @property
    def width(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device a width-1 slot's cohort runs on."""
        return self.devices[0]


class SubmeshPool:
    """Disjoint-slot allocator over ``visible_devices(device_type)``.

    * no overlap: the slots partition a prefix of the device list;
    * exclusive lease: an acquired slot cannot be acquired again until
      released, and releasing a free or foreign slot raises;
    * bounded: ``acquire`` on an exhausted pool returns ``None`` (the
      caller queues).

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
        self._free: list[int] = list(range(num - 1, -1, -1))  # pop -> index 0 first
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
                    and self.submeshes[sub.index].devices == sub.devices):
                raise ValueError(f"submesh {sub.index} is not from this pool")
            if sub.index in self._free:
                raise ValueError(f"submesh {sub.index} released twice")
            self._free.append(sub.index)
            self._free.sort(reverse=True)   # keep index-0-first acquire order
