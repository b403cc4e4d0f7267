"""Reading the profiler's trace of the window (``torch.profiler``, CPU and
CUDA activity).

The window is the span of the benchmark's own ``perfbench.window`` label;
each call of the round loop inside it is labelled ``perfbench.call``.  From
the trace:

* the device's busy time: the union of every device activity's interval
  (kernels, copies, sets) inside the window, never the sum of their
  durations, which counts overlapping work twice;
* kernels by name: launches and device time;
* the idle gaps between device activities, each named by what the host
  was doing at its middle (the innermost host operation open then, on any
  thread).
"""

from __future__ import annotations

import collections
import dataclasses

WINDOW_LABEL = "perfbench.window"
CALL_LABEL = "perfbench.call"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120


def _kind(e) -> str:
    """The event's activity kind; torch builds without ``activity_type``
    (2.11) tell a device-side label by ``is_user_annotation``."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    annotation = e.is_user_annotation()
    if "cuda" in str(e.device_type()).lower():
        name = e.name()
        return ("gpu_user_annotation" if annotation else
                "gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "user_annotation" if annotation else "cpu_op"


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]                       # ns
    device: list[tuple[int, int, str, str]]       # (start, end, kind, name), sorted
    host: dict[int, list[tuple[int, int, str]]]   # thread -> (start, end, name)

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        window = None
        device, host = [], collections.defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            kind = _kind(e)
            start, end = int(e.start_ns()), int(e.end_ns())
            if kind in DEVICE_KINDS:
                device.append((start, end, kind, e.name()))
            elif kind in HOST_KINDS:
                if e.name() == WINDOW_LABEL:
                    window = (start, end)
                host[int(e.start_thread_id())].append((start, end, e.name()))
        if window is None:
            raise RuntimeError(f"the trace has no {WINDOW_LABEL!r} span")
        lo, hi = window
        device = sorted((max(s, lo), min(t, hi), k, n) for s, t, k, n in device
                        if t > lo and s < hi)
        for ops in host.values():
            ops.sort()
        return cls(window, device, dict(host))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for s, t, _, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-9

    def kernels(self, contains: str = "") -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name contains
        ``contains``."""
        sel = [t - s for s, t, k, n in self.device if k == "kernel" and contains in n]
        return len(sel), sum(sel) * 1e-9

    def top_device_ops(self, k: int = 10) -> list[list]:
        total: dict[str, int] = collections.Counter()
        for s, t, _, n in self.device:
            total[n[:NAME_CHARS]] += t - s
        return [[n, ns * 1e-9] for n, ns in total.most_common(k)]

    def _host_at(self, points: list[int]) -> list[str]:
        """The innermost host operation open at each of the sorted
        ``points``, over all threads (the latest-started one)."""
        best = [(-1, "(no host operation)")] * len(points)
        for ops in self.host.values():
            stack: list[tuple[int, int, str]] = []
            i = 0
            for j, q in enumerate(points):
                while i < len(ops) and ops[i][0] <= q:
                    while stack and stack[-1][1] <= ops[i][0]:
                        stack.pop()
                    stack.append(ops[i])
                    i += 1
                while stack and stack[-1][1] <= q:
                    stack.pop()
                if stack and stack[-1][0] > best[j][0]:
                    best[j] = (stack[-1][0], stack[-1][2])
        return [name for _, name in best]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle device time inside the window by the host operation open at
        each gap's middle, the ``k`` largest totals."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        names = self._host_at([(s + t) // 2 for s, t in gaps])
        total: dict[str, int] = collections.Counter()
        for (s, t), n in zip(gaps, names):
            total[n[:NAME_CHARS]] += t - s
        return [[n, ns * 1e-9] for n, ns in total.most_common(k)]

