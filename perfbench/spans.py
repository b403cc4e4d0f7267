"""The program's own ranges in a window's trace: the ``fl.*`` labels the
port's round loop opens with ``torch.profiler.record_function``, and the
device and idle time they account for.

A range is matched by its label on any host thread.  Device time counts
under a label when the runtime or driver call that launched it
(``launched_by``) started inside a range of that label, whenever the device
ran it: a kernel queued in a range and run after it closed still counts
there.  The launching call is matched by time on any thread, since the
autograd engine launches a CUDA backward from its own device thread while
the thread that opened the range waits inside it.  Every reader returns
``None`` where the trace has no range of its label (a program without the
labels) or no launch call.

``Trace`` keeps no correlation id, so a device activity is matched to its
launch call by order, kind by kind: set-up ends in a synchronisation, so
every call made inside the window has its activity in it, and the window's
last activities pair with its last calls.  On the port's one stream the
activities run in the order their calls were made.  cuDNN runs some of a
convolution's kernels out of that order; the pairing then lands a few dozen
launches off, inside the same phase, so it moves no time from one range to
another: on an H100 both ResNet-18 cells read every range's device time the
same to the nanosecond as by correlation id, and the nlp cells pair every
activity as correlation ids do.
"""

from __future__ import annotations

import bisect
import re

from perfbench.tracing import Trace

# the CUDA runtime and driver calls that put an activity of each device kind
# on a stream
LAUNCH_CALLS = {"kernel": re.compile(r"^cu(da)?Launch(Cooperative)?Kernel"),
                "gpu_memcpy": re.compile(r"^cu(da)?Memcpy"),
                "gpu_memset": re.compile(r"^cu(da)?Memset")}


def _union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def _length_s(intervals) -> float:
    return sum(t - s for s, t in _union(intervals)) * 1e-9


def _inside(point: int, union: list[tuple[int, int]], starts: list[int]) -> bool:
    i = bisect.bisect_right(starts, point) - 1
    return i >= 0 and point < union[i][1]


def spans(trace: Trace, label: str) -> list[tuple[int, int]]:
    """Every range named ``label``, on any thread, clipped to the window,
    as sorted ``(start, end)`` in ns."""
    lo, hi = trace.window
    return sorted((max(s, lo), min(t, hi)) for ops in trace.host.values()
                  for s, t, name in ops if name == label and t > lo and s < hi)


def launched_by(trace: Trace) -> list[tuple[int, int] | None]:
    """Per device activity of ``trace.device``, the ``(thread, start)`` of
    the call that launched it, or ``None`` where no call inside the window
    is left for it (an activity launched before the window opened)."""
    lo, hi = trace.window
    calls: dict[str, list[tuple[int, int]]] = {kind: [] for kind in LAUNCH_CALLS}
    for thread, ops in trace.host.items():
        for s, _, name in ops:
            if lo <= s < hi:
                for kind, pattern in LAUNCH_CALLS.items():
                    if pattern.match(name):
                        calls[kind].append((s, thread))
                        break
    links: list[tuple[int, int] | None] = [None] * len(trace.device)
    for kind, made in calls.items():
        made.sort()
        ran = [i for i, (_, _, k, _) in enumerate(trace.device) if k == kind]
        for i, (s, thread) in zip(reversed(ran), reversed(made)):
            links[i] = (thread, s)
    return links


def host_seconds(trace: Trace, label: str) -> float | None:
    """The host time inside ranges of ``label`` (their union)."""
    found = spans(trace, label)
    return _length_s(found) if found else None


def device_seconds(trace: Trace, label: str) -> float | None:
    """The union of the device intervals launched by a call that started
    inside a range of ``label``."""
    union = _union(spans(trace, label))
    if not union:
        return None
    links = launched_by(trace)
    if all(link is None for link in links):
        return None
    starts = [s for s, _ in union]
    return _length_s((s, t) for (s, t, _, _), link in zip(trace.device, links)
                     if link is not None and _inside(link[1], union, starts))


def idle_seconds_outside(trace: Trace, label: str) -> float | None:
    """The device's idle time in the window whose gap middle lies outside
    every range of ``label`` (the middle, as ``Trace.idle_gaps`` names a
    gap)."""
    union = _union(spans(trace, label))
    if not union:
        return None
    starts = [s for s, _ in union]
    lo, hi = trace.window
    edges = [lo] + [x for iv in trace.busy_intervals() for x in iv] + [hi]
    return sum(edges[i + 1] - edges[i] for i in range(0, len(edges), 2)
               if edges[i + 1] > edges[i]
               and not _inside((edges[i] + edges[i + 1]) // 2, union, starts)) * 1e-9


def per_round_ms(seconds: float | None, run) -> float | None:
    """``seconds`` over the window's rounds, in ms."""
    if seconds is None or not run.rounds:
        return None
    return 1e3 * seconds / len(run.rounds)
