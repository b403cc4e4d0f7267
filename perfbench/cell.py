"""One run of one cell: set-up, the measured window, the metrics, the check.

Set-up makes the clients' data, the eval set and the weights from the seed,
builds (or loads) the masked-Adam kernel, and runs the cell's first
``checked_rounds`` rounds through the window's own call: the port's
``run_federated`` with the cell's engine and settings.  Those rounds warm
every shape the window uses and are the rounds the plain reference
follows.  The window then calls the round loop on consecutive slices of the
schedule, carrying the global weights across calls, until ``seconds`` have
passed at the end of a call.  Once the window has closed and the program's
state is freed, the reference runs the checked rounds from the same
weights and data and ``compare`` decides ``correct``.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from pathlib import Path

import torch

from perfbench import compare, fedref
from perfbench.manifest import Cell, load_cell, reader
from perfbench.peaks import peaks_for
from perfbench.tracing import CALL_LABEL, WINDOW_LABEL, Trace
from perfbench.traffic import Traffic

@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    traffic: Traffic
    leaves: list
    num_groups: int
    setup_s: float
    window_s: float                     # host clock, window open to close
    rounds: list[tuple[int, int]]       # the window's rounds, (index, group)
    window_peak_bytes: int
    launches: int                       # masked-Adam launches in the window
    trace: Trace | None
    peaks: dict | None                  # the card's published peaks, if listed

    @property
    def samples(self) -> int:
        return len(self.rounds) * self.traffic.samples_per_round

    def train_flops_per_sample(self, group: int) -> float:
        """Forward and required backward of a step training ``group``."""
        trained = frozenset(range(self.num_groups)) if group < 0 else frozenset((group,))
        return self.cell.counts.step(self.cell.config, self.cell.reference, trained).total

    def eval_flops_per_sample(self) -> float:
        return self.cell.counts.step(self.cell.config, self.cell.reference, None).forward


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fp32_only() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Inputs:
    """A run's cell and everything made from its seed, handed to both sides."""

    cell: Cell
    traffic: Traffic
    leaves: list
    groups: int
    clients: list
    eval_set: tuple
    params0: dict
    fl_seed: int
    checked: list[tuple[int, int]]

    def fed_setup(self) -> fedref.FedSetup:
        t = self.traffic
        return fedref.FedSetup(clients=self.clients, batch_size=t.batch_size,
                               local_epochs=t.local_epochs, lr=t.lr, adam_eps=t.adam_eps,
                               fl_seed=self.fl_seed)

    def reference(self, device, **faults) -> fedref.Readings:
        """The plain reference over the checked rounds (``faults``: those of
        ``fedref.reference_rounds``)."""
        cfg, ref = self.cell.config, self.cell.reference
        return fedref.reference_rounds(lambda p, x, y: ref.loss(p, cfg, x, y), self.leaves,
                                       self.params0, self.checked, self.fed_setup(),
                                       torch.device(device), **faults)


def prepare(root: Path, name: str, seed: int, device: str, *,
            config_override: dict | None = None,
            traffic_override: dict | None = None) -> Inputs:
    """Load cell ``name`` and make its data, eval set and weights from
    ``seed``.  The overrides shrink a cell for a test on the CPU."""
    cell = load_cell(root, name)
    cell.config.update(config_override or {})
    cell.traffic.update(traffic_override or {})
    traffic = Traffic.from_json(cell.traffic)
    cfg, ref = cell.config, cell.reference
    leaves = ref.leaves(cfg)
    groups = ref.num_groups(cfg)
    return Inputs(cell=cell, traffic=traffic, leaves=leaves, groups=groups,
                  clients=traffic.make_clients(ref, cfg, seed),
                  eval_set=traffic.make_eval(ref, cfg, seed),
                  params0=fedref.init_params(leaves, fedref.sub_seed(seed, 4), device),
                  fl_seed=fedref.sub_seed(seed, 5),
                  checked=traffic.schedule(0, traffic.checked_rounds, groups))


def program_checked_rounds(inp: Inputs, device: str):
    """The checked rounds through the program's own call: its readings, the
    global weights after them and the federation to go on with."""
    from perfbench import system

    fed = system.Federation(inp.cell.program(), inp.cell.config, inp.traffic, inp.clients,
                            inp.eval_set, inp.fl_seed, device)
    prog, params = system.program_readings(
        fed, inp.params0, inp.checked, fedref.trained_paths(inp.leaves, inp.checked[0][1]),
        inp.fed_setup().b1)
    return prog, params, fed


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float | None = None,
             config_override: dict | None = None, traffic_override: dict | None = None,
             log=None) -> dict:
    """Run cell ``name`` once and return its result line as a dict.
    ``t0``: the process's start on the host clock (set-up counts from it).
    The overrides shrink a cell for a test on the CPU."""
    from perfbench import system

    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    fp32_only()
    if dev.type == "cuda":
        system.build_kernels()
    t_build = time.perf_counter()
    inp = prepare(root, name, seed, dev, config_override=config_override,
                  traffic_override=traffic_override)
    cell, traffic, leaves, groups, checked = (inp.cell, inp.traffic, inp.leaves, inp.groups,
                                              inp.checked)
    _sync(dev)
    t_data = time.perf_counter()
    prog, params, fed = program_checked_rounds(inp, device)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    log(f"[{name}] set-up {setup_s:.3f} s: to the kernel loaded {t_build - t0:.3f}, data "
        f"and weights {t_data - t_build:.3f}, checked rounds {checked} "
        f"{t0 + setup_s - t_data:.3f}")

    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    per_call = traffic.rounds_per_call
    nxt, rounds, calls = traffic.checked_rounds, [], []
    launches0 = system.kernel_launches()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    with torch.profiler.record_function(WINDOW_LABEL):
        t_open = time.perf_counter()
        while True:
            sched = traffic.schedule(nxt, per_call, groups)
            t_call = time.perf_counter()
            with torch.profiler.record_function(CALL_LABEL):
                params, history = fed.call(params, sched)
            calls.append((time.perf_counter() - t_call, sum(h["seconds"] for h in history),
                          torch.cuda.max_memory_allocated(dev) if cuda else 0))
            rounds += sched
            nxt += per_call
            if time.perf_counter() - t_open >= seconds:
                break
        _sync(dev)
        t_close = time.perf_counter()
    tr = None
    if prof is not None:
        t_stop = time.perf_counter()
        prof.__exit__(None, None, None)
        t_read = time.perf_counter()
        tr = Trace.from_profile(prof)
        del prof
        log(f"[{name}] profiler stop {t_read - t_stop:.1f} s, trace read "
            f"{time.perf_counter() - t_read:.1f} s, {len(tr.device)} device events")
    launches = system.kernel_launches() - launches0
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    overhead = [c - h for c, h, _ in calls]
    log(f"[{name}] window {t_close - t_open:.3f} s, {len(rounds)} rounds in {len(calls)} "
        f"calls; per-call overhead outside the rounds: "
        f"{min(overhead):.4f}-{max(overhead):.4f} s; peak bytes after each call "
        f"{[peak for _, _, peak in calls]}")

    device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    run = Run(cell=cell, traffic=traffic, leaves=leaves, num_groups=groups, setup_s=setup_s,
              window_s=t_close - t_open, rounds=rounds, window_peak_bytes=window_peak,
              launches=launches, trace=tr, peaks=peaks_for(device_name))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs
    del params, history, fed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    fp32_only()
    t_ref = time.perf_counter()
    ref_read = inp.reference(dev)
    numbers = compare.gaps(prog, ref_read, inp.params0)
    limits = compare.load_limits(root, name)
    correct = compare.verdict(numbers, limits)
    log(f"[{name}] reference {time.perf_counter() - t_ref:.3f} s; losses program "
        f"{prog.losses} reference {ref_read.losses}")

    result = {"correct": correct, "attempted": len(rounds), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": device_name,
                         "count": cell.chips if cuda else 0,
                         "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    log(f"[{name}] numbers not compared here: "
        f"{ {k: v for k, v in numbers.items() if k not in limits} }")
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k in limits:
        log(f"check {k} {numbers[k]!r} limit {limits[k]!r}")
    return result
