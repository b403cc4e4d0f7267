"""The benchmark's one door into the program: the port's synchronous round
loop (``repro_torch.fl.server.run_federated``), its masked-Adam kernel
counter and build, and the program's state after its first local step.

Everything else the benchmark runs (data, weights, schedule, reference,
metrics) imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

from perfbench.fedref import Readings, flatten, nest, path_key
from perfbench.traffic import Traffic


def build_kernels() -> None:
    """Build (first run in a checkout) or load the masked-Adam library."""
    from repro_torch.kernels import build
    build.load("masked_adam")


def kernel_launches() -> int:
    from repro_torch.kernels.masked_adam import MaskedAdamCohort
    return MaskedAdamCohort.launches


class Federation:
    """The port's task, clients, eval set and round-loop settings for one
    run; ``call`` runs a slice of the schedule from given global weights."""

    def __init__(self, program, cfg: dict, traffic: Traffic, clients, eval_set,
                 fl_seed: int, device: str):
        from repro_torch.data.pipeline import ClientDataset
        from repro_torch.fl.algorithms import AlgoConfig
        from repro_torch.fl.server import FLRunConfig

        self.adapter = program.make_task(cfg)
        self.clients = [ClientDataset(x, y) for x, y in clients]
        self.eval_set = eval_set
        self.run_cfg = FLRunConfig(
            local_epochs=traffic.local_epochs, batch_size=traffic.batch_size,
            lr=traffic.lr, adam_eps=traffic.adam_eps, algo=AlgoConfig(name="fedavg"),
            seed=fl_seed, eval_every=traffic.eval_every, eval_batch=traffic.eval_samples,
            engine=traffic.engine, fused_adam=traffic.fused_adam, device=device)

    def call(self, params: dict, rounds: list[tuple[int, int]]):
        """One call of the round loop over ``rounds`` (``(index, group)``);
        returns the new global weights (nested) and the round history."""
        from repro_torch.core.schedule import RoundSpec
        from repro_torch.fl.server import run_federated

        specs = [RoundSpec(i, "partial" if g >= 0 else "warmup", -1, g) for i, g in rounds]
        res = run_federated(self.adapter, self.clients, self.eval_set, specs,
                            self.run_cfg, init_params=params)
        return res.params, res.history


@contextlib.contextmanager
def first_adam_state():
    """Capture the cohort optimizer's first moment ``m`` right after its
    first launch: ``(clients, rows, 128)``, which after one step is
    ``(1 - b1)`` times the gradient the optimizer got.  The state, not the
    gradient handed to the launch, so the kernel's own update is read too.
    Used in set-up only; the window runs the class untouched."""
    from repro_torch.kernels.masked_adam import MaskedAdamCohort

    seen: dict = {}
    orig = MaskedAdamCohort.step

    def step(self, t, g):
        orig(self, t, g)
        if "m" not in seen:
            seen["m"] = self.m.detach().clone()

    MaskedAdamCohort.step = step
    try:
        yield seen
    finally:
        MaskedAdamCohort.step = orig


def _layout(paths_shapes: list[tuple[str, int]], rows: int, lanes: int) -> list[int]:
    """Each leaf's padded length in the packed buffer: leaves in sorted path
    order, each padded to a multiple of ``block_rows * lanes`` elements;
    the block size is the one that fills ``rows`` exactly."""
    for block_rows in (8, *range(1, 65)):
        unit = block_rows * lanes
        padded = [n + (-n) % unit for _, n in paths_shapes]
        if sum(padded) == rows * lanes:
            return padded
    raise ValueError(f"no block size packs these leaves into {rows} rows")


def state_grad_norms(m: torch.Tensor, b1: float, params0: dict[str, torch.Tensor],
                     train: list[str]) -> list[dict[str, float]]:
    """Per client, the norm of each trained leaf's first gradient, worked
    out from the optimizer's first moment after one step with the stated
    ``b1`` (the reference's, not the program's, so a wrong one shows)."""
    items = sorted(((k, t.numel()) for k, t in params0.items()), key=lambda kv: path_key(kv[0]))
    padded = _layout(items, m.shape[1], m.shape[2])
    flat = m.reshape(m.shape[0], -1)
    out = [dict() for _ in range(m.shape[0])]
    off = 0
    for (k, n), pn in zip(items, padded):
        if k in train:
            norms = torch.linalg.vector_norm(flat[:, off:off + n].double(), dim=1) / (1 - b1)
            for c, v in enumerate(norms.tolist()):
                out[c][k] = v
        off += pn
    return out


def program_readings(fed: Federation, params0: dict[str, torch.Tensor],
                     rounds: list[tuple[int, int]], first_train: list[str], b1: float):
    """Set-up's first call: the checked rounds through the window's own call,
    with the optimizer's state read after its first step.  Returns the
    readings and the global weights to hand on to the window."""
    with first_adam_state() as seen:
        params, history = fed.call(nest(params0), rounds)
    grads = (state_grad_norms(seen["m"], b1, params0, first_train)
             if "m" in seen else [])
    flat = flatten(params)
    losses = [float(h["loss"]) for h in history]
    if not all(math.isfinite(x) for x in losses):
        losses = [float("inf")] * len(losses)
    return Readings(losses=losses, first_grads=grads,
                    params={k: v.detach().clone() for k, v in flat.items()}), params
