"""Client availability / latency model for the async runtime (numpy-only
copy of ``repro.fl.runtime.clients``, value-identical: the same streams
consumed in the same order).

Real federated deployments never see the simulator's implicit "every client
is always reachable, equally fast, and perfectly reliable" regime: devices
come and go, compute speeds span orders of magnitude, and a fraction of
dispatched work simply vanishes (Sen et al. 2025; Liu et al. 2023).
``ClientAvailability`` is the seeded, deterministic stand-in for all of that:

* **compute-speed multipliers** — one persistent log-uniform draw per client
  in ``[1/(1+spread), 1+spread]``; a client's local round takes
  ``flops / (flops_per_second * speed)`` virtual seconds.  The draw is
  *counter-based*: derived lazily per client id from
  ``SeedSequence((seed, stream, client_id))``, so no O(N) speed table is
  ever built — a population of 10^6+ virtual clients costs nothing until a
  client is actually sampled (docs/POPULATION.md);
* **latency jitter** — a fresh multiplicative draw per dispatch in
  ``[1, 1+jitter]``, modelling network variance on top of the deterministic
  cost model (``core.costs.VirtualTimeModel``);
* **dropout** — per-dispatch probability that the client trains but its
  update never reaches the server (compute burned, no bytes delivered);
* **unavailability** — per-dispatch probability a client cannot be sampled
  at all (the arrival process: offline, charging, metered network);
* **availability traces** — deterministic per-client periodic on/off
  windows (``trace="diurnal"``: duty cycle + phase hashed counter-based
  from ``SeedSequence((seed, stream, id))``, O(1) at population scale like
  ``speed()``; ``trace="file"``: a real on-disk trace tiled over the
  fleet).  A client is sampleable at virtual time ``t`` only inside its
  on-window; ``arrival_ok(client_id, t)`` is therefore time- and id-aware,
  and ``next_on_time`` tells the runtime exactly how long to wait when
  every sampled candidate is off (docs/ASYNC.md).

Everything stochastic draws from one ``numpy`` generator seeded by
``AvailabilityConfig.seed``, consumed in dispatch order, so a run is
reproducible event-for-event.  The trace is *pure* — on/off is a function
of ``(seed, client_id, t)`` and consumes no stream randomness — so layering
a trace over the i.i.d. knobs never desyncs the per-dispatch stream, and
the degenerate trace (``duty_cycle=(1.0, 1.0)``: every client always on)
is bit-identical to no trace at all.  Crucially, a **degenerate config
(all knobs 0, no trace) consumes no randomness at all** — the async
runtime's client-selection stream then advances exactly like the
synchronous server's, which is what makes the sync-equivalence guarantee
testable (docs/ASYNC.md).

This model is also the *only* source of fleet feedback the adaptive server
control loop ever sees (``runtime.control``, docs/CONTROL.md): stragglers,
drops, and staleness show up as virtual timeline events, the controller
windows those events, and its knob adjustments change only *future*
dispatches — the availability stream itself is never re-seeded or consumed
out of dispatch order, so static and adaptive runs draw identical
randomness for identical dispatch sequences.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

TRACES = ("", "diurnal", "file")


@dataclasses.dataclass(frozen=True)
class AvailabilityConfig:
    """Knobs of the client availability / latency model (all default to the
    degenerate "perfect fleet": homogeneous, instant, reliable, always on)."""

    speed_spread: float = 0.0       # persistent per-client speed heterogeneity
    latency_jitter: float = 0.0     # per-dispatch multiplicative latency noise
    dropout_prob: float = 0.0       # per-dispatch update-loss probability
    unavailable_prob: float = 0.0   # per-dispatch sampling-exclusion probability
    seed: int = 0
    # -- trace-driven availability (deterministic on/off windows) -----------
    trace: str = ""                 # "" (always on) | "diurnal" | "file"
    trace_period: float = 16.0      # virtual seconds per on/off cycle
    duty_cycle: tuple[float, float] = (1.0, 1.0)  # per-client on-fraction range
    trace_path: str = ""            # on-disk trace (required for trace="file")
    retry_wait: float = 0.5         # virtual-clock backoff when every sampled
    #                                 candidate fails its i.i.d. arrival draw

    def __post_init__(self):
        for name in ("speed_spread", "latency_jitter"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
        for name in ("dropout_prob", "unavailable_prob"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if self.trace not in TRACES:
            raise ValueError(f"unknown trace {self.trace!r}; "
                             f"expected one of {TRACES}")
        lo, hi = self.duty_cycle
        if not 0.0 < lo <= hi <= 1.0:
            raise ValueError("duty_cycle must satisfy 0 < lo <= hi <= 1, "
                             f"got {self.duty_cycle}")
        if self.trace and self.trace_period <= 0.0:
            raise ValueError(f"trace_period must be > 0, got {self.trace_period}")
        if self.trace == "file" and not self.trace_path:
            raise ValueError("trace='file' requires a trace_path")
        if self.retry_wait <= 0.0:
            raise ValueError(f"retry_wait must be > 0, got {self.retry_wait}")

    @property
    def is_degenerate(self) -> bool:
        """True when the model is the perfect fleet (sync-equivalent)."""
        return (self.speed_spread == 0.0 and self.latency_jitter == 0.0
                and self.dropout_prob == 0.0 and self.unavailable_prob == 0.0
                and self.trace == "")


# SeedSequence stream tags for the per-client persistent draws: keyed by
# (seed, tag, client_id) so speeds / trace parameters are pure functions of
# the id — identical whether the fleet has 8 clients or 10^8, and regardless
# of sampling order.
_SPEED_STREAM = 0x5BEED
_TRACE_STREAM = 0x7AACE


class ClientAvailability:
    """Seeded realisation of ``AvailabilityConfig`` for ``num_clients``.

    O(1) to construct at any population size: per-client speeds and trace
    parameters are derived lazily (counter-based hashing per id, memoised
    for sampled clients), and the per-dispatch event stream is a single
    generator consumed in dispatch order as before.  (``trace="file"``
    additionally reads its trace file once, on first use — O(trace), never
    O(population).)"""

    def __init__(self, cfg: AvailabilityConfig, num_clients: int):
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        self.cfg = cfg
        self.num_clients = num_clients
        self._speed_cache: dict[int, float] = {}
        # id -> (duty, phase, period); populated lazily per sampled client.
        self._trace_cache: dict[int, tuple[float, float, float]] = {}
        self._file_trace: tuple[float, np.ndarray, np.ndarray] | None = None
        # Per-dispatch draws come from a *separate* stream so the number of
        # clients never shifts the event randomness.
        self._rng = np.random.default_rng((cfg.seed, 0x5EED))

    def speed(self, client_id: int) -> float:
        """Persistent log-uniform multiplier in [1/(1+spread), 1+spread],
        a pure function of (seed, client_id) — no O(N) table, no draw at
        all on a homogeneous fleet (the degenerate no-RNG contract)."""
        if self.cfg.speed_spread <= 0.0:
            return 1.0
        s = self._speed_cache.get(client_id)
        if s is None:
            rng = np.random.default_rng(np.random.SeedSequence(
                (self.cfg.seed, _SPEED_STREAM, int(client_id))))
            lim = np.log1p(self.cfg.speed_spread)
            s = float(np.exp(rng.uniform(-lim, lim)))
            self._speed_cache[client_id] = s
        return s

    @property
    def speeds(self) -> np.ndarray:
        """The full speed table (diagnostics / small fleets only — this is
        the one deliberately O(N) accessor)."""
        return np.array([self.speed(i) for i in range(self.num_clients)])

    def jitter(self) -> float:
        """Multiplicative latency factor for one dispatch (1.0 when off)."""
        if self.cfg.latency_jitter <= 0.0:
            return 1.0
        return float(self._rng.uniform(1.0, 1.0 + self.cfg.latency_jitter))

    def drops(self) -> bool:
        """Whether this dispatch's update is lost in transit."""
        if self.cfg.dropout_prob <= 0.0:
            return False
        return bool(self._rng.random() < self.cfg.dropout_prob)

    # -- trace-driven on/off windows ----------------------------------------

    def _load_file_trace(self) -> tuple[float, np.ndarray, np.ndarray]:
        """Read an on-disk availability trace (once, lazily).

        Two formats: a ``.npz`` with ``duty`` / ``phase`` arrays (and an
        optional scalar ``period``), or a JSON object with the same keys.
        Client ``i`` uses entry ``i % len(duty)`` — a short real-device
        trace tiles over an arbitrarily large virtual fleet."""
        if self._file_trace is None:
            path = self.cfg.trace_path
            if path.endswith(".npz"):
                with np.load(path) as data:
                    duty = np.asarray(data["duty"], dtype=np.float64)
                    phase = np.asarray(data["phase"], dtype=np.float64)
                    period = (float(data["period"]) if "period" in data
                              else self.cfg.trace_period)
            else:
                with open(path) as f:
                    obj = json.load(f)
                duty = np.asarray(obj["duty"], dtype=np.float64)
                phase = np.asarray(obj["phase"], dtype=np.float64)
                period = float(obj.get("period", self.cfg.trace_period))
            if duty.ndim != 1 or duty.size < 1 or phase.shape != duty.shape:
                raise ValueError(
                    f"trace file {path!r} needs 1-D duty/phase arrays of "
                    f"equal nonzero length, got {duty.shape} / {phase.shape}")
            if not ((duty > 0.0) & (duty <= 1.0)).all():
                raise ValueError(
                    f"trace file {path!r} duty entries must lie in (0, 1]")
            if period <= 0.0:
                raise ValueError(
                    f"trace file {path!r} period must be > 0, got {period}")
            self._file_trace = (period, duty, np.mod(phase, 1.0))
        return self._file_trace

    def _trace_params(self, client_id: int) -> tuple[float, float, float]:
        """``(duty, phase, period)`` for one client — a pure function of
        (seed, client_id) for the diurnal trace (counter-based, like
        ``speed``), or the tiled file entry.  Memoised per sampled id."""
        p = self._trace_cache.get(client_id)
        if p is None:
            if self.cfg.trace == "file":
                period, duty, phase = self._load_file_trace()
                i = int(client_id) % duty.size
                p = (float(duty[i]), float(phase[i]), period)
            else:
                rng = np.random.default_rng(np.random.SeedSequence(
                    (self.cfg.seed, _TRACE_STREAM, int(client_id))))
                lo, hi = self.cfg.duty_cycle
                p = (float(rng.uniform(lo, hi)), float(rng.random()),
                     self.cfg.trace_period)
            self._trace_cache[client_id] = p
        return p

    def trace_on(self, client_id: int, t: float) -> bool:
        """Whether the client's trace window is *on* at virtual time ``t``
        (always True without a trace).  Pure — consumes no randomness."""
        if not self.cfg.trace:
            return True
        duty, phase, period = self._trace_params(client_id)
        if duty >= 1.0:
            return True
        return float(np.mod(t / period + phase, 1.0)) < duty

    def next_on_time(self, client_id: int, t: float) -> float:
        """Earliest virtual time >= ``t`` the client's window is on —
        ``t`` itself when already on, else the start of the next cycle.
        Deterministic: this is what the runtime books its wait/retry
        event at when every sampled candidate is off."""
        if self.trace_on(client_id, t):
            return t
        _, phase, period = self._trace_params(client_id)
        pos = float(np.mod(t / period + phase, 1.0))
        return t + (1.0 - pos) * period

    def availability_weight(self, client_id: int, t: float) -> float:
        """The client's *current* availability — the biased cohort
        sampler's selection weight: its trace window (0/1) times the
        stationary i.i.d. arrival rate.  Pure — consumes no randomness."""
        on = 1.0 if self.trace_on(client_id, t) else 0.0
        return on * (1.0 - self.cfg.unavailable_prob)

    def inclusion_prob(self, client_id: int) -> float:
        """Stationary per-client inclusion rate relative to an always-on
        client — its trace duty cycle (1.0 without a trace).  Recorded on
        each ``ClientUpdate`` under biased sampling so the merge can
        inverse-probability debias (docs/ASYNC.md); the i.i.d.
        ``unavailable_prob`` factor is shared by every client and cancels
        in the normalised average, so it is deliberately not included."""
        if not self.cfg.trace:
            return 1.0
        duty, _, _ = self._trace_params(client_id)
        return min(duty, 1.0)

    def arrival_ok(self, client_id: int | None = None, t: float = 0.0) -> bool:
        """One candidate's arrival draw at virtual time ``t``
        (population-scale sampling: the availability filter runs over
        *sampled* candidates only, never the whole fleet).  The trace
        check is pure and runs first — an off-window client is rejected
        without touching the stream — then the i.i.d. knob draws exactly
        as before, so no-trace configs replay bit-for-bit and the knob-off
        path consumes no randomness (the degenerate-config contract)."""
        if self.cfg.trace:
            if client_id is None:
                raise ValueError(
                    "trace-driven availability needs a client_id")
            if not self.trace_on(client_id, t):
                return False
        if self.cfg.unavailable_prob <= 0.0:
            return True
        return bool(self._rng.random() >= self.cfg.unavailable_prob)
