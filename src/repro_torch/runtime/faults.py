"""Seeded, deterministic flaky-link channel model.

The planner (core/smartsplit.py) chooses a split against a *nominal*
client->server link; the runtime executes against this one, which can
degrade, drop, corrupt, delay, or black out entirely.  Everything is
simulated on a **virtual clock** driven only by link activity (transfer
time, timeouts, backoff waits), so fault schedules are bit-reproducible
from a seed and a send sequence -- no real sleeps, no wall-clock in the
loop -- and a whole chaos sweep runs in milliseconds of host time.

Fault taxonomy (one uniform draw per category per send, so the fault
schedule for a given seed is independent of payload sizes and outcomes):

* **drop**     -- the payload vanishes in flight; the sender learns
                  nothing until its per-attempt timeout expires.
* **corrupt**  -- the payload arrives with a flipped byte.  The link
                  itself stays silent: detection is the transfer layer's
                  job (crc32, see runtime/transfer.py), which is exactly
                  why the checksum exists.
* **delay**    -- the transfer takes ``delay_s`` longer; if that pushes
                  it past the timeout the sender sees a timeout.
* **outage**   -- wall of silence during configured virtual-time windows;
                  every send inside one burns its full timeout.

Bandwidth/latency come from either a constant or a piecewise-constant
profile over virtual time, so sustained degradation (the EWMA estimator's
trigger) is expressible without any fault randomness at all.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

ENV_PREFIX = "REPRO_LINK_"


class VirtualClock:
    """A monotone virtual-time source shared by every hop of a chain.

    The two-tier runtime had one link and therefore one clock; an N-hop
    chain needs its hops to agree on *when* things happen (an outage
    window on hop 2 is a window in chain time, not hop-2-activity time).
    ``advance_to`` is a max -- concurrent activity on different hops can
    report out of order without ever moving time backwards."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot advance by {seconds}")
        self.now += seconds

    def advance_to(self, t: float) -> None:
        self.now = max(self.now, float(t))


class LinkError(RuntimeError):
    """One failed transfer attempt; ``elapsed_s`` is the virtual time the
    attempt consumed (the link clock has already advanced by it)."""

    def __init__(self, msg: str, elapsed_s: float):
        super().__init__(msg)
        self.elapsed_s = elapsed_s


class LinkDropped(LinkError):
    """Payload lost in flight (sender observed a timeout)."""


class LinkTimeout(LinkError):
    """Transfer could not complete within the per-attempt timeout."""


class LinkOutage(LinkError):
    """Send fell inside a configured outage window."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Injectable fault rates + outage windows (virtual-time seconds)."""

    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.0
    outages: tuple[tuple[float, float], ...] = ()

    def __post_init__(self):
        for field in ("drop_rate", "corrupt_rate", "delay_rate"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field} must be in [0, 1], got {v}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        for start, end in self.outages:
            if end <= start:
                raise ValueError(f"outage window ({start}, {end}) is empty")

    @property
    def fault_free(self) -> bool:
        return (self.drop_rate == 0.0 and self.corrupt_rate == 0.0
                and self.delay_rate == 0.0 and not self.outages)


class FaultyLink:
    """A client->server channel with seeded, injectable faults.

    bandwidth: nominal bytes/s (e.g. ``hw.link.bandwidth``).
    latency_s: fixed per-transfer propagation latency.
    faults: the ``FaultSpec`` to inject.
    seed: PRNG seed; same seed + same send sequence => same fault schedule.
    bandwidth_profile: optional piecewise-constant schedule
      ``((start_s, bytes_per_s), ...)`` overriding ``bandwidth`` from each
      start time onward -- models sustained degradation (walking out of
      Wi-Fi range) as opposed to point faults.
    """

    def __init__(self, bandwidth: float, *, latency_s: float = 0.0,
                 faults: FaultSpec = FaultSpec(), seed: int = 0,
                 bandwidth_profile: tuple[tuple[float, float], ...] = (),
                 clock: VirtualClock | None = None):
        if bandwidth <= 0:
            raise ValueError(f"bandwidth must be positive, got {bandwidth}")
        self.bandwidth = float(bandwidth)
        self.latency_s = float(latency_s)
        self.faults = faults
        self.seed = int(seed)
        self.bandwidth_profile = tuple(sorted(bandwidth_profile))
        self._rng = np.random.default_rng(self.seed)
        # virtual seconds of link activity; a chain passes one shared
        # VirtualClock to all its hops so their timelines agree
        self._clock = clock if clock is not None else VirtualClock()
        # counters (all attempts, successful or not)
        self.sends = 0
        self.delivered = 0
        self.dropped = 0
        self.timeouts = 0
        self.outage_hits = 0
        self.corrupted = 0
        self.bytes_delivered = 0
        self.bytes_lost = 0

    # -- clock ---------------------------------------------------------
    @property
    def clock(self) -> float:
        return self._clock.now

    @clock.setter
    def clock(self, value: float) -> None:
        self._clock.now = float(value)

    def advance(self, seconds: float) -> None:
        """Spend non-transfer virtual time on the clock (backoff waits)."""
        self._clock.advance(seconds)

    def bandwidth_at(self, t: float) -> float:
        """Effective bytes/s at virtual time ``t``."""
        bw = self.bandwidth
        for start, seg_bw in self.bandwidth_profile:
            if t >= start:
                bw = seg_bw
        return bw

    def in_outage(self, t: float) -> bool:
        return any(start <= t < end for start, end in self.faults.outages)

    def outage_overlaps(self, t0: float, t1: float) -> bool:
        """True when [t0, t1) intersects any outage window: a transfer in
        flight when the link blacks out dies too, not just one that
        *starts* during the window."""
        return any(start < t1 and t0 < end
                   for start, end in self.faults.outages)

    # -- transfer ------------------------------------------------------
    def send(self, data: bytes, timeout_s: float) -> tuple[bytes, float]:
        """Attempt one transfer starting now.  Returns
        ``(delivered, elapsed_s)`` and advances the clock; raises
        ``LinkDropped`` / ``LinkTimeout`` / ``LinkOutage`` on failure
        (clock advanced by the timeout either way -- a failed attempt is
        never free).  A *corrupted* delivery returns normally with a
        flipped byte: callers must checksum."""
        return self.send_at(self.clock, data, timeout_s)

    def send_at(self, t0: float, data: bytes,
                timeout_s: float) -> tuple[bytes, float]:
        """Attempt one transfer starting at virtual time ``t0``.

        The chain runtime schedules hop sends from its pipeline model, so
        a send's start time comes from the schedule (compute finish /
        link free), not from "whenever the shared clock happens to be".
        Fault draws happen in call order (deterministic per seed); the
        shared clock only ever moves forward (``advance_to``), so
        ``send()`` -- where ``t0 == clock`` -- behaves exactly as
        before."""
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.sends += 1
        n = len(data)
        t0 = float(t0)
        # Draw every category each send so the schedule is size-invariant
        # (a scaled uniform, not integers(0, n): bounded-int draws consume
        # a size-dependent amount of the stream via rejection sampling).
        u_drop, u_corrupt, u_delay, u_pos = self._rng.uniform(size=4)
        corrupt_at = min(int(u_pos * n), n - 1) if n else 0
        xfer = self.latency_s + n / self.bandwidth_at(t0)
        if u_delay < self.faults.delay_rate:
            xfer += self.faults.delay_s
        if self.outage_overlaps(t0, t0 + min(xfer, timeout_s)):
            self.outage_hits += 1
            self.bytes_lost += n
            self._clock.advance_to(t0 + timeout_s)
            raise LinkOutage(f"outage window at t={t0:.3f}s", timeout_s)
        if u_drop < self.faults.drop_rate:
            self.dropped += 1
            self.bytes_lost += n
            self._clock.advance_to(t0 + timeout_s)
            raise LinkDropped(f"payload dropped at t={t0:.3f}s", timeout_s)
        if xfer > timeout_s:
            self.timeouts += 1
            self.bytes_lost += n
            self._clock.advance_to(t0 + timeout_s)
            raise LinkTimeout(
                f"transfer needs {xfer:.3f}s > timeout {timeout_s:.3f}s",
                timeout_s)
        self._clock.advance_to(t0 + xfer)
        self.delivered += 1
        self.bytes_delivered += n
        if u_corrupt < self.faults.corrupt_rate and n:
            self.corrupted += 1
            out = bytearray(data)
            out[corrupt_at] ^= 0xFF
            return bytes(out), xfer
        return bytes(data), xfer

    def counters(self) -> dict[str, int | float]:
        return {"sends": self.sends, "delivered": self.delivered,
                "dropped": self.dropped, "timeouts": self.timeouts,
                "outage_hits": self.outage_hits,
                "corrupted": self.corrupted,
                "bytes_delivered": self.bytes_delivered,
                "bytes_lost": self.bytes_lost, "clock_s": self.clock}


def _env_raw(name: str, hop: int | None = None) -> str | None:
    """Env lookup with per-hop override: ``REPRO_LINK{hop}_X`` wins over
    the chain-wide ``REPRO_LINK_X``."""
    if hop is not None:
        raw = os.environ.get(f"REPRO_LINK{hop}_{name}")
        if raw is not None:
            return raw
    return os.environ.get(ENV_PREFIX + name)


def _env_float(name: str, default: float, hop: int | None = None) -> float:
    raw = _env_raw(name, hop)
    return default if raw is None else float(raw)


def parse_outages(raw: str) -> tuple[tuple[float, float], ...]:
    """Parse ``"start:end[,start:end...]"`` (seconds) outage windows."""
    windows = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        start, _, end = part.partition(":")
        windows.append((float(start), float(end)))
    return tuple(windows)


def link_from_env(bandwidth: float, *, seed: int | None = None,
                  faults: FaultSpec | None = None,
                  hop: int | None = None,
                  clock: VirtualClock | None = None) -> FaultyLink:
    """Build a ``FaultyLink`` from ``REPRO_LINK_*`` env knobs.

    REPRO_LINK_BW        bytes/s (default: the ``bandwidth`` argument,
                         normally the plan's nominal link)
    REPRO_LINK_LATENCY   fixed per-transfer latency, seconds (default 0)
    REPRO_LINK_DROP      drop probability per attempt      (default 0)
    REPRO_LINK_CORRUPT   corruption probability per attempt (default 0)
    REPRO_LINK_DELAY     delay-fault probability per attempt (default 0)
    REPRO_LINK_DELAY_S   extra seconds when a delay fires  (default 0.5)
    REPRO_LINK_OUTAGES   "start:end[,start:end]" virtual-time windows
    REPRO_LINK_SEED      fault-schedule seed (default 0)

    With ``hop`` given, ``REPRO_LINK{hop}_X`` (e.g. ``REPRO_LINK1_DROP``)
    overrides the chain-wide knob for that hop only -- how the chaos
    harness aims a fault at one specific link of a chain.

    Explicit ``faults``/``seed`` arguments win over the environment."""
    if faults is None:
        faults = FaultSpec(
            drop_rate=_env_float("DROP", 0.0, hop),
            corrupt_rate=_env_float("CORRUPT", 0.0, hop),
            delay_rate=_env_float("DELAY", 0.0, hop),
            delay_s=_env_float("DELAY_S", 0.5, hop),
            outages=parse_outages(_env_raw("OUTAGES", hop) or ""),
        )
    if seed is None:
        seed = int(_env_float("SEED", 0, hop))
    return FaultyLink(_env_float("BW", bandwidth, hop),
                      latency_s=_env_float("LATENCY", 0.0, hop),
                      faults=faults, seed=seed, clock=clock)


def chain_links_from_env(bandwidths, *, seed: int | None = None,
                         clock: VirtualClock | None = None
                         ) -> list[FaultyLink]:
    """One env-configured ``FaultyLink`` per hop, all on a shared clock.

    bandwidths: nominal bytes/s per hop (e.g. from the plan's links).
    seed: base fault-schedule seed; hop k draws from ``seed + k`` so the
      hops' fault streams are independent (REPRO_LINK{k}_SEED overrides
      per hop, REPRO_LINK_SEED overrides the base)."""
    clock = clock if clock is not None else VirtualClock()
    links = []
    for k, bw in enumerate(bandwidths):
        if os.environ.get(f"REPRO_LINK{k}_SEED") is not None:
            hop_seed = None      # per-hop env knob wins verbatim
        else:
            env_base = os.environ.get(ENV_PREFIX + "SEED")
            base = int(env_base) if env_base is not None else \
                (int(seed) if seed is not None else 0)
            hop_seed = base + k
        links.append(link_from_env(bw, seed=hop_seed, hop=k, clock=clock))
    return links

