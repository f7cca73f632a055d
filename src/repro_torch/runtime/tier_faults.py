"""Seeded, deterministic faulty-TIER compute model.

``runtime/faults.py`` makes the *wire* unreliable; this module does the
same for the compute tiers themselves (phone NPU, edge box, core
server).  A ``FaultyTier`` sits between the chain runtime's schedule and
a tier's stage execution and can

* **crash** -- the stage dies.  Either probabilistically per execution
  (``crash_rate``) or deterministically inside configured virtual-time
  ``crash_windows`` (a tier that is down is down for *everyone* whose
  stage overlaps the window -- restarts are just the window ending).
* **straggle** -- the stage completes but takes ``slow_factor`` x its
  modelled compute time (probability ``slow_rate`` per execution).
  Stragglers are not failures: they never trip circuit breakers, they
  just stretch the pipeline schedule.
* **shed** -- memory-pressure admission control: a stage whose activation
  footprint exceeds the tier's *current* memory budget is rejected
  before it runs.  The budget is time-varying (``mem_profile``,
  piecewise-constant over virtual time) so "the edge box is busy between
  t=2 and t=5" is expressible without randomness.

Everything draws from one seeded generator in call order (one uniform
vector per execution, size-invariant), so a chaos schedule is
bit-reproducible from a seed and an execution sequence -- exactly the
contract ``FaultyLink`` established for links.

Env surface mirrors the link stack: ``REPRO_TIER_*`` knobs configure
every tier of a chain, ``REPRO_TIER{k}_*`` overrides one tier (k =
0-based tier id), and ``tier_faults_from_env`` builds the per-tier
models with tier k seeded from ``seed + k``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.runtime.faults import VirtualClock, parse_outages

ENV_TIER_PREFIX = "REPRO_TIER_"


class TierError(RuntimeError):
    """One failed stage execution; ``elapsed_s`` is the virtual time the
    tier consumed before the failure surfaced."""

    def __init__(self, msg: str, elapsed_s: float):
        super().__init__(msg)
        self.elapsed_s = elapsed_s


class TierCrash(TierError):
    """The tier died mid-stage (random crash or crash window)."""


class TierShed(TierError):
    """Stage rejected: activation footprint exceeds the tier's current
    memory budget (admission control, never mid-flight)."""


@dataclasses.dataclass(frozen=True)
class TierFaultSpec:
    """Injectable tier-fault rates, crash windows, and memory pressure.

    crash_rate: per-execution crash probability.
    crash_windows: ``((start, end), ...)`` virtual-time windows during
      which every overlapping stage execution dies.
    slow_rate / slow_factor: straggler probability and the compute-time
      multiplier applied when one fires (factor 1 = no-op).
    mem_budget: admission budget in bytes (0 = unlimited) -- a stage
      whose activation footprint exceeds it is shed.
    mem_profile: piecewise-constant ``((start_s, budget_bytes), ...)``
      overriding ``mem_budget`` from each start time onward (0 entries
      mean unlimited from then on)."""

    crash_rate: float = 0.0
    crash_windows: tuple[tuple[float, float], ...] = ()
    slow_rate: float = 0.0
    slow_factor: float = 1.0
    mem_budget: float = 0.0
    mem_profile: tuple[tuple[float, float], ...] = ()

    def __post_init__(self):
        for field in ("crash_rate", "slow_rate"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field} must be in [0, 1], got {v}")
        if self.slow_factor < 1.0:
            raise ValueError(
                f"slow_factor must be >= 1, got {self.slow_factor}")
        if self.mem_budget < 0:
            raise ValueError(
                f"mem_budget must be >= 0, got {self.mem_budget}")
        for start, end in self.crash_windows:
            if end <= start:
                raise ValueError(
                    f"crash window ({start}, {end}) is empty")

    @property
    def fault_free(self) -> bool:
        return (self.crash_rate == 0.0 and not self.crash_windows
                and self.slow_rate == 0.0 and self.mem_budget == 0.0
                and not self.mem_profile)


class FaultyTier:
    """One tier's compute health model on the shared virtual clock.

    The runtime asks it to *vet and price* each stage execution:
    ``execute(t_start, compute_s, mem_bytes)`` returns the actual compute
    seconds (possibly stretched by a straggler fault) or raises
    ``TierCrash`` / ``TierShed``.  The tier never touches the clock --
    the caller owns scheduling (resource free-times, ``advance_to``)."""

    def __init__(self, name: str = "tier", *,
                 faults: TierFaultSpec = TierFaultSpec(), seed: int = 0,
                 clock: VirtualClock | None = None):
        self.name = name
        self.faults = faults
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._clock = clock if clock is not None else VirtualClock()
        # counters (the chaos harness reads these)
        self.executions = 0
        self.completed = 0
        self.crashes = 0
        self.window_hits = 0
        self.sheds = 0
        self.slowdowns = 0
        self.compute_s = 0.0        # virtual compute seconds delivered

    def in_crash_window(self, t: float) -> bool:
        return any(start <= t < end
                   for start, end in self.faults.crash_windows)

    def crash_overlaps(self, t0: float, t1: float) -> bool:
        """True when [t0, t1) intersects any crash window: a stage in
        flight when the tier dies dies with it."""
        return any(start < t1 and t0 < end
                   for start, end in self.faults.crash_windows)

    def budget_at(self, t: float) -> float:
        """Effective admission budget (bytes) at virtual time ``t``;
        0 = unlimited."""
        budget = self.faults.mem_budget
        for start, b in sorted(self.faults.mem_profile):
            if t >= start:
                budget = b
        return budget

    def execute(self, t_start: float, compute_s: float,
                mem_bytes: float = 0.0) -> float:
        """Vet one stage execution starting at ``t_start`` that would
        take ``compute_s`` seconds and hold ``mem_bytes`` of activations.

        Returns the actual compute seconds (>= ``compute_s`` when a
        straggler fault fires); raises ``TierShed`` (before any time is
        spent) or ``TierCrash`` (``elapsed_s`` = the partial compute the
        crash wasted).  Draws every fault category each call so the
        schedule is invariant to payload sizes and outcomes."""
        if compute_s < 0:
            raise ValueError(f"compute_s must be >= 0, got {compute_s}")
        self.executions += 1
        t_start = float(t_start)
        u_crash, u_slow, u_frac = self._rng.uniform(size=3)
        budget = self.budget_at(t_start)
        if budget > 0 and mem_bytes > budget:
            self.sheds += 1
            raise TierShed(
                f"{self.name}: stage needs {mem_bytes:.0f}B > budget "
                f"{budget:.0f}B at t={t_start:.3f}s", 0.0)
        dt = float(compute_s)
        slowed = u_slow < self.faults.slow_rate \
            and self.faults.slow_factor > 1.0
        if slowed:
            dt *= self.faults.slow_factor
        if self.crash_overlaps(t_start, t_start + dt):
            self.window_hits += 1
            self.crashes += 1
            # the crash lands where the window first intersects the stage
            hit = min((max(start, t_start)
                       for start, end in self.faults.crash_windows
                       if start < t_start + dt and t_start < end),
                      default=t_start)
            raise TierCrash(
                f"{self.name}: crash window hit at t={hit:.3f}s",
                hit - t_start)
        if u_crash < self.faults.crash_rate:
            self.crashes += 1
            wasted = u_frac * dt
            raise TierCrash(
                f"{self.name}: crashed {wasted:.3f}s into a "
                f"{dt:.3f}s stage at t={t_start:.3f}s", wasted)
        if slowed:
            self.slowdowns += 1
        self.completed += 1
        self.compute_s += dt
        return dt

    def counters(self) -> dict[str, int | float]:
        return {"executions": self.executions, "completed": self.completed,
                "crashes": self.crashes, "window_hits": self.window_hits,
                "sheds": self.sheds, "slowdowns": self.slowdowns,
                "compute_s": self.compute_s}


def _tier_env_raw(name: str, tier: int | None = None) -> str | None:
    """Env lookup with per-tier override: ``REPRO_TIER{tier}_X`` wins
    over the chain-wide ``REPRO_TIER_X``."""
    if tier is not None:
        raw = os.environ.get(f"REPRO_TIER{tier}_{name}")
        if raw is not None:
            return raw
    return os.environ.get(ENV_TIER_PREFIX + name)


def _tier_env_float(name: str, default: float,
                    tier: int | None = None) -> float:
    raw = _tier_env_raw(name, tier)
    return default if raw is None else float(raw)


def parse_mem_profile(raw: str) -> tuple[tuple[float, float], ...]:
    """Parse ``"start:budget[,start:budget...]"`` (seconds : bytes)."""
    return parse_outages(raw)


def tier_from_env(name: str, *, tier: int | None = None,
                  seed: int | None = None,
                  faults: TierFaultSpec | None = None,
                  clock: VirtualClock | None = None) -> FaultyTier:
    """Build a ``FaultyTier`` from ``REPRO_TIER_*`` env knobs.

    REPRO_TIER_CRASH          crash probability per stage      (default 0)
    REPRO_TIER_CRASH_WINDOWS  "start:end[,start:end]" dead windows
    REPRO_TIER_SLOW           straggler probability per stage  (default 0)
    REPRO_TIER_SLOW_FACTOR    compute multiplier when one fires (default 4)
    REPRO_TIER_MEM_BUDGET     admission budget, bytes (0 = unlimited)
    REPRO_TIER_MEM_PROFILE    "start:budget[,...]" time-varying budget
    REPRO_TIER_SEED           fault-schedule seed (default 0)

    With ``tier`` given, ``REPRO_TIER{tier}_X`` (e.g.
    ``REPRO_TIER1_CRASH_WINDOWS``) overrides the chain-wide knob for that
    tier only -- how the chaos harness kills one specific box.  Explicit
    ``faults``/``seed`` arguments win over the environment."""
    if faults is None:
        faults = TierFaultSpec(
            crash_rate=_tier_env_float("CRASH", 0.0, tier),
            crash_windows=parse_outages(
                _tier_env_raw("CRASH_WINDOWS", tier) or ""),
            slow_rate=_tier_env_float("SLOW", 0.0, tier),
            slow_factor=_tier_env_float("SLOW_FACTOR", 4.0, tier),
            mem_budget=_tier_env_float("MEM_BUDGET", 0.0, tier),
            mem_profile=parse_mem_profile(
                _tier_env_raw("MEM_PROFILE", tier) or ""),
        )
    if seed is None:
        seed = int(_tier_env_float("SEED", 0, tier))
    return FaultyTier(name, faults=faults, seed=seed, clock=clock)


def tier_faults_from_env(names, *, seed: int | None = None,
                         clock: VirtualClock | None = None
                         ) -> list[FaultyTier]:
    """One env-configured ``FaultyTier`` per chain tier, shared clock.

    names: per-tier display names (e.g. the chain's tier names).
    seed: base fault-schedule seed; tier k draws from ``seed + k`` so
      the tiers' fault streams are independent (``REPRO_TIER{k}_SEED``
      overrides per tier, ``REPRO_TIER_SEED`` overrides the base)."""
    clock = clock if clock is not None else VirtualClock()
    tiers = []
    for k, name in enumerate(names):
        if os.environ.get(f"REPRO_TIER{k}_SEED") is not None:
            tier_seed = None     # per-tier env knob wins verbatim
        else:
            env_base = os.environ.get(ENV_TIER_PREFIX + "SEED")
            base = int(env_base) if env_base is not None else \
                (int(seed) if seed is not None else 0)
            tier_seed = base + k
        tiers.append(tier_from_env(name, tier=k, seed=tier_seed,
                                   clock=clock))
    return tiers
