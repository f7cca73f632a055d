"""Per-tier circuit breakers on the virtual clock.

A breaker sits in front of a tier and gates stage dispatch so the
runtime stops burning compute (and pipeline slots) against a box it
already knows is down:

* **closed** -- dispatch flows; consecutive failures count up.
* **open** -- after ``failure_threshold`` consecutive failures the
  breaker trips: ``allow()`` rejects every dispatch until
  ``cooldown_s`` of virtual time has passed.  An open breaker is the
  standby-failover trigger (``runtime.ChainRuntime``) and feeds the
  proactive re-pick path next to the EWMA link estimators.
* **half-open** -- after the cooldown one probe execution is admitted:
  success closes the breaker (the tier restarted), failure re-opens it
  and restarts the cooldown.

State transitions are driven purely by the caller's virtual timestamps
-- no wall clock, no threads -- so breaker schedules are as reproducible
as the fault schedules that trip them.  Transitions land in the shared
``EventLog`` (``breaker_open`` / ``breaker_half_open`` /
``breaker_close``) when one is attached.
"""
from __future__ import annotations

from repro_torch.runtime import events as ev
from repro_torch.runtime.events import EventLog

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Closed -> open on consecutive failures -> half-open probe."""

    def __init__(self, name: str = "tier", *,
                 failure_threshold: int = 3, cooldown_s: float = 1.0,
                 log: EventLog | None = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if cooldown_s <= 0:
            raise ValueError(
                f"cooldown_s must be positive, got {cooldown_s}")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.log = log
        self.state = CLOSED
        self.failures = 0            # consecutive
        self.opened_at = 0.0
        # counters
        self.n_opens = 0
        self.n_probes = 0
        self.n_closes = 0
        self.n_rejected = 0

    def _emit(self, kind: str, t: float, **detail) -> None:
        if self.log is not None:
            self.log.emit(kind, t, breaker=self.name, **detail)

    def allow(self, t: float) -> bool:
        """May a stage dispatch to this tier at virtual time ``t``?
        Open breakers reject until the cooldown elapses, then admit one
        half-open probe (and keep admitting until its verdict arrives:
        recording the probe's outcome is what resolves the state)."""
        if self.state == CLOSED or self.state == HALF_OPEN:
            return True
        if t >= self.opened_at + self.cooldown_s:
            self.state = HALF_OPEN
            self.n_probes += 1
            self._emit(ev.BREAKER_HALF_OPEN, t, failures=self.failures)
            return True
        self.n_rejected += 1
        return False

    def record_success(self, t: float) -> None:
        """A stage completed on the tier: reset the failure streak and
        close a half-open breaker (the probe succeeded)."""
        self.failures = 0
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self.n_closes += 1
            self._emit(ev.BREAKER_CLOSE, t)
        elif self.state == OPEN:        # defensive: forced execution
            self.state = CLOSED
            self.n_closes += 1
            self._emit(ev.BREAKER_CLOSE, t)

    def record_failure(self, t: float) -> bool:
        """A stage failed on the tier.  Returns True when this failure
        tripped (or re-tripped) the breaker open."""
        self.failures += 1
        if self.state == HALF_OPEN or \
                (self.state == CLOSED
                 and self.failures >= self.failure_threshold):
            self.state = OPEN
            self.opened_at = float(t)
            self.n_opens += 1
            self._emit(ev.BREAKER_OPEN, t, failures=self.failures,
                       cooldown_s=self.cooldown_s)
            return True
        return False

    def reset(self) -> None:
        """Forget all state (e.g. after the tier was failed over)."""
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0

    def counters(self) -> dict[str, int | str]:
        return {"state": self.state, "failures": self.failures,
                "opens": self.n_opens, "probes": self.n_probes,
                "closes": self.n_closes, "rejected": self.n_rejected}


def tier_breakers(names, *, failure_threshold: int = 3,
                  cooldown_s: float = 1.0,
                  log: EventLog | None = None) -> list[CircuitBreaker]:
    """One breaker per chain tier (``names`` = the tier names)."""
    return [CircuitBreaker(name, failure_threshold=failure_threshold,
                           cooldown_s=cooldown_s, log=log)
            for name in names]
