"""Structured event log for the fault-tolerant split runtime.

Every recovery action -- retries, timeouts, checksum failures, backoff
waits, device fallbacks, Pareto-front re-picks, proactive re-splits -- is
recorded as an ``Event`` stamped with the link's virtual clock, so tests
can assert "no silent wrong answer" (a faulty run either matches the
fault-free logits bit-exactly or carries the recovery that explains why)
and the chaos harness can aggregate counts/bytes without parsing stdout.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any

# Canonical event kinds (the log accepts any string; these are the ones
# the runtime emits -- tests and the chaos harness key on them).
ATTEMPT = "attempt"                  # one wire attempt started
TRANSFER_OK = "transfer_ok"          # attempt delivered + checksum passed
DROP = "drop"                        # attempt failed: payload dropped
TIMEOUT = "timeout"                  # attempt failed: timeout
OUTAGE = "outage"                    # attempt failed: outage window
CHECKSUM_FAIL = "checksum_fail"      # delivered but corrupt (crc32)
BACKOFF = "backoff"                  # retry wait added to the clock
WIRE_ENCODE = "wire_encode"          # boundary re-encoded to a wire dtype
GIVE_UP = "give_up"                  # retries exhausted for one transfer
FALLBACK_DEVICE = "fallback_device"  # degraded to full on-device run
STAGE_MERGE = "stage_merge"          # collapsed a cut onto the upstream tier
REPICK = "repick"                    # re-picked split from Pareto front
PROACTIVE_RESPLIT = "proactive_resplit"  # EWMA-triggered re-split
UNRECOVERABLE = "unrecoverable"      # no fallback or re-pick remained
QUEUE_SHED = "queue_shed"            # serving engine rejected: queue full
DEADLINE_EXPIRED = "deadline_expired"  # request missed its deadline
TIER_CRASH = "tier_crash"            # stage died on its tier (crash/window)
TIER_SHED = "tier_shed"              # stage rejected: tier memory pressure
TIER_SLOW = "tier_slow"              # straggler stretched a stage's compute
BREAKER_OPEN = "breaker_open"        # consecutive tier failures tripped it
BREAKER_HALF_OPEN = "breaker_half_open"  # cooldown elapsed; probe admitted
BREAKER_CLOSE = "breaker_close"      # probe succeeded; tier back in rotation
TIER_FAILOVER = "tier_failover"      # re-picked onto a standby-tier chain


@dataclasses.dataclass(frozen=True)
class Event:
    t: float                         # link virtual-clock seconds
    kind: str
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {"t": round(self.t, 9), "kind": self.kind, **self.detail}


class EventLog:
    """Append-only event sink shared by the transfer layer and runtime."""

    def __init__(self):
        self.events: list[Event] = []

    def emit(self, kind: str, t: float, **detail: Any) -> Event:
        ev = Event(t=float(t), kind=kind, detail=detail)
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)

    def counts(self) -> dict[str, int]:
        return dict(Counter(e.kind for e in self.events))

    def since(self, mark: int) -> list[Event]:
        """Events appended after ``mark`` (= an earlier ``len(log)``)."""
        return self.events[mark:]

    def to_json(self) -> list[dict[str, Any]]:
        return [e.to_json() for e in self.events]
