"""Reliable transfer over a ``FaultyLink``: checksum, timeout, retries,
exponential backoff with seeded jitter.

One call = one logical boundary-payload upload.  Each wire attempt carries
the payload plus a small framing header (crc32 + length); a delivered-but-
corrupt payload fails checksum verification and retries exactly like a
drop -- the caller NEVER sees corrupted bytes, which is what makes the
runtime's "bit-identical or recorded fallback" guarantee possible.
Backoff waits are spent on the link's virtual clock (seeded jitter keeps
the schedule deterministic), so retry storms interact correctly with
outage windows and time-varying bandwidth profiles."""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import numpy as np

from repro_torch.core.costs import (FRAME_HEADER_BYTES, MULTIPART_BASE_BYTES,
                              PART_HEADER_BYTES)
from repro_torch.runtime import events as ev
from repro_torch.runtime.events import EventLog
from repro_torch.runtime.faults import (ENV_PREFIX, FaultyLink, LinkDropped,
                                  LinkError, LinkOutage, LinkTimeout)
from repro_torch.spans import span

# Framing overhead per wire attempt: crc32 (4B) + payload length (4B).
# The cost model prices the same constant (costs.FRAME_HEADER_BYTES) in
# the microbatch pipeline terms -- one source of truth.
HEADER_BYTES = FRAME_HEADER_BYTES


class ChecksumError(LinkError):
    """Payload delivered but its crc32 did not match the header's.

    ``part`` names the multipart frame the mismatch hit ("scales" /
    "data" / "header") when the transfer was framed, else None -- the
    chaos harness uses it to attribute quantized-frame corruption."""

    part: str | None = None


def _crc32(data: bytes) -> int:
    with span("link/checksum"):
        return zlib.crc32(data)


class FrameError(ValueError):
    """A multipart buffer failed structural or per-part crc validation."""

    def __init__(self, msg: str, part: str):
        super().__init__(msg)
        self.part = part


def pack_frames(*parts: bytes) -> bytes:
    """Frame N byte-strings as one payload, each with its own crc32.

    Layout: ``u32 part-count | [u32 length, u32 crc32, bytes] * N``.
    The int8 boundary codec sends (scales, data) through this, so a
    single flipped byte anywhere is caught -- and attributed -- by
    ``unpack_frames``.  The overhead constants (``MULTIPART_BASE_BYTES``
    + ``PART_HEADER_BYTES`` per part) live in ``core.costs`` so the
    optimiser prices exactly these bytes."""
    buf = [struct.pack("<I", len(parts))]
    for p in parts:
        buf.append(struct.pack("<II", len(p), _crc32(p)))
        buf.append(p)
    return b"".join(buf)


def unpack_frames(buf: bytes, labels: tuple[str, ...] = ()
                  ) -> tuple[bytes, ...]:
    """Split and verify a ``pack_frames`` buffer.

    Raises ``FrameError`` naming the corrupted part (``labels[i]`` when
    given, else ``part{i}``; structural damage = "header")."""
    base = MULTIPART_BASE_BYTES
    if len(buf) < base:
        raise FrameError("multipart buffer shorter than its header",
                         "header")
    (count,) = struct.unpack_from("<I", buf, 0)
    if labels and count != len(labels):
        raise FrameError(
            f"expected {len(labels)} parts, header says {count}", "header")
    off = base
    parts = []
    for i in range(count):
        if off + PART_HEADER_BYTES > len(buf):
            raise FrameError(f"part {i} header out of bounds", "header")
        length, crc = struct.unpack_from("<II", buf, off)
        off += PART_HEADER_BYTES
        if off + length > len(buf):
            raise FrameError(f"part {i} length out of bounds", "header")
        part = buf[off:off + length]
        off += length
        label = labels[i] if i < len(labels) else f"part{i}"
        if _crc32(part) != crc:
            raise FrameError(f"crc32 mismatch in part {label!r}", label)
        parts.append(part)
    if off != len(buf):
        raise FrameError("trailing bytes after last part", "header")
    return tuple(parts)


class TransferFailed(RuntimeError):
    """Retries exhausted for one logical transfer (stats attached)."""

    def __init__(self, msg: str, *, attempts: int, elapsed_s: float,
                 wire_bytes: int):
        super().__init__(msg)
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.wire_bytes = wire_bytes


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-transfer reliability knobs (env: REPRO_LINK_RETRIES /
    REPRO_LINK_TIMEOUT / REPRO_LINK_BACKOFF / REPRO_LINK_BACKOFF_FACTOR /
    REPRO_LINK_JITTER via ``RetryPolicy.from_env``).

    Attempt i (1-based) waits ``backoff_base_s * backoff_factor**(i-1)``
    -- scaled by ``1 + jitter * U[0,1)`` from the caller's seeded rng --
    before attempt i+1."""

    max_attempts: int = 4
    timeout_s: float = 5.0
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.timeout_s <= 0:
            raise ValueError(
                f"timeout_s must be positive, got {self.timeout_s}")
        if self.backoff_base_s < 0 or self.backoff_factor < 1 \
                or self.jitter < 0:
            raise ValueError("backoff must be non-negative and "
                             "non-shrinking")

    def backoff_s(self, attempt: int, u: float = 0.0) -> float:
        """Wait after failed attempt ``attempt`` (1-based); ``u`` in
        [0, 1) supplies the jitter draw."""
        base = self.backoff_base_s * self.backoff_factor ** (attempt - 1)
        return base * (1.0 + self.jitter * u)

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        get = os.environ.get
        return cls(
            max_attempts=int(get(ENV_PREFIX + "RETRIES", 4)),
            timeout_s=float(get(ENV_PREFIX + "TIMEOUT", 5.0)),
            backoff_base_s=float(get(ENV_PREFIX + "BACKOFF", 0.05)),
            backoff_factor=float(get(ENV_PREFIX + "BACKOFF_FACTOR", 2.0)),
            jitter=float(get(ENV_PREFIX + "JITTER", 0.25)))


@dataclasses.dataclass(frozen=True)
class TransferOutcome:
    """A successful logical transfer and what it cost."""

    payload: bytes               # verified, bit-identical to what was sent
    attempts: int                # wire attempts used (1 = clean)
    elapsed_s: float             # total virtual time incl. failures+backoff
    success_elapsed_s: float     # the winning attempt's own wire time
    wire_bytes: int              # all bytes put on the wire (retransmits)
    goodput_bytes: int           # payload + one header (the useful bytes)

    @property
    def retransmitted_bytes(self) -> int:
        return self.wire_bytes - self.goodput_bytes

    # A zero-virtual-time win (e.g. a mocked or infinitely fast link)
    # must not hand callers an infinite bandwidth: one `inf` folded into
    # an EWMA poisons every later `degradation()` ratio (1/inf -> 0 ->
    # permanent "degraded" verdict).  Clamp to a finite ceiling instead.
    BANDWIDTH_CLAMP = 1e18          # bytes/s; ~8 exabit/s, safely absurd

    @property
    def observed_bandwidth(self) -> float:
        """Goodput of the winning attempt -- the EWMA estimator's input.
        Finite by construction (see ``BANDWIDTH_CLAMP``)."""
        if self.success_elapsed_s <= 0:
            return self.BANDWIDTH_CLAMP
        return min(self.goodput_bytes / self.success_elapsed_s,
                   self.BANDWIDTH_CLAMP)


_FAIL_KINDS = {LinkDropped: ev.DROP, LinkTimeout: ev.TIMEOUT,
               LinkOutage: ev.OUTAGE, ChecksumError: ev.CHECKSUM_FAIL}


def send_with_retry(link: FaultyLink, payload: bytes,
                    policy: RetryPolicy = RetryPolicy(), *,
                    rng: np.random.Generator | None = None,
                    log: EventLog | None = None,
                    what: str = "boundary",
                    at: float | None = None,
                    framed: tuple[str, ...] | None = None) -> TransferOutcome:
    """Deliver ``payload`` over ``link`` or raise ``TransferFailed``.

    rng: seeded generator for backoff jitter (None = no jitter).
    log: optional ``EventLog``; every attempt/failure/backoff is emitted.
    what: label carried on the events (e.g. "boundary", "logits").
    at: explicit virtual start time for the transfer.  ``None`` (the
      two-tier path) starts at the link clock and spends backoff waits on
      it directly -- exactly the historical behaviour.  The chain runtime
      passes its pipeline-scheduled send time: the retry loop then keeps
      a local time cursor (the shared clock only ratchets forward via
      ``send_at``), so concurrent hops don't steal each other's time.
    framed: part labels when ``payload`` is a ``pack_frames`` buffer
      (e.g. ``("scales", "data")`` for int8 boundaries).  Integrity then
      comes from the embedded per-part crc32s instead of the outer
      checksum, so a corruption event names the part it hit."""
    with span("link/send"):
        log = log if log is not None else EventLog()
        crc = _crc32(payload)
        size = len(payload) + HEADER_BYTES
        scheduled = at is not None
        t = float(at) if scheduled else link.clock
        t_start = t
        wire_bytes = 0
        for attempt in range(1, policy.max_attempts + 1):
            log.emit(ev.ATTEMPT, t, what=what, attempt=attempt, nbytes=size)
            wire_bytes += size
            try:
                with span("link/transmit"):
                    if scheduled:
                        delivered, elapsed = link.send_at(t, payload,
                                                          policy.timeout_s)
                    else:
                        delivered, elapsed = link.send(payload,
                                                       policy.timeout_s)
                if framed is not None:
                    try:
                        unpack_frames(delivered, framed)
                    except FrameError as fe:
                        err = ChecksumError(
                            f"{fe} on attempt {attempt}", elapsed)
                        err.part = fe.part
                        raise err from fe
                elif _crc32(delivered) != crc:
                    raise ChecksumError(
                        f"crc32 mismatch on attempt {attempt}", elapsed)
                t += elapsed
                log.emit(ev.TRANSFER_OK, t, what=what,
                         attempt=attempt, elapsed_s=elapsed)
                return TransferOutcome(
                    payload=delivered, attempts=attempt,
                    elapsed_s=t - t_start, success_elapsed_s=elapsed,
                    wire_bytes=wire_bytes, goodput_bytes=size)
            except LinkError as e:
                t += e.elapsed_s
                part = getattr(e, "part", None)
                log.emit(_FAIL_KINDS[type(e)], t, what=what,
                         attempt=attempt, elapsed_s=e.elapsed_s,
                         **({"part": part} if part else {}))
                if attempt == policy.max_attempts:
                    log.emit(ev.GIVE_UP, t, what=what, attempts=attempt)
                    raise TransferFailed(
                        f"{what}: {attempt} attempts exhausted ({e})",
                        attempts=attempt, elapsed_s=t - t_start,
                        wire_bytes=wire_bytes) from e
                u = float(rng.uniform()) if rng is not None else 0.0
                wait = policy.backoff_s(attempt, u)
                if not scheduled:
                    link.advance(wait)
                t += wait
                log.emit(ev.BACKOFF, t, what=what, attempt=attempt,
                         wait_s=wait)
        raise AssertionError("unreachable")  # pragma: no cover
