"""The card's idle time put down to the host work that held it.

``Trace.idle_gaps`` files a whole gap under the span the harness thread
was in when the gap opened.  ``idle_by_span`` follows the harness thread
through the gap instead: each idle instant of the window goes to the
innermost span open on that thread at that instant, so a gap that opens
in the encoder and runs on through the link and the decoder is split
between them."""
from __future__ import annotations

import collections

HARNESS = "(harness)"


def _pieces(spans, w0: float, w1: float):
    """``(start, end, innermost span's name)`` pieces tiling [w0, w1], from
    one thread's spans sorted by (start, -end).  A span that outlasts its
    parent (the trace rounds to the nanosecond) is cut at the parent's
    end."""
    out, stack, t = [], [], w0

    def close(until: float) -> None:
        nonlocal t
        while stack and stack[-1][1] <= until:
            end, name = stack.pop()[1:]
            out.append((t, end, name))
            t = end

    for a, b, name, _ in spans:
        close(a)
        out.append((t, a, stack[-1][2] if stack else HARNESS))
        t = a
        stack.append((a, min(b, stack[-1][1]) if stack else b, name))
    close(w1)
    out.append((t, w1, HARNESS))
    return [p for p in out if p[1] > p[0]]


def idle_by_span(trace) -> dict[str, float]:
    """Idle seconds of ``trace``'s window by the innermost span of the
    harness thread open at each idle instant (``HARNESS`` where none is)."""
    edges = [trace.w0] + [t for ab in trace.busy for t in ab] + [trace.w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    pieces = _pieces(trace._by_tid.get(trace.tid, []), trace.w0, trace.w1)
    by: dict[str, float] = collections.defaultdict(float)
    k = 0
    for a, b in idle:
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            p0, p1, name = pieces[j]
            by[name] += min(b, p1) - max(a, p0)
            j += 1
    return dict(by)


def idle_ms_per_batch(run, prefixes: tuple[str, ...]):
    """Idle milliseconds a batch of the window credited to spans whose
    names start with one of ``prefixes``; None without device operations,
    batches, or any such span in the trace (a program without them)."""
    t, win = run["trace"], run["window"]
    if t is None or not t.device or not win["batches"] \
            or not any(n.startswith(prefixes) for n in t.count):
        return None
    idle = idle_by_span(t)
    return 1e3 * sum(s for n, s in idle.items() if n.startswith(prefixes)) \
        / win["batches"]
