"""Idle time put down to the program's spans, and the program's spans
beside the benchmark's wrappers: each program span nests so that every
metric read from a wrapper reads what it read before the program had
spans of its own."""
import collections

import pytest

from chipbench import attribution, manifest, tracing
from chipbench.run import run_cell
from chipbench.tests.test_chipbench_faults import BENCH, CELL, SMALL

NEW = ("crossing_idle_ms.fused", "submit_idle_ms.fused",
       "checksum_ms_per_image.fused", "linear_ms.fused")


def _event(cat, name, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=1,
                args=args)


def _synthetic(spans=True):
    """A 1,000 us window with two kernels, [0, 100] and [600, 700]; the
    first gap runs through three nested spans and ends in the harness,
    the second holds a submit."""
    events = [_event("user_annotation", tracing.WINDOW, 0, 1000),
              _event("cuda_runtime", "cudaLaunchKernel", 5, 1,
                     correlation=1),
              _event("cuda_runtime", "cudaLaunchKernel", 580, 1,
                     correlation=2),
              _event("kernel", "k0", 0, 100, correlation=1),
              _event("kernel", "k1", 600, 100, correlation=2)]
    if spans:
        events += [_event("user_annotation", name, a, b - a)
                   for name, a, b in [("serve/step", 50, 500),
                                      ("codec/encode", 120, 400),
                                      ("link/checksum", 150, 300),
                                      ("model/linear", 560, 590),
                                      ("serve/submit", 750, 850)]]
    return tracing.Trace(events)


def test_each_idle_instant_goes_to_the_innermost_span_open():
    t = _synthetic()
    got = attribution.idle_by_span(t)
    want = {"serve/step": 20 + 100, "codec/encode": 30 + 100,
            "link/checksum": 150, "model/linear": 30, "serve/submit": 100,
            attribution.HARNESS: 60 + 10 + 50 + 150}
    assert got.keys() == want.keys()
    for name, us in want.items():
        assert got[name] == pytest.approx(us * 1e-6, rel=1e-9), name
    assert sum(got.values()) == pytest.approx(t.window_s - t.busy_s)
    # the gap-start filing puts the whole first gap under the step
    assert dict(t.idle_gaps()) == pytest.approx(
        {"serve/step": 500e-6, attribution.HARNESS: 300e-6})


def test_a_span_that_outlasts_its_parent_ends_with_it():
    pieces = attribution._pieces([(0.0, 10.0, "a", 1), (5.0, 11.0, "b", 1)],
                                 0.0, 20.0)
    assert pieces == [(0.0, 5.0, "a"), (5.0, 10.0, "b"),
                      (10.0, 20.0, attribution.HARNESS)]


def test_the_new_readers_on_the_synthetic_trace():
    run = {"trace": _synthetic(), "window": {"images": 8, "batches": 2}}
    read = {name: manifest.reader(name).read(run) for name in NEW}
    assert read == pytest.approx({
        "crossing_idle_ms.fused": (130 + 150) * 1e-3 / 2,
        "submit_idle_ms.fused": 100 * 1e-3 / 2,
        "checksum_ms_per_image.fused": 150 * 1e-3 / 8,
        "linear_ms.fused": 100 * 1e-3 / 2}, rel=1e-9)
    assert manifest.reader("crossing_idle_ms.open").read(run) \
        == read["crossing_idle_ms.fused"]


@pytest.mark.parametrize("run", [
    {"trace": None, "window": {"images": 8, "batches": 2}},
    {"trace": _synthetic(spans=False), "window": {"images": 8,
                                                  "batches": 2}},
    {"trace": _synthetic(), "window": {"images": 0, "batches": 0}}],
    ids=["untraced", "a_program_without_spans", "no_batches"])
def test_the_new_readers_read_nothing_where_their_input_is_absent(run):
    for name in NEW:
        assert manifest.reader(name).read(run) is None, name


@pytest.fixture(scope="module")
def traced_cell():
    """One traced CPU run of the small MobileNetV2 cell, with the trace
    the run read."""
    read, kept = tracing.read, []

    def keep(prof):
        kept.append(read(prof))
        return kept[-1]

    tracing.read = keep
    try:
        out = run_cell(BENCH, CELL, seed=2**31 + 5, seconds=0.5, trace=True,
                       device="cpu", overrides=SMALL)
    finally:
        tracing.read = read
    return out, kept[0]


def _ancestors(trace):
    """Each harness-thread span with the names of the spans around it,
    innermost first."""
    out, stack = [], []
    for a, b, name, _ in trace._by_tid[trace.tid]:
        while stack and stack[-1][1] <= a:
            stack.pop()
        out.append((name, [s[2] for s in reversed(stack)]))
        stack.append((a, b, name))
    return out


def test_program_spans_nest_so_the_wrappers_read_as_before(traced_cell):
    _, trace = traced_cell
    wrappers = {label for *_, label in manifest.driver("cnn_engine")
                .System.spans(None)}
    seen = collections.Counter()
    for name, around in _ancestors(trace):
        if "/" not in name:
            continue
        seen[name] += 1
        # (b) the runtime's self time keeps what the program spans cover
        assert not around or around[0] != "runtime.infer", name
        # (c) launches inside the conv wrapper stay credited to it
        assert "kernels.conv2d" not in around, name
        # (a) the crossing nests inside its wrappers
        if name.startswith(("codec/", "link/")):
            assert {"wire.encode", "wire.decode", "transfer.send"} \
                & set(around), name
        if name == "chain/infer":
            assert "runtime.infer" not in around
    assert wrappers == {"engine.step", "engine.submit", "runtime.infer",
                        "runtime.stage", "wire.encode", "transfer.send",
                        "wire.decode", "kernels.conv2d"}
    assert seen["link/checksum"] == 7 * 2 * trace.count["serve/step"]


def test_a_traced_cpu_run_reports_the_host_metrics_alone(traced_cell):
    out, _ = traced_cell
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    assert metrics["checksum_ms_per_image.fused"]["value"] > 0
    assert metrics["runtime_host_ms.fused"]["value"] > 0
    for name in ("crossing_idle_ms.fused", "submit_idle_ms.fused",
                 "linear_ms.fused"):
        assert name not in metrics
