"""The port's own spans (``repro_torch.spans``): under ``torch.profiler``
the serving engine, chain runtime, wire codec, link and model walk put
their ranges on the profiler's timeline; with no profiler a span is a
shared null context and no range is opened.

MobileNetV2 at 224 px, served in batches of 4 on ``paper_chain(3)`` with
the int8 wire on both hops, on the CPU."""
import collections

import pytest
import torch

from repro_torch import spans
from repro_torch.core.hardware import paper_chain
from repro_torch.models import cnn as cnn_lib
from repro_torch.serving.cnn_engine import CnnServingEngine

NAMES = ("serve/submit", "serve/upload", "serve/step", "chain/infer",
         "chain/stage", "model/conv", "model/linear", "codec/encode",
         "codec/to_host", "codec/pack", "link/send", "link/transmit",
         "link/checksum", "codec/decode", "codec/upload")
BATCH, BATCHES, HOPS = 4, 2, 2


def _engine():
    layers = cnn_lib.CNN_MODELS["mobilenetv2"]
    params = cnn_lib.init_cnn(layers, device="cpu")
    return CnnServingEngine({"mobilenetv2": (layers, params)},
                            hw=paper_chain(3), max_batch=BATCH,
                            pipelined=False, wire=("int8", "int8"),
                            device="cpu")


def _serve(eng, images):
    reqs = [eng.submit(x) for x in images]
    for _ in range(-(-len(images) // BATCH)):
        eng.step()
    return torch.stack([r.logits for r in reqs])


@pytest.fixture(scope="module")
def traced():
    """Two batches served under the profiler, then the same images again
    with no profiler: (span counts, traced logits, untraced logits)."""
    eng = _engine()
    images = torch.randn(BATCH * BATCHES, 3, 224, 224,
                         generator=torch.Generator().manual_seed(0))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        logits = _serve(eng, images)
    counts = collections.Counter(e.name for e in prof.events()
                                 if "/" in e.name)
    return counts, logits, _serve(eng, images)


def test_every_span_appears_under_a_profiler(traced):
    counts, _, _ = traced
    assert set(counts) == set(NAMES)
    assert counts["serve/step"] == counts["chain/infer"] == BATCHES
    assert counts["chain/stage"] == 3 * BATCHES
    for name in ("codec/encode", "codec/to_host", "codec/pack", "link/send",
                 "link/transmit", "codec/decode", "codec/upload"):
        assert counts[name] == HOPS * BATCHES, name


def test_seven_checksum_passes_a_hop_and_one_upload_a_request(traced):
    """Framing (2), the whole payload (1), verifying the frames on
    delivery (2) and again in the decoder (2)."""
    counts, _, _ = traced
    assert counts["link/checksum"] == 7 * HOPS * BATCHES
    assert counts["serve/upload"] == counts["serve/submit"] \
        == BATCH * BATCHES


def test_the_walks_spans_count_its_conv_steps_and_its_classifier(traced):
    """MobileNetV2: the stem, 17 inverted residuals and the last 1x1 conv
    are conv steps; the pooled linear head is the classifier."""
    counts, _, _ = traced
    assert counts["model/conv"] == 19 * BATCHES
    assert counts["model/linear"] == BATCHES


def test_spans_change_no_number(traced):
    _, logits, again = traced
    assert torch.equal(logits, again)


def test_no_profiler_no_range(monkeypatch):
    opened = []
    enter = spans._enter
    monkeypatch.setattr(spans, "_enter",
                        lambda name: opened.append(name) or enter(name))
    assert spans.span("serve/step") is spans.span("codec/decode")
    eng = _engine()
    _serve(eng, torch.zeros(1, 3, 224, 224))
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("serve/step"):
            pass
    assert opened == ["serve/step"]
