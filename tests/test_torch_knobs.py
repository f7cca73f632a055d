"""The port's knob registry (``repro_torch.core.knobs``, a copy of the
JAX package's): every ``REPRO_*`` name the port reads is registered and
read by the JAX package too (the port adds none), the registry renders
``docs/knobs.md`` exactly as the JAX package's does, and that file is
what both render."""
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import knobs as J  # noqa: E402
from repro_torch.core import knobs as K  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_port_reads_are_registered():
    scanned = K.scan_env_reads()
    assert scanned and scanned <= K.registry_names()


def test_port_reads_no_name_the_jax_package_does_not():
    assert K.scan_env_reads() <= J.scan_env_reads()
    assert "REPRO_FSDP" in K.scan_env_reads()
    assert "REPRO_MOE_EP" in K.scan_env_reads()


def test_scan_defaults_to_the_port_package():
    assert K.scan_env_reads() == K.scan_env_reads(REPO / "src"
                                                  / "repro_torch")


def test_render_equals_jax_and_docs():
    assert K.render_markdown() == J.render_markdown()
    assert (REPO / "docs" / "knobs.md").read_text() == K.render_markdown()
    assert K.registry_names() == J.registry_names()
