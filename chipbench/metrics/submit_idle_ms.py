"""Milliseconds a batch the card sat idle while the host was admitting
requests: the idle instants put down to the engine's ``serve/submit``
and ``serve/upload`` spans (``chipbench.attribution``), over the
window's batches."""
from chipbench import attribution


def read(run):
    return attribution.idle_ms_per_batch(run, ("serve/submit",
                                               "serve/upload"))
