"""Milliseconds a batch the card sat idle while the host was crossing a
boundary: each idle instant of the window put down to the innermost
program span open on the harness thread (``chipbench.attribution``), and
those of the wire codec's and the link's spans (``codec/*``, ``link/*``)
summed over the window's batches."""
from chipbench import attribution


def read(run):
    return attribution.idle_ms_per_batch(run, ("codec/", "link/"))
