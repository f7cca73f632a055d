"""Cost and collective counting for the dry-run: the port's counterpart
of ``repro.analysis.hlo``.

The port has no HLO: nothing is compiled, so nothing is parsed.  Its
step functions run eagerly on meta tensors (shapes and dtypes, no data),
and three counters watch the aten operations they dispatch:

* ``count_cost`` -- flops and bytes of one call on plain meta tensors of
  the GLOBAL shapes:
  - flops: ``torch.utils.flop_counter.FlopCounterMode``, which counts
    matmuls, convolutions and attention (2 per multiply-add) and nothing
    elementwise (no norms, softmax, activations or optimizer arithmetic).
    XLA's ``cost_analysis()["flops"]`` counts those too;
  - bytes: every non-view aten operation's tensor inputs and outputs,
    each once an operation -- the memory traffic of the port's unfused
    eager path (each op reads its inputs from and writes its outputs to
    HBM), not XLA's fused ``bytes accessed``.  Views (reshape, slice,
    transpose, expand, ...) move nothing and are not counted; a gather
    (an embedding lookup) reads the rows it returns, not its whole
    table.
  A per-device figure is the global one over the number of devices: it
  leaves out work that a sharded program repeats on every device
  (replicated parameters' updates, replicated activations), which XLA's
  per-device counts include.
* ``count_collectives`` -- the collectives one call issues on DTensors
  over a ``torch.distributed`` DeviceMesh (under a fake process group,
  so no data moves), bucketed by ``COLLECTIVE_OPS``: counts, and the
  bytes of each collective's result on one device (the per-device
  payload, as ``collective_bytes`` of the JAX package sums the result
  shapes).  They are what DTensor's sharding propagation issues, which
  need not be what XLA's partitioner would; ``collective-permute`` has
  no DTensor counterpart and stays 0.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# aten-level collectives (DTensor's redistributions desugar to these) by
# the JAX package's names
_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def _nbytes(tree) -> int:
    flat, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in flat
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


# gathers: the source (first argument) is read where the output says
_GATHERS = ("index", "index_select", "gather", "embedding")


class _Bytes(TorchDispatchMode):
    """Sums the bytes of every non-view aten op's tensor inputs and
    outputs, and counts the ops."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            if func._overloadpacket.__name__ in _GATHERS:
                # the source's bytes read are the rows returned
                self.bytes += _nbytes((args[1:], kwargs)) + 2 * _nbytes(out)
            else:
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.ops += 1
        return out


def count_cost(fn, *args) -> dict:
    """``fn(*args)`` on meta tensors of the global shapes: ``{"flops",
    "bytes accessed", "ops"}`` over the whole call (module docstring for
    what each includes), and ``"out"``, what ``fn`` returned."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    nbytes = _Bytes()
    with flops, nbytes:
        out = fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(nbytes.bytes), "ops": nbytes.ops,
            "out": out}


class _Collectives(TorchDispatchMode):
    """Counts the aten collectives below DTensor (it lets DTensor run
    first, as ``CommDebugMode`` does) and sums each one's result bytes
    on this rank."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is not None and func.namespace in ("_c10d_functional",
                                                   "_dtensor"):
            self.bytes[kind] += _nbytes(out)
            self.counts[kind] += 1
        return out


def count_collectives(fn, *args) -> tuple[dict[str, float],
                                          dict[str, int]]:
    """``fn(*args)`` on DTensors: (result bytes on one device by kind,
    with ``"total"``; counts by kind), kinds in ``COLLECTIVE_OPS``."""
    mode = _Collectives()
    with mode:
        fn(*args)
    out = {k: mode.bytes.get(k, 0.0) for k in COLLECTIVE_OPS}
    out["total"] = sum(out.values())
    return out, {k: mode.counts.get(k, 0) for k in COLLECTIVE_OPS}
