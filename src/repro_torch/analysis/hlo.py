"""Cost and collective counting for the dry-run: the port's counterpart
of ``repro.analysis.hlo``.

The port has no HLO: nothing is compiled, so nothing is parsed.  Its
step functions run eagerly on meta tensors (shapes and dtypes, no data),
and four counters watch the aten operations they dispatch:

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
  shapes).  They are what the step issues: the explicit moves of
  ``models/sharded.py``'s per-rank bodies and DTensor's own
  redistributions elsewhere; ``collective-permute`` has no counterpart
  and stays 0.  DTensor's CPU mesh has no all-to-all: it moves a
  Shard(i) -> Shard(j) redistribution as an all-gather and a local
  chunk.  The pass routes that move through DTensor's own all-to-all op
  (``_dtensor.shard_dim_alltoall``, whose meta kernel gives the local
  result), so it counts as one all-to-all of the local result's bytes,
  which is what XLA emits.
* ``LiveBytes`` -- the step's own memory: every storage an operation
  creates, followed until it is freed (the plain meta pass, or the local
  tensors of the DTensor pass).  ``temp`` is the peak of those bytes
  less the step's new outputs (XLA's ``temp_size_in_bytes`` holds no
  output buffer), ``output`` the bytes the step returns and ``alias``
  those of them that share storage with an argument.  It also keeps the
  peak of each named stage of the step (``stage_temps``): the step marks
  where a stage begins (``mark``, ``mark_at_grad``), and the global peak
  is the largest stage's.  And it keeps the live bytes at every moment
  of the step (``moments``), keyed alike in two steps that differ only
  in the trips of a loop whose body is a ``loop_body``: each moment's
  bytes can then be fit across the two (the dry-run's sequence-length
  fit).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter, defaultdict, deque

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
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")


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


def count_cost(fn, *args, memory: bool = False) -> dict:
    """``fn(*args)`` on meta tensors of the global shapes: ``{"flops",
    "bytes accessed", "ops"}`` over the whole call (module docstring for
    what each includes), ``"out"``, what ``fn`` returned, and with
    ``memory`` the step's ``LiveBytes.sizes`` as ``"memory"``, its
    ``stage_temps`` as ``"stage_temps"`` and its ``moments`` as
    ``"moments"``."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    nbytes = _Bytes()
    live = LiveBytes(args) if memory else contextlib.nullcontext()
    with flops, nbytes, live:
        out = fn(*args)
    res = {"flops": float(flops.get_total_flops()),
           "bytes accessed": float(nbytes.bytes), "ops": nbytes.ops,
           "out": out}
    if memory:
        res["memory"] = live.sizes(out)
        res["stage_temps"] = live.stage_temps(out)
        res["moments"] = live.moments(out)
    return res


# the LiveBytes that count now, innermost last: what ``mark``,
# ``mark_at_grad`` and ``loop_body`` tell; empty, they do nothing
_COUNTING: list = []
# the iterations of a loop whose first and last ``KEPT`` each keep their
# moments (``LiveBytes.moments``); the ones between are left out
KEPT = 2


def mark(stage: str) -> None:
    """Stage ``stage`` of the step begins now (for every ``LiveBytes``
    counting; nothing is dispatched)."""
    for live in _COUNTING:
        live.enter(stage)


def mark_at_grad(t: torch.Tensor, stage: str) -> None:
    """Stage ``stage`` begins when the gradient of ``t`` is complete: a
    hook on ``t``, registered only while a ``LiveBytes`` counts and ``t``
    takes part in autograd (the hook returns nothing, so the gradient is
    the one autograd computed)."""
    if _COUNTING and t.requires_grad:
        t.register_hook(lambda grad: mark(stage))


def _created(args, out) -> set:
    """The sequence numbers of the autograd nodes a call made: those
    reached from its outputs' ``grad_fn`` short of its arguments' (and of
    leaves' gradient accumulators)."""
    flat, _ = tree_flatten(args)
    stop = {t.grad_fn._sequence_nr() for t in flat
            if isinstance(t, torch.Tensor) and t.grad_fn is not None}
    flat, _ = tree_flatten(out)
    todo = [t.grad_fn for t in flat if isinstance(t, torch.Tensor)]
    seen: set = set()
    while todo:
        node = todo.pop()
        if node is None or node.name().endswith("AccumulateGrad"):
            continue
        seq = node._sequence_nr()
        if seq in stop or seq in seen:
            continue
        seen.add(seq)
        todo.extend(f for f, _ in node.next_functions)
    return seen


@contextlib.contextmanager
def loop_body(module, name: str):
    """Inside: each call of ``module.name`` is one iteration of a loop
    whose trips grow with the input (a token loop), for every
    ``LiveBytes`` counting -- its operations while it runs, and in the
    backward those of the autograd nodes it made.  Nothing is
    dispatched; restored on exit."""
    fn = getattr(module, name)

    def body(*args):
        for live in _COUNTING:
            live.iteration_begins()
        out = fn(*args)
        nodes = _created(args, out) if _COUNTING else ()
        for live in _COUNTING:
            live.iteration_ends(nodes)
        return out
    setattr(module, name, body)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _local(t):
    """A DTensor's local tensor; a plain tensor itself."""
    return getattr(t, "_local_tensor", t)


def _storages(tree) -> list:
    flat, _ = tree_flatten(tree)
    return [_local(t).untyped_storage() for t in flat
            if isinstance(t, torch.Tensor)]


class LiveBytes(TorchDispatchMode):
    """Follows every storage that a non-view, non-in-place operation
    creates until it is freed (a ``weakref.finalize`` on the storage,
    which outlives its tensors while a view holds it): the live bytes
    and their peak, overall and within each stage the step marks
    (``mark``; the step starts in ``"start"``): a stage's peak counts
    the bytes live when it begins.  The arguments' storages are not the
    step's own.  Below DTensor, it sees the local tensors of one device;
    the fake tensors of DTensor's shape propagation (global shapes, never
    allocated) are not counted.

    It also keeps the live bytes at each moment of the step: a stage's
    beginning and each operation that allocates, keyed by where it lies
    in the step's structure and not by when, so that two steps that
    differ only in the trips of their ``loop_body`` loops key the same
    moments alike: (stage, the count of the stage's moments outside
    loops before it) outside a loop, and inside one (stage, that count
    where the loop began, iteration from its start (0, 1, ...) or end
    (-1, -2, ...), allocation within the iteration) for its first and
    last ``KEPT`` iterations.  The iterations between run the same
    operations, so their live bytes are affine in the iteration, and
    each of their moments peaks in a kept one."""

    def __init__(self, args):
        super().__init__()
        self._args = _storages(args)          # held: their ids stay
        self._arg_ids = {id(s) for s in self._args}
        self._live: dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.stage = "start"
        self.stage_peaks = {self.stage: 0}
        self._moments: dict[tuple, int] = {}
        self._count = {self.stage: 0}         # moments outside loops
        self._loop = None      # the loop the moments are in now
        self._calls = 0        # loop_body calls so far
        self._call = None      # the one running, or None
        self._node_call: dict[int, int] = {}  # node -> the call made it

    def __enter__(self):
        _COUNTING.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _COUNTING.remove(self)
        return super().__exit__(*exc)

    def enter(self, stage: str) -> None:
        self._close_loop()
        self.stage = stage
        self.stage_peaks[stage] = max(self.stage_peaks.get(stage, 0),
                                      self.live)
        self._count.setdefault(stage, 0)
        self._moment(None)

    def iteration_begins(self) -> None:
        self._calls += 1
        self._call = self._calls

    def iteration_ends(self, nodes) -> None:
        self._node_call.update(dict.fromkeys(nodes, self._call))
        self._call = None

    def _iteration(self):
        """The loop_body call whose operations run now, or None."""
        if self._call is not None:
            return self._call
        node = torch._C._current_autograd_node()
        return None if node is None \
            else self._node_call.get(node._sequence_nr())

    def _close_loop(self) -> None:
        if self._loop is None:
            return
        at, first, last = (self._loop[k] for k in ("at", "first", "last"))
        for i, lives in [*enumerate(first),
                         *((i - len(last), v) for i, v in enumerate(last))]:
            for j, v in enumerate(lives):
                self._moments[(self.stage, at, i, j)] = v
        self._loop = None

    def _moment(self, it) -> None:
        """Keep the live bytes now as a moment: outside a loop if ``it``
        is None, else in the loop_body call ``it``."""
        if it is None:
            self._close_loop()
            k = self._count[self.stage]
            self._moments[(self.stage, k)] = self.live
            self._count[self.stage] = k + 1
            return
        loop = self._loop
        if loop is None:
            loop = self._loop = {"at": self._count[self.stage], "first": [],
                                 "last": deque(maxlen=KEPT),
                                 "it": None, "now": None}
        if it != loop["it"]:
            loop["it"], loop["now"] = it, []
            (loop["first"] if len(loop["first"]) < KEPT
             else loop["last"]).append(loop["now"])
        loop["now"].append(self.live)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.HigherOrderOperator) \
                or any(r.alias_info is not None
                       for r in func._schema.returns):
            return out              # a view, or written in place
        from torch._subclasses.fake_tensor import is_fake
        flat, _ = tree_flatten(out)
        if any(isinstance(t, torch.Tensor) and is_fake(t) for t in flat):
            return out
        new = False
        for s in _storages(out):
            key = id(s)
            if key in self._arg_ids or key in self._live:
                continue
            self._live[key] = s.nbytes()
            self.live += s.nbytes()
            weakref.finalize(s, self._free, key)
            new = True
        if new:
            self.peak = max(self.peak, self.live)
            self.stage_peaks[self.stage] = max(
                self.stage_peaks[self.stage], self.live)
            self._moment(self._iteration())
        return out

    def _new(self, out) -> int:
        """The bytes of the step's new outputs (storages it created)."""
        flat, _ = tree_flatten(out)
        seen, new = set(), 0
        for t in flat:
            if not isinstance(t, torch.Tensor):
                continue
            key = id(_local(t).untyped_storage())
            if key in self._live and key not in seen:
                seen.add(key)
                new += self._live[key]
        return new

    def sizes(self, out) -> dict:
        """The step's memory sizes, after it returned ``out``."""
        flat, _ = tree_flatten(out)
        tensors = [_local(t) for t in flat if isinstance(t, torch.Tensor)]
        output = sum(t.numel() * t.element_size() for t in tensors)
        alias = sum(t.numel() * t.element_size() for t in tensors
                    if id(t.untyped_storage()) in self._arg_ids)
        return {"output_size_in_bytes": output,
                "temp_size_in_bytes": max(self.peak - self._new(out), 0),
                "alias_size_in_bytes": alias}

    def stage_temps(self, out) -> dict:
        """Each stage's peak less the step's new outputs (``out``), as
        ``temp`` is the global peak less them: the largest, floored at 0,
        is ``temp``."""
        new = self._new(out)
        return {k: v - new for k, v in self.stage_peaks.items()}

    def moments(self, out) -> dict:
        """``{"live": each moment's live bytes by its key (class
        docstring), "new": the bytes of the step's new outputs}``: a
        moment's temp is its live bytes less the new outputs'."""
        self._close_loop()
        return {"live": dict(self._moments), "new": self._new(out)}


class _Collectives(TorchDispatchMode):
    """Counts the aten collectives below DTensor (it lets DTensor run
    first, as ``CommDebugMode`` does) and sums each one's result bytes
    on this rank; ``shapes`` counts each (kind, result shape, dtype)."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.shapes: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is not None and func.namespace in _COLLECTIVE_NAMESPACES:
            self.bytes[kind] += _nbytes(out)
            self.counts[kind] += 1
            self.shapes[(kind, tuple(out.shape), str(out.dtype))] += 1
        return out


@contextlib.contextmanager
def alltoall_as_alltoall():
    """Inside: DTensor moves a Shard(i) -> Shard(j) redistribution on a
    CPU mesh through its all-to-all op (``_dtensor.shard_dim_alltoall``)
    and not through its CPU fallback (an all-gather and a chunk).  The
    fake process group sends nothing, and the op's meta kernel gives the
    local result.  Restored on exit."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    real = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = real


def count_collectives(fn, *args) -> dict:
    """``fn(*args)`` on DTensors: ``{"coll"}`` result bytes on one device
    by kind, with ``"total"``, ``{"counts"}`` by kind (kinds in
    ``COLLECTIVE_OPS``), ``{"shapes"}`` each collective's (kind, result
    shape, dtype) and its count, and one device's ``LiveBytes.sizes`` as
    ``{"memory"}``, its ``stage_temps`` as ``{"stage_temps"}`` and its
    ``moments`` as ``{"moments"}``."""
    mode = _Collectives()
    live = LiveBytes(args)
    with alltoall_as_alltoall(), mode, live:
        out = fn(*args)
    coll = {k: mode.bytes.get(k, 0.0) for k in COLLECTIVE_OPS}
    coll["total"] = sum(coll.values())
    return {"coll": coll,
            "counts": {k: mode.counts.get(k, 0) for k in COLLECTIVE_OPS},
            "shapes": dict(mode.shapes), "memory": live.sizes(out),
            "stage_temps": live.stage_temps(out),
            "moments": live.moments(out)}
