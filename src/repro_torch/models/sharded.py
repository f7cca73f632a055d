"""The dry-run's sharded step: per-rank bodies of the model's
communicating layers, on DTensors.

``launch/dryrun.py`` counts a cell's collectives by running the port's
step on DTensors over a (pod x data, model) DeviceMesh under a fake
process group.  Left to DTensor's sharding propagation, that step
all-gathers the vocab-sharded embedding table and logits, q, k and v at
their reshape into heads, the SwiGLU hidden layer, the MoE slot slabs
and, inside the recurrent mixers, their projections (RWKV6's train step
once a token): another program than the JAX package's, which XLA's
partitioner lays out as a Megatron-style step.  The helpers of
``models/layers.py`` (``embed``, ``token_logprobs``, ``attention``,
``swiglu``, ``moe``, ``rwkv6``, ``mamba2``, ``mamba2_step``) call the
bodies below when they are handed DTensors; on plain tensors they run
the ops they always ran.

A body works on one rank's local tensors (``to_local``), moves data only
by named collectives (``move``: a redistribution to a named placement;
``regroup``, ``all_to_all``: ``_functional_collectives``), and returns
DTensors (``DTensor.from_local``).  Under the fake group this process is
rank 0 of every mesh dim, and its shapes stand for every rank's (where
ranks differ, rank 0 holds the most).  Each move is recorded -- where,
from and to which layout, its result bytes on this device -- in the
``Pass`` that ``counting`` opens; it exists only inside the dry-run's
pass.

* Embedding: vocab-parallel.  A rank looks up the rows of its vocab
  slice, a mask zeroes the others, and the partial rows are all-reduced
  over the model axis.  The table is never gathered.
* Loss: vocab-parallel cross-entropy.  The max and the sum of
  exponentials are all-reduced over the model axis, the label's logit
  is picked where it lives and all-reduced.  The logits are never
  gathered.
* Attention: head-sharded.  A rank takes h / m q heads (ceil(h / m)
  where m does not divide h, the last ranks fewer) and the kv heads
  they read.  Where its columns of a projection are not those heads (a
  kv head split over ranks; Granite's 24 heads over 16) the
  projection's output moves to the head-aligned layout by one
  all-to-all before the reshape.  The KV cache keeps its placement: a
  head-sharded cache is written and read where it lies; a slot-sharded
  one (kv heads that do not divide the model axis) is read flash-
  decoding style -- every q head against the rank's slots, the
  softmax's max and sum and the weighted values all-reduced over the
  model axis -- after q and the new k and v (not the cache) are
  gathered.  The output projection is row-parallel: one all-reduce.
* SwiGLU: wg and wu column-parallel, wd row-parallel: one all-reduce.
* MoE: expert-parallel where ``moe_ep.ep_enabled``'s conditions hold on
  the DeviceMesh and the pass asks for it (``REPRO_MOE_EP``): the port's
  own ``moe_ep._route``, ``_experts`` and ``_combine``, two all-to-alls
  of the send buffers over the model axis, the expert weights first
  moved to expert-dim shards, the combined tokens all-reduced (JAX's
  ``psum``).  Every rank routes over all experts: a router sharded over
  model (Kimi-K2's 384 columns) is gathered first.  Elsewhere the local
  dispatch of the rank's tokens against the weights where they lie
  (expert-dim or within-expert shards), and one all-reduce of the
  combined tokens.
* RWKV6 and Mamba2: head-local.  A rank takes its heads' columns of
  each column-parallel projection (Mamba2's ``in_proj`` output moved to
  them by one ``regroup``: z, xs, the B and C of the groups its heads
  read, dt), its slice of each replicated per-head parameter, and runs
  the recurrence on its share of the head-sharded state, which never
  moves; the norms over the whole width sum their squares over the
  model axis (``_SumShares``: forward and backward), the output
  projections are row-parallel.  The states are written back in the
  placements the cache structs give them.

Gradients follow Megatron's rule: a body's local input has the ranks'
shares of its gradient (``_local_act``'s partial), a reduced value that
every rank then uses alike has the whole gradient on each (``_reduce``),
one that each uses on its own columns gathers its shares backward
(``_SumShares``).  ``tests/test_torch_sharded_numeric.py`` runs the
recurrent bodies on two gloo ranks against the plain layers, gradients
included.
"""
from __future__ import annotations

import contextlib
import math
import sys

import torch


class Pass:
    """What one counted pass did: its explicit moves and how many MoE
    layers it dispatched expert-parallel."""

    def __init__(self, ep: bool):
        self.ep = ep
        self.moves: list[dict] = []
        self.ep_layers = 0


_PASS: Pass | None = None


@contextlib.contextmanager
def counting(ep: bool = True):
    """A ``Pass`` that records the moves of the bodies run inside; ``ep``
    asks for the expert-parallel MoE dispatch where it applies."""
    global _PASS
    prev, _PASS = _PASS, Pass(ep)
    try:
        yield _PASS
    finally:
        _PASS = prev


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (False, and no import, where
    ``torch.distributed.tensor`` was never loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _pl():
    from torch.distributed.tensor import Partial, Replicate, Shard
    return Partial, Replicate, Shard


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kind(src, dst) -> str:
    kinds = []
    for a, b in zip(src, dst):
        if a == b:
            continue
        if a.is_partial():
            kinds.append("all-reduce" if b.is_replicate()
                         else "reduce-scatter")
        elif a.is_shard():
            kinds.append("all-gather" if b.is_replicate() else "all-to-all")
        else:
            kinds.append("local")
    return "+".join(kinds)


def _note(where: str, src: str, dst: str, kind: str, nbytes: int) -> None:
    if _PASS is not None:
        _PASS.moves.append({"where": where, "from": src, "to": dst,
                            "kind": kind, "bytes": int(nbytes)})


def move(t, placements, where: str):
    """``t`` redistributed to ``placements``; the move is recorded with
    its local result's bytes."""
    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    out = t.redistribute(t.device_mesh, placements)
    _note(where, str(tuple(t.placements)), str(placements),
          _kind(t.placements, placements), _nbytes(out._local_tensor))
    return out


class _Mesh:
    """The data (pod x data) and model dims of a DTensor's mesh, and this
    rank's place on the model dim."""

    def __init__(self, t):
        self.mesh = t.device_mesh
        names = self.mesh.mesh_dim_names
        self.di = names.index("data") if "data" in names else None
        self.mi = names.index("model") if "model" in names else None
        self.m = self.mesh.size(self.mi) if self.mi is not None else 1
        self.r = self.mesh.get_local_rank(self.mi) \
            if self.mi is not None else 0
        self.dn = self.mesh.size(self.di) if self.di is not None else 1

    def placements(self, data, model) -> tuple:
        out = [None] * self.mesh.ndim
        if self.di is not None:
            out[self.di] = data
        if self.mi is not None:
            out[self.mi] = model
        return tuple(out)

    def model(self, t):
        return t.placements[self.mi] if self.mi is not None \
            else _pl()[1]()

    def data(self, t):
        return t.placements[self.di] if self.di is not None \
            else _pl()[1]()


def _activation(x, M: _Mesh, where: str):
    """x laid out as a block input: batch-sharded over data (or
    replicated), replicated over model; returns (x, its data
    placement)."""
    _, R, _ = _pl()
    pd = M.data(x)
    if not (pd.is_replicate() or (pd.is_shard() and pd.dim == 0)):
        pd = R()
    return move(x, M.placements(pd, R()), where), pd


def _local_act(x, M: _Mesh, pd, partial: bool):
    """x's local tensor; its gradient is partial over the model axis
    where the body's ranks compute different shares (Megatron's f)."""
    P, R, _ = _pl()
    return x.to_local(grad_placements=M.placements(
        pd, P() if partial else R()))


def _param(w, M: _Mesh, pd, partial: bool, where: str, model_to=None):
    """A weight's local tensor for a body: gathered over data where it
    is data-sharded (FSDP), moved to ``model_to`` over model where
    given.  Its gradient is partial over data where the batch is
    data-sharded, and over model where the weight is replicated there
    but the ranks' shares differ (``partial``)."""
    P, R, _ = _pl()
    want = list(w.placements)
    if M.di is not None and not want[M.di].is_replicate():
        want[M.di] = R()
    if model_to is not None and M.mi is not None:
        want[M.mi] = model_to
    w = move(w, want, where)
    grad = list(w.placements)
    if M.di is not None and pd.is_shard():
        grad[M.di] = P()
    if M.mi is not None and grad[M.mi].is_replicate() and partial:
        grad[M.mi] = P()
    return w.to_local(grad_placements=tuple(grad))


def _out(local, M: _Mesh, pd, partial: bool, where: str):
    """A body's (B, ...) result as a DTensor replicated over model: the
    ranks' partial sums all-reduced where ``partial``."""
    from torch.distributed.tensor import DTensor
    P, R, _ = _pl()
    t = DTensor.from_local(local, M.mesh, M.placements(
        pd, P() if partial else R()), run_check=False)
    return move(t, M.placements(pd, R()), where) if partial else t


def _reduce(local, M: _Mesh, pd, op: str, where: str):
    """``local`` reduced (``op``) over the model axis; a local tensor."""
    from torch.distributed.tensor import DTensor
    P, R, _ = _pl()
    t = DTensor.from_local(local, M.mesh, M.placements(pd, P(op)),
                           run_check=False)
    return move(t, M.placements(pd, R()), where).to_local()


def _local_rows(t, n: int):
    """A (B, ...) tensor or replicated DTensor's first ``n`` rows (the
    rows of a data shard: positions are the same in every row)."""
    t = t.to_local() if is_dtensor(t) else t
    return t if t.shape[0] == n else t[:n]


def _chunks(n: int, m: int) -> list[tuple[int, int]]:
    """torch.chunk's split of range(n) into m parts."""
    c = -(-n // m)
    return [(min(q * c, n), min((q + 1) * c, n)) for q in range(m)]


def _held(w, M: _Mesh, dim: int) -> list[tuple[int, int]]:
    """The range of ``w``'s dim ``dim`` each model rank holds."""
    n = w.shape[dim]
    pm = M.model(w)
    if pm.is_shard() and pm.dim % w.ndim == dim % w.ndim:
        return _chunks(n, M.m)
    return [(0, n)] * M.m


def _span(a, b, c, d):
    lo, hi = max(a, c), min(b, d)
    return (lo, hi) if lo < hi else None


def _ranges(need) -> list[tuple[int, int]]:
    """One rank's ``need``: a (lo, hi) range or a list of them."""
    return [need] if isinstance(need, tuple) else list(need)


def regroup(t, held, need, M: _Mesh, where: str):
    """``t``: this rank's (..., n) slice of the columns ``held[r]`` (one
    range a model rank) -> its columns ``need[r]`` (a range, or a list of
    ranges whose columns come in that order).  A slice where every rank's
    lie within what it holds; an all-gather where every rank needs every
    column from even shares; else one all-to-all over the model axis
    (each rank sends each other rank the columns it holds of those it
    needs).  Recorded with the result's bytes."""
    import torch.distributed._functional_collectives as funcol
    a, b = held[M.r]
    mine = _ranges(need[M.r])
    if all(lo <= na and nb <= hi for (lo, hi), n in zip(held, need)
           for na, nb in _ranges(n)):
        parts = [t[..., na - a:nb - a] for na, nb in mine] or [t[..., :0]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    total = max(hi for _, hi in held)
    src = t.movedim(-1, 0)
    if all(_ranges(n) == [(0, total)] for n in need) \
            and held == _chunks(total, M.m) and total % M.m == 0:
        gather = getattr(funcol, "all_gather_single_autograd", None) \
            or funcol.all_gather_tensor_autograd
        out = gather(src.contiguous(), 0, (M.mesh, M.mi))
        kind = "all-gather"
    else:
        # to rank q: the columns of need[q] this rank holds, in q's order;
        # from rank q: the pieces of this rank's ranges q holds, in order
        send = [[s for n in _ranges(need[q]) if (s := _span(a, b, *n))]
                for q in range(M.m)]
        recv = [[_span(*held[q], *n) for n in mine] for q in range(M.m)]
        parts = [src[lo - a:hi - a] for q in send for lo, hi in q]
        buf = torch.cat(parts) if parts else src[:0]
        out = funcol.all_to_all_single_autograd(
            buf.contiguous(),
            [sum(s[1] - s[0] for s in q if s) for q in recv],
            [sum(hi - lo for lo, hi in q) for q in send], (M.mesh, M.mi))
        if len(mine) > 1:       # the pieces to this rank's column order
            at, offs = 0, {}
            for q in range(M.m):
                for i, s in enumerate(recv[q]):
                    if s:
                        offs[i, q] = (at, at + s[1] - s[0])
                        at += s[1] - s[0]
            out = torch.cat([out[offs[i, q][0]:offs[i, q][1]]
                             for i in range(len(mine)) for q in range(M.m)
                             if (i, q) in offs])
        kind = "all-to-all"
    out = out.movedim(0, -1)
    to = ", ".join(f"[{na}, {nb})" for na, nb in mine)
    _note(where, f"columns [{a}, {b}) of {total} a rank",
          f"columns {to}", kind, _nbytes(out))
    return out


def all_to_all(t, M: _Mesh, where: str):
    """``jax.lax.all_to_all(t, model, 0, 0)`` of (m, ...) send buffers:
    block j to rank j; recorded."""
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_to_all_single_autograd(t.contiguous(), None, None,
                                            (M.mesh, M.mi))
    _note(where, "block j of each rank", "rank j", "all-to-all",
          _nbytes(out))
    return out


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------
def embed(table, tokens):
    """``table[tokens]``, vocab-parallel where the table is sharded over
    model on its rows and replicated over data."""
    M = _Mesh(table)
    P, R, Sh = _pl()
    pm = M.model(table)
    if M.mi is None or not (pm.is_shard() and pm.dim == 0) \
            or not M.data(table).is_replicate():
        return table[tokens]
    tok = tokens.to_local() if is_dtensor(tokens) else tokens
    pd = M.data(tokens) if is_dtensor(tokens) else R()
    tl = table.to_local(grad_placements=M.placements(
        P() if pd.is_shard() else R(), Sh(0)))
    rel = tok.long() - M.r * tl.shape[0]
    inside = (rel >= 0) & (rel < tl.shape[0])
    rows = tl[torch.where(inside, rel, torch.zeros_like(rel))] \
        * inside[..., None].to(tl.dtype)
    return _out(rows, M, pd, True, "embedding: vocab-parallel rows")


def token_logprobs(logits, labels):
    """log_softmax(logits)[label] per token, vocab-parallel where the
    logits are sharded over model on their last dim."""
    from torch.distributed.tensor import DTensor
    M = _Mesh(logits)
    _, R, _ = _pl()
    pm = M.model(logits)
    if M.mi is None or not (pm.is_shard()
                            and pm.dim % logits.ndim == logits.ndim - 1):
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, labels[..., None].long())[..., 0]
    pd = M.data(logits)
    ll = logits.to_local(grad_placements=logits.placements)
    lab = _local_rows(labels, ll.shape[0]).long()
    mx = _reduce(ll.detach().amax(-1), M, pd, "max",
                 "loss: max over the vocab shards")
    se = _reduce(torch.exp(ll - mx[..., None]).sum(-1), M, pd, "sum",
                 "loss: sum of exponentials over the vocab shards")
    rel = lab - M.r * ll.shape[-1]
    inside = (rel >= 0) & (rel < ll.shape[-1])
    pick = torch.gather(ll, -1, torch.where(
        inside, rel, torch.zeros_like(rel))[..., None])[..., 0] \
        * inside.to(ll.dtype)
    pick = _reduce(pick, M, pd, "sum", "loss: the label's logit")
    return DTensor.from_local(pick - mx - torch.log(se), M.mesh,
                              M.placements(pd, R()), run_check=False)


def attention(cfg, p, x, *, positions, cache, causal: bool):
    """``layers.attention`` on DTensors (module docstring)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import layers as L
    _, R, _ = _pl()
    M = _Mesh(x)
    x, pd = _activation(x, M, "attention: input")
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g, m = h // kv, M.m
    pk = M.model(cache.k) if cache is not None else None
    by_slot = pk is not None and pk.is_shard() and pk.dim == 1
    if by_slot:
        q_need = [(0, h)] * m
    elif h % m == 0:
        q_need = [(q * h // m, (q + 1) * h // m) for q in range(m)]
    else:
        q_need = _chunks(h, m)
    if cache is not None and not by_slot and pk.is_replicate():
        kv_need = [(0, kv)] * m             # every rank writes every head
    else:
        kv_need = [(a // g, (b - 1) // g + 1) if b > a else (0, 0)
                   for a, b in q_need]
    partial = m > 1
    xl = _local_act(x, M, pd, partial)
    B, S, _ = xl.shape

    def project(name, need):
        wl = _param(p[name], M, pd, partial, f"attention: {name}")
        return regroup(xl @ wl, _held(p[name], M, -1),
                       [(a * hd, b * hd) for a, b in need], M,
                       f"attention: {name}'s output to the head-aligned "
                       f"layout").reshape(B, S, -1, hd)
    q, k, v = project("wq", q_need), project("wk", kv_need), \
        project("wv", kv_need)
    if cfg.qk_norm:
        q = L.rmsnorm(q, _param(p["q_norm"], M, pd, partial, "q_norm"),
                      cfg.norm_eps)
        k = L.rmsnorm(k, _param(p["k_norm"], M, pd, partial, "k_norm"),
                      cfg.norm_eps)
    pos = _local_rows(positions, B)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)

    if cache is None:
        keys, vals, key_pos = k, v, pos
    else:
        Mc = cache.k.shape[1]
        ck, cv = cache.k.to_local(), cache.v.to_local()
        slots = (pos[0] % Mc).long()
        sp = cache.slot_pos
        spl = sp.to_local()
        if by_slot:
            # this rank's slots; a new token whose slot lies elsewhere
            # leaves them as they were
            lo = M.r * ck.shape[1]
            rel = slots - lo
            inside = (rel >= 0) & (rel < ck.shape[1])
            idx = rel.clamp(0, ck.shape[1] - 1)

            def write(c, new, dim):
                shape = [1] * new.dim()
                shape[dim] = -1
                keep = inside.reshape(shape)
                return c.index_copy(dim, idx, torch.where(
                    keep, new.to(c.dtype), c.index_select(dim, idx)))
            ck, cv = write(ck, k, 1), write(cv, v, 1)
            spl = write(spl, pos[0], 0)
            key_pos = spl[None, :]
        else:
            ck = ck.index_copy(1, slots, k.to(ck.dtype))
            cv = cv.index_copy(1, slots, v.to(cv.dtype))
            full = move(sp, M.placements(M.data(sp), R()),
                        "attention: slot positions").to_local() \
                if M.model(sp).is_shard() else spl
            full = full.index_copy(0, slots, pos[0].to(full.dtype))
            lo, hi = _held(sp, M, 0)[M.r]
            spl = full[lo:hi] if M.model(sp).is_shard() else full
            key_pos = full[None, :]
        keys, vals = ck, cv
        cache = type(cache)(*(
            DTensor.from_local(t, c.device_mesh, c.placements,
                               run_check=False, shape=c.shape,
                               stride=c.stride())
            for t, c in zip((ck, cv, spl), cache)))

    (qa, qb), (ka, kb) = q_need[M.r], kv_need[M.r]
    if qb - qa == (kb - ka) * g and qa == ka * g:
        qg = q.reshape(B, S, kb - ka, g, hd)
    else:       # this rank's q heads read kv heads out of group order
        sel = torch.tensor([j // g - ka for j in range(qa, qb)],
                           device=keys.device)
        keys, vals = keys.index_select(2, sel), vals.index_select(2, sel)
        qg = q.reshape(B, S, qb - qa, 1, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), keys.float())
    scores = scores / math.sqrt(hd)
    qp = pos[:, None, None, :, None].int()
    kp = key_pos[:, None, None, None, :].int()
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if cfg.sliding_window:
        valid = valid & (kp > qp - cfg.sliding_window)
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    if by_slot:
        # flash-decoding: each rank's slots, the softmax combined over
        # the model axis
        mx = _reduce(scores.detach().amax(-1), M, pd, "max",
                     "attention: softmax max over the slot shards")
        e = torch.exp(scores - mx[..., None])
        den = _reduce(e.sum(-1), M, pd, "sum",
                      "attention: softmax sum over the slot shards")
        num = _reduce(torch.einsum("bkgst,btkh->bskgh", e.to(xl.dtype),
                                   vals.to(xl.dtype)), M, pd, "sum",
                      "attention: weighted values over the slot shards")
        y = (num / den.permute(0, 3, 1, 2)[..., None]).to(xl.dtype)
    else:
        w = torch.softmax(scores.float(), dim=-1).to(xl.dtype)
        y = torch.einsum("bkgst,btkh->bskgh", w, vals.to(xl.dtype))
    y = y.reshape(B, S, -1)

    wo = p["wo"]
    rows = _held(wo, M, 0)
    cols = [(a * hd, b * hd) for a, b in q_need]
    if M.model(wo).is_replicate():
        # every rank the whole product, the same on each
        y = regroup(y, cols, [(0, h * hd)] * m, M,
                    "attention: output heads to every rank")
        out = y @ _param(wo, M, pd, False, "attention: wo")
        return _out(out, M, pd, False, ""), cache
    y = regroup(y, cols, rows, M, "attention: output heads to wo's rows")
    out = y @ _param(wo, M, pd, partial, "attention: wo")
    return _out(out, M, pd, partial,
                "attention: row-parallel wo, partial sums"), cache


def swiglu(p, x):
    """``layers.swiglu`` on DTensors: column-parallel wg, wu and
    row-parallel wd where the hidden dim is sharded over model; else
    every weight gathered over model and the product replicated."""
    from repro_torch.models import layers as L
    _, R, Sh = _pl()
    M = _Mesh(x)
    x, pd = _activation(x, M, "swiglu: input")
    tp = M.mi is not None and M.m > 1 \
        and all(M.model(p[n]) == Sh(1) for n in ("wg", "wu")) \
        and M.model(p["wd"]) == Sh(0)
    to = None if tp else R()
    xl = _local_act(x, M, pd, tp)
    wg, wu, wd = (_param(p[n], M, pd, tp, f"swiglu: {n}", to)
                  for n in ("wg", "wu", "wd"))
    out = (L.silu(xl @ wg) * (xl @ wu)) @ wd
    return _out(out, M, pd, tp, "swiglu: row-parallel wd, partial sums")


def _ep_applies(cfg, M: _Mesh, B: int, S: int) -> bool:
    """``moe_ep.ep_enabled``'s conditions on the DeviceMesh."""
    if _PASS is None or not _PASS.ep or M.mi is None or M.m < 2:
        return False
    E, m = cfg.num_experts, M.m
    if E % m or E < m or B % M.dn:
        return False
    return (B // M.dn) * S % m == 0


def moe(cfg, p, x):
    """``layers.moe`` on DTensors (module docstring)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import layers as L
    from repro_torch.models import moe_ep
    P, R, Sh = _pl()
    M = _Mesh(x)
    x, pd = _activation(x, M, "moe: input")
    B, S, d = x.shape
    E, m = cfg.num_experts, M.m
    ep = _ep_applies(cfg, M, B, S)
    if ep:
        _PASS.ep_layers += 1
        xl = _local_act(x, M, pd, True)
        Bl = xl.shape[0]
        T_all = Bl * S
        T = T_all // m
        xt = xl.reshape(T_all, d)[M.r * T:(M.r + 1) * T]
        router = _param(p["router"], M, pd, True, "moe: router",
                        model_to=R())
        w = {n: _param(p[n], M, pd, False, f"moe: {n} to expert shards",
                       model_to=Sh(0)) for n in ("wg", "wu", "wd")}
        send_x, send_e, pair_slot, gate, aux = moe_ep._route(cfg, xt,
                                                             router, m)
        recv_x = all_to_all(send_x, M, "moe: tokens to their experts")
        recv_e = all_to_all(send_e, M, "moe: expert ids to their experts")
        back = moe_ep._experts(recv_x, recv_e, w["wg"], w["wu"], w["wd"])
        ret = all_to_all(back, M, "moe: expert outputs back")
        y = moe_ep._combine(ret, pair_slot, gate, M.r, T_all)
        y = _out(y.reshape(Bl, S, d), M, pd, True,
                 "moe: combined tokens over the model axis (psum)")
        parts = M.placements(P() if pd.is_shard() else R(), P())
        aux = DTensor.from_local(aux / (M.dn * m if pd.is_shard() else m),
                                 M.mesh, parts, run_check=False)
        return y, move(aux, M.placements(R(), R()), "moe: aux (pmean)")
    # the local dispatch: the rank's tokens, the weights where they lie
    shard = {n: M.model(p[n]) for n in ("wg", "wu", "wd")}
    by_expert = all(s == Sh(0) for s in shard.values())
    within = shard["wg"] == Sh(2) and shard["wu"] == Sh(2) \
        and shard["wd"] == Sh(1)
    split = M.mi is not None and m > 1 and (by_expert or within)
    to = None if split else R()
    xl = _local_act(x, M, pd, split)
    Bl = xl.shape[0]
    router = _param(p["router"], M, pd, split, "moe: router",
                    model_to=R())
    w = {n: _param(p[n], M, pd, split, f"moe: {n}", to)
         for n in ("wg", "wu", "wd")}
    experts = _chunks(E, m)[M.r] if split and by_expert else None
    y, aux = L.moe_local(cfg, router, w["wg"], w["wu"], w["wd"],
                         xl.reshape(Bl * S, d), experts=experts)
    y = _out(y.reshape(Bl, S, d), M, pd, split,
             "moe: combined tokens over the model axis")
    if M.di is not None and pd.is_shard():
        aux = move(DTensor.from_local(aux / M.dn, M.mesh,
                                      M.placements(P(), R()),
                                      run_check=False),
                   M.placements(R(), R()), "moe: aux over data shards")
    else:
        aux = DTensor.from_local(aux, M.mesh, M.placements(R(), R()),
                                 run_check=False)
    return y, aux


# ---------------------------------------------------------------------------
# The recurrent mixers: head-local bodies
# ---------------------------------------------------------------------------
class _SumShares(torch.autograd.Function):
    """The ranks' shares summed over the model axis, where each rank then
    uses the sum on its own columns: an all-reduce forward, and the
    ranks' gradient shares all-reduced backward (the sum's gradient is
    theirs together)."""

    @staticmethod
    def forward(ctx, local, M, pd, where):
        ctx.args = (M, pd, where)
        return _reduce(local, M, pd, "sum", where)

    @staticmethod
    def backward(ctx, g):
        M, pd, where = ctx.args
        return _reduce(g, M, pd, "sum", f"{where} (backward)"), None, None, \
            None


class _GradScale(torch.autograd.Function):
    """The identity, its gradient scaled by ``s``: a value that every rank
    computes alike, entering a body whose input gradients are the ranks'
    shares, contributes 1/m of its gradient on each rank."""

    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _cols(w, M: _Mesh, pd, partial: bool, need, where: str, dim: int = -1):
    """The range ``need[M.r]`` of weight ``w``'s dim ``dim`` (columns, or
    rows with -2), local: a slice of what the rank holds, or of ``w``
    gathered over model where a rank does not hold its range
    (recorded)."""
    _, R, _ = _pl()
    lo, hi = need[M.r]
    pm = M.model(w)
    own = [(0, w.shape[dim])] * M.m if not pm.is_shard() \
        else _held(w, M, dim) if pm.dim % w.ndim == dim % w.ndim else None
    to = None
    if own is None or not all(a <= c and e <= b
                              for (a, b), (c, e) in zip(own, need)):
        to, own = R(), [(0, w.shape[dim])] * M.m
    wl = _param(w, M, pd, partial, where, model_to=to)
    return wl.narrow(dim, lo - own[M.r][0], hi - lo)


def _rmsnorm(y, w, n: int, eps: float, M: _Mesh, pd, where: str):
    """``layers.rmsnorm`` over ``n`` columns of which this rank holds
    ``y``'s (and ``w``'s): the sum of squares summed over the model
    axis."""
    y32 = y.float()
    ss = (y32 * y32).sum(dim=-1, keepdim=True)
    if M.m > 1:
        ss = _SumShares.apply(ss, M, pd, where)
    return (y32 * torch.rsqrt(ss / n + eps) * w.float()).to(y.dtype)


def _on(t, M: _Mesh, dim: int):
    """``t``'s model placement, as Replicate where it shards another dim
    than ``dim`` (such a state is gathered whole over model first)."""
    pm = M.model(t)
    return pm if not pm.is_shard() or pm.dim % t.ndim == dim % t.ndim \
        else _pl()[1]()


def _state_in(t, M: _Mesh, pd, dim: int, need, where: str):
    """A recurrent state's range ``need[M.r]`` of dim ``dim``, local, read
    where it lies (a slice; moved only where it lies elsewhere)."""
    t = move(t, M.placements(pd, _on(t, M, dim)), where)
    return regroup(t.to_local().movedim(dim, -1), _held(t, M, dim), need,
                   M, where).movedim(-1, dim)


def _state_out(local, like, shape, M: _Mesh, pd, dim: int, need,
               where: str):
    """A new state from this rank's range ``need[M.r]`` of dim ``dim``, in
    the placements of the state ``like`` it replaces, or with no ``like``
    where it was computed (split over model as ``need`` splits it)."""
    from torch.distributed.tensor import DTensor
    _, R, Sh = _pl()
    whole = [(0, shape[dim])] * M.m
    if like is None:
        pm = R() if need == whole else Sh(dim)
    else:
        pm = _on(like, M, dim)
        own = _chunks(shape[dim], M.m) if pm.is_shard() else whole
        if own != need:
            local = regroup(local.movedim(dim, -1), need, own, M,
                            where).movedim(-1, dim)
    out = DTensor.from_local(local, M.mesh, M.placements(pd, pm),
                             run_check=False, shape=torch.Size(shape),
                             stride=torch.empty(shape,
                                                device="meta").stride())
    return out if like is None else move(out, like.placements, where)


def rwkv6(cfg, p, x, state):
    """``layers.rwkv6`` on DTensors: each rank its heads (ceil(nh / m)
    where m does not divide nh).  Token shift on the replicated input;
    r, k, v, w and g from the columns of the rank's heads (``ww``
    column-sharded at full width, sliced where replicated); the WKV
    recurrence on the rank's (B, nh/m, 64, 64) state, never gathered;
    ``ln_x``'s norm one all-reduce of the sum of squares, ``wo``
    row-parallel: one all-reduce.  Channel-mix: ``ck`` column- and
    ``cv`` row-parallel (one all-reduce); a replicated ``cr`` computes
    its gate whole on every rank, a column-sharded one (full width) the
    gate's columns, which multiply the all-reduced ``cv`` product's
    there, as XLA's partitioner does; the gated columns are all-gathered
    once (XLA leaves the block's output sharded over d and gathers it
    again before each of the next layer's seven projections).  The states
    keep their placements: ``wkv`` head-sharded, ``x_tm`` and ``x_cm``
    replicated over model."""
    from repro_torch.models import layers as L
    _, R, Sh = _pl()
    M = _Mesh(x)
    x, pd = _activation(x, M, "rwkv6: input")
    B, S, d = x.shape
    hd = L.RWKV_HD
    nh, ff, m = d // hd, cfg.d_ff, M.m
    heads = _chunks(nh, m)
    cols = [(a * hd, b * hd) for a, b in heads]
    nr = heads[M.r][1] - heads[M.r][0]
    whole = [(0, d)] * m
    partial = m > 1
    xl = _local_act(x, M, pd, partial)
    Bl = xl.shape[0]

    def col(name, need=cols, dim=-1):
        return _cols(p[name], M, pd, partial, need, f"rwkv6: {name}", dim)
    if state is None:
        wkv = torch.zeros((Bl, nr, hd, hd), dtype=torch.float32,
                          device=xl.device)
        x_tm, x_cm = xl.new_zeros((Bl, d)), xl.new_zeros((Bl, d))
    else:
        wkv = _state_in(state.wkv, M, pd, 1, heads, "rwkv6: wkv state")
        x_tm = _state_in(state.x_tm, M, pd, 1, whole, "rwkv6: x_tm state")
        x_cm = _state_in(state.x_cm, M, pd, 1, whole, "rwkv6: x_cm state")

    # time-mix, head-local
    prev, new_last = L._token_shift(xl, x_tm)
    mu = _param(p["mu"], M, pd, partial, "rwkv6: mu")

    def mix(i):
        return xl * mu[i] + prev * (1 - mu[i])
    r = (mix(0) @ col("wr")).reshape(Bl, S, nr, hd)
    k = (mix(1) @ col("wk")).reshape(Bl, S, nr, hd)
    v = (mix(2) @ col("wv")).reshape(Bl, S, nr, hd)
    wlog = -torch.exp((mix(3) @ col("ww")).float() + col("w_bias"))
    w = torch.exp(wlog).reshape(Bl, S, nr, hd)
    gt = L.silu(mix(4) @ col("wg"))
    y, wkv = L.wkv_scan(r, k, v, w, col("u").reshape(nr, hd), wkv)
    y = y.reshape(Bl, S, nr * hd).to(xl.dtype)
    y = _rmsnorm(y, col("ln_x"), d, cfg.norm_eps, M, pd,
                 "rwkv6: ln_x's sum of squares") * gt
    y = _out(y @ col("wo", cols, -2), M, pd, partial,
             "rwkv6: row-parallel wo, partial sums")

    # channel-mix
    xc = x + y
    xcl = _local_act(xc, M, pd, partial)
    prev_c, new_last_c = L._token_shift(xcl, x_cm)
    mu_cm = _param(p["mu_cm"], M, pd, partial, "rwkv6: mu_cm")

    def mixc(i):
        return xcl * mu_cm[i] + prev_c * (1 - mu_cm[i])
    fcols = _chunks(ff, m)
    kk = torch.square(torch.relu(mixc(0) @ col("ck", fcols)))
    kv = kk @ col("cv", fcols, -2)
    if m == 1 or M.model(p["cr"]).is_replicate():
        gate = _GradScale.apply(mixc(1), 1 / m)
        out_c = _reduce(kv, M, pd, "sum",
                        "rwkv6: row-parallel cv, partial sums") \
            * L.sigmoid(gate @ _param(p["cr"], M, pd, False, "rwkv6: cr"))
        out_c = _out(out_c, M, pd, False, "")
    else:
        from torch.distributed.tensor import DTensor
        dcols = _chunks(d, m)
        a, b = dcols[M.r]
        kv = _SumShares.apply(kv, M, pd,
                              "rwkv6: row-parallel cv, partial sums")
        gated = kv[..., a:b] * L.sigmoid(mixc(1) @ col("cr", dcols))
        out_c = move(DTensor.from_local(
            gated, M.mesh, M.placements(pd, Sh(2)), run_check=False,
            shape=x.shape, stride=x.stride()), M.placements(pd, R()),
            "rwkv6: gated channel-mix columns to every rank")
    new = L.RWKVState(
        wkv=_state_out(wkv, None if state is None else state.wkv,
                       (B, nh, hd, hd), M, pd, 1, heads, "rwkv6: wkv state"),
        x_tm=_state_out(new_last, None if state is None else state.x_tm,
                        (B, d), M, pd, 1, whole, "rwkv6: x_tm state"),
        x_cm=_state_out(new_last_c, None if state is None else state.x_cm,
                        (B, d), M, pd, 1, whole, "rwkv6: x_cm state"))
    return y + out_c, new


def _mamba_cols(cfg, heads) -> list[list[tuple[int, int]]]:
    """Each rank's columns of ``in_proj``'s output for its heads [a, b):
    z and xs of those heads, B and C of the groups they read, their dt."""
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    nh, ds, G = cfg.n_mamba_heads, cfg.ssm_state, cfg.ssm_groups
    hp, rep = inner // nh, nh // G
    o = 2 * inner
    out = []
    for a, b in heads:
        ga, gb = (a // rep, (b - 1) // rep + 1) if b > a else (0, 0)
        out.append([(a * hp, b * hp), (inner + a * hp, inner + b * hp),
                    (o + ga * ds, o + gb * ds),
                    (o + (G + ga) * ds, o + (G + gb) * ds),
                    (o + 2 * G * ds + a, o + 2 * G * ds + b)])
    return out


def _mamba(cfg, p, x, state, chunk: int, step: bool):
    from repro_torch.models import layers as L
    import torch.nn.functional as F
    M = _Mesh(x)
    x, pd = _activation(x, M, "mamba2: input")
    B, S, d = x.shape
    inner = cfg.ssm_expand * d
    nh, ds, G = cfg.n_mamba_heads, cfg.ssm_state, cfg.ssm_groups
    hp, rep, m = inner // nh, nh // G, M.m
    heads = _chunks(nh, m)
    h0, h1 = heads[M.r]
    nr = h1 - h0
    g0 = h0 // rep if nr else 0
    chans = [(a * hp, b * hp) for a, b in heads]
    partial = m > 1
    xl = _local_act(x, M, pd, partial)
    Bl = xl.shape[0]

    def col(name, need=heads, dim=-1):
        return _cols(p[name], M, pd, partial, need, f"mamba2: {name}", dim)
    w = p["in_proj"]
    proj = regroup(xl @ _param(w, M, pd, partial, "mamba2: in_proj"),
                   _held(w, M, -1), _mamba_cols(cfg, heads), M,
                   "mamba2: in_proj's output to the head-aligned layout")
    ng = (((h1 - 1) // rep + 1) - g0) if nr else 0
    z, xs, Bm, Cm, dt = torch.split(
        proj, [nr * hp, nr * hp, ng * ds, ng * ds, nr], dim=-1)
    tail = None if state is None else _state_in(
        state.conv, M, pd, 2, chans, "mamba2: conv tail")
    xs, new_tail = L._causal_conv(xs, col("conv_w", chans), tail)
    dt = F.softplus(dt.float() + col("dt_bias"))
    A = -torch.exp(col("A_log"))
    grp = torch.tensor([h // rep - g0 for h in range(h0, h1)],
                       dtype=torch.long, device=xl.device)
    if state is None:
        h = torch.zeros((Bl, nr, hp, ds), dtype=torch.float32,
                        device=xl.device)
    else:
        h = _state_in(state.h, M, pd, 1, heads, "mamba2: ssm state").float()
    if step:
        xh = xs.reshape(Bl, nr, hp).float()
        Bh = Bm.reshape(Bl, ng, ds).index_select(1, grp).float()
        Ch = Cm.reshape(Bl, ng, ds).index_select(1, grp).float()
        y, h = L.ssd_step(xh, Bh, Ch, dt[:, 0], A, col("D"), h)
    else:
        xh = xs.reshape(Bl, S, nr, hp).float()
        Bh = Bm.reshape(Bl, S, ng, ds).index_select(2, grp).float()
        Ch = Cm.reshape(Bl, S, ng, ds).index_select(2, grp).float()
        y, h = L.ssd_chunked(xh, Bh, Ch, dt, A, col("D"), h, chunk)
    y = y.reshape(Bl, S, nr * hp).to(xl.dtype) * L.silu(z)
    y = _rmsnorm(y, col("gate_norm", chans), inner, cfg.norm_eps, M, pd,
                 "mamba2: gate_norm's sum of squares")
    out = _out(y @ col("out_proj", chans, -2), M, pd, partial,
               "mamba2: row-parallel out_proj, partial sums")
    new = L.MambaState(
        h=_state_out(h, None if state is None else state.h,
                     (B, nh, hp, ds), M, pd, 1, heads, "mamba2: ssm state"),
        conv=_state_out(new_tail, None if state is None else state.conv,
                        (B, L.CONV_K - 1, inner), M, pd, 2, chans,
                        "mamba2: conv tail"))
    return out, new


def mamba2(cfg, p, x, state, chunk: int):
    """``layers.mamba2`` on DTensors: each rank its heads (ceil(nh / m)
    where m does not divide nh).  ``in_proj`` column-parallel, its output
    moved by one ``regroup`` to the rank's z and xs columns, the B and C
    of the groups its heads read and their dt; from there on head-local:
    the causal conv over its channels (and its share of the conv tail,
    which lies there), softplus, the chunked SSD on its (B, nh/m, hp, ds)
    state; ``gate_norm``'s norm one all-reduce of the sum of squares,
    ``out_proj`` row-parallel: one all-reduce.  The states keep their
    placements."""
    return _mamba(cfg, p, x, state, chunk, step=False)


def mamba2_step(cfg, p, x, state):
    """``layers.mamba2_step`` on DTensors: ``mamba2``'s body with one
    SSD step."""
    return _mamba(cfg, p, x, state, 0, step=True)
