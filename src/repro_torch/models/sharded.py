"""The dry-run's sharded step: per-rank bodies of the model's
communicating layers, on DTensors.

``launch/dryrun.py`` counts a cell's collectives by running the port's
step on DTensors over a (pod x data, model) DeviceMesh under a fake
process group.  Left to DTensor's sharding propagation, that step
all-gathers the vocab-sharded embedding table and logits, q, k and v at
their reshape into heads, the SwiGLU hidden layer and the MoE slot
slabs: another program than the JAX package's, which XLA's partitioner
lays out as a Megatron-style step.  The helpers of ``models/layers.py``
(``embed``, ``token_logprobs``, ``attention``, ``swiglu``, ``moe``) call
the bodies below when they are handed DTensors; on plain tensors they
run the ops they always ran.

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


def regroup(t, held, need, M: _Mesh, where: str):
    """``t``: this rank's (..., n) slice of the columns ``held[r]`` (one
    range a model rank) -> its (..., columns ``need[r]``).  A slice
    where they lie within what it holds; an all-gather where every rank
    needs every column; else one all-to-all over the model axis (each
    rank sends each other rank the columns it holds of those it needs).
    Recorded with the result's bytes."""
    import torch.distributed._functional_collectives as funcol
    a, b = held[M.r]
    na, nb = need[M.r]
    if a <= na and nb <= b:
        return t[..., na - a:nb - a]
    total = max(hi for _, hi in held)
    src = t.movedim(-1, 0)
    if all(n == (0, total) for n in need) and held == _chunks(total, M.m):
        gather = getattr(funcol, "all_gather_single_autograd", None) \
            or funcol.all_gather_tensor_autograd
        out = gather(src.contiguous(), 0, (M.mesh, M.mi))
        kind = "all-gather"
    else:
        send = [_span(a, b, *need[q]) for q in range(M.m)]
        recv = [_span(*held[q], na, nb) for q in range(M.m)]
        parts = [src[lo - a:hi - a] for lo, hi in filter(None, send)]
        buf = torch.cat(parts) if parts else src[:0]
        out = funcol.all_to_all_single_autograd(
            buf.contiguous(), [s[1] - s[0] if s else 0 for s in recv],
            [s[1] - s[0] if s else 0 for s in send], (M.mesh, M.mi))
        kind = "all-to-all"
    out = out.movedim(0, -1)
    _note(where, f"columns [{a}, {b}) of {total} a rank",
          f"columns [{na}, {nb})", kind, _nbytes(out))
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
