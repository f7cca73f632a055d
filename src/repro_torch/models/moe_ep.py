"""Expert-parallel MoE over a mesh: the port of ``repro.models.moe_ep``.

The baseline ``layers.moe`` gathers every token into one slot table.  Here
tokens travel to the model shard that owns their experts, and back, with
``mesh.all_to_all`` over the ``model`` axis, so a shard moves
O(T_loc * topk * d) bytes, not O(T * d); the sort-based capacity dispatch
is reused locally on each shard.

The JAX package writes the shard's work once, as a ``shard_map`` body;
the port runs it once a mesh position (one controller, as in
``launch.mesh``), phase by phase, with the collectives between the
phases: route and fill the send buffer, ``all_to_all`` of the tokens and
their local expert ids, the local dispatch and SwiGLU, ``all_to_all``
back, the combine at the source, ``psum`` over the model axis, and the
aux loss's ``pmean``.  Where JAX scatter-adds (``.at[].add``) the port
gathers: a received row takes its slot's output, and a token sums its K
expert outputs in top-k order, so every sum has a fixed order and two
runs on the card agree bitwise.  Autograd through the indexing and the
collectives gives the gradients, as JAX's transposes do.

Enabled by setting the module global ``EP_MESH`` (the JAX package's
``launch/partition.py`` does so; here the caller does) when num_experts
divides the model-axis size."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import all_to_all, data_axes, pmean, psum
from repro_torch.models import layers as L

# Set by the caller before the forward pass; None = disabled.
EP_MESH = None
EP_AXIS = "model"


def ep_enabled(cfg: ModelConfig, x_shape: tuple | None = None) -> bool:
    if (EP_MESH is None or EP_AXIS not in EP_MESH.axis_names
            or cfg.num_experts % EP_MESH.shape[EP_AXIS] != 0
            or cfg.num_experts < EP_MESH.shape[EP_AXIS]):
        return False
    if x_shape is not None:
        B, S = x_shape[0], x_shape[1]
        dsize = 1
        for a in EP_MESH.axis_names:
            if a in ("pod", "data"):
                dsize *= EP_MESH.shape[a]
        if B % dsize != 0:
            return False
        t_loc = (B // dsize) * S
        if t_loc % EP_MESH.shape[EP_AXIS] != 0:
            return False                  # decode with tiny local batches
    return True


def _send_capacity(cfg: ModelConfig, t_loc: int, n_shards: int) -> int:
    c = math.ceil(t_loc * cfg.experts_per_token
                  * cfg.moe_capacity_factor / n_shards)
    return max(8, -(-c // 8) * 8)


def _expert_capacity(cfg: ModelConfig, n_recv: int, e_loc: int) -> int:
    c = math.ceil(n_recv * cfg.moe_capacity_factor / e_loc)
    return max(8, -(-c // 8) * 8)


def _route(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor,
           n_shards: int):
    """A shard's T tokens: top-k routing, then the first hop's send
    buffers, the T*K assignments grouped by destination shard (Cs slots a
    shard; an assignment past Cs goes to a trash slot past the buffer).
    Returns (send_x (n, Cs, d), send_e (n, Cs) local expert ids with
    E_loc as padding, each assignment's send slot (T, K) with the trash
    slot n*Cs for a drop, gates (T, K), aux)."""
    T, d = xt.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    E_loc = E // n_shards
    dev = xt.device

    logits = xt.float() @ router                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    flat_e = eidx.reshape(-1)                                 # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    dest = flat_e // E_loc                                    # owning shard
    order = torch.sort(dest, stable=True).indices
    s_dest, s_e, s_t = dest[order], flat_e[order], flat_t[order]
    Cs = _send_capacity(cfg, T, n_shards)
    counts = L.count_ids(s_dest, n_shards)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[s_dest]
    slot = torch.where(rank < Cs, s_dest * Cs + rank,
                       torch.full_like(s_dest, n_shards * Cs))

    def fill(src, init):
        buf = torch.full((n_shards * Cs + 1,) + tuple(src.shape[1:]), init,
                         dtype=src.dtype, device=dev)
        return buf.index_put((slot,), src)[:-1]

    send_x = fill(xt[s_t], 0).reshape(n_shards, Cs, d)
    send_e = fill((s_e % E_loc).to(torch.int32), E_loc).reshape(n_shards,
                                                                Cs)
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot

    # router load-balance aux (this shard's estimate)
    me = probs.mean(dim=0)
    ce = L.count_ids(eidx, E) / (T * K)
    aux = E * torch.sum(me * ce)
    return send_x, send_e, pair_slot.reshape(T, K), gate, aux


def _experts(recv_x: torch.Tensor, recv_e: torch.Tensor, wg, wu, wd):
    """The local dispatch of the received rows to this shard's E_loc
    experts (sort-based, capacity Cl an expert), SwiGLU, and each
    received row's output back in the received layout (zero for a row
    that is padding or past capacity)."""
    n, Cs, d = recv_x.shape
    R = n * Cs
    E_loc = wg.shape[0]
    dev = recv_x.device
    rx = recv_x.reshape(R, d)
    re = recv_e.reshape(R).long()                 # local expert id
    key = torch.where(re < E_loc, re, torch.full_like(re, E_loc))

    Cl = max(8, -(-R // E_loc // 8) * 8)
    order2 = torch.sort(key, stable=True).indices
    r_e = re[order2]
    counts2 = L.count_ids(key[order2], E_loc + 1)[:E_loc]
    starts2 = torch.cumsum(counts2, 0) - counts2
    r_c = r_e.clamp(0, E_loc - 1)
    rank2 = torch.arange(R, device=dev) - starts2[r_c]
    keep2 = (r_e < E_loc) & (rank2 < Cl)
    slot2 = torch.where(keep2, r_c * Cl + rank2,
                        torch.full_like(r_c, E_loc * Cl))  # trash slot
    slot_src = torch.zeros(E_loc * Cl + 1, dtype=torch.long, device=dev)
    slot_src.index_put_((slot2,), order2)
    slot_src = slot_src[:-1]

    xe = rx[slot_src].reshape(E_loc, Cl, d)
    h = L.silu(torch.einsum("ecd,edf->ecf", xe, wg)) \
        * torch.einsum("ecd,edf->ecf", xe, wu)
    ye = torch.einsum("ecf,efd->ecd", h, wd).reshape(E_loc * Cl, d)

    # undo the local dispatch: each received row its slot's output
    row_slot = torch.empty_like(slot2)
    row_slot[order2] = slot2
    back = torch.cat([ye, ye.new_zeros((1, d))])[row_slot]
    return back.reshape(n, Cs, d)


def _combine(ret: torch.Tensor, pair_slot: torch.Tensor, gate: torch.Tensor,
             midx: int, T_all: int) -> torch.Tensor:
    """At the source: each of the shard's T tokens sums its K returned
    expert rows, gate-weighted, in top-k order (a dropped assignment adds
    zero), placed at the shard's slice of the (T_all, d) local buffer,
    zeros elsewhere."""
    n, Cs, d = ret.shape
    T, K = pair_slot.shape
    rows = torch.cat([ret.reshape(n * Cs, d), ret.new_zeros((1, d))])
    picked = rows[pair_slot]                                  # (T, K, d)
    w = gate.to(ret.dtype)
    y = torch.zeros((T, d), dtype=ret.dtype, device=ret.device)
    for j in range(K):
        y = y + picked[:, j] * w[:, j, None]
    return F.pad(y, (0, 0, midx * T, T_all - (midx + 1) * T))


def moe_expert_parallel(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, d) -> (y, aux) on x's device, over the mesh ``EP_MESH``:
    the batch split over its data axes (``pod``, ``data``) where B divides
    into them, the experts over its ``model`` axis."""
    mesh = EP_MESH
    if mesh is None or EP_AXIS not in mesh.axis_names:
        raise ValueError("moe_expert_parallel: EP_MESH is not set to a "
                         "mesh with a 'model' axis")
    n_shards = mesh.shape[EP_AXIS]
    E = cfg.num_experts
    if E % n_shards or E < n_shards:
        raise ValueError(f"{E} experts over {n_shards} model shards")
    E_loc = E // n_shards
    daxes = data_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in daxes)
    B, S, d = x.shape
    sharded = bool(daxes) and B % dsize == 0
    Bl = B // dsize if sharded else B
    T_all = Bl * S
    if T_all % n_shards:
        raise ValueError(f"{T_all} local tokens over {n_shards} model "
                         f"shards (ep_enabled guards this)")
    T = T_all // n_shards

    # one group of model positions a data shard (the batch replicated over
    # the data axes computes one group: the others would repeat it); axes
    # other than the data and model axes replicate, as in shard_map
    groups = [mesh.group(EP_AXIS, at) for at in mesh.group(daxes)] \
        if sharded else [mesh.group(EP_AXIS)]
    ys, auxes, aux_devs = [], [], []
    for g, group in enumerate(groups):
        devs = [mesh.device(q) for q in group]
        xl = x[g * Bl:(g + 1) * Bl] if sharded else x
        routed = []
        for j, dev in enumerate(devs):
            xt = xl.to(dev).reshape(T_all, d)[j * T:(j + 1) * T]
            routed.append(_route(cfg, xt, p["router"].to(dev), n_shards))
        recv_x = all_to_all([r[0] for r in routed], devs)
        recv_e = all_to_all([r[1] for r in routed], devs)
        back = []
        for j, dev in enumerate(devs):
            local = slice(j * E_loc, (j + 1) * E_loc)
            back.append(_experts(recv_x[j], recv_e[j],
                                 *(p[k][local].to(dev)
                                   for k in ("wg", "wu", "wd"))))
        ret = all_to_all(back, devs)
        y = psum([_combine(ret[j], routed[j][2], routed[j][3], j, T_all)
                  for j in range(n_shards)], devs)
        ys.append(y[0].reshape(Bl, S, d).to(x.device))
        auxes += [r[4] for r in routed]
        aux_devs += devs
    aux = pmean(auxes, aux_devs)[0].to(x.device)
    return (ys[0] if len(ys) == 1 else torch.cat(ys)), aux
