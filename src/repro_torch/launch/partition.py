"""Sharding rules, sharded input structs and step functions: the port of
``repro.launch.partition``.

* Rules: ``best_effort_spec``, ``_maybe_fsdp`` (``REPRO_FSDP``) and
  ``_param_spec`` are the JAX package's, line for line, over anything
  with ``shape`` and ``axis_names`` (the port's ``launch.mesh.Mesh``).  A
  spec is a tuple with one entry a dim: ``None`` (replicated), an axis
  name, or a tuple of axis names (the dim split over them in order), as
  a ``PartitionSpec`` normalised to the leaf's rank.  ``placements``
  turns one into DTensor ``Shard``/``Replicate`` placements over a
  ``torch.distributed`` ``DeviceMesh``.
* Structs: ``param_struct``, ``opt_state_struct``, ``batch_struct`` and
  ``cache_struct`` give trees of ``Struct``: a tensor on the meta device
  of the global shape and dtype, with its spec and mesh -- the
  counterpart of ``ShapeDtypeStruct(..., sharding=NamedSharding(...))``.
  Nothing is allocated, at any size.
* Step functions and the split boundary run on one device (the
  executors across devices are ``launch/smartsplit_exec.py`` and
  ``models/moe_ep.py``)."""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.dtype_policy import conv_dtype, policy_torch_dtype
from repro_torch.launch.mesh import data_axes
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt
from repro_torch.tree import tree_map

Spec = tuple          # one entry a dim: None, an axis name, or a tuple


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------
def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _data_entry(daxes: tuple):
    return daxes if len(daxes) > 1 else daxes[0]


def best_effort_spec(shape: tuple, mesh, *, skip_dims: tuple = (),
                     batch_dim: int | None = None) -> Spec:
    """Shard batch_dim over (pod,data) if divisible; then the last other
    dim divisible by the model axis."""
    model = _axis_size(mesh, "model")
    daxes = data_axes(mesh)
    dsize = int(np.prod([mesh.shape[a] for a in daxes])) if daxes else 1
    spec: list = [None] * len(shape)
    if batch_dim is not None and dsize > 1 \
            and shape[batch_dim] % dsize == 0:
        spec[batch_dim] = _data_entry(daxes)
    if model > 1:
        for i in range(len(shape) - 1, -1, -1):
            if i in skip_dims or i == batch_dim or spec[i] is not None:
                continue
            if shape[i] % model == 0 and shape[i] >= model:
                spec[i] = "model"
                break
    return tuple(spec)


FSDP_MIN_ELEMENTS = 1 << 22      # only bother sharding big leaves


def _maybe_fsdp(spec: Spec, shape: tuple, mesh, cfg=None) -> Spec:
    """Additionally shard the largest still-replicated dim of big
    parameters over the data axes (FSDP/ZeRO-1 -- the optimiser moments
    mirror parameter shardings, so they shard too).  Enabled by default;
    REPRO_FSDP=0 restores the baseline.

    Applies only to non-recurrent patterns: inside the doubly-nested
    recurrent scans (mamba/zamba/rwkv) the JAX package's partitioner
    cannot hoist the per-layer weight all-gathers (the rule is kept so
    the two packages shard alike)."""
    if os.environ.get("REPRO_FSDP", "1") != "1":
        return spec
    if cfg is not None and cfg.pattern in ("mamba", "rwkv"):
        return spec
    if np.prod(shape) < FSDP_MIN_ELEMENTS:
        return spec
    daxes = data_axes(mesh)
    if not daxes:
        return spec
    dsize = int(np.prod([mesh.shape[a] for a in daxes]))
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            used.add(a)
    if used & set(daxes):
        return spec          # a data axis is already in use on this leaf
    cands = [i for i, e in enumerate(entries)
             if e is None and shape[i] % dsize == 0 and shape[i] >= dsize]
    if not cands:
        return spec
    tgt = max(cands, key=lambda i: shape[i])
    entries[tgt] = _data_entry(daxes)
    return tuple(entries)


def _param_spec(path: str, shape: tuple, cfg: ModelConfig, mesh) -> Spec:
    """Explicit TP rules keyed on parameter name, generic fallback."""
    model = _axis_size(mesh, "model")
    stacked = path.startswith(("blocks/", "tail_blocks/"))
    lead = (0,) if stacked else ()
    name = path.split("/")[-1]

    def ok(dim_size):
        return model > 1 and dim_size % model == 0 and dim_size >= model

    nd = len(shape)
    if name == "embed" and ok(shape[0]):
        return ("model",) + (None,) * (nd - 1)
    if name == "unembed" and ok(shape[-1]):
        return (None,) * (nd - 1) + ("model",)
    if name in ("wq", "wk", "wv", "wg", "wu", "ck", "wr", "wv_", "in_proj") \
            and nd >= 2 and ok(shape[-1]):
        return (None,) * (nd - 1) + ("model",)           # column parallel
    if name in ("wo", "wd", "cv", "out_proj") and nd >= 2 \
            and ok(shape[-2]):
        spec = [None] * nd
        spec[-2] = "model"                               # row parallel
        return tuple(spec)
    if path.split("/")[-2:][0] == "moe" or "/moe/" in path:
        # expert-stacked weights (L, E, d, f) or (E, d, f)
        e_dim = 1 if stacked else 0
        if name in ("wg", "wu", "wd") and nd >= 3:
            if ok(shape[e_dim]):
                spec = [None] * nd
                spec[e_dim] = "model"                    # expert parallel
                return tuple(spec)
            # granite: E=40 not divisible -> shard within-expert dim
            tgt = nd - 1 if name in ("wg", "wu") else nd - 2
            if ok(shape[tgt]):
                spec = [None] * nd
                spec[tgt] = "model"
                return tuple(spec)
    # Small per-layer vectors (norm scales, token-shift mus, biases):
    # REPLICATE.  Sharding a (d,)-vector poisons every activation it
    # multiplies into a d-sharded layout, and each downstream projection
    # then all-gathers the full activation.
    per_layer = int(np.prod(shape[1:] if stacked else shape))
    if per_layer <= 1 << 20:
        return (None,) * nd
    return best_effort_spec(shape, mesh, skip_dims=lead)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, device_mesh, joins: dict | None = None) -> tuple:
    """DTensor placements of ``spec`` over ``device_mesh``: for each mesh
    dim, in the mesh's order, ``Shard(d)`` for the tensor dim ``d`` whose
    entry names it, else ``Replicate()``.  A dim sharded over ("pod",
    "data") takes ``Shard(d)`` on both mesh dims, the first the major, as
    JAX splits it.  ``joins`` maps a mesh dim's name to the spec axes it
    stands for together (``{"data": ("pod", "data")}`` for the dry-run's
    2-D (pod x data, model) mesh); an entry that names only some of a
    joined dim's axes raises."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in device_mesh.mesh_dim_names:
        covers = set((joins or {}).get(name, (name,)))
        dims = [d for d, e in enumerate(spec) if covers & set(_names(e))]
        if len(dims) > 1:
            raise ValueError(f"mesh dim {name!r} shards dims {dims} of "
                             f"{spec}")
        if dims and len(covers) > 1 \
                and not covers <= set(_names(spec[dims[0]])):
            raise ValueError(f"{spec[dims[0]]!r} splits the joined mesh "
                             f"dim {name!r} ({sorted(covers)})")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# Structs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Struct:
    """A tensor on the meta device of the global shape and dtype, with
    its spec over ``mesh``: a leaf of the struct trees below."""
    tensor: torch.Tensor
    spec: Spec
    mesh: Any

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    @property
    def local_shape(self) -> tuple[int, ...]:
        """One device's shard (each sharded dim split evenly, rounded
        up, as a padded shard holds it)."""
        return tuple(-(-n // math.prod(self.mesh.shape[a] for a in _names(e)))
                     for n, e in zip(self.shape, self.spec))

    @property
    def local_nbytes(self) -> int:
        return math.prod(self.local_shape) * self.tensor.element_size()


def _struct(t: torch.Tensor, spec: Spec, mesh) -> Struct:
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a {t.dim()}-d leaf")
    return Struct(t.to("meta"), tuple(spec), mesh)


def tensors(tree):
    """The struct tree's meta tensors, in its structure."""
    return tree_map(lambda s: s.tensor if isinstance(s, Struct) else s, tree)


def specs(tree):
    """The struct tree's specs, in its structure."""
    return tree_map(lambda s: s.spec if isinstance(s, Struct) else s, tree)


def _tree_paths(tree) -> Any:
    """Map each leaf to its 'a/b/c' key path string."""
    paths = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, (tuple, list)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        else:
            paths[prefix] = node
    walk(tree, "")
    return paths


def _map_with_paths(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_paths(v, fn, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*[
            _map_with_paths(v, fn, f"{prefix}/{f}")
            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            _map_with_paths(v, fn, f"{prefix}/{i}")
            for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def param_struct(cfg: ModelConfig, mesh, dtype=torch.bfloat16,
                 mode: str = "train"):
    """Structs (no allocation) for params with their specs.

    FSDP data-axis sharding applies to training only: inference wants
    weights resident (model-sharded), not re-gathered every step."""
    shapes = T.init_params(cfg, 0, dtype, device="meta")

    def attach(path, leaf):
        spec = _param_spec(path, tuple(leaf.shape), cfg, mesh)
        # FSDP for PARAMETERS only on MoE expert weights (their
        # replicated-over-data payload dominates); optimiser moments are
        # ZeRO-sharded for everyone in opt_state_struct.
        if mode == "train" and "moe/" in path:
            spec = _maybe_fsdp(spec, tuple(leaf.shape), mesh, cfg)
        return _struct(leaf, spec, mesh)
    return _map_with_paths(shapes, attach)


def opt_state_struct(params_struct, cfg=None):
    """AdamW state structs: parameter specs + ZeRO-1 data-axis sharding
    of the f32 moments (touched only at the update, outside the layer
    loop)."""
    def f32_like(leaf: Struct) -> Struct:
        spec = _maybe_fsdp(leaf.spec, leaf.shape, leaf.mesh, None)
        return Struct(torch.empty(leaf.shape, dtype=torch.float32,
                                  device="meta"), spec, leaf.mesh)
    mu = tree_map(f32_like, params_struct)
    nu = tree_map(f32_like, params_struct)
    mesh = next(iter(_tree_paths(params_struct).values())).mesh
    step = _struct(torch.empty((), dtype=torch.int32), (), mesh)
    return opt.AdamWState(step=step, mu=mu, nu=nu)


def batch_struct(cfg: ModelConfig, shape: InputShape, mesh,
                 dtype=torch.bfloat16) -> dict:
    """Input structs for one (arch, input-shape) cell.  Tokens are int32,
    as the JAX package's."""
    B = shape.global_batch
    S = shape.seq_len if shape.mode != "decode" else 1
    daxes = data_axes(mesh)
    dsize = int(np.prod([mesh.shape[a] for a in daxes])) if daxes else 1
    bspec = _data_entry(daxes) if dsize > 1 and B % dsize == 0 else None

    def tok(s):
        return _struct(torch.empty((B, s), dtype=torch.int32,
                                   device="meta"), (bspec, None), mesh)

    def embeds(n):
        return _struct(torch.empty((B, n, cfg.d_model), dtype=dtype,
                                   device="meta"), (bspec, None, None), mesh)

    batch = {}
    if shape.mode == "train":
        if cfg.frontend == "audio":
            batch["prefix_embeds"] = embeds(shape.seq_len)
            batch["labels"] = tok(shape.seq_len)
        elif cfg.frontend == "vision":
            n_patch = min(1024, shape.seq_len // 4)
            n_text = shape.seq_len - n_patch
            batch["prefix_embeds"] = embeds(n_patch)
            batch["tokens"] = tok(n_text)
            batch["labels"] = tok(n_text)
        else:
            batch["tokens"] = tok(shape.seq_len)
            batch["labels"] = tok(shape.seq_len)
    elif shape.mode == "prefill":
        if cfg.frontend == "audio":
            batch["prefix_embeds"] = embeds(shape.seq_len)
        else:
            batch["tokens"] = tok(shape.seq_len)
    else:   # decode: ONE token
        batch["tokens"] = tok(1)
    return batch


def cache_struct(cfg: ModelConfig, shape: InputShape, mesh,
                 dtype=torch.bfloat16):
    """KV/SSM cache structs for decode shapes, best-effort sharded.  The
    position, a host int in the port's ``Cache``, is a () int32 struct
    here, as the JAX package's cache holds it."""
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                         device="meta")
    cache = cache._replace(pos=torch.empty((), dtype=torch.int32,
                                           device="meta"))

    model = _axis_size(mesh, "model")

    def attach(path, leaf):
        if leaf.ndim == 0:
            return _struct(leaf, (), mesh)
        name = path.split("/")[-1]
        # KV caches (L, B, M, KV, hd): shard kv heads over `model` when
        # divisible; otherwise REPLICATE over model (sharding M or hd
        # forces an all-gather per layer in the attention contraction).
        if name in ("k", "v") and leaf.ndim == 5:
            bspec = best_effort_spec((leaf.shape[1],), mesh,
                                     batch_dim=0)[0]
            if model > 1 and leaf.shape[3] % model == 0:
                # kv heads divide the model axis: head-sharded cache
                spec = (None, bspec, None, "model", None)
            elif model > 1 and leaf.shape[2] % model == 0:
                # flash-decoding style: shard the sequence dim; softmax
                # over the sharded axis costs only tiny stat reductions
                spec = (None, bspec, "model", None, None)
            else:
                spec = (None, bspec, None, None, None)
        elif name == "slot_pos":
            spec = (None, "model") if model > 1 \
                and leaf.ndim == 2 and leaf.shape[1] % model == 0 \
                else (None,) * leaf.ndim
        elif name in ("x_tm", "x_cm"):
            # token-shift states (L, B, d) are tiny; sharding d poisons
            # every projection input via the shift-concat
            bspec = best_effort_spec((leaf.shape[1],), mesh,
                                     batch_dim=0)[0]
            spec = (None, bspec, None)
        elif name in ("wkv", "h") and leaf.ndim == 5:
            # recurrent states (L, B, nh, hd, hd|ds): shard HEADS over
            # `model` to match the head-sharded projections
            bspec = best_effort_spec((leaf.shape[1],), mesh,
                                     batch_dim=0)[0]
            nh_ok = model > 1 and leaf.shape[2] % model == 0
            spec = (None, bspec, "model" if nh_ok else None, None, None)
        else:
            # other states: dim0 = layer, dim1 = batch
            bdim = 1 if leaf.ndim >= 2 else None
            spec = best_effort_spec(tuple(leaf.shape), mesh, skip_dims=(0,),
                                    batch_dim=bdim)
        return _struct(leaf, spec, mesh)
    return _map_with_paths(cache, attach)


class BoundaryStruct(NamedTuple):
    shape: tuple[int, ...]
    dtype: torch.dtype


def split_boundary_struct(cfg: ModelConfig, batch: int, seq_len: int,
                          dtype: str | None = None
                          ) -> tuple[BoundaryStruct, int]:
    """The tensor that crosses the client->server link under a SmartSplit
    placement, serialized in the storage-policy dtype.

    Returns ``(struct, nbytes)``: the boundary hidden state's shape
    (batch, seq_len, d_model) and torch dtype, and its wire size in bytes,
    which is exactly the I|l1 the dtype-aware cost model feeds Eq. 4."""
    tdt = policy_torch_dtype(conv_dtype(dtype))
    shape = (batch, seq_len, cfg.d_model)
    itemsize = torch.empty((), dtype=tdt).element_size()
    return BoundaryStruct(shape, tdt), int(np.prod(shape)) * itemsize


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def _trainable(tree):
    """Each leaf as a detached alias of its storage that requires grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``loss_fn`` and its gradient: (loss, metrics, trainable, grads),
    where ``trainable`` is ``params`` with its blocks as per-layer views
    (``transformer.unstack_blocks``), each a detached alias of its
    storage, and ``grads`` the gradient tree of the same structure (zeros
    for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    trainable = _trainable(T.unstack_blocks(params))
    loss, metrics = T.loss_fn(cfg, trainable, batch)
    loss.backward()
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, trainable)
    return loss.detach(), metrics, trainable, grads


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig | None = None,
                    reduce_grads=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: forward, ``backward()``, then AdamW in place.

    The step differentiates per-layer views of the stacked weights
    (``transformer.unstack_blocks``), so each layer's gradient is its own
    tensor and the update writes through to the stacks; the returned
    ``params`` and moments are the objects passed in.  ``metrics`` holds
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` as 0-d tensors on
    the device: nothing is read back to the host.

    ``reduce_grads(grads, mu)``, where given, returns the grads laid out
    as the moments ``mu`` are before the update: a sharded step's
    gradient reduction (the dry-run's DTensor pass redistributes each
    gradient to its moment's placements, as XLA's partitioner reduces
    them for the JAX package's update)."""
    ocfg = ocfg or opt.AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, metrics, trainable, grads = loss_and_grads(cfg, params,
                                                         batch)
        state = opt.AdamWState(opt_state.step,
                               T.unstack_blocks(opt_state.mu),
                               T.unstack_blocks(opt_state.nu))
        if reduce_grads is not None:
            grads = reduce_grads(grads, state.mu)
        _, state, om = opt.apply_updates(ocfg, trainable, grads, state)
        return params, opt_state._replace(step=state.step), {
            "loss": loss, "ce": metrics["ce"].detach(),
            "aux": metrics["aux"].detach(), **om}
    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        logits, cache, _ = T.forward(cfg, params, batch, mode="prefill",
                                     cache=cache)
        return logits[:, -1:], cache
    return prefill_step


def make_encode_step(cfg: ModelConfig):
    """Encoder-only archs: prefill == full forward, no cache."""
    def encode_step(params, batch):
        logits, _, _ = T.forward(cfg, params, batch, mode="prefill")
        return logits
    return encode_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, tokens, cache):
        return T.decode_step(cfg, params, tokens, cache)
    return serve_step
