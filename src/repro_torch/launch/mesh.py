"""Device meshes and their collectives: the port of ``repro.launch.mesh``.

A ``Mesh`` is what ``jax.sharding.Mesh`` is to the JAX package: an
ndarray of devices with named axes.  The port runs one controller over
it, as the JAX program does: code that JAX writes once inside
``shard_map`` runs here once a mesh position, and the collectives are
plain functions over the list of per-position tensors along one axis,
the i-th tensor on the i-th position's device.  A collective moves a
tensor with ``.to(device)`` where the destination position lies on
another device, and makes no copy where it does not; all of them are
differentiable through autograd, as JAX's collectives have transposes.

The constructors default to the card and raise without one
(``device.resolve_device``).  A debug mesh puts every position on one
device, which is how the CPU tests, and one card, run a mesh; a
production mesh needs a card for each position and never shares one."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """Devices on named axes: ``devices`` an object ndarray of
    ``torch.device`` whose dims are ``axis_names``; ``shape`` maps each
    name to its size, in order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} dims named "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, position: tuple[int, ...]) -> torch.device:
        return self.devices[tuple(position)]

    def along(self, axis: str | Sequence[str],
              at: tuple[int, ...] | None = None) -> list[torch.device]:
        """The devices of the positions along ``axis`` (a name, or names
        taken together in mesh order, the last fastest), the other
        coordinates those of position ``at`` (default all 0): the
        ``axis`` argument of the collectives below."""
        return [self.device(p) for p in self.group(axis, at)]

    def group(self, axis: str | Sequence[str],
              at: tuple[int, ...] | None = None) -> list[tuple[int, ...]]:
        """The positions ``along`` lists the devices of."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for name in names:
            if name not in self.axis_names:
                raise ValueError(f"no axis {name!r} in {self.axis_names}")
        at = tuple(at) if at is not None else (0,) * len(self.axis_names)
        dims = [i for i, a in enumerate(self.axis_names) if a in names]
        out = []
        for idx in np.ndindex(*(self.devices.shape[i] for i in dims)):
            pos = list(at)
            for i, v in zip(dims, idx):
                pos[i] = v
            out.append(tuple(pos))
        return out


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence[str | torch.device]) -> Mesh:
    """A mesh of ``shape`` over the listed ``devices``, one a position in
    row-major order; each is resolved (a CUDA device raises without a
    card)."""
    n = math.prod(shape)
    devs = [resolve_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} "
                         f"devices, got {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), axes)


def make_debug_mesh(shape: Sequence[int] = (2, 2, 2),
                    axes: Sequence[str] = ("pod", "data", "model"),
                    device: str | torch.device = "cuda") -> Mesh:
    """A mesh whose positions all share ``device`` (default the card;
    raises without one): the CPU tests' mesh, and a mesh on one card."""
    return make_mesh(shape, axes, [device] * math.prod(shape))


# (shape, axis names) of the production meshes, single pod and multi-pod
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) = 256 cards, axes (data, model).
    Multi-pod:   (2, 16, 16) = 512 cards, axes (pod, data, model).
    Each position takes a card of its own; raises where the host has
    fewer cards than positions.  The dry-run's production mesh, which
    needs no card, is ``make_debug_mesh(*PRODUCTION_MESHES[multi_pod],
    device="meta")``."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    n = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"a production mesh {dict(zip(axes, shape))} needs {n} CUDA "
            f"devices, one a position; this host has {have}.  Use "
            f"make_debug_mesh to put a small mesh on one device")
    return make_mesh(shape, axes, [torch.device("cuda", i)
                                   for i in range(n)])


def data_axes(mesh) -> tuple[str, ...]:
    """Axes the batch dimension shards over (pod joins data-parallel in the
    baseline multi-pod configuration)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


# ---------------------------------------------------------------------------
# Collectives over the per-position tensors along one axis
# ---------------------------------------------------------------------------
def _check(xs: Sequence[torch.Tensor], axis: Sequence[torch.device]):
    if len(xs) != len(axis):
        raise ValueError(f"{len(xs)} tensors for {len(axis)} positions")


def send(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One (src, dst) pair of ``ppermute``: ``x`` on the destination's
    device, itself where it is there already."""
    return x.to(device)


def ppermute(xs: Sequence[torch.Tensor], axis: Sequence[torch.device],
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """``jax.lax.ppermute``: position ``dst`` receives ``xs[src]`` for
    each ``(src, dst)`` in ``perm``; a position that receives nothing
    gets zeros."""
    _check(xs, axis)
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts) or len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation")
    out = [torch.zeros_like(x, device=dev) for x, dev in zip(xs, axis)]
    for src, dst in perm:
        out[dst] = send(xs[src], axis[dst])
    return out


def all_to_all(xs: Sequence[torch.Tensor], axis: Sequence[torch.device]
               ) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``: each xs[i] is
    (n, ...) over the n positions; position j receives block j of every
    position, stacked in position order: ``out[j][i] = xs[i][j]``."""
    _check(xs, axis)
    n = len(xs)
    for x in xs:
        if x.shape[0] != n:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} is "
                             f"not the axis size {n}")
    return [torch.stack([send(xs[i][j], axis[j]) for i in range(n)])
            for j in range(n)]


def psum(xs: Sequence[torch.Tensor], axis: Sequence[torch.device]
         ) -> list[torch.Tensor]:
    """``jax.lax.psum``: every position gets the sum of all, added in
    position order; positions that share a device share one sum."""
    _check(xs, axis)
    sums: dict[torch.device, torch.Tensor] = {}
    for dev in axis:
        if dev not in sums:
            total = send(xs[0], dev)
            for x in xs[1:]:
                total = total + send(x, dev)
            sums[dev] = total
    return [sums[dev] for dev in axis]


def pmean(xs: Sequence[torch.Tensor], axis: Sequence[torch.device]
          ) -> list[torch.Tensor]:
    """``jax.lax.pmean``: ``psum`` over the number of positions."""
    return [s / len(xs) for s in psum(xs, axis)]
