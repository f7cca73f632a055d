"""Weights and images from the seed: the inputs that the program and the
reference are both given.

Weights are made on the device in a few large calls, in the type they are
served in: one draw of every weight in the storage type and one draw of
every bias in fp32, each leaf a view of its draw at an offset aligned to
128 bytes, then scaled to He-normal.  Drawing again from the same seed on
the same device gives the same bits, which is how the reference gets its
own copy once the program's state is freed."""
from __future__ import annotations

import math

import torch

from chipbench.reference import cnn as ref

ALIGN = 64            # elements: a leaf starts 128 bytes apart at least
BIAS_STD = 0.01
POOL_CHUNK = 64       # images drawn on the device at a time


def _seeded(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 4 + stream) % 2**63)


def _offsets(sizes: list[int]) -> tuple[list[int], int]:
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += -(-n // ALIGN) * ALIGN
    return offs, at


def make_weights(net: list[dict], in_shape: tuple, seed: int, device,
                 dtype: torch.dtype) -> list[dict]:
    """The network's weights (``dtype``) and fp32 biases, in the layers'
    nesting: ``{"w", "b"}`` a conv or linear layer, ``{"expand", "dw",
    "project"}`` of those an inverted residual, ``{}`` a layer without
    weights."""
    leaves = [(i, path, shape, fan_in)
              for i, layer in enumerate(ref.param_shapes(net, in_shape))
              for path, (shape, fan_in) in layer.items()]
    w_offs, w_total = _offsets([math.prod(s) for _, _, s, _ in leaves])
    b_offs, b_total = _offsets([s[0] if len(s) == 4 else s[1]
                                for _, _, s, _ in leaves])
    gen = _seeded(seed, 0, device)
    w_all = torch.randn(w_total, generator=gen, device=device, dtype=dtype)
    b_all = torch.randn(b_total, generator=gen, device=device,
                        dtype=torch.float32).mul_(BIAS_STD)
    params: list[dict] = [{} for _ in net]
    for (i, path, shape, fan_in), wo, bo in zip(leaves, w_offs, b_offs):
        w = w_all[wo:wo + math.prod(shape)].view(shape)
        w.mul_(math.sqrt(2.0 / fan_in))
        nb = shape[0] if len(shape) == 4 else shape[1]
        leaf = {"w": w, "b": b_all[bo:bo + nb]}
        if path:
            params[i][path] = leaf
        else:
            params[i] = leaf
    return params


def make_pool(n: int, in_shape: tuple, seed: int, device) -> torch.Tensor:
    """``n`` fp32 images (N(0, 1) a value, as normalised photos are near)
    in host memory, drawn on ``device`` a chunk at a time.  Beside a card
    the pool is pinned, as a GPU server's receive buffers are: an upload's
    copy to the card is then a DMA, and its time does not swing with the
    host's memory traffic as a pageable copy's does."""
    gen = _seeded(seed, 1, device)
    pool = torch.empty((n, *in_shape), dtype=torch.float32,
                       pin_memory=torch.device(device).type == "cuda")
    for a in range(0, n, POOL_CHUNK):
        b = min(n, a + POOL_CHUNK)
        pool[a:b] = torch.randn((b - a, *in_shape), generator=gen,
                                device=device).cpu()
    return pool
