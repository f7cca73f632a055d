"""The split boundary of a transformer under a SmartSplit placement: the
port of ``repro.launch.partition.split_boundary_struct``.  The rest of
that module (GSPMD partition specs, step functions for a mesh) waits for
the port's mesh tooling."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dtype_policy import conv_dtype, policy_torch_dtype


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
