"""Checkpointing of the PyTorch port: a tree -> a directory holding
``arrays.npz`` and a JSON ``manifest.json``, in ``repro.training.
checkpoint``'s format exactly (the same paths, ``__namedtuple__`` /
``__seq__`` / ``__none__`` markers and manifest keys ``step``, ``meta``,
``arrays``, ``extra``), so weights and optimizer state cross between the
two packages in both directions.

A bfloat16 leaf is written as the JAX package writes it -- two-byte
records under the ``.npy`` descriptor ``'<V2'``, ``"bfloat16"`` in the
manifest -- and read back to ``torch.bfloat16`` bits through the
manifest's dtype, with no ``ml_dtypes``.  Restores are validated
structurally: arrays are looked up by path, a missing one raises
``KeyError`` and a shape mismatch ``ValueError``."""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any

import numpy as np
import torch

_BF16_DESCR = "<V2"       # ml_dtypes' bfloat16 as np.savez records it


def _flatten(tree, prefix="") -> dict[str, Any]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            flat.update(_flatten(v, f"{prefix}/{f}"))
        flat[f"{prefix}/__namedtuple__"] = type(tree).__name__
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}/{i}"))
        flat[f"{prefix}/__seq__"] = type(tree).__name__
    elif tree is None:
        flat[f"{prefix}/__none__"] = True
    else:
        flat[prefix] = tree
    return flat


def _write_npy(fid, t: torch.Tensor) -> str:
    """One ``.npy`` member, byte for byte what ``np.savez`` writes for the
    JAX package's array of the same value; returns the manifest dtype."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        np.lib.format.write_array_header_1_0(
            fid, {"descr": _BF16_DESCR, "fortran_order": False,
                  "shape": tuple(t.shape)})
        fid.write(t.view(torch.int16).numpy().tobytes())
        return "bfloat16"
    a = t.numpy()
    np.lib.format.write_array(fid, a, allow_pickle=False)
    return str(a.dtype)


def save(path: str, step: int, params, opt_state=None,
         extra: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    flat = _flatten(tree)
    arrays = {k: v for k, v in flat.items() if hasattr(v, "shape")}
    meta = {k: v for k, v in flat.items() if not hasattr(v, "shape")}
    dtypes = {}
    # np.savez's container: a stored (uncompressed) zip, one forced-zip64
    # member "<path>.npy" per array
    with zipfile.ZipFile(os.path.join(path, "arrays.npz"), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, t in arrays.items():
            with zf.open(k + ".npy", "w", force_zip64=True) as fid:
                dtypes[k] = _write_npy(fid, torch.as_tensor(t))
    manifest = {
        "step": step,
        "meta": meta,
        "arrays": {k: {"shape": list(t.shape), "dtype": dtypes[k]}
                   for k, t in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like) -> tuple[int, Any]:
    """Restore into the structure of ``like`` (a tree of tensors, e.g.
    freshly initialised params or {'params':..., 'opt_state':...}): each
    array in its template's dtype, on its template's device.  Returns
    (step, tree)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[rebuild(v, f"{prefix}/{f}")
                                for f, v in zip(node._fields, node)])
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v, f"{prefix}/{i}")
                              for i, v in enumerate(node))
        if node is None:
            return None
        if prefix not in data:
            raise KeyError(f"checkpoint missing array {prefix!r}")
        arr = data[prefix]
        want = tuple(node.shape)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"checkpoint shape mismatch at {prefix!r}: "
                f"{arr.shape} vs {want}")
        t = _tensor(arr, manifest["arrays"][prefix]["dtype"])
        return t.to(device=node.device, dtype=node.dtype)

    return manifest["step"], rebuild(like, "")
