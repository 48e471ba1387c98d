"""Sharded, atomic, resumable checkpoints in the reference's on-disk format.

Layout:  <dir>/step_<N>/
             manifest.json      step, shard count, leaf index, metadata
             shard_<i>.npz      flattened leaves (path-keyed)

* **atomic publish** — written to ``step_<N>.tmp`` then renamed, so a crash
  mid-save never corrupts the latest checkpoint;
* **sharded** — leaves are split across ``shard_count`` npz files by
  ``zlib.crc32`` of the path;
* **self-describing** — restore rebuilds the tree from ``like`` and checks
  each leaf's shape.

The format is the reference's (``repro.checkpoint``): a leaf's key is its
``/``-joined path with dict keys in sorted order, as
``jax.tree_util.tree_flatten_with_path`` names it (``p/blocks/0/wq``,
``o/leaves/embed/m``), and bfloat16 is stored as its ``uint16`` bits with
the dtype name ``"bfloat16"`` in the index.  A checkpoint written by one
package restores in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import leaves, rebuild

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "available_steps"]

_SEP = "/"


def _flatten(tree) -> List[Tuple[str, Any]]:
    return [(_SEP.join(path), leaf) for path, leaf in leaves(tree)]


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The leaf's bytes as numpy, and the dtype name for the index."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def save_checkpoint(directory: str, step: int, tree, *,
                    metadata: Optional[Dict] = None,
                    shard_count: int = 1) -> str:
    """Write ``tree`` (nested dicts of tensors) as
    ``<directory>/step_<step>``; returns that path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(shard_count)]
    index = {}
    for key, leaf in _flatten(tree):
        sh = zlib.crc32(key.encode()) % shard_count
        arr, dtype_name = _to_numpy(leaf)
        shards[sh][key] = arr
        index[key] = [sh, dtype_name]
    for i, sh in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{i}.npz"), **sh)
    manifest = {
        "step": step,
        "shard_count": shard_count,
        "index": index,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, like, device="cuda"
                       ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf takes its ``like`` leaf's dtype and lands on ``device``.  Raises
    on a missing leaf or a shape that differs from ``like``'s.  Returns
    ``(tree, metadata)``."""
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    loaded: Dict[str, np.ndarray] = {}
    for i in range(manifest["shard_count"]):
        with np.load(os.path.join(path, f"shard_{i}.npz")) as z:
            for k in z.files:
                loaded[k] = z[k]
    index = manifest["index"]
    out = []
    for key, leaf in _flatten(like):
        if key not in loaded:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = loaded[key]
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = arr.copy()
        entry = index.get(key)
        stored_dtype = entry[1] if isinstance(entry, list) else arr.dtype.name
        if stored_dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        want_shape = tuple(leaf.shape)
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{want_shape}")
        out.append(t.to(device=dev, dtype=leaf.dtype))
    return rebuild(like, out), manifest["metadata"]
