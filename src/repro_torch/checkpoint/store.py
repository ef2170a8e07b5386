"""Checkpoints: a flattened tree in one ``.npz`` per step directory.

The counterpart of ``repro.checkpoint.store``, with its layout and its
key strings, so each package loads the other's files:

    <dir>/step_<n:08d>/arrays.npz  +  manifest.json  {"step", "keys"}

A leaf's key joins its path with ``/``: a dict key as itself (sorted, as
``jax.tree`` orders them), a NamedTuple field as ``.<name>``
(``TrainState``, ``AdamWState``), a ``QuantMoment``'s ``q`` and ``scale``
as ``0`` and ``1``.  bfloat16 leaves are stored as raw 2-byte records
(``V2``), as numpy writes the reference's.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..optim.adamw import QuantMoment


def _map_keyed(fn: Callable[[str, Any], Any], tree, path: tuple = ()):
    """``tree`` with every tensor leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_keyed(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, QuantMoment):
        return QuantMoment(q=fn("/".join(path + ("0",)), tree.q),
                           scale=fn("/".join(path + ("1",)), tree.scale),
                           shape=tree.shape)
    if isinstance(tree, tuple):   # a NamedTuple: TrainState, AdamWState
        return type(tree)(*(_map_keyed(fn, getattr(tree, f),
                                       path + ("." + f,))
                            for f in tree._fields))
    return fn("/".join(path), tree)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as raw 2-byte records."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A tensor of ``arr``'s values; raw 2-byte records (and numpy's
    ``bfloat16`` extension type) read as bfloat16 bits."""
    arr = np.asarray(arr)
    if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                    or arr.dtype.name == "bfloat16"):
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def save_checkpoint(directory: str | Path, step: int, tree) -> Path:
    """Write ``tree`` (nested dicts, NamedTuples, QuantMoments of
    tensors) as ``<directory>/step_<step:08d>``; returns that path."""
    d = Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    flat: dict[str, np.ndarray] = {}

    def put(key, leaf):
        flat[key] = to_numpy(leaf)
    _map_keyed(put, tree)
    np.savez(d / "arrays.npz", **flat)
    (d / "manifest.json").write_text(json.dumps(
        {"step": step, "keys": sorted(flat)}, indent=1))
    return d


def latest_step(directory: str | Path) -> int | None:
    """The highest step saved under ``directory``, None if none is."""
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def load_checkpoint(directory: str | Path, step: int, like) -> Any:
    """Restore step ``step`` onto the structure of ``like``: each leaf
    takes the stored values at ``like``'s leaf's device and dtype (and
    its ``requires_grad``); a stored shape other than that leaf's
    raises."""
    d = Path(directory) / f"step_{step:08d}"
    with np.load(d / "arrays.npz") as data:
        def get(key, leaf):
            if key not in data.files:
                raise KeyError(f"{d}: no array {key!r}")
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{d}: {key!r} has shape {arr.shape}, "
                                 f"want {tuple(leaf.shape)}")
            out = from_numpy(arr).to(leaf.device, leaf.dtype)
            return out.requires_grad_(leaf.requires_grad)
        return _map_keyed(get, like)
