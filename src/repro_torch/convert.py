"""Carry weights from the JAX reference into the port.

``repro.models.model.Model.init`` returns a nested dict of arrays; pass
it through ``np.asarray`` leaf by leaf and :func:`params_from_numpy`
turns it into the port's tree: the same nested dict, names and shapes,
the stacked leading layer axis kept.  Leaves keep their dtype (fp32 for
the reference's ``param_dtype``); ``Model.cast_params`` makes the
serving copy.

``repro.core.engine.init_params`` returns a flat dict, parameter name ->
array, for a CNN graph; :func:`graph_params_from_numpy` turns it into the
port's executor parameters for the port's graph of the same model (the
graph builders name parameters identically in both packages).
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def graph_params_from_numpy(params, graph, device="cuda"):
    """Flat dict name -> array (the reference CNN's parameters) -> the
    port's fp32 parameter dict for ``graph`` on ``device``.  Every
    parameter of ``graph`` must be present with the graph's shape."""
    dev = resolve_device(device)
    out = {}
    for name in graph.params:
        if name not in params:
            raise KeyError(f"parameter {name!r} of graph {graph.name!r} is "
                           "missing")
        arr = np.asarray(params[name], dtype=np.float32)
        want = graph.tensors[name].shape
        if arr.shape != want:
            raise ValueError(f"parameter {name!r}: shape {arr.shape}, the "
                             f"graph wants {want}")
        out[name] = torch.from_numpy(arr.copy()).to(dev)
    return out
