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

A reference ``TrainState`` (``Model.init_train_state``) crosses with
:func:`train_state_from_numpy`: params, the AdamW step and moments in any
of the three moment dtypes (``QuantMoment`` leaves included), so both
packages can train from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .checkpoint.store import from_numpy
from .models.layers import tree_map
from .models.model import TrainState
from .optim.adamw import AdamWState, QuantMoment


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (bfloat16 arrays stay bfloat16)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return from_numpy(np.asarray(tree)).to(dev)


def _moments_from_numpy(tree, dev):
    """A moment tree: arrays, or the reference's int8 moments (anything
    with ``q``, ``scale`` and ``shape``) as :class:`QuantMoment`."""
    if isinstance(tree, dict):
        return {k: _moments_from_numpy(v, dev) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QuantMoment(q=from_numpy(np.asarray(tree.q)).to(dev),
                           scale=from_numpy(np.asarray(tree.scale)).to(dev),
                           shape=tuple(tree.shape))
    return from_numpy(np.asarray(tree)).to(dev)


def train_state_from_numpy(state, device="cuda") -> TrainState:
    """A reference ``TrainState(params, opt=AdamWState(step, m, v),
    step)`` (leaves: anything ``np.asarray`` reads) -> the port's, on
    ``device``, its params leaves that require grad."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(state.params, dev))
    opt = AdamWState(step=from_numpy(np.asarray(state.opt.step)).to(dev),
                     m=_moments_from_numpy(state.opt.m, dev),
                     v=_moments_from_numpy(state.opt.v, dev))
    return TrainState(params=params, opt=opt,
                      step=from_numpy(np.asarray(state.step)).to(dev))


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
