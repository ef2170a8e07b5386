"""Carry weights from the JAX reference into the port.

``repro.models.model.Model.init`` returns a nested dict of arrays; pass
it through ``np.asarray`` leaf by leaf and :func:`params_from_numpy`
turns it into the port's tree: the same nested dict, names and shapes,
the stacked leading layer axis kept.  Leaves keep their dtype (fp32 for
the reference's ``param_dtype``); ``Model.cast_params`` makes the
serving copy.
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
