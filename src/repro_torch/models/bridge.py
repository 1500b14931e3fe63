"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the JAX param tree as numpy arrays (nested
dicts keyed by the ``ParamSpec`` paths of ``param_specs()``), checks every
shape against the port's own specs, moves each array to ``device`` in its
load dtype and splits the stacked ``layers`` axis.  ``train_params_from_
numpy`` keeps the JAX layout (stacked groups) in float32, each leaf
requiring a gradient: what ``model.loss`` and the trainer take.  Neither
imports JAX: the caller converts (``jax.tree_util.tree_map(np.asarray,
params)``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.common import (ParamSpec, load_dtype, trainable,
                                       tree_map_specs)


def _tensors(tree: Dict[str, Any], model, device, dtype_of):
    """The spec tree of ``model`` with each leaf from ``tree``, shape-checked,
    on ``device`` in ``dtype_of(path, spec)``."""
    def leaf(path, spec: ParamSpec) -> torch.Tensor:
        node: Any = tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"param {'/'.join(path)} missing from the tree")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != spec.shape:
            raise ValueError(f"param {'/'.join(path)}: shape {arr.shape} != "
                             f"spec {spec.shape}")
        t = torch.from_numpy(np.array(arr, np.float32))     # a writable copy
        return t.to(device=device, dtype=dtype_of(path, spec))

    return tree_map_specs(leaf, model.param_specs())


def params_from_numpy(tree: Dict[str, Any], model, device) -> Dict[str, Any]:
    """Serving parameters: load dtypes, layers split."""
    return model.split_layers(_tensors(
        tree, model, device,
        lambda path, spec: load_dtype(path, spec, model.dtype)))


def train_params_from_numpy(tree: Dict[str, Any], model,
                            device) -> Dict[str, Any]:
    """Training parameters: float32, the JAX layout, requiring gradients."""
    return trainable(_tensors(tree, model, device,
                              lambda path, spec: torch.float32))
