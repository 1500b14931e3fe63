"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the JAX param tree as numpy arrays (nested
dicts keyed by the ``ParamSpec`` paths of ``param_specs()``), checks every
shape against the port's own specs, moves each array to ``device`` in its
load dtype and splits the stacked ``layers`` axis.  It never imports JAX:
the caller converts (``jax.tree_util.tree_map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.common import ParamSpec, load_dtype, tree_map_specs


def params_from_numpy(tree: Dict[str, Any], model, device) -> Dict[str, Any]:
    specs = model.param_specs()

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
        return t.to(device=device, dtype=load_dtype(path, spec, model.dtype))

    return model.split_layers(tree_map_specs(leaf, specs))
