"""Activation placement under the installed rules: the batch's rows over
the data axis, and the hooks the models call on activations.

The torch counterpart of ``repro.parallel.act``.  ``activation_sharding``
installs a mesh's axis sizes and ``ShardingRules.activation_rules()`` for
the calls inside it.  In this slice the ``model`` axis is 1 (a larger one
raises, ROADMAP.md slice 6, item 8b), so every activation is whole on its
rank apart from the batch's rows: ``constrain`` and ``shard_residual`` are
the identity, the places where tensor and sequence parallelism will act,
and ``local_rows`` takes this rank's rows of the global batch (the rule of
``ShardingRules.batch_spec``: rows over ``act_batch`` when they divide,
else every rank holds the whole batch).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Mapping, Optional, Tuple

import torch

_state = threading.local()


class activation_sharding:
    """Context manager installing a mesh's axis sizes and activation rules
    for the calls inside it."""

    def __init__(self, mesh_shape: Mapping[str, int],
                 rules: Dict[str, Tuple[str, ...]]):
        self.mesh_shape, self.rules = dict(mesh_shape), rules

    def __enter__(self):
        self._saved = (getattr(_state, "mesh_shape", None),
                       getattr(_state, "rules", None))
        _state.mesh_shape, _state.rules = self.mesh_shape, self.rules
        return self

    def __exit__(self, *exc):
        _state.mesh_shape, _state.rules = self._saved
        return False


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The identity while the ``model`` axis is 1: the batch axis is already
    local (``local_rows``) and no other activation axis is split."""
    return x


def shard_residual(x: torch.Tensor) -> torch.Tensor:
    """(batch, seq, embed) residual stream: batch over DP, seq over TP (SP);
    the identity while the ``model`` axis is 1."""
    return constrain(x, "act_batch", "act_seq", None)


def data_extent() -> int:
    """Size of the data-parallel (batch) axes under the installed rules; 1
    when none are installed (one device)."""
    mesh_shape = getattr(_state, "mesh_shape", None)
    rules = getattr(_state, "rules", None)
    if mesh_shape is None or rules is None:
        return 1
    return math.prod(mesh_shape[a] for a in rules.get("act_batch", ()))


def local_rows(x: torch.Tensor, index: int) -> torch.Tensor:
    """Batch shard ``index``'s rows of a global-batch leaf under the
    installed rules: a contiguous block of them when they divide over
    ``data_extent()``, else all of them (the JAX ``batch_sharding`` rule)."""
    extent = data_extent()
    if extent == 1 or x.shape[0] % extent:
        return x
    n = x.shape[0] // extent
    return x[index * n:(index + 1) * n]
