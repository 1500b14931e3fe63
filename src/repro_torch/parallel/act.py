"""Activation placement under the installed rules: the batch's rows over
the data axis, the sequence over the model axis, and the hooks the models
call on activations.

The torch counterpart of ``repro.parallel.act``.  ``activation_sharding``
installs a mesh's axis sizes, ``ShardingRules.activation_rules()`` and
this rank's index on each axis for the calls inside it.  Activations are
plain local tensors: the batch axis is already this rank's rows
(``local_rows``, the rule of ``ShardingRules.batch_spec``: rows over
``act_batch`` when they divide, else every rank holds the whole batch), so
``constrain`` leaves it as it is; a logical axis the rules map to the
``model`` axis (``act_seq`` under sequence parallelism) is taken from a
tensor whole over ``model`` as this rank's contiguous block, the chunk
JAX's ``NamedSharding`` gives the same device, and left whole where the
axis does not divide it (JAX's rule too).

The installed state is the process's, not a thread's: autograd's backward
thread recomputes each layer's checkpointed forward, which must see the
rules the forward saw.  The sharded step holds it over its forward and its
backward.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Mapping, Optional, Tuple

import torch

_state = SimpleNamespace(mesh_shape=None, rules=None, index=None)


class activation_sharding:
    """Context manager installing a mesh's axis sizes, activation rules and
    this rank's index on each axis (default 0) for the calls inside it."""

    def __init__(self, mesh_shape: Mapping[str, int],
                 rules: Dict[str, Tuple[str, ...]],
                 index: Optional[Mapping[str, int]] = None):
        self.mesh_shape, self.rules = dict(mesh_shape), rules
        self.index = dict(index or {})

    def __enter__(self):
        self._saved = (_state.mesh_shape, _state.rules, _state.index)
        _state.mesh_shape, _state.rules = self.mesh_shape, self.rules
        _state.index = self.index
        return self

    def __exit__(self, *exc):
        _state.mesh_shape, _state.rules, _state.index = self._saved
        return False


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x``'s part on this rank under the installed rules: along each
    dimension whose logical axis maps to ``model``, this rank's contiguous
    block where the axis divides it (``x`` is whole over ``model``); the
    batch axis is already local.  The identity with no rules installed."""
    rules, shape = _state.rules, _state.mesh_shape
    if rules is None or shape is None:
        return x
    used = set()
    for d, name in enumerate(logical_axes):
        axes = tuple(a for a in rules.get(name, ()) if a not in used) \
            if name else ()
        if not axes:
            continue
        size = math.prod(shape[a] for a in axes)
        if x.shape[d] % size:
            continue
        used.update(axes)
        if "model" not in axes:
            continue                            # rows already local
        index = 0
        for a in axes:                          # row-major over the axes
            index = index * shape[a] + _state.index.get(a, 0)
        n = x.shape[d] // size
        x = x.narrow(d, index * n, n)
    return x


def shard_residual(x: torch.Tensor) -> torch.Tensor:
    """(batch, seq, embed) residual stream: batch over DP, seq over TP (SP);
    a whole stream -> this rank's rows of it."""
    return constrain(x, "act_batch", "act_seq", None)


def _extent(name: str) -> int:
    if _state.mesh_shape is None or _state.rules is None:
        return 1
    return math.prod(_state.mesh_shape[a] for a in _state.rules.get(name, ()))


def data_extent() -> int:
    """Size of the data-parallel (batch) axes under the installed rules; 1
    when none are installed (one device)."""
    return _extent("act_batch")


def seq_extent() -> int:
    """Size of the axes the sequence is split over under the installed
    rules (the ``model`` axis under sequence parallelism); 1 otherwise."""
    return _extent("act_seq")


def local_rows(x: torch.Tensor, index: int) -> torch.Tensor:
    """Batch shard ``index``'s rows of a global-batch leaf under the
    installed rules: a contiguous block of them when they divide over
    ``data_extent()``, else all of them (the JAX ``batch_sharding`` rule)."""
    extent = data_extent()
    if extent == 1 or x.shape[0] % extent:
        return x
    n = x.shape[0] // extent
    return x[index * n:(index + 1) * n]
