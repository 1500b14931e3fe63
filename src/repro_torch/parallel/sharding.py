"""Partition rules: logical param/activation axes -> mesh axes.

The torch counterpart of ``repro.parallel.sharding.ShardingRules``, as pure
code over a mesh's axis sizes (``{"data": 8, "model": 1}``): the same
2-D "fsdp x tensor" scheme, the same first-fit choice in dimension order,
each mesh axis used at most once within a parameter, and a dimension that
its axes do not divide left unsharded.  A spec is a tuple with one entry
per dimension: ``None``, one mesh-axis name, or a tuple of names, as the
JAX ``PartitionSpec`` holds them.

  * ``model``: tensor parallel over heads / ffn / vocab / experts;
  * ``data``: FSDP (ZeRO-3) over the remaining large axis ('embed') plus
    batch data parallelism;
  * ``pod``: data parallel across pods (multi-pod runs only).

The port executes both axes in training: ``data`` in
``repro_torch.parallel.fsdp``, ``model`` in ``repro_torch.parallel.tensor``
(each leaf's two dimensions from ``split_dims``).  The input batch's rule
(``batch_sharding``: rows over the batch axes when they divide, else
replicated) is ``repro_torch.parallel.act.local_rows``.  Serving over
``model`` (``cache_shardings``) raises, naming its ROADMAP.md item.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ParallelConfig

Spec = Tuple[Any, ...]
# ROADMAP.md's item for serving over the model axis
SERVE_TP_ITEM = ("serving over 'model' (JAX's cache_shardings) is "
                 "ROADMAP.md slice 6, item 8c")


class ShardingRules:
    def __init__(self, mesh_shape: Mapping[str, int], cfg: ModelConfig,
                 parallel: ParallelConfig):
        self.mesh_shape = dict(mesh_shape)
        self.cfg = cfg
        self.parallel = parallel
        self.model_size = int(self.mesh_shape.get("model", 1))
        fsdp = parallel.fsdp_axes(cfg)
        self.fsdp_axes = tuple(a for a in fsdp if a in self.mesh_shape)
        self.batch_axes = tuple(a for a in parallel.batch_axes()
                                if a in self.mesh_shape)
        ms = self.model_size
        self.axis_map: Dict[Optional[str], Tuple[str, ...]] = {
            "embed": self.fsdp_axes,
            "vocab": ("model",),
            "ffn": ("model",),
            "expert_ffn": ("model",),
            "heads": ("model",) if cfg.n_heads % ms == 0 else (),
            "kv_heads": ("model",) if cfg.n_kv_heads % ms == 0 else (),
            "experts": (("model",) if cfg.moe is not None
                        and cfg.moe.n_experts % ms == 0 else ()),
            "layers": (),
            None: (),
        }

    def _size(self, axes) -> int:
        return math.prod(self.mesh_shape[a] for a in axes)

    # ---------------------------------------------------------------- params
    def spec_for(self, axes: Tuple[Optional[str], ...],
                 shape: Tuple[int, ...]) -> Spec:
        spec = []
        used = set()
        for d, name in enumerate(axes):
            cands = tuple(a for a in self.axis_map.get(name, ())
                          if a not in used)
            if not cands or shape[d] % self._size(cands):
                spec.append(None)
                continue
            used.update(cands)
            spec.append(cands if len(cands) > 1 else cands[0])
        return tuple(spec)

    def split_dims(self, axes: Tuple[Optional[str], ...],
                   shape: Tuple[int, ...]) -> Tuple[int, int]:
        """(the dimension ``spec_for`` splits over ``data``, the one it
        splits over ``model``) of a leaf, -1 for none."""
        spec = self.spec_for(axes, shape)

        def dim(axis):
            return next((d for d, e in enumerate(spec)
                         if axis in spec_axes(e)), -1)
        return dim("data"), dim("model")

    def cache_shardings(self, *_args, **_kw):
        """JAX's KV-cache placement over ``model``: not ported."""
        raise NotImplementedError(SERVE_TP_ITEM)

    # ----------------------------------------------------------- activations
    def activation_rules(self) -> Dict[str, Tuple[str, ...]]:
        seq = (("model",) if self.parallel.sequence_parallel
               and self.model_size > 1 else ())
        return {"act_batch": self.batch_axes, "act_seq": seq,
                "experts_ep": self.axis_map["experts"]}

    def describe(self) -> Dict[str, Any]:
        return {
            "fsdp_axes": self.fsdp_axes,
            "batch_axes": self.batch_axes,
            "tp_heads": bool(self.axis_map["heads"]),
            "tp_kv_heads": bool(self.axis_map["kv_heads"]),
            "expert_parallel": bool(self.axis_map["experts"]),
            "sequence_parallel": bool(self.activation_rules()["act_seq"]),
        }


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)

