"""ZeRO-3 over the mesh's ``data`` axis, with tensor, sequence and expert
parallelism over its ``model`` axis: the sharded train state and the
collectives of a step.

The torch counterpart of ``repro.parallel.fsdp`` (``state_shardings``,
``build_train_step``, ``init_train_state``).  Each rank holds its shard of
every fp32 parameter and of both AdamW moments: the leaf's block along the
dimension ``ShardingRules`` splits over ``model`` (heads, kv heads, ffn,
vocab or experts; ``Placement.mdim``), and of that the block along the one
it splits over ``data`` (the ``embed`` axis; ``Placement.dim``).  A leaf
whose dimension an axis does not divide, or that has none the axis takes,
is whole over that axis (the norm weights over both).  In a step:

  * every rank draws the same global batch and keeps its data row's rows
    (``act.local_rows``), or all of them when they do not divide; every
    model rank of a data row holds the same rows;
  * inside each layer's activation checkpoint the layer's leaves are
    all-gathered over ``data``, cast to the compute dtype by the model and
    used, then freed; the recompute in the backward gathers them again;
    the gather's backward reduce-scatters the gradient onto the shards;
  * over ``model`` the layers run on their local heads, ffn and experts
    (``repro_torch.parallel.tensor``, ``TensorParallel``), the residual
    stream on this rank's sequence rows under sequence parallelism;
  * the gradients of leaves whole over ``data`` are all-reduced over it
    after the backward; those of leaves whole over ``model`` are
    all-reduced over ``model`` where each model rank's is a partial sum:
    all of them under sequence parallelism (each saw other rows), and
    without it those inside attention split over heads (wk and wv where
    the kv heads do not divide, the qk-norms), the rest being whole;
  * the embedding, the final norm and the lm_head are gathered around
    their use; the lookup and the cross-entropy are vocab-parallel;
  * the loss divides each rank's cross-entropy and z-loss sums by the
    all-reduced count of valid tokens over ``data``, so the sum over data
    ranks, which the gradients carry, is the global batch's mean (a
    replicated batch counts each token once per rank, which the division
    undoes); every model rank of a data row holds the same loss;
  * the MoE layers route over the data group (``models.moe.MoEGroup``):
    with split rows, by the global batch's capacity and positions and
    with its aux loss shared out linearly (an all-gather of the
    per-expert counts a layer); with replicated rows, each rank as one
    device, carrying 1/world of the aux; each model rank runs its E/m
    experts and carries 1/m of the aux; the logged ``aux_loss``, summed
    over ranks, is the global;
  * the clip reads the global norm: every leaf's squared sum in the
    single-device order, a leaf split over an axis summed over it, a leaf
    whole over an axis counted once;
  * AdamW (``train.optimizer.adamw_update``) updates the local shards in
    place.

The state is plain local shards with these collectives written out, not
``DTensor``s: the kernels are called through ctypes on raw pointers and
need plain contiguous tensors; the gather's backward must sum the ranks'
gradients (a ``DTensor`` redistributed from ``Shard`` to ``Replicate``
takes its gradient as replicated and keeps its chunk, losing the sum,
unless told ``Partial``), which the reduce-scatter here makes explicit;
and the same code runs over NCCL and gloo.  At a ``model`` axis of 1 no
``model`` collective runs and the step is the ZeRO-3 step over ``data``
alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.common import (init_params, layer_views,
                                       tree_leaves, tree_map_specs,
                                       trainable)
from repro_torch.models.moe import MoEGroup
from repro_torch.parallel.act import activation_sharding, local_rows
from repro_torch.parallel.mesh import mesh_shape
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.parallel.tensor import (TensorParallel, all_gather_dim,
                                         all_reduce, reduce_scatter_dim)
from repro_torch.train.checkpoint import flatten_with_paths
from repro_torch.train.optimizer import AdamWState, tree_map

# ROADMAP.md's items for what the port does not carry yet
EXTRAS_ITEM = "ROADMAP.md slice 11, item 19"
TP_EXPERT_ITEM = "ROADMAP.md slice 8, item 13b"


class TrainState(NamedTuple):
    """The JAX package's TrainState without its grad-compression error
    feedback (``grad_compression`` raises): the same checkpoint keys."""
    params: Any
    opt: AdamWState


def check_parallel(parallel: ParallelConfig) -> None:
    """Raise for the options the port does not carry yet."""
    if parallel.multi_pod:
        raise NotImplementedError(f"multi_pod (a data axis across hosts): "
                                  f"{EXTRAS_ITEM}")
    if parallel.explicit_overlap:
        raise NotImplementedError(f"explicit_overlap (the prefetching FSDP "
                                  f"variant): {EXTRAS_ITEM}")
    if parallel.grad_compression != "none":
        raise NotImplementedError(f"grad_compression="
                                  f"{parallel.grad_compression!r}: "
                                  f"{EXTRAS_ITEM}")
    if parallel.remat_policy != "nothing":
        raise NotImplementedError(f"remat_policy={parallel.remat_policy!r}: "
                                  f"the port checkpoints every layer and "
                                  f"saves nothing in it ('nothing')")


def check_model_axis(model, rules: ShardingRules) -> None:
    """Raise for the layouts over ``model`` the port does not carry: the
    TP-expert one (the axis does not divide the experts, JAX's
    ``moe_shard_map``), and a vocabulary or an FFN the axis does not
    divide (JAX keeps them whole).  Heads it does not divide run whole."""
    cfg, m = model.cfg, rules.model_size
    if cfg.moe is not None and not rules.axis_map["experts"]:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.moe.n_experts} experts over a model axis of "
            f"{m} (the TP-expert layout, JAX's moe_shard_map): "
            f"{TP_EXPERT_ITEM}")

    def check(path, s):
        if set(s.axes) & {"vocab", "ffn", "experts"} \
                and rules.split_dims(s.axes, s.shape)[1] < 0:
            raise NotImplementedError(
                f"{cfg.name}: {'/'.join(path)} {tuple(s.shape)} "
                f"({s.axes}) is not split by a model axis of {m}: "
                f"{TP_EXPERT_ITEM}")
    tree_map_specs(check, model.param_specs())


@dataclass(frozen=True)
class Placement:
    """Where a leaf lives: ``dim`` split over the data axis and ``mdim``
    over the model axis (-1: whole over it); ``shape`` is the full leaf's;
    ``block``: whole over ``model`` inside attention split over heads, so
    that its gradient is a partial sum on each model rank even without
    sequence parallelism."""
    dim: int
    shape: tuple
    mdim: int = -1
    block: bool = False

    def per_layer(self) -> "Placement":
        """A layer's slice of a stacked leaf (the unsplit 'layers' axis)."""
        return Placement(self.dim - 1 if self.dim >= 0 else -1,
                         self.shape[1:],
                         self.mdim - 1 if self.mdim >= 0 else -1, self.block)


@dataclass(frozen=True)
class Shard:
    """A rank's part of one leaf, as the model receives it in a step."""
    local: torch.Tensor
    placement: Placement


def _zip_map(fn: Callable, a, b):
    """fn(x, y) over two nested dicts of the same keys."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


# --------------------------------------------------------------------------- #
# The gather over data
# --------------------------------------------------------------------------- #
class _Gather(torch.autograd.Function):
    """All-gather forward over the data ranks' shards along ``p.dim``
    (this model rank's part of the leaf), reduce-scatter backward: the
    gathered leaf's gradient is a partial sum on each rank, summed onto
    the shards."""

    @staticmethod
    def forward(ctx, local, p: Placement, group):
        ctx.p, ctx.group = p, group
        return all_gather_dim(local, p.dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.p.dim, ctx.group), None, None


# --------------------------------------------------------------------------- #
# The sharded state and step
# --------------------------------------------------------------------------- #
class FSDP:
    """A model's parameters sharded over a mesh's ``data`` axis and split
    over its ``model`` axis."""

    def __init__(self, model, mesh, parallel: ParallelConfig, device):
        check_parallel(parallel)
        shape = mesh_shape(mesh)
        self.model = model
        self.rules = ShardingRules(shape, model.cfg, parallel)
        self.mesh_shape = shape
        self.model_size = int(shape.get("model", 1))
        if self.model_size > 1:
            check_model_axis(model, self.rules)
        self.group = mesh.get_group("data")
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.model_group, self.model_rank = None, 0
        if self.model_size > 1:
            self.model_group = mesh.get_group("model")
            self.model_rank = dist.get_rank(self.model_group)
        self.device = torch.device(device)
        self.moe_group: Optional[MoEGroup] = None   # set by each step
        self.tp: Optional[TensorParallel] = None     # set by each step
        heads = bool(self.rules.axis_map["heads"])

        def place(path, s):
            dim, mdim = self.rules.split_dims(s.axes, s.shape)
            if self.model_size == 1:
                mdim = -1
            return Placement(dim, tuple(s.shape), mdim,
                             mdim < 0 and heads and "attn" in path)
        self.placements = tree_map_specs(place, model.param_specs())

    # ------------------------------------------------------------------ state
    def shard(self, full: torch.Tensor, p: Placement) -> torch.Tensor:
        """This rank's shard of a full leaf (a copy of its own): its model
        rank's block, and of that its data rank's."""
        t = full
        if p.mdim >= 0:
            t = t.chunk(self.model_size, p.mdim)[self.model_rank]
        if p.dim >= 0:
            t = t.chunk(self.world, p.dim)[self.rank]
        if t is full:
            return full
        return t.clone(memory_format=torch.contiguous_format)

    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        """The single-device ``init_train_params`` values, sharded: every
        leaf drawn from the same generator in the same order, one full leaf
        at a time, this rank's shard kept."""
        return trainable(init_params(
            self.model.param_specs(), generator, dtype=torch.float32,
            device=self.device,
            keep=lambda path, t: self.shard(t, self._at(path))))

    def _at(self, path) -> Placement:
        node = self.placements
        for k in path:
            node = node[k]
        return node

    def state_placements(self) -> Dict[str, Placement]:
        """Checkpoint key -> placement, over a whole ``TrainState``."""
        whole = Placement(-1, ())
        tree = TrainState(self.placements, AdamWState(
            whole, self.placements, self.placements))
        return dict(flatten_with_paths(tree))

    def state_leaves(self, state) -> Iterator[Tuple[str, Optional[Any]]]:
        """(checkpoint key, the whole leaf in host memory on global rank 0,
        None on the others), leaf by leaf: each leaf is gathered over
        ``data`` and ``model`` when it is reached, every rank taking part,
        so that no rank holds more than one whole leaf at a time."""
        where = self.state_placements()
        rank0 = dist.get_rank() == 0
        for key, local in flatten_with_paths(state):
            p, t = where[key], local.detach()
            if p.dim >= 0:
                t = all_gather_dim(t, p.dim, self.group)
            if p.mdim >= 0:
                t = all_gather_dim(t, p.mdim, self.model_group)
            yield key, (t.cpu() if rank0 else None)

    # ------------------------------------------------------------------- step
    def split(self, params) -> Dict[str, Any]:
        """Local shards in the JAX layout -> the model's per-layer tree of
        ``Shard``s (each layer's views of the stacked groups)."""
        groups = [f"g{gi}" for gi in range(len(self.model.layer_groups()))]
        out = {k: _zip_map(Shard, v, self.placements[k])
               for k, v in params.items() if k not in groups}
        out["layers"] = []
        for g, (n, _) in zip(groups, self.model.layer_groups()):
            per = tree_map(Placement.per_layer, self.placements[g])
            out["layers"] += [_zip_map(Shard, lp, per)
                              for lp in layer_views(params[g], n)]
        return out

    def gather(self, tree):
        """A tree of ``Shard``s -> this model rank's leaves, each gathered
        over ``data`` through ``_Gather`` (whole leaves as they are)."""
        if isinstance(tree, dict):
            return {k: self.gather(v) for k, v in tree.items()}
        if tree.placement.dim < 0:
            return tree.local
        return _Gather.apply(tree.local, tree.placement, self.group)

    def token_count(self, n: torch.Tensor) -> torch.Tensor:
        """The all-reduced count of valid tokens, at least 1."""
        return all_reduce(n.float(), self.group).clamp_min(1)

    def loss_and_backward(self, params, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global ``batch`` through the model, the
        backward, and the whole leaves' gradients summed; returns the
        step's loss metrics, summed over ranks."""
        rules = self.rules.activation_rules()
        m = self.model_size
        self.tp = None if m == 1 else TensorParallel(
            self.model_group, m, self.model_rank,
            seq=bool(rules["act_seq"]) and batch["tokens"].shape[1] % m == 0)
        with activation_sharding(self.mesh_shape, rules,
                                 {"data": self.rank,
                                  "model": self.model_rank}):
            local = {k: local_rows(v, self.rank) for k, v in batch.items()}
            replicas = self.world if local["labels"].shape[0] == \
                batch["labels"].shape[0] else 1
            self.moe_group = None if self.world == 1 else MoEGroup(
                self.group, self.world, self.rank, split=replicas == 1)
            loss, metrics = self.model.loss(params, local, fsdp=self)
            loss.backward()
        for p, pl in zip(tree_leaves(params), tree_leaves(self.placements)):
            if pl.dim < 0:
                all_reduce(p.grad, self.group)
            if self.tp is not None and pl.mdim < 0 \
                    and (self.tp.seq or pl.block):
                all_reduce(p.grad, self.model_group)
        names = ["loss"] + [k for k in ("ce_loss", "z_loss", "aux_loss",
                                        "tokens") if k in metrics]
        vals = torch.stack([loss.detach().float()] + [
            metrics[k].detach().float() for k in names[1:]])
        vals = all_reduce(vals, self.group)
        out = dict(zip(names, vals.unbind()))
        if "tokens" in out:          # a replicated batch counted per rank
            out["tokens"] = (out["tokens"] / replicas).round().long()
        if self.tp is not None:      # each model rank carried 1/m of the aux
            out["aux_loss"] = all_reduce(out["aux_loss"].clone(),
                                         self.model_group)
            out["loss"] = (out["ce_loss"] + out.get("z_loss", 0.0)
                           + out["aux_loss"])
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of every leaf's squared sum, in the single-device order: a
        leaf split over an axis summed over it, a leaf whole over an axis
        counted once."""
        def counted(p):
            return (p.dim >= 0 or self.rank == 0) and \
                (p.mdim >= 0 or self.model_rank == 0)
        sq = torch.stack([
            torch.sum(torch.square(g.float())) if counted(p)
            else torch.zeros((), dtype=torch.float32, device=g.device)
            for g, p in zip(tree_leaves(grads),
                            tree_leaves(self.placements))])
        sq = all_reduce(sq, self.group)
        if self.model_size > 1:
            sq = all_reduce(sq, self.model_group)
        return torch.sqrt(sum(sq.unbind()))
