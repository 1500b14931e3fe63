"""ZeRO-3 over the mesh's ``data`` axis: the sharded train state and the
collectives of a step.

The torch counterpart of ``repro.parallel.fsdp`` (``state_shardings``,
``build_train_step``, ``init_train_state``).  Each rank holds its shard of
every fp32 parameter and of both AdamW moments, split along the dimension
``ShardingRules.spec_for`` gives the ``data`` axis (the ``embed`` axis); a
leaf whose dimension the axis does not divide, and every leaf with no
``embed`` axis (the norm weights), is held whole on every rank.  In a step:

  * every rank draws the same global batch and keeps its rows
    (``act.local_rows``), or all of them when they do not divide;
  * inside each layer's activation checkpoint the layer's leaves are
    all-gathered, cast to the compute dtype by the model and used, then
    freed; the recompute in the backward gathers them again;
  * the gather's backward reduce-scatters the gradient onto the shards
    (summing the ranks' contributions); the gradients of whole leaves are
    all-reduced after the backward;
  * the embedding, the final norm and the lm_head are gathered around
    their use;
  * the loss divides each rank's cross-entropy and z-loss sums by the
    all-reduced count of valid tokens, so the sum over ranks, which the
    gradients carry, is the global batch's mean (a replicated batch counts
    each token once per rank, which the division undoes);
  * the MoE layers route over the group (``models.moe.MoEGroup``): with
    split rows, by the global batch's capacity and positions and with its
    aux loss shared out linearly (an all-gather of the per-expert counts a
    layer); with replicated rows, each rank as one device, carrying 1/world
    of the aux; the logged ``aux_loss``, summed over ranks, is the global;
  * the clip reads the global norm: every leaf's squared sum in the
    single-device order, a sharded leaf's summed over ranks, a whole leaf's
    counted once;
  * AdamW (``train.optimizer.adamw_update``) updates the local shards in
    place.

The state is plain local shards with these collectives written out, not
``DTensor``s: the kernels are called through ctypes on raw pointers and
need plain contiguous tensors; the gather's backward must sum the ranks'
gradients (a ``DTensor`` redistributed from ``Shard`` to ``Replicate``
takes its gradient as replicated and keeps its chunk, losing the sum,
unless told ``Partial``), which the reduce-scatter here makes explicit;
and the same code runs over NCCL and gloo.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.common import (init_params, layer_views,
                                       tree_leaves, tree_map_specs,
                                       trainable)
from repro_torch.models.moe import MoEGroup
from repro_torch.parallel.act import activation_sharding, local_rows
from repro_torch.parallel.mesh import TP_ITEM, mesh_shape
from repro_torch.parallel.sharding import ShardingRules, spec_axes
from repro_torch.train.checkpoint import flatten_with_paths
from repro_torch.train.optimizer import AdamWState, tree_map

# ROADMAP.md's item for the ParallelConfig options this slice does not carry
EXTRAS_ITEM = "ROADMAP.md slice 11, item 19"


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


@dataclass(frozen=True)
class Placement:
    """Where a leaf lives: ``dim`` split over the data axis (-1: whole on
    every rank); ``shape`` is the full leaf's."""
    dim: int
    shape: tuple

    def per_layer(self) -> "Placement":
        """A layer's slice of a stacked leaf (the unsplit 'layers' axis)."""
        return Placement(self.dim - 1 if self.dim >= 0 else -1,
                         self.shape[1:])


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
# The collectives
# --------------------------------------------------------------------------- #
def all_gather(local: torch.Tensor, p: Placement, group) -> torch.Tensor:
    """The full leaf from every rank's shard along ``p.dim``."""
    world = dist.get_world_size(group)
    shape = tuple(local.shape)
    buf = torch.empty((world * shape[0],) + shape[1:], dtype=local.dtype,
                      device=local.device)
    dist.all_gather_into_tensor(buf, local.contiguous(), group=group)
    if p.dim == 0:
        return buf
    return buf.view((world,) + shape).movedim(0, p.dim).reshape(p.shape)


def reduce_scatter(full: torch.Tensor, p: Placement, group) -> torch.Tensor:
    """This rank's shard of the sum over ranks of a full-shape tensor."""
    world = dist.get_world_size(group)
    d = p.dim
    local = p.shape[:d] + (p.shape[d] // world,) + p.shape[d + 1:]
    parts = full.reshape(p.shape[:d] + (world,) + local[d:]).movedim(d, 0)
    out = torch.empty(local, dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(
        out, parts.reshape((world * local[0],) + local[1:]),
        op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _Gather(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward: the gathered leaf's
    gradient is a partial sum on each rank, summed onto the shards."""

    @staticmethod
    def forward(ctx, local, p: Placement, group):
        ctx.p, ctx.group = p, group
        return all_gather(local, p, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.p, ctx.group), None, None


# --------------------------------------------------------------------------- #
# The sharded state and step
# --------------------------------------------------------------------------- #
class FSDP:
    """A model's parameters sharded over a mesh's ``data`` axis."""

    def __init__(self, model, mesh, parallel: ParallelConfig, device):
        check_parallel(parallel)
        shape = mesh_shape(mesh)
        if shape.get("model", 1) != 1:
            raise NotImplementedError(f"mesh {shape}: {TP_ITEM}")
        self.model = model
        self.rules = ShardingRules(shape, model.cfg, parallel)
        self.mesh_shape = shape
        self.group = mesh.get_group("data")
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.device = torch.device(device)
        self.moe_group: Optional[MoEGroup] = None   # set by each step

        def place(_path, s):
            spec = self.rules.spec_for(s.axes, s.shape)
            dims = [d for d, e in enumerate(spec) if "data" in spec_axes(e)]
            return Placement(dims[0] if dims else -1, tuple(s.shape))
        self.placements = tree_map_specs(place, model.param_specs())

    # ------------------------------------------------------------------ state
    def shard(self, full: torch.Tensor, p: Placement) -> torch.Tensor:
        """This rank's shard of a full leaf (a copy of its own)."""
        if p.dim < 0:
            return full
        return full.chunk(self.world, p.dim)[self.rank].clone(
            memory_format=torch.contiguous_format)

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

    def full_state(self, state) -> Optional[Any]:
        """The state with every leaf whole, gathered leaf by leaf into host
        memory on rank 0 (``None`` on the other ranks, which take part)."""
        def full(local, p):
            t = local.detach()
            if p.dim >= 0:
                t = all_gather(t, p, self.group)
            return t.cpu() if self.rank == 0 else None
        whole = Placement(-1, ())
        out = type(state)(
            _zip_map(full, state.params, self.placements),
            AdamWState(full(state.opt.step, whole),
                       _zip_map(full, state.opt.exp_avg, self.placements),
                       _zip_map(full, state.opt.exp_avg_sq,
                                self.placements)))
        return out if self.rank == 0 else None

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
        """A tree of ``Shard``s -> the full leaves, each gathered through
        ``_Gather`` (whole leaves as they are)."""
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
        with activation_sharding(self.mesh_shape,
                                 self.rules.activation_rules()):
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
        names = ["loss"] + [k for k in ("ce_loss", "z_loss", "aux_loss",
                                        "tokens") if k in metrics]
        vals = torch.stack([loss.detach().float()] + [
            metrics[k].detach().float() for k in names[1:]])
        vals = all_reduce(vals, self.group)
        out = dict(zip(names, vals.unbind()))
        if "tokens" in out:          # a replicated batch counted per rank
            out["tokens"] = (out["tokens"] / replicas).round().long()
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of every leaf's squared sum, in the single-device order: a
        shard's summed over ranks, a whole leaf's counted once."""
        sq = torch.stack([
            torch.sum(torch.square(g.float()))
            if p.dim >= 0 or self.rank == 0
            else torch.zeros((), dtype=torch.float32, device=g.device)
            for g, p in zip(tree_leaves(grads),
                            tree_leaves(self.placements))])
        return torch.sqrt(sum(all_reduce(sq, self.group).unbind()))

