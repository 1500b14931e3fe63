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
  * these gathers and reduce-scatters overlap the compute (the paper's C3,
    which JAX gets from XLA's latency-hiding scheduler): when layer i's
    gather is consumed, layer i+1's is issued (async, on a second process
    group over the data ranks, ``mesh.param_group``), and when layer i's
    recompute begins, layer i-1's; layer i's reduce-scatters are left in
    flight while layer i-1's backward runs (``FSDP.gather``); at most one
    layer is gathered ahead; the sums and their order are the same as
    gathering in place (``prefetch=False``), so the step is the same bit
    for bit;
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
  * with ``grad_compression="int8"`` the gradients pass through int8 with
    error feedback first (``parallel.compression``; the error sharded as
    the parameters are), a leaf split along its last axis quantized
    against the whole slice's largest magnitude;
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
from repro_torch.parallel.mesh import mesh_shape, param_group
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.parallel.tensor import (TensorParallel, all_gather_dim,
                                         all_reduce, reduce_scatter_dim)
from repro_torch.train.checkpoint import flatten_with_paths
from repro_torch.train.optimizer import AdamWState, tree_map

# ROADMAP.md's items for what the port does not carry yet
EXTRAS_ITEM = "ROADMAP.md slice 11, item 19b"
REMAT_ITEM = "ROADMAP.md slice 6, item 8d"
TP_EXPERT_ITEM = "ROADMAP.md slice 8, item 13b"
COMPRESSIONS = ("none", "int8")


class TrainState(NamedTuple):
    """The JAX package's TrainState: ``err`` is the int8 gradient
    compression's error feedback (None without it); the same checkpoint
    keys (``err/...`` with it)."""
    params: Any
    opt: AdamWState
    err: Optional[Any] = None


def check_parallel(parallel: ParallelConfig) -> None:
    """Raise for the options the port does not carry yet.
    ``explicit_overlap`` is accepted and read nowhere, as in the JAX
    package: the overlap is FSDP's default path."""
    if parallel.multi_pod:
        raise NotImplementedError(f"multi_pod (a data axis across hosts): "
                                  f"{EXTRAS_ITEM}")
    if parallel.grad_compression not in COMPRESSIONS:
        raise ValueError(f"grad_compression={parallel.grad_compression!r}: "
                         f"one of {COMPRESSIONS}")
    if parallel.remat_policy != "nothing":
        raise NotImplementedError(f"remat_policy={parallel.remat_policy!r}: "
                                  f"the port checkpoints every layer and "
                                  f"saves nothing in it ('nothing'): "
                                  f"{REMAT_ITEM}")


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
    the shards.  ``ahead``: the gather, issued earlier (a ``Pending``),
    waited for here; ``sink``: takes the reduce-scatter, issued async, and
    the gradient is its output, read only once the sink's owner has waited
    for it."""

    @staticmethod
    def forward(ctx, local, p: Placement, group, ahead=None, sink=None):
        ctx.p, ctx.group, ctx.sink = p, group, sink
        if ahead is not None:
            return ahead.wait()
        return all_gather_dim(local, p.dim, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sink is None:
            return (reduce_scatter_dim(grad, ctx.p.dim, ctx.group),
                    None, None, None, None)
        pending = reduce_scatter_dim(grad, ctx.p.dim, ctx.group,
                                     async_op=True)
        ctx.sink(pending)
        return pending.out, None, None, None, None


# --------------------------------------------------------------------------- #
# The sharded state and step
# --------------------------------------------------------------------------- #
class FSDP:
    """A model's parameters sharded over a mesh's ``data`` axis and split
    over its ``model`` axis.  ``prefetch`` False gathers each layer where
    it is used and waits for each reduce-scatter at once (the same sums:
    for tests and A/B timing only)."""

    def __init__(self, model, mesh, parallel: ParallelConfig, device,
                 prefetch: bool = True):
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
        # per leaf (tree order), the groups splitting its last axis: the
        # int8 compression's slices span them
        self.last_axis_groups = [
            tuple(g for g, d, size in ((self.group, p.dim, self.world),
                                       (self.model_group, p.mdim,
                                        self.model_size))
                  if size > 1 and d == len(p.shape) - 1)
            for p in tree_leaves(self.placements)]
        self.param_group = param_group(mesh)
        self.prefetch = prefetch
        self._layers: list = []        # the step's per-layer Shard trees
        self._backward = False         # the step's backward has begun
        self._ahead = None             # (layer, its gathers in flight)
        self._in_flight = 0            # layers gathered ahead, not yet used
        self._scatters: list = []      # [(layer, reduce-scatter in flight)]
        self.prefetch_stats = {"layers": 0, "most_ahead": 0}

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

    def state_placements(self, err: bool = False) -> Dict[str, Placement]:
        """Checkpoint key -> placement, over a whole ``TrainState`` (with
        the compression's error tree: ``err``)."""
        whole = Placement(-1, ())
        tree = TrainState(self.placements, AdamWState(
            whole, self.placements, self.placements),
            self.placements if err else None)
        return dict(flatten_with_paths(tree))

    def state_leaves(self, state) -> Iterator[Tuple[str, Optional[Any]]]:
        """(checkpoint key, the whole leaf in host memory on global rank 0,
        None on the others), leaf by leaf: each leaf is gathered over
        ``data`` and ``model`` when it is reached, every rank taking part,
        so that no rank holds more than one whole leaf at a time."""
        where = self.state_placements(state.err is not None)
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
        ``Shard``s (each layer's views of the stacked groups).  With
        ``prefetch``, each stacked leaf's backward (which stacks its
        layers' gradients) first waits for its group's reduce-scatters
        still in flight."""
        groups = [f"g{gi}" for gi in range(len(self.model.layer_groups()))]
        out = {k: _zip_map(Shard, v, self.placements[k])
               for k, v in params.items() if k not in groups}
        out["layers"] = []
        for g, (n, _) in zip(groups, self.model.layer_groups()):
            per = tree_map(Placement.per_layer, self.placements[g])
            lo = len(out["layers"])
            out["layers"] += [_zip_map(Shard, lp, per)
                              for lp in layer_views(params[g], n)]
            for s in tree_leaves(out["layers"][lo]) if self.prefetch else ():
                if s.placement.dim >= 0 and s.local.grad_fn is not None:
                    s.local.grad_fn.register_prehook(
                        lambda _, lo=lo, hi=lo + n:
                        self._wait_scatters(lambda i: lo <= i < hi))
        self._layers = out["layers"]
        return out

    def gather(self, tree, layer: Optional[int] = None):
        """A tree of ``Shard``s -> this model rank's leaves, each gathered
        over ``data`` through ``_Gather`` (whole leaves as they are) on the
        parameter group.  ``layer``: the tree is that layer's; with
        ``prefetch`` its gathers were issued a layer ahead (in the forward
        while layer - 1 ran, in the backward while layer + 1 was recomputed
        and differentiated) and are waited for here, the next layer's are
        issued, and the reduce-scatters of its backward are left in flight
        (waited for two layers on, or where its stacked leaf's gradients
        are stacked)."""
        if layer is None or not self.prefetch:
            return self._gather(tree)
        ahead = None
        if self._ahead is not None:
            at, ahead = self._ahead
            self._ahead = None
            self._in_flight -= 1
            if at != layer:
                self._wait(ahead)
                raise RuntimeError(f"FSDP prefetch: layer {at} was gathered "
                                   f"ahead, layer {layer} came")
        out = self._gather(tree, ahead, lambda pending:
                           self._scatters.append((layer, pending)))
        if self._backward:
            # the parameter group ran these before this layer's gather,
            # just waited for: the wait costs nothing and frees their inputs
            self._wait_scatters(lambda i: i >= layer + 2)
        nxt = layer - 1 if self._backward else layer + 1
        if 0 <= nxt < len(self._layers):
            with torch.no_grad():
                self._ahead = (nxt, self._issue(self._layers[nxt]))
            self._in_flight += 1
            stats = self.prefetch_stats
            stats["layers"] += 1
            stats["most_ahead"] = max(stats["most_ahead"], self._in_flight)
        return out

    def _gather(self, tree, ahead=None, sink=None):
        if isinstance(tree, dict):
            return {k: self._gather(v, None if ahead is None else ahead[k],
                                    sink) for k, v in tree.items()}
        if tree.placement.dim < 0:
            return tree.local
        return _Gather.apply(tree.local, tree.placement, self.param_group,
                             ahead, sink)

    def _issue(self, tree):
        """A layer's gathers, issued async: the same tree of ``Pending``s
        (None for a leaf whole over ``data``)."""
        if isinstance(tree, dict):
            return {k: self._issue(v) for k, v in tree.items()}
        if tree.placement.dim < 0:
            return None
        return all_gather_dim(tree.local.detach(), tree.placement.dim,
                              self.param_group, async_op=True)

    @staticmethod
    def _wait(ahead) -> None:
        for pending in tree_leaves(ahead):
            pending.wait()

    def _settle(self) -> None:
        """After a step's backward (or a failed step): wait for whatever
        is still in flight and drop the step's layers."""
        self._wait_scatters(lambda i: True)
        if self._ahead is not None:
            self._wait(self._ahead[1])
        self._ahead, self._in_flight = None, 0
        self._backward, self._layers = False, []

    def _wait_scatters(self, which: Callable[[int], bool]) -> None:
        """Make the current stream wait for the reduce-scatters in flight
        of the layers ``which`` picks (their inputs are then released)."""
        left = []
        for layer, pending in self._scatters:
            if which(layer):
                pending.wait()
            else:
                left.append((layer, pending))
        self._scatters = left

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
            self.prefetch_stats = {"layers": 0, "most_ahead": 0}
            try:
                loss, metrics = self.model.loss(params, local, fsdp=self)
                self._backward = True
                loss.backward()
            finally:
                self._settle()
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
