"""Fully-sharded data parallelism (ZeRO-3) and the LM train steps
(counterpart of the JAX ``parallel/fsdp.py``).

The JAX package annotates every leaf with a shape-based ``PartitionSpec``
and lets GSPMD insert the all-gather and the reduce-scatter. Here the
lifecycle is written out, over the mesh's ``data`` axis:

- every leaf shards its **largest dimension divisible by the axis size**,
  ties toward the trailing dim (:func:`largest_shardable_dim`, the JAX
  rule); a leaf with no such dim is replicated. The port's layouts are not
  the flax ones (OIHW against HWIO, ``(V, D)`` against ``(D, V)``), so the
  sharded dim's index may differ, but the set of leaves that shard does
  not, and :func:`param_shard_fraction` equals JAX's;
- each rank keeps only its shard of every sharded parameter and of its
  optimizer state (the optimizer runs on the shards, ZeRO's saving);
- a step gathers the full leaves (one ``all_gather`` of every shard
  flattened into one buffer) before the forward, frees them after the
  backward, ``reduce_scatter``s the gradients (one buffer, SUM, divided by
  the axis size: the mean), averages the replicated leaves' gradients with
  an ``all_reduce`` and lets the optimizer update the shards. Global-norm
  clipping sums the squared shards over the axis (:meth:`Sharding.sq_norm`).
  Whole-model gathering; per-layer prefetch is later work.

The step equals sync DP's (``parallel/sync.py``): the same mean gradient,
the same update. Every rank builds the full model from the seed on the host
and keeps its shard, so values do not depend on the mesh's shape.

The one-device LM steps stay: ``make_fsdp_lm_train_step(model, tx)``
without a mesh is the JAX ``--mode single`` ("fsdp on a one-device mesh"),
and :func:`make_fsdp_lm_scan_train_step` its K-step form, on the card one
step captured as a CUDA graph and replayed K times.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh, flat_all_reduce
from distributed_ml_pytorch_tpu_torch.training.optim import with_sq_norm
from distributed_ml_pytorch_tpu_torch.training.trainer import (
    SGD,
    TrainState,
    _apply,
    _as_tensors,
    _make_k_step,
    chunked_lm_loss,
    cross_entropy_loss,
)

# ------------------------------------------------------------------ the LM loss


def lm_loss_builder(model: nn.Module, loss_chunk: int = 0) -> Callable:
    """``loss_fn(tokens, targets) -> loss``: the masked-mean next-token CE
    with the final position masked.

    A model with a detachable head (``TransformerLM``) runs its body, then
    the ``lm_head`` product on 2-D ``(b·s, d)`` hidden states in the
    activation dtype and the CE with integer labels, and divides the masked
    sum by the mask's sum (both in the CE's dtype, as the JAX loss does).
    ``loss_chunk > 0`` computes the same loss sequence-chunked
    (:func:`~distributed_ml_pytorch_tpu_torch.training.trainer.chunked_lm_loss`).
    """

    def loss_fn(tokens, targets):
        if loss_chunk > 0:
            return chunked_lm_loss(model, tokens, targets, chunk=loss_chunk)
        if getattr(model, "head", None) is True:
            hidden = model.hidden(tokens)
            b, s, dm = hidden.shape
            logits = F.linear(hidden.reshape(b * s, dm), model.lm_head.weight.to(hidden.dtype))
            ce = F.cross_entropy(logits, targets.reshape(-1).long(), reduction="none")
            mask = torch.ones((b, s), dtype=ce.dtype, device=ce.device)
            mask[:, -1] = 0.0
            return torch.sum(ce * mask.reshape(-1)) / torch.sum(mask)
        logits = model(tokens)
        ce = F.cross_entropy(logits.transpose(1, 2), targets.long(), reduction="none")
        mask = torch.ones_like(ce)
        mask[:, -1] = 0.0
        return torch.sum(ce * mask) / torch.sum(mask)

    return loss_fn


def _lm_step_body(model: nn.Module, tx, params, loss_fn, opt_state) -> Callable:
    """``body(tokens, targets, generator) -> loss``: forward and backward of
    ``loss_fn``, then ``tx``'s update applied to ``params`` in place. It
    touches no host state (the step count is its caller's), so a CUDA graph
    can capture it; ``generator`` is unused (the LM draws no random
    numbers)."""

    def body(tokens, targets, generator=None):
        model.train()
        for p in params:
            p.grad = None
        loss = loss_fn(tokens, targets)
        loss.backward()
        # a parameter the loss does not reach (a head=False model's lm_head)
        # has no .grad: its gradient is zero, as JAX's AD gives it
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        updates = tx.update(grads, opt_state)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        return loss.detach()

    return body


def make_fsdp_lm_train_step(model: nn.Module, tx: SGD, mesh: Optional[DeviceMesh] = None,
                            axis: str = "data", loss_chunk: int = 0) -> Callable:
    """``step(state, tokens, targets) -> (state, loss)``: forward and
    backward of :func:`lm_loss_builder`'s loss, then ``tx``'s update.

    Without ``mesh``, the one-device step (parameters updated in place).
    With ``mesh``, the ZeRO-3 step over ``axis`` on an :class:`FsdpState`
    (:func:`create_fsdp_train_state`): ``tokens``/``targets`` are this
    rank's rows of the global batch (:func:`shard_fsdp_batch`) and ``loss``
    is the global batch's. ``loss`` is a device tensor (reading it
    synchronizes)."""
    if mesh is not None:
        return make_sharded_step(tx, mesh, lm_sharded_loss(model, loss_chunk), axis)
    params = list(model.parameters())
    loss_fn = lm_loss_builder(model, loss_chunk)

    def step(state: TrainState, tokens: torch.Tensor, targets: torch.Tensor):
        loss = _lm_step_body(model, tx, params, loss_fn, state.opt_state)(tokens, targets)
        state.step += 1
        return state, loss

    return step


def make_fsdp_lm_scan_train_step(model: nn.Module, tx: SGD, steps_per_dispatch: int = 0,
                                 loss_chunk: int = 0) -> Callable:
    """K one-device steps a dispatch (the JAX ``train_lm``'s ``lax.scan``
    over :func:`make_fsdp_lm_train_step`): ``scan(state, tokens [K, B, S],
    targets [K, B, S]) -> (state, losses [K])``, each step exactly
    :func:`make_fsdp_lm_train_step`'s on its own batch (equal to K calls of
    it, tested). On the card one step is captured as a CUDA graph and
    replayed K times (``training.trainer.GraphedSteps``, its buffers sized
    for ``steps_per_dispatch``); on the CPU a loop. ``state.step`` advances
    by K after the dispatch, never inside the captured step."""
    params = list(model.parameters())
    loss_fn = lm_loss_builder(model, loss_chunk)
    return _make_k_step(model, lambda state: _lm_step_body(
        model, tx, params, loss_fn, state.opt_state), steps_per_dispatch)


# ------------------------------------------------------------------ the sharding rule


def largest_shardable_dim(shape: Sequence[int], axis_size: int, taken=()) -> Optional[int]:
    """Index of the largest dimension divisible by ``axis_size`` that is not
    in ``taken``, or ``None``; ties break toward the trailing dim (the JAX
    rule)."""
    order = sorted((i for i in range(len(shape)) if i not in taken),
                   key=lambda i: (shape[i], i), reverse=True)
    for i in order:
        if shape[i] >= axis_size and shape[i] % axis_size == 0:
            return i
    return None


def fsdp_specs(tree: Mapping[str, object], axis_size: int) -> Dict[str, Optional[int]]:
    """``{name: sharded dim or None}`` for a mapping of names to tensors or
    shapes (a ``state_dict``, ``named_parameters``): each leaf's
    :func:`largest_shardable_dim`; scalars and leaves with no such dim are
    replicated (``None``)."""
    out = {}
    for name, leaf in tree.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        out[name] = largest_shardable_dim(shape, axis_size) if shape else None
    return out


# ------------------------------------------------------------------ the sharded state


@dataclass
class Sharding:
    """The ZeRO-3 layout of a model's parameters over one mesh axis.

    ``dims[j]`` is parameter ``j``'s sharded dim (``None``: replicated);
    ``shards[j]`` is what this rank keeps of it (the rows of the sharded dim
    moved to the front, contiguous; a replicated parameter itself). A
    sharded parameter's ``data`` is empty between steps; :meth:`gather`
    fills it with the full leaf in its own strides (a channels-last conv
    weight stays channels-last) and :meth:`free` empties it again."""

    mesh: DeviceMesh
    axis: str
    params: List[nn.Parameter]
    dims: List[Optional[int]]
    shards: List[torch.Tensor]
    strides: List[tuple] = field(default_factory=list)
    _empty: List[torch.Tensor] = field(default_factory=list, repr=False)

    @property
    def sharded(self) -> List[int]:
        return [j for j, d in enumerate(self.dims) if d is not None]

    @property
    def replicated(self) -> List[int]:
        return [j for j, d in enumerate(self.dims) if d is None]

    def gather(self) -> None:
        """Every sharded parameter's full value in its ``data`` (one
        ``all_gather`` of the flattened shards)."""
        idx = self.sharded
        if not idx:
            return
        flat = torch.cat([self.shards[j].reshape(-1) for j in idx])
        n = self.mesh.axis_size(self.axis)
        full = self.mesh.all_gather(flat, self.axis).view(n, -1)
        off = 0
        with torch.no_grad():
            for j in idx:
                p, d, shard = self.params[j], self.dims[j], self.shards[j]
                m = shard.numel()
                moved = full[:, off:off + m].reshape(n * shard.shape[0], *shard.shape[1:])
                off += m
                shape = list(moved.shape)
                shape.insert(d, shape.pop(0))
                dst = torch.empty_strided(tuple(shape), self.strides[j], dtype=shard.dtype,
                                          device=shard.device)
                dst.copy_(moved.movedim(0, d))
                p.data = dst

    def free(self) -> None:
        """Drop the gathered full leaves (the sharded parameters' ``data``
        becomes empty)."""
        for j in self.sharded:
            self.params[j].data = self._empty[j]

    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the axis of full-shape gradients, laid out as the
        shards: one ``reduce_scatter`` of the sharded leaves (rank ``r``'s
        rows of every leaf gathered into its chunk of one buffer) and one
        ``all_reduce`` of the replicated ones, each divided by the axis
        size."""
        n = self.mesh.axis_size(self.axis)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        idx = self.sharded
        if idx:
            chunks = torch.cat([grads[j].movedim(self.dims[j], 0).reshape(n, -1)
                                for j in idx], dim=1)
            mine = self.mesh.reduce_scatter(chunks.reshape(-1), self.axis)
            off = 0
            for j in idx:
                m = self.shards[j].numel()
                out[j] = mine[off:off + m].view(self.shards[j].shape) / n
                off += m
        rep = self.replicated
        if rep:
            for j, g in zip(rep, flat_all_reduce(self.mesh, [grads[j] for j in rep],
                                                 self.axis)):
                out[j] = g / n
        return out

    def sq_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The squared global norm of sharded gradients: the shards' squares
        summed over the axis, plus the replicated leaves' once."""
        local = sum((torch.sum(grads[j] * grads[j]) for j in self.sharded),
                    torch.zeros((), device=self.mesh.device))
        total = self.mesh.all_reduce(local.reshape(1), self.axis)[0]
        return total + sum(torch.sum(grads[j] * grads[j]) for j in self.replicated)


def shard_params(model: nn.Module, mesh: DeviceMesh, axis: str = "data",
                 dims: Optional[Sequence[Optional[int]]] = None) -> Sharding:
    """``model``'s parameters sharded over ``axis`` (:class:`Sharding`):
    each rank keeps its rows of every sharded leaf and frees the rest.
    ``dims`` gives each parameter's sharded dim (``None``: replicated);
    by default each leaf's :func:`largest_shardable_dim`."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    params = list(model.parameters())
    if dims is None:
        dims = [largest_shardable_dim(tuple(p.shape), n) if p.dim() else None for p in params]
    shards, strides, empty = [], [], []
    with torch.no_grad():
        for p, d in zip(params, dims):
            strides.append(p.stride())
            empty.append(torch.empty(0, dtype=p.dtype, device=p.device))
            if d is None:
                shards.append(p.data)
                continue
            rows = p.shape[d] // n
            shards.append(p.data.movedim(d, 0)[i * rows:(i + 1) * rows].contiguous())
    sh = Sharding(mesh, axis, params, list(dims), shards, strides, empty)
    sh.free()
    return sh


class FsdpState(TrainState):
    """A :class:`~distributed_ml_pytorch_tpu_torch.training.trainer.TrainState`
    whose optimizer state lives on the shards of :attr:`sharding`."""

    def __init__(self, model, opt_state, sharding: Sharding, step: int = 0, generator=None):
        super().__init__(model, opt_state, step, generator)
        self.sharding = sharding


def fsdp_layout(state: FsdpState):
    """The checkpoint layout of an :class:`FsdpState` (``utils/checkpoint``):
    each parameter's shard, its sharded dim moved to the front and chunked
    over the axis (``rows``), or the replicated leaf itself."""
    sh = state.sharding
    return [(name, sh.shards[j], () if sh.dims[j] is None else (("rows", sh.axis, sh.dims[j]),))
            for j, (name, _) in enumerate(state.model.named_parameters())]


def create_fsdp_train_state(model: nn.Module, tx, mesh: DeviceMesh, axis: str = "data",
                            generator=None) -> FsdpState:
    """``model`` (built from its seed, the same on every rank) sharded over
    ``axis``, with ``tx``'s state over the shards (momentum mirrors the
    shards leaf for leaf)."""
    sharding = shard_params(model, mesh, axis)
    return FsdpState(model, tx.init(sharding.shards), sharding, 0, generator)


# ------------------------------------------------------------------ the sharded steps


def _sharded_update(tx, mesh: DeviceMesh, axis: str, loss_builder: Callable,
                    state: FsdpState, *batch) -> torch.Tensor:
    """The one ZeRO-3 update (gather → forward/backward → free →
    reduce-scatter → the optimizer on the shards), shared by the per-step
    and K-step dispatchers."""
    sh = state.sharding
    sh.gather()
    try:
        state.model.train()
        loss = loss_builder(state, *batch)
        grads = torch.autograd.grad(loss, sh.params, allow_unused=True,
                                    materialize_grads=True)
    finally:
        sh.free()
    with torch.no_grad():
        grads = sh.reduce_grads(grads)
        n = mesh.axis_size(axis)
        loss = mesh.all_reduce(loss.detach().float().reshape(1), axis)[0] / n
    _apply(with_sq_norm(tx, sh.sq_norm), state.opt_state, sh.shards, grads)
    state.step += 1
    return loss


def make_sharded_step(tx, mesh: DeviceMesh, loss_builder: Callable, axis: str = "data"
                      ) -> Callable:
    """``step(state, *batch) -> (state, loss)`` over an :class:`FsdpState`:
    ``loss_builder(state, *batch) -> loss`` is computed with the gathered
    parameters on this rank's rows of the batch; the ZeRO-3 update follows
    (:func:`_sharded_update`)."""

    def step(state: FsdpState, *batch):
        return state, _sharded_update(tx, mesh, axis, loss_builder, state, *batch)

    return step


def make_sharded_scan_step(tx, mesh: DeviceMesh, loss_builder: Callable,
                           axis: str = "data") -> Callable:
    """K sharded updates a dispatch: ``scan(state, xs [K, b, ...], ys [K,
    b]) -> (state, losses [K])``, each :func:`make_sharded_step`'s update
    (equal to K calls of it bit for bit)."""

    def scan(state: FsdpState, xs, ys):
        losses = [_sharded_update(tx, mesh, axis, loss_builder, state, xs[i], ys[i])
                  for i in range(xs.shape[0])]
        return state, torch.stack(losses)

    return scan


def cnn_loss_builder(model: nn.Module, mesh: DeviceMesh, axis: str = "data",
                     seed: int = 0) -> Callable:
    """The CNN loss on this rank's rows as a :func:`make_sharded_step` loss
    builder; dropout draws from ``sync.dropout_generator(seed, step,
    rank)``, as sync DP's do."""
    from distributed_ml_pytorch_tpu_torch.parallel.sync import dropout_generator

    def loss_builder(state, images, labels):
        x, y = _as_tensors(images, labels)
        gen = dropout_generator(seed, state.step, mesh.axis_index(axis), mesh.device)
        return cross_entropy_loss(model(x.to(mesh.device), generator=gen), y.to(mesh.device))

    return loss_builder


def lm_sharded_loss(model: nn.Module, loss_chunk: int = 0) -> Callable:
    """:func:`lm_loss_builder` as a :func:`make_sharded_step` loss builder
    (the rank's rows of the batch; the masked mean over them is the global
    mean's share, every rank holding as many rows)."""
    loss_fn = lm_loss_builder(model, loss_chunk)
    return lambda state, tokens, targets: loss_fn(tokens, targets)


def make_fsdp_train_step(model: nn.Module, tx, mesh: DeviceMesh, axis: str = "data",
                         seed: int = 0) -> Callable:
    """The ZeRO-3 CNN step: ``step(state, images, labels) -> (state,
    loss)`` over this rank's rows (:func:`shard_fsdp_batch`); semantically
    ``sync.make_sync_train_step``'s, only the layout differs."""
    return make_sharded_step(tx, mesh, cnn_loss_builder(model, mesh, axis, seed), axis)


def shard_fsdp_batch(mesh: DeviceMesh, *arrays, axis: str = "data"):
    """This rank's rows of global batch arrays (``sync.shard_batch``)."""
    from distributed_ml_pytorch_tpu_torch.parallel.sync import shard_batch

    return shard_batch(mesh, *arrays, axis=axis)


def param_shard_fraction(state: FsdpState, mesh: Optional[DeviceMesh] = None) -> float:
    """Bytes of this rank's parameter shards over the full parameters'
    bytes: about 1/N when the big leaves shard (the JAX function's
    measure)."""
    sh = state.sharding
    n = sh.mesh.axis_size(sh.axis)
    local = total = 0
    for j, shard in enumerate(sh.shards):
        size = shard.element_size()
        full = shard.numel() * (n if sh.dims[j] is not None else 1)
        total += full * size
        local += shard.numel() * size
    return local / total if total else 1.0


def train_fsdp(args, mesh: Optional[DeviceMesh] = None):
    """Fully-sharded data-parallel training (``--mode fsdp``): the driver of
    ``--mode sync`` (``sync.train_data_parallel``) with the state sharded
    per :func:`fsdp_specs`. ``--ckpt-dir`` saves the global tree
    (``utils/checkpoint.ShardedCheckpointer`` over :func:`fsdp_layout`),
    and ``--resume`` restores it into the full model before the sharding,
    as the JAX driver restores before placement."""
    from distributed_ml_pytorch_tpu_torch.parallel.sync import train_data_parallel

    seed = getattr(args, "seed", 0) + 1

    def strategy(model, tx, mesh, state):
        state = create_fsdp_train_state(model, tx, mesh, generator=state.generator)
        frac = param_shard_fraction(state, mesh)
        step = make_fsdp_train_step(model, tx, mesh, seed=seed)
        scan = make_sharded_scan_step(tx, mesh, cnn_loss_builder(model, mesh, seed=seed))

        def sharded_step(state, bx, by):
            return step(state, *shard_fsdp_batch(mesh, bx, by))

        def sharded_scan(state, bxs, bys):
            from distributed_ml_pytorch_tpu_torch.parallel.sync import shard_batch

            xs, ys = _as_tensors(bxs, bys)
            return scan(state, *shard_batch(mesh, xs, ys, dim=1))

        hooks = (state.sharding.gather, state.sharding.free)
        return state, sharded_step, sharded_scan, f", {frac:.3f} of params/rank", hooks

    return train_data_parallel(args, mesh, strategy, "FSDP", sharded=("fsdp", fsdp_layout))
