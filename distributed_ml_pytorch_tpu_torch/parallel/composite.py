"""Composite 3-D sharding: data × FSDP × tensor parallelism on one
``{"data", "fsdp", "model"}`` mesh (counterpart of the JAX
``parallel/composite.py``).

The JAX package expresses the whole strategy as one spec tree and lets
XLA derive the collectives. Here the layers are stacked by hand:

- Megatron tp over ``model`` (``tensor_parallel.shard_tp``: column- and
  row-parallel layers, the vocab-parallel head and cross-entropy, two sums
  over ``model`` a block);
- then ZeRO-3 over ``fsdp`` on each rank's tp shards, along the largest
  dimension tp left unsharded (:func:`composite_specs`, the JAX rule, with
  ``fsdp.largest_shardable_dim(shape, axis_size, taken)``), through
  ``fsdp.Sharding``: the shards gathered before the forward, freed after
  the backward, the gradients reduce-scattered (the mean over ``fsdp``);
- the batch is sharded over ``data`` × ``fsdp`` (one data-parallel group
  split only by how the parameters are laid out); the gradients are then
  averaged over ``data``, and the loss is the global batch's.

The same ``TransformerLM`` and the same loss as the tp path.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.parallel.fsdp import (
    FsdpState,
    largest_shardable_dim,
    shard_params,
)
from distributed_ml_pytorch_tpu_torch.parallel.tensor_parallel import (
    _check_divisibility,
    shard_tp,
    tp_lm_loss,
    tp_param_specs,
)
from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh, flat_all_reduce
from distributed_ml_pytorch_tpu_torch.training.optim import with_sq_norm
from distributed_ml_pytorch_tpu_torch.training.trainer import _apply


def composite_specs(tree: Mapping[str, object], fsdp_size: int, model_axis: str = "model",
                    fsdp_axis: str = "fsdp") -> Dict[str, Tuple]:
    """``{name: spec}`` merging the Megatron tp layout with FSDP: a tuple
    naming each dim's axis (``None``: not sharded). Start from
    ``tp_param_specs`` (one dim over ``model_axis`` or none), then shard
    the largest dimension not already claimed by ``model_axis`` over
    ``fsdp_axis``, provided it divides by ``fsdp_size``; a leaf with no
    such dim keeps its tp spec."""
    tp_specs = tp_param_specs(tree)
    out = {}
    for name, leaf in tree.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        entries = [None] * len(shape)
        d = tp_specs.get(name)
        if d is not None:
            entries[d] = model_axis
        if shape:
            taken = tuple(i for i, e in enumerate(entries) if e is not None)
            i = largest_shardable_dim(shape, fsdp_size, taken)
            if i is not None:
                entries[i] = fsdp_axis
        out[name] = tuple(entries)
    return out


class CompositeState(FsdpState):
    """An ``FsdpState`` over ``fsdp`` whose model is a ``shard_tp`` model
    over ``model``."""


def create_composite_train_state(model: nn.Module, tx, mesh: DeviceMesh,
                                 model_axis: str = "model", fsdp_axis: str = "fsdp"
                                 ) -> Tuple[CompositeState, Dict[str, Tuple]]:
    """``model`` (built from its seed or loaded from the JAX tree, the same
    on every rank) laid out per :func:`composite_specs`: tp-sharded over
    ``model_axis``, then each tp shard FSDP-sharded over ``fsdp_axis``
    along the dim tp left alone; ``tx``'s state lives on the final shards.
    Returns ``(state, specs)``, the specs over the full model's names."""
    _check_divisibility(model, mesh.axis_size(model_axis))
    specs = composite_specs(dict(model.named_parameters()), mesh.axis_size(fsdp_axis),
                            model_axis, fsdp_axis)
    shard_tp(model, mesh, model_axis)
    dims = [specs[name].index(fsdp_axis) if fsdp_axis in specs[name] else None
            for name, _ in model.named_parameters()]
    sh = shard_params(model, mesh, fsdp_axis, dims)
    return CompositeState(model, tx.init(sh.shards), sh), specs


def composite_layout(state: CompositeState, specs: Dict[str, Tuple], model_axis: str = "model",
                     fsdp_axis: str = "fsdp"):
    """The checkpoint layout of a composite state (``utils/checkpoint``): a
    leaf's tp chunk over ``model_axis``, then its FSDP rows over
    ``fsdp_axis`` (the shard this rank stores)."""
    sh = state.sharding
    out = []
    for j, (name, _) in enumerate(state.model.named_parameters()):
        ops = []
        if model_axis in specs[name]:
            ops.append(("split", model_axis, specs[name].index(model_axis)))
        if sh.dims[j] is not None:
            ops.append(("rows", fsdp_axis, sh.dims[j]))
        out.append((name, sh.shards[j], tuple(ops)))
    return out


def _sq_norm_fn(specs_local, mesh: DeviceMesh, model_axis: str, fsdp_axis: str) -> Callable:
    """The squared global norm of the composite shards: each leaf's squares
    summed over the axes it is sharded over."""
    groups = {}
    for j, spec in enumerate(specs_local):
        key = tuple(a for a in (fsdp_axis, model_axis) if a in spec)
        groups.setdefault(key, []).append(j)

    def sq_norm(grads):
        total = torch.zeros((), device=mesh.device)
        for axes, idx in groups.items():
            part = sum((torch.sum(grads[j] * grads[j]) for j in idx),
                       torch.zeros((), device=mesh.device)).reshape(1)
            for a in axes:
                part = mesh.all_reduce(part, a)
            total = total + part[0]
        return total

    return sq_norm


def make_composite_train_step(model: nn.Module, tx, mesh: DeviceMesh,
                              specs: Mapping[str, Tuple], data_axis: str = "data",
                              fsdp_axis: str = "fsdp", model_axis: str = "model") -> Callable:
    """The 3-D (dp×fsdp×tp) LM step: ``step(state, tokens, targets) ->
    (state, loss)`` on this rank's rows (:func:`shard_composite_batch`) of
    a :func:`create_composite_train_state` state, ``specs`` the layout it
    returned; ``loss`` is the global batch's (a device tensor)."""
    if getattr(model, "tp_mesh", None) is not mesh:
        raise ValueError("make_composite_train_step needs the model "
                         "create_composite_train_state sharded over this mesh")
    n_data, n_fsdp = mesh.axis_size(data_axis), mesh.axis_size(fsdp_axis)
    sq = _sq_norm_fn([specs[n] for n, _ in model.named_parameters()], mesh, model_axis,
                     fsdp_axis)

    def step(state: CompositeState, tokens, targets):
        sh = state.sharding
        sh.gather()
        try:
            model.train()
            loss = tp_lm_loss(model, tokens.to(mesh.device), targets.to(mesh.device))
            grads = torch.autograd.grad(loss, sh.params, allow_unused=True,
                                        materialize_grads=True)
        finally:
            sh.free()
        with torch.no_grad():
            grads = sh.reduce_grads(grads)
            grads = [g / n_data for g in flat_all_reduce(mesh, grads, data_axis)]
            loss = loss.detach().float().reshape(1)
            loss = mesh.all_reduce(mesh.all_reduce(loss, fsdp_axis), data_axis)[0]
            loss = loss / (n_fsdp * n_data)
        _apply(with_sq_norm(tx, sq), state.opt_state, sh.shards, grads)
        state.step += 1
        return state, loss

    return step


def shard_composite_batch(mesh: DeviceMesh, tokens, targets, data_axis: str = "data",
                          fsdp_axis: str = "fsdp"):
    """This rank's rows of a global ``(batch, seq)`` pair: the batch split
    over ``data`` × ``fsdp`` (data-major), int64 tensors on the device."""
    n = mesh.axis_size(data_axis) * mesh.axis_size(fsdp_axis)
    i = mesh.axis_index(data_axis) * mesh.axis_size(fsdp_axis) + mesh.axis_index(fsdp_axis)
    out = []
    for a in (tokens, targets):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not divide over {n} data x fsdp ranks")
        b = t.shape[0] // n
        out.append(t[i * b:(i + 1) * b].long().contiguous().to(mesh.device))
    return tuple(out)
