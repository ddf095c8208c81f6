"""Expert-parallel MoE training: dp×ep over a ``{"data", "expert"}`` mesh
(counterpart of the JAX ``parallel/expert_parallel.py``).

The JAX package shards the stacked expert weights ``P(expert, ...)`` and
lets GSPMD turn the dispatch and combine einsums into all-to-alls. Here
each rank of the ``expert`` axis holds ``E/ep`` whole experts (rows
``[i·E/ep, (i+1)·E/ep)`` of ``w_up``, ``b_up``, ``w_down``, ``b_down``;
:func:`ep_param_specs`), and the tokens are replicated over ``expert``
(every rank of an expert group holds the same rows of the batch):

- the router, the routing (dispatch and combine over all ``E`` experts,
  the capacity of the whole layer) and the load-balance loss run on every
  rank, the same everywhere;
- the rank runs its own experts on the tokens routed to them and combines
  their outputs; the partial combines are summed over ``expert``
  (``tensor_parallel._ReduceFromModel``: the sum forward, identity
  backward). Megatron's ``f`` (identity forward, the gradient summed over
  ``expert`` backward) sits on the expert region's inputs, the layer input
  and the router probabilities, so every replicated parameter's gradient
  is the whole one on every rank. Under top-1 routing a token's combine has
  one nonzero entry, so the sum adds zeros and equals the unsharded combine;
- the loss is the masked next-token CE plus ``aux_loss_weight`` (0.01)
  times the sum of ``MoEMLP.load_balance`` over the layers (JAX
  ``expert_parallel.py:82-124``), each layer's balance taken over the
  global batch (:func:`global_load_balance`: it is a product of two means,
  not a mean over rows); the step returns ``(loss, aux)``; the gradients
  are averaged over ``data``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.models.moe import (
    MoEMLP,
    load_balance_loss,
    switch_route,
    topk_route,
)
from distributed_ml_pytorch_tpu_torch.parallel.tensor_parallel import (
    _CopyToModel,
    _ReduceFromModel,
)
from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh, flat_all_reduce
from distributed_ml_pytorch_tpu_torch.training.trainer import TrainState, _apply

_EXPERT_PARAMS = ("w_up", "b_up", "w_down", "b_down")


def ep_param_specs(tree: Mapping[str, object], expert_axis: str = "expert"
                   ) -> Dict[str, Optional[str]]:
    """``{name: expert_axis or None}``: the stacked expert weights shard
    their leading (expert) dim over ``expert_axis``; the rest is
    replicated. By name, so it applies to a ``state_dict`` or to
    ``named_parameters``."""
    return {name: (expert_axis if name.split(".")[-1] in _EXPERT_PARAMS else None)
            for name in tree}


def _check_experts(model, n_expert: int) -> None:
    if model.n_experts % n_expert:
        raise ValueError(
            f"model.n_experts={model.n_experts} is not divisible by the ep "
            f"axis size {n_expert} — each device must hold whole experts")


class _AllReduceSum(torch.autograd.Function):
    """``psum`` and its transpose: the sum over ``axis`` forward and
    backward (a replicated cotangent of a replicated sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x.clone().contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone().contiguous(), ctx.axis), None, None


def global_load_balance(probs: torch.Tensor, mesh: DeviceMesh, data_axis: str) -> torch.Tensor:
    """``moe.load_balance_loss`` over the global batch whose rows are
    sharded over ``data_axis`` (the JAX step sees the whole batch): the
    routed counts and the probability sums are summed over the axis before
    the means. Its gradient, summed over ``data`` and divided by the axis
    size as the step averages gradients, is the global loss's."""
    e = probs.shape[-1]
    n = probs.shape[0] * probs.shape[1] * mesh.axis_size(data_axis)
    onehot = (torch.argmax(probs, dim=-1)[..., None]
              == torch.arange(e, device=probs.device)).float()
    counts = mesh.all_reduce(onehot.sum(dim=(0, 1)).contiguous(), data_axis)
    sums = _AllReduceSum.apply(probs.sum(dim=(0, 1), dtype=torch.float32), mesh, data_axis)
    frac_tokens = (counts / n).to(probs.dtype)
    frac_probs = (sums / n).to(probs.dtype)
    return e * torch.sum(frac_tokens * frac_probs, dtype=torch.float32).to(probs.dtype)


class ExpertParallelMLP(MoEMLP):
    """A :class:`~distributed_ml_pytorch_tpu_torch.models.moe.MoEMLP` that
    holds experts ``[lo, lo + n_local)`` of ``n_experts`` and sums its
    partial combine over the mesh's ``expert`` axis."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh, axis, lo, n = self.mesh, self.axis, self.lo, self.n_local
        cap = self.capacity(x.shape[1])
        probs = torch.softmax(self.router(x).float(), dim=-1).to(x.dtype)
        if self.data_axis is None:
            self.load_balance = load_balance_loss(probs)
        else:
            self.load_balance = global_load_balance(probs, mesh, self.data_axis)
        probs = _CopyToModel.apply(probs, mesh, axis)
        x = _CopyToModel.apply(x, mesh, axis)
        if self.router_top_k == 1:
            dispatch, combine = switch_route(probs, cap)
        else:
            dispatch, combine = topk_route(probs, cap, k=self.router_top_k)
        dispatch, combine = dispatch[:, :, lo:lo + n], combine[:, :, lo:lo + n]
        pt = torch.promote_types(x.dtype, self.w_up.dtype)
        xin = torch.einsum("bsec,bsd->ebcd", dispatch, x).to(pt)
        h = torch.einsum("ebcd,edf->ebcf", xin, self.w_up) + self.b_up[:, None, None, :]
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("ebcf,efd->ebcd", h, self.w_down) + self.b_down[:, None, None, :]
        part = torch.einsum("bsec,ebcd->bsd", combine.to(pt), out)
        return _ReduceFromModel.apply(part, mesh, axis)


def shard_ep(model: nn.Module, mesh: DeviceMesh, expert_axis: str = "expert",
             data_axis: str = "data") -> nn.Module:
    """``model`` (a ``MoETransformerLM``, the same on every rank) turned
    into this rank's expert shard, in place: each block's ``moe`` becomes
    an :class:`ExpertParallelMLP` holding its ``E/ep`` experts, whose
    load-balance loss is the global batch's over ``data_axis`` (when the
    mesh has it and it is wider than one rank)."""
    ep, i = mesh.axis_size(expert_axis), mesh.axis_index(expert_axis)
    _check_experts(model, ep)
    n = model.n_experts // ep
    for blk in model.blocks():
        old = blk.moe
        with torch.device("meta"):
            new = ExpertParallelMLP(old.d_model, old.d_ff, old.n_experts, old.capacity_factor,
                                    old.dtype, router_top_k=old.router_top_k)
        new.router = old.router
        for name in _EXPERT_PARAMS:
            src = getattr(old, name)
            setattr(new, name, nn.Parameter(src.detach()[i * n:(i + 1) * n].clone()))
        new.mesh, new.axis, new.lo, new.n_local = mesh, expert_axis, i * n, n
        new.data_axis = (data_axis if data_axis in mesh.names
                         and mesh.axis_size(data_axis) > 1 else None)
        blk.moe = new
    model.ep_mesh, model.ep_axis = mesh, expert_axis
    return model


def create_ep_train_state(model: nn.Module, tx, mesh: DeviceMesh,
                          expert_axis: str = "expert", data_axis: str = "data") -> TrainState:
    """``model`` (built from its seed, or loaded from the JAX tree through
    ``utils/interop.params_from_jax``, the same on every rank) with its
    experts sharded over ``expert_axis`` (:func:`shard_ep`) and ``tx``'s
    state over the local parameters (the momentum mirrors the shards)."""
    shard_ep(model, mesh, expert_axis, data_axis)
    return TrainState(model, tx.init(list(model.parameters())))


def ep_layout(state: TrainState, expert_axis: str = "expert"):
    """The checkpoint layout of a :func:`create_ep_train_state` state
    (``utils/checkpoint``): the stacked expert weights are this rank's chunk
    of their leading dim, the rest replicated."""
    params = dict(state.model.named_parameters())
    specs = ep_param_specs(params, expert_axis)
    return [(name, p, () if specs[name] is None else (("split", expert_axis, 0),))
            for name, p in params.items()]


def make_ep_train_step(model: nn.Module, tx, mesh: DeviceMesh, expert_axis: str = "expert",
                       aux_loss_weight: float = 0.01, data_axis: str = "data") -> Callable:
    """The dp×ep MoE step: ``step(state, tokens, targets) -> (state, (loss,
    aux))`` on this data rank's rows (:func:`shard_ep_batch`) of a model
    :func:`create_ep_train_state` sharded. ``loss`` is the masked
    next-token CE, ``aux`` the load-balance loss summed over the layers
    (both the global batch's, device tensors); the objective is ``loss +
    aux_loss_weight·aux``."""
    _check_experts(model, mesh.axis_size(expert_axis))
    if getattr(model, "ep_mesh", None) is not mesh:
        raise ValueError("make_ep_train_step needs the model create_ep_train_state "
                         "sharded over this mesh")
    params = list(model.parameters())
    n_data = mesh.axis_size(data_axis)

    def step(state: TrainState, tokens, targets):
        model.train()
        tokens, targets = tokens.to(mesh.device), targets.to(mesh.device)
        logits = model(tokens)
        ce = F.cross_entropy(logits.transpose(1, 2), targets.long(), reduction="none")
        mask = torch.ones_like(ce)
        mask[:, -1] = 0.0
        ce_loss = torch.sum(ce * mask) / torch.sum(mask)
        aux = sum(torch.sum(a) for a in model.load_balance_losses())
        grads = list(torch.autograd.grad(ce_loss + aux_loss_weight * aux, params,
                                         allow_unused=True, materialize_grads=True))
        with torch.no_grad():
            grads = [g / n_data for g in flat_all_reduce(mesh, grads, data_axis)]
            metrics = torch.stack([ce_loss.detach().float(), aux.detach().float()])
            metrics = mesh.all_reduce(metrics, data_axis) / n_data
        _apply(tx, state.opt_state, params, grads)
        state.step += 1
        return state, (metrics[0], metrics[1])

    return step


def shard_ep_batch(mesh: DeviceMesh, tokens, targets, data_axis: str = "data"):
    """This data rank's rows of a global ``(batch, seq)`` pair (the tp
    path's placement: rows over ``data``, replicated over ``expert``)."""
    from distributed_ml_pytorch_tpu_torch.parallel.tensor_parallel import shard_tp_batch

    return shard_tp_batch(mesh, tokens, targets, data_axis)
