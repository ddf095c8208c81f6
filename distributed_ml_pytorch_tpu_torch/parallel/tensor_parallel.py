"""Megatron tensor parallelism for the Transformer LM over a ``{"data",
"model"}`` mesh (counterpart of the JAX ``parallel/tensor_parallel.py``).

The JAX package annotates the parameters and lets GSPMD insert the
collectives. Here each rank holds a rank-local copy of the model with its
shards (:func:`shard_tp`) and the collectives are Megatron's, written as
``torch.autograd.Function`` pairs over the mesh's ``model`` axis:

- ``f`` (identity forward, ``all_reduce`` backward) at the input of a
  column-parallel layer: the attention block's input (its q/k/v), the MLP's
  ``Dense_0`` and the ``lm_head``;
- ``g`` (``all_reduce`` forward, identity backward) at the output of a
  row-parallel layer: the attention's ``o`` and the MLP's ``Dense_1``, whose
  bias is added after the sum. The sums run in float32 and are rounded to
  the activation dtype once;
- a vocab-parallel cross-entropy: the max and the sum of exponentials
  ``all_reduce``d over ``model``, the target's logit taken from the rank
  that holds it;
- the gradients are averaged over ``data``.

The layout is the JAX table's on the port's ``(out, in)`` weights
(:func:`tp_param_specs`): q/k/v and ``Dense_0`` (with its bias) shard their
output features, ``o`` and ``Dense_1`` their input features, ``lm_head``
its vocabulary rows; everything else is replicated. A fused ``qkv`` is
replicated as in JAX's table; each rank slices its heads' rows and its
gradient is summed over ``model``. DTensor is not used: it needs the default
process group (ruling out a world of threads), and explicit calls keep the
order of the reductions in view.

Attention runs on each rank's ``n_heads / tp`` local heads through
``auto_attention`` (the flash kernels K4, K5 or K6 on the card): attention
is rank-local by construction, which is what the JAX package's
``make_sharded_attn_fn``/``gspmd_safe_lm`` islands are for under GSPMD.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.models.transformer import Dense
from distributed_ml_pytorch_tpu_torch.runtime.mesh import (
    DeviceMesh,
    flat_all_reduce,
    rows_of,
)
from distributed_ml_pytorch_tpu_torch.training.optim import with_sq_norm
from distributed_ml_pytorch_tpu_torch.training.trainer import TrainState, _apply

# ------------------------------------------------------------------ the layout


def tp_param_specs(tree: Mapping[str, object]) -> Dict[str, Optional[int]]:
    """``{name: sharded dim or None}`` over ``model`` for a ``TransformerLM``
    ``state_dict`` (or any mapping of its parameter names to tensors or
    shapes), by name as the JAX table is by path:

    ==========================  ============  ===========
    parameter                   shape         sharded dim
    ==========================  ============  ===========
    ``attn.{q,k,v}.weight``     (d, d)        0 (columns)
    ``attn.o.weight``           (d, d)        1 (rows)
    ``Dense_0.weight``          (d_ff, d)     0
    ``Dense_0.bias``            (d_ff,)       0
    ``Dense_1.weight``          (d, d_ff)     1
    ``lm_head.weight``          (vocab, d)    0
    everything else             —             None
    ==========================  ============  ===========
    """
    out = {}
    for name, leaf in tree.items():
        parts = name.split(".")
        ndim = len(tuple(getattr(leaf, "shape", leaf)))
        spec = None
        if "attn" in parts and len(parts) >= 2 and parts[-2] in ("q", "k", "v"):
            spec = 0
        elif "attn" in parts and len(parts) >= 2 and parts[-2] == "o":
            spec = 1
        elif "Dense_0" in parts:
            spec = 0
        elif "Dense_1" in parts:
            spec = 1 if ndim == 2 else None
        elif "lm_head" in parts and ndim == 2:
            spec = 0
        out[name] = spec
    return out


def _check_divisibility(model, n_model: int) -> None:
    for name, dim in (("n_heads", model.n_heads), ("d_ff", model.d_ff),
                      ("vocab_size", model.vocab_size)):
        if dim % n_model:
            raise ValueError(f"model.{name}={dim} is not divisible by the tp axis size "
                             f"{n_model} — the sharded dimension must split evenly")


# ------------------------------------------------------------------ Megatron's f and g


def _sum_over(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``axis`` in float32, returned in ``x``'s dtype."""
    y = x.to(torch.float32, copy=True).contiguous()
    mesh.all_reduce(y, axis)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """``f``: identity forward, the gradient summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(ctx.mesh, ctx.axis, g), None, None


class _ReduceFromModel(torch.autograd.Function):
    """``g``: the partial products summed over ``model`` forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum_over(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _VocabParallelCE(torch.autograd.Function):
    """Per-row cross-entropy of vocab-sharded logits ``(N, V/tp)`` (rows
    ``lo .. lo + V/tp`` of the vocabulary on this rank), in float32."""

    @staticmethod
    def forward(ctx, logits, targets, lo, mesh, axis):
        x = logits.float()
        m = x.max(dim=-1).values
        mesh.all_reduce(m, axis, op="max")
        x = x - m[:, None]
        e = torch.exp(x)
        s = mesh.all_reduce(e.sum(dim=-1), axis)
        vl = logits.shape[-1]
        local = targets - lo
        hit = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        tgt = x.gather(1, idx[:, None])[:, 0] * hit
        tgt = mesh.all_reduce(tgt.contiguous(), axis)
        ctx.save_for_backward(e / s[:, None], idx, hit)
        ctx.dtype = logits.dtype
        return torch.log(s) - tgt

    @staticmethod
    def backward(ctx, g):
        p, idx, hit = ctx.saved_tensors
        grad = p.clone()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, idx] -= hit.to(grad.dtype)
        return (grad * g[:, None]).to(ctx.dtype), None, None, None, None


class ColumnParallelDense(Dense):
    """A ``Dense`` holding this rank's output features; ``f`` at its input."""

    def forward(self, x):
        x = _CopyToModel.apply(x, self.mesh, self.axis)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class RowParallelDense(Dense):
    """A ``Dense`` holding this rank's input features: the partial product
    summed over ``model`` (``g``), then the (replicated) bias."""

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        y = _ReduceFromModel.apply(y, self.mesh, self.axis)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class VocabParallelHead(Dense):
    """The ``lm_head`` holding this rank's vocabulary rows; ``f`` at its
    input. ``gather_output`` (decode) returns the full logits (an
    ``all_gather`` over ``model``); training keeps them sharded for
    :func:`vocab_parallel_cross_entropy`."""

    gather_output = False

    def forward(self, x):
        x = _CopyToModel.apply(x, self.mesh, self.axis)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if not self.gather_output:
            return y
        return self.mesh.all_gather(y.movedim(-1, 0), self.axis).movedim(0, -1)


class HeadSlicedQKV(Dense):
    """A replicated fused ``qkv`` (``(3d, d)``, as JAX's table leaves it)
    that computes this rank's heads only: rows ``rows`` of the weight, in
    q, k, v order. Its gradient is nonzero on those rows alone and is
    summed over ``model`` by the step (``tp_partial``)."""

    def forward(self, x):
        w = self.weight.index_select(0, self.rows).to(self.dtype)
        return F.linear(x.to(self.dtype), w)


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 mesh: DeviceMesh, axis: str = "model") -> torch.Tensor:
    """Per-row CE ``(N,)`` float32 of ``(N, V/tp)`` logits sharded over
    ``axis`` against global ``targets`` ``(N,)``."""
    lo = mesh.axis_index(axis) * logits.shape[-1]
    return _VocabParallelCE.apply(logits, targets.long(), lo, mesh, axis)


# ------------------------------------------------------------------ the local model


def _replace(src: Dense, cls, weight: torch.Tensor, bias: Optional[torch.Tensor],
             mesh: DeviceMesh, axis: str) -> Dense:
    """A ``cls`` Dense of ``weight``'s shape holding ``weight``/``bias``
    (copies), on ``src``'s device and dtype."""
    with torch.device("meta"):
        new = cls(weight.shape[1], weight.shape[0], bias=bias is not None, dtype=src.dtype)
    new.weight = nn.Parameter(weight.detach().clone(), requires_grad=src.weight.requires_grad)
    if bias is not None:
        new.bias = nn.Parameter(bias.detach().clone(), requires_grad=src.bias.requires_grad)
    new.mesh, new.axis = mesh, axis
    return new


def shard_tp_block(blk: nn.Module, mesh: DeviceMesh, axis: str = "model",
                   shard_fused_qkv: bool = False) -> nn.Module:
    """One ``Block`` turned into this rank's Megatron shard along ``axis``,
    in place (see :func:`shard_tp`); returns it. ``parallel/pipeline.py``
    shards each stage's blocks this way under ``model_axis``."""
    tp, m = mesh.axis_size(axis), mesh.axis_index(axis)

    def rows(n: int) -> slice:
        return slice(m * (n // tp), (m + 1) * (n // tp))

    attn = blk.attn
    d, dl = attn.d_model, attn.d_model // tp
    if attn.fused_qkv:
        w = attn.qkv.weight
        idx = torch.cat([torch.arange(i * d, (i + 1) * d, device=w.device)[rows(d)]
                         for i in range(3)])
        if shard_fused_qkv:
            attn.qkv = _replace(attn.qkv, Dense, w[idx], None, mesh, axis)
        else:
            new = _replace(attn.qkv, HeadSlicedQKV, w, None, mesh, axis)
            new.register_buffer("rows", idx, persistent=False)
            new.weight.tp_partial = True
            attn.qkv = new
    else:
        for name in ("q", "k", "v"):
            src = getattr(attn, name)
            setattr(attn, name, _replace(src, Dense, src.weight[rows(d)], None, mesh, axis))
    attn.o = _replace(attn.o, RowParallelDense, attn.o.weight[:, rows(d)], None, mesh, axis)
    attn.d_model, attn.n_heads = dl, attn.n_heads // tp
    attn.register_forward_pre_hook(
        lambda mod, args: (_CopyToModel.apply(args[0], mesh, axis), *args[1:]))
    ff = blk.Dense_0.weight.shape[0]
    blk.Dense_0 = _replace(blk.Dense_0, ColumnParallelDense, blk.Dense_0.weight[rows(ff)],
                           blk.Dense_0.bias[rows(ff)], mesh, axis)
    blk.Dense_1 = _replace(blk.Dense_1, RowParallelDense, blk.Dense_1.weight[:, rows(ff)],
                           blk.Dense_1.bias, mesh, axis)
    return blk


def shard_tp(model: nn.Module, mesh: DeviceMesh, axis: str = "model",
             shard_fused_qkv: bool = False) -> nn.Module:
    """Turn ``model`` (a ``TransformerLM``, training or decode, the same on
    every rank) into this rank's shard along ``axis``, in place; returns it.

    The parallel layers replace ``q/k/v`` (or ``qkv``), ``o``, ``Dense_0``,
    ``Dense_1`` and ``lm_head`` under the same names; each attention module
    computes ``n_heads / tp`` heads, and ``f`` is applied to its input (a
    forward pre-hook). A fused ``qkv`` stays replicated
    (:class:`HeadSlicedQKV`), or with ``shard_fused_qkv`` (decode, no
    gradients) keeps only this rank's rows."""
    tp, m = mesh.axis_size(axis), mesh.axis_index(axis)
    _check_divisibility(model, tp)
    for blk in model.blocks():
        shard_tp_block(blk, mesh, axis, shard_fused_qkv)
    v = model.lm_head.weight.shape[0] // tp
    model.lm_head = _replace(model.lm_head, VocabParallelHead,
                             model.lm_head.weight[m * v:(m + 1) * v], None, mesh, axis)
    model.tp_mesh, model.tp_axis = mesh, axis
    return model


# ------------------------------------------------------------------ the train step


def tp_lm_loss(model: nn.Module, tokens: torch.Tensor, targets: torch.Tensor
               ) -> torch.Tensor:
    """The LM loss of a :func:`shard_tp` model on this rank's rows: the
    masked mean (final position masked) of :func:`vocab_parallel_cross_entropy`
    over the vocab-sharded logits."""
    hidden = model.hidden(tokens)
    b, s, dm = hidden.shape
    logits = model.lm_head(hidden.reshape(b * s, dm))
    ce = vocab_parallel_cross_entropy(logits, targets.reshape(-1), model.tp_mesh, model.tp_axis)
    mask = torch.ones((b, s), dtype=ce.dtype, device=ce.device)
    mask[:, -1] = 0.0
    return torch.sum(ce * mask.reshape(-1)) / torch.sum(mask)


def _sharded_over_model(model: nn.Module) -> list:
    """Per parameter: whether it is sharded over ``model`` (its gradient's
    squares sum over the axis in the global norm)."""
    specs = tp_param_specs({n: p for n, p in model.named_parameters()})
    fused = [getattr(p, "tp_partial", False) for p in model.parameters()]
    return [specs[n] is not None and not f
            for (n, _), f in zip(model.named_parameters(), fused)]


def _sq_norm_fn(model: nn.Module) -> Callable:
    """The squared global norm of the local gradients: the ``model``-sharded
    leaves' squares summed over the axis, the replicated leaves' once."""
    mesh, axis = model.tp_mesh, model.tp_axis
    sharded = _sharded_over_model(model)

    def sq_norm(grads):
        part = sum((torch.sum(g * g) for g, s in zip(grads, sharded) if s),
                   torch.zeros((), device=mesh.device))
        total = mesh.all_reduce(part.reshape(1), axis)[0]
        return total + sum(torch.sum(g * g) for g, s in zip(grads, sharded) if not s)

    return sq_norm


def create_tp_train_state(model: nn.Module, tx, mesh: DeviceMesh, model_axis: str = "model"
                          ) -> TrainState:
    """``model`` (built from its seed, the same on every rank) sharded per
    :func:`tp_param_specs` (:func:`shard_tp`), with ``tx``'s state over the
    local parameters: the momentum mirrors the shards."""
    shard_tp(model, mesh, model_axis)
    return TrainState(model, tx.init(list(model.parameters())))


def tp_layout(state: TrainState, model_axis: str = "model"):
    """The checkpoint layout of a :func:`create_tp_train_state` state
    (``utils/checkpoint``): each leaf of :func:`tp_param_specs` is this
    rank's chunk of its sharded dim, the rest replicated."""
    params = dict(state.model.named_parameters())
    specs = tp_param_specs(params)
    return [(name, p, () if specs[name] is None else (("split", model_axis, specs[name]),))
            for name, p in params.items()]


def make_tp_train_step(model: nn.Module, tx, mesh: DeviceMesh, model_axis: str = "model",
                       data_axis: str = "data") -> Callable:
    """The dp×tp LM step: ``step(state, tokens, targets) -> (state, loss)``
    on this data rank's rows (:func:`shard_tp_batch`) of a model
    :func:`create_tp_train_state` sharded. The gradients of a replicated
    fused ``qkv`` are summed over ``model``, then every gradient is averaged
    over ``data``; ``loss`` is the global batch's (a device tensor)."""
    _check_divisibility(model, mesh.axis_size(model_axis))
    if getattr(model, "tp_mesh", None) is not mesh:
        raise ValueError("make_tp_train_step needs the model create_tp_train_state "
                         "sharded over this mesh")
    params = list(model.parameters())
    partial = [j for j, p in enumerate(params) if getattr(p, "tp_partial", False)]
    ttx = with_sq_norm(tx, _sq_norm_fn(model))
    n_data = mesh.axis_size(data_axis)

    def step(state: TrainState, tokens, targets):
        model.train()
        loss = tp_lm_loss(model, tokens.to(mesh.device), targets.to(mesh.device))
        grads = list(torch.autograd.grad(loss, params, allow_unused=True,
                                         materialize_grads=True))
        with torch.no_grad():
            if partial:
                for j, g in zip(partial, flat_all_reduce(mesh, [grads[j] for j in partial],
                                                         model_axis)):
                    grads[j] = g
            grads = [g / n_data for g in flat_all_reduce(mesh, grads, data_axis)]
            loss = mesh.all_reduce(loss.detach().float().reshape(1), data_axis)[0] / n_data
        _apply(ttx, state.opt_state, params, grads)
        state.step += 1
        return state, loss

    return step


def shard_tp_batch(mesh: DeviceMesh, tokens, targets, data_axis: str = "data"):
    """This data rank's rows of a global ``(batch, seq)`` pair, as int64
    tensors on the rank's device (every model rank of it holds the same)."""
    out = []
    for a in (tokens, targets):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        out.append(t[rows_of(t.shape[0], mesh, data_axis)].long().to(mesh.device))
    return tuple(out)
