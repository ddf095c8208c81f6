"""Ulysses sequence parallelism: all-to-all head↔sequence re-sharding
(counterpart of the JAX ``parallel/ulysses.py``).

Attention inputs arrive sequence-sharded; a tiled all-to-all over the
``seq`` axis (``DeviceMesh.all_to_all``) re-shards them head-sharded with
the whole sequence local; each rank runs ordinary causal attention over
its ``n_heads/p`` heads (``default_attn_fn`` → ``auto_attention``: K4/K5
on the card); a second all-to-all restores sequence sharding for the
position-local rest of the block. Four all-to-alls a layer forward (q, k,
v in, the output back) and their transposes backward, against the ring's
``p`` K/V rotations; the degree is capped by ``n_heads``.

Everything outside attention (loss, positions, sharding, update) is the
sp step's (``parallel/seq_parallel.py``): the binder is the only moving
part.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.models.transformer import default_attn_fn
from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
    make_sp_eval_fn,
    make_sp_train_step,
)
from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its transpose swaps the split and concat dims."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return mesh.all_to_all(g.contiguous(), axis, concat_dim, split_dim), None, None, None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: DeviceMesh, axis: str = "seq") -> torch.Tensor:
    """Exact causal attention over a sequence sharded on ``mesh``'s
    ``axis``: ``q``/``k``/``v`` are this rank's ``(b, h, S/p, hd)`` chunks
    with every head; returns the local output chunk.

    1. split the heads ``p`` ways, concatenate the sequence → ``(b, h/p, S,
       hd)``: chunks concatenate in rank order, which is global sequence
       order (``shard_lm_batch`` shards contiguously), so the causal mask
       over the gathered axis is exact;
    2. causal attention over the whole sequence on the local heads;
    3. the inverse all-to-all → ``(b, h, S/p, hd)``."""
    p = mesh.axis_size(axis)
    if p == 1:
        return default_attn_fn(q, k, v)
    if q.shape[1] % p:
        raise ValueError(
            f"n_heads={q.shape[1]} is not divisible by the sequence axis size "
            f"{p} — Ulysses shards attention over heads")
    qh, kh, vh = (_AllToAll.apply(t, mesh, axis, 1, 2) for t in (q, k, v))
    out = default_attn_fn(qh.contiguous(), kh.contiguous(), vh.contiguous())
    return _AllToAll.apply(out, mesh, axis, 2, 1)


def _bind_ulysses(model: nn.Module, mesh: DeviceMesh, seq_axis: str) -> Callable:
    p = mesh.axis_size(seq_axis)
    if model.n_heads % p:
        raise ValueError(
            f"n_heads={model.n_heads} must be divisible by the '{seq_axis}' "
            f"axis size {p} for Ulysses sequence parallelism (use the ring "
            f"path, parallel/seq_parallel.py, when it is not)")
    return functools.partial(ulysses_attention, mesh=mesh, axis=seq_axis)


def make_ulysses_train_step(model: nn.Module, tx, mesh: DeviceMesh, data_axis: str = "data",
                            seq_axis: str = "seq") -> Callable:
    """The dp×sp LM step with Ulysses attention: ``step(state, tokens,
    targets) -> (state, loss)``, :func:`~distributed_ml_pytorch_tpu_torch.
    parallel.seq_parallel.make_sp_train_step` with the all-to-all binder."""
    return make_sp_train_step(model, tx, mesh, data_axis, seq_axis,
                              attn_binder=_bind_ulysses)


def make_ulysses_eval_fn(model: nn.Module, mesh: DeviceMesh, data_axis: str = "data",
                         seq_axis: str = "seq") -> Callable:
    """The sp eval under Ulysses attention (the same loss definition)."""
    return make_sp_eval_fn(model, mesh, data_axis, seq_axis, attn_binder=_bind_ulysses)
