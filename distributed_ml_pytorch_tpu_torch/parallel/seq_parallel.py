"""Sequence-parallel LM training: dp×sp over a ``{"data", "seq"}`` mesh with
ring attention (counterpart of the JAX ``parallel/seq_parallel.py``).

Each rank holds ``S/p`` tokens of every sequence in its rows of the batch
(``data`` splits the rows, ``seq`` the positions, both contiguous):

- activations stay sharded along the sequence; the only traffic across
  chunks is the attention's (ring attention's K/V rotation,
  ``parallel/ring.py``, or Ulysses' all-to-alls, ``parallel/ulysses.py``):
  everything else in the Transformer is position-local;
- each rank feeds its tokens' *global* positions to the model, starting at
  ``idx·S/p`` (``TransformerLM.hidden(tokens, positions)``), so the
  position embeddings do not see the sharding;
- the loss is the exact global masked mean (JAX ``_global_masked_ce``):
  only the final *global* position is masked, and the CE numerator and the
  token count are each summed over both mesh axes before the division. A
  per-rank mean would be a different loss;
- parameters are replicated; each rank differentiates its share of the
  global loss (its numerator over the global count), and the gradients are
  all-reduced over ``data`` and ``seq``, so every rank applies the same
  update (the JAX step gets this from ``psum``'s transpose).

Also here: :func:`next_token_targets` and :func:`create_lm_train_state`,
shared by every LM path.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh, flat_all_reduce
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD, TrainState, _apply


def next_token_targets(tokens: np.ndarray, pad_id: int = 0) -> np.ndarray:
    """Position i predicts token i+1; the final position gets ``pad_id`` and
    is masked by position in the loss. Computed before sharding, so the
    last token of chunk j predicts the first of chunk j+1."""
    return np.concatenate(
        [tokens[:, 1:], np.full((tokens.shape[0], 1), pad_id, tokens.dtype)], axis=1
    )


def create_lm_train_state(model: nn.Module, tx: SGD) -> TrainState:
    """``model`` with ``tx``'s fresh state. The JAX function initialises the
    parameters from its rng here; a port model holds its parameters from
    construction, drawn from the ``seed`` it was built with."""
    return TrainState(model, tx.init(list(model.parameters())))


def _bind_ring(model: nn.Module, mesh: DeviceMesh, seq_axis: str) -> Callable:
    """The model's attention over the ``seq`` axis: causal ring attention."""
    from distributed_ml_pytorch_tpu_torch.parallel.ring import ring_attention

    return functools.partial(ring_attention, mesh=mesh, axis=seq_axis, causal=True)


def _global_masked_ce(model: nn.Module, tokens: torch.Tensor, targets: torch.Tensor,
                      mesh: DeviceMesh, seq_axis: str):
    """This rank's ``(numerator, count)`` of the global next-token loss over
    its ``(b, S/p)`` chunk: the CE summed over the positions that are not the
    final *global* one, and their count."""
    s_local = tokens.shape[1]
    s_global = s_local * mesh.axis_size(seq_axis)
    max_len = getattr(model, "max_len", None)
    if max_len is not None and s_global > max_len:
        raise ValueError(
            f"global sequence length {s_global} exceeds the model's max_len "
            f"{max_len} — position embeddings would silently go out of range")
    start = mesh.axis_index(seq_axis) * s_local
    positions = (start + torch.arange(s_local, device=tokens.device))[None, :]
    hidden = model.hidden(tokens, positions)
    b, s, dm = hidden.shape
    logits = F.linear(hidden.reshape(b * s, dm), model.lm_head.weight.to(hidden.dtype))
    ce = F.cross_entropy(logits, targets.reshape(-1).long(), reduction="none")
    mask = (positions < s_global - 1).to(ce.dtype).expand(b, s).reshape(-1)
    return torch.sum(ce * mask), torch.sum(mask)


def _sum_over(mesh: DeviceMesh, axes, t: torch.Tensor) -> torch.Tensor:
    t = t.detach().float().reshape(1).clone()
    for a in axes:
        mesh.all_reduce(t, a)
    return t[0]


class _Bound:
    """The model's attention set to ``attn_fn`` for one call, then restored."""

    def __init__(self, model: nn.Module, attn_fn: Callable):
        self.model, self.attn_fn = model, attn_fn

    def __enter__(self):
        self.saved = [blk.attn.attn_fn for blk in self.model.blocks()]
        self.model.set_attn_fn(self.attn_fn)

    def __exit__(self, *exc):
        for blk, fn in zip(self.model.blocks(), self.saved):
            blk.attn.attn_fn = fn


def make_sp_train_step(model: nn.Module, tx: SGD, mesh: DeviceMesh, data_axis: str = "data",
                       seq_axis: str = "seq", attn_binder: Optional[Callable] = None
                       ) -> Callable:
    """The dp×sp LM step: ``step(state, tokens, targets) -> (state, loss)``
    on this rank's ``(b/d, S/p)`` chunk (:func:`shard_lm_batch`).

    ``attn_binder(model, mesh, seq_axis) -> attn_fn`` makes the attention
    over the ``seq`` axis: ring attention by default; ``parallel/ulysses.py``
    passes its all-to-all binder (sharding, loss and update are the same).
    ``loss`` is the global loss (a device tensor)."""
    attn_fn = (attn_binder or _bind_ring)(model, mesh, seq_axis)
    axes = (data_axis, seq_axis)
    params = list(model.parameters())

    def step(state: TrainState, tokens, targets):
        model.train()
        with _Bound(model, attn_fn):
            num, den = _global_masked_ce(model, tokens.to(mesh.device),
                                         targets.to(mesh.device), mesh, seq_axis)
            den_g = _sum_over(mesh, axes, den)
            grads = list(torch.autograd.grad(num / den_g, params, allow_unused=True,
                                             materialize_grads=True))
        with torch.no_grad():
            for a in axes:
                grads = flat_all_reduce(mesh, grads, a)
            loss = _sum_over(mesh, axes, num) / den_g
        _apply(tx, state.opt_state, params, grads)
        state.step += 1
        return state, loss

    return step


def shard_lm_batch(mesh: DeviceMesh, tokens, targets, data_axis: str = "data",
                   seq_axis: str = "seq"):
    """This rank's ``(rows over data, positions over seq)`` block of a
    global ``(batch, seq)`` pair, as int64 tensors on its device."""
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import rows_of

    out = []
    for a in (tokens, targets):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        t = t[rows_of(t.shape[0], mesh, data_axis)]
        t = t[:, rows_of(t.shape[1], mesh, seq_axis)]
        out.append(t.long().contiguous().to(mesh.device))
    return tuple(out)


def make_sp_eval_fn(model: nn.Module, mesh: DeviceMesh, data_axis: str = "data",
                    seq_axis: str = "seq", attn_binder: Optional[Callable] = None
                    ) -> Callable:
    """``fn(model, tokens, targets) -> loss``: the global masked-mean CE of
    the train step (same sharding, same loss), without gradients."""
    attn_fn = (attn_binder or _bind_ring)(model, mesh, seq_axis)
    axes = (data_axis, seq_axis)

    def fn(m: nn.Module, tokens, targets):
        with torch.no_grad(), _Bound(m, attn_fn):
            num, den = _global_masked_ce(m, tokens.to(mesh.device), targets.to(mesh.device),
                                         mesh, seq_axis)
            return _sum_over(mesh, axes, num) / _sum_over(mesh, axes, den)

    return fn


def sp_eval_loss(model: nn.Module, mesh: DeviceMesh, state: TrainState, tokens, targets,
                 data_axis: str = "data", seq_axis: str = "seq") -> Tuple[float, int]:
    """One-shot :func:`make_sp_eval_fn` on ``state``'s model: ``(loss, the
    tokens of this rank's chunk)``."""
    fn = make_sp_eval_fn(model, mesh, data_axis, seq_axis)
    loss = fn(state.model, tokens, targets)
    return float(loss), int(np.prod(tuple(tokens.shape)))
