"""The LM loss and the single-device LM train step (counterpart of the JAX
``parallel/fsdp.py``'s ``lm_loss_builder`` and ``make_fsdp_lm_train_step``).

The JAX ``--mode single`` trains through the FSDP step on a one-device mesh,
so that single-device and sharded updates cannot differ; on one device that
step is value-and-grad, then the optimizer update. The port keeps that step
for one device, and its K-step counterpart (the JAX ``train_lm``'s
``lax.scan`` over the step): :func:`make_fsdp_lm_scan_train_step`, on the
card one step captured as a CUDA graph and replayed K times. Sharded FSDP
(parameters split over ranks) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.training.trainer import (
    SGD,
    TrainState,
    _make_k_step,
    chunked_lm_loss,
)


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


def make_fsdp_lm_train_step(model: nn.Module, tx: SGD, loss_chunk: int = 0) -> Callable:
    """``step(state, tokens, targets) -> (state, loss)`` on one device:
    forward and backward of :func:`lm_loss_builder`'s loss, then ``tx``'s
    update applied to the parameters in place. ``loss`` is a device tensor
    (reading it synchronizes)."""
    params = list(model.parameters())
    loss_fn = lm_loss_builder(model, loss_chunk)

    def step(state: TrainState, tokens: torch.Tensor, targets: torch.Tensor):
        loss = _lm_step_body(model, tx, params, loss_fn, state.opt_state)(tokens, targets)
        state.step += 1
        return state, loss

    return step


def make_fsdp_lm_scan_train_step(model: nn.Module, tx: SGD, steps_per_dispatch: int = 0,
                                 loss_chunk: int = 0) -> Callable:
    """K steps a dispatch (the JAX ``train_lm``'s ``lax.scan`` over
    :func:`make_fsdp_lm_train_step`): ``scan(state, tokens [K, B, S],
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
