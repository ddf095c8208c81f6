"""The single-process trainer and evaluator (counterpart of the JAX
``training/trainer.py``, per-step path), with the LM's :class:`TrainState`
and sequence-chunked loss (:func:`chunked_lm_loss`).

One step is zero-grad → forward → cross-entropy → backward → SGD update,
eagerly on the model's device. :class:`SGD` has optax ``sgd`` semantics
(``trace = g + momentum·trace`` when momentum is set, ``updates = −lr·trace``,
``params += updates``), so the DownPour worker can accumulate exactly the
updates it applies.

Float32 precision: :func:`train_single` (and the PS worker entry) call
``device.full_float32()``, which sets ``torch.backends.cudnn.allow_tf32 =
False`` and ``torch.backends.cuda.matmul.allow_tf32 = False`` — cuDNN would
otherwise run float32 convolutions in TF32, unlike the JAX reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributed_ml_pytorch_tpu_torch.data import get_dataset, iterate_batches
from distributed_ml_pytorch_tpu_torch.device import full_float32, resolve_device
from distributed_ml_pytorch_tpu_torch.utils.metrics import MetricsLogger, print_eval_line


class SGD:
    """Plain SGD with optional momentum, as optax ``sgd(lr, momentum)``.

    ``init(params)`` returns the state (momentum traces, or none);
    ``update(grads, state)`` returns the updates (parameter deltas) and
    advances the traces in place."""

    def __init__(self, lr: float, momentum: float = 0.0):
        if lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        self.lr = float(lr)
        self.momentum = float(momentum or 0.0)

    def init(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.zeros_like(p) for p in params] if self.momentum else []

    def update(self, grads: Sequence[torch.Tensor],
               state: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.momentum:
            for t, g in zip(state, grads):
                t.mul_(self.momentum).add_(g)
            grads = state
        return [g * (-self.lr) for g in grads]


@dataclass
class TrainState:
    """A model (its parameters, updated in place by the step), the
    optimizer's state and the step count."""

    model: nn.Module
    opt_state: List[torch.Tensor]
    step: int = 0


def tx_from_args(args) -> SGD:
    """The local optimizer from the CLI surface (``--lr``, ``--momentum``)."""
    return SGD(args.lr, getattr(args, "momentum", 0.0))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy (reference ``F.cross_entropy``)."""
    return F.cross_entropy(logits, labels.long())


def chunked_lm_loss(model: nn.Module, tokens: torch.Tensor, targets: torch.Tensor,
                    chunk: int = 2048, ce_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Masked-mean next-token CE without materializing the (batch, seq,
    vocab) logits: the model body once (``model.hidden``), then per
    ``chunk``-token slice the ``lm_head`` product and CE in the activation
    dtype under ``torch.utils.checkpoint`` (the backward recomputes each
    chunk's logits). The final position is masked, as in
    ``parallel/fsdp.lm_loss_builder``; ``seq`` must divide by ``chunk``.
    ``ce_dtype`` casts each chunk's logits before the CE (``None`` keeps the
    activation dtype)."""
    b, s = tokens.shape
    if s % chunk:
        raise ValueError(f"seq {s} must divide by chunk {chunk}")
    h = model.hidden(tokens)
    w = model.lm_head.weight  # (vocab, d): flax's kernel transposed
    mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    mask[:, -1] = 0.0

    def chunk_ce(w_, h_c, t_c, m_c):
        b_, c_, d_ = h_c.shape
        logits = F.linear(h_c.reshape(b_ * c_, d_), w_.to(h_c.dtype))
        if ce_dtype is not None:
            logits = logits.to(ce_dtype)
        ce = F.cross_entropy(logits, t_c.reshape(-1).long(), reduction="none")
        return torch.sum(ce * m_c.reshape(-1))

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(chunk_ce, w, h[:, sl], targets[:, sl], mask[:, sl],
                                   use_reentrant=False)
    return total / mask.sum()


def to_device(bx: np.ndarray, by: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A numpy NHWC batch as tensors on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(bx, np.float32))
    y = torch.from_numpy(np.asarray(by, np.int64))
    if torch.device(device).type == "cuda":
        x, y = x.pin_memory(), y.pin_memory()
    return x.to(device, non_blocking=True), y.to(device, non_blocking=True)


def loss_and_grads(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
                   generator=None) -> torch.Tensor:
    """Forward + backward in training mode; gradients land in ``p.grad``.
    Returns the (unsynchronized) loss."""
    model.train()
    for p in model.parameters():
        p.grad = None
    loss = cross_entropy_loss(model(images, generator=generator), labels)
    loss.backward()
    return loss.detach()


def make_train_step(model: nn.Module, tx: SGD) -> Callable:
    """One SGD step on ``model`` in place: ``step(images, labels,
    generator=None) -> loss`` (a device tensor; reading it synchronizes)."""
    params = list(model.parameters())
    state = tx.init(params)

    def train_step(images, labels, generator=None):
        loss = loss_and_grads(model, images, labels, generator)
        updates = tx.update([p.grad for p in params], state)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        return loss

    return train_step


def make_eval_fn(model: nn.Module) -> Callable:
    """Per-batch eval: ``(mean loss, predictions)`` in eval mode."""

    @torch.no_grad()
    def eval_step(images, labels):
        model.eval()
        logits = model(images)
        return cross_entropy_loss(logits, labels), logits.argmax(dim=-1)

    return eval_step


def evaluate(eval_step: Callable, x_test: np.ndarray, y_test: np.ndarray,
             test_batch_size: int, device, verbose: bool = False) -> Tuple[float, float]:
    """Full test-set pass: ``(test_loss, test_accuracy)`` where the loss sums
    per-batch mean losses (the reference's summed semantics) and accuracy
    covers the whole test set."""
    total_loss = 0.0
    preds_all = []
    for bx, by in iterate_batches(x_test, y_test, min(test_batch_size, len(x_test)),
                                  shuffle=False, drop_last=False):
        loss, preds = eval_step(*to_device(bx, by, device))
        total_loss += float(loss)
        preds_all.append(preds.cpu().numpy())
    accuracy = float((np.concatenate(preds_all) == y_test).mean())
    if verbose:
        print("Loss: {:.3f}".format(total_loss))
        print("Accuracy: {:.3f}".format(accuracy))
    return total_loss, accuracy


def train_single(args, device="cuda") -> Tuple[nn.Module, MetricsLogger]:
    """Single-process baseline training (reference ``make single``): per-step
    SGD on ``device`` with an eval every ``log_interval`` steps and at each
    epoch end. Sets full float32 (no TF32) for the run."""
    from distributed_ml_pytorch_tpu_torch.models import get_model

    dev = resolve_device(device)
    full_float32()
    x_train, y_train, x_test, y_test = get_dataset(args)
    seed = getattr(args, "seed", 0)
    # AlexNet's relu→pool tails run the relu_pool2 kernel: same numerics
    model = get_model(args.model, fused_epilogue=True, seed=seed, device=dev)
    train_step = make_train_step(model, tx_from_args(args))
    eval_step = make_eval_fn(model)
    logger = MetricsLogger(getattr(args, "log_dir", "log"))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.time()
    for epoch in range(args.epochs):
        print("Training for epoch {}".format(epoch))
        for i, (bx, by) in enumerate(iterate_batches(
                x_train, y_train, args.batch_size, seed=seed, epoch=epoch)):
            loss = float(train_step(*to_device(bx, by, dev), generator=gen))
            extra = {}
            if i % args.log_interval == 0 and i > 0:
                test_loss, test_acc = evaluate(eval_step, x_test, y_test,
                                               args.test_batch_size, dev)
                extra = {"test_loss": test_loss, "test_accuracy": test_acc}
            rec = logger.log_step(i, loss, **extra)
            if extra:
                print_eval_line(rec)
        evaluate(eval_step, x_test, y_test, args.test_batch_size, dev, verbose=True)
    print("Finished Training ({:.1f}s)".format(time.time() - t0))
    return model, logger
