"""The single-process trainer and evaluator (counterpart of the JAX
``training/trainer.py``), with the LM's :class:`TrainState` and
sequence-chunked loss (:func:`chunked_lm_loss`).

A step is forward → cross-entropy → gradients → the optimizer's update
(``training/optim.py``: sgd, adam or adamw, schedules, clipping, decay,
``MultiSteps`` accumulation) → ``params += updates``, on the model's device.
The step builders mirror the JAX ones, each over a :class:`TrainState` that
they advance in place and return with the loss:

- :func:`make_train_step`: one step a call;
- :func:`make_accum_train_step`: one update from a large batch, its
  microbatches' gradients summed and scaled (the mean over the batch, or
  the sum of ``batch/e`` batch-``e`` mean gradients);
- :func:`make_scan_train_step` and :func:`make_scan_accum_train_step`: K
  steps (or K accumulated updates) a dispatch, the ``lax.scan`` trainers.
  On the card one step is captured as a CUDA graph (:class:`GraphedSteps`)
  and replayed K times, its batches gathered on the card from static
  buffers that each dispatch fills with one copy from pinned memory, and
  the K losses read with one synchronisation; on the CPU they are a plain
  loop of the same step. The graph's job is host dispatch: the kernels in
  it are the port's own and PyTorch's, as in an eager step.

:func:`run_training_loop` and :func:`train_single` are the JAX loop: chunks
never cross an eval or a checkpoint boundary, the per-step losses land in
the CSV row for row, a resumed run restarts at the exact batch
(``utils/checkpoint.py``), and a final forced save runs in ``finally``.

Float32 precision: :func:`train_single` (and the PS worker entry) call
``device.full_float32()``, which sets ``torch.backends.cudnn.allow_tf32 =
False`` and ``torch.backends.cuda.matmul.allow_tf32 = False`` — cuDNN would
otherwise run float32 convolutions in TF32, unlike the JAX reference.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributed_ml_pytorch_tpu_torch.data import (
    CIFAR10_CLASSES,
    get_dataset,
    iterate_batches,
    prefetch_to_device,
)
from distributed_ml_pytorch_tpu_torch.device import full_float32, resolve_device
from distributed_ml_pytorch_tpu_torch.training.optim import (  # noqa: F401 — re-exported
    SGD,
    OptState,
    build_tx,
    make_lr_schedule,
    make_optimizer,
    tx_from_args,
)
from distributed_ml_pytorch_tpu_torch.utils.metrics import (
    MetricsLogger,
    print_classification_report,
    print_eval_line,
)
from distributed_ml_pytorch_tpu_torch.utils.tracing import StepTimer, TraceWindow, annotate_step

#: eager steps run on a side stream before a graph is captured (PyTorch's
#: whole-network capture recipe); they are real training steps
GRAPH_WARMUP_STEPS = 2
#: one CUDA-graph capture at a time in the process (see GraphedSteps._capture)
_CAPTURE_LOCK = threading.Lock()


@dataclass
class TrainState:
    """A model (its parameters, updated in place by the step), the
    optimizer's state, the step count (raw batches, on the host) and the
    dropout generator the steps draw from (``None``: the device default)."""

    model: nn.Module
    opt_state: OptState
    step: int = 0
    generator: Optional[torch.Generator] = None


def create_train_state(model: nn.Module, tx, generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """``model`` paired with ``tx``'s fresh state (the JAX function also
    initialises the parameters; a port model holds them from construction)."""
    return TrainState(model, tx.init(list(model.parameters())), 0, generator)


def state_from_args(args, model: nn.Module, steps_per_epoch: int,
                    generator: Optional[torch.Generator] = None):
    """``(state, tx)`` from the CLI surface (see :func:`tx_from_args`)."""
    tx = tx_from_args(args, steps_per_epoch)
    return create_train_state(model, tx, generator), tx


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
        # no random numbers in a chunk: the generators' state is not saved
        # (reading it is refused while a CUDA graph captures the step)
        total = total + checkpoint(chunk_ce, w, h[:, sl], targets[:, sl], mask[:, sl],
                                   use_reentrant=False, preserve_rng_state=False)
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


def _grads(model: nn.Module, params: List[torch.Tensor], images, labels, generator,
           remat: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(loss, grads)`` of one batch in training mode; the gradients are
    returned, not accumulated into ``.grad``."""
    model.train()

    def loss_of(bx, by):
        return cross_entropy_loss(model(bx, generator=generator), by)

    if remat:
        if generator is not None:
            raise ValueError("remat recomputes the forward, and a dropout generator would "
                             "draw other masks there: remat takes no generator")
        loss = checkpoint(loss_of, images, labels, use_reentrant=False)
    else:
        loss = loss_of(images, labels)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads)


def _apply(tx, opt_state: OptState, params: List[torch.Tensor],
           grads: Sequence[torch.Tensor]) -> None:
    """``tx``'s update for ``grads``, added to the parameters in place."""
    updates = tx.update(grads, opt_state, params)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)


def _sgd_step_body(model, tx, params, opt_state, images, labels, generator) -> torch.Tensor:
    """One step shared by the per-step and the K-step trainers."""
    loss, grads = _grads(model, params, images, labels, generator)
    _apply(tx, opt_state, params, grads)
    return loss


def _accum_update_body(model, tx, microbatch: int, params, opt_state, images, labels,
                       generator, effective_update_batch: Optional[int],
                       remat: bool) -> torch.Tensor:
    """One update from a large batch ``(B, ...)``, ``B = k·microbatch``: the
    microbatches' mean gradients summed into a zero accumulator, then scaled
    by ``1/k`` (``effective_update_batch=None``: the mean over ``B``) or by
    ``microbatch/e`` (the sum of the ``B/e`` batch-``e`` mean gradients at
    the current parameters); ``remat`` recomputes each microbatch's
    activations in its backward (``torch.utils.checkpoint``). Returns the
    mean of the microbatch losses."""
    b = images.shape[0]
    if b % microbatch:
        raise ValueError(f"batch {b} must divide by microbatch {microbatch}")
    k = b // microbatch
    if effective_update_batch is not None:
        if effective_update_batch <= 0:
            raise ValueError(f"effective_update_batch must be positive, got "
                             f"{effective_update_batch} (use None for the large-batch "
                             f"mean update)")
        scale = microbatch / float(effective_update_batch)
    else:
        scale = 1.0 / k
    acc = [torch.zeros_like(p) for p in params]
    loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for j in range(k):
        sl = slice(j * microbatch, (j + 1) * microbatch)
        loss, grads = _grads(model, params, images[sl], labels[sl], generator, remat)
        acc = [a + g for a, g in zip(acc, grads)]
        loss_sum = loss_sum + loss
    _apply(tx, opt_state, params, [a * scale for a in acc])
    return loss_sum / k


def _as_tensors(images, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images as float32 and labels as int64 tensors where they lie (numpy
    arrays, and sequences of per-step batches, become host tensors)."""
    if isinstance(images, (list, tuple)):
        images, labels = np.stack(images), np.stack(labels)
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels, np.int64))
    return images, labels.long()


def _make_step(model: nn.Module, body_of: Callable) -> Callable:
    """``step(state, images, labels, generator=None) -> (state, loss)`` over
    ``body_of(state) -> body(x, y, generator) -> loss``, the state advanced
    in place; ``generator`` defaults to the state's."""
    dev = next(model.parameters()).device

    def step(state: TrainState, images, labels, generator=None):
        x, y = _as_tensors(images, labels)
        gen = state.generator if generator is None else generator
        loss = body_of(state)(x.to(dev), y.to(dev), gen)
        state.step += 1
        return state, loss

    return step


def make_train_step(model: nn.Module, tx) -> Callable:
    """One step: ``step(state, images, labels, generator=None) -> (state,
    loss)``. ``loss`` is a device tensor (reading it synchronizes)."""
    params = list(model.parameters())
    return _make_step(model, lambda state: (
        lambda x, y, g: _sgd_step_body(model, tx, params, state.opt_state, x, y, g)))


def make_accum_train_step(model: nn.Module, tx, microbatch: int,
                          effective_update_batch: Optional[int] = None,
                          remat: bool = False) -> Callable:
    """One optimizer update from a large batch through a microbatch loop:
    ``step(state, images [B, ...], labels [B], generator=None) -> (state,
    loss)`` with ``B`` a multiple of ``microbatch`` (see
    :func:`_accum_update_body` for the update's scale)."""
    params = list(model.parameters())
    return _make_step(model, lambda state: (
        lambda x, y, g: _accum_update_body(model, tx, microbatch, params, state.opt_state, x,
                                           y, g, effective_update_batch, remat)))


class GraphedSteps:
    """K steps a dispatch on the card: one step captured as a CUDA graph and
    replayed.

    ``run(body, images [K, B, ...], labels [K, B], generator)`` copies the K
    batches into static device buffers (from a pinned staging buffer when
    they come from the host), then runs ``body(x, y, generator) -> loss``
    once per batch, each step gathering its batch from the buffers at a
    device index that the step itself advances and writing its loss into a
    static loss vector, so nothing of the host (a batch's address, the
    step's number) is baked into the graph. The first
    :data:`GRAPH_WARMUP_STEPS` steps run eagerly on a side stream (real
    steps: cuDNN and the allocator settle before capture), the next is
    captured into a private memory pool, and every later step is a replay.
    The optimizer state and the parameters are allocated before capture;
    ``generator`` is registered with the graph, so replays draw fresh
    dropout masks as eager steps do. The graph is rebuilt, never replayed,
    when a batch's shape or dtype, the generator or ``key`` changes, or a
    dispatch holds more steps than the buffers. The generator and ``owner``
    (the optimizer state the step writes) are held and compared by identity,
    so a freed state's address reused by a new one cannot pass for it.
    Returns the K losses (a device tensor).

    ``capacity`` sizes the buffers for that many steps a dispatch from the
    start, so a short first dispatch (a resumed run's rest of an epoch) does
    not force a rebuild when the full ones follow.

    The port's wrappers count a kernel where they launch it: the eager
    warm-up steps and the capture count, the replays do not
    (``utils/devprof`` counts what ran)."""

    def __init__(self, capacity: int = 0):
        self.capacity = int(capacity)
        self._key = None
        self._held = ()
        self.graph = None
        self.captures = 0

    def _reset(self, key, held, capacity: int, x: torch.Tensor, y: torch.Tensor,
               device) -> None:
        self._key, self._held = key, held
        self.graph = None
        self._warm = 0
        self._pool = torch.cuda.graph_pool_handle()
        shape_x, shape_y = (capacity, *x.shape[1:]), (capacity, *y.shape[1:])
        self._x = torch.empty(shape_x, dtype=x.dtype, device=device)
        self._y = torch.empty(shape_y, dtype=y.dtype, device=device)
        self._stage_x = torch.empty(shape_x, dtype=x.dtype, pin_memory=True)
        self._stage_y = torch.empty(shape_y, dtype=y.dtype, pin_memory=True)
        self._staged = None
        self._idx = torch.zeros(1, dtype=torch.long, device=device)
        self._losses = torch.zeros(capacity, dtype=torch.float32, device=device)

    def _fill(self, buf: torch.Tensor, stage: torch.Tensor, src: torch.Tensor) -> None:
        n = src.shape[0]
        if src.is_cuda:
            buf[:n].copy_(src)
            return
        if self._staged is not None:  # the last dispatch's copy has left the stage
            self._staged.synchronize()
        stage[:n].copy_(src)
        buf[:n].copy_(stage[:n], non_blocking=True)

    def _one(self, body, generator) -> None:
        x = self._x.index_select(0, self._idx).squeeze(0)
        y = self._y.index_select(0, self._idx).squeeze(0)
        loss = body(x, y, generator)
        self._losses.index_copy_(0, self._idx, loss.detach().reshape(1).float())
        self._idx.add_(1)

    def _eager(self, body, generator, device) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._one(body, generator)
        torch.cuda.current_stream(device).wait_stream(side)

    def _capture(self, body, generator) -> None:
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        # Other threads of the process may use the card meanwhile (two
        # DownPour workers as threads, a push flusher's copy): in the
        # default "global" mode an unsafe call by any of them during the
        # capture (an allocation, a synchronisation) fails and invalidates
        # it. "thread_local" forbids unsafe calls to the capturing thread
        # alone, and the lock keeps two captures from overlapping.
        with _CAPTURE_LOCK, torch.cuda.graph(graph, pool=self._pool,
                                             capture_error_mode="thread_local"):
            self._one(body, generator)
        self.graph = graph
        self.captures += 1

    def run(self, body, images: torch.Tensor, labels: torch.Tensor, generator=None,
            owner=None, device="cuda") -> torch.Tensor:
        device = torch.device(device)
        n = images.shape[0]
        key = (tuple(images.shape[1:]), images.dtype, tuple(labels.shape[1:]), labels.dtype)
        held = (generator, owner)
        if (key != self._key or any(a is not b for a, b in zip(held, self._held))
                or n > self._x.shape[0]):
            self._reset(key, held, max(n, self.capacity), images, labels, device)
        self._fill(self._x, self._stage_x, images)
        self._fill(self._y, self._stage_y, labels)
        self._staged = torch.cuda.Event()
        self._staged.record()
        self._idx.zero_()
        done = 0
        while done < n and self.graph is None:
            if self._warm < GRAPH_WARMUP_STEPS:
                self._eager(body, generator, device)
                self._warm += 1
                done += 1
            else:
                self._capture(body, generator)
        for _ in range(done, n):
            self.graph.replay()
        return self._losses[:n].clone()


def dispatch_steps(device, capacity: int = 0) -> Callable:
    """``dispatch(body, images [K, ...], labels [K, ...], generator=None,
    owner=None) -> losses [K]``: K calls of ``body(x, y, generator) ->
    loss``, one per batch. On the card a graph of one step replayed
    (:class:`GraphedSteps`, buffers for ``capacity`` steps or the longest
    dispatch seen, ``owner`` the state the step writes; ``dispatch.graphed``),
    on the CPU a loop."""
    device = torch.device(device)
    graphed = GraphedSteps(capacity)

    def dispatch(body, images, labels, generator=None, owner=None) -> torch.Tensor:
        x, y = _as_tensors(images, labels)
        if device.type == "cuda":
            return graphed.run(body, x, y, generator, owner=owner, device=device)
        x, y = x.to(device), y.to(device)
        return torch.stack([body(x[i], y[i], generator).float() for i in range(x.shape[0])])

    dispatch.graphed = graphed
    return dispatch


def _make_k_step(model: nn.Module, body_of: Callable, steps_per_dispatch: int) -> Callable:
    """``scan(state, images [K, ...], labels [K, ...], generator=None) ->
    (state, losses [K])`` over ``body_of(state) -> body(x, y, generator) ->
    loss`` (:func:`dispatch_steps`)."""
    dispatch = dispatch_steps(next(model.parameters()).device, steps_per_dispatch)

    def scan_step(state: TrainState, images, labels, generator=None):
        gen = state.generator if generator is None else generator
        losses = dispatch(body_of(state), images, labels, gen, owner=state.opt_state)
        state.step += losses.shape[0]
        return state, losses

    scan_step.graphed = dispatch.graphed
    return scan_step


def make_scan_train_step(model: nn.Module, tx, steps_per_dispatch: int = 0) -> Callable:
    """K steps a dispatch: ``scan(state, images [K, B, ...], labels [K, B],
    generator=None) -> (state, losses [K])``, each step exactly
    :func:`make_train_step`'s (equal to K calls of it, tested), K distinct
    batches. On the card, a CUDA graph of one step replayed K times
    (:class:`GraphedSteps`, its buffers sized for ``steps_per_dispatch``)."""
    params = list(model.parameters())
    return _make_k_step(model, lambda state: (
        lambda x, y, g: _sgd_step_body(model, tx, params, state.opt_state, x, y, g)),
        steps_per_dispatch)


def make_scan_accum_train_step(model: nn.Module, tx, microbatch: int,
                               effective_update_batch: Optional[int] = None,
                               remat: bool = False, steps_per_dispatch: int = 0) -> Callable:
    """U accumulated large-batch updates a dispatch: ``scan(state, images
    [U, B, ...], labels [U, B], generator=None) -> (state, losses [U])``,
    each :func:`make_accum_train_step`'s update."""
    params = list(model.parameters())
    return _make_k_step(model, lambda state: (
        lambda x, y, g: _accum_update_body(model, tx, microbatch, params, state.opt_state, x,
                                           y, g, effective_update_batch, remat)),
        steps_per_dispatch)


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
    y_pred = np.concatenate(preds_all)
    accuracy = float((y_pred == y_test).mean())
    if verbose:
        print_classification_report(y_test, y_pred, CIFAR10_CLASSES, total_loss, accuracy)
    return total_loss, accuracy


def run_training_loop(*, state: TrainState, train_step: Callable, eval_step: Callable, data,
                      args, logger: MetricsLogger, device, ckpt=None, start_epoch: int = 0,
                      start_iter: int = 0, scan_step: Optional[Callable] = None) -> TrainState:
    """The epoch/batch loop (the JAX ``run_training_loop``).

    ``ckpt`` (a ``utils.checkpoint.Checkpointer``) is offered the state after
    every dispatch; its ``save_interval_steps`` decides which saves it
    accepts. ``start_epoch``/``start_iter`` fast-forward a resumed run to
    the exact batch (the order is a pure function of ``(seed, epoch)``).

    ``scan_step`` (:func:`make_scan_train_step`-shaped) with
    ``--steps-per-dispatch K > 1`` trains up to K consecutive batches a
    dispatch. A chunk never crosses a ``log_interval`` eval boundary (the
    eval sees the parameters after exactly that step) or a ``--ckpt-every``
    boundary (saves land on exact multiples), and the K per-step losses
    land in the CSV row for row. The per-step path keeps ``--prefetch``
    batches' copies in flight (``data.prefetch_to_device``); the chunked
    path copies each chunk from pinned memory itself.

    ``--profile-dir`` traces the global steps ``[--profile-start, +
    --profile-steps)`` (``utils/tracing.TraceWindow``; a resumed run counts
    on from its checkpoint's step), each dispatch inside an
    ``annotate_step("train", step)`` range.
    """
    x_train, y_train, x_test, y_test = data
    seed = getattr(args, "seed", 0)
    tracer = TraceWindow(getattr(args, "profile_dir", None),
                         start=getattr(args, "profile_start", 10),
                         n_steps=getattr(args, "profile_steps", 10))
    global_step = int(state.step)
    timer = StepTimer(items_per_step=args.batch_size)
    chunk_k = int(getattr(args, "steps_per_dispatch", 1) or 1)
    use_scan = scan_step is not None and chunk_k > 1

    def run_one(state, i, bx, by):
        nonlocal global_step
        tracer.on_step(global_step)
        timer.start()
        with annotate_step("train", global_step):
            state, loss = train_step(state, bx, by)
            loss_val = float(loss)  # waits for the step
        timer.tick()
        if ckpt is not None:
            ckpt.save(state.step, state)
        global_step += 1
        tracer.after_step(global_step)
        return state, [(i, loss_val)]

    def run_chunk(state, chunk):
        nonlocal global_step
        tracer.on_step(global_step, n_steps=len(chunk))
        timer.start()
        with annotate_step("train", global_step):
            state, losses = scan_step(state, [c[1] for c in chunk], [c[2] for c in chunk])
            losses = losses.cpu().tolist()  # one synchronisation for the chunk
        timer.tick_n(len(chunk))
        if ckpt is not None:
            ckpt.save(state.step, state)
        global_step += len(chunk)
        tracer.after_step(global_step)
        return state, [(c[0], loss) for c, loss in zip(chunk, losses)]

    def emit(records):
        for i, loss_val in records:
            extra = {}
            if i % args.log_interval == 0 and i > 0:
                test_loss, test_acc = evaluate(eval_step, x_test, y_test,
                                               args.test_batch_size, device)
                extra = {"test_loss": test_loss, "test_accuracy": test_acc}
            rec = logger.log_step(i, loss_val, **extra)
            if extra:
                print_eval_line(rec)

    try:
        for epoch in range(start_epoch, args.epochs):
            print("Training for epoch {}".format(epoch))
            skip = start_iter if epoch == start_epoch else 0
            batches = iterate_batches(x_train, y_train, args.batch_size, seed=seed,
                                      epoch=epoch, start_iter=skip)
            prefetch_n = int(getattr(args, "prefetch", 2) or 0)
            if not use_scan and prefetch_n > 0:
                batches = prefetch_to_device(batches, prefetch_n, device)
            pending = []
            for i, (bx, by) in enumerate(batches, start=skip):
                if not use_scan:
                    state, records = run_one(state, i, bx, by)
                    emit(records)
                    continue
                pending.append((i, bx, by))
                at_eval = i % args.log_interval == 0 and i > 0
                at_ckpt = (ckpt is not None
                           and (state.step + len(pending)) % ckpt.save_interval_steps == 0)
                if len(pending) >= chunk_k or at_eval or at_ckpt:
                    state, records = run_chunk(state, pending)
                    pending = []
                    emit(records)
            if pending:
                state, records = run_chunk(state, pending)
                emit(records)
            # a window across the epoch's end stops here, before the eval
            tracer.close()
            evaluate(eval_step, x_test, y_test, args.test_batch_size, device, verbose=True)
            line = timer.report("epoch {} train-step time".format(epoch))
            if line:
                print(line)
            timer.reset_stats()
    finally:
        tracer.close()
        tracer.warn_if_never_opened()
        # commit the last completed step even when interrupted mid-epoch
        if ckpt is not None:
            try:
                ckpt.save(state.step, state, force=True)
                ckpt.wait()
            except Exception as e:  # never mask the original exception
                print(f"warning: final checkpoint save failed: {e}", file=sys.stderr)
    return state


def setup_checkpoint(args, state: TrainState, steps_per_epoch: int, sharded=None):
    """The Checkpointer from the CLI flags, and a resumed run's position:
    ``(ckpt, state, start_epoch, start_iter)``; ``ckpt`` is ``None`` without
    ``--ckpt-dir``. With ``sharded = (mode, layout_fn, mesh)`` it is a
    ``ShardedCheckpointer``, and a resume loads the parameters into the full
    ``state.model`` and sets ``state.step`` (``ckpt.restore_placed`` loads
    the optimizer state once the state is sharded)."""
    if not getattr(args, "ckpt_dir", None):
        return None, state, 0, 0
    from distributed_ml_pytorch_tpu_torch.utils.checkpoint import (
        Checkpointer,
        ShardedCheckpointer,
        maybe_restore,
        resume_position,
    )

    keep, every = getattr(args, "ckpt_keep", 3), getattr(args, "ckpt_every", 500)
    if sharded is not None:
        mode, layout_fn, mesh = sharded
        ckpt = ShardedCheckpointer(args.ckpt_dir, mode=mode, mesh=mesh, layout_fn=layout_fn,
                                   max_to_keep=keep, save_interval_steps=every)
    else:
        ckpt = Checkpointer(args.ckpt_dir, max_to_keep=keep, save_interval_steps=every)
    start_epoch = start_iter = 0
    if getattr(args, "resume", False):
        if sharded is not None:
            resume_step = ckpt.resume_full(state)
        else:
            state, resume_step = maybe_restore(ckpt, state)
        if resume_step:
            start_epoch, start_iter = resume_position(resume_step, steps_per_epoch)
            print("resumed from step {} → epoch {} iter {}".format(
                resume_step, start_epoch, start_iter))
    return ckpt, state, start_epoch, start_iter


def train_single(args, device="cuda") -> Tuple[TrainState, MetricsLogger]:
    """Single-process training (reference ``make single``/``make gpu``) on
    ``device``: the optimizer, schedule, clipping, decay and accumulation of
    the CLI flags, ``--steps-per-dispatch`` steps a dispatch, checkpoints,
    float32 or bfloat16 computation. Sets full float32 (no TF32) for the
    run. AlexNet's relu→pool tails run the ``relu_pool2`` kernels in either
    dtype."""
    from distributed_ml_pytorch_tpu_torch.models import get_model

    dev = resolve_device(device)
    full_float32()
    x_train, y_train, x_test, y_test = get_dataset(args)
    seed = getattr(args, "seed", 0)
    model = get_model(getattr(args, "model", "alexnet"), fused_epilogue=True, seed=seed,
                      device=dev, dtype=getattr(args, "dtype", "float32"))
    steps_per_epoch = max(1, len(x_train) // args.batch_size)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    state, tx = state_from_args(args, model, steps_per_epoch, generator)
    train_step = make_train_step(model, tx)
    spd = int(getattr(args, "steps_per_dispatch", 1) or 1)
    scan_step = make_scan_train_step(model, tx, spd) if spd > 1 else None
    eval_step = make_eval_fn(model)
    logger = MetricsLogger(getattr(args, "log_dir", "log"))
    ckpt, state, start_epoch, start_iter = setup_checkpoint(args, state, steps_per_epoch)
    t0 = time.time()
    try:
        state = run_training_loop(state=state, train_step=train_step, eval_step=eval_step,
                                  data=(x_train, y_train, x_test, y_test), args=args,
                                  logger=logger, device=dev, ckpt=ckpt,
                                  start_epoch=start_epoch, start_iter=start_iter,
                                  scan_step=scan_step)
    finally:
        if ckpt is not None:
            ckpt.close()
    print("Finished Training ({:.1f}s)".format(time.time() - t0))
    return state, logger
