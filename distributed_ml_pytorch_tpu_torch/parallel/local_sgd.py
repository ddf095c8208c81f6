"""Local SGD with periodic parameter averaging (counterpart of the JAX
``parallel/local_sgd.py``), the synchronous reformulation of the
reference's DownPour push/pull cadence.

Every rank takes ``k = --sync-every`` optimizer steps on its own shard of
the data, with no cross-rank gradient, then the ranks average their
parameters and their optimizer's floating state with one ``all_reduce``
over ``data`` (the integer counters, identical on every rank, are reduced
with MAX so they keep their dtype, as the JAX round ``pmax``es them). The
round's k losses are averaged over the ranks step by step. With ``k = 1``
and plain SGD a round equals a sync-DP step; with ``k > 1`` the ranks'
trajectories diverge between averages.

- ``n_push = n_pull = k`` ↔ ``--sync-every k`` (default ``--num-push``);
- the round dispatcher and the R-round dispatcher run the same round body;
  checkpoints (rank 0 writes) land on round boundaries, where the state is
  averaged, and a resumed run restarts at the exact round.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.parallel.sync import dropout_generator, shard_batch
from distributed_ml_pytorch_tpu_torch.runtime.mesh import DeviceMesh, data_mesh, flat_all_reduce
from distributed_ml_pytorch_tpu_torch.training.trainer import (
    TrainState,
    _as_tensors,
    _sgd_step_body,
    evaluate,
    make_eval_fn,
    state_from_args,
)
from distributed_ml_pytorch_tpu_torch.utils.metrics import MetricsLogger, print_eval_line


def average_state(mesh: DeviceMesh, state: TrainState, axis: str = "data") -> None:
    """The parameters and the optimizer's floating tensors replaced by their
    mean over ``axis`` (one SUM ``all_reduce`` per dtype, divided by the axis
    size); integer tensors by their MAX, in place."""
    n = mesh.axis_size(axis)
    tensors = [p.data for p in state.model.parameters()] + state.opt_state.tensors()
    floats = [t for t in tensors if t.is_floating_point()]
    ints = [t for t in tensors if not t.is_floating_point()]
    with torch.no_grad():
        for t, s in zip(floats, flat_all_reduce(mesh, floats, axis)):
            t.copy_(s / n)
        for t, s in zip(ints, flat_all_reduce(mesh, ints, axis, op="max")):
            t.copy_(s)


def _round_body(model, tx, params, mesh: DeviceMesh, axis: str, seed: int,
                state: TrainState, images, labels) -> torch.Tensor:
    """One round: ``images [k, b, ...]`` are this rank's k microbatches; k
    local steps, then :func:`average_state`. Returns the k losses averaged
    over the ranks. Shared by the one-round and R-round dispatchers."""
    rank = mesh.axis_index(axis)
    losses = []
    for i in range(images.shape[0]):
        gen = dropout_generator(seed, state.step, rank, mesh.device)
        losses.append(_sgd_step_body(model, tx, params, state.opt_state, images[i], labels[i],
                                     gen).float())
        state.step += 1
    average_state(mesh, state, axis)
    with torch.no_grad():
        total = flat_all_reduce(mesh, [torch.stack(losses)], axis)[0]
    return total / mesh.axis_size(axis)


def make_local_sgd_round(model: nn.Module, tx, mesh: DeviceMesh, axis: str = "data",
                         seed: int = 0) -> Callable:
    """``round_fn(state, images [k, b, ...], labels [k, b]) -> (state, losses
    [k])`` over this rank's shard (:func:`~.sync.shard_batch` with ``dim=1``
    of the global ``[k, B, ...]`` stack)."""
    params = list(model.parameters())

    def round_fn(state: TrainState, images, labels):
        xs, ys = _as_tensors(images, labels)
        losses = _round_body(model, tx, params, mesh, axis, seed, state,
                             xs.to(mesh.device), ys.to(mesh.device))
        return state, losses

    return round_fn


def make_local_sgd_rounds(model: nn.Module, tx, mesh: DeviceMesh, axis: str = "data",
                          seed: int = 0) -> Callable:
    """R whole rounds a dispatch: ``rounds_fn(state, images [R, k, b, ...],
    labels [R, k, b]) -> (state, losses [R, k])``, each round
    :func:`make_local_sgd_round`'s body."""
    params = list(model.parameters())

    def rounds_fn(state: TrainState, images, labels):
        xs, ys = _as_tensors(images, labels)
        xs, ys = xs.to(mesh.device), ys.to(mesh.device)
        out = [_round_body(model, tx, params, mesh, axis, seed, state, xs[r], ys[r])
               for r in range(xs.shape[0])]
        return state, torch.stack(out)

    return rounds_fn


def _round_batches(x, y, global_batch: int, k: int, seed: int, epoch: int,
                   start_round: int = 0):
    """``(k, global_batch, ...)`` stacks, k microbatches a round, in an order
    that is a pure function of ``(seed, epoch)`` (the JAX ``_round_batches``);
    ``start_round`` fast-forwards a resumed run."""
    n = len(x)
    idx = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(idx)
    per_round = global_batch * k
    limit = (n // per_round) * per_round
    for start in range(start_round * per_round, limit, per_round):
        sel = idx[start:start + per_round]
        yield x[sel].reshape(k, global_batch, *x.shape[1:]), y[sel].reshape(k, global_batch)


def train_local_sgd(args, mesh: Optional[DeviceMesh] = None
                    ) -> Tuple[TrainState, MetricsLogger]:
    """Local-SGD training: ``--sync-every`` (default ``--num-push``) local
    steps between averages, the optimizer surface of ``state_from_args``,
    ``--steps-per-dispatch K`` fusing ⌈K/k⌉ whole rounds into one dispatch
    (a group never crosses an eval or checkpoint boundary), ``--ckpt-dir``
    checkpoints at round boundaries (``--ckpt-every`` rounded to them) with
    exact resume. ``--batch-size`` is the per-rank batch. ``--profile-dir``
    traces rank 0's dispatches over the steps ``[--profile-start, +
    --profile-steps)`` (a group that strides over the window is traced
    whole; ranks that are threads of one process share one profiler)."""
    from distributed_ml_pytorch_tpu_torch.data import get_dataset
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sync import replicate
    from distributed_ml_pytorch_tpu_torch.training.trainer import setup_checkpoint
    from distributed_ml_pytorch_tpu_torch.utils.tracing import TraceWindow

    mesh = mesh or data_mesh()
    n = mesh.axis_size("data")
    k = int(getattr(args, "sync_every", 0) or args.num_push)
    global_batch = args.batch_size * n
    if mesh.device.type == "cuda":
        full_float32()
    x_train, y_train, x_test, y_test = get_dataset(args)
    seed = getattr(args, "seed", 0)
    model = get_model(getattr(args, "model", "alexnet"), seed=seed, device=mesh.device,
                      dtype=getattr(args, "dtype", "float32"))
    state, tx = state_from_args(args, model, len(x_train) // global_batch)
    rounds_per_epoch = len(x_train) // (global_batch * k)
    steps_per_epoch = rounds_per_epoch * k
    if getattr(args, "ckpt_dir", None):
        every = max(k, (int(getattr(args, "ckpt_every", 500)) // k) * k)
        if every != getattr(args, "ckpt_every", 500):
            print("local-sgd: --ckpt-every {} rounds to {} (round boundaries are every {} "
                  "steps)".format(args.ckpt_every, every, k))
        args.ckpt_every = every
    ckpt, state, start_epoch, start_iter = setup_checkpoint(args, state, steps_per_epoch)
    if ckpt is not None and mesh.rank != 0:
        ckpt.close()
        ckpt = None
    state = replicate(mesh, state)
    spd = int(getattr(args, "steps_per_dispatch", 1) or 1)
    rounds_per_dispatch = max(1, -(-spd // k)) if spd > 1 else 1
    rounds_fn = make_local_sgd_rounds(model, tx, mesh, seed=seed + 1)
    eval_step = make_eval_fn(model)
    logger = MetricsLogger(getattr(args, "log_dir", "log"))
    dev = mesh.device
    tracer = TraceWindow(getattr(args, "profile_dir", None) if mesh.rank == 0 else None,
                         start=getattr(args, "profile_start", 10),
                         n_steps=getattr(args, "profile_steps", 10))
    t0 = time.time()
    step_counter = start_epoch * steps_per_epoch + start_iter

    def emit(losses, first_step):
        ev = None
        for j, loss in enumerate(losses):
            i = first_step + j
            extra = {}
            if i % args.log_interval == 0 and i > 0:
                if ev is None:
                    ev = evaluate(eval_step, x_test, y_test, args.test_batch_size, dev)
                extra = {"test_loss": ev[0], "test_accuracy": ev[1]}
            rec = logger.log_step(i, float(loss), **extra)
            if extra:
                print_eval_line(rec)

    try:
        for epoch in range(start_epoch, args.epochs):
            print("Training for epoch {}".format(epoch))
            skip_rounds = (start_iter // k) if epoch == start_epoch else 0
            pending = []

            def flush():
                nonlocal state, step_counter
                if not pending:
                    return
                rx = np.stack([p[0] for p in pending])
                ry = np.stack([p[1] for p in pending])
                n_r = len(pending)
                tracer.on_step(step_counter, n_steps=n_r * k)
                state, losses = rounds_fn(state, *shard_batch(mesh, rx, ry, dim=2))
                pending.clear()
                losses = losses.reshape(-1).cpu().tolist()  # waits for the dispatch
                tracer.after_step(step_counter + n_r * k)
                emit(losses, step_counter)
                step_counter += n_r * k
                if ckpt is not None:
                    ckpt.save(state.step, state)

            for rx, ry in _round_batches(x_train, y_train, global_batch, k, seed, epoch,
                                         start_round=skip_rounds):
                pending.append((rx, ry))
                first = step_counter + (len(pending) - 1) * k
                at_eval = any(i % args.log_interval == 0 and i > 0
                              for i in range(first, first + k))
                at_ckpt = ckpt is not None and (first + k) % ckpt.save_interval_steps == 0
                if len(pending) >= rounds_per_dispatch or at_eval or at_ckpt:
                    flush()
            flush()
            # a window across the epoch's end stops here, before the eval
            tracer.close()
            evaluate(eval_step, x_test, y_test, args.test_batch_size, dev, verbose=True)
    finally:
        tracer.close()
        tracer.warn_if_never_opened()
        if ckpt is not None:
            try:
                ckpt.save(state.step, state, force=True)
                ckpt.wait()
            except Exception as e:  # never mask the original exception
                print(f"warning: final checkpoint save failed: {e}", file=sys.stderr)
            ckpt.close()
    print("Finished local-SGD training ({:.1f}s, {} ranks, sync every {} steps)".format(
        time.time() - t0, mesh.size, k))
    return state, logger
