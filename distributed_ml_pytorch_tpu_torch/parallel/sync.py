"""Synchronous data parallelism over the device mesh (counterpart of the JAX
``parallel/sync.py``).

Each rank computes the loss and gradients of its shard of the global batch,
then one ``all_reduce`` (SUM, every gradient flattened into one buffer)
over the ``data`` axis, divided by the axis size, is the global-batch mean
gradient (the JAX step divides the psum by ``psum(1)``); the loss is
averaged the same way. Parameters and optimizer state are replicated and
every rank applies the same update, so no broadcast follows (the DDP
invariant); :func:`replicate` broadcasts rank 0's state once at the start.

Dropout draws come from a generator seeded by ``(seed, step, rank)``
(:func:`dropout_generator`): ``jax.random`` streams cannot be reproduced in
PyTorch, so the parity tests use AlexNet, which has no dropout, as the JAX
tests do. The K-step dispatcher (:func:`make_sync_scan_step`) runs the
per-step body K times, so the two are equal bit for bit; it is a loop on
every device (a CUDA graph cannot capture a gloo collective).
"""

from __future__ import annotations

import copy
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.runtime.mesh import (
    DeviceMesh,
    data_mesh,
    flat_all_reduce,
    rows_of,
)
from distributed_ml_pytorch_tpu_torch.training.trainer import (
    TrainState,
    _apply,
    _as_tensors,
    _grads,
    make_eval_fn,
    run_training_loop,
)
from distributed_ml_pytorch_tpu_torch.utils.metrics import MetricsLogger


def dropout_generator(seed: int, step: int, rank: int, device) -> torch.Generator:
    """The dropout generator of ``step`` on ``rank``: seeded from ``(seed,
    step, rank)`` alone, so the per-step and K-step dispatchers draw the same
    masks."""
    hi, lo = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(step), int(rank)]
                                    ).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(hi) << 32) | int(lo))
    return gen


def shard_batch(mesh: DeviceMesh, *arrays, axis: str = "data", dim: int = 0):
    """This rank's rows of global host (or device) arrays, sharded along
    ``dim`` over ``axis``, as tensors on the rank's device (images float32,
    integer arrays int64)."""
    out = []
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            a = torch.from_numpy(np.ascontiguousarray(
                a, np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32))
        idx = [slice(None)] * a.dim()
        idx[dim] = rows_of(a.shape[dim], mesh, axis)
        out.append(a[tuple(idx)].to(mesh.device, non_blocking=True))
    return tuple(out) if len(out) > 1 else out[0]


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of a replicated state: parameters, buffers and the
    optimizer's state (its counters included)."""
    return ([p.data for p in state.model.parameters()] + list(state.model.buffers())
            + state.opt_state.tensors())


def replicate(mesh: DeviceMesh, state: TrainState) -> TrainState:
    """Rank 0's parameters, buffers and optimizer state on every rank (a
    broadcast along every axis from index 0); returns ``state``."""
    with torch.no_grad():
        for t in state_tensors(state):
            for axis in mesh.names:
                mesh.broadcast(t, axis, 0)
    return state


def mean_over(mesh: DeviceMesh, tensors: Sequence[torch.Tensor], axis: str
              ) -> List[torch.Tensor]:
    """The mean over ``axis`` of every tensor: one SUM ``all_reduce`` of the
    flattened tensors, divided by the axis size (the JAX ``psum / psum(1)``)."""
    n = mesh.axis_size(axis)
    return [t / n for t in flat_all_reduce(mesh, tensors, axis)]


def _sync_step_body(model, tx, params, mesh: DeviceMesh, axis: str, seed: int,
                    state: TrainState, images, labels) -> torch.Tensor:
    """One DDP step on this rank's shard, shared by the per-step and K-step
    dispatchers: local gradients, the mean over ``axis``, the update."""
    gen = dropout_generator(seed, state.step, mesh.axis_index(axis), mesh.device)
    loss, grads = _grads(model, params, images, labels, gen)
    with torch.no_grad():
        grads = mean_over(mesh, grads, axis)
        loss = mean_over(mesh, [loss.float().reshape(1)], axis)[0][0]
    _apply(tx, state.opt_state, params, grads)
    state.step += 1
    return loss


def make_sync_train_step(model: nn.Module, tx, mesh: DeviceMesh, axis: str = "data",
                         seed: int = 0) -> Callable:
    """``step(state, images, labels) -> (state, loss)`` over this rank's
    shard of the batch (:func:`shard_batch`): local gradients, their mean
    over ``axis``, the optimizer's update of the replicated parameters.
    ``loss`` is the global-batch mean (a device tensor)."""
    params = list(model.parameters())

    def step(state: TrainState, images, labels):
        x, y = _as_tensors(images, labels)
        loss = _sync_step_body(model, tx, params, mesh, axis, seed, state,
                               x.to(mesh.device), y.to(mesh.device))
        return state, loss

    return step


def make_sync_scan_step(model: nn.Module, tx, mesh: DeviceMesh, axis: str = "data",
                        seed: int = 0) -> Callable:
    """K DDP steps a dispatch: ``scan(state, images [K, b, ...], labels [K,
    b]) -> (state, losses [K])`` over this rank's shard of K stacked batches,
    each step :func:`make_sync_train_step`'s body (equal to K calls of it
    bit for bit)."""
    params = list(model.parameters())

    def scan(state: TrainState, images, labels):
        xs, ys = _as_tensors(images, labels)
        xs, ys = xs.to(mesh.device), ys.to(mesh.device)
        losses = [_sync_step_body(model, tx, params, mesh, axis, seed, state, xs[i], ys[i])
                  for i in range(xs.shape[0])]
        return state, torch.stack(losses)

    return scan


def _mesh_eval(eval_step: Callable, before: Optional[Callable], after: Optional[Callable]
               ) -> Callable:
    """``eval_step`` with ``before()``/``after()`` around each call (the
    FSDP strategy gathers its parameters for the eval and frees them)."""
    if before is None:
        return eval_step

    def run(images, labels):
        before()
        try:
            return eval_step(images, labels)
        finally:
            after()

    return run


def train_data_parallel(args, mesh: Optional[DeviceMesh], strategy: Callable, label: str,
                        sharded: Optional[Tuple[str, Callable]] = None
                        ) -> Tuple[TrainState, MetricsLogger]:
    """The shared data-parallel driver of sync DP and FSDP (the JAX
    ``train_data_parallel``).

    ``--batch-size`` is the per-rank batch (the reference's per-worker 64);
    the global batch is ``batch_size × mesh size``. Every rank walks the same
    seeded global order and takes its rows of each batch, which is the JAX
    single controller's placement. ``strategy(model, tx, mesh, state) ->
    (state, step, scan_step, suffix, eval_hooks)`` owns the layout: placing
    the (possibly restored) state, the steps over the global host batch, and
    ``(before, after)`` around an eval (or ``None``). The data, the model,
    the optimizer surface, checkpoints (rank 0 writes; every rank restores)
    and the loop (``training/trainer.run_training_loop``) are one copy here.
    ``sharded = (mode, layout_fn)`` checkpoints a state the strategy shards:
    every rank takes part in each save's gather, the parameters are
    restored into the full model before the strategy places it and the
    optimizer state after (``utils/checkpoint.ShardedCheckpointer``).
    """
    from distributed_ml_pytorch_tpu_torch.data import get_dataset
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        setup_checkpoint,
        state_from_args,
    )

    mesh = mesh or data_mesh()
    n = mesh.axis_size("data")
    global_batch = args.batch_size * n
    if mesh.device.type == "cuda":
        full_float32()
    x_train, y_train, x_test, y_test = get_dataset(args)
    seed = getattr(args, "seed", 0)
    model = get_model(getattr(args, "model", "alexnet"), seed=seed, device=mesh.device,
                      dtype=getattr(args, "dtype", "float32"))
    steps_per_epoch = len(x_train) // global_batch
    state, tx = state_from_args(args, model, steps_per_epoch)
    ckpt, state, start_epoch, start_iter = setup_checkpoint(
        args, state, steps_per_epoch, sharded=None if sharded is None else (*sharded, mesh))
    if ckpt is not None and mesh.rank != 0 and sharded is None:
        ckpt.close()
        ckpt = None
    state, step, scan_step, suffix, hooks = strategy(model, tx, mesh, state)
    if sharded is not None and ckpt is not None and ckpt.restored is not None:
        ckpt.restore_placed(state)
    eval_step = _mesh_eval(make_eval_fn(model), *(hooks or (None, None)))
    logger = MetricsLogger(getattr(args, "log_dir", "log"))
    loop_args = copy.copy(args)
    loop_args.batch_size = global_batch
    # the steps take the host batch and move this rank's rows themselves
    loop_args.prefetch = 0
    t0 = time.time()
    try:
        state = run_training_loop(state=state, train_step=step, eval_step=eval_step,
                                  data=(x_train, y_train, x_test, y_test), args=loop_args,
                                  logger=logger, device=mesh.device, ckpt=ckpt,
                                  start_epoch=start_epoch, start_iter=start_iter,
                                  scan_step=scan_step)
    finally:
        if ckpt is not None:
            ckpt.close()
    print("Finished {} training ({:.1f}s, {} ranks{})".format(
        label, time.time() - t0, mesh.size, suffix))
    return state, logger


def train_sync(args, mesh: Optional[DeviceMesh] = None) -> Tuple[TrainState, MetricsLogger]:
    """Synchronous data-parallel training (replicated state, the gradient
    mean over ``data`` every step); see :func:`train_data_parallel`."""
    seed = getattr(args, "seed", 0) + 1

    def strategy(model, tx, mesh, state):
        state = replicate(mesh, state)
        step = make_sync_train_step(model, tx, mesh, seed=seed)
        scan = make_sync_scan_step(model, tx, mesh, seed=seed)

        def sharded_step(state, bx, by):
            return step(state, *shard_batch(mesh, bx, by))

        def sharded_scan(state, bxs, bys):
            xs, ys = _as_tensors(bxs, bys)
            return scan(state, *shard_batch(mesh, xs, ys, dim=1))

        return state, sharded_step, sharded_scan, "", None

    return train_data_parallel(args, mesh, strategy, "sync-DP")
