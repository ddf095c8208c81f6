"""Async DownPour-SGD parameter server (counterpart of the JAX
``parallel/async_ps.py``; the reference's ``asgd/optim/Asynchronous.py``).

- Workers train locally with SGD and accumulate their updates into a flat
  float32 vector every step (``accum += updates`` through the ``flat_axpy``
  kernel, ``ops/fused_update.py``).
- Every ``n_pull`` steps a worker sends **ParameterRequest**; the server
  replies with **ParameterUpdate** carrying the central vector.
- Every ``n_push`` steps the worker sends **GradientUpdate** with the
  accumulator and starts a fresh one; the server ADDS it to the central
  vector (the updates are already lr-scaled).
- At construction each worker installs its initial parameters as the central
  vector (one ParameterUpdate); ``WorkerDone`` lets the server stop once
  every worker has finished.

The flat vector is laid out exactly as the JAX package lays it out
(``utils/serialization.py``), so a port worker can train against a JAX
server and the other way round. A listener thread receives replies while the
worker trains and the optimizer installs the newest one between steps, so no
step sees a torn model. Pushes are copied to the host and sent by a
background thread (:class:`PushFlusher`) while the next steps run.

Not in this package yet (the JAX server's other planes): write-ahead log,
checkpoint/resume, admission and nacks, Adasum, the sharded server-side
optimizer, delta pulls, compressed pushes, rejoin and chunked dispatch.
"""

from __future__ import annotations

import logging
import queue
import sys
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.ops.fused_update import LANES, flat_axpy
from distributed_ml_pytorch_tpu_torch.utils.failure import StalenessAuditor
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    SERVER_RANK,
    MessageCode,
    MessageListener,
    Transport,
    send_message,
)
from distributed_ml_pytorch_tpu_torch.utils.serialization import (
    make_unraveler,
    ravel_model_params,
    ravel_tensors,
    unravel_model_params,
)

_LOGGER = logging.getLogger(__name__)


class ParameterServer:
    """Central parameter holder: a host float32 vector.

    ``run()`` serves messages until every worker has sent ``WorkerDone``
    (or failed, with ``worker_timeout``), ``stop()`` is called or the
    timeout passes.
    """

    def __init__(self, model: Optional[nn.Module] = None, *,
                 params: Optional[np.ndarray] = None,
                 transport: Optional[Transport] = None,
                 n_workers: Optional[int] = None,
                 worker_timeout: Optional[float] = None):
        if params is not None:
            self.central = np.asarray(params, dtype=np.float32).copy()
        elif model is not None:
            self.central = ravel_model_params(model).cpu().numpy().astype(np.float32)
        else:
            raise ValueError("ParameterServer needs a model or a flat params vector")
        self.transport = transport
        self.n_workers = n_workers
        self.worker_timeout = worker_timeout
        self.failed_workers: set = set()
        self.message_counts = {code: 0 for code in MessageCode}
        self.dropped_bad_updates = 0
        self.staleness = StalenessAuditor()
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def handle(self, sender: int, code: MessageCode, payload: np.ndarray) -> None:
        _LOGGER.info("Processing message: %s", MessageCode(code).name)
        self.message_counts[code] = self.message_counts.get(code, 0) + 1
        if code == MessageCode.GradientUpdate:
            self._apply_update(sender, payload)
        elif code == MessageCode.ParameterRequest:
            self._reply(sender, self.central)
            self.staleness.on_pull(sender)
        elif code == MessageCode.ParameterUpdate:
            if payload.shape != self.central.shape:
                self.dropped_bad_updates += 1
                _LOGGER.warning("dropping install from %d: %d params vs central %d",
                                sender, payload.size, self.central.size)
                return
            self.central = payload.astype(np.float32).copy()

    def _apply_update(self, sender: int, payload: np.ndarray) -> None:
        if payload.shape != self.central.shape:
            # validated before any accounting: a wrong-size push must not
            # move the version clock or broadcast into the vector
            self.dropped_bad_updates += 1
            _LOGGER.warning("dropping update from %d: %d params vs central %d "
                            "(wrong model?)", sender, payload.size, self.central.size)
            return
        self.staleness.on_push(sender)
        self.central += payload

    def _reply(self, sender: int, payload: np.ndarray) -> None:
        """Answer one worker; a worker gone between request and reply must
        not take the server down."""
        try:
            send_message(MessageCode.ParameterUpdate, payload, dst=sender,
                         transport=self.transport)
        except (OSError, ConnectionError, KeyError):
            _LOGGER.warning("reply to worker %d failed (peer gone?) — dropping it", sender)

    def run(self, timeout: Optional[float] = None) -> None:
        """Serve until all workers finish (or ``stop()``/``timeout``). With
        ``worker_timeout``, a worker silent that long (heartbeats count) is
        declared failed and no longer waited for."""
        done_workers = set()
        detector = None
        if self.worker_timeout and self.n_workers is not None:
            from distributed_ml_pytorch_tpu_torch.utils.failure import FailureDetector

            detector = FailureDetector(self.worker_timeout,
                                       ranks=range(1, self.n_workers + 1))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            if detector is not None:
                for rank in sorted(detector.expired()):
                    print("parameter server: worker {} silent for {:.1f}s — "
                          "declaring it failed".format(rank, self.worker_timeout))
                self.failed_workers = set(detector.failed)
                if len(done_workers) + len(self.failed_workers) >= self.n_workers:
                    break
            msg = self.transport.recv(timeout=0.2)
            if msg is None:
                continue
            sender, code, payload = msg
            if detector is not None:
                detector.note(sender)
                self.failed_workers = set(detector.failed)
            if code == MessageCode.Heartbeat:
                self.message_counts[code] += 1
                continue
            if code == MessageCode.WorkerDone:
                self.message_counts[code] += 1
                done_workers.add(sender)
                if detector is not None:
                    detector.forget(sender)
                if self.n_workers is not None and (
                        len(done_workers) + len(self.failed_workers) >= self.n_workers):
                    break
                continue
            self.handle(sender, code, payload)
        line = self.staleness.report()
        if line:
            print("parameter server:", line)


def validate_downpour_args(lr: float, n_push: int, n_pull: int) -> None:
    if lr < 0.0:
        raise ValueError("Invalid learning rate: {}".format(lr))
    if int(n_push) < 1 or int(n_pull) < 1:
        raise ValueError("Invalid cadence: n_push={}, n_pull={} (both must be >= 1)"
                         .format(n_push, n_pull))


def init_downpour_accumulator(model: nn.Module):
    """``(flat_init, flat_n, pad, accum)``: the flat parameters (host), their
    count, the pad up to a multiple of ``LANES`` (the JAX package's length),
    and a zero accumulator of ``flat_n + pad`` on the model's device."""
    flat = ravel_model_params(model).cpu().numpy()
    n = int(flat.shape[0])
    pad = (-n) % LANES
    device = next(model.parameters()).device
    return flat, n, pad, torch.zeros(n + pad, dtype=torch.float32, device=device)


def default_downpour_tx(lr: float):
    """The reference worker recipe: plain SGD, no momentum."""
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    return SGD(lr)


def _downpour_micro_update(tx, model: nn.Module, opt_state, accum: torch.Tensor,
                           scratch: torch.Tensor, flat_n: int) -> torch.Tensor:
    """THE DownPour per-step device math: the local optimizer turns the
    gradients in ``p.grad`` into updates, the flat updates accumulate into
    ``accum`` through the ``flat_axpy`` kernel (``accum += 1.0·updates``, in
    place), and the same updates apply to the parameters. ``scratch`` is the
    padded flat-update buffer; its tail past ``flat_n`` stays zero."""
    names, params = zip(*model.named_parameters())
    updates = tx.update([p.grad for p in params], opt_state, list(params))
    ravel_tensors(model, dict(zip(names, updates)), out=scratch[:flat_n])
    flat_axpy(accum, scratch, 1.0)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
    return accum


def make_downpour_device_step(model: nn.Module, tx, flat_n: int, pad: int):
    """``step(opt_state, accum) -> accum``: :func:`_downpour_micro_update`
    with its padded scratch buffer allocated once."""
    device = next(model.parameters()).device
    scratch = torch.zeros(flat_n + pad, dtype=torch.float32, device=device)

    def _device_step(opt_state, accum):
        return _downpour_micro_update(tx, model, opt_state, accum, scratch, flat_n)

    return _device_step


class Listener(MessageListener):
    """Receives the server's ParameterUpdate replies and deposits the newest
    in a mailbox for the optimizer to install between steps."""

    def __init__(self, transport: Optional[Transport] = None):
        super().__init__(transport=transport)
        self._lock = threading.Lock()
        self._latest: Optional[np.ndarray] = None

    def receive(self, sender: int, message_code: MessageCode, parameter: np.ndarray) -> None:
        if message_code == MessageCode.ParameterUpdate:
            with self._lock:
                self._latest = parameter

    def take_latest(self) -> Optional[np.ndarray]:
        with self._lock:
            latest, self._latest = self._latest, None
        return latest


class PushFlusher:
    """Background push pipeline: the cadence boundary hands the device
    accumulator to this thread, which copies it to the host and sends it
    while the training thread runs the next steps. FIFO (one thread, one
    queue), so pushes arrive in cadence order; at most ``MAX_IN_FLIGHT``
    pushes wait, beyond which :meth:`enqueue` blocks (backpressure)."""

    MAX_IN_FLIGHT = 2

    def __init__(self, send_fn):
        self._send_fn = send_fn  # called with the host np.ndarray
        self._q: "queue.Queue" = queue.Queue(maxsize=self.MAX_IN_FLIGHT)
        self._thread = threading.Thread(target=self._run, name="downpour-push-flusher",
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._send_fn(item.detach().cpu().numpy())
            except Exception as e:  # noqa: BLE001 — the thread must survive
                # a failed copy/send loses THIS push (accepted async
                # staleness); a dead thread would deadlock drain()
                print(f"push flusher: dropping one push after {type(e).__name__}: {e}",
                      file=sys.stderr)
            finally:
                self._q.task_done()

    def enqueue(self, vec: torch.Tensor) -> None:
        self._q.put(vec)

    def drain(self) -> None:
        """Block until every enqueued push has been copied and sent."""
        self._q.join()

    def stop(self) -> None:
        self.drain()
        self._q.put(None)
        self._thread.join(timeout=10)


class Asynchronous:
    """DownPour-SGD client optimizer (reference ``Asynchronous.py:20-71``).

    Used like a torch optimizer: after ``loss.backward()``, ``opt.step()``
    installs the newest pulled parameters (if any), requests a pull every
    ``n_pull`` steps, applies the local update while accumulating it, and
    pushes the accumulator every ``n_push`` steps — both on step index 0
    too, as the reference's ``idx % n == 0`` tests do. The gradients in use
    at a step were computed before that step's install, as in the JAX
    package.
    """

    def __init__(self, model: nn.Module, lr: float, n_push: int, n_pull: int, *,
                 tx=None, transport: Optional[Transport] = None, heartbeat=None):
        validate_downpour_args(lr, n_push, n_pull)
        self.model = model
        self.lr = float(lr)
        self.n_push = int(n_push)
        self.n_pull = int(n_pull)
        self.transport = transport
        self.idx = 0
        self._unravel = make_unraveler(model)
        self.tx = tx if tx is not None else default_downpour_tx(self.lr)
        self.opt_state = self.tx.init(list(model.parameters()))
        flat, self._flat_n, self._pad, self.accum = init_downpour_accumulator(model)
        # attach the listener before anything is sent, so no reply can race it
        self.listener = Listener(transport=transport)
        self.listener.start()
        # install this worker's initial params as the central params (:34)
        send_message(MessageCode.ParameterUpdate, flat, transport=transport)
        self.server_down = False
        self.heartbeat = heartbeat
        self._device_step = make_downpour_device_step(model, self.tx, self._flat_n,
                                                      self._pad)
        self._flusher = PushFlusher(
            lambda arr: self._send(MessageCode.GradientUpdate, arr))

    def _send(self, code: MessageCode, payload) -> None:
        """Send toward the server; a dead server degrades the worker to
        purely-local SGD with one warning instead of crashing mid-epoch."""
        if self.server_down:
            return
        if self.heartbeat is not None and self.heartbeat.peer_down:
            self.server_down = True
        else:
            try:
                send_message(code, payload, transport=self.transport)
                return
            except (OSError, ConnectionError):
                self.server_down = True
        print("worker: parameter server unreachable — continuing with purely-local "
              "SGD (no further push/pull)", file=sys.stderr)

    def install(self, flat: np.ndarray) -> None:
        """Copy a central vector into the model (between steps)."""
        device = self.accum.device
        unravel_model_params(self.model, torch.from_numpy(flat).to(device),
                             unravel=self._unravel)

    def step(self) -> None:
        latest = self.listener.take_latest()
        if latest is not None:
            self.install(latest)
        if self.idx % self.n_pull == 0:
            self._send(MessageCode.ParameterRequest, np.zeros(0, np.float32))
        self.accum = self._device_step(self.opt_state, self.accum)
        if self.idx % self.n_push == 0:
            # hand the accumulator to the flusher and start a fresh one; the
            # training thread never touches the handed-off buffer again
            self._flusher.enqueue(self.accum[: self._flat_n])
            self.accum = torch.zeros_like(self.accum)
        self.idx += 1

    def finish(self) -> None:
        """Flush a final push, notify the server, stop the threads."""
        self._flusher.drain()
        self._send(MessageCode.GradientUpdate, self.accum[: self._flat_n])
        self._send(MessageCode.WorkerDone, np.zeros(0, np.float32))
        self._flusher.stop()
        if self.heartbeat is not None:
            self.heartbeat.stop()
        self.listener.stop()


# the same optimizer under its original DownPour name
DownpourSGD = Asynchronous


def train_worker(args, transport: Transport, heartbeat=None,
                 device="cuda") -> Tuple[nn.Module, "MetricsLogger"]:
    """Worker-side training loop (reference ``main(args)`` distributed
    branch): per-step forward/backward, ``Asynchronous.step``, an eval every
    ``log_interval`` steps and at each epoch end. Sets full float32 (no
    TF32) for the run."""
    from distributed_ml_pytorch_tpu_torch.data import get_dataset, iterate_batches
    from distributed_ml_pytorch_tpu_torch.device import full_float32, resolve_device
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        evaluate,
        loss_and_grads,
        make_eval_fn,
        to_device,
        tx_from_args,
    )
    from distributed_ml_pytorch_tpu_torch.utils.metrics import MetricsLogger, print_eval_line

    dev = resolve_device(device)
    full_float32()
    x_train, y_train, x_test, y_test = get_dataset(args)
    seed = getattr(args, "seed", 0)
    # AlexNet's relu→pool tails run the relu_pool2 kernel: same numerics
    model = get_model(getattr(args, "model", "alexnet"), fused_epilogue=True,
                      seed=seed, device=dev)
    # the full optimizer surface of the CLI, its schedule in local updates
    steps_per_epoch = len(x_train) // args.batch_size
    opt = Asynchronous(model, lr=args.lr, n_push=args.num_push, n_pull=args.num_pull,
                       tx=tx_from_args(args, steps_per_epoch), transport=transport,
                       heartbeat=heartbeat)
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + transport.rank)
    eval_step = make_eval_fn(model)
    logger = MetricsLogger(getattr(args, "log_dir", "runs"))
    for epoch in range(args.epochs):
        print("Training for epoch {}".format(epoch))
        batches = iterate_batches(x_train, y_train, args.batch_size,
                                  seed=seed + 1000 * transport.rank, epoch=epoch)
        for i, (bx, by) in enumerate(batches):
            loss = loss_and_grads(model, *to_device(bx, by, dev), generator=gen)
            opt.step()
            extra = {}
            if i % args.log_interval == 0 and i > 0:
                test_loss, test_acc = evaluate(eval_step, x_test, y_test,
                                               args.test_batch_size, dev)
                extra = {"test_loss": test_loss, "test_accuracy": test_acc}
            rec = logger.log_step(i, float(loss), **extra)
            if extra:
                print_eval_line(rec)
        evaluate(eval_step, x_test, y_test, args.test_batch_size, dev, verbose=True)
    opt.finish()
    return model, logger


def run_server(args, transport: Transport) -> ParameterServer:
    """Server-side entry (reference ``init_server``): the central vector
    starts from the seeded model, built on the host — the server never
    touches the card."""
    from distributed_ml_pytorch_tpu_torch.models import get_model

    model = get_model(getattr(args, "model", "alexnet"), seed=getattr(args, "seed", 0),
                      device="cpu")
    server = ParameterServer(model, transport=transport, n_workers=args.world_size - 1,
                             worker_timeout=getattr(args, "worker_timeout", 0.0) or None)
    server.run()
    if server.failed_workers:
        print("parameter server: finished with failed workers: {}".format(
            sorted(server.failed_workers)))
    return server


def run_ps_process(args) -> int:
    """CLI entry for one PS-world process (rank 0 = server, 1+ = workers)."""
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

    if args.rank is None:
        raise SystemExit("--rank is required for distributed --mode ps runs")
    is_server = args.server or args.rank == SERVER_RANK
    transport = make_transport(args.rank, args.world_size, args.master, int(args.port))
    heartbeat = None
    try:
        if is_server:
            server = run_server(args, transport)
            if not server.failed_workers:
                print("parameter server: all workers done")
        else:
            if args.heartbeat_interval > 0:
                from distributed_ml_pytorch_tpu_torch.utils.failure import HeartbeatSender

                heartbeat = HeartbeatSender(transport, interval=args.heartbeat_interval)
                heartbeat.start()
            _model, logger = train_worker(args, transport, heartbeat=heartbeat,
                                          device=args.backend)
            print("wrote", logger.to_csv("node{}.csv".format(args.rank)))
            print("Finished Training")
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        transport.close()
    return 0
