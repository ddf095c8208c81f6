"""The reliable wire's faults, each held by a test that failed before its
repair.

- **No timeout on a loss-free wire.** A port ``ParameterServer`` process
  and two worker processes running the port's ``Asynchronous`` on AlexNet
  (2,472,266 floats, 9.9 MB a push or a reply) over localhost TCP with
  ``--reliable``, once with the server's WAL and durable acks and once
  without: 80 steps a worker on the CPU, ``n_push = n_pull = 10``, a 1.3
  ms host sleep a step (a batch-64 step on the card). Nothing is lost, so
  a timeout is spurious: every rank's ``rto_expired`` and ``retries``
  must be 0, and so must the server's ``dup_dropped``. Each rank also
  reports the longest a frame's retransmit clock ran before its ack
  (``max_ack_s``), which a timeout needs to pass the 1 s floor. Before the
  repair, acks of durable pushes waited 0.17-0.49 s for the WAL's group
  commit and frames sent during the rendezvous 0.2-0.55 s for the server,
  against a 0.1 s floor. After it, on an 8-core host, the longest was
  0.45 s over ten runs of this file beside the other wire and
  parameter-server test files under ``-p xdist -n 6``, and 0.574 s with
  six such worlds at once (18 processes on 8 cores; a worker's first push
  waiting for the rendezvous): the floor keeps a margin of 2.2x and 1.7x.
- **No timeout while the other workers start.** A durable server holds a
  push's ack until its application has handed the push out and logged it,
  and the server's application used to start only once every worker had
  connected: under load (eight copies of this file's first test at once
  beside four busy loops, 8 cores), a worker's first push waited 1.1-1.6
  s for another worker's process start-up, and 4 copies in 32 timed it
  out (0 in 32 after the repair, the longest ack 0.697 s). The server now
  serves the workers that connected while the others connect (a reliable
  server from ``make_transport``, Python or native, returns before its
  rendezvous ends), its ``run`` closing the rendezvous, which still raises
  past its deadline; a push to a server whose second worker has not
  connected is acked within the 1 s floor. The native server used to wait
  out the whole rendezvous in its constructor.
- **Two lives of a rank begun in one second.** A second
  ``ReliableTransport`` of rank 1 built in the same second as the first,
  with the incarnation clock reset as a fresh process has it: its frames
  are delivered, whichever package each life and the receiver run, and a
  JAX receiver still takes a later second's life of either package as
  newer.

Run one rank by hand: ``python tests/test_torch_wire_faults.py server
--port P [--wal DIR]`` or ``... worker --rank R --port P``.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg  # noqa: E402

STEPS = 80
CADENCE = 10
STEP_SLEEP_S = 0.0013


def _alexnet():
    from distributed_ml_pytorch_tpu_torch.models import get_model

    return get_model("alexnet", seed=0, device="cpu")


def _stats(t):
    out = dict(t.stats)
    if isinstance(t, tmsg.ReliableTransport):
        out["max_ack_s"] = t.max_ack_wait
        out["ack_timeout"] = t.ack_timeout
        out["expired"] = t.expired
    return out


def _brief(r):
    return {k: r[k] for k in ("rank", "sent", "retries", "rto_expired", "dup_dropped",
                              "max_ack_s", "expired")}


def _run_server(port, wal_dir):
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    # the CLI's order: build the server, then listen, and serve the first
    # worker while the other connects
    flat = ravel_model_params(_alexnet()).numpy()
    server = ParameterServer(params=flat, n_workers=2, ckpt_dir=wal_dir,
                             wal=wal_dir is not None)
    server.transport = t = make_transport(0, 3, "localhost", port, kind="python",
                                          reliable=True, durable_acks=wal_dir is not None)
    server.run(timeout=120)
    t.close()
    print(json.dumps({"rank": 0, "applied": server._push_count, **_stats(t)}), flush=True)


def _run_worker(rank, port):
    import torch

    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import Asynchronous
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

    torch.set_num_threads(1)
    # the CLI's order: connect, then build the model
    t = make_transport(rank, 3, "localhost", port, kind="python", reliable=True)
    model = _alexnet()
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-4)
    opt = Asynchronous(model, lr=0.008, n_push=CADENCE, n_pull=CADENCE, transport=t)
    for _ in range(STEPS):
        time.sleep(STEP_SLEEP_S)
        opt.step()
    opt.finish()
    t.close()
    print(json.dumps({"rank": rank, **_stats(t)}), flush=True)


def _world(tmp_path, wal):
    from distributed_ml_pytorch_tpu_torch.launch import _free_port

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    me = os.path.abspath(__file__)
    server = [sys.executable, me, "server", "--port", port]
    if wal:
        server += ["--wal", str(tmp_path / "ps")]
    procs = [subprocess.Popen(server, env=env, stdout=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, me, "worker", "--rank", str(r),
                                "--port", port], env=env, stdout=subprocess.PIPE, text=True)
              for r in (1, 2)]
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=180)
            assert p.returncode == 0, text[-2000:]
            out.append(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_loss_free_world_never_retransmits(tmp_path):
    """Run with ``--reliable --wal`` (durable acks), then with ``--reliable``
    alone: 19 frames a worker (install, 8 pulls, 9 pushes, ``WorkerDone``),
    16 replies from the server, none retransmitted."""
    for wal in (True, False):
        ranks = _world(tmp_path / ("wal" if wal else "plain"), wal)
        server, workers = ranks[0], ranks[1:]
        label = "--reliable --wal" if wal else "--reliable"
        assert server["applied"] == 2 * (STEPS // CADENCE + 1), (label, ranks)
        brief = (label, [_brief(r) for r in ranks])
        print(json.dumps(brief))
        assert sum(r["rto_expired"] for r in ranks) == 0, brief
        assert sum(r["retries"] for r in ranks) == 0, brief
        assert server["dup_dropped"] == 0, (label, ranks)
        assert all(w["sent"] == 19 for w in workers), (label, ranks)
        assert server["sent"] == 2 * STEPS // CADENCE, (label, ranks)


def test_taken_in_frames_are_acked_early_but_pushes_only_once_handed_out():
    """The receiver's retry tick takes frames in while its application is
    not reading: a pull is acked at once, but a push to a durable receiver
    stays unacked through a commit until ``recv()`` has handed it out, then
    through the commit after that."""
    MessageCode = tmsg.MessageCode
    world = tmsg.InProcessTransport.create_world(2)
    server = tmsg.ReliableTransport(world[0], ack_on_delivery=False, ack_timeout=0.05)
    worker = tmsg.ReliableTransport(world[1], ack_timeout=0.05)
    try:
        worker.send(MessageCode.ParameterRequest, np.zeros(0, np.float32))
        assert worker.flush(timeout=3), "a pull waited for the application"
        for v in (1.0, 2.0):
            worker.send(MessageCode.GradientUpdate, np.full(3, v, np.float32))
        deadline = time.monotonic() + 3
        while len(server._requeue) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(server._requeue) == 3
        server.ack_delivered()  # a commit for frames the application never saw
        assert not worker.flush(timeout=0.3)
        assert worker.acked_count(0, MessageCode.GradientUpdate) == 0
        assert server.recv(timeout=1)[1] == MessageCode.ParameterRequest
        assert float(server.recv(timeout=1)[2][0]) == 1.0
        server.ack_delivered()
        deadline = time.monotonic() + 3
        while (worker.acked_count(0, MessageCode.GradientUpdate) < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert worker.acked_count(0, MessageCode.GradientUpdate) == 1
        assert float(server.recv(timeout=1)[2][0]) == 2.0
        server.ack_delivered()
        assert worker.flush(timeout=3)
        assert worker.acked_count(0, MessageCode.GradientUpdate) == 2
    finally:
        for t in (worker, server):
            t.detach()


def test_a_receiver_working_through_a_queue_times_nothing_out():
    """Eight pushes sent at once to a durable receiver that applies one
    every 0.1 s: the last is acked 0.8 s after it left, past the 0.25 s
    timeout, but each ack of the oldest pending push restarts the clocks
    of those behind it, so none times out and none is sent twice."""
    MessageCode = tmsg.MessageCode
    world = tmsg.InProcessTransport.create_world(2)
    server = tmsg.ReliableTransport(world[0], ack_on_delivery=False, ack_timeout=0.25)
    worker = tmsg.ReliableTransport(world[1], ack_timeout=0.25)
    try:
        for v in range(8):
            worker.send(MessageCode.GradientUpdate, np.full(3, v, np.float32))
        got = []
        while len(got) < 8:
            msg = server.recv(timeout=3)
            assert msg is not None, (got, worker.stats)
            time.sleep(0.1)  # the apply and the log's fsync
            got.append(float(msg[2][0]))
            server.ack_delivered()
        assert worker.flush(timeout=3), worker.stats
        assert got == [float(v) for v in range(8)]
        assert worker.stats["rto_expired"] == 0 and worker.stats["retries"] == 0, worker.stats
        assert server.stats["dup_dropped"] == 0
        assert 0.1 <= worker.max_ack_wait < 0.25
    finally:
        for t in (worker, server):
            t.detach()


class _SlowFirstHandOff:
    """An inner transport whose first ``ReliableFrame`` takes ``delay_s`` to
    be handed over, as a 9.9 MB push does behind a socket whose reader is
    starved of the CPU; frames arrive only once handed over."""

    def __init__(self, inner, delay_s: float):
        self.inner, self.rank, self.delay_s = inner, inner.rank, delay_s
        self.slow_left = 1

    def sendv(self, code, parts, dst=0):
        if code == tmsg.MessageCode.ReliableFrame and self.slow_left:
            self.slow_left -= 1
            time.sleep(self.delay_s)
        self.inner.send(code, np.concatenate([np.asarray(p, np.float32).ravel()
                                              for p in parts]), dst=dst)

    def send(self, code, payload, dst=0):
        self.sendv(code, (payload,), dst=dst)

    def recv(self, timeout=None):
        return self.inner.recv(timeout=timeout)

    def close(self):
        self.inner.close()


def test_a_frame_still_being_handed_over_does_not_time_out():
    """A push whose hand-off to the inner transport takes 0.3 s, six times
    the 0.05 s timeout floor, to a receiver that acks it at once: its clock
    starts when it has left, so it is acked on its first copy. The retry
    thread used to time it out while its first copy was still leaving and
    send a second behind it: a timeout on a loss-free wire, acked within
    the floor, so ``max_ack_s`` stayed small (the loss-free world's
    ``--reliable`` failure)."""
    MessageCode = tmsg.MessageCode
    world = tmsg.InProcessTransport.create_world(2)
    server = tmsg.ReliableTransport(world[0], ack_timeout=0.05)
    worker = tmsg.ReliableTransport(_SlowFirstHandOff(world[1], 0.3), ack_timeout=0.05)
    try:
        worker.send(MessageCode.GradientUpdate, np.full(3, 1.0, np.float32))
        msg = server.recv(timeout=3)
        assert msg is not None and float(msg[2][0]) == 1.0
        assert worker.flush(timeout=3), worker.stats
        assert worker.stats["rto_expired"] == 0, (worker.stats, worker.expired)
        assert worker.stats["retries"] == 0, (worker.stats, worker.expired)
        assert server.recv(timeout=0.3) is None
        assert server.stats["dup_dropped"] == 0, server.stats
    finally:
        for t in (worker, server):
            t.detach()


class _RaisingFirstHandOff(_SlowFirstHandOff):
    """An inner transport whose first ``ReliableFrame`` hand-off raises an
    error that is not a connection error, delivering nothing."""

    def sendv(self, code, parts, dst=0):
        if code == tmsg.MessageCode.ReliableFrame and self.slow_left:
            self.slow_left -= 1
            raise RuntimeError("scripted hand-off failure")
        super().sendv(code, parts, dst=dst)


def test_a_hand_off_that_raises_leaves_the_frame_to_the_retry_thread():
    """A push whose hand-off raises ``RuntimeError``: the error reaches the
    caller, and the frame, pending but never sent, is the retry thread's:
    it times out, is sent again and acked, and ``flush`` returns. Were the
    frame left marked as still leaving, the retry thread would skip it for
    good and ``flush`` would wait out its timeout."""
    MessageCode = tmsg.MessageCode
    world = tmsg.InProcessTransport.create_world(2)
    server = tmsg.ReliableTransport(world[0], ack_timeout=0.05)
    worker = tmsg.ReliableTransport(_RaisingFirstHandOff(world[1], 0.0), ack_timeout=0.05)
    try:
        with pytest.raises(RuntimeError, match="scripted hand-off failure"):
            worker.send(MessageCode.GradientUpdate, np.full(3, 2.0, np.float32))
        msg = server.recv(timeout=3)
        assert msg is not None and float(msg[2][0]) == 2.0, worker.stats
        assert worker.flush(timeout=3), worker.stats
        assert worker.stats["retries"] == 1, (worker.stats, worker.expired)
        assert worker.stats["rto_expired"] == 1, (worker.stats, worker.expired)
    finally:
        for t in (worker, server):
            t.detach()


def test_the_least_ack_slack_is_the_margin_under_the_timeout():
    """Four pushes to a durable receiver that applies one every 0.1 s under
    a 0.5 s timeout floor: no timeout fires, and ``min_ack_slack`` is the
    least time a push had left, under the floor by at least the 0.1 s its
    ack took at the least."""
    MessageCode = tmsg.MessageCode
    world = tmsg.InProcessTransport.create_world(2)
    server = tmsg.ReliableTransport(world[0], ack_on_delivery=False, ack_timeout=0.5)
    worker = tmsg.ReliableTransport(world[1], ack_timeout=0.5)
    try:
        assert worker.min_ack_slack is None
        for v in range(4):
            worker.send(MessageCode.GradientUpdate, np.full(3, v, np.float32))
        for _ in range(4):
            assert server.recv(timeout=3) is not None, worker.stats
            time.sleep(0.1)
            server.ack_delivered()
        assert worker.flush(timeout=3), worker.stats
        assert worker.stats["rto_expired"] == 0, worker.stats
        assert 0.0 < worker.min_ack_slack <= 0.5 - 0.1
    finally:
        for t in (worker, server):
            t.detach()


def test_a_receiver_behind_a_full_park_still_takes_in_its_acks():
    """A server whose application lags (it is applying pushes) holds
    PARK_MAX frames taken in for it, and more wait behind them; an ack of
    a frame it sent arrives after those. Its retry tick must still take
    the ack in: its own frame is acked within the tick, not after the
    application has worked through the backlog (before the repair the
    tick stopped reading at a full park, and the frame timed out). The
    frames past the park stay unacked, so the sender's window still
    closes, and are handed out later, in order."""
    MessageCode = tmsg.MessageCode
    world = tmsg.InProcessTransport.create_world(2)
    server = tmsg.ReliableTransport(world[0], ack_timeout=0.5, batched_acks=False)
    worker = tmsg.ReliableTransport(world[1], ack_timeout=5.0, batched_acks=False)
    n = tmsg.PARK_MAX + 4
    try:
        for v in range(n):
            worker.send(MessageCode.ParameterRequest, np.full(1, v, np.float32))
        deadline = time.monotonic() + 3
        while len(server._requeue) < tmsg.PARK_MAX and time.monotonic() < deadline:
            time.sleep(0.01)
        server.send(MessageCode.ParameterUpdate, np.ones(4, np.float32), dst=1)
        assert worker.recv(timeout=2)[1] == MessageCode.ParameterUpdate
        deadline = time.monotonic() + 0.4
        while server.pending_depth(1) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.pending_depth(1) == 0, "the ack waited behind the full park"
        assert server.stats["rto_expired"] == 0 and server.stats["retries"] == 0
        assert worker.pending_depth(0) == n - tmsg.PARK_MAX  # past the park: unacked
        got = [float(server.recv(timeout=1)[2][0]) for _ in range(n)]
        assert got == [float(v) for v in range(n)]
        assert worker.flush(timeout=3), worker.stats
        assert server.stats["dup_dropped"] == 0
    finally:
        for t in (worker, server):
            t.detach()



#: a lagging durable server (the card's int8 + Adasum server took 75-110 ms
#: a push): the apply's time, and each worker's offered pushes a second and
#: count, scaled up together until the fault showed on an 8-core host
LAG_APPLY_S = 0.15
LAG_PUSHES_PER_S = 30
LAG_PUSHES = 12


def test_a_lagging_durable_server_narrows_its_senders_windows(tmp_path):
    """Two workers offer more pushes than a durable server applies (each
    apply 0.15 s, each worker 30 pushes a second, after a pull) on a
    loss-free in-process wire with the 1 s timeout floor. Before the
    repair the server's WAL group filled to 8 pushes behind the lagging
    apply, 1.2 s, and its acks came past the floor: the workers
    retransmitted and the server dropped duplicates. Now the credit the
    server advertises is what it applies within a quarter of the floor,
    sent as soon as it binds, and a held ack that has waited that long closes
    the group: every push is acked once, on its first copy, the longest
    within the floor, and each is applied once."""
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer

    MessageCode = tmsg.MessageCode

    class LaggingServer(ParameterServer):
        def handle(self, sender, code, payload):
            if code == MessageCode.GradientUpdate:
                time.sleep(LAG_APPLY_S)
            super().handle(sender, code, payload)

    world = tmsg.InProcessTransport.create_world(3)
    server_t = tmsg.ReliableTransport(world[0], ack_on_delivery=False)
    workers = [tmsg.ReliableTransport(world[r]) for r in (1, 2)]
    server = LaggingServer(params=np.zeros(16, np.float32), transport=server_t, n_workers=2,
                           ckpt_dir=str(tmp_path / "ps"), wal=True)
    serve = threading.Thread(target=server.run, kwargs={"timeout": 60})

    def offer(t):
        t.send(MessageCode.ParameterRequest, np.zeros(1, np.float32))
        for _ in range(LAG_PUSHES):
            t0 = time.monotonic()
            t.send(MessageCode.GradientUpdate, np.full(16, 1e-3, np.float32))
            time.sleep(max(0.0, 1.0 / LAG_PUSHES_PER_S - (time.monotonic() - t0)))
        assert t.flush(timeout=30), t.stats
        t.send(MessageCode.WorkerDone, np.zeros(1, np.float32))

    offers = [threading.Thread(target=offer, args=(t,)) for t in workers]
    try:
        serve.start()
        for th in offers:
            th.start()
        for th in offers:
            th.join(timeout=60)
        serve.join(timeout=60)
        assert not serve.is_alive()
        waits = [t.max_ack_wait for t in workers]
        assert server.applied_by_sender == {1: LAG_PUSHES, 2: LAG_PUSHES}
        assert server_t.stats["dup_dropped"] == 0, (server_t.stats, waits)
        for t in workers:
            assert t.stats["rto_expired"] == 0 and t.stats["retries"] == 0, (t.stats, waits)
            assert t.acked_count(0, MessageCode.GradientUpdate) == LAG_PUSHES
            assert t.max_ack_wait < t.ack_timeout
        # the credit bound: each worker blocked at its narrowed window, which
        # is not the full send window (the gray plane's partition witness)
        assert all(t.stats["credit_blocked"] > 0 and t.stats["window_blocked"] == 0
                   for t in workers)
    finally:
        for t in (*workers, server_t):
            t.detach()
        if server.wal is not None:
            server.wal.close()


def test_a_frame_served_slowly_narrows_the_credit_while_it_is_served():
    """After a pull it serves at once, a durable receiver's application
    takes a push and is slow with it (0.3 s, more than the quarter of the
    1 s floor that the frames queued behind it may take): while the
    application still holds it, with three more pushes waiting, the
    receiver cuts its sender's credit to nothing and sends the cut at
    once. Its only measured time a frame was the pull's: a bound that
    waited for the slow frame's end would let a sender queue its whole
    window behind it."""
    MessageCode = tmsg.MessageCode
    world = tmsg.InProcessTransport.create_world(2)
    rx = tmsg.ReliableTransport(world[0], ack_on_delivery=False)
    tx = tmsg.ReliableTransport(world[1])
    try:
        tx.send(MessageCode.ParameterRequest, np.zeros(1, np.float32), dst=0)
        for _ in range(4):
            tx.send(MessageCode.GradientUpdate, np.full(4, 1e-3, np.float32), dst=0)
        assert rx.recv(timeout=5)[1] == MessageCode.ParameterRequest  # served at once
        assert rx.recv(timeout=5)[1] == MessageCode.GradientUpdate
        deadline = time.monotonic() + 5
        while rx.stats["delivered"] < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rx.stats["delivered"] == 5, rx.stats
        time.sleep(0.3)  # the application still holds the first push
        deadline = time.monotonic() + 1
        while tx._peers[0].credit != 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert tx._peers[0].credit == 0, (tx._peers[0].credit, rx.stats)
        # only the pull is acked: every push's ack waits for the log
        assert tx.stats["acked"] == 1, tx.stats
    finally:
        for t in (tx, rx):
            t.detach()


def test_a_code_not_served_before_is_taken_one_frame_at_a_time():
    """A durable receiver's application has served a pull (its only
    measured time a frame, a few microseconds) and takes its first push,
    with a second push waiting: until that push's time is known the
    receiver's credit is nothing, however short the pull was. A bound
    from the pull's time let the card's workers queue three pushes each
    behind the first one (75-110 ms apiece) before the cut arrived."""
    MessageCode = tmsg.MessageCode
    world = tmsg.InProcessTransport.create_world(2)
    rx = tmsg.ReliableTransport(world[0], ack_on_delivery=False)
    tx = tmsg.ReliableTransport(world[1])
    try:
        tx.send(MessageCode.ParameterRequest, np.zeros(1, np.float32), dst=0)
        for _ in range(2):
            tx.send(MessageCode.GradientUpdate, np.full(4, 1e-3, np.float32), dst=0)
        deadline = time.monotonic() + 5
        while rx.stats["delivered"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rx.stats["delivered"] == 3, rx.stats
        assert rx.recv(timeout=5)[1] == MessageCode.ParameterRequest
        assert rx.recv(timeout=5)[1] == MessageCode.GradientUpdate
        with rx._lock:
            assert rx._credit_for(1) == 0
        deadline = time.monotonic() + 1
        while tx._peers[0].credit != 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert tx._peers[0].credit == 0, (tx._peers[0].credit, rx.stats)
    finally:
        for t in (tx, rx):
            t.detach()


# ------------------------------------------------- same-second incarnations

def _messaging(pkg):
    """The messaging and obs modules of ``pkg`` ("port" or "jax")."""
    if pkg == "jax":
        from distributed_ml_pytorch_tpu.utils import messaging, obs
    else:
        from distributed_ml_pytorch_tpu_torch.utils import messaging, obs
    return messaging, obs


def _fresh_life(pkg, inner, monkeypatch):
    """A rank-1 sender of ``pkg`` as a freshly started process builds it:
    the module's incarnation clock starts from zero (the port's: no
    endpoint stamped), and the thread has no correlation id."""
    mod, obs = _messaging(pkg)
    monkeypatch.setattr(mod, "_LAST_INC", 0)
    if hasattr(mod, "_STAMPED"):
        monkeypatch.setattr(mod, "_STAMPED", weakref.WeakKeyDictionary())
    obs.set_corr(0)
    return mod.ReliableTransport(inner, ack_timeout=0.05)


#: what each life sends: a deterministic restart repeats the first life's
#: install and pull, frame for frame, before its first push
LIFE_FRAMES = {
    "distinct": ([(tmsg.MessageCode.GradientUpdate, 1.0)],
                 [(tmsg.MessageCode.GradientUpdate, 2.0),
                  (tmsg.MessageCode.GradientUpdate, 3.0)]),
    "same_prefix": ([(tmsg.MessageCode.ParameterUpdate, 5.0),
                     (tmsg.MessageCode.ParameterRequest, None)],
                    [(tmsg.MessageCode.ParameterUpdate, 5.0),
                     (tmsg.MessageCode.ParameterRequest, None),
                     (tmsg.MessageCode.GradientUpdate, 2.0)]),
}


def _send_and_recv(sender, receiver, code, value):
    """``(code, first value)`` of what ``receiver`` delivers after ``sender``
    sends ``code`` (a 3-float body of ``value``, or an empty one)."""
    body = np.zeros(0, np.float32) if value is None else np.full(3, value, np.float32)
    sender.send(code, body, dst=0)
    deadline = time.monotonic() + 3
    while time.monotonic() < deadline:
        msg = receiver.recv(timeout=0.1)
        if msg is not None:
            return int(msg[1]), (float(msg[2][0]) if msg[2].size else None)
    return None


def _two_lives(receiver_pkg, first, second, step_s, frames, monkeypatch):
    """A receiver of ``receiver_pkg`` on rank 0 and two lives of rank 1 over
    one in-process world (the JAX mailbox carries the port's frames too),
    the wall clock frozen mid-second and moved ``step_s`` between the
    lives, each life sending its ``LIFE_FRAMES[frames]``. Returns the
    receiver, the lives, what each life sent and what the receiver
    delivered."""
    world = tmsg.InProcessTransport.create_world(2)
    rx = _messaging(receiver_pkg)[0].ReliableTransport(world[0], ack_timeout=0.05)
    _messaging(receiver_pkg)[1].set_corr(0)
    now = [float(int(time.time())) + 0.5]
    monkeypatch.setattr(time, "time", lambda: now[0])
    lives, sent, got = [], [], []
    try:
        for pkg, life_frames in zip((first, second), LIFE_FRAMES[frames]):
            if lives:
                lives[-1].detach()
                now[0] += step_s
            lives.append(_fresh_life(pkg, world[1], monkeypatch))
            for code, value in life_frames:
                sent.append((int(code), value))
                got.append(_send_and_recv(lives[-1], rx, code, value))
            assert lives[-1].flush(timeout=3), lives[-1].stats
        return rx, lives, sent, got
    finally:
        for t in lives + [rx]:
            t.detach()


@pytest.mark.parametrize("frames", sorted(LIFE_FRAMES))
@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "port"),
                                          ("port", "jax")])
def test_a_second_life_in_the_same_second_is_delivered(first, second, frames, monkeypatch):
    """Two lives of rank 1, the second begun in the same wall-clock second
    as the first with a fresh incarnation clock, so both stamp the same
    incarnation: the port's receiver delivers every frame of the second
    life, also when its first frames repeat the first life's (a
    deterministic restart: the same install, then an empty pull), since a
    port life's first frame carries its own nonce."""
    rx, lives, sent, got = _two_lives("port", first, second, 0.0, frames, monkeypatch)
    assert lives[0].incarnation == lives[1].incarnation
    assert got == sent, "a frame of the new life was dropped"
    assert rx.stats["delivered"] == len(sent)


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_a_jax_receiver_takes_a_later_second_as_newer(first, second, monkeypatch):
    """A JAX receiver (whose own same-second fault stays, ROADMAP Queue C)
    delivers a life begun a second after the previous one, whichever
    package each life runs: a port life never stamps ahead of its wall
    second."""
    _rx, lives, sent, got = _two_lives("jax", first, second, 1.0, "same_prefix",
                                       monkeypatch)
    assert lives[1].incarnation == lives[0].incarnation + 1
    assert got == sent


def _main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("role", choices=("server", "worker"))
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--wal", default=None, metavar="DIR")
    a = p.parse_args(argv)
    if a.role == "server":
        _run_server(a.port, a.wal)
    else:
        _run_worker(a.rank, a.port)


if __name__ == "__main__":
    _main()


def _kind(kind):
    """The transport kind of a rendezvous test; the native library builds
    with g++ on first use."""
    if kind == "native" and shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build the native transport")
    if kind == "native":
        from distributed_ml_pytorch_tpu_torch import native

        assert native.native_available(), native.native_load_error()
    return kind


def _open_server(*args, **kw):
    """``make_transport`` of a reliable rank 0, which must return once it
    listens, long before any worker connects (built on a thread, so that a
    constructor that waits for its workers fails the test instead of
    hanging it)."""
    out = {}

    def build():
        try:
            out["t"] = tmsg.make_transport(*args, **kw)
        except BaseException as e:  # noqa: BLE001 — reported below
            out["e"] = e

    th = threading.Thread(target=build, daemon=True)
    th.start()
    th.join(timeout=5)
    assert not th.is_alive(), "the server's constructor waited for its workers"
    if "e" in out:
        raise out["e"]
    return out["t"]


@pytest.mark.parametrize("kind", ["python", "native"])
def test_a_server_serves_the_first_worker_while_the_second_connects(tmp_path, kind):
    """A durable reliable server, Python or native, acks a worker's push
    (after its log's fsync) while the world's second worker has not
    connected; the rendezvous ends when it does."""
    from distributed_ml_pytorch_tpu_torch.launch import _free_port
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer

    kind = _kind(kind)
    port = int(_free_port())
    server = ParameterServer(params=np.zeros(8, np.float32), n_workers=2,
                             ckpt_dir=str(tmp_path / "ps"), wal=True)
    server.transport = _open_server(0, 3, "localhost", port, kind=kind, reliable=True,
                                    durable_acks=True)
    assert not server.transport.rendezvous_done()
    th = threading.Thread(target=server.run, kwargs={"timeout": 30}, daemon=True)
    th.start()
    workers = []
    try:
        workers.append(tmsg.make_transport(1, 3, "localhost", port, kind="python",
                                           reliable=True))
        t0 = time.monotonic()
        workers[0].send(tmsg.MessageCode.GradientUpdate, np.ones(8, np.float32))
        assert workers[0].flush(timeout=3), workers[0].stats
        assert time.monotonic() - t0 < 1.0 and workers[0].stats["rto_expired"] == 0
        assert server._apply_seq == 1 and not server.transport.rendezvous_done()
        workers.append(tmsg.make_transport(2, 3, "localhost", port, kind="python",
                                           reliable=True))
        deadline = time.monotonic() + 5
        while not server.transport.rendezvous_done() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.transport.rendezvous_done()
        for w in workers:
            w.send(tmsg.MessageCode.WorkerDone, np.zeros(0, np.float32))
            assert w.flush(timeout=3)
        th.join(timeout=10)
        assert not th.is_alive()
    finally:
        for w in workers:
            w.close()
        server.transport.close()


@pytest.mark.parametrize("kind", ["python", "native"])
def test_an_open_rendezvous_still_raises_past_its_deadline(kind):
    from distributed_ml_pytorch_tpu_torch.launch import _free_port
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer

    kind = _kind(kind)
    port = int(_free_port())
    t = _open_server(0, 2, "localhost", port, kind=kind, reliable=True, connect_timeout=0.3)
    server = ParameterServer(params=np.zeros(4, np.float32), n_workers=1, transport=t)
    try:
        with pytest.raises(TimeoutError, match="did not connect"):
            server.run(timeout=10)
    finally:
        t.close()
