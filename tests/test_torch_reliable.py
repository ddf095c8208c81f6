"""The port's ``ReliableTransport`` against the JAX package's.

- ``_frame_crc`` equals the JAX function over
  random bodies of 0 to 200 KiB (both sides of ``_BULK_SUM_BYTES``, odd
  tails), as bytes, memoryviews and float32 arrays: exact;
- an envelope packed by one package is delivered by the other, in both
  directions, its correlation id restored on the receiving thread, and its
  ack clears the sender;
- the JAX messaging tests of the reliable layer, on the port: round trip
  and dedup, a restarted peer not blackholed, a stale incarnation's ack,
  deferred acks, ``seed_dedup`` across a receiver restart;
- the window, credit, circuit-breaker, flapping-peer and partition-heal
  tests of the JAX ``tests/test_netweather.py``, with :class:`Lossy` (a
  seeded drop/dup/corrupt/black-hole layer defined here) in place of the
  chaos layer;
- the worker's degrade-to-local path catches an open breaker, and the
  server's reply survives a retransmit after the central vector moved;
- cross-package worlds through :class:`Lossy`: a port worker against a JAX
  server and a JAX worker against a port server, both servers with a WAL
  and durable acks: every push applied exactly once, the central vector
  bit for bit the worker's install plus the pushes in the order applied,
  and acked pushes = applied pushes = sent pushes.
"""

import collections
import json
import os
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models import get_model as jget_model
from distributed_ml_pytorch_tpu.parallel import async_ps as jps
from distributed_ml_pytorch_tpu.training.trainer import cross_entropy_loss as jce
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu.utils import obs as jobs
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils import obs as tobs
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    InProcessTransport,
    MessageCode,
    ReliableTransport,
)

PKG = {"port": (tmsg, tobs), "jax": (jmsg, jobs)}
FRAME = int(MessageCode.ReliableFrame)
ACKS = {int(MessageCode.ReliableAck), int(MessageCode.CumAck)}


class Lossy(tmsg.Transport):
    """A seeded fault layer under a reliable transport of either package.

    Each frame it sends whose code is in ``codes`` (every code when
    ``None``) takes one verdict: the first ``script`` frames take theirs
    from the list, later ones are drawn from ``default_rng(seed)`` — dropped
    with probability ``drop``, corrupted (one bit of one body word flipped)
    with ``corrupt``, sent twice with ``dup``. :meth:`crash` makes the
    endpoint a black hole (its sends and arrivals vanish) until
    :meth:`restart`. ``counts`` tallies the verdicts."""

    def __init__(self, inner, seed=0, *, drop=0.0, dup=0.0, corrupt=0.0, codes=None,
                 script=()):
        self.inner = inner
        self.rank = inner.rank
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.drop, self.dup, self.corrupt = drop, dup, corrupt
        self.codes = None if codes is None else {int(c) for c in codes}
        self._script = list(script)
        self._down = False
        self.counts = collections.Counter()

    def _verdict(self):
        with self._lock:
            if self._script:
                return self._script.pop(0)
            u = self._rng.random()
            if u < self.drop:
                return "drop"
            if u < self.drop + self.corrupt:
                return "corrupt"
            if u < self.drop + self.corrupt + self.dup:
                return "dup"
            return "pass"

    def send(self, code, payload, dst=0):
        if self._down:
            self.counts["blackholed"] += 1
            return
        if self.codes is None or int(code) in self.codes:
            verdict = self._verdict()
            self.counts[verdict] += 1
            if verdict == "drop":
                return
            if verdict == "corrupt" and np.size(payload) > 9:
                payload = np.array(payload, np.float32, copy=True)
                with self._lock:
                    i = int(self._rng.integers(9, payload.size))
                    bit = int(self._rng.integers(0, 23))
                payload.view(np.uint32)[i] ^= np.uint32(1 << bit)
            elif verdict == "dup":
                self.inner.send(code, payload, dst=dst)
        self.inner.send(code, payload, dst=dst)

    def sendv(self, code, parts, dst=0):
        self.send(code, np.concatenate([np.asarray(p, np.float32).ravel() for p in parts]),
                  dst=dst)

    def recv(self, timeout=None):
        msg = self.inner.recv(timeout=timeout)
        return None if self._down else msg

    def crash(self):
        self._down = True

    def restart(self):
        self._down = False

    def close(self):
        self.inner.close()


def _drain(t, n, timeout=10.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        m = t.recv(timeout=0.2)
        if m is not None:
            got.append(m)
    return got


def _close(*ts):
    for t in ts:
        t.close()


# --------------------------------------------------------------- the checksum

CRC_SIZES = [0, 1, 3, 4, 7, 8, 100, 1023, 65528, 65532, 65535, 65536, 65537, 65540,
             65543, 100_003, 200 * 1024]


@pytest.mark.parametrize("nbytes", CRC_SIZES)
def test_frame_crc_equals_jax(nbytes):
    rng = np.random.default_rng(nbytes)
    body = rng.integers(0, 256, size=nbytes, dtype=np.uint8).tobytes()
    inc, seq, code, corr = (int(v) for v in rng.integers(0, 2**32, size=4))
    bodies = [body, memoryview(body)]
    if nbytes % 4 == 0:
        bodies.append(np.frombuffer(body, np.float32))
    for b in bodies:
        assert tmsg._frame_crc(inc, seq, code, b, corr) == jmsg._frame_crc(
            inc, seq, code, b, corr)
    # every header field and one body bit are covered
    base = tmsg._frame_crc(inc, seq, code, body, corr)
    assert base != tmsg._frame_crc(inc ^ 1, seq, code, body, corr)
    assert base != tmsg._frame_crc(inc, seq, code, body, corr ^ 1)
    if nbytes:
        flipped = bytearray(body)
        flipped[nbytes // 2] ^= 4
        assert base != tmsg._frame_crc(inc, seq, code, bytes(flipped), corr)


@pytest.mark.parametrize("sender_pkg,receiver_pkg", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("n", [5, 40_000], ids=["crc32", "bulk"])
def test_envelopes_pass_between_the_packages(sender_pkg, receiver_pkg, n):
    """Two packages' transports on one mailbox dict: the receiver delivers
    the sender's envelope, restores its correlation id on the receiving
    thread, and its ack clears the sender's pending frame."""
    (smod, sobs), (rmod, robs) = PKG[sender_pkg], PKG[receiver_pkg]
    boxes = {r: queue.Queue() for r in (0, 1)}
    rx = rmod.ReliableTransport(rmod.InProcessTransport(0, boxes), ack_timeout=0.05)
    tx = smod.ReliableTransport(smod.InProcessTransport(1, boxes), ack_timeout=0.05)
    try:
        payload = np.random.default_rng(n).normal(size=n).astype(np.float32)
        sobs.set_corr(0xBEEF1234)
        tx.send(MessageCode.GradientUpdate, payload, dst=0)
        sobs.set_corr(0)
        msg = rx.recv(timeout=5)
        assert msg is not None and (msg[0], int(msg[1])) == (1, 2)
        np.testing.assert_array_equal(msg[2], payload)
        assert robs.current_corr() == 0xBEEF1234
        assert rx.last_delivery == (tx.incarnation, 0)
        assert tx.flush(timeout=5), tx.stats
        assert tx.acked_count(0, MessageCode.GradientUpdate) == 1
        assert rx.stats["crc_dropped"] == 0 and rx.stats["delivered"] == 1
    finally:
        _close(rx, tx)


# ------------------------------------------- the JAX messaging tests, on the port

def test_reliable_round_trip_and_dedup():
    world = InProcessTransport.create_world(2)
    a = ReliableTransport(world[0], ack_timeout=0.05)
    b = ReliableTransport(world[1], ack_timeout=0.05)
    try:
        b.send(MessageCode.GradientUpdate, np.arange(4, dtype=np.float32))
        msg = a.recv(timeout=5)
        assert msg is not None and msg[1] == MessageCode.GradientUpdate
        np.testing.assert_array_equal(msg[2], np.arange(4, dtype=np.float32))
        assert b.flush(timeout=5) and b.stats["acked"] == 1
        # the same envelope again, byte-correct: only dedup can drop it
        body = np.arange(4, dtype=np.float32)
        crc = tmsg._frame_crc(b.incarnation, 0, int(MessageCode.GradientUpdate),
                              body.tobytes())
        b.inner.send(MessageCode.ReliableFrame, np.concatenate([
            np.asarray([*tmsg._split16(b.incarnation), *tmsg._split16(0),
                        *tmsg._split16(crc), float(int(MessageCode.GradientUpdate)),
                        *tmsg._split16(0)], np.float32), body]))
        assert a.recv(timeout=0.3) is None
        assert a.stats["dup_dropped"] == 1
    finally:
        _close(a, b)


def test_reliable_restarted_peer_not_blackholed_and_dead_peer_heals():
    world = InProcessTransport.create_world(2)
    server = ReliableTransport(world[0], ack_timeout=0.02, max_backoff=0.05, max_retries=2)
    life1 = ReliableTransport(world[1], ack_timeout=0.05)
    life1.send(MessageCode.GradientUpdate, np.full(2, 1.0, np.float32))
    msg = server.recv(timeout=5)
    assert msg is not None and int(msg[2][0]) == 1
    life1.detach()  # rank 1 dies: its acks stop
    server.send(MessageCode.ParameterUpdate, np.ones(1, np.float32), dst=1)
    deadline = time.monotonic() + 5
    while not server.stats["gave_up"] and time.monotonic() < deadline:
        time.sleep(0.02)
    assert server.stats["gave_up"] == 1
    assert server.breaker_state(1) == "dead"
    with pytest.raises(ConnectionError):
        server.send(MessageCode.ParameterUpdate, np.ones(1, np.float32), dst=1)
    life2 = ReliableTransport(world[1], ack_timeout=0.05)
    assert life2.incarnation > life1.incarnation
    life2.send(MessageCode.GradientUpdate, np.full(2, 2.0, np.float32))
    msg = server.recv(timeout=5)
    assert msg is not None and int(msg[2][0]) == 2, "restarted peer blackholed"
    server.send(MessageCode.ParameterUpdate, np.ones(1, np.float32), dst=1)
    msg = life2.recv(timeout=5)
    assert msg is not None and msg[1] == MessageCode.ParameterUpdate
    _close(server, life2)


def test_unbatched_acks_are_individual():
    """With ``batched_acks=False`` every delivery gets its own
    ``ReliableAck`` and no ``CumAck`` is sent."""
    world = InProcessTransport.create_world(2)
    a = ReliableTransport(world[0], ack_timeout=0.05, batched_acks=False)
    b = ReliableTransport(world[1], ack_timeout=0.05)
    try:
        for i in range(3):
            b.send(MessageCode.GradientUpdate, np.full(2, i, np.float32))
        assert len(_drain(a, 3)) == 3
        assert b.flush(timeout=5)
        assert a.stats["acks_tx"] == 3 and a.stats["cum_acks_tx"] == 0
        assert b.stats["acked"] == 3 and b.stats["cum_acked"] == 0
    finally:
        _close(a, b)


def test_reliable_stale_incarnation_ack_does_not_clear_pending():
    world = InProcessTransport.create_world(2)
    b = ReliableTransport(world[1], ack_timeout=0.05)
    try:
        b.send(MessageCode.GradientUpdate, np.ones(2, np.float32), dst=0)
        world[0].send(MessageCode.ReliableAck, np.asarray(
            [*tmsg._split16(0), *tmsg._split16(b.incarnation - 1)], np.float32), dst=1)
        assert not b.flush(timeout=0.4)
        assert b.stats["acked"] == 0
        world[0].send(MessageCode.ReliableAck, np.asarray(
            [*tmsg._split16(0), *tmsg._split16(b.incarnation)], np.float32), dst=1)
        assert b.flush(timeout=2)
        assert b.stats["acked"] == 1
    finally:
        _close(b, *world.values())


def test_deferred_ack_withheld_until_ack_delivered():
    world = InProcessTransport.create_world(2)
    a = ReliableTransport(world[0], ack_timeout=0.05, ack_on_delivery=False)
    b = ReliableTransport(world[1], ack_timeout=0.05)
    try:
        b.send(MessageCode.GradientUpdate, np.ones(2, np.float32), dst=0)
        msg = a.recv(timeout=2)
        assert msg is not None and msg[1] == MessageCode.GradientUpdate
        assert a.last_delivery is not None
        assert a.recv(timeout=0.3) is None  # the retry lands as a dup, not re-acked
        assert a.stats["dup_dropped"] >= 1
        assert b.pending_depth(0) == 1
        a.ack_delivered()
        assert b.flush(timeout=5), b.stats
        assert b.acked_count(0, MessageCode.GradientUpdate) == 1
    finally:
        _close(a, b, *world.values())


def test_seed_dedup_survives_receiver_restart():
    world = InProcessTransport.create_world(2)
    a = ReliableTransport(world[0], ack_timeout=0.05, ack_on_delivery=False)
    b = ReliableTransport(world[1], ack_timeout=0.05)
    a2 = None
    try:
        b.send(MessageCode.GradientUpdate, np.ones(2, np.float32), dst=0)
        assert a.recv(timeout=2) is not None
        inc, seq = a.last_delivery
        a.detach()  # the crash: applied and logged, the ack never released
        a2 = ReliableTransport(world[0], ack_timeout=0.05)
        a2.seed_dedup([(1, inc, seq)])
        # b retransmits every ~0.1 s: a second of a2's receiving sees retries
        for _ in range(10):
            assert a2.recv(timeout=0.1) is None, "the retry was delivered again"
        assert a2.stats["dup_dropped"] >= 1
        assert b.flush(timeout=5), b.stats
        assert b.acked_count(0, MessageCode.GradientUpdate) == 1
    finally:
        _close(*(t for t in (a2, b) if t is not None), *world.values())


# ----------------------------------------- the JAX netweather units, on the port

def test_send_window_bounds_pending_against_a_silent_receiver():
    world = InProcessTransport.create_world(2)
    a = ReliableTransport(world[0], ack_timeout=0.2)
    b = ReliableTransport(world[1], ack_timeout=0.2, send_window=4)
    n, sent, peak = 20, [], [0]

    def tx():
        for i in range(n):
            b.send(MessageCode.GradientUpdate, np.full(2, i, np.float32))
            peak[0] = max(peak[0], b.pending_depth(0))
            sent.append(i)

    t = threading.Thread(target=tx)
    t.start()
    time.sleep(0.5)
    assert len(sent) < n
    assert b.pending_depth(0) <= 4
    assert b.pressure() == 1.0
    assert b.stats["window_blocked"] >= 1
    got = _drain(a, n, timeout=20)
    t.join(timeout=20)
    assert not t.is_alive() and len(sent) == n
    assert len(got) == n
    assert peak[0] <= 4
    assert b.stats["window_blocked_s"] > 0.0
    _close(a, b)


def test_many_sending_threads_keep_the_window_and_exactly_once():
    """16 threads send through one transport with a window of 3 under a
    short switch interval: pending never exceeds the window (the slot is
    reserved inside the check), and every frame is delivered once and
    acked once."""
    import sys

    world = InProcessTransport.create_world(2)
    a = ReliableTransport(world[0], ack_timeout=0.05)
    b = ReliableTransport(world[1], ack_timeout=0.05, send_window=3)
    n_threads, per = 16, 12
    peak, errors = [0], []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def tx(k):
            try:
                for i in range(per):
                    b.send(MessageCode.GradientUpdate, np.asarray([k, i], np.float32))
                    peak[0] = max(peak[0], b.pending_depth(0))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=tx, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        got = _drain(a, n_threads * per, timeout=30)
        for t in threads:
            t.join(timeout=30)
        assert not errors and not any(t.is_alive() for t in threads)
        assert b.flush(timeout=10)
    finally:
        sys.setswitchinterval(prev)
        _close(a, b)
    keys = sorted((int(m[2][0]), int(m[2][1])) for m in got)
    assert keys == [(k, i) for k in range(n_threads) for i in range(per)]
    assert peak[0] <= 3
    assert b.stats["sent"] == b.stats["acked"] == n_threads * per


def test_advertised_credit_narrows_the_senders_window():
    world = InProcessTransport.create_world(2)
    a = ReliableTransport(world[0], ack_timeout=0.2)
    b = ReliableTransport(world[1], ack_timeout=0.2, send_window=16)
    b.send(MessageCode.GradientUpdate, np.ones(2, np.float32))
    assert a.recv(timeout=5) is not None
    assert b.flush(timeout=5)
    a.advertise_credit(2)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        b.recv(timeout=0.05)  # pump: the credit rides a CumAck frame
        with b._lock:
            st = b._peers.get(0)
            if st is not None and st.credit == 2:
                break
    with b._lock:
        assert b._peers[0].credit == 2
    peak = [0]

    def tx():
        for i in range(12):
            b.send(MessageCode.GradientUpdate, np.full(2, i, np.float32))
            peak[0] = max(peak[0], b.pending_depth(0))

    t = threading.Thread(target=tx)
    t.start()
    _drain(a, 12, timeout=20)
    t.join(timeout=20)
    assert not t.is_alive()
    assert peak[0] <= 2, f"credit 2 ignored: peak pending {peak[0]}"
    _close(a, b)


def test_breaker_opens_fails_fast_probes_and_recovers():
    world = InProcessTransport.create_world(2)
    b = ReliableTransport(world[1], ack_timeout=0.02, max_backoff=0.1, max_retries=200,
                          breaker_fails=3, breaker_grace=0.05, breaker_cooldown=0.1)
    b.send(MessageCode.GradientUpdate, np.ones(2, np.float32))
    deadline = time.monotonic() + 10
    while b.breaker_state(0) != "open" and time.monotonic() < deadline:
        time.sleep(0.02)
    assert b.breaker_state(0) == "open"
    assert b.stats["breaker_opens"] >= 1 and b.open_breakers() == 1
    with pytest.raises(ConnectionError):
        b.send(MessageCode.GradientUpdate, np.ones(2, np.float32))
    while world[0].recv(timeout=0.3) is not None:
        pass
    a = ReliableTransport(world[0], ack_timeout=0.05)
    got = _drain(a, 1, timeout=10)
    assert got and got[0][1] == MessageCode.GradientUpdate
    deadline = time.monotonic() + 10
    while b.breaker_state(0) != "closed" and time.monotonic() < deadline:
        b.flush(timeout=0.2)
    assert b.breaker_state(0) == "closed"
    assert b.stats["probes"] >= 1
    assert b.open_breakers() == 0
    b.send(MessageCode.GradientUpdate, np.full(2, 7.0, np.float32))
    got = _drain(a, 1, timeout=10)
    assert got and int(got[0][2][0]) == 7
    _close(a, b)


def test_flapping_peer_cannot_grow_pending_without_bound():
    world = InProcessTransport.create_world(2)
    fw = {r: Lossy(t) for r, t in world.items()}
    b = ReliableTransport(fw[1], ack_timeout=0.02, max_backoff=0.05, max_retries=3,
                          send_window=6)
    a = ReliableTransport(fw[0], ack_timeout=0.05)
    stop = threading.Event()
    peak = [0]

    def flapper():
        while not stop.is_set():
            fw[0].crash()
            time.sleep(0.05)
            fw[0].restart()
            time.sleep(0.05)

    def rx():
        while not stop.is_set():
            a.recv(timeout=0.1)

    threads = [threading.Thread(target=flapper), threading.Thread(target=rx)]
    for t in threads:
        t.start()
    sent = 0
    t_end = time.monotonic() + 2.0
    while time.monotonic() < t_end:
        try:
            b.send(MessageCode.GradientUpdate, np.ones(2, np.float32))
            sent += 1
        except ConnectionError:
            time.sleep(0.01)  # the breaker's or the death's fail-fast
        peak[0] = max(peak[0], b.pending_depth(0))
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert sent > 0 and fw[0].counts["blackholed"] > 0
    assert peak[0] <= 6, f"pending grew to {peak[0]} under the flap (window 6)"
    _close(a, b)


def test_partition_heal_drains_pending_via_one_cumulative_ack():
    """The first n data frames are dropped (a one-way partition that heals):
    one retransmission each delivers them, and the receiver acks them with
    cumulative acks only."""
    n = 10
    world = InProcessTransport.create_world(2)
    lossy = Lossy(world[1], codes={FRAME}, script=["drop"] * n)
    a = ReliableTransport(world[0], ack_timeout=0.3, max_backoff=2.0)
    b = ReliableTransport(lossy, ack_timeout=0.3, max_backoff=2.0)
    stop = threading.Event()

    def rx():
        while not stop.is_set():
            a.recv(timeout=0.1)

    t = threading.Thread(target=rx)
    t.start()
    for i in range(n):
        b.send(MessageCode.GradientUpdate, np.full(2, i, np.float32))
    ok = b.flush(timeout=20)
    stop.set()
    t.join(timeout=5)
    try:
        assert ok, b.stats
        assert b.stats["acked"] == n
        assert lossy.counts["drop"] == n
        assert b.stats["retries"] <= n + 1, b.stats
        assert a.stats["acks_tx"] == 0, a.stats
        assert a.stats["cum_acks_tx"] <= 3, a.stats
    finally:
        _close(a, b)


# --------------------------------------------------------- the DownPour endpoints

def test_worker_degrades_to_local_sgd_when_the_breaker_opens():
    """Nobody serves rank 0: the worker's frames go unacked, the breaker
    opens, the next send raises ``ConnectionError``, and ``_send`` turns it
    into purely-local SGD; ``finish`` then skips the flush and returns. The
    heartbeat, whose own frames skip the envelope and still leave, reads
    the open breaker as the server down."""
    from distributed_ml_pytorch_tpu_torch.utils.failure import HeartbeatSender

    world = InProcessTransport.create_world(2)
    t = ReliableTransport(world[1], ack_timeout=0.02, max_backoff=0.05, max_retries=200,
                          breaker_fails=2, breaker_grace=0.05)
    heartbeat = HeartbeatSender(t, interval=0.02)
    model = get_model("lenet", seed=0, device="cpu")
    opt = tps.Asynchronous(model, lr=0.1, n_push=1, n_pull=1, transport=t,
                           heartbeat=heartbeat)
    heartbeat.start()
    deadline = time.monotonic() + 10
    while not heartbeat.peer_down and time.monotonic() < deadline:
        time.sleep(0.02)
    assert t.breaker_state(0) == "open" and heartbeat.peer_down
    opt.heartbeat = None  # the send itself must raise, not the heartbeat's view
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    opt._flusher.drain()
    assert opt.server_down
    heartbeat.stop()
    t0 = time.monotonic()
    opt.finish()
    assert time.monotonic() - t0 < 5
    t.detach()


def test_server_reply_survives_a_retransmit_after_the_vector_moved():
    """The server's first reply is dropped; a push then moves the central
    vector in place; the retransmitted reply still passes its checksum and
    carries the vector as it was when the worker asked."""
    world = InProcessTransport.create_world(2)
    central = np.linspace(-1, 1, 1000).astype(np.float32)
    server_t = ReliableTransport(Lossy(world[0], codes={FRAME}, script=["drop"]),
                                 ack_timeout=0.05)
    worker_t = ReliableTransport(world[1], ack_timeout=0.05)
    server = tps.ParameterServer(params=central, transport=server_t)
    try:
        server.handle(1, MessageCode.ParameterRequest, np.zeros(0, np.float32))
        server.handle(1, MessageCode.GradientUpdate, np.ones(1000, np.float32))
        msg = worker_t.recv(timeout=5)
        assert msg is not None and msg[1] == MessageCode.ParameterUpdate
        np.testing.assert_array_equal(msg[2], central)
        np.testing.assert_array_equal(server.central, central + 1)
        assert worker_t.stats["crc_dropped"] == 0
        assert server_t.flush(timeout=5)
    finally:
        _close(server_t, worker_t)


# ------------------------------------------------------------ cross-package worlds

def _port_worker(transport, steps):
    model = get_model("lenet", seed=3, device="cpu")
    opt = tps.Asynchronous(model, lr=0.05, n_push=1, n_pull=2, transport=transport)
    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        x = torch.from_numpy(rng.uniform(-1, 1, size=(8, 32, 32, 3)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, size=8))
        loss_and_grads(model, x, y, generator=gen)
        opt.step()
    opt.finish()


def _jax_worker(transport, steps):
    jmodel = jget_model("lenet")
    params = jmodel.init(jax.random.key(4), jnp.zeros((1, 32, 32, 3)))["params"]

    @jax.jit
    def jgrad(p, bx, by):
        return jax.grad(lambda q: jce(jmodel.apply({"params": q}, bx), by))(p)

    opt = jps.Asynchronous(params, lr=0.05, n_push=1, n_pull=2, transport=transport)
    rng = np.random.default_rng(7)
    for _ in range(steps):
        bx = rng.uniform(-1, 1, size=(8, 32, 32, 3)).astype(np.float32)
        by = rng.integers(0, 10, size=8).astype(np.int32)
        params = opt.step(params, jgrad(params, bx, by))
    opt.finish()


def _recording(cls, pushes):
    class Recording(cls):
        def send(self, code, payload, dst=0):
            if int(code) == int(MessageCode.GradientUpdate):
                pushes.append(np.array(payload, np.float32, copy=True))
            super().send(code, payload, dst)

    return Recording


#: the worker's frames: frame 1 dropped, 2 duplicated, 3 corrupted, then
#: each drawn (drop 0.15, corrupt 0.1, dup 0.1); the server's acks: frame 1
#: dropped, then drop 0.2, dup 0.1
WORKER_FAULTS = dict(drop=0.15, corrupt=0.1, dup=0.1, codes={FRAME},
                     script=["pass", "drop", "dup", "corrupt"])
SERVER_FAULTS = dict(drop=0.2, dup=0.1, codes=ACKS, script=["drop"])


@pytest.mark.parametrize("worker_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
def test_cross_package_world_applies_each_push_exactly_once(tmp_path, worker_pkg, server_pkg):
    """One worker of one package against the other's server with a WAL and
    durable acks, every frame through :class:`Lossy`. The server's handled
    stream holds each push exactly once; its central vector is bit for bit
    the worker's install plus the pushes in the order applied; acked =
    applied = sent pushes, and the checkpoint's recent envelopes name them
    all."""
    steps = 10
    wmod, smod = PKG[worker_pkg][0], PKG[server_pkg][0]
    boxes = {r: queue.Queue() for r in (0, 1)}
    server_lossy = Lossy(smod.InProcessTransport(0, boxes), seed=11, **SERVER_FAULTS)
    server_t = smod.ReliableTransport(server_lossy, ack_on_delivery=False, ack_timeout=0.05)
    pushes = []
    worker_lossy = Lossy(wmod.InProcessTransport(1, boxes), seed=12, **WORKER_FAULTS)
    worker_t = _recording(wmod.ReliableTransport, pushes)(worker_lossy, ack_timeout=0.05)
    server_cls = jps.ParameterServer if server_pkg == "jax" else tps.ParameterServer
    n = int(sum(p.numel() for p in get_model("lenet", device="cpu").parameters()))
    server = server_cls(params=np.zeros(n, np.float32), transport=server_t, n_workers=1,
                        ckpt_dir=str(tmp_path), ckpt_every=0, wal=True)
    handled = []
    inner_handle = server.handle

    def handle(sender, code, payload):
        handled.append((int(code), np.array(payload, np.float32, copy=True)))
        inner_handle(sender, code, payload)

    server.handle = handle
    thread = threading.Thread(target=server.run, kwargs={"timeout": 60})
    thread.start()
    try:
        (_port_worker if worker_pkg == "port" else _jax_worker)(worker_t, steps)
        thread.join(timeout=60)
        assert not thread.is_alive(), "the server did not finish"
        applied = [p for c, p in handled if c == int(MessageCode.GradientUpdate)]
        assert len(pushes) == steps + 1  # a push a step and the final one
        assert sorted(p.tobytes() for p in applied) == sorted(p.tobytes() for p in pushes)
        installs = [p for c, p in handled if c == int(MessageCode.ParameterUpdate)]
        assert len(installs) == 1
        expected = installs[0].copy()
        for p in applied:
            expected += p
        np.testing.assert_array_equal(server.central, expected)
        assert server._apply_seq == len(pushes)
        assert worker_t.acked_count(0, MessageCode.GradientUpdate) == len(pushes)
        with open(os.path.join(tmp_path, "ps_meta.json")) as f:
            envelopes = json.load(f)["recent_envelopes"]
        assert len(envelopes) == len(pushes)
        assert {(s, i) for s, i, _q in envelopes} == {(1, worker_t.incarnation)}
        # the faults happened and were absorbed
        assert worker_lossy.counts["drop"] and worker_lossy.counts["dup"]
        assert worker_lossy.counts["corrupt"] and server_lossy.counts["drop"]
        assert server_t.stats["crc_dropped"] >= 1 and server_t.stats["dup_dropped"] >= 1
        assert worker_t.stats["gave_up"] == 0
    finally:
        server.stop()
        thread.join(timeout=10)
        _close(worker_t, server_t)
        if server.wal is not None:
            server.wal.close()
