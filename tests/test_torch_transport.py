"""The port's TCP transport, its ``sendv`` and its ``Backoff``, against the
JAX package's.

- a worker that dies and comes back with the same rank reconnects after the
  rendezvous: the server keeps accepting, and the new life's frames arrive
  (and the server's replies reach it); a connection that stalls its hello
  wedges neither the rendezvous nor the accept loop after it;
- ``sendv`` writes the bytes of a joined ``send``, for a small frame (one
  ``sendall``) and a bulk one (one per part), read raw off the socket and
  delivered between the two packages' transports in both directions;
- the port's ``Backoff`` gives the JAX one's delays for the same seeds over
  a hypothesis sweep, and keeps the JAX policy's properties;
- ``make_transport`` and ``make_world`` choose and wrap as the JAX ones do.

Every socket binds port 0 or a free port; tolerances are exact.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_ml_pytorch_tpu.utils import backoff as jbackoff
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.utils import backoff as tbackoff
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode, TCPTransport

MODULES = {"port": tmsg, "jax": jmsg}


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _star(port, server_mod=tmsg, worker_mod=tmsg, **server_kw):
    """A server of ``server_mod`` (rank 0, world 2) and a worker of
    ``worker_mod`` met on ``port``."""
    holder = {}
    th = threading.Thread(target=lambda: holder.setdefault(
        "t", server_mod.TCPTransport(0, 2, "localhost", port, **server_kw)))
    th.start()
    w = worker_mod.TCPTransport(1, 2, "localhost", port, connect_timeout=30)
    th.join(timeout=30)
    assert "t" in holder, "the rendezvous did not complete"
    return holder["t"], w


def test_restarted_worker_reconnects_after_the_rendezvous():
    """The repair: a worker whose transport closes and a new
    ``TCPTransport(1, 2)`` of the same rank that dials in. The server admits
    it after the rendezvous, its frame arrives within 5 s, and the server's
    reply reaches the new life."""
    server, w = _star(_free_port())
    try:
        w.send(MessageCode.Heartbeat, np.zeros(0, np.float32))
        assert server.recv(timeout=5) is not None
        w.close()
        w = TCPTransport(1, 2, "localhost", server._server_sock.getsockname()[1],
                         connect_timeout=10)
        w.send(MessageCode.GradientUpdate, np.arange(4, dtype=np.float32))
        msg = server.recv(timeout=5)
        assert msg is not None, "the restarted worker's frame never arrived"
        assert msg[0] == 1 and msg[1] == MessageCode.GradientUpdate
        np.testing.assert_array_equal(msg[2], np.arange(4, dtype=np.float32))
        server.send(MessageCode.ParameterUpdate, np.full(3, 7.0, np.float32), dst=1)
        reply = w.recv(timeout=5)
        assert reply is not None and reply[1] == MessageCode.ParameterUpdate
        assert len(server._retired) == 1
    finally:
        w.close()
        server.close()


def test_tcp_stalled_handshake_cannot_wedge_the_rendezvous():
    """A connection that sends 4 bytes of its 16-byte hello and goes silent
    is dropped after ``handshake_timeout``: the real worker behind it is
    admitted (mirrors the JAX test of the same name)."""
    port = _free_port()
    holder = {}

    def server():
        holder["t"] = TCPTransport(0, 2, "localhost", port, handshake_timeout=0.5)

    st_ = threading.Thread(target=server)
    st_.start()
    staller = None
    for _ in range(100):
        try:
            staller = socket.create_connection(("localhost", port), timeout=2)
            break
        except OSError:
            time.sleep(0.05)
    assert staller is not None
    staller.sendall(struct.pack("<i", 1))
    t0 = time.monotonic()
    w = TCPTransport(1, 2, "localhost", port, connect_timeout=30)
    st_.join(timeout=30)
    assert not st_.is_alive(), "rendezvous wedged behind a stalled handshake"
    assert time.monotonic() - t0 < 20
    t = holder["t"]
    try:
        w.send(MessageCode.GradientUpdate, np.arange(3, dtype=np.float32))
        msg = t.recv(timeout=10)
        assert msg is not None and msg[1] == MessageCode.GradientUpdate
    finally:
        staller.close()
        w.close()
        t.close()


def test_stalled_handshake_cannot_wedge_the_accept_loop():
    """After the rendezvous a stalled dial is shed the same way: a
    restarting worker behind it is still admitted."""
    server, w = _star(_free_port(), handshake_timeout=0.5)
    port = server._server_sock.getsockname()[1]
    staller = socket.create_connection(("localhost", port), timeout=2)
    try:
        staller.sendall(struct.pack("<i", 1))
        w.close()
        w = TCPTransport(1, 2, "localhost", port, connect_timeout=10)
        w.send(MessageCode.GradientUpdate, np.ones(2, np.float32))
        msg = server.recv(timeout=10)
        assert msg is not None and msg[1] == MessageCode.GradientUpdate
    finally:
        staller.close()
        w.close()
        server.close()


def _recv_raw_frame(conn):
    head = b""
    while len(head) < 16:
        head += conn.recv(16 - len(head))
    n = struct.unpack("<iiq", head)[2]
    body = b""
    while len(body) < n:
        body += conn.recv(min(1 << 20, n - len(body)))
    return head + body


@pytest.mark.parametrize("tail_len", [5, 40_000], ids=["small", "bulk"])
def test_sendv_writes_the_bytes_of_a_joined_send(tail_len):
    """Read raw off the socket: a two-part ``sendv`` frame equals the
    single-part frame of the joined payload byte for byte, below 64 KiB
    (one ``sendall``) and above (one per part)."""
    lsock = socket.socket()
    lsock.bind(("localhost", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    w = TCPTransport(1, 2, "localhost", port, connect_timeout=10)
    conn, _ = lsock.accept()
    try:
        hello = _recv_raw_frame(conn)
        assert hello == struct.pack("<iiq", 1, int(MessageCode.ParameterRequest), 0)
        head = np.asarray([1.0, 2.0, 3.0], np.float32)
        tail = np.random.default_rng(tail_len).normal(size=tail_len).astype(np.float32)
        w.sendv(MessageCode.GradientUpdate, (head, tail))
        w.send(MessageCode.GradientUpdate, np.concatenate([head, tail]))
        a, b = _recv_raw_frame(conn), _recv_raw_frame(conn)
        assert a == b
        assert len(a) == 16 + 4 * (3 + tail_len)
    finally:
        conn.close()
        lsock.close()
        w.close()


@pytest.mark.parametrize("server_pkg,worker_pkg", [("port", "port"), ("jax", "port"),
                                                   ("port", "jax")])
@pytest.mark.parametrize("tail_len", [5, 40_000], ids=["small", "bulk"])
def test_sendv_frames_pass_between_the_packages(server_pkg, worker_pkg, tail_len):
    """Each side sends a ``sendv`` frame and a joined ``send`` of the same
    parts; the other package's transport receives two equal payloads."""
    server, w = _star(_free_port(), MODULES[server_pkg], MODULES[worker_pkg])
    try:
        head = np.asarray([1.0, 2.0, 3.0], np.float32)
        tail = np.arange(tail_len, dtype=np.float32)
        joined = np.concatenate([head, tail])
        for src, dst, to in ((w, server, 0), (server, w, 1)):
            src.sendv(MessageCode.GradientUpdate, (head, tail), dst=to)
            src.send(MessageCode.GradientUpdate, joined, dst=to)
            a, b = dst.recv(timeout=10), dst.recv(timeout=10)
            assert a is not None and b is not None
            np.testing.assert_array_equal(a[2], joined)
            np.testing.assert_array_equal(b[2], joined)
    finally:
        w.close()
        server.close()


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), base=st.floats(1e-3, 1.0),
       cap=st.floats(1e-3, 10.0), factor=st.floats(1.0, 4.0),
       jitter=st.floats(0.0, 0.99))
def test_backoff_delays_equal_jax(seed, base, cap, factor, jitter):
    mine = tbackoff.Backoff(base, cap, factor=factor, jitter=jitter, seed=seed)
    ref = jbackoff.Backoff(base, cap, factor=factor, jitter=jitter, seed=seed)
    # asked out of order and twice: attempt k's delay is a pure function of k
    order = [5, 0, 3, 11, 1, 5, 2, 0]
    assert [mine.delay(k) for k in order] == [ref.delay(k) for k in order]


def test_backoff_policy_is_seeded_capped_and_deadline_bounded():
    """The JAX test of the same name, on the port's policy."""
    p1 = tbackoff.Backoff(0.1, 1.0, jitter=0.5, seed=7)
    p2 = tbackoff.Backoff(0.1, 1.0, jitter=0.5, seed=7)
    p3 = tbackoff.Backoff(0.1, 1.0, jitter=0.5, seed=8)
    d1 = [p1.delay(k) for k in range(8)]
    assert d1 == [p2.delay(k) for k in range(8)]
    assert d1 == [p1.delay(k) for k in range(8)]
    assert d1 != [p3.delay(k) for k in range(8)]
    assert all(d <= 1.0 for d in d1)
    assert d1[0] < d1[4]
    t0 = time.monotonic()
    fast = tbackoff.Backoff(0.01, 0.02, seed=1)
    n = sum(1 for _ in fast.attempts(deadline=t0 + 0.15))
    assert 3 <= n <= 40
    assert time.monotonic() - t0 < 2.0
    with pytest.raises(ValueError):
        tbackoff.Backoff(0.0, 1.0)
    with pytest.raises(ValueError):
        tbackoff.Backoff(0.1, 1.0, jitter=1.0)


def test_make_transport_and_make_world():
    port = _free_port()
    holder = {}
    th = threading.Thread(target=lambda: holder.setdefault("t", tmsg.make_transport(
        0, 2, port=port, kind="python", reliable=True, durable_acks=True)))
    th.start()
    w = tmsg.make_transport(1, 2, port=port, kind="python", reliable=True,
                            reliable_opts={"ack_timeout": 0.05})
    th.join(timeout=30)
    server = holder["t"]
    try:
        assert isinstance(server, tmsg.ReliableTransport)
        assert isinstance(server.inner, TCPTransport)
        assert not server.ack_on_delivery and w.ack_on_delivery and w.ack_timeout == 0.05
        w.send(MessageCode.GradientUpdate, np.ones(3, np.float32))
        assert server.recv(timeout=5)[1] == MessageCode.GradientUpdate
        server.ack_delivered()
        assert w.flush(timeout=5)
    finally:
        w.close()
        server.close()
    with pytest.raises(ValueError, match="unknown transport kind"):
        tmsg.make_transport(0, 1, kind="bogus")
    world = tmsg.make_world(3, reliable=True, reliable_opts={"send_window": 4})
    try:
        assert sorted(world) == [0, 1, 2]
        assert all(isinstance(t, tmsg.ReliableTransport) and t.send_window == 4
                   for t in world.values())
    finally:
        for t in world.values():
            t.close()
    plain = tmsg.make_world(2)
    assert all(isinstance(t, tmsg.InProcessTransport) for t in plain.values())
