"""Tagged-tensor messaging for the DownPour control plane (counterpart of the
JAX ``utils/messaging.py``; numpy, sockets and threads only).

- :class:`MessageCode` — the whole tag enum, with the JAX package's integer
  values, so a frame means the same thing to either package;
- :class:`InProcessTransport` — queue-based, a whole world in one process;
- :class:`TCPTransport` — a star of sockets between processes (rank 0 is the
  server), with the JAX package's wire format: a little-endian header
  ``(sender:i32, code:i32, nbytes:i64)`` followed by a float32 payload;
- ``send_message`` / :class:`MessageListener` — the reference's API
  (``Asynchronous.py:5,9-18``), on an explicit or a default transport.

Payloads on the wire are host float32 arrays. ``send_message`` accepts a
torch tensor on any device and copies it to the host.
"""

from __future__ import annotations

import enum
import logging
import queue
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

_LOGGER = logging.getLogger(__name__)

_HEADER = struct.Struct("<iiq")

#: upper bound on a declared frame payload: a malformed header must not make
#: the reader allocate unbounded memory (256M float32 parameters)
MAX_FRAME_BYTES = 1 << 30

SERVER_RANK = 0  # reference convention: rank 0 is the parameter server


class MessageCode(enum.IntEnum):
    """Message tags, value for value the JAX package's. This package speaks
    codes 0-4 (the DownPour path) and 27 (``UpdateNack``, the admission
    gate's reject); the rest are defined so that frames from the JAX
    package's other planes decode to their names."""

    ParameterUpdate = 0
    ParameterRequest = 1
    GradientUpdate = 2
    WorkerDone = 3
    Heartbeat = 4
    SubmitRequest = 5
    StreamTokens = 6
    ServeReject = 7
    CancelRequest = 8
    ReliableFrame = 9
    ReliableAck = 10
    StreamAck = 11
    ResumeStream = 12
    CoordJoin = 13
    CoordLeave = 14
    LeaseRenew = 15
    ShardMapUpdate = 16
    FleetState = 17
    SpeculateTask = 18
    SpeculativeUpdate = 19
    RangeInstall = 20
    SnapshotRequest = 21
    SnapshotDone = 22
    SubmitRequestV2 = 23
    ShardPush = 24
    ShardParams = 25
    CumAck = 26
    UpdateNack = 27
    RollbackRequest = 28
    RollbackDone = 29
    ActivationShip = 30
    ActivationGrad = 31
    StageReady = 32
    StageAssign = 33
    CompressedUpdate = 34
    PreemptRequest = 35
    PreemptDone = 36
    SlotGrant = 37
    ResumeRequest = 38
    DeltaParams = 39
    KvMigrate = 40


Message = Tuple[int, MessageCode, np.ndarray]


class Transport:
    """Point-to-point tagged-tensor channel for one rank."""

    rank: int = 0

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        """Blocking receive; returns ``None`` on timeout or closed transport."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcessTransport(Transport):
    """Queue-based transport: a whole world inside one process.

    ``mailboxes`` maps each rank to its ``queue.Queue`` of
    ``(sender, code, payload)``; a world made by either package can be
    shared, since both use that tuple and the same integer codes."""

    def __init__(self, rank: int, mailboxes: Dict[int, "queue.Queue[Message]"]):
        self.rank = rank
        self._boxes = mailboxes
        self._closed = False

    @classmethod
    def create_world(cls, world_size: int) -> Dict[int, "InProcessTransport"]:
        boxes: Dict[int, queue.Queue] = {r: queue.Queue() for r in range(world_size)}
        return {r: cls(r, boxes) for r in range(world_size)}

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        # copy: the receiver must never alias the sender's live buffer (the
        # server's central vector is updated in place)
        arr = np.array(payload, dtype=np.float32, copy=True).ravel()
        self._boxes[dst].put((self.rank, MessageCode(code), arr))

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        if self._closed:
            return None
        try:
            return self._boxes[self.rank].get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._closed = True


def _send_frame(sock: socket.socket, sender: int, code: int, payload: np.ndarray) -> None:
    buf = np.ascontiguousarray(payload, dtype=np.float32).tobytes()
    sock.sendall(_HEADER.pack(sender, code, len(buf)) + buf)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        try:
            b = sock.recv(min(n, 1 << 20))
        except (OSError, ValueError):
            return None
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


#: a malformed frame was consumed but the stream is still framed
_MALFORMED = object()


def _recv_frame(sock: socket.socket):
    """One wire frame: a ``Message``, ``None`` (closed or unframeable), or
    :data:`_MALFORMED` (a bad frame was skipped; keep reading)."""
    hdr = _recv_exact(sock, _HEADER.size)
    if hdr is None:
        return None
    sender, code, nbytes = _HEADER.unpack(hdr)
    if nbytes < 0 or nbytes > MAX_FRAME_BYTES:
        _LOGGER.warning("dropping connection: unframeable payload length %d "
                        "(sender=%d code=%d)", nbytes, sender, code)
        return None
    body = _recv_exact(sock, nbytes)
    if body is None:
        return None
    try:
        mcode = MessageCode(code)
    except ValueError:
        _LOGGER.warning("dropping frame with unknown MessageCode %d from %d", code, sender)
        return _MALFORMED
    if nbytes % 4:
        _LOGGER.warning("dropping frame: %d-byte payload is not float32-aligned", nbytes)
        return _MALFORMED
    return sender, mcode, np.frombuffer(body, dtype=np.float32).copy()


class TCPTransport(Transport):
    """Star-topology socket transport.

    Rank 0 (the server) binds ``master:port`` and accepts ``world_size - 1``
    worker connections; each worker dials in and identifies itself with a
    hello frame. Reader threads pump incoming frames into a local queue, so
    :meth:`recv` has the in-process transport's blocking-queue semantics.
    """

    def __init__(self, rank: int, world_size: int, master: str = "localhost",
                 port: int = 29500, connect_timeout: float = 60.0):
        self.rank = rank
        self.world_size = world_size
        self._inbox: "queue.Queue[Message]" = queue.Queue()
        self._peers: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._threads = []
        self._closed = False
        self._server_sock = None
        if rank == SERVER_RANK:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((master if master != "localhost" else "", int(port)))
            srv.listen(world_size)
            srv.settimeout(connect_timeout)
            self._server_sock = srv
            while len(self._peers) < world_size - 1:
                conn, _addr = srv.accept()
                conn.settimeout(5.0)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hello = _recv_frame(conn)
                if hello is None or hello is _MALFORMED or not (
                        1 <= hello[0] < world_size):
                    conn.close()  # garbage connection: drop it, keep waiting
                    continue
                conn.settimeout(None)
                self._peers[hello[0]] = conn
                self._send_locks[hello[0]] = threading.Lock()
                self._spawn_reader(conn)
        else:
            deadline = time.monotonic() + connect_timeout
            while True:
                try:
                    sock = socket.create_connection((master, int(port)), timeout=5.0)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.05)
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_frame(sock, rank, int(MessageCode.ParameterRequest),
                        np.zeros(0, np.float32))
            self._peers[SERVER_RANK] = sock
            self._send_locks[SERVER_RANK] = threading.Lock()
            self._spawn_reader(sock)

    def _spawn_reader(self, sock: socket.socket) -> None:
        def pump():
            while not self._closed:
                msg = _recv_frame(sock)
                if msg is None:
                    break
                if msg is not _MALFORMED:
                    self._inbox.put(msg)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        self._threads.append(t)

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        # one lock per peer: the training loop, the push flusher and the
        # heartbeat thread may send concurrently, and frames must not interleave
        with self._send_locks[dst]:
            _send_frame(self._peers[dst], self.rank, int(code), payload)

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        # short slices, so a blocked recv() returns None once closed
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed:
                return None
            slice_t = 0.1 if deadline is None else max(0.0, min(0.1, deadline - time.monotonic()))
            try:
                return self._inbox.get(timeout=slice_t)
            except queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    return None

    def close(self) -> None:
        self._closed = True
        for s in self._peers.values():
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        if self._server_sock is not None:
            self._server_sock.close()


def make_transport(rank: int, world_size: int, master: str = "localhost",
                   port: int = 29500, connect_timeout: float = 60.0) -> Transport:
    """The TCP transport of one rank of the PS world."""
    return TCPTransport(rank, world_size, master, int(port), connect_timeout)


# --- module-level default transport: the reference's send_message has no
# transport argument (its process group is ambient state)

_default_transport: Optional[Transport] = None


def set_default_transport(t: Optional[Transport]) -> None:
    global _default_transport
    _default_transport = t


def get_default_transport() -> Transport:
    if _default_transport is None:
        raise RuntimeError("no default transport installed — call set_default_transport()")
    return _default_transport


_INC_LOCK = threading.Lock()
_LAST_INC = 0


def _next_incarnation() -> int:
    """A stamp for one life of a server: epoch seconds in 32 bits (they wrap
    in 2106; milliseconds would wrap every 50 days and make a restart after
    the wrap read as an older life), strictly increasing within the process,
    so two lives begun in the same second still differ."""
    global _LAST_INC
    with _INC_LOCK:
        _LAST_INC = max(_LAST_INC + 1, int(time.time()) & 0xFFFFFFFF)
        return _LAST_INC


def _host_f32(payload) -> np.ndarray:
    if hasattr(payload, "detach"):  # a torch tensor, on any device
        payload = payload.detach().cpu().numpy()
    return np.asarray(payload, dtype=np.float32)


def send_message(message_code: MessageCode, payload, dst: int = SERVER_RANK,
                 transport: Optional[Transport] = None) -> None:
    """Fire-and-forget tagged tensor send (reference ``Asynchronous.py:34,49,59``)."""
    t = transport or get_default_transport()
    t.send(MessageCode(message_code), _host_f32(payload), dst=dst)


class MessageListener(threading.Thread):
    """Background receive loop; subclasses override :meth:`receive` and
    deposit results for the training loop to install between steps."""

    def __init__(self, model=None, transport: Optional[Transport] = None):
        super().__init__(daemon=True)
        self.model = model
        self.transport = transport or get_default_transport()
        self._running = threading.Event()
        self._running.set()

    def receive(self, sender: int, message_code: MessageCode, parameter: np.ndarray) -> None:
        raise NotImplementedError

    def run(self) -> None:
        while self._running.is_set():
            msg = self.transport.recv(timeout=0.1)
            if msg is None:
                continue
            sender, code, payload = msg
            self.receive(sender, MessageCode(code), payload)

    def stop(self) -> None:
        self._running.clear()
