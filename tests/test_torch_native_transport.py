"""The port's native (C++) transport: its own copy of the source, built with
g++ into ``build/native/<hash>/``, against the JAX package's transports.

- the copy of ``transport.cpp`` is byte-equal to the JAX package's (read
  here by the test; the port never reads the JAX tree) outside its blocks
  marked ``port: open rendezvous``, which only add (the rank-0 server that
  listens and admits its workers on its accept thread);
- round trips between native and Python endpoints (both packages' Python
  transports), empty and 20 MB payloads, a timed-out and a closed
  ``recv``, a malformed hello that does not poison the rendezvous, a
  restarted worker of the same rank after it, and the reliable layer
  over native endpoints;
- N processes building the library at once into one empty directory all
  load it, and no temporary file is left.

Skipped, with the reason, only where no ``g++`` is found. Exact throughout.
"""

import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch import native
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build the native transport")
    assert native.native_available(), native.native_load_error()
    return native


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _world(port, server_cls, worker_cls):
    out = {}
    st = threading.Thread(target=lambda: out.setdefault(
        "server", server_cls(0, 2, "localhost", port)))
    st.start()
    worker = worker_cls(1, 2, "localhost", port)
    st.join(timeout=30)
    assert "server" in out, "server rendezvous did not complete"
    return out["server"], worker


def test_source_is_a_byte_copy_of_the_jax_one():
    mine = os.path.join(ROOT, "distributed_ml_pytorch_tpu_torch", "native", "transport.cpp")
    ref = os.path.join(ROOT, "distributed_ml_pytorch_tpu", "native", "transport.cpp")
    with open(mine, "rb") as f:
        src = f.read()
    # each block is whole lines with a blank line after it
    marked = rb"(?ms)^ *// port: open rendezvous begin\n.*?^ *// port: open rendezvous end\n\n"
    src, n = re.subn(marked, b"", src)
    assert n == 2, "the port's additions are two marked blocks"
    with open(ref, "rb") as f:
        assert src == f.read()


def test_builds_under_build_and_not_beside_the_source(lib):
    path = lib.ensure_built()
    assert path.startswith(os.path.join(ROOT, "build", "native") + os.sep)
    src_dir = os.path.join(ROOT, "distributed_ml_pytorch_tpu_torch", "native")
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


PAIRS = {
    "native-native": ("native", "native"),
    "py-server": ("port", "native"),
    "native-server": ("native", "port"),
    "jax-py-server": ("jax", "native"),
    "jax-py-worker": ("native", "jax"),
}


def _cls(kind):
    return {"native": native.NativeTCPTransport, "port": tmsg.TCPTransport,
            "jax": jmsg.TCPTransport}[kind]


@pytest.mark.parametrize("pair", list(PAIRS))
def test_round_trip_and_interop(lib, pair):
    server_kind, worker_kind = PAIRS[pair]
    server, worker = _world(_free_port(), _cls(server_kind), _cls(worker_kind))
    try:
        payload = np.arange(5, dtype=np.float32) * 1.5
        worker.send(MessageCode.GradientUpdate, payload)
        sender, code, got = server.recv(timeout=10)
        assert sender == 1 and int(code) == int(MessageCode.GradientUpdate)
        np.testing.assert_array_equal(got, payload)
        server.send(MessageCode.ParameterUpdate, np.full(7, 3.0, np.float32), dst=1)
        reply = worker.recv(timeout=10)
        assert reply[0] == 0 and int(reply[1]) == int(MessageCode.ParameterUpdate)
        np.testing.assert_array_equal(reply[2], np.full(7, 3.0, np.float32))
        worker.send(MessageCode.ParameterRequest, np.zeros(0, np.float32))
        req = server.recv(timeout=10)
        assert int(req[1]) == int(MessageCode.ParameterRequest) and req[2].size == 0
    finally:
        server.close()
        worker.close()


def test_recv_timeout_and_close_unblocks(lib):
    server, worker = _world(_free_port(), native.NativeTCPTransport, native.NativeTCPTransport)
    try:
        t0 = time.monotonic()
        assert server.recv(timeout=0.2) is None
        assert time.monotonic() - t0 < 5.0
        got = {}
        th = threading.Thread(target=lambda: got.setdefault("msg", worker.recv(timeout=None)))
        th.start()
        time.sleep(0.2)
        worker.close()
        th.join(timeout=10)
        assert not th.is_alive() and got["msg"] is None
    finally:
        server.close()
        worker.close()


def test_large_payload(lib):
    server, worker = _world(_free_port(), native.NativeTCPTransport, tmsg.TCPTransport)
    try:
        payload = np.random.default_rng(0).normal(size=5_000_000).astype(np.float32)
        worker.send(MessageCode.GradientUpdate, payload)
        msg = server.recv(timeout=30)
        np.testing.assert_array_equal(msg[2], payload)
        server.send(MessageCode.ParameterUpdate, payload, dst=1)
        np.testing.assert_array_equal(worker.recv(timeout=30)[2], payload)
    finally:
        server.close()
        worker.close()


def test_rendezvous_tolerates_malformed_handshake_and_admits_a_rejoin(lib):
    """A hello with a payload and one with an out-of-range rank are dropped
    while the server waits for its world; then a worker of rank 1 dials in
    again and replaces its first socket."""
    port = _free_port()
    out = {}
    st = threading.Thread(target=lambda: out.setdefault(
        "server", native.NativeTCPTransport(0, 3, "localhost", port, connect_timeout=10)))
    st.start()
    time.sleep(0.2)
    s1 = socket.create_connection(("localhost", port), timeout=5)
    s1.sendall(struct.pack("<iiq", 1, 1, 0))
    bad = socket.create_connection(("localhost", port), timeout=5)
    bad.sendall(struct.pack("<iiq", 2, 1, 4))
    bad2 = socket.create_connection(("localhost", port), timeout=5)
    bad2.sendall(struct.pack("<iiq", 99, 1, 0))
    time.sleep(0.3)
    assert st.is_alive(), "server gave up on the rendezvous instead of tolerating garbage"
    s2 = socket.create_connection(("localhost", port), timeout=5)
    s2.sendall(struct.pack("<iiq", 2, 1, 0))
    st.join(timeout=20)
    assert not st.is_alive() and "server" in out
    server = out["server"]
    try:
        s1.sendall(struct.pack("<iiq", 1, 2, 4) + np.float32(7).tobytes())
        msg = server.recv(timeout=5.0)
        assert msg is not None and msg[0] == 1 and msg[2][0] == 7
        s1.close()
        w = tmsg.TCPTransport(1, 3, "localhost", port, connect_timeout=10)
        w.send(MessageCode.GradientUpdate, np.full(2, 9.0, np.float32))
        msg = server.recv(timeout=5.0)
        assert msg is not None and msg[0] == 1 and msg[2][0] == 9
        server.send(MessageCode.ParameterUpdate, np.ones(3, np.float32), dst=1)
        assert w.recv(timeout=5)[1] == MessageCode.ParameterUpdate
        w.close()
    finally:
        for s in (s1, s2, bad, bad2):
            s.close()
        server.close()


def test_reliable_layer_over_native_endpoints(lib):
    """``make_transport(kind="native", reliable=True)`` on both ranks, the
    server with durable acks: a 9.9 MB push is delivered once, its ack waits
    for ``ack_delivered``."""
    port = _free_port()
    out = {}
    st = threading.Thread(target=lambda: out.setdefault("s", tmsg.make_transport(
        0, 2, port=port, kind="native", reliable=True, durable_acks=True,
        reliable_opts={"ack_timeout": 0.05})))
    st.start()
    w = tmsg.make_transport(1, 2, port=port, kind="native", reliable=True,
                            reliable_opts={"ack_timeout": 0.05})
    st.join(timeout=30)
    s = out["s"]
    try:
        assert isinstance(s.inner, native.NativeTCPTransport)
        push = np.random.default_rng(1).normal(size=2_472_320).astype(np.float32)
        w.send(MessageCode.GradientUpdate, push)
        msg = s.recv(timeout=10)
        np.testing.assert_array_equal(msg[2], push)
        assert not w.flush(timeout=0.3)  # withheld until durable
        s.ack_delivered()
        assert w.flush(timeout=10), w.stats
        assert w.acked_count(0, MessageCode.GradientUpdate) == 1
        assert s.stats["delivered"] == 1 and s.stats["crc_dropped"] == 0
    finally:
        w.close()
        s.close()


_BUILD_ONE = """
import ctypes, sys
from pathlib import Path
from distributed_ml_pytorch_tpu_torch import native
native.BUILD_ROOT = Path(sys.argv[1])
ctypes.CDLL(native.ensure_built()).tpt_last_error
print("ok")
"""


def test_concurrent_builds_never_load_a_half_written_library(lib, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and out.strip() == "ok", err[-2000:]
    files = [os.path.join(d, f) for d, _s, fs in os.walk(tmp_path) for f in fs]
    assert [os.path.basename(f) for f in files] == ["libdmt_transport.so"]
