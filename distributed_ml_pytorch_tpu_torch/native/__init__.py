"""The native (C++) star transport, loaded with ctypes (counterpart of the
JAX ``native/__init__.py``).

:class:`NativeTCPTransport` speaks the wire format of
``utils/messaging.TCPTransport`` (a little-endian ``<iiq`` header and a
float32 payload) from a C++ library whose reader threads run outside the
interpreter lock, so native and Python endpoints of either package
interoperate in one world. ``transport.cpp`` here is this package's own
copy of the JAX package's source, byte for byte outside the blocks marked
``port: open rendezvous``: a rank 0 made with ``open_rendezvous=True``
listens and admits its workers on its accept thread from the start, and
:meth:`NativeTCPTransport.expect_peers` and
:meth:`NativeTCPTransport.rendezvous_done` end that rendezvous as
``utils/messaging.TCPTransport``'s do.

:func:`ensure_built` compiles it with ``g++`` on first use into
``build/native/<hash>/`` at the root of the checkout (``.gitignore`` lists
``build/``), keyed by a hash of the source and the flags, under a
per-process temporary name and then ``os.replace``: N ranks started at
once on a fresh tree never load a half-written library, and nothing is
written beside the source. :func:`native_available` and
``utils/messaging.make_transport(kind="auto")`` fall back to the Python
transport where no compiler or library is found; ``kind="native"``
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    SERVER_RANK,
    Message,
    MessageCode,
    Transport,
)

_SRC_PATH = Path(__file__).resolve().parent / "transport.cpp"
BUILD_ROOT = _SRC_PATH.parent.parent.parent / "build" / "native"
#: the JAX package's Makefile flags, and those of a shared library
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread"]
_LIB_NAME = "libdmt_transport.so"

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def build_dir() -> Path:
    """The directory of the library built from the current source and flags."""
    h = hashlib.sha256(" ".join([_cxx(), *CXXFLAGS]).encode())
    h.update(_SRC_PATH.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def ensure_built() -> str:
    """Compile the library if it is missing; return its path."""
    with _build_lock:
        out = build_dir()
        lib = out / _LIB_NAME
        if lib.exists():
            return str(lib)
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f".{_LIB_NAME}.{os.getpid()}.tmp"
        try:
            subprocess.run([_cxx(), *CXXFLAGS, "-o", str(tmp), str(_SRC_PATH)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, lib)
        except subprocess.CalledProcessError as e:
            raise OSError(f"g++ failed to build {_SRC_PATH.name}:\n{e.stderr[-4000:]}") from e
        finally:
            if tmp.exists():
                tmp.unlink()
        return str(lib)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built())
    lib.tpt_create.restype = ctypes.c_void_p
    lib.tpt_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
    ]
    lib.tpt_send.restype = ctypes.c_int
    lib.tpt_send.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.tpt_recv.restype = ctypes.c_void_p
    lib.tpt_recv.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.tpt_rank.restype = ctypes.c_int
    lib.tpt_rank.argtypes = [ctypes.c_void_p]
    lib.tpt_msg_sender.restype = ctypes.c_int
    lib.tpt_msg_sender.argtypes = [ctypes.c_void_p]
    lib.tpt_msg_code.restype = ctypes.c_int
    lib.tpt_msg_code.argtypes = [ctypes.c_void_p]
    lib.tpt_msg_size.restype = ctypes.c_int64
    lib.tpt_msg_size.argtypes = [ctypes.c_void_p]
    lib.tpt_msg_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.tpt_msg_data.argtypes = [ctypes.c_void_p]
    lib.tpt_msg_free.restype = None
    lib.tpt_msg_free.argtypes = [ctypes.c_void_p]
    lib.tpt_close.restype = None
    lib.tpt_close.argtypes = [ctypes.c_void_p]
    lib.tpt_free.restype = None
    lib.tpt_free.argtypes = [ctypes.c_void_p]
    lib.tpt_last_error.restype = ctypes.c_char_p
    lib.tpt_last_error.argtypes = []
    lib.tpt_create_open.restype = ctypes.c_void_p
    lib.tpt_create_open.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tpt_expect.restype = None
    lib.tpt_expect.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_double]
    lib.tpt_rendezvous.restype = ctypes.c_int
    lib.tpt_rendezvous.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """True if the library is (or can be) built and loaded."""
    global _load_error
    try:
        _load()
        return True
    except (OSError, FileNotFoundError) as e:
        _load_error = str(e)
        return False


def native_load_error() -> Optional[str]:
    return _load_error


class NativeTCPTransport(Transport):
    """C++-backed star transport, a drop-in for ``TCPTransport``: rank 0
    admits ``world_size - 1`` workers, then goes on accepting (a rejoining
    rank replaces its socket); frame pumping, queueing and the blocking
    receive run in native threads. ``sendv`` is the base class's (one
    joined copy: the C interface takes one buffer).

    With ``open_rendezvous`` rank 0 returns once it listens and admits the
    workers on its accept thread (``TCPTransport(wait_for=0)``'s path);
    :meth:`expect_peers` starts a rendezvous with a deadline and
    :meth:`rendezvous_done` polls it."""

    def __init__(self, rank: int, world_size: int, master: str = "localhost",
                 port: int = 29500, connect_timeout: float = 60.0,
                 open_rendezvous: bool = False):
        self._lib = _load()
        self.rank = rank
        self.world_size = world_size
        self._closed = False
        #: the pending rendezvous: ``(workers, timeout)``, or None
        self._expect: Optional[tuple] = None
        if open_rendezvous and rank == SERVER_RANK:
            handle = self._lib.tpt_create_open(world_size, int(port))
        else:
            handle = self._lib.tpt_create(rank, world_size, master.encode(), int(port),
                                          float(connect_timeout))
        if not handle:
            err = self._lib.tpt_last_error().decode()
            raise ConnectionError(f"native transport rendezvous failed: {err}")
        self._handle = handle

    def expect_peers(self, n: int, timeout: float) -> None:
        """Start a rendezvous of ``n`` workers (an ``open_rendezvous`` rank 0
        admits them on its accept thread) that must end within ``timeout``
        seconds; :meth:`rendezvous_done` polls it."""
        self._lib.tpt_expect(self._handle, int(n), float(timeout))
        self._expect = (int(n), float(timeout))

    def rendezvous_done(self) -> bool:
        """Whether the expected workers have all connected (True with no
        rendezvous pending); raises ``TimeoutError`` past its deadline."""
        if self._expect is None:
            return True
        n, timeout = self._expect
        admitted = self._lib.tpt_rendezvous(self._handle)
        if admitted < 0:
            raise TimeoutError(f"{n} workers did not connect within {timeout:.0f} s")
        if admitted >= n:
            self._expect = None
            return True
        return False

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        arr = np.ascontiguousarray(np.asarray(payload, dtype=np.float32).ravel())
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        rc = self._lib.tpt_send(self._handle, int(dst), int(code), ptr, arr.size)
        if rc != 0:
            err = self._lib.tpt_last_error().decode()
            raise ConnectionError(f"native transport send failed: {err}")

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        msg = self._lib.tpt_recv(self._handle, -1.0 if timeout is None else float(timeout))
        if not msg:
            return None
        try:
            sender = self._lib.tpt_msg_sender(msg)
            code = MessageCode(self._lib.tpt_msg_code(msg))
            n = self._lib.tpt_msg_size(msg)
            if n:
                data = np.ctypeslib.as_array(self._lib.tpt_msg_data(msg), shape=(n,)).copy()
            else:
                data = np.zeros(0, dtype=np.float32)
            return sender, code, data
        finally:
            self._lib.tpt_msg_free(msg)

    def close(self) -> None:
        # shut down only (idempotent in C): wakes a thread blocked in recv
        # and joins the native readers; the handle is freed in __del__, so
        # a receiver racing close never touches freed memory
        if self._closed:
            return
        self._closed = True
        self._lib.tpt_close(self._handle)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self.close()
                self._lib.tpt_free(self._handle)
                self._handle = None
        except Exception:
            pass
