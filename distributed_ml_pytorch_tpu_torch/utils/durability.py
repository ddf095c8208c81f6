"""Power-loss-durable file writes (counterpart of the JAX
``utils/durability.py``).

A write-then-``os.replace`` is atomic (no reader sees a torn file) but not
durable: after a power loss the rename can survive while the file's data
blocks do not, or the other way round. :func:`atomic_write` is the three-step
fix: write a temp file and fsync it, ``os.replace`` it onto the destination,
fsync the directory. The parameter server's checkpoint (``ps_central.npy``,
``ps_meta.json``) and the write-ahead log's rewrites (``utils/wal.py``) go
through it.
"""

from __future__ import annotations

import os

#: process umask, read once at import (single-threaded): the momentary
#: ``os.umask(0)`` is unsafe to repeat on threads that write concurrently
_UMASK = os.umask(0)
os.umask(_UMASK)


def fsync_dir(path: str) -> None:
    """fsync a directory, so that a rename inside it survives power loss. A
    platform that cannot open directories degrades to a no-op (the rename
    is still atomic there, just not power-loss durable)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data) -> None:
    """Atomically and durably replace ``path`` with ``data``: bytes, or a
    sequence of bytes-like chunks written back to back (a large state need
    not be joined into one buffer first).

    The temp file lives beside the destination (``os.replace`` must not
    cross file systems), has a name unique to the call (``mkstemp``: two
    writers of one path end as last-writer-wins, never as one publishing
    the other's partial bytes) and is fsync'd before the swap; the directory
    is fsync'd after it. A failed write unlinks its temp file.
    """
    import tempfile

    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp",
                               dir=dirname)
    try:
        # mkstemp creates 0600; give the file the mode a plain open() would
        os.fchmod(fd, 0o666 & ~_UMASK)
        with os.fdopen(fd, "wb") as f:
            for chunk in ((data,) if isinstance(data, (bytes, bytearray, memoryview))
                          else data):
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(dirname)
