"""The parameter server's write-ahead log (counterpart of the JAX
``utils/wal.py``, byte for byte: a log written by either package replays in
the other).

The server appends each applied update to the log before it acknowledges
anything, so recovery is "restore the latest checkpoint, then replay the
log", and an update the server applied is not lost to a crash after the
covering :meth:`WriteAheadLog.sync`. A checkpoint truncates the log.

One self-delimiting record per applied update, little-endian::

    magic:u32 ("WAL2")  incarnation:u32  seq:u64  sender:i32
    env_inc:u32  env_seq:u32  codec:u32  nbytes:u64  crc:u32  payload[nbytes]

- ``incarnation`` stamps the server life that wrote the record: a record
  whose incarnation goes backward mid-log is a dead life's late tail and is
  skipped, and counted.
- ``seq`` is the server's apply sequence (monotonic across lives, restored
  from the checkpoint's meta), which makes replay idempotent: a record the
  checkpoint already covers is skipped.
- ``(sender, env_inc, env_seq)`` name the delivery envelope of a reliable
  transport (0 where there is none); ``codec`` the wire encoding that
  delivered the update (0: dense). The payload is the decoded float32 delta
  that was applied.
- ``crc`` covers the whole record. A bad record at the tail of the log is a
  torn final write (dropped, counted); a bad record with valid records after
  it is damage, and replay raises :class:`WALCorruptionError` rather than
  skip applied updates. A log in the older codec-less ``WAL1`` layout is
  refused with the same error.

Appends are single unbuffered ``write`` calls (one whole record each);
:meth:`WriteAheadLog.sync` fsyncs, and the server batches it over small
groups of updates (group commit).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.utils.durability import atomic_write

_MAGIC = 0x57414C32  # "WAL2"
#: the codec-less record layout's magic, recognized only to refuse it: its
#: records are applied updates this parser cannot decode
_MAGIC_V1 = 0x57414C31  # "WAL1"
_HEADER = struct.Struct("<IIQiIIIQI")  # magic inc seq sender env_inc env_seq codec nbytes crc


class WALError(Exception):
    """Base class of the write-ahead log's failures."""


class WALCorruptionError(WALError):
    """A record failed its CRC (or does not parse) with valid records after
    it, or the log is in the ``WAL1`` layout: replay must not go on past
    it."""


@dataclasses.dataclass(frozen=True)
class WALRecord:
    """One applied update: its apply seq, where it came from, and the delta
    that was added to the central vector (after staleness damping, so replay
    reproduces the applied bytes)."""

    incarnation: int
    seq: int
    sender: int
    env_inc: int
    env_seq: int
    payload: np.ndarray
    #: the wire encoding that delivered the update (0: dense)
    codec: int = 0


def _record_bytes(inc: int, seq: int, sender: int, env_inc: int, env_seq: int,
                  payload: np.ndarray, codec: int = 0) -> bytes:
    body = np.asarray(payload, np.float32).tobytes()
    head_sans_crc = struct.pack(
        "<IIQiIII", _MAGIC, inc & 0xFFFFFFFF, seq, sender, env_inc & 0xFFFFFFFF,
        env_seq & 0xFFFFFFFF, codec & 0xFFFFFFFF) + struct.pack("<Q", len(body))
    crc = zlib.crc32(body, zlib.crc32(head_sans_crc)) & 0xFFFFFFFF
    return head_sans_crc + struct.pack("<I", crc) + body


def _parse_one(data: bytes, off: int) -> Optional[Tuple[WALRecord, int]]:
    """The record at ``off`` and the offset after it; ``None`` where the
    bytes there are not a whole CRC-valid record (torn or corrupt: the
    caller tells which by what follows)."""
    end = off + _HEADER.size
    if end > len(data):
        return None
    magic, inc, seq, sender, env_inc, env_seq, codec, nbytes, crc = _HEADER.unpack(
        data[off:end])
    if magic != _MAGIC or nbytes > len(data) - end:
        return None
    body = data[end:end + nbytes]
    if zlib.crc32(body, zlib.crc32(data[off:end - 4])) & 0xFFFFFFFF != crc:
        return None
    if nbytes % 4:
        return None
    payload = np.frombuffer(body, dtype=np.float32).copy()
    return WALRecord(inc, seq, sender, env_inc, env_seq, payload, codec), end + nbytes


def _any_valid_record_after(data: bytes, off: int) -> bool:
    """Whether a whole CRC-valid record starts anywhere past ``off``: the
    test between a torn tail and damage mid-log."""
    magic = struct.pack("<I", _MAGIC)
    probe = data.find(magic, off)
    while probe != -1:
        if _parse_one(data, probe) is not None:
            return True
        probe = data.find(magic, probe + 1)
    return False


def replay_wal(path: str) -> Tuple[List[WALRecord], dict]:
    """Every replayable record of the log at ``path``, and ``stats``:
    ``records``, ``torn_tail`` (0 or 1: a partial or corrupt final write,
    dropped) and ``stale_skipped`` (records whose incarnation went backward
    mid-log, skipped). Damage mid-log and a ``WAL1`` log raise
    :class:`WALCorruptionError`. A missing file is an empty log."""
    stats = {"records": 0, "torn_tail": 0, "stale_skipped": 0}
    if not os.path.exists(path):
        return [], stats
    with open(path, "rb") as f:
        data = f.read()
    records: List[WALRecord] = []
    off = 0
    max_inc = 0
    while off < len(data):
        parsed = _parse_one(data, off)
        if parsed is None:
            if data[off:off + 4] == struct.pack("<I", _MAGIC_V1):
                raise WALCorruptionError(
                    f"{path}: record at byte {off} carries the WAL1 magic — this log "
                    "predates the codec-stamped WAL2 layout; restore it with the code "
                    "that wrote it (checkpoint, then delete the log) instead of losing "
                    "its records")
            if _any_valid_record_after(data, off + 1):
                raise WALCorruptionError(
                    f"{path}: record at byte {off} is corrupt but valid records follow "
                    "it — the log is damaged mid-stream, refusing to replay past a "
                    "silent loss")
            stats["torn_tail"] = 1
            break
        rec, off = parsed
        if rec.incarnation < max_inc:
            stats["stale_skipped"] += 1
            continue
        max_inc = rec.incarnation
        records.append(rec)
        stats["records"] += 1
    return records, stats


class WriteAheadLog:
    """Append-only, CRC-framed, incarnation-stamped update log.

    :meth:`append` buffers nothing in user space (one unbuffered ``write`` a
    record), but durability needs :meth:`sync`, which the caller batches
    (group commit); ``pending`` counts the appends since the last sync.
    """

    def __init__(self, path: str, incarnation: Optional[int] = None):
        from distributed_ml_pytorch_tpu_torch.utils.messaging import _next_incarnation

        self.path = path
        self.incarnation = (int(incarnation) if incarnation is not None
                            else _next_incarnation())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "ab", buffering=0)
        self.pending = 0
        self.appended = 0
        #: highest seq this handle appended, so that :meth:`truncate` can
        #: drop the whole file without parsing it when a checkpoint covers
        #: everything; 0 until the first append, so a new handle over an
        #: old log takes the parsing path
        self._max_seq = 0

    def append(self, seq: int, payload: np.ndarray, *, sender: int = 0, env_inc: int = 0,
               env_seq: int = 0, codec: int = 0) -> None:
        self._f.write(_record_bytes(self.incarnation, int(seq), int(sender), env_inc,
                                    env_seq, payload, codec=int(codec)))
        self.pending += 1
        self.appended += 1
        self._max_seq = max(self._max_seq, int(seq))

    def sync(self) -> None:
        """Make every appended record power-loss durable (fsync)."""
        if self.pending:
            os.fsync(self._f.fileno())
            self.pending = 0

    def replay(self) -> Tuple[List[WALRecord], dict]:
        return replay_wal(self.path)

    def _rewrite(self, keep: List[WALRecord]) -> None:
        self._f.close()
        atomic_write(self.path, b"".join(
            _record_bytes(r.incarnation, r.seq, r.sender, r.env_inc, r.env_seq, r.payload,
                          codec=r.codec) for r in keep))
        self._f = open(self.path, "ab", buffering=0)
        self.pending = 0

    def truncate(self, upto_seq: int) -> None:
        """Drop the records a durable checkpoint now covers (``seq <=
        upto_seq``); the ones past it are kept, rewritten through
        :func:`atomic_write`."""
        self.sync()
        if self.appended and self._max_seq <= int(upto_seq):
            keep = []  # the checkpoint covers all this handle wrote
        else:
            keep = [r for r in replay_wal(self.path)[0] if r.seq > int(upto_seq)]
        self._rewrite(keep)

    def drop_after(self, upto_seq: int) -> None:
        """The inverse of :meth:`truncate`: drop the records past
        ``upto_seq`` and keep the rest, so that updates a rollback discarded
        cannot come back at the next restore."""
        self.sync()
        self._rewrite([r for r in replay_wal(self.path)[0] if r.seq <= int(upto_seq)])
        self._max_seq = min(self._max_seq, int(upto_seq))

    def close(self) -> None:
        try:
            self.sync()
        except (OSError, ValueError):
            pass
        try:
            self._f.close()
        except (OSError, ValueError):
            pass
