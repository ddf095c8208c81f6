"""Compressed gradient pushes with error feedback (counterpart of the JAX
``utils/compress.py``; numpy only, so both packages frame the same bytes).

A dense push is the whole float32 accumulator (9.9 MB for AlexNet). The
codecs here shrink it without changing what the server applies:

- :class:`Int8Codec` — per-block symmetric int8 quantization: each block of
  ``block`` elements keeps its own scale ``max(absmax, 1e-12) / 127``, so one
  outlier cannot crush every other element's resolution. The body is the
  scales then the int8 values packed four to a float32 word.
- :class:`TopKCodec` — the k largest magnitudes as exact ``(index, value)``
  pairs; indices ride the float32 wire exactly below 2^24.
- :class:`Tok16Codec` — exact packing of integer ids below 2^16, two to a
  word (the token wire of the codec plane, ``utils/codecs.py``).

Both lossy codecs run behind :class:`CompressingEncoder`, whose per-worker
residual carries what one push could not represent into the next, so the sum
of the decoded pushes is the sum of the raw pushes less the final residual.

The ``CompressedUpdate`` frame::

    [codec, n_lo, n_hi, crc_lo, crc_hi, param,
     ver_lo, ver_hi, lo_lo, lo_hi, hi_lo, hi_hi, *body]

``codec`` names the codec, ``n`` the decoded length, ``param`` the codec's
parameter (block size, or k), ``crc`` a crc32 of the body's bytes and the
``(ver, lo, hi)`` halves the elastic stamp (all zero: unstamped). The frame
leaves as ``(head, body)`` parts through ``Transport.sendv``. The server
decodes it before anything else reads it: the admission gate judges the
decoded norm, and the WAL logs the decoded delta with the codec id.

The expressions are the JAX module's, so bodies and frames are equal bit for
bit across the two packages.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.utils.messaging import _join16, _split16

#: codec ids on the wire (small integers, exact in float32)
CODEC_DENSE = 0
CODEC_INT8 = 1
CODEC_TOPK = 2
CODEC_TOK16 = 3

CODEC_NAMES = {CODEC_DENSE: "dense", CODEC_INT8: "int8", CODEC_TOPK: "topk",
               CODEC_TOK16: "tok16"}

#: the fixed head of a CompressedUpdate frame (its WIRE_SCHEMAS fields)
HEAD_LEN = 12

#: float32 carries integers exactly only below 2^24
_MAX_EXACT = 1 << 24


class CompressionError(ValueError):
    """A frame that cannot be decoded: an unknown codec id, a body CRC
    mismatch, indices out of range, a size mismatch. The server drops and
    counts such frames; it never applies them."""


def body_crc(body: np.ndarray) -> int:
    """crc32 over the body's raw bytes (the bit pattern, so packed int8
    words survive the round trip exactly)."""
    mv = memoryview(np.ascontiguousarray(body)).cast("B")
    return zlib.crc32(mv) & 0xFFFFFFFF


class Int8Codec:
    """Per-block symmetric int8 quantization; the body is ``[scales
    (nblocks f32), packed int8 (nblocks * block / 4 f32 words)]``.
    Elementwise ``|x - decode(encode(x))| <= scale_block / 2``."""

    id = CODEC_INT8
    name = "int8"

    def __init__(self, block: int = 1024):
        if block < 4 or block % 4:
            raise ValueError(f"int8 block must be a positive multiple of 4, got {block}")
        self.block = int(block)

    @property
    def param(self) -> int:
        return self.block

    def encode(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32).ravel()
        n = x.size
        nblocks = -(-n // self.block)
        padded = np.zeros(nblocks * self.block, np.float32)
        padded[:n] = x
        blocks = padded.reshape(nblocks, self.block)
        absmax = np.max(np.abs(blocks), axis=1)
        scales = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
        q = np.clip(np.round(blocks / scales[:, None]), -127, 127).astype(np.int8)
        packed = q.reshape(-1).view(np.float32)  # four int8 to a float32 word
        return np.concatenate([scales, packed])

    def decode(self, body: np.ndarray, n: int, param: int) -> np.ndarray:
        block = int(param)
        if block < 4 or block % 4:
            raise CompressionError(f"bad int8 block {block}")
        nblocks = -(-n // block)
        expect = nblocks + (nblocks * block) // 4
        body = np.asarray(body, np.float32).ravel()
        if body.size != expect:
            raise CompressionError(f"int8 body holds {body.size} floats, expected {expect} "
                                   f"for n={n} block={block}")
        scales = body[:nblocks]
        q = np.ascontiguousarray(body[nblocks:]).view(np.int8)
        out = (q.reshape(nblocks, block).astype(np.float32) * scales[:, None]).reshape(-1)[:n]
        return np.ascontiguousarray(out, dtype=np.float32)

    def wire_floats(self, n: int) -> int:
        nblocks = -(-n // self.block)
        return nblocks + (nblocks * self.block) // 4


class TopKCodec:
    """The ``k`` largest ``|x|`` as exact ``(index, value)`` pairs, ``k =
    max(1, min(n, round(k_frac * n)))``. Everything strictly above the k-th
    magnitude is kept, then ties at it by lowest index: the set a stable sort
    on ``-|x|`` gives, so the encoding is a pure function of the input."""

    id = CODEC_TOPK
    name = "topk"

    def __init__(self, k_frac: float = 0.01):
        if not 0.0 < k_frac <= 1.0:
            raise ValueError(f"need 0 < k_frac <= 1, got {k_frac}")
        self.k_frac = float(k_frac)

    def k_for(self, n: int) -> int:
        return max(1, min(n, int(round(self.k_frac * n))))

    @property
    def param(self) -> int:  # resolved per encode; 0 in the spec slot
        return 0

    def encode(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32).ravel()
        n = x.size
        if n >= _MAX_EXACT:
            raise ValueError(f"top-k indices for n={n} are not float32-exact (>= 2^24)")
        k = self.k_for(n)
        a = np.abs(x)
        if k >= n:
            idx = np.arange(n, dtype=np.int64)
        else:
            kth = np.partition(a, n - k)[n - k]
            above = np.flatnonzero(a > kth)
            ties = np.flatnonzero(a == kth)[:k - above.size]
            idx = np.sort(np.concatenate([above, ties]))
        return np.concatenate([idx.astype(np.float32), x[idx]])

    def decode(self, body: np.ndarray, n: int, param: int) -> np.ndarray:
        body = np.asarray(body, np.float32).ravel()
        if body.size % 2:
            raise CompressionError(f"top-k body of {body.size} floats is not (idx, val) pairs")
        k = body.size // 2
        if not 1 <= k <= n:
            raise CompressionError(f"top-k k={k} out of range for n={n}")
        idx = body[:k]
        if not np.isfinite(idx).all():
            raise CompressionError("top-k indices are nonfinite")
        ii = idx.astype(np.int64)
        if (ii < 0).any() or (ii >= n).any() or (ii != idx).any():
            raise CompressionError("top-k indices out of range / non-integer")
        out = np.zeros(n, np.float32)
        out[ii] = body[k:]
        return out

    def wire_floats(self, n: int) -> int:
        return 2 * self.k_for(n)


class Tok16Codec:
    """Exact packing of non-negative integer ids below 2^16, two to a
    float32 word by bit pattern (never through float arithmetic)."""

    id = CODEC_TOK16
    name = "tok16"

    @property
    def param(self) -> int:
        return 0

    def encode(self, x: np.ndarray) -> np.ndarray:
        ids = np.asarray(x).ravel()
        ii = np.rint(ids).astype(np.int64)
        if ids.size and (np.abs(np.asarray(ids, np.float64) - ii).max() > 0):
            raise ValueError("tok16 encodes integer ids only")
        if ids.size and ((ii < 0).any() or (ii >= (1 << 16)).any()):
            raise ValueError("tok16 ids must be in [0, 2^16)")
        u = ii.astype(np.uint16)
        if u.size % 2:
            u = np.concatenate([u, np.zeros(1, np.uint16)])
        return u.view(np.float32).copy()

    def decode(self, body: np.ndarray, n: int, param: int) -> np.ndarray:
        body = np.ascontiguousarray(np.asarray(body, np.float32).ravel())
        if body.size != (n + 1) // 2:
            raise CompressionError(f"tok16 body holds {body.size} words, expected "
                                   f"{(n + 1) // 2} for n={n}")
        u = body.view(np.uint16)[:n]
        return u.astype(np.float32)

    def wire_floats(self, n: int) -> int:
        return (n + 1) // 2


def make_codec(name: str, *, block: int = 1024, k_frac: float = 0.01):
    """The codec behind ``--compress int8|topk``."""
    if name == "int8":
        return Int8Codec(block=block)
    if name == "topk":
        return TopKCodec(k_frac=k_frac)
    raise ValueError(f"unknown compression codec {name!r} (known: int8, topk)")


#: the codecs a frame's codec id decodes with (the decoder reads its
#: parameter from the frame, so a default instance serves)
CODECS_BY_ID = {CODEC_INT8: Int8Codec, CODEC_TOPK: TopKCodec, CODEC_TOK16: Tok16Codec}


def pack_frame(codec_id: int, n: int, param: int, body: np.ndarray,
               stamp: Optional[Tuple[int, int, int]] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``(head, body)`` of one CompressedUpdate frame, ready for
    ``Transport.sendv``; ``stamp`` is the elastic ``(version, lo, hi)``
    (``None``: zeros, the unstamped wire)."""
    ver, lo, hi = stamp if stamp is not None else (0, 0, 0)
    crc = body_crc(body)
    head = np.asarray(
        [float(codec_id), *_split16(int(n)), *_split16(crc), float(int(param)),
         *_split16(int(ver)), *_split16(int(lo)), *_split16(int(hi))], np.float32)
    return head, np.asarray(body, np.float32).ravel()


def unpack_frame(payload: np.ndarray,
                 ) -> Tuple[int, int, int, Optional[Tuple[int, int, int]], np.ndarray]:
    """``(codec_id, n, param, stamp or None, body)`` of one CompressedUpdate
    payload; a short frame, a nonfinite head or a body CRC mismatch raises
    :class:`CompressionError`."""
    arr = np.asarray(payload, np.float32).ravel()
    if arr.size < HEAD_LEN + 1:
        raise CompressionError(f"CompressedUpdate frame of {arr.size} floats is shorter than "
                               f"head+1 ({HEAD_LEN + 1})")
    if not np.isfinite(arr[:HEAD_LEN]).all():
        raise CompressionError("CompressedUpdate head is nonfinite")
    codec_id = int(arr[0])
    n = _join16(arr[1], arr[2])
    crc = _join16(arr[3], arr[4])
    param = int(arr[5])
    ver = _join16(arr[6], arr[7])
    lo = _join16(arr[8], arr[9])
    hi = _join16(arr[10], arr[11])
    body = arr[HEAD_LEN:]
    if body_crc(body) != crc:
        raise CompressionError("CompressedUpdate body CRC mismatch")
    stamp = None if (ver, lo, hi) == (0, 0, 0) else (ver, lo, hi)
    return codec_id, n, param, stamp, body


def decode_update(payload: np.ndarray,
                  ) -> Tuple[Optional[Tuple[int, int, int]], int, np.ndarray]:
    """``(stamp or None, codec_id, decoded vector)`` of one CompressedUpdate
    payload: what the server's admission gate, WAL and apply path see."""
    codec_id, n, param, stamp, body = unpack_frame(payload)
    cls = CODECS_BY_ID.get(codec_id)
    if cls is None:
        raise CompressionError(f"unknown codec id {codec_id}")
    return stamp, codec_id, cls().decode(body, n, param)


def peek_stamp(payload: np.ndarray) -> Optional[Tuple[int, int, int]]:
    """The elastic ``(version, lo, hi)`` stamp without decoding the body."""
    arr = np.asarray(payload, np.float32).ravel()
    if arr.size < HEAD_LEN or not np.isfinite(arr[6:HEAD_LEN]).all():
        return None
    ver = _join16(arr[6], arr[7])
    lo = _join16(arr[8], arr[9])
    hi = _join16(arr[10], arr[11])
    return None if (ver, lo, hi) == (0, 0, 0) else (ver, lo, hi)


def restamp_crc(arr: np.ndarray, head_off: int) -> None:
    """Recompute, in place, the body CRC of the CompressedUpdate frame that
    starts at ``arr[head_off:]``: a body corrupted in the sender's memory
    before framing carries a matching CRC."""
    if arr.size < head_off + HEAD_LEN + 1:
        return
    lo, hi = _split16(body_crc(arr[head_off + HEAD_LEN:]))
    arr[head_off + 3] = lo
    arr[head_off + 4] = hi


class CompressingEncoder:
    """A worker's compressed-push encoder with error feedback, over the whole
    flat vector (length ``n``; the residual is indexed absolutely). A push of
    ``[lo, hi)``::

        p                = raw[lo:hi] + residual[lo:hi]
        body             = codec.encode(p)
        residual[lo:hi]  = p - codec.decode(body)

    so ``sum(decoded pushes) == sum(raw pushes) - residual``. A nonfinite
    residual restarts at zero and is counted in ``residual_resets``.
    ``error_feedback=False`` keeps the residual at zero.

    Called from one thread only (the push flusher), like the accumulator it
    mirrors: no lock.
    """

    def __init__(self, n: int, codec, *, error_feedback: bool = True):
        self.n = int(n)
        self.codec = codec
        self.error_feedback = bool(error_feedback)
        self.residual = np.zeros(self.n, np.float32)
        #: float32 words framed, and those of the dense frames they replace
        self.pushes = 0
        self.wire_floats = 0
        self.dense_floats = 0
        self.residual_resets = 0

    def encode_range(self, arr: np.ndarray, lo: int, hi: int,
                     stamp: Optional[Tuple[int, int, int]] = None,
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One compressed push of ``arr[lo:hi]`` as fresh ``(head, body)``
        arrays, folding in and updating the range's residual."""
        sl = np.asarray(arr, np.float32).ravel()[lo:hi]
        p = sl + self.residual[lo:hi]
        body = self.codec.encode(p)
        param = (self.codec.k_for(hi - lo) if isinstance(self.codec, TopKCodec)
                 else self.codec.param)
        if self.error_feedback:
            r = p - self.codec.decode(body, hi - lo, param)
            if not np.isfinite(r).all():
                r = np.zeros_like(r)
                self.residual_resets += 1
            self.residual[lo:hi] = r
        head, body = pack_frame(self.codec.id, hi - lo, param, body, stamp=stamp)
        self.pushes += 1
        self.wire_floats += head.size + body.size
        self.dense_floats += (hi - lo) + (0 if stamp is None else 6)
        return head, body

    def compression_ratio(self) -> float:
        """Dense words over framed words, over every push so far."""
        if self.wire_floats == 0:
            return 1.0
        return self.dense_floats / self.wire_floats


def compress_from_args(args) -> dict:
    """``--compress int8|topk`` (with ``--compress-block`` and
    ``--compress-topk``) as the DownPour clients' keyword arguments; ``{}``
    when compression is off."""
    name = getattr(args, "compress", "") or ""
    if not name or name == "none":
        return {}
    return {"compress": name,
            "compress_opts": {"block": int(getattr(args, "compress_block", 1024)),
                              "k_frac": float(getattr(args, "compress_topk", 0.01))}}
