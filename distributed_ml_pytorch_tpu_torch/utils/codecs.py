"""The codec plane: one registry of the coded wires (counterpart of the JAX
``utils/codecs.py``; numpy only).

Every ``WIRE_SCHEMAS`` code that carries a ``codec`` field has a
:class:`WirePlane` here: the codec ids that may ride it, its loss contract,
and the codec parameter both ends share (so a frame's head needs one codec
id, not a parameter block).

Loss contracts:

- ``exact`` — ``decode(encode(x)) == x`` bit for bit (``CODEC_DENSE``, and
  ``Tok16Codec`` for integer ids);
- ``bounded`` — elementwise ``|x - x̂| <= scale_block / 2`` with
  ``scale_block = max(absmax_block, 1e-12) / 127`` (int8 per block,
  :func:`int8_bound`); one-shot payloads carry no residual, so the bound is
  the whole guarantee;
- ``error-feedback`` — each frame lossy, the receiver's running sum exact:
  what frame t could not represent rides frame t+1 (``CompressingEncoder``
  for pushes; the server's per-worker pull base for delta replies, where
  ``base + decoded == central - residual`` holds by construction).

    plane = codecs.plane_for(MessageCode.ActivationShip)
    cid, body = codecs.encode_body(MessageCode.ActivationShip, acts)
    x_hat = codecs.decode_body(MessageCode.ActivationShip, cid, body, n=acts.size)
    assert (abs(acts - x_hat) <= codecs.int8_bound(acts, plane.param)).all()

The codec classes live in ``utils/compress.py``, whose decode table holds
all of them (``CODECS_BY_ID``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.utils.compress import (
    CODEC_DENSE,
    CODEC_INT8,
    CODEC_TOK16,
    CODEC_TOPK,
    CompressionError,
    Int8Codec,
    Tok16Codec,
    TopKCodec,
)

#: the loss-contract vocabulary
CONTRACTS = ("exact", "bounded", "error-feedback")


@dataclasses.dataclass(frozen=True)
class WirePlane:
    """One coded wire: which codec ids may ride it, under what loss
    contract, and the codec parameter both ends share."""

    code_name: str            # the MessageCode member's name (the schema key)
    contract: str             # one of CONTRACTS
    codec_ids: Tuple[int, ...]  # the codec ids this wire admits
    default_id: int           # what encode_body picks when none is named
    param: int                # the shared codec parameter (int8 block size)
    k_frac: float             # the top-k fraction where CODEC_TOPK is admitted
    bound: Optional[str]      # the stated bound, for bounded planes
    fallback: str             # what restores exactness when the lossy rung fails

    def __post_init__(self):
        if self.contract not in CONTRACTS:
            raise ValueError(f"unknown loss contract {self.contract!r} "
                             f"(vocabulary: {CONTRACTS})")
        if self.default_id not in self.codec_ids:
            raise ValueError(f"default codec {self.default_id} not admissible on "
                             f"{self.code_name} ({self.codec_ids})")


#: int8 block sizes per plane: small enough that one activation outlier
#: cannot crush a whole microbatch's resolution, large enough that the
#: per-block float32 scale stays a rounding error of the wire
ACT_BLOCK = 256
DELTA_BLOCK = 1024
KV_BLOCK = 128

_INT8_BOUND = "|x - x̂| <= max(absmax_block, 1e-12)/127 / 2 per element"

#: every WIRE_SCHEMAS code with a ``codec`` field, and nothing else
WIRE_PLANES: Dict[str, WirePlane] = {
    "CompressedUpdate": WirePlane(
        code_name="CompressedUpdate", contract="error-feedback",
        codec_ids=(CODEC_INT8, CODEC_TOPK), default_id=CODEC_INT8,
        param=DELTA_BLOCK, k_frac=0.01, bound=None,
        fallback="per-worker CompressingEncoder residual (what a push "
                 "could not represent rides the next push)"),
    "ActivationShip": WirePlane(
        code_name="ActivationShip", contract="bounded",
        codec_ids=(CODEC_DENSE, CODEC_INT8), default_id=CODEC_INT8,
        param=ACT_BLOCK, k_frac=0.0, bound=_INT8_BOUND,
        fallback="token/target/loss kinds ride CODEC_DENSE (exact); "
                 "int8 is legal for activations only"),
    "ActivationGrad": WirePlane(
        code_name="ActivationGrad", contract="bounded",
        codec_ids=(CODEC_DENSE, CODEC_INT8), default_id=CODEC_INT8,
        param=ACT_BLOCK, k_frac=0.0, bound=_INT8_BOUND,
        fallback="CODEC_DENSE (exact) when the stage is configured "
                 "uncompressed"),
    "DeltaParams": WirePlane(
        code_name="DeltaParams", contract="error-feedback",
        codec_ids=(CODEC_DENSE, CODEC_INT8, CODEC_TOPK),
        default_id=CODEC_TOPK, param=DELTA_BLOCK, k_frac=0.02, bound=None,
        fallback="full dense reply (CODEC_DENSE install) on version "
                 "miss, epoch change, restore, or rebalance — the "
                 "drill/manifest machinery only ever sees bit-exact "
                 "installs"),
    "KvMigrate": WirePlane(
        code_name="KvMigrate", contract="bounded",
        codec_ids=(CODEC_DENSE, CODEC_INT8), default_id=CODEC_INT8,
        param=KV_BLOCK, k_frac=0.0,
        bound="|kv - k̂v| <= max(absmax_block, 1e-12)/127 / 2 per element",
        fallback="token history rides Tok16 (exact) in the same frame; "
                 "the resumed stream re-prefills from it, so token "
                 "identity never depends on the KV rung"),
}


def plane_for(code) -> Optional[WirePlane]:
    """The plane of a MessageCode (or of its name), else None."""
    return WIRE_PLANES.get(str(getattr(code, "name", code)))


def coded_wires() -> Dict[str, WirePlane]:
    """Name -> plane for every coded wire (a copy)."""
    return dict(WIRE_PLANES)


def _plane(code) -> WirePlane:
    plane = plane_for(code)
    if plane is None:
        raise CompressionError(f"{getattr(code, 'name', code)} is not a registered coded "
                               "wire (utils/codecs.WIRE_PLANES)")
    return plane


def _admitted(plane: WirePlane, codec_id) -> int:
    cid = int(codec_id)
    if cid not in plane.codec_ids:
        raise CompressionError(f"codec id {cid} is not admissible on {plane.code_name} "
                               f"(allowed: {plane.codec_ids})")
    return cid


def _instance(codec_id: int, plane: WirePlane):
    if codec_id == CODEC_INT8:
        return Int8Codec(block=plane.param)
    if codec_id == CODEC_TOPK:
        return TopKCodec(k_frac=plane.k_frac)
    if codec_id == CODEC_TOK16:
        return Tok16Codec()
    raise CompressionError(f"unknown codec id {codec_id}")


def encode_body(code, x: np.ndarray, codec_id: Optional[int] = None) -> Tuple[int, np.ndarray]:
    """``(codec_id, body)`` of ``x`` on the wire ``code``; ``codec_id=None``
    takes the plane's default, and an id the plane does not admit raises."""
    plane = _plane(code)
    cid = _admitted(plane, plane.default_id if codec_id is None else codec_id)
    x = np.asarray(x, np.float32).ravel()
    if cid == CODEC_DENSE:
        return cid, x
    return cid, _instance(cid, plane).encode(x)


def decode_body(code, codec_id: int, body: np.ndarray, n: int) -> np.ndarray:
    """The decoded ``n`` elements of one body on the wire ``code``, with the
    plane's parameter; an id the plane does not admit is a malformed frame."""
    plane = _plane(code)
    cid = _admitted(plane, codec_id)
    body = np.asarray(body, np.float32).ravel()
    if cid == CODEC_DENSE:
        if body.size != n:
            raise CompressionError(f"dense body holds {body.size} floats, expected {n}")
        return body.copy()
    return _instance(cid, plane).decode(body, n, plane.param)


def wire_floats(code, n: int, codec_id: Optional[int] = None) -> int:
    """The exact body floats of one frame of ``n`` elements on the wire
    ``code`` under ``codec_id`` (default: the plane's)."""
    plane = _plane(code)
    cid = plane.default_id if codec_id is None else int(codec_id)
    if cid == CODEC_DENSE:
        return int(n)
    return int(_instance(cid, plane).wire_floats(int(n)))


def int8_bound(x: np.ndarray, block: int) -> np.ndarray:
    """The per-element error allowance of int8 per block over ``x``:
    ``scale_block / 2`` repeated over each block's elements."""
    x = np.asarray(x, np.float32).ravel()
    n = x.size
    nblocks = -(-n // block)
    padded = np.zeros(nblocks * block, np.float32)
    padded[:n] = x
    absmax = np.max(np.abs(padded.reshape(nblocks, block)), axis=1)
    scales = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
    return np.repeat(scales / 2.0, block)[:n]
