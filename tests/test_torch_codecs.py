"""The port's codec plane (``utils/codecs.py``) against the JAX package's, on
the same seeded numpy inputs, bit for bit:

- ``WIRE_PLANES`` equal to JAX's, plane for plane, and the loss-contract
  vocabulary and block sizes;
- ``encode_body``, ``decode_body``, ``wire_floats`` and ``int8_bound``
  equal to JAX's for every plane and every codec it admits; the int8 rung
  inside its stated bound;
- Tok16 exact over the full id range, and refusing what is not an id;
- codec ids a plane does not admit, unknown wires and dense bodies of the
  wrong size refused by both packages;
- the registry and the port's ``WIRE_SCHEMAS`` agree on the codes in the
  port's table: each code there with a ``codec`` field has a plane, and
  each plane of a code in the table names a code with that field.
"""

import dataclasses

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.utils import codecs as jcodecs
from distributed_ml_pytorch_tpu.utils import compress as jc
from distributed_ml_pytorch_tpu.utils.messaging import MessageCode as JCode
from distributed_ml_pytorch_tpu_torch.utils import codecs
from distributed_ml_pytorch_tpu_torch.utils import compress as tc
from distributed_ml_pytorch_tpu_torch.utils.messaging import WIRE_SCHEMAS, MessageCode


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


def test_planes_equal_jax_plane_for_plane():
    assert list(codecs.WIRE_PLANES) == list(jcodecs.WIRE_PLANES)
    for name, plane in codecs.WIRE_PLANES.items():
        assert dataclasses.asdict(plane) == dataclasses.asdict(jcodecs.WIRE_PLANES[name]), name
    assert codecs.CONTRACTS == jcodecs.CONTRACTS
    assert (codecs.ACT_BLOCK, codecs.DELTA_BLOCK, codecs.KV_BLOCK) == (
        jcodecs.ACT_BLOCK, jcodecs.DELTA_BLOCK, jcodecs.KV_BLOCK)
    assert codecs.CODEC_TOK16 == jcodecs.CODEC_TOK16
    assert codecs.coded_wires() == codecs.WIRE_PLANES
    assert codecs.coded_wires() is not codecs.WIRE_PLANES


@pytest.mark.parametrize("name", list(jcodecs.WIRE_PLANES))
def test_wire_plane_refuses_what_jax_refuses(name):
    plane = codecs.WIRE_PLANES[name]
    for bad in (dict(contract="lossy-ish"), dict(default_id=3)):
        for cls, ref in ((codecs.WirePlane, plane), (jcodecs.WirePlane,
                                                     jcodecs.WIRE_PLANES[name])):
            with pytest.raises(ValueError):
                cls(**{**dataclasses.asdict(ref), **bad})


def _planes_and_ids():
    return [(name, cid) for name, plane in jcodecs.WIRE_PLANES.items()
            for cid in (None, *plane.codec_ids)]


@pytest.mark.parametrize("name,cid", _planes_and_ids())
@pytest.mark.parametrize("n", [1, 37, 5000])
def test_encode_decode_and_wire_floats_equal_jax(name, cid, n):
    rng = np.random.default_rng(n)
    x = rng.normal(scale=2.0, size=n).astype(np.float32)
    x[: min(n, 10)] = np.float32(0.5)  # ties
    got, body = codecs.encode_body(MessageCode[name], x, cid)
    jgot, jbody = jcodecs.encode_body(JCode[name], x, cid)
    assert got == jgot
    _same(body, jbody)
    _same(codecs.decode_body(name, got, body, n), jcodecs.decode_body(name, jgot, jbody, n))
    assert (codecs.wire_floats(MessageCode[name], n, cid)
            == jcodecs.wire_floats(JCode[name], n, cid) == body.size)


@pytest.mark.parametrize("block", [128, 256, 1024])
def test_int8_bound_equals_jax_and_holds(block):
    rng = np.random.default_rng(block)
    x = rng.standard_normal(5 * block + 37).astype(np.float32)
    x[:block] *= 1e3
    x[block: 2 * block] = 0.0
    x[7] = 512.0
    allow = codecs.int8_bound(x, block)
    _same(allow, jcodecs.int8_bound(x, block))
    x_hat = tc.Int8Codec(block).decode(tc.Int8Codec(block).encode(x), x.size, block)
    assert (np.abs(x - x_hat) <= allow).all()


def test_tok16_is_exact_over_the_full_range_and_equals_jax():
    ids = np.arange(1 << 16, dtype=np.int64)
    for n in (ids.size, ids.size - 1):
        tok = codecs.Tok16Codec().encode(ids[:n])
        _same(tok, jcodecs.Tok16Codec().encode(ids[:n]))
        assert tok.size == codecs.Tok16Codec().wire_floats(n) == (n + 1) // 2
        out = codecs.Tok16Codec().decode(tok, n, 0)
        np.testing.assert_array_equal(out.astype(np.int64), ids[:n])
        _same(out, jcodecs.Tok16Codec().decode(tok, n, 0))


@pytest.mark.parametrize("bad", [[1.5], [-1], [1 << 16], [np.nan]])
def test_tok16_refuses_what_is_not_an_id_as_jax_does(bad):
    for codec in (codecs.Tok16Codec(), jcodecs.Tok16Codec()):
        with pytest.raises(ValueError):
            codec.encode(np.asarray(bad, np.float64))
    with pytest.raises(tc.CompressionError):
        codecs.Tok16Codec().decode(np.zeros(3, np.float32), 8, 0)


@pytest.mark.parametrize("name,cid", [("ActivationShip", tc.CODEC_TOPK),
                                      ("ActivationGrad", tc.CODEC_TOK16),
                                      ("KvMigrate", tc.CODEC_TOPK),
                                      ("CompressedUpdate", tc.CODEC_DENSE),
                                      ("DeltaParams", tc.CODEC_TOK16)])
def test_codec_ids_a_plane_does_not_admit_are_refused(name, cid):
    x = np.ones(16, np.float32)
    with pytest.raises(tc.CompressionError):
        codecs.encode_body(name, x, cid)
    with pytest.raises(jc.CompressionError):
        jcodecs.encode_body(name, x, cid)
    with pytest.raises(tc.CompressionError):
        codecs.decode_body(name, cid, x, 16)
    with pytest.raises(jc.CompressionError):
        jcodecs.decode_body(name, cid, x, 16)


def test_unknown_wires_and_wrong_dense_sizes_are_refused():
    for mod, err in ((codecs, tc.CompressionError), (jcodecs, jc.CompressionError)):
        assert mod.plane_for("GradientUpdate") is None
        for fn in (lambda: mod.encode_body("GradientUpdate", np.ones(4)),
                   lambda: mod.decode_body("GradientUpdate", 0, np.ones(4), 4),
                   lambda: mod.wire_floats("GradientUpdate", 4),
                   lambda: mod.decode_body("DeltaParams", 0, np.ones(4), 5)):
            with pytest.raises(err):
                fn()
    assert codecs.plane_for(MessageCode.DeltaParams) is codecs.plane_for("DeltaParams")


def test_the_registry_and_the_schema_table_agree_on_the_ports_codes():
    in_table = {code.name for code in WIRE_SCHEMAS}
    with_codec = {code.name for code, s in WIRE_SCHEMAS.items() if "codec" in s.fields}
    assert with_codec <= set(codecs.WIRE_PLANES)
    assert set(codecs.WIRE_PLANES) & in_table == with_codec
    assert {"CompressedUpdate", "DeltaParams", "ActivationShip", "KvMigrate"} <= with_codec
    for name, plane in codecs.WIRE_PLANES.items():
        assert plane.code_name == name and hasattr(MessageCode, name)
        for cid in plane.codec_ids:
            assert cid in tc.CODEC_NAMES
            assert cid == tc.CODEC_DENSE or cid in tc.CODECS_BY_ID
