"""The port's compressed-push codecs (``utils/compress.py``) against the JAX
package's, on the same seeded numpy inputs. Every comparison is bit for bit
(arrays compared as their uint32 bit patterns, so NaN payloads count too)
unless a test says otherwise:

- int8 and top-k bodies and whole frames (head with CRC, with and without a
  stamp) at n in {1, 3, 1023, 1024, 1025, 2,472,266}, on random input, on
  input with magnitude ties at the top-k boundary, with blocks of zeros and
  with nonfinite elements;
- malformed frames refused with ``CompressionError`` by both packages;
- frames decoded across the packages both ways;
- a 12-push ``CompressingEncoder`` trajectory (frames and residuals) over
  ranges and stamps, and its counters;
- the error-feedback identity: the decoded pushes sum to the raw pushes less
  the final residual (within float32 addition noise, atol 1e-4 as the JAX
  test states it).
"""

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.utils import codecs as jcodecs  # noqa: F401 — Tok16 in JAX's table
from distributed_ml_pytorch_tpu.utils import compress as jc
from distributed_ml_pytorch_tpu_torch.utils import compress as tc

SIZES = [1, 3, 1023, 1024, 1025, 2_472_266]
KINDS = ["random", "ties", "zero_blocks", "nonfinite"]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _input(n, kind, seed=0):
    rng = np.random.default_rng(seed + n)
    x = rng.normal(scale=0.01, size=n).astype(np.float32)
    if kind == "ties":
        # a block of equal magnitudes (both signs) straddles the top-k cut
        k = max(1, round(0.01 * n))
        m = min(n, 2 * k + 1)
        x[:m] = np.where(np.arange(m) % 2, np.float32(0.5), np.float32(-0.5))
        x[m: m + k // 2] = 1.0
    elif kind == "zero_blocks":
        x[: min(n, 2048)] = 0.0
        if n > 3000:
            x[-1500:] = 0.0
    elif kind == "nonfinite":
        x[0] = np.nan
        if n > 1:
            x[n // 2] = np.inf
        if n > 2:
            x[-1] = -np.inf
    return x


def _codecs():
    return [(tc.Int8Codec(block=1024), jc.Int8Codec(block=1024)),
            (tc.Int8Codec(block=64), jc.Int8Codec(block=64)),
            (tc.TopKCodec(k_frac=0.01), jc.TopKCodec(k_frac=0.01)),
            (tc.TopKCodec(k_frac=0.3), jc.TopKCodec(k_frac=0.3))]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_bodies_and_frames_equal_jax(n, kind):
    x = _input(n, kind)
    for mine, ref in _codecs():
        if n == SIZES[-1] and getattr(mine, "block", 0) == 64:
            continue  # the 1024 block covers the full size
        body, jbody = mine.encode(x), ref.encode(x)
        _same(body, jbody)
        param = mine.k_for(n) if isinstance(mine, tc.TopKCodec) else mine.param
        for stamp in (None, (3, 17, 17 + n)):
            head, fbody = tc.pack_frame(mine.id, n, param, body, stamp=stamp)
            jhead, jfbody = jc.pack_frame(ref.id, n, param, jbody, stamp=stamp)
            _same(head, jhead)
            _same(fbody, jfbody)
        if kind != "nonfinite":
            _same(mine.decode(body, n, param), ref.decode(jbody, n, param))
        assert mine.wire_floats(n) == ref.wire_floats(n)
        if kind != "nonfinite":  # a NaN magnitude selects no top-k pair
            assert body.size == mine.wire_floats(n)


@pytest.mark.parametrize("n", [1, 3, 1025])
def test_tok16_frames_equal_jax(n):
    ids = np.random.default_rng(n).integers(0, 1 << 16, size=n)
    body, jbody = tc.Tok16Codec().encode(ids), jcodecs.Tok16Codec().encode(ids)
    _same(body, jbody)
    head, _ = tc.pack_frame(tc.CODEC_TOK16, n, 0, body)
    stamp, cid, out = jc.decode_update(np.concatenate([head, body]))
    assert (stamp, cid) == (None, tc.CODEC_TOK16)
    np.testing.assert_array_equal(out, ids.astype(np.float32))
    np.testing.assert_array_equal(tc.decode_update(np.concatenate([head, body]))[2], out)


def _frame(n=1025, codec="int8"):
    x = _input(n, "random")
    c = tc.make_codec(codec)
    body = c.encode(x)
    param = c.k_for(n) if codec == "topk" else c.param
    head, body = tc.pack_frame(c.id, n, param, body)
    return np.concatenate([head, body])


def _bad_frames():
    good = _frame()
    crc = good.copy()
    crc[-1] += 1.0
    short = good[:12]
    head_nan = good.copy()
    head_nan[5] = np.nan
    unknown = good.copy()
    unknown[0] = 7.0
    tc.restamp_crc(unknown, 0)
    size = good[:-1].copy()
    tc.restamp_crc(size, 0)
    topk = _frame(codec="topk")
    k = (topk.size - tc.HEAD_LEN) // 2
    out_of_range = topk.copy()
    out_of_range[tc.HEAD_LEN] = 5000.0
    tc.restamp_crc(out_of_range, 0)
    odd = topk[:-1].copy()
    tc.restamp_crc(odd, 0)
    fraction = topk.copy()
    fraction[tc.HEAD_LEN + k - 1] += 0.5
    tc.restamp_crc(fraction, 0)
    bad_block = good.copy()
    bad_block[5] = 6.0
    return {"crc": crc, "short": short, "head_nan": head_nan, "unknown_codec": unknown,
            "int8_size": size, "topk_out_of_range": out_of_range, "topk_odd": odd,
            "topk_fraction": fraction, "int8_block": bad_block}


@pytest.mark.parametrize("name", sorted(_bad_frames()))
def test_malformed_frames_are_refused_as_in_jax(name):
    frame = _bad_frames()[name]
    with pytest.raises(tc.CompressionError):
        tc.decode_update(frame)
    with pytest.raises(jc.CompressionError):
        jc.decode_update(frame)
    assert issubclass(tc.CompressionError, ValueError)


@pytest.mark.parametrize("codec", ["int8", "topk"])
@pytest.mark.parametrize("stamp", [None, (2, 100, 1125)])
def test_frames_decode_across_the_packages_both_ways(codec, stamp):
    x = _input(1025, "random", seed=4)
    for enc, dec in ((tc, jc), (jc, tc)):
        c = enc.make_codec(codec, block=256, k_frac=0.05)
        body = c.encode(x)
        param = c.k_for(x.size) if codec == "topk" else c.param
        head, body = enc.pack_frame(c.id, x.size, param, body, stamp=stamp)
        frame = np.concatenate([head, body])
        got, ref = dec.decode_update(frame), enc.decode_update(frame)
        assert got[0] == ref[0] == stamp and got[1] == ref[1] == c.id
        _same(got[2], ref[2])
        assert dec.peek_stamp(frame) == stamp
        assert dec.unpack_frame(frame)[:3] == enc.unpack_frame(frame)[:3]


def test_body_crc_and_restamp_equal_jax():
    frame = _frame()
    assert tc.body_crc(frame[12:]) == jc.body_crc(frame[12:])
    mine, ref = frame.copy(), frame.copy()
    mine[40] = ref[40] = 3.0
    tc.restamp_crc(mine, 0)
    jc.restamp_crc(ref, 0)
    _same(mine, ref)
    tc.decode_update(mine)  # silent corruption: the CRC matches again


@pytest.mark.parametrize("codec,opts", [("int8", {"block": 1024}), ("int8", {"block": 128}),
                                        ("topk", {"k_frac": 0.01}), ("topk", {"k_frac": 0.1})])
def test_encoder_trajectory_equals_jax_over_12_pushes(codec, opts):
    n = 5000
    rng = np.random.default_rng(7)
    mine = tc.CompressingEncoder(n, tc.make_codec(codec, **opts))
    ref = jc.CompressingEncoder(n, jc.make_codec(codec, **opts))
    ranges = [(0, n), (0, 2500), (2500, n)]
    for i in range(12):
        raw = rng.normal(scale=0.01 * (1 + i), size=n).astype(np.float32)
        if i == 5:
            raw[4000] = np.inf  # a diverged push: the residual restarts
        lo, hi = ranges[i % 3]
        stamp = None if i % 2 else (i, lo, hi)
        for a, b in zip(mine.encode_range(raw, lo, hi, stamp=stamp),
                        ref.encode_range(raw, lo, hi, stamp=stamp)):
            _same(a, b)
        _same(mine.residual, ref.residual)
    assert (mine.pushes, mine.wire_floats, mine.dense_floats, mine.residual_resets) == (
        ref.pushes, ref.wire_floats, ref.dense_floats, ref.residual_resets)
    assert mine.residual_resets >= 1
    assert mine.compression_ratio() == ref.compression_ratio()


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_error_feedback_identity(codec):
    n = 4096
    rng = np.random.default_rng(3)
    enc = tc.CompressingEncoder(n, tc.make_codec(codec, k_frac=0.05))
    tot_raw = np.zeros(n, np.float64)
    tot_dec = np.zeros(n, np.float64)
    for _ in range(20):
        raw = rng.normal(scale=0.01, size=n).astype(np.float32)
        head, body = enc.encode_range(raw, 0, n)
        _stamp, _cid, dec = tc.decode_update(np.concatenate([head, body]))
        tot_raw += raw
        tot_dec += dec
    np.testing.assert_allclose(tot_raw, tot_dec + enc.residual, atol=1e-4)
    off = tc.CompressingEncoder(n, tc.make_codec(codec, k_frac=0.05), error_feedback=False)
    off.encode_range(raw, 0, n)
    assert not off.residual.any()


def test_full_size_frames_match_the_stated_push_sizes():
    """AlexNet's 2,472,266 floats: an int8 push frames at 620,667 floats
    (2,415 scales, 618,240 words and the 12-float head), a top-k push of
    1 % at 2 x 24,723 pairs; each shard's half (1,236,133) at 12,361 pairs."""
    n = 2_472_266
    x = _input(n, "random")
    enc = tc.CompressingEncoder(n, tc.make_codec("int8"))
    head, body = enc.encode_range(x, 0, n)
    assert head.size + body.size == 620_667
    assert round(enc.compression_ratio(), 3) == 3.983
    top = tc.CompressingEncoder(n, tc.make_codec("topk"))
    assert top.encode_range(x, 0, n)[1].size == 2 * 24_723
    assert top.encode_range(x, 0, 1_236_133)[1].size == 2 * 12_361


def test_codec_tables_and_cli_face_equal_jax():
    assert tc.CODEC_NAMES == jc.CODEC_NAMES
    assert {k: v.__name__ for k, v in tc.CODECS_BY_ID.items()} == {
        k: v.__name__ for k, v in jc._CODECS_BY_ID.items()}
    assert tc.HEAD_LEN == jc.HEAD_LEN

    class Args:
        compress = "topk"
        compress_block = 256
        compress_topk = 0.05

    assert tc.compress_from_args(Args()) == jc.compress_from_args(Args())
    Args.compress = "none"
    assert tc.compress_from_args(Args()) == jc.compress_from_args(Args()) == {}
    for bad in (dict(block=6), dict(block=0)):
        with pytest.raises(ValueError):
            tc.Int8Codec(**bad)
    with pytest.raises(ValueError):
        tc.TopKCodec(k_frac=0.0)
    with pytest.raises(ValueError):
        tc.make_codec("fp8")
