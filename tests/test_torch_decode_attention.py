"""The port's decode attention (K8's function) against the JAX package's, on
the CPU.

The JAX side runs ``decode_attention_step`` (the Pallas kernel) in interpret
mode and the XLA blocked-decode math (``_xla_reference`` below, the
expression of ``tests/test_decode_attention.py``); the port runs
``decode_attention_step`` on CPU tensors, which is its reference. Inputs come
from numpy. Tolerance (float32): 2e-5 relative and 2e-6 absolute, the JAX
test's; the sums run in other orders. ``quantize_kv`` must be bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models.transformer import quantize_kv as jquantize
from distributed_ml_pytorch_tpu.ops.decode_attention import decode_attention_step as jstep
from distributed_ml_pytorch_tpu.ops.fused_update import force_pallas_interpret
from distributed_ml_pytorch_tpu_torch.models.transformer import quantize_kv
from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da

TOL = dict(rtol=2e-5, atol=2e-6)
B, H, C, T, D = 3, 4, 40, 16, 32


def _xla_reference(q, k_new, v_new, big_k, big_v, ring_k, ring_v, t, ring_base,
                   scale_k=None, scale_v=None):
    """The JAX blocked-decode step's math (transformer.py:300-330)."""
    d = q.shape[-1]
    scale = jnp.sqrt(jnp.asarray(d, jnp.float32))
    C, T = big_k.shape[2], ring_k.shape[2]
    s_big = jnp.einsum("bhsd,bhcd->bhsc", q, big_k.astype(q.dtype),
                       preferred_element_type=jnp.float32)
    if scale_k is not None:
        s_big = s_big * scale_k[:, :, None, :]
    s_big = jnp.where((jnp.arange(C) < ring_base)[None, None, None, :], s_big, -jnp.inf)
    s_ring = jnp.einsum("bhsd,bhtd->bhst", q, ring_k, preferred_element_type=jnp.float32)
    s_ring = jnp.where((jnp.arange(T) < t)[None, None, None, :], s_ring, -jnp.inf)
    s_self = jnp.einsum("bhsd,bhsd->bhs", q, k_new, preferred_element_type=jnp.float32)
    scores = jnp.concatenate([s_big, s_ring, s_self[..., None]], axis=-1) / scale
    probs = jax.nn.softmax(scores, axis=-1)
    p_big = probs[..., :C]
    if scale_v is not None:
        p_big = p_big * scale_v[:, :, None, :]
    out = (jnp.einsum("bhsc,bhcd->bhsd", p_big.astype(q.dtype), big_v.astype(q.dtype),
                      preferred_element_type=jnp.float32)
           + jnp.einsum("bhst,bhtd->bhsd", probs[..., C:C + T].astype(q.dtype), ring_v,
                        preferred_element_type=jnp.float32)
           + probs[..., C + T:].astype(jnp.float32) * v_new)
    return out.astype(q.dtype)


def _inputs(quant, seed=0):
    """numpy inputs; under ``quant`` the big cache is JAX's int8 + scales."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, H, 1, D)).astype(np.float32) for _ in range(3)]
    arrs += [rng.normal(size=(B, H, C, D)).astype(np.float32) for _ in range(2)]
    arrs += [rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(2)]
    q, kn, vn, bk, bv, rk, rv = arrs
    sk = sv = None
    if quant:
        (bk, sk), (bv, sv) = jquantize(jnp.asarray(bk)), jquantize(jnp.asarray(bv))
        bk, sk, bv, sv = map(np.asarray, (bk, sk, bv, sv))
    return q, kn, vn, bk, bv, rk, rv, sk, sv


def _torch(arrs):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrs]


def _jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_matches_jax_kernel_and_xla_math(quant):
    q, kn, vn, bk, bv, rk, rv, sk, sv = _inputs(quant)
    t, ring_base = 5, 32
    jargs = _jax([q, kn, vn, bk, bv, rk, rv])
    want_xla = np.asarray(_xla_reference(*jargs, jnp.asarray(t), jnp.asarray(ring_base),
                                         *_jax([sk, sv])))
    with force_pallas_interpret():
        want_kernel = np.asarray(jstep(*jargs, jnp.asarray(t), jnp.asarray(ring_base),
                                       *_jax([sk, sv])))
    before = da.launches
    got = da.decode_attention_step(*_torch([q, kn, vn, bk, bv, rk, rv]), t, ring_base,
                                   *_torch([sk, sv]))
    assert da.launches == before  # a CPU tensor takes the reference
    assert got.shape == (B, H, 1, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_xla, **TOL)
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_per_row_state_matches_jax_row_by_row(quant):
    q, kn, vn, bk, bv, rk, rv, sk, sv = _inputs(quant, seed=1)
    t = np.asarray([0, 7, 16], np.int32)
    ring_base = np.asarray([40, 0, 23], np.int32)
    got = da.decode_attention_step(*_torch([q, kn, vn, bk, bv, rk, rv]),
                                   torch.from_numpy(t), torch.from_numpy(ring_base),
                                   *_torch([sk, sv])).numpy()
    for r in range(B):
        row = lambda a: None if a is None else jnp.asarray(a[r:r + 1])
        jargs = [row(a) for a in (q, kn, vn, bk, bv, rk, rv)]
        with force_pallas_interpret():
            want = jstep(*jargs, jnp.asarray(t[r]), jnp.asarray(ring_base[r]),
                         row(sk), row(sv))
        np.testing.assert_allclose(got[r:r + 1], np.asarray(want), err_msg=f"row {r}", **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 16, 32)).astype(np.float32) * 0.3
    # rows whose absmax is 127 quantize with scale 1, so x / scale is x and
    # the .5 ties must round half to even; an all-zero row hits the 1e-8 floor
    x[0, 0, 0] = np.r_[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, np.zeros(26)]
    x[0, 0, 1] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jq, js = jquantize(jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tq, ts = quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tq[0, 0, 0, :6]) == [127, 2, -4, 0, 0, 2]
    assert float(ts[0, 0, 1]) == np.float32(1e-8)


def test_error_scale_bounds_the_bf16_roundings():
    # the reference in bfloat16 against the same inputs in float32: each
    # weight (and the output) rounds at 2^-8, within 2^-6 of the absolute
    # product (the card's kernel is held there against the reference)
    q, kn, vn, bk, bv, rk, rv, _, _ = _inputs(False, seed=3)
    args32 = _torch([q, kn, vn, bk, bv, rk, rv])
    args16 = [a.to(torch.bfloat16) for a in args32]
    exact = da.decode_attention_reference(*[a.float() for a in args16], 9, 30)
    bf16 = da.decode_attention_reference(*args16, 9, 30)
    scale = da.decode_error_scale(*[a.float() for a in args16], 9, 30)
    err = (bf16.float() - exact).abs()
    assert bool((err <= 1e-6 + 2.0 ** -6 * scale).all()), float((err / scale).max())
    assert float((err / scale).max()) > 2.0 ** -12  # the roundings are there


def test_reference_rejects_bad_row_state():
    q, kn, vn, bk, bv, rk, rv, _, _ = _inputs(False)
    with pytest.raises(ValueError, match="per-row"):
        da.decode_attention_step(*_torch([q, kn, vn, bk, bv, rk, rv]),
                                 torch.zeros(2, dtype=torch.int32), 3)
