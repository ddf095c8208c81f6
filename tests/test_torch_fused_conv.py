"""The port's relu_pool2 (K2) and max_pool_2x2 against the JAX package's.

JAX runs its Pallas kernels in interpret mode; the port runs its plain
versions (a CPU tensor's path) forward and through autograd. The forward is
bit-identical; the backward is exact: the cotangents are small integers, so
``db`` (a sum outside the kernel) is exact in any summation order too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.ops import fused_conv as jfc
from distributed_ml_pytorch_tpu_torch.ops import fused_conv as tfc

SHAPES = [(2, 8, 8, 16), (3, 4, 4, 8), (2, 2, 2, 24),
          # AlexNet's three relu->pool tails at a small batch, and an odd C
          (2, 8, 8, 64), (2, 4, 4, 192), (2, 2, 2, 256), (2, 4, 4, 37)]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, seed, ties):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if ties:  # half-step values: equal slots inside windows, and zeros after relu
        x = np.round(x * 2) / 2
    b = rng.normal(size=shape[-1]).astype(np.float32)
    pooled = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    g = rng.integers(-4, 5, size=pooled).astype(np.float32)
    return x, b, g


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_relu_pool2_fwd_and_bwd_match_jax(shape, with_bias, ties):
    x, b, g = _inputs(shape, seed=sum(shape), ties=ties)
    with jfc.force_pallas_interpret():
        if with_bias:
            m_ref, vjp = jax.vjp(jfc.relu_pool2, jnp.asarray(x), jnp.asarray(b))
            dx_ref, db_ref = vjp(jnp.asarray(g))
        else:
            m_ref, vjp = jax.vjp(jfc.relu_pool2, jnp.asarray(x))
            (dx_ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True) if with_bias else None
    m = tfc.relu_pool2(xt, bt)
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(m_ref))
    m.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_ref))
    if with_bias:
        np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(db_ref))


@pytest.mark.parametrize("shape", SHAPES[3:])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_relu_pool2_bf16_fwd_and_bwd_match_jax(shape, with_bias, ties):
    """bfloat16, bit-identical: x + b rounds to bfloat16 once on both sides,
    relu and max are exact; the cotangents are small integers, so every
    partial sum of db (at most 4 x 32 windows) is exact in bfloat16 too."""
    x, b, g = _inputs(shape, seed=sum(shape) + 1, ties=ties)
    jx, jb, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, b, g))
    with jfc.force_pallas_interpret():
        if with_bias:
            m_ref, vjp = jax.vjp(jfc.relu_pool2, jx, jb)
            dx_ref, db_ref = vjp(jg)
        else:
            m_ref, vjp = jax.vjp(jfc.relu_pool2, jx)
            (dx_ref,) = vjp(jg)

    def port(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)

    def ref(a):
        return np.asarray(a.astype(jnp.float32))

    xt = port(jx).requires_grad_(True)
    bt = port(jb).requires_grad_(True) if with_bias else None
    m = tfc.relu_pool2(xt, bt)
    assert m.dtype == torch.bfloat16
    np.testing.assert_array_equal(m.detach().float().numpy(), ref(m_ref))
    m.backward(port(jg))
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.grad.float().numpy(), ref(dx_ref))
    if with_bias:
        np.testing.assert_array_equal(bt.grad.float().numpy(), ref(db_ref))


def test_max_pool_2x2_tie_vjp_matches_jax():
    # every window ties: the cotangent must go to slot (0, 0) only
    x = np.zeros((2, 4, 4, 3), np.float32)
    x[:, ::2, 1::2, 1] = 1.0  # channel 1: slot (0, 1) is the unique max
    g = np.arange(2 * 2 * 2 * 3, dtype=np.float32).reshape(2, 2, 2, 3) + 1
    _, vjp = jax.vjp(jfc.max_pool_2x2, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    m = tfc.max_pool_2x2(xt)
    m.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    assert xt.grad[:, 0, 0, 0].ne(0).all() and xt.grad[:, 0, 1, 0].eq(0).all()


@pytest.mark.parametrize("shape", [(2, 5, 4, 3), (2, 4, 3, 3), (4, 4, 3), (0, 4, 4, 3)])
def test_relu_pool2_raises_outside_pool2_tiles(shape):
    x = torch.zeros(shape)
    assert tfc.pool2_tiles(x) == jfc.pool2_tiles(np.zeros(shape)) is False
    with pytest.raises(ValueError):
        tfc.relu_pool2(x)


@pytest.mark.parametrize("shape,ptrs,route", [
    ((64, 8, 8, 64), (0x1000, 0x2000), "vector"),
    ((1024, 2, 2, 256), (0x1000, 0x2010, 0x3020), "vector"),
    ((64, 4, 4, 37), (0x1000, 0x2000), "scalar"),       # odd C
    ((64, 4, 4, 6), (0x1000, 0x2000), "scalar"),        # C % 4 != 0
    ((64, 8, 8, 64), (0x1004, 0x2000), "scalar"),       # x one element in
    ((64, 8, 8, 64), (0x1000, 0x2008, 0x3000), "scalar"),  # a misaligned operand
    ((32767, 8, 8, 1024), (0x1000,), "vector"),         # just under 2^31 elements
])
def test_relu_pool2_route(shape, ptrs, route):
    assert tfc.relu_pool2_route(shape, torch.float32, ptrs) == route


@pytest.mark.parametrize("shape,ptrs,route", [
    # bfloat16: 8 channels a 16-byte load, so C % 8 == 0
    ((64, 8, 8, 64), (0x1000, 0x2000), "vector"),
    ((1024, 4, 4, 192), (0x1000, 0x2010, 0x3020), "vector"),
    ((1024, 2, 2, 256), (0x1000, 0x2000), "vector"),
    ((64, 4, 4, 36), (0x1000, 0x2000), "scalar"),       # C % 4 == 0 but C % 8 != 0
    ((64, 4, 4, 37), (0x1000, 0x2000), "scalar"),       # odd C
    ((64, 8, 8, 64), (0x1008, 0x2000), "scalar"),       # 8-byte aligned only
    ((64, 8, 8, 64), (0x1002, 0x2000), "scalar"),       # x one element in
])
def test_relu_pool2_route_bf16(shape, ptrs, route):
    assert tfc.relu_pool2_route(shape, torch.bfloat16, ptrs) == route


def test_relu_pool2_route_raises_beyond_its_reach():
    with pytest.raises(ValueError, match="32 bits"):
        tfc.relu_pool2_route((32768, 8, 8, 1024), torch.float32, (0x1000,))
    with pytest.raises(ValueError, match="32 bits"):
        tfc.relu_pool2_route((32768, 8, 8, 1024), torch.bfloat16, (0x1000,))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tfc.relu_pool2_route((2, 4, 4, 8), dtype, (0x1000,))


def test_relu_pool2_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.relu_pool2_fwd_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.relu_pool2_bwd_cuda(x, None, torch.zeros(2, 2, 2, 8), torch.zeros(2, 2, 2, 8))


@pytest.mark.parametrize("operand", ["m", "g"])
def test_relu_pool2_bwd_cuda_refuses_a_wrong_pooled_shape(operand):
    x = torch.zeros(2, 4, 4, 8)
    right, wrong = torch.zeros(2, 2, 2, 8), torch.zeros(2, 2, 4, 8)
    m, g = (wrong, right) if operand == "m" else (right, wrong)
    before = dict(tfc.launches)
    with pytest.raises(ValueError, match=f"{operand} must be .* pooled shape"):
        tfc.relu_pool2_bwd_cuda(x, None, m, g)
    assert tfc.launches == before


def test_cpu_path_counts_no_launch():
    before = dict(tfc.launches)
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    tfc.relu_pool2(x).sum().backward()
    assert tfc.launches == before



# ------------------------------------------------- bias_relu (K3)

BIAS_RELU_SHAPES = [(4, 37), (2, 3, 4, 16), (16, 8)]


def _bias_relu_inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    x[0, ..., 0] = -b[0]  # z = x + b = 0 exactly: relu and its gradient give 0
    # small integer cotangents: db is exact in any summation order (|sum| <=
    # 96 < 256, so exact in bfloat16 too)
    g = rng.integers(-4, 5, size=shape).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    j = [jnp.asarray(a, jdt) for a in (x, b, g)]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in j]
    return j, t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("shape", BIAS_RELU_SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_relu_fwd_and_vjp_match_jax(shape, with_bias, dtype):
    # bit-identical: the same add (rounded to the dtype) and compare
    (jx, jb, jg), (tx, tb, tg) = _bias_relu_inputs(shape, sum(shape), dtype)
    with jfc.force_pallas_interpret():
        if with_bias:
            y_ref, vjp = jax.vjp(jfc.bias_relu, jx, jb)
            dx_ref, db_ref = vjp(jg)
        else:
            y_ref, vjp = jax.vjp(jfc.bias_relu, jx)
            (dx_ref,) = vjp(jg)
    xt = tx.requires_grad_(True)
    bt = tb.requires_grad_(True) if with_bias else None
    y = tfc.bias_relu(xt, bt)
    assert y.dtype == tx.dtype
    np.testing.assert_array_equal(_np(y), _np(y_ref))
    y.backward(tg)
    np.testing.assert_array_equal(_np(xt.grad), _np(dx_ref))
    if with_bias:
        np.testing.assert_array_equal(_np(bt.grad), _np(db_ref))
        assert float(xt.grad[0, ..., 0].abs().sum()) == 0.0  # gradient at z = 0 is 0


def test_bias_relu_plain_versions_and_cpu_counts():
    (_, _, _), (x, b, g) = _bias_relu_inputs((5, 6), 0, "float32")
    before = dict(tfc.launches)
    y = tfc.bias_relu_fwd_plain(x, b)
    assert torch.equal(y, torch.relu(x + b))
    dz = tfc.bias_relu_bwd_plain(x, b, g)
    assert torch.equal(dz, torch.where(x + b > 0, g, torch.zeros(())))
    assert torch.equal(tfc.bias_relu_fwd_plain(x), torch.relu(x))
    # bias without requires_grad: no db, and the CPU path launches nothing
    xr = x.clone().requires_grad_(True)
    tfc.bias_relu(xr, b).backward(g)
    assert torch.equal(xr.grad, dz) and b.grad is None
    assert tfc.launches == before
    from distributed_ml_pytorch_tpu_torch import ops

    assert ops.bias_relu is tfc.bias_relu
