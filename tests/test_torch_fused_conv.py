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

SHAPES = [(2, 8, 8, 16), (3, 4, 4, 8), (2, 2, 2, 24)]


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


def test_cpu_path_counts_no_launch():
    before = dict(tfc.launches)
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    tfc.relu_pool2(x).sum().backward()
    assert tfc.launches == before

