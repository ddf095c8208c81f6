"""The port's flat_axpy (K1) against the JAX package's, bit for bit.

The JAX side runs its Pallas kernel in interpret mode (lane-aligned lengths)
or its XLA path (ragged lengths), as its own tests do; the port runs its
plain PyTorch version, which is what a CPU tensor takes. On the card the
CUDA kernel is held against the same plain version
(``tests/test_torch_gpu.py``, and ``chip_smoke.py`` at the main path's
shapes).
"""

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.ops import fused_update as jfu
from distributed_ml_pytorch_tpu_torch.ops import fused_update as tfu

ALEXNET_PADDED = 2_472_320


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _vecs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("n", [128, 128 * 37, 1000, ALEXNET_PADDED])
@pytest.mark.parametrize("alpha", [1.0, -0.008, 0.37])
def test_flat_axpy_bit_identical_to_jax(n, alpha):
    """Bit-identical to the JAX function's op-by-op path (two roundings) for
    every alpha, and to its Pallas kernel in interpret mode at the
    production alpha = 1.0. For other alphas XLA's CPU compiler contracts
    the interpreted kernel body into one FMA (one rounding): there the two
    differ by no more than the product's rounding plus the sum's — one ulp
    of ``alpha*x`` plus one ulp of the result."""
    y, x = _vecs(n, seed=n)
    yt = torch.from_numpy(y.copy())
    out = tfu.flat_axpy(yt, torch.from_numpy(x), alpha)
    assert out is yt  # in place, as the TPU kernel aliases y
    eager = np.asarray(jfu.flat_axpy(y, x, alpha)) if n % 128 else (
        y + np.float32(alpha) * x)
    np.testing.assert_array_equal(out.numpy(), eager)
    with jfu.force_pallas_interpret():
        interp = np.asarray(jfu.flat_axpy(y, x, alpha))
    if alpha == 1.0 or n % 128:
        np.testing.assert_array_equal(out.numpy(), interp)
    else:
        got = out.numpy()
        bound = np.spacing(np.abs(np.float32(alpha) * x)) + np.spacing(np.abs(got))
        assert (np.abs(got - interp) <= bound).all()
        assert (got != interp).mean() < 0.5  # most elements agree bit for bit


def test_downpour_accumulate_matches_jax():
    y, x = _vecs(128 * 5, seed=3)
    ref = np.asarray(jfu.downpour_accumulate(y, x, 0.008))
    out = tfu.downpour_accumulate(torch.from_numpy(y.copy()), torch.from_numpy(x), 0.008)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cpu_path_counts_no_launch_and_rejects_bad_shapes():
    before = tfu.launches
    tfu.flat_axpy(torch.zeros(256), torch.ones(256), 1.0)
    assert tfu.launches == before
    assert tfu.LANES == jfu.LANES
    with pytest.raises(ValueError):
        tfu.flat_axpy(torch.zeros(8), torch.zeros(9), 1.0)
    with pytest.raises(TypeError):
        tfu.flat_axpy(torch.zeros(8, dtype=torch.float64), torch.zeros(8), 1.0)
    with pytest.raises(ValueError):
        tfu.flat_axpy_cuda(torch.zeros(8), torch.zeros(8), 1.0)

