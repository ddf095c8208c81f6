"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips without a card (decided in the
``cuda`` fixture, never at import). This file imports neither JAX nor the
JAX package, nor needs ``tests/conftest.py``, so it runs on a machine with
PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu_torch.ops import fused_conv as tfc
from distributed_ml_pytorch_tpu_torch.ops import fused_update as tfu

ALEXNET_PADDED = 2_472_320


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _vecs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 128, 1001, ALEXNET_PADDED])
@pytest.mark.parametrize("alpha", [1.0, -0.008, 0.37])
def test_flat_axpy_kernel_bit_identical(cuda, n, alpha):
    y, x = _vecs(n, seed=n)
    ref = tfu.flat_axpy_plain(torch.from_numpy(y.copy()), torch.from_numpy(x), alpha)
    yk, xk = torch.from_numpy(y).to(cuda), torch.from_numpy(x).to(cuda)
    before = tfu.launches
    out = tfu.flat_axpy(yk, xk, alpha)
    assert out is yk and tfu.launches == before + 1
    # views one element in: not 16-byte aligned, the scalar variant
    yo = torch.from_numpy(np.concatenate([[0.0], y]).astype(np.float32)).to(cuda)
    xo = torch.from_numpy(np.concatenate([[0.0], x]).astype(np.float32)).to(cuda)
    tfu.flat_axpy(yo[1:], xo[1:], alpha)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(yk.cpu().numpy(), ref.numpy())
    np.testing.assert_array_equal(yo[1:].cpu().numpy(), ref.numpy())


def _pool_inputs(shape, seed, ties):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2
    b = rng.normal(size=shape[-1]).astype(np.float32)
    pooled = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    g = rng.integers(-4, 5, size=pooled).astype(np.float32)
    return x, b, g


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 8, 8, 64), (64, 4, 4, 192), (64, 2, 2, 256),
                                   (3, 6, 10, 5)])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_relu_pool2_kernels_match_plain(cuda, shape, ties, with_bias):
    x, b, g = _pool_inputs(shape, seed=1, ties=ties)
    xc = torch.from_numpy(x).to(cuda).requires_grad_(True)
    bc = torch.from_numpy(b).to(cuda).requires_grad_(True) if with_bias else None
    before = dict(tfc.launches)
    m = tfc.relu_pool2(xc, bc)
    m.backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert tfc.launches["relu_pool2_fwd"] == before["relu_pool2_fwd"] + 1
    assert tfc.launches["relu_pool2_bwd"] == before["relu_pool2_bwd"] + 1
    xr = torch.from_numpy(x).requires_grad_(True)
    br = torch.from_numpy(b).requires_grad_(True) if with_bias else None
    mr = tfc.relu_pool2(xr, br)
    mr.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(m.detach().cpu().numpy(), mr.detach().numpy())
    np.testing.assert_array_equal(xc.grad.cpu().numpy(), xr.grad.numpy())
    if with_bias:
        np.testing.assert_array_equal(bc.grad.cpu().numpy(), br.grad.numpy())


@pytest.mark.gpu
def test_relu_pool2_rejects_non_contiguous(cuda):
    x = torch.randn(2, 4, 4, 8, device=cuda).permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.relu_pool2(x)


@pytest.mark.gpu
def test_alexnet_fused_and_unfused_steps_agree(cuda):
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD, make_train_step
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    full_float32()
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(16, 32, 32, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 10, size=16)).to(cuda)
    flats, losses = [], []
    for fused in (True, False):
        model = get_model("alexnet", fused_epilogue=fused, device=cuda)
        step = make_train_step(model, SGD(0.008))
        losses.append([float(step(x, y)) for _ in range(3)])
        flats.append(ravel_model_params(model))
    assert losses[0] == losses[1]
    assert torch.equal(flats[0], flats[1])
