"""The port's CIFAR-10 pipeline against the JAX package's: the same arrays
and the same batch order, bit for bit, from the same (seed, epoch)."""

import pickle

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.data import cifar10 as jd
from distributed_ml_pytorch_tpu_torch.data import cifar10 as td


def test_synthetic_arrays_identical():
    ref = jd.synthetic_cifar10(n_train=64, n_test=16, seed=3)
    out = td.synthetic_cifar10(n_train=64, n_test=16, seed=3)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_load_cifar10_synthetic_identical():
    ref = jd.load_cifar10(synthetic=True, n_train=32, n_test=8)
    out = td.load_cifar10(synthetic=True, n_train=32, n_test=8)
    assert out[4] is ref[4] is True
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,epoch,start", [(0, 0, 0), (1001, 2, 0), (7, 1, 3)])
def test_iterate_batches_order_identical(seed, epoch, start):
    x = np.arange(50 * 2, dtype=np.float32).reshape(50, 2)
    y = np.arange(50, dtype=np.int32)
    ref = list(jd.iterate_batches(x, y, 8, seed=seed, epoch=epoch, start_iter=start))
    out = list(td.iterate_batches(x, y, 8, seed=seed, epoch=epoch, start_iter=start))
    assert len(out) == len(ref) == 6 - start
    for (a, b), (c, d) in zip(out, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_pickle_loader_identical(tmp_path):
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        entry = {b"data": rng.integers(0, 256, size=(4, 3072), dtype=np.uint8),
                 b"labels": list(rng.integers(0, 10, size=4))}
        with open(d / name, "wb") as f:
            pickle.dump(entry, f)
    ref = jd.load_cifar10(root=str(tmp_path), synthetic=False)
    out = td.load_cifar10(root=str(tmp_path), synthetic=False)
    assert out[4] is ref[4] is False
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)


def test_missing_real_data_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        td.load_cifar10(root=str(tmp_path), synthetic=False)
