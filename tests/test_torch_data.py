"""The port's CIFAR-10 pipeline against the JAX package's: the same arrays
and the same batch order, bit for bit, from the same (seed, epoch); the same
per-process shards; a download from a ``file://`` tarball built here (never
the network) installs, loads as JAX loads it and refuses a checksum
mismatch; device prefetch hands over the batches unchanged."""

import glob
import hashlib
import io
import os
import pickle
import tarfile

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("n,count", [(50, 1), (50, 3), (64, 8), (7, 2)])
def test_shard_for_process_identical(n, count):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.int32)
    for r in range(count):
        out = td.shard_for_process(x, y, r, count)
        ref = jd.shard_for_process(x, y, r, count)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


def _fake_archive(path, n_train_per_batch=4, n_test=4):
    """A CIFAR-10-layout tarball of random pixels; returns its md5."""
    rng = np.random.default_rng(0)
    with tarfile.open(path, "w:gz") as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            n = n_test if name == "test_batch" else n_train_per_batch
            blob = pickle.dumps({b"data": rng.integers(0, 256, size=(n, 3072), dtype=np.uint8),
                                 b"labels": rng.integers(0, 10, size=n).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def test_download_installs_and_loads_as_jax_does(tmp_path):
    src = tmp_path / "src.tar.gz"
    md5 = _fake_archive(str(src))
    root = str(tmp_path / "data")
    d = td.download_cifar10(root, url=src.as_uri(), md5=md5)
    assert os.path.isdir(d) and d == os.path.join(root, "cifar-10-batches-py")
    out = td.load_cifar10(root=root, synthetic=False)
    ref = jd.load_cifar10(root=root, synthetic=False)
    assert out[4] is ref[4] is False and out[0].shape == (20, 32, 32, 3)
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    # a second call finds everything installed
    assert td.download_cifar10(root, url=src.as_uri(), md5=md5) == d


def test_download_refuses_a_checksum_mismatch(tmp_path):
    src = tmp_path / "src.tar.gz"
    _fake_archive(str(src))
    root = str(tmp_path / "data")
    with pytest.raises(ValueError, match="checksum mismatch"):
        td.download_cifar10(root, url=src.as_uri(), md5="0" * 32)
    assert not os.path.exists(os.path.join(root, "cifar-10-python.tar.gz"))
    assert not glob.glob(os.path.join(root, "*.part"))
    assert not glob.glob(os.path.join(root, "*.extract"))
    assert not os.path.isdir(os.path.join(root, "cifar-10-batches-py"))


def test_download_replaces_a_corrupt_tarball(tmp_path):
    src = tmp_path / "src.tar.gz"
    md5 = _fake_archive(str(src))
    root = tmp_path / "data"
    root.mkdir()
    (root / "cifar-10-python.tar.gz").write_bytes(b"torn")
    td.download_cifar10(str(root), url=src.as_uri(), md5=md5)
    assert hashlib.md5((root / "cifar-10-python.tar.gz").read_bytes()).hexdigest() == md5


def test_download_flag_fetches_or_falls_back(tmp_path, monkeypatch):
    src = tmp_path / "src.tar.gz"
    md5 = _fake_archive(str(src))
    monkeypatch.setattr(td, "CIFAR10_URL", src.as_uri())
    monkeypatch.setattr(td, "CIFAR10_MD5", md5)
    *_, synth = td.load_cifar10(root=str(tmp_path / "a"), synthetic=False)
    assert synth is False
    monkeypatch.setattr(td, "CIFAR10_URL", (tmp_path / "missing.tar.gz").as_uri())
    *_, synth = td.load_cifar10(root=str(tmp_path / "b"), download=True, n_train=8, n_test=4)
    assert synth is True
    with pytest.raises(FileNotFoundError, match="download failed"):
        td.load_cifar10(root=str(tmp_path / "c"), synthetic=False)


def test_prefetch_hands_over_the_batches_unchanged():
    x = np.random.default_rng(0).normal(size=(40, 32, 32, 3)).astype(np.float32)
    y = np.arange(40, dtype=np.int32) % 10
    plain = list(td.iterate_batches(x, y, 8, seed=1))
    for size in (1, 2, 5):
        got = list(td.prefetch_to_device(td.iterate_batches(x, y, 8, seed=1), size, "cpu"))
        assert len(got) == len(plain)
        for (a, b), (c, d) in zip(got, plain):
            assert a.dtype == torch.float32 and b.dtype == torch.int64
            np.testing.assert_array_equal(a.numpy(), c)
            np.testing.assert_array_equal(b.numpy(), d)
