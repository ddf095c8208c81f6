"""CIFAR-10 input pipeline (counterpart of the JAX ``data/cifar10.py``).

- loads the standard ``cifar-10-batches-py`` pickle layout from disk when
  present (the ``./data`` root convention);
- otherwise generates the same deterministic class-conditional synthetic
  stand-in as the JAX package, array for array, so the two packages train on
  identical data from the same seed;
- applies the reference's ``(x/255 - 0.5)/0.5`` normalization to [-1, 1];
- batches with a per-epoch shuffle that is a pure function of
  ``(seed, epoch)`` — the same order as the JAX package.

Arrays are numpy, NHWC; the trainer moves each batch to its device. The
JAX package's download (``download_cifar10``) and device prefetch
(``prefetch_to_device``) are not part of this package.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Iterator, Tuple

import numpy as np

CIFAR10_CLASSES = (
    "plane", "car", "bird", "cat", "deer", "dog", "frog", "horse", "ship", "truck",
)

_BATCHES_DIR = "cifar-10-batches-py"
_TARBALL = "cifar-10-python.tar.gz"


def _normalize(images_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 in [-1,1] (Normalize((0.5,)*3, (0.5,)*3))."""
    return (images_u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def _load_pickle_batches(root: str):
    """``(x_train, y_train, x_test, y_test)`` uint8 NHWC from ``root``, or
    None when the dataset is not there."""
    d = os.path.join(root, _BATCHES_DIR)
    if not os.path.isdir(d):
        tb = os.path.join(root, _TARBALL)
        if os.path.isfile(tb):
            with tarfile.open(tb, "r:gz") as tf:
                tf.extractall(root, filter="data")
        if not os.path.isdir(d):
            return None

    def read(name):
        with open(os.path.join(d, name), "rb") as f:
            entry = pickle.load(f, encoding="bytes")
        data = entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # →NHWC
        labels = np.asarray(entry[b"labels"], dtype=np.int32)
        return data, labels

    train = [read(f"data_batch_{i}") for i in range(1, 6)]
    x_train = np.concatenate([t[0] for t in train])
    y_train = np.concatenate([t[1] for t in train])
    x_test, y_test = read("test_batch")
    return x_train, y_train, x_test, y_test


def synthetic_cifar10(
    n_train: int = 50000, n_test: int = 10000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic class-conditional 32×32×3 uint8 images: a fixed
    low-frequency template per class plus per-sample noise, so a CNN can
    separate the classes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    templates = []
    for _ in range(10):
        img = np.zeros((32, 32, 3), np.float32)
        for c in range(3):
            for _k in range(3):
                fy, fx = rng.uniform(0.5, 3.0, size=2)
                ph = rng.uniform(0, 2 * np.pi, size=2)
                img[:, :, c] += rng.uniform(0.3, 1.0) * np.sin(
                    2 * np.pi * fy * yy / 32 + ph[0]
                ) * np.cos(2 * np.pi * fx * xx / 32 + ph[1])
        templates.append(img)
    templates = np.stack(templates)  # (10,32,32,3)
    templates = (templates - templates.min()) / (np.ptp(templates) + 1e-6)

    def make(n, split_seed):
        r = np.random.default_rng(split_seed)
        labels = r.integers(0, 10, size=n).astype(np.int32)
        noise = r.normal(0.0, 0.25, size=(n, 32, 32, 3)).astype(np.float32)
        imgs = np.clip(templates[labels] + noise, 0.0, 1.0)
        return (imgs * 255).astype(np.uint8), labels

    x_train, y_train = make(n_train, seed + 1)
    x_test, y_test = make(n_test, seed + 2)
    return x_train, y_train, x_test, y_test


def load_cifar10(
    root: str = "./data", synthetic: bool | None = None, seed: int = 0,
    n_train: int = 50000, n_test: int = 10000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]:
    """``(x_train, y_train, x_test, y_test, is_synthetic)``, normalized.

    ``synthetic=None`` auto-detects: the real dataset when it is on disk
    under ``root``, else the synthetic stand-in. ``synthetic=False`` with no
    dataset on disk raises ``FileNotFoundError``.
    """
    loaded = None if synthetic is True else _load_pickle_batches(root)
    if loaded is None and synthetic is False:
        raise FileNotFoundError(
            f"CIFAR-10 not found under {root!r} (no {_BATCHES_DIR}/ or {_TARBALL}); "
            "pass synthetic=True/None for the deterministic stand-in")
    if loaded is not None:
        x_train, y_train, x_test, y_test = loaded
        is_synth = False
    else:
        x_train, y_train, x_test, y_test = synthetic_cifar10(n_train, n_test, seed)
        is_synth = True
    return _normalize(x_train), y_train, _normalize(x_test), y_test, is_synth


def get_dataset(args) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CLI-facing loader (reference ``get_dataset``, ``example/main.py:23``)."""
    x_train, y_train, x_test, y_test, _ = load_cifar10(
        root=getattr(args, "data_root", "./data"),
        synthetic=True if getattr(args, "synthetic_data", False) else None,
        n_train=getattr(args, "synthetic_train_size", 50000),
        n_test=getattr(args, "synthetic_test_size", 10000),
    )
    return x_train, y_train, x_test, y_test


def iterate_batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
    start_iter: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Per-epoch shuffled minibatches (reference DataLoader semantics); the
    permutation is a pure function of ``(seed, epoch)``, so ``start_iter``
    skips ahead without materializing the skipped batches."""
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    limit = (n // batch_size) * batch_size if drop_last else n
    for start in range(start_iter * batch_size, limit, batch_size):
        sel = idx[start : start + batch_size]
        yield x[sel], y[sel]
