"""CIFAR-10 input pipeline (counterpart of the JAX ``data/cifar10.py``).

- loads the standard ``cifar-10-batches-py`` pickle layout from disk when
  present (the ``./data`` root convention);
- otherwise generates the same deterministic class-conditional synthetic
  stand-in as the JAX package, array for array, so the two packages train on
  identical data from the same seed;
- applies the reference's ``(x/255 - 0.5)/0.5`` normalization to [-1, 1];
- batches with a per-epoch shuffle that is a pure function of
  ``(seed, epoch)`` — the same order as the JAX package;
- fetches the real tarball on request (:func:`download_cifar10`:
  md5-verified, installed atomically), shards it per process
  (:func:`shard_for_process`) and keeps batches' host→device copies in
  flight ahead of compute (:func:`prefetch_to_device`).

Arrays are numpy, NHWC; the trainer moves each batch to its device.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import pickle
import shutil
import tarfile
from typing import Iterator, Tuple

import numpy as np
import torch

CIFAR10_CLASSES = (
    "plane", "car", "bird", "cat", "deer", "dog", "frog", "horse", "ship", "truck",
)

_BATCHES_DIR = "cifar-10-batches-py"
_TARBALL = "cifar-10-python.tar.gz"

# the canonical distribution and its published md5 (the pair torchvision's
# CIFAR10(download=True) verifies against)
CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"


def _file_md5(path: str) -> str:
    digest = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def download_cifar10(root: str, url: str | None = None, md5: str | None = None,
                     timeout: float = 30.0) -> str:
    """Fetch the CIFAR-10 tarball into ``root``, verify its md5, install it
    atomically (a per-process ``.part`` file, then ``os.replace``), extract
    it (into a private directory, then one rename) and return the batches
    directory. A tarball already there with the wrong md5 is removed and
    fetched again. Raises on a network failure or a checksum mismatch.

    ``url`` may be any scheme urllib reads (``file://`` in the tests)."""
    import urllib.request

    url = CIFAR10_URL if url is None else url
    md5 = CIFAR10_MD5 if md5 is None else md5
    os.makedirs(root, exist_ok=True)
    dest = os.path.join(root, _TARBALL)
    if os.path.isfile(dest) and md5 and _file_md5(dest) != md5:
        with contextlib.suppress(FileNotFoundError):
            os.remove(dest)
    if not os.path.isfile(dest):
        part = f"{dest}.{os.getpid()}.part"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp, open(part, "wb") as f:
                shutil.copyfileobj(resp, f)
            if md5:
                digest = _file_md5(part)
                if digest != md5:
                    raise ValueError(f"checksum mismatch for {url}: got {digest}, want {md5} "
                                     f"— refusing to install")
            os.replace(part, dest)
        finally:
            if os.path.exists(part):
                os.remove(part)
    d = os.path.join(root, _BATCHES_DIR)
    if os.path.isdir(d):
        return d
    tmp_extract = f"{d}.{os.getpid()}.extract"
    with tarfile.open(dest, "r:gz") as tf:
        tf.extractall(tmp_extract, filter="data")
    extracted = os.path.join(tmp_extract, _BATCHES_DIR)
    if not os.path.isdir(extracted):
        shutil.rmtree(tmp_extract, ignore_errors=True)
        raise FileNotFoundError(f"archive at {dest} did not contain {_BATCHES_DIR}/")
    try:
        os.rename(extracted, d)
    except OSError:
        if not os.path.isdir(d):  # a real failure, not another process's win
            raise
    finally:
        shutil.rmtree(tmp_extract, ignore_errors=True)
    return d


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
    n_train: int = 50000, n_test: int = 10000, download: bool | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]:
    """``(x_train, y_train, x_test, y_test, is_synthetic)``, normalized.

    ``synthetic=None`` auto-detects: the real dataset when it is on disk
    under ``root``, else the synthetic stand-in. ``download=None`` fetches
    it (:func:`download_cifar10`) exactly when real data was demanded
    (``synthetic=False``) and is not on disk; ``download=True`` tries under
    auto-detect too and falls back to the stand-in when the fetch fails.
    ``synthetic=False`` with no dataset raises ``FileNotFoundError``.
    """
    loaded = None
    if synthetic is not True:
        loaded = _load_pickle_batches(root)
        if loaded is None and (download or (download is None and synthetic is False)):
            try:
                download_cifar10(root)
                loaded = _load_pickle_batches(root)
            except Exception as e:
                if synthetic is False:
                    raise FileNotFoundError(
                        f"CIFAR-10 not under {root!r} and download failed: {e}") from e
        if loaded is None and synthetic is False:
            raise FileNotFoundError(
                f"CIFAR-10 not found under {root!r} (no {_BATCHES_DIR}/ or {_TARBALL}); "
                "pass download=True, or synthetic=True/None for the deterministic stand-in")
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
        download=True if getattr(args, "download", False) else None,
    )
    return x_train, y_train, x_test, y_test


def shard_for_process(x: np.ndarray, y: np.ndarray, process_index: int,
                      process_count: int) -> Tuple[np.ndarray, np.ndarray]:
    """Strided per-process shard: process r takes elements r, r + P, r + 2P,
    ... of the first ``len(x) // P · P``."""
    n = (len(x) // process_count) * process_count
    return x[process_index:n:process_count], y[process_index:n:process_count]


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


def _host_batch(batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """A numpy ``(images, labels)`` pair as float32 and int64 tensors."""
    bx, by = batch
    return (torch.from_numpy(np.ascontiguousarray(bx, np.float32)),
            torch.from_numpy(np.asarray(by, np.int64)))


def prefetch_to_device(it: Iterator[Tuple[np.ndarray, np.ndarray]], size: int = 2,
                       device="cuda") -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """``(images, labels)`` tensors on ``device`` with ``size`` batches'
    copies in flight: each batch is pinned and copied ``non_blocking`` on a
    side stream, and the consumer's stream waits for that copy before the
    batch is handed over, so the copy of the next batches overlaps the
    current step. The values are the batches' own (float32 images, int64
    labels), so training with or without prefetch is bit-identical. On the
    CPU the batches are only converted."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for batch in it:
            yield _host_batch(batch)
        return
    stream = torch.cuda.Stream(dev)
    queue: "collections.deque" = collections.deque()

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            host = [t.pin_memory() for t in _host_batch(batch)]
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                on_dev = [t.to(dev, non_blocking=True) for t in host]
            done = torch.cuda.Event()
            done.record(stream)
            queue.append((on_dev, host, done))

    enqueue(max(1, int(size)))
    while queue:
        on_dev, _host, done = queue.popleft()
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        for t in on_dev:  # allocated on the side stream, used on this one
            t.record_stream(current)
        enqueue(1)
        yield tuple(on_dev)
