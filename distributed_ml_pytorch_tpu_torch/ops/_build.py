"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface and loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds. The libraries land in ``build/torch_kernels/<hash>/`` at the root of
the checkout (listed in ``.gitignore``), keyed by a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused. All
sources are compiled in parallel (one ``nvcc`` each, started together).

Nothing here runs at import time: :func:`load` builds on the first launch of a
kernel. Every C entry point returns ``cudaGetLastError()``; :func:`check`
turns a non-zero code into an exception, so a refused launch never passes
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds the last build took (0.0 when every library was already built)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "distributed_ml_pytorch_tpu_torch cannot be built on this machine")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build_all(out: Path) -> None:
    """Compile every missing library in parallel; write atomically (a
    temporary name, then ``os.replace``) so concurrent processes never load
    a half-written file."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        log = open(out / f"{src.stem}.{os.getpid()}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((src.name, Path(log.name).read_text()[-4000:]))
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}\n{text}" for name, text in failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    source first if needed)."""
    global build_seconds
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = build_dir()
        if not all((out / f"lib{s.stem}.so").exists() for s in _sources()):
            t0 = time.monotonic()
            _build_all(out)
            build_seconds = time.monotonic() - t0
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        _libs[name] = lib
        return lib


def build_logs() -> str:
    """The compiler's output of the last build (``-Xptxas -v``: registers,
    shared memory and spills per kernel)."""
    out = build_dir()
    return "\n".join(p.read_text() for p in sorted(out.glob("*.log")))


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
