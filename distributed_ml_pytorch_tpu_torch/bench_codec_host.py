"""The host cost of the optimizer and codec plane's numpy work on one vector
of AlexNet's 2,472,266 floats (the DownPour push).

    python -m distributed_ml_pytorch_tpu_torch.bench_codec_host [--size N] [--reps R]

Times each call ``R`` times in this process, after one untimed call, on the
host clock:

- ``adasum``: ``parallel/optplane.adasum_adjust`` of an overlap window and
  a push, as the Adasum server runs it on every push;
- ``decode_int8`` and ``encode_int8``: ``utils/compress.decode_update`` of
  one int8 frame and ``CompressingEncoder.encode_range`` over the vector;
- ``wal_record``: the write-ahead log's record bytes of one dense delta;
- ``ddot_f64``: one float64 dot product through BLAS, Adasum's three.

Prints one JSON object: each call's mean and least ms, the size, and
``OPENBLAS_NUM_THREADS`` as this process saw it (set it in the environment
to compare BLAS thread counts). Runs on the host only. The server's own
figures in a running world are ``chip_smoke.py`` phase 20 (a)'s
``host_ms``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from distributed_ml_pytorch_tpu_torch.parallel.optplane import adasum_adjust
from distributed_ml_pytorch_tpu_torch.utils import wal
from distributed_ml_pytorch_tpu_torch.utils.compress import (
    CompressingEncoder,
    decode_update,
    make_codec,
)

ALEXNET_PARAMS = 2_472_266


def measure(size: int = ALEXNET_PARAMS, reps: int = 20, seed: int = 0) -> dict:
    """Each call's mean and least host ms over ``reps`` timed calls."""
    rng = np.random.default_rng(seed)
    overlap = rng.standard_normal(size).astype(np.float32)
    push = (rng.standard_normal(size) + overlap).astype(np.float32)
    enc = CompressingEncoder(size, make_codec("int8"))
    frame = np.concatenate(enc.encode_range(push, 0, size))
    a64 = overlap.astype(np.float64)
    calls = {
        "adasum": lambda: adasum_adjust(overlap, push),
        "decode_int8": lambda: decode_update(frame),
        "encode_int8": lambda: enc.encode_range(push, 0, size),
        "wal_record": lambda: wal._record_bytes(1, 1, 1, 0, 0, push),
        "ddot_f64": lambda: a64 @ a64,
    }
    out = {}
    for name, fn in calls.items():
        fn()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"mean_ms": sum(ms) / len(ms), "min_ms": min(ms)}
    return {"size": size, "reps": reps,
            "openblas_num_threads": os.environ.get("OPENBLAS_NUM_THREADS"), "ms": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=ALEXNET_PARAMS)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(json.dumps(measure(args.size, args.reps, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
