"""Localhost multi-process launcher for the DownPour world (counterpart of
the JAX ``launch.py``)::

    python -m distributed_ml_pytorch_tpu_torch.launch --world-size 3 -- \
        --model lenet --epochs 1 --synthetic-data

spawns rank 0 as the parameter server and ranks 1..N-1 as workers, all on a
TCP rendezvous on localhost; everything after ``--`` goes to the trainer CLI
verbatim (add ``--backend cpu`` to run without a card). Workers share the
card; the server never touches it.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import time
from typing import List


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("", 0))
        return str(s.getsockname()[1])


def launch_world(world_size: int, extra_args: List[str], *, port: str | None = None,
                 poll_interval: float = 0.2) -> int:
    """Spawn the server and the workers; returns the worst exit code. If any
    process exits non-zero while others run, the rest are killed, so a
    crashed worker cannot leave the server waiting forever."""
    if world_size < 2:
        raise ValueError(f"world_size={world_size} needs a server and at least one worker")
    port = port or _free_port()
    common = [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.training.cli",
              "--mode", "ps", "--world-size", str(world_size), "--port", port,
              *extra_args]
    procs = [subprocess.Popen(common + ["--rank", "0", "--server"])]
    procs += [subprocess.Popen(common + ["--rank", str(r)]) for r in range(1, world_size)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return next((c for c in codes if c != 0), 0)
            bad = next((c for c in codes if c not in (None, 0)), None)
            if bad is not None:
                print(f"launch: a process exited with code {bad}; terminating the rest",
                      file=sys.stderr)
                return bad
            time.sleep(poll_interval)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Launch the PS world on localhost (server + workers)")
    parser.add_argument("--world-size", type=int, default=3)
    parser.add_argument("--port", type=str, default=None)
    args, extra = parser.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]
    return launch_world(args.world_size, extra, port=args.port)


if __name__ == "__main__":
    sys.exit(main())
