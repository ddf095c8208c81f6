"""Localhost multi-process launcher (counterpart of the JAX ``launch.py``).

The DownPour world::

    python -m distributed_ml_pytorch_tpu_torch.launch --world-size 3 -- \
        --model lenet --epochs 1 --synthetic-data

spawns rank 0 as the parameter server and ranks 1..N-1 as workers, all on a
TCP rendezvous on localhost; everything after ``--`` goes to the trainer CLI
verbatim (add ``--backend cpu`` to run without a card). Workers share the
card; the server never touches it. ``--n-servers K`` launches the sharded
world: ranks 0..K-1 are shard servers on K consecutive ports, the rest
workers::

    python -m distributed_ml_pytorch_tpu_torch.launch --world-size 4 --n-servers 2 -- \
        --synthetic-data

A mesh mode (``--mode sync``, ``local-sgd`` or ``fsdp`` of the trainer CLI;
``--entry train_lm`` with ``--mode fsdp`` or ``tp``) starts ``--world-size``
equal ranks on one TCP rendezvous (``--world-size``, ``--port`` and each
``--rank`` are passed on)::

    python -m distributed_ml_pytorch_tpu_torch.launch --world-size 2 -- \
        --mode sync --dist-backend gloo --backend cpu --synthetic-data
    python -m distributed_ml_pytorch_tpu_torch.launch --world-size 2 --entry train_lm -- \
        --mode tp --dist-backend gloo --device cpu
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


def _free_port_block(n: int, attempts: int = 50) -> str:
    """A base port with ``n`` consecutive free ports (the sharded world binds
    base..base+n-1, one star per shard), checked by binding them all."""
    for _ in range(attempts):
        base = int(_free_port())
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("", base + i))
            return str(base)
        except (OSError, OverflowError):  # taken, or base+i ran past 65535
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} consecutive free ports found")


ENTRIES = {"cli": "distributed_ml_pytorch_tpu_torch.training.cli",
           "train_lm": "distributed_ml_pytorch_tpu_torch.training.train_lm"}


def _mode_of(extra_args: List[str], default: str) -> str:
    """The ``--mode`` value among the forwarded flags."""
    for i, a in enumerate(extra_args):
        if a == "--mode" and i + 1 < len(extra_args):
            return extra_args[i + 1]
        if a.startswith("--mode="):
            return a.split("=", 1)[1]
    return default


def _wait_all(procs, poll_interval: float) -> int:
    """The worst exit code of ``procs``; when one exits non-zero while
    others run, the rest are killed."""
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


def launch_ranks(module: str, world_size: int, extra_args: List[str], *,
                 port: str | None = None, poll_interval: float = 0.2) -> int:
    """Spawn ``world_size`` equal ranks of ``python -m module extra_args
    --port P --rank r`` on one free port; returns the worst exit code."""
    port = port or _free_port()
    procs = [subprocess.Popen([sys.executable, "-m", module, *extra_args, "--port", port,
                               "--rank", str(r)]) for r in range(world_size)]
    return _wait_all(procs, poll_interval)


def launch_world(world_size: int, extra_args: List[str], *, port: str | None = None,
                 n_servers: int = 1, poll_interval: float = 0.2) -> int:
    """Spawn the ``n_servers`` server ranks and the workers; returns the
    worst exit code. If any process exits non-zero while others run, the
    rest are killed, so a crashed worker cannot leave a server waiting
    forever."""
    if not 1 <= n_servers < world_size:
        raise ValueError(f"n_servers={n_servers} must leave at least one worker in a "
                         f"world of {world_size}")
    port = port or (_free_port_block(n_servers) if n_servers > 1 else _free_port())
    common = [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.training.cli",
              "--mode", "ps", "--world-size", str(world_size), "--port", port,
              *(["--n-servers", str(n_servers)] if n_servers > 1 else []), *extra_args]
    procs = [subprocess.Popen(common + ["--rank", str(r), "--server"])
             for r in range(n_servers)]
    procs += [subprocess.Popen(common + ["--rank", str(r)])
              for r in range(n_servers, world_size)]
    return _wait_all(procs, poll_interval)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Launch a world on localhost (the PS world, or the ranks of a mesh mode)")
    parser.add_argument("--world-size", type=int, default=3)
    parser.add_argument("--port", type=str, default=None)
    parser.add_argument("--n-servers", type=int, default=1, metavar="K",
                        help="shard the parameter server across K ranks "
                             "(the DistBelief layout)")
    parser.add_argument("--entry", default="cli", choices=sorted(ENTRIES),
                        help="the program each rank runs: the trainer CLI or train_lm")
    args, extra = parser.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]
    if args.entry == "cli" and _mode_of(extra, "ps") == "ps":
        return launch_world(args.world_size, extra, port=args.port, n_servers=args.n_servers)
    return launch_ranks(ENTRIES[args.entry], args.world_size,
                        ["--world-size", str(args.world_size), *extra], port=args.port)


if __name__ == "__main__":
    sys.exit(main())
