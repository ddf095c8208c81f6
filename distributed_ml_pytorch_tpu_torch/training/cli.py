"""Command line of the port (counterpart of the JAX ``training/cli.py``).

The reference's flag surface for the two paths this package runs:
``--no-distributed`` (single-process training) and ``--mode ps`` (one rank
of the DownPour world: ``--rank 0`` or ``--server`` is the parameter server,
ranks 1+ are workers, over TCP on ``--master:--port``). ``--backend`` is
``cuda`` (default) or ``cpu``; ``--cuda`` is accepted for the reference's
scripts and means the default. Flags of the JAX CLI that this package does
not implement are absent, so argparse rejects them instead of ignoring them.

    python -m distributed_ml_pytorch_tpu_torch.training.cli --no-distributed \
        --epochs 1 --synthetic-data
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Distbelief training example (PyTorch + CUDA)")
    p.add_argument("--batch-size", type=int, default=64, metavar="N",
                   help="input batch size for training (default: 64)")
    p.add_argument("--test-batch-size", type=int, default=10000, metavar="N",
                   help="input batch size for testing (default: 10000)")
    p.add_argument("--epochs", type=int, default=20, metavar="N",
                   help="number of epochs to train (default: 20)")
    p.add_argument("--lr", type=float, default=0.008, metavar="LR",
                   help="learning rate (default: 0.008)")
    p.add_argument("--num-pull", type=int, default=10, metavar="N",
                   help="how often to pull params (default: 10)")
    p.add_argument("--num-push", type=int, default=10, metavar="N",
                   help="how often to push grads (default: 10)")
    p.add_argument("--cuda", action="store_true", default=False,
                   help="use the GPU (the default; kept for the reference's scripts)")
    p.add_argument("--log-interval", type=int, default=100, metavar="N",
                   help="how often to evaluate and print out")
    p.add_argument("--no-distributed", action="store_true", default=False,
                   help="run the single-process baseline instead of distributed training")
    p.add_argument("--rank", type=int, metavar="N",
                   help="rank of current process (0 is server, 1+ is training node)")
    p.add_argument("--world-size", type=int, default=3, metavar="N",
                   help="size of the world")
    p.add_argument("--server", action="store_true", default=False, help="server node?")
    p.add_argument("--master", type=str, default="localhost",
                   help="ip address of the master (server) node")
    p.add_argument("--port", type=str, default="29500",
                   help="port on master node to communicate with")
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="compute device; cuda raises when no card is present")
    p.add_argument("--mode", type=str, default="ps", choices=["ps"],
                   help="distributed strategy: the async parameter server")
    p.add_argument("--model", type=str, default="alexnet", choices=["alexnet", "lenet"],
                   help="model architecture")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32"],
                   help="compute dtype (float32 only in this package)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-root", type=str, default="./data",
                   help="CIFAR-10 location (cifar-10-batches-py/ or the tarball)")
    p.add_argument("--synthetic-data", action="store_true", default=False,
                   help="force the deterministic synthetic dataset")
    p.add_argument("--synthetic-train-size", type=int, default=50000)
    p.add_argument("--synthetic-test-size", type=int, default=10000)
    p.add_argument("--log-dir", type=str, default="runs",
                   help="CSV telemetry directory")
    p.add_argument("--momentum", type=float, default=0.0, metavar="M",
                   help="sgd momentum (the reference uses 0.0)")
    p.add_argument("--heartbeat-interval", type=float, default=1.0, metavar="SEC",
                   help="PS-mode worker liveness heartbeat cadence; 0 disables")
    p.add_argument("--worker-timeout", type=float, default=30.0, metavar="SEC",
                   help="PS-mode server declares a worker failed after this long "
                        "without a frame; 0 disables")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    if args.no_distributed:
        from distributed_ml_pytorch_tpu_torch.training.trainer import train_single

        _model, logger = train_single(args, device=args.backend)
        name = "single.csv" if args.backend == "cpu" else "gpu.csv"
        print("wrote", logger.to_csv(name))
        print("Finished Training")
        return 0
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import run_ps_process

    return run_ps_process(args)


if __name__ == "__main__":
    sys.exit(main())
