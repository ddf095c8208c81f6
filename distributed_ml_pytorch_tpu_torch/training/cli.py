"""Command line of the port (counterpart of the JAX ``training/cli.py``).

The reference's flag surface for the paths this package runs:
``--no-distributed`` (single-process training), ``--mode ps`` (one rank of
the DownPour world: ``--rank 0`` or ``--server`` is the parameter server,
ranks 1+ are workers, over TCP on ``--master:--port``) and the mesh modes
``--mode sync``, ``local-sgd`` and ``fsdp`` (``parallel/sync.py``,
``local_sgd.py``, ``fsdp.py``): every rank of ``--world-size`` is a worker
of a ``data`` mesh over ``--master:--port`` with ``--dist-backend`` (``nccl``
on the card by default, ``gloo`` to share a card or on the CPU),
``--batch-size`` per rank, ``--sync-every`` local steps between averages,
and each rank writes ``node<rank>.csv``. ``--backend`` is
``cuda`` (default) or ``cpu``; ``--cuda`` is accepted for the reference's
scripts and means the default. The single-process trainer takes the JAX
trainer's surface: ``--dtype``, ``--optimizer``, ``--weight-decay``,
``--grad-clip``, ``--lr-schedule``, ``--grad-accum``, ``--steps-per-dispatch``
(K steps a dispatch, a CUDA graph on the card), ``--prefetch``,
``--ckpt-dir``/``--ckpt-every``/``--ckpt-keep``/``--resume`` and
``--download``. In ``--mode ps`` the worker takes the optimizer flags,
``--chunked-dispatch`` and ``--steps-per-dispatch`` (runs of local steps
between communication gaps as one dispatch, a CUDA graph on the card) and
``--rejoin``; the server takes ``--ckpt-dir``/``--ckpt-every``/``--resume``,
``--wal``, ``--admission``/``--admission-z``/``--admission-warmup``,
``--staleness-damping`` or ``--combine adasum`` (not both), and
``--server-opt``/``--server-lr``/``--server-momentum`` (an optimizer over
each server's range); the worker takes ``--compress``/``--compress-block``/
``--compress-topk`` (compressed pushes with error feedback); every rank
takes ``--transport`` (the native C++ library, the Python sockets, or auto)
and ``--reliable`` (the reliable wire; with ``--wal`` the server acks a push
only after the log's fsync). ``--n-servers K`` shards the server across
ranks 0..K-1, each owning a contiguous range of the central vector on
``port + shard`` (``parallel/sharded_ps.py``); its workers run one step a
dispatch, as the JAX package's do. ``--coord HOST:PORT`` attaches every
rank to the coordinator of ``coord/cli.py`` instead: the shard ranks serve
the ranges its shard maps assign (``coord/elastic.py``), the workers cut
over when the map moves, and a worker may join or a shard die mid-run; it
takes the sharded entry even with ``--n-servers 1``; ``--manifest-path``
names the coordinator's fleet manifest, which a shard restores in place on
a rollback barrier. ``--profile-dir``/``--profile-start``/
``--profile-steps`` trace a window of training steps with
``torch.profiler`` (``utils/tracing.TraceWindow``), and ``--metrics-dump
PATH`` writes the metrics registry's snapshot at exit.

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
    p.add_argument("--n-servers", type=int, default=1, metavar="K",
                   help="(--mode ps) shard the parameter server across K "
                        "ranks (0..K-1), each owning a contiguous range of "
                        "the central vector on its own port (port+shard) — "
                        "the DistBelief layout (parallel/sharded_ps.py)")
    p.add_argument("--server", action="store_true", default=False, help="server node?")
    p.add_argument("--master", type=str, default="localhost",
                   help="ip address of the master (server) node")
    p.add_argument("--port", type=str, default="29500",
                   help="port on master node to communicate with")
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="compute device; cuda raises when no card is present")
    p.add_argument("--mode", type=str, default="ps",
                   choices=["ps", "sync", "local-sgd", "fsdp"],
                   help="distributed strategy: the async parameter server, sync "
                        "all-reduce data parallelism, local SGD with periodic "
                        "averaging, or fully-sharded data parallelism (ZeRO-3)")
    p.add_argument("--dist-backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="(mesh modes) torch.distributed backend: nccl (default on the "
                        "card; one rank per card) or gloo (the CPU, or ranks sharing "
                        "a card)")
    p.add_argument("--sync-every", type=int, default=0, metavar="K",
                   help="local-sgd mode: average params every K steps "
                        "(default 0 = use --num-push)")
    p.add_argument("--model", type=str, default="alexnet",
                   choices=["alexnet", "lenet", "resnet18", "resnet50"],
                   help="model architecture")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype over float32 parameters (--no-distributed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-root", type=str, default="./data",
                   help="CIFAR-10 location (cifar-10-batches-py/ or the tarball)")
    p.add_argument("--synthetic-data", action="store_true", default=False,
                   help="force the deterministic synthetic dataset")
    p.add_argument("--download", action="store_true", default=False,
                   help="fetch real CIFAR-10 (checksum-verified) into --data-root when "
                        "missing; a failure falls back to the synthetic stand-in")
    p.add_argument("--synthetic-train-size", type=int, default=50000)
    p.add_argument("--synthetic-test-size", type=int, default=10000)
    p.add_argument("--log-dir", type=str, default="runs",
                   help="CSV telemetry directory")
    p.add_argument("--transport", type=str, default="auto",
                   choices=["auto", "native", "python"],
                   help="PS control-plane transport: C++ library "
                        "(native/transport.cpp), pure Python, or auto-detect")
    p.add_argument("--reliable", action="store_true", default=False,
                   help="wrap the PS control plane in the reliability layer "
                        "(per-peer sequence numbers, frame CRC, ack+retry "
                        "with capped backoff, receiver dedup — gradient "
                        "pushes apply exactly once under duplicates/loss); "
                        "set it on EVERY rank of the world")
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="checkpoint directory (empty = checkpointing off)")
    p.add_argument("--ckpt-every", type=int, default=500, metavar="N",
                   help="save a checkpoint every N global steps (--mode ps: every N "
                        "gradient pushes, summed across workers)")
    p.add_argument("--ckpt-keep", type=int, default=3, metavar="N",
                   help="retain the newest N checkpoints (ignored by --mode ps, which "
                        "keeps one atomically-replaced file)")
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in --ckpt-dir")
    p.add_argument("--wal", action="store_true", default=False,
                   help="PS server: write-ahead-log every applied update before it "
                        "mutates the central params (requires --ckpt-dir); recovery = "
                        "restore the checkpoint + replay the log")
    p.add_argument("--admission", action="store_true", default=False,
                   help="PS server: numerical admission gate — every GradientUpdate "
                        "passes finiteness + per-worker EWMA norm-outlier checks before "
                        "accounting/WAL; rejects are quarantined and explicitly nacked "
                        "(UpdateNack), the worker resyncs by pulling fresh params")
    p.add_argument("--admission-z", type=float, default=6.0, metavar="Z",
                   help="admission gate: reject a push whose log-norm z-score vs the "
                        "sender's own history exceeds Z")
    p.add_argument("--admission-warmup", type=int, default=8, metavar="N",
                   help="admission gate: per-sender pushes admitted before the z-score "
                        "check activates (finiteness is checked from the first push)")
    p.add_argument("--profile-dir", type=str, default="",
                   help="capture a torch.profiler trace (Chrome-trace JSON) of a "
                        "training-step window into this directory (the reference has no "
                        "tracing at all)")
    p.add_argument("--profile-start", type=int, default=10, metavar="N",
                   help="global step at which the trace window opens")
    p.add_argument("--profile-steps", type=int, default=10, metavar="N",
                   help="number of steps the trace window covers")
    p.add_argument("--metrics-dump", type=str, default="", metavar="PATH",
                   help="write the metrics-registry snapshot JSON (utils/metrics."
                        "get_registry) at exit — reliable-transport counters, component "
                        "stats; '-' prints to stdout")
    p.add_argument("--rejoin", action="store_true", default=False,
                   help="PS-mode worker restart: reconnect to a running server and ADOPT "
                        "its central params instead of installing this process's fresh "
                        "init")
    p.add_argument("--prefetch", type=int, default=2, metavar="N",
                   help="keep N batches' host->device copies in flight ahead of compute "
                        "(per-step path; 0 disables)")
    p.add_argument("--optimizer", type=str, default="sgd", choices=("sgd", "adam", "adamw"),
                   help="optimizer; sgd is the reference recipe (in --mode ps the "
                        "worker-local optimizer)")
    p.add_argument("--momentum", type=float, default=0.0, metavar="M",
                   help="sgd momentum (the reference uses 0.0)")
    p.add_argument("--weight-decay", type=float, default=None, metavar="WD",
                   help="weight decay: decoupled for adamw, L2 for sgd/adam; unset keeps "
                        "each optimizer's default (adamw: 1e-4), 0 disables")
    p.add_argument("--grad-clip", type=float, default=0.0, metavar="NORM",
                   help="clip gradients to this global norm before the update; 0 disables")
    p.add_argument("--lr-schedule", type=str, default="constant",
                   choices=("constant", "inverse-epoch", "cosine"),
                   help="learning-rate schedule over optimizer updates")
    p.add_argument("--grad-accum", type=int, default=1, metavar="K",
                   help="average gradients over K micro-batches before each optimizer "
                        "update (optax.MultiSteps semantics)")
    p.add_argument("--steps-per-dispatch", type=int, default=1, metavar="K",
                   help="train up to K consecutive steps a dispatch (a CUDA graph of one "
                        "step replayed K times on the card); per-step CSV rows and the "
                        "eval cadence are kept. In --mode ps, K caps the fused "
                        "between-comm runs (default auto = 64) and K > 1 forces chunked "
                        "dispatch on")
    p.add_argument("--chunked-dispatch", choices=("auto", "on", "off"), default="auto",
                   help="(--mode ps workers) run each between-comm run of local SGD as "
                        "one dispatch (a CUDA graph of one step replayed) with exact "
                        "push/pull cadence semantics; 'auto' enables it on the card, "
                        "where per-step dispatch leaves the card mostly idle. With "
                        "--n-servers > 1 the workers run one step a dispatch whatever "
                        "this says, as the JAX package's do")
    p.add_argument("--heartbeat-interval", type=float, default=1.0, metavar="SEC",
                   help="PS-mode worker liveness heartbeat cadence; 0 disables")
    p.add_argument("--worker-timeout", type=float, default=30.0, metavar="SEC",
                   help="PS-mode server declares a worker failed after this long "
                        "without a frame; 0 disables")
    p.add_argument("--coord", type=str, default="", metavar="HOST:PORT",
                   help="attach this PS-mode rank to an elastic control plane "
                        "(coord/cli.py): membership and lease liveness, coordinator-pushed "
                        "shard maps (workers cut over at step boundaries; shard servers "
                        "resize), straggler speculation. Empty = static fleet (the classic "
                        "launch-time topology)")
    p.add_argument("--manifest-path", type=str, default="",
                   help="elastic shard servers (--coord): path of the coordinator's "
                        "FleetManifest — required to honor auto-rollback barriers "
                        "(RollbackRequest restores the last good snapshot in place)")
    p.add_argument("--staleness-damping", type=float, default=0.0, metavar="D",
                   help="PS-mode server scales each gradient push by 1/(1 + D*staleness), "
                        "where staleness counts central versions since that worker's "
                        "last pull; 0 = reference behavior (apply raw)")
    p.add_argument("--compress", type=str, default="none", choices=("none", "int8", "topk"),
                   help="PS-mode gradient wire compression (utils/compress.py): pushes ride "
                        "CompressedUpdate frames with per-worker error-feedback residuals — "
                        "int8 = per-block symmetric quantization (~4x fewer bytes), topk = "
                        "sparsified (idx, value) pairs; the server decodes BEFORE the "
                        "admission gate and WAL")
    p.add_argument("--compress-block", type=int, default=1024, metavar="B",
                   help="int8 quantization block size (one absmax scale per block; multiple "
                        "of 4)")
    p.add_argument("--compress-topk", type=float, default=0.01, metavar="F",
                   help="top-k fraction of elements kept per push (--compress topk)")
    p.add_argument("--combine", type=str, default="add", choices=("add", "adasum"),
                   help="how the PS combines concurrent pushes: add = the reference "
                        "behavior; adasum = angle-aware merge against the overlap applied "
                        "since the pusher's last pull (arXiv:2006.02924) — the alternative "
                        "to --staleness-damping (mutually exclusive)")
    p.add_argument("--server-opt", type=str, default="none", choices=("none", "sgdm", "adam"),
                   help="sharded server-side optimizer (parallel/optplane.py): each "
                        "server/shard owns momentum (sgdm) or Adam moments for EXACTLY its "
                        "range — state cost scales 1/shards; state rides checkpoints + WAL "
                        "replay (arXiv:2004.13336)")
    p.add_argument("--server-lr", type=float, default=1.0, metavar="LR",
                   help="server-side optimizer step scale (1.0 with sgdm momentum 0 "
                        "reproduces the plain add)")
    p.add_argument("--server-momentum", type=float, default=0.9, metavar="M",
                   help="server-side sgdm momentum over incoming deltas")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.combine == "adasum" and args.staleness_damping > 0.0:
        parser.error("--combine adasum replaces --staleness-damping — pick one")
    try:
        return _main(args)
    finally:
        # whatever the run registered or attached (the reliable wire's
        # counters through make_transport, component stats) in one snapshot
        if args.metrics_dump:
            from distributed_ml_pytorch_tpu_torch.coord.cli import dump_metrics

            dump_metrics(args.metrics_dump)


def _main(args) -> int:
    print(args)
    if args.no_distributed:
        from distributed_ml_pytorch_tpu_torch.training.trainer import train_single

        _state, logger = train_single(args, device=args.backend)
        name = "single.csv" if args.backend == "cpu" else "gpu.csv"
        print("wrote", logger.to_csv(name))
        print("Finished Training")
        return 0
    if args.mode != "ps":
        return run_mesh_mode(args)
    if args.n_servers > 1 or args.coord:
        # the sharded entry hosts the elastic path: one server is a map of
        # one entry there
        from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import (
            run_sharded_ps_process,
        )

        return run_sharded_ps_process(args)
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import run_ps_process

    return run_ps_process(args)


def run_mesh_mode(args) -> int:
    """One rank of a ``--mode sync|local-sgd|fsdp`` world: join it, train,
    write ``node<rank>.csv``."""
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import data_mesh, init_distributed

    if args.mode == "sync":
        from distributed_ml_pytorch_tpu_torch.parallel.sync import train_sync as train_fn
    elif args.mode == "fsdp":
        from distributed_ml_pytorch_tpu_torch.parallel.fsdp import train_fsdp as train_fn
    else:
        from distributed_ml_pytorch_tpu_torch.parallel.local_sgd import (
            train_local_sgd as train_fn,
        )
    rank = 0 if args.rank is None else args.rank
    world = init_distributed(args.dist_backend, args.master, args.port, args.world_size, rank,
                             device=args.backend)
    _state, logger = train_fn(args, data_mesh(world=world))
    print("wrote", logger.to_csv("node{}.csv".format(rank)))
    print("Finished Training")
    return 0


if __name__ == "__main__":
    sys.exit(main())
