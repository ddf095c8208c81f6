"""The coordinator's process (counterpart of the JAX ``coord/cli.py``).

The hub of an elastic PS fleet over TCP::

    # members dial in whenever they start
    python -m distributed_ml_pytorch_tpu_torch.coord.cli --port 29700 --model alexnet

    # every PS rank attaches with --coord (training/cli.py):
    python -m distributed_ml_pytorch_tpu_torch.training.cli --mode ps --rank 0 \\
        --world-size 4 --n-servers 2 --coord localhost:29700 ...

    # the elastic world in one process: two shard servers and two workers,
    # a third worker joins, a shard crashes, the map rebalances
    python -m distributed_ml_pytorch_tpu_torch.coord.cli --demo

    # the recovery drill (snapshot, kill every shard, restore from the
    # manifest and the WALs) and the numerical-health scenario (poisoned
    # worker, nacks, reputation, auto-rollback), in one process each
    python -m distributed_ml_pytorch_tpu_torch.coord.cli --drill --model lenet
    python -m distributed_ml_pytorch_tpu_torch.coord.cli --health --model lenet

    # the multi-tenant scheduler: a serving spike parks a training shard
    # behind a snapshot barrier, the off-peak resumes it bit for bit
    python -m distributed_ml_pytorch_tpu_torch.coord.cli --sched-demo --model lenet

    # the MPMD pipeline: four stage members under seeded chaos, the middle
    # stage killed and restarted from its stage checkpoint
    python -m distributed_ml_pytorch_tpu_torch.coord.cli --mpmd

The hub binds and serves at once (``TCPTransport(wait_for=0)``): the members
are whoever dials in. ``--manifest-dir`` and ``--snapshot-interval`` drive
its snapshot barrier, ``--auto-rollback`` and ``--rollback-loss-factor``
its watchdog, ``--reputation-nacks`` worker reputation. On exit it prints
its last 64 decisions and ``fleet at exit:`` with the fleet state and the
final shard map. ``--drill``, ``--health``, ``--sched-demo``, ``--mpmd``
and ``--demo`` print their summary and exit 0 only if it is ok, each on
``--backend`` (the card unless ``cpu`` is asked for). ``--metrics-dump
PATH`` writes the metrics registry's snapshot at exit (the hub attaches its
decision-log totals and fleet telemetry as ``coord.*``; ``-`` prints it):
:func:`dump_metrics` is the three CLIs' shared tail.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Elastic control plane: membership, leases, shard rebalancing, "
                    "straggler speculation")
    p.add_argument("--port", type=str, default="29700",
                   help="TCP port the coordination hub binds")
    p.add_argument("--master", type=str, default="localhost")
    p.add_argument("--max-members", type=int, default=64,
                   help="upper bound on member ranks (sizes the hub's rank space; members "
                        "may come and go freely below it)")
    p.add_argument("--model", type=str, default="alexnet",
                   choices=["alexnet", "lenet", "resnet18", "resnet50"],
                   help="model whose flat size defines the shard map's parameter space "
                        "(must match the training ranks)")
    p.add_argument("--n-params", type=int, default=0,
                   help="the parameter space's size directly (0 = from --model)")
    p.add_argument("--lease", type=float, default=3.0,
                   help="seconds of silence before a member is removed")
    p.add_argument("--straggler-factor", type=float, default=3.0,
                   help="speculate a worker whose step-latency EWMA exceeds this multiple "
                        "of the fleet median")
    p.add_argument("--no-speculation", action="store_true",
                   help="disable Sandblaster-style backup tasks")
    p.add_argument("--timeout", type=float, default=0.0,
                   help="exit after this many seconds (0 = serve forever)")
    p.add_argument("--demo", action="store_true",
                   help="run the in-process elastic demo (join + shard crash + rebalance) "
                        "and exit")
    p.add_argument("--drill", action="store_true",
                   help="run the in-process disaster-recovery drill (snapshot barrier, kill "
                        "ALL shards, restore from manifest + WAL, sequence-accounted) and exit")
    p.add_argument("--health", action="store_true",
                   help="run the in-process numerical-health scenario (admission gate + "
                        "nacks, seeded SDC poisoned worker, reputation revocation, "
                        "coordinator auto-rollback) and exit")
    p.add_argument("--sched-demo", action="store_true",
                   help="run the in-process multi-tenant scheduler scenario (serving demand "
                        "spike preempts a live training shard — snapshot barrier, park under "
                        "the FleetManifest — then resumes it bit-for-bit off-peak via "
                        "checkpoint + exactly-once WAL replay; prints preempt/resume MTTR and "
                        "the restore proof) and exit")
    p.add_argument("--mpmd", action="store_true",
                   help="run the in-process MPMD pipeline scenario (4 stage members "
                        "under seeded drop/dup + weather, middle stage killed "
                        "mid-schedule, lease-expiry detection, restart from its stage "
                        "checkpoint, watermark replay; prints MTTR + accounting) and "
                        "exit")
    p.add_argument("--auto-rollback", action="store_true",
                   help="TCP hub mode: watch the fleet's loss telemetry and drive "
                        "RollbackRequest barriers to the last good manifest on "
                        "divergence/nonfinite losses")
    p.add_argument("--rollback-loss-factor", type=float, default=2.0,
                   help="auto-rollback: trigger when the fleet-mean loss EWMA exceeds this "
                        "multiple of its best")
    p.add_argument("--reputation-nacks", type=int, default=0,
                   help="revoke a worker's lease after this many admission nacks since it "
                        "(re)joined (0 = off)")
    p.add_argument("--manifest-dir", type=str, default="",
                   help="directory for fleet snapshot manifests (TCP hub mode; empty = "
                        "snapshots stay in memory)")
    p.add_argument("--snapshot-interval", type=float, default=0.0,
                   help="seconds between automatic fleet snapshot barriers (0 = only on "
                        "demand)")
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="--demo, --drill, --health, --sched-demo, --mpmd: the workers' (or "
                        "the stages') device")
    p.add_argument("--metrics-dump", type=str, default="", metavar="PATH",
                   help="write the metrics-registry snapshot JSON (utils/metrics."
                        "get_registry) to PATH at exit — decision-log totals, fleet "
                        "telemetry, attached component stats; '-' prints to stdout")
    p.add_argument("--seed", type=int, default=0)
    return p


def dump_metrics(path: str) -> None:
    """The ``--metrics-dump`` tail of the training, serving and coordinator
    CLIs: the default registry's snapshot to ``path`` (``-``: stdout)."""
    if not path:
        return
    from distributed_ml_pytorch_tpu_torch.utils.metrics import get_registry

    reg = get_registry()
    if path == "-":
        print(reg.dump_json())
    else:
        reg.dump_json(path)
        print(f"metrics snapshot -> {path}")


def _n_params(args) -> int:
    if args.n_params:
        return int(args.n_params)
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.utils.serialization import flat_size

    return flat_size(get_model(args.model, seed=args.seed, device="cpu"))


def run_demo(args) -> int:
    """The elastic script in one process (:func:`~.demo.elastic_demo`) on
    ``--model`` and ``--backend``."""
    from distributed_ml_pytorch_tpu_torch.coord.demo import elastic_demo

    summary = elastic_demo(seed=args.seed, model=args.model, device=args.backend)
    print("elastic demo:", summary)
    return 0 if summary.get("ok") else 1


def run_drill(args) -> int:
    """The recovery drill in one process (:func:`~.drill.drill_demo`)."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import drill_demo

    summary = drill_demo(seed=args.seed, model=args.model, device=args.backend)
    print("recovery drill:", summary)
    return 0 if summary.get("ok") else 1


def run_health(args) -> int:
    """The numerical-health scenario in one process
    (:func:`~.health.health_demo`)."""
    from distributed_ml_pytorch_tpu_torch.coord.health import health_demo

    summary = health_demo(seed=args.seed, model=args.model, device=args.backend)
    print("health scenario:", summary)
    return 0 if summary.get("ok") else 1


def run_sched(args) -> int:
    """The scheduler scenario in one process (:func:`~.drill.sched_demo`):
    peak preempt, park, borrowed slot, off-peak resume."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import sched_demo

    summary = sched_demo(seed=args.seed, model=args.model, device=args.backend)
    print("sched scenario:", summary)
    return 0 if summary.get("ok") else 1


def run_mpmd(args) -> int:
    """The MPMD pipeline scenario in one process
    (:func:`~.stages.mpmd_demo`)."""
    from distributed_ml_pytorch_tpu_torch.coord.stages import mpmd_demo

    summary = mpmd_demo(seed=args.seed, device=args.backend)
    print("mpmd scenario:", summary)
    return 0 if summary.get("ok") else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    if args.demo:
        return run_demo(args)
    if args.drill:
        return run_drill(args)
    if args.health:
        return run_health(args)
    if args.mpmd:
        return run_mpmd(args)
    if args.sched_demo:
        return run_sched(args)

    from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
    from distributed_ml_pytorch_tpu_torch.utils.messaging import TCPTransport

    n_params = _n_params(args)
    transport = TCPTransport(rank=0, world_size=int(args.max_members), master=args.master,
                             port=int(args.port), wait_for=0)
    coord = Coordinator(transport, n_params, lease=args.lease,
                        straggler_factor=args.straggler_factor,
                        speculation=not args.no_speculation,
                        manifest_dir=args.manifest_dir or None,
                        snapshot_interval=args.snapshot_interval,
                        auto_rollback=args.auto_rollback,
                        rollback_loss_factor=args.rollback_loss_factor,
                        reputation_nacks=args.reputation_nacks)
    if args.metrics_dump:
        from distributed_ml_pytorch_tpu_torch.coord.coordinator import FLEET_METRICS_FIELDS
        from distributed_ml_pytorch_tpu_torch.utils.metrics import get_registry

        def coord_stats():
            fleet = coord.fleet_state()["fleet_metrics"]
            return {"events_total": coord.events.total,
                    "events_dropped": coord.events.dropped,
                    "rollbacks_done": coord.rollbacks_done,
                    "manifests_written": coord.manifests_written,
                    **{f"fleet.{k}": v for k, v in zip(FLEET_METRICS_FIELDS, fleet)}}

        get_registry().attach("coord", coord_stats)
    print(f"coordinator on {args.master}:{args.port} ({n_params} params, lease "
          f"{args.lease:.1f}s)", flush=True)
    try:
        coord.run(timeout=args.timeout or None)
    except KeyboardInterrupt:
        pass
    finally:
        transport.close()
        for line in coord.events[-64:]:
            print("event:", line)
        if coord.events.dropped:
            print(f"({coord.events.total} decisions total, {coord.events.dropped} aged out "
                  "of the ring)")
        fs = coord.fleet_state()
        fs["map"] = [[e.server_id, e.lo, e.hi] for e in coord.shard_map.entries]
        print("fleet at exit:", fs, flush=True)
        dump_metrics(args.metrics_dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
