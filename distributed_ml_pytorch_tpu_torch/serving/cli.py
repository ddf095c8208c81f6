"""``serve`` — the serving CLI (counterpart of the JAX ``serving/cli.py``).

Starts a continuous-batching engine for a ``TransformerLM`` with random
weights from ``--seed`` and exposes it over a messaging transport::

    # TCP server: waits for --clients client processes on --port
    python -m distributed_ml_pytorch_tpu_torch.serving.cli --port 29600 --clients 1

    # self-contained demo: an in-process client drives N mixed greedy/sampled
    # requests through the whole frontend path, prints the SLO summary, exits
    python -m distributed_ml_pytorch_tpu_torch.serving.cli --demo 6

    # N engine replicas behind a FleetRouter (routing, migration across an
    # engine's death, overload shedding), here through the demo client
    python -m distributed_ml_pytorch_tpu_torch.serving.cli --fleet 3 --demo 12

    # the weights a training run left (training/train_lm.py --ckpt-dir)
    python -m distributed_ml_pytorch_tpu_torch.serving.cli --ckpt-dir runs/lm --demo 4

It runs on the card (``--backend cuda``, the default) unless ``--backend
cpu`` is given; without a card the default raises. Engine knobs:
``--slots``, ``--cache-size`` (rows per slot: prompt + padded decode
blocks), ``--decode-block``, ``--kv-quant`` (int8 slot caches),
``--max-queue`` (backpressure), ``--prefill-bucket``, and the overload
plane's ``--slo-ttft-ms``, ``--shed-occupancy``, ``--brownout-occupancy``,
``--brownout-max-new``. ``--fleet N`` serves through N replicas,
``--coord HOST:PORT`` (and ``--coord-rank``) registers each engine with a
coordinator (``coord/cli.py``) whose fleet view holds submits while no
engine is up, ``--reliable`` wraps the hub's transport in the reliability
layer (clients must wrap theirs too), and ``--ckpt-dir`` restores the
parameters from the latest checkpoint there. ``--metrics-dump PATH``
writes the metrics registry's snapshot at exit, the engine's SLO summary
attached as ``engine.*`` (``-`` prints it).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Continuous-batching TransformerLM serving engine")
    # model size
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=8,
                   help="attention heads (the card's kernels take head_dim 16, 32, 64 or 128)")
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=256)
    p.add_argument("--max-len", type=int, default=0,
                   help="learned-position table size (0 = derived from --cache-size)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--pos-encoding", default="learned", choices=["learned", "rope"])
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="restore params from a training/train_lm.py checkpoint (default: "
                        "fresh random init)")
    # engine
    p.add_argument("--slots", type=int, default=4,
                   help="concurrent sequences sharing each decode step")
    p.add_argument("--cache-size", type=int, default=256,
                   help="KV rows per slot (bounds prompt + generation)")
    p.add_argument("--decode-block", type=int, default=16,
                   help="tokens per decode block (admission happens between blocks)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 slot caches with per-key scales: half the pool footprint")
    p.add_argument("--max-queue", type=int, default=64,
                   help="queued-request cap; beyond it submissions are rejected")
    p.add_argument("--prefill-bucket", type=int, default=16,
                   help="round prompt lengths up to this multiple (1 = exact lengths)")
    # transport
    p.add_argument("--port", type=str, default="29600",
                   help="TCP port the engine's rank-0 hub binds")
    p.add_argument("--master", type=str, default="localhost")
    p.add_argument("--clients", type=int, default=1,
                   help="client processes the TCP rendezvous waits for")
    p.add_argument("--reliable", action="store_true",
                   help="wrap the hub transport in the reliability layer (seq + CRC + "
                        "ack/retry + dedup, utils/messaging.ReliableTransport); clients "
                        "must wrap too")
    p.add_argument("--client-deadline", type=float, default=30.0, metavar="SEC",
                   help="cancel and free a request whose client has been silent this long")
    p.add_argument("--coord", type=str, default="", metavar="HOST:PORT",
                   help="register this engine with an elastic control plane (coord/cli.py): "
                        "lease-based membership, and the frontend holds submits while the "
                        "coordinator reports the engine fleet down, re-admitting them on "
                        "recovery")
    p.add_argument("--coord-rank", type=int, default=0, metavar="R",
                   help="this engine's rank in the coordination star (0 = derive from "
                        "--port; two engines must use distinct ranks)")
    p.add_argument("--demo", type=int, default=0, metavar="N",
                   help="serve N synthetic requests from an in-process client, print the "
                        "SLO summary, exit")
    p.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="run N engine replicas behind a FleetRouter (occupancy and "
                        "session-affinity routing, stream migration across engine death, "
                        "overload shed/brownout); 0 = single-engine frontend")
    # overload plane
    p.add_argument("--slo-ttft-ms", type=float, default=0.0,
                   help="TTFT SLO in ms (0 = off): recent TTFT above it sheds work")
    p.add_argument("--shed-occupancy", type=float, default=0.0,
                   help="pressure (busy+queued per slot) at which new work admits only "
                        "by displacing lower-priority waiting work (0 = off)")
    p.add_argument("--brownout-occupancy", type=float, default=0.0,
                   help="pressure at which incoming max_new_tokens is capped at "
                        "--brownout-max-new (0 = off)")
    p.add_argument("--brownout-max-new", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device the engine runs on")
    p.add_argument("--metrics-dump", type=str, default="", metavar="PATH",
                   help="write the metrics-registry snapshot JSON (utils/metrics."
                        "get_registry) at exit — the engine's SLO summary, the wire's "
                        "counters; '-' prints to stdout")
    return p


def parse_args(argv=None, parser=None) -> argparse.Namespace:
    parser = parser or build_parser()
    args = parser.parse_args(argv)
    if args.d_model % args.n_heads:
        parser.error(f"--d-model {args.d_model} must divide by --n-heads {args.n_heads}")
    return args


def build_model(args):
    """The flags' ``TransformerLM`` on ``--backend``: seeded from ``--seed``,
    or with the parameters of the latest checkpoint under ``--ckpt-dir``."""
    import torch

    from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        max_len=args.max_len or max(args.cache_size, 256),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        pos_encoding=args.pos_encoding, seed=args.seed, device=args.backend)
    if args.ckpt_dir:
        from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
            create_lm_train_state,
        )
        from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
        from distributed_ml_pytorch_tpu_torch.utils.checkpoint import Checkpointer

        with Checkpointer(args.ckpt_dir) as ckpt:
            if ckpt.latest_step() is None:
                raise SystemExit(f"no checkpoint under {args.ckpt_dir} — train one with "
                                 "training/train_lm.py --ckpt-dir first")
            _state, step = ckpt.restore(create_lm_train_state(lm, SGD(0.1)))
        print(f"restored params from step {step} of {args.ckpt_dir}")
    return lm


def make_engine(lm, args):
    from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(
        lm, slots=args.slots, cache_size=args.cache_size, decode_block=args.decode_block,
        kv_quant=args.kv_quant, max_queue=args.max_queue, prefill_bucket=args.prefill_bucket)


def build_fleet(args, coord_factory=None):
    """``args.fleet`` engine replicas as started ``EngineMember``s over one
    model. ``coord_factory(engine_id)`` may supply each member's
    ``CoordClient``. Each engine is warmed (its prefill buckets and a decode
    block run once) before its serve thread starts, so the router's
    liveness probe never takes a first call's kernel build for a death."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.serving.fleet import EngineMember

    lm = build_model(args)
    members = []
    for i in range(args.fleet):
        engine = make_engine(lm, args)
        bucket = max(2, args.prefill_bucket)
        warmed = 0
        while warmed < 32 and engine.pool.capacity_needed(bucket, bucket, 2) \
                <= engine.pool.cache_size:
            w = engine.submit(np.zeros(bucket, np.int32), 2)
            engine.run_until_idle()
            assert w.done
            bucket += max(1, args.prefill_bucket)
            warmed += 1
        engine.reset_metrics()
        coord = coord_factory(i) if coord_factory is not None else None
        members.append(EngineMember(i, engine, coord=coord).start())
    return members


def _coord_client(args, rank: int):
    """An ``engine`` member's ``CoordClient`` over TCP to ``--coord``."""
    from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
    from distributed_ml_pytorch_tpu_torch.utils.messaging import TCPTransport

    host, _, cport = args.coord.partition(":")
    return CoordClient(TCPTransport(rank=rank, world_size=64, master=host or "localhost",
                                    port=int(cport or 29700)), "engine")


def _hub_transport(args):
    """The client-facing rank-0 hub, reliable with ``--reliable``."""
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        ReliableTransport,
        TCPTransport,
    )

    transport = TCPTransport(rank=0, world_size=1 + args.clients, master=args.master,
                             port=int(args.port))
    return ReliableTransport(transport) if args.reliable else transport


def _print_summary(engine) -> None:
    print("SLO summary:", json.dumps(engine.slo_summary(), indent=2, default=float))


def demo_requests(n: int, vocab: int, cache_size: int, prefill_bucket: int,
                  decode_block: int, seed: int):
    """``n`` synthetic requests ``(prompt, max_new, sampling kwargs)``:
    prompts of 2-11 tokens, generation lengths capped so each fits the slot
    capacity check; odd requests sample at temperature 0.8 with top-k 8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    budget = max(2, min(24, cache_size - prefill_bucket - decode_block))
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(2, 12))).astype(np.int32)
        new = int(rng.integers(2, budget + 1))
        sampled = bool(i % 2)
        out.append((prompt, new, dict(temperature=0.8 if sampled else 0.0,
                                      top_k=8 if sampled else 0, seed=int(i))))
    return out


def _overload(args) -> dict:
    return dict(slo_ttft_ms=args.slo_ttft_ms, shed_occupancy=args.shed_occupancy,
                brownout_occupancy=args.brownout_occupancy,
                brownout_max_new=args.brownout_max_new)


def run_demo(args, engine=None, members=None) -> int:
    """The demo client's requests through the frontend of ``engine``, or
    through a ``FleetRouter`` over ``members``."""
    import threading

    from distributed_ml_pytorch_tpu_torch.serving.frontend import (
        ServingClient,
        ServingFrontend,
    )
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    world = InProcessTransport.create_world(2)
    if members is not None:
        from distributed_ml_pytorch_tpu_torch.serving.fleet import FleetRouter

        frontend = FleetRouter(world[0], members, **_overload(args))
        engine = members[0].engine  # the SLO summary's engine
    else:
        frontend = ServingFrontend(engine, world[0], **_overload(args))
    client = ServingClient(world[1])
    server = threading.Thread(target=frontend.serve_forever, daemon=True)
    server.start()
    try:
        # submit everything up front so the engine batches the requests
        # together, then collect the streams
        submitted = [(client.submit(prompt, new, **kw), new) for prompt, new, kw in
                     demo_requests(args.demo, args.vocab, args.cache_size,
                                   args.prefill_bucket, args.decode_block, args.seed)]
        results = {rid: (new, list(client.stream(rid, timeout=120.0)))
                   for rid, new in submitted}
        for rid, (new, toks) in results.items():
            if len(toks) != new or any(t < 0 or t >= args.vocab for t in toks):
                print(f"demo request {rid}: bad stream {toks}", file=sys.stderr)
                return 1
        print(f"served {args.demo} demo requests "
              f"({sum(len(t) for _, t in results.values())} tokens)")
        _print_summary(engine)
        if members is not None:
            print("fleet summary:", json.dumps(frontend.fleet_summary(), default=str))
        print("serving demo complete")
        return 0
    finally:
        frontend.stop()
        server.join(timeout=5)
        for t in world.values():
            t.close()


def main_fleet(args, parser) -> int:
    """``--fleet N``: N replicas behind a ``FleetRouter``; with ``--coord``
    each holds a lease (ranks ``--coord-rank`` + i, or derived from
    ``--port``), and the router follows the coordinator's fleet view."""
    coord_factory = None
    coord_clients = []
    if args.coord:
        def coord_factory(i):
            rank = (args.coord_rank or 50 + int(args.port) % 14) + i
            if rank >= 64:
                parser.error(f"fleet replica {i} derives coordination rank {rank} >= 64 — "
                             "pin a lower base with --coord-rank")
            client = _coord_client(args, rank)
            coord_clients.append(client)
            return client

    members = build_fleet(args, coord_factory)
    try:
        if args.demo:
            return run_demo(args, members=members)

        from distributed_ml_pytorch_tpu_torch.serving.fleet import FleetRouter

        transport = _hub_transport(args)
        router = FleetRouter(
            transport, members, client_deadline=args.client_deadline,
            fleet=members[0].coord.fleet if members[0].coord else None, **_overload(args))
        print(f"fleet serving on {args.master}:{args.port} ({args.fleet} engines x "
              f"{args.slots} slots x {args.cache_size} rows, block {args.decode_block})")
        try:
            router.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            router.stop()
            transport.close()
            print("fleet summary:", json.dumps(router.fleet_summary(), default=str))
            _print_summary(members[0].engine)
        return 0
    finally:
        for m in members:
            if m.alive:
                m.stop()
        for c in coord_clients:
            c.transport.close()


def main(argv=None) -> int:
    parser = build_parser()
    args = parse_args(argv, parser)
    try:
        return _main(args, parser)
    finally:
        if args.metrics_dump:
            from distributed_ml_pytorch_tpu_torch.coord.cli import dump_metrics

            dump_metrics(args.metrics_dump)


def _main(args, parser) -> int:
    print(args)
    if args.fleet:
        return main_fleet(args, parser)
    engine = make_engine(build_model(args), args)
    # the engine's SLO summary is in every --metrics-dump
    from distributed_ml_pytorch_tpu_torch.utils.metrics import get_registry

    get_registry().attach("engine", engine.slo_summary)
    if args.demo:
        return run_demo(args, engine)

    from distributed_ml_pytorch_tpu_torch.serving.frontend import ServingFrontend

    coord_client = None
    if args.coord:
        coord_client = _coord_client(args, args.coord_rank or 50 + int(args.port) % 14)
        coord_client.join(timeout=10)
    transport = _hub_transport(args)
    frontend = ServingFrontend(
        engine, transport, client_deadline=args.client_deadline,
        fleet=coord_client.fleet if coord_client is not None else None, **_overload(args))
    print(f"serving on {args.master}:{args.port} ({args.slots} slots x {args.cache_size} "
          f"rows, block {args.decode_block}" + (", int8 kv" if args.kv_quant else "") + ")")
    try:
        frontend.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        frontend.stop()
        transport.close()
        if coord_client is not None:
            coord_client.close()
            coord_client.transport.close()
        _print_summary(engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
