"""``serve`` — the serving CLI (counterpart of the JAX ``serving/cli.py``).

Starts a continuous-batching engine for a ``TransformerLM`` with random
weights from ``--seed`` and exposes it over a messaging transport::

    # TCP server: waits for --clients client processes on --port
    python -m distributed_ml_pytorch_tpu_torch.serving.cli --port 29600 --clients 1

    # self-contained demo: an in-process client drives N mixed greedy/sampled
    # requests through the whole frontend path, prints the SLO summary, exits
    python -m distributed_ml_pytorch_tpu_torch.serving.cli --demo 6

It runs on the card (``--backend cuda``, the default) unless ``--backend
cpu`` is given; without a card the default raises. Engine knobs:
``--slots``, ``--cache-size`` (rows per slot: prompt + padded decode
blocks), ``--decode-block``, ``--kv-quant`` (int8 slot caches),
``--max-queue`` (backpressure), ``--prefill-bucket``, and the overload
plane's ``--slo-ttft-ms``, ``--shed-occupancy``, ``--brownout-occupancy``,
``--brownout-max-new``. ``--fleet``, ``--coord``, ``--reliable``,
``--ckpt-dir`` and ``--metrics-dump`` are not ported yet and exit with an
error.
"""

from __future__ import annotations

import argparse
import json
import sys

#: flags of the JAX CLI that the port does not have yet
NOT_PORTED = ("fleet", "coord", "reliable", "ckpt_dir", "metrics_dump")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Continuous-batching TransformerLM serving engine")
    # model size
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=4,
                   help="attention heads (the card's kernels take head_dim 32, 64 or 128)")
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=256)
    p.add_argument("--max-len", type=int, default=0,
                   help="learned-position table size (0 = derived from --cache-size)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--pos-encoding", default="learned", choices=["learned", "rope"])
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
    p.add_argument("--client-deadline", type=float, default=30.0, metavar="SEC",
                   help="cancel and free a request whose client has been silent this long")
    p.add_argument("--demo", type=int, default=0, metavar="N",
                   help="serve N synthetic requests from an in-process client, print the "
                        "SLO summary, exit")
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
    # the JAX CLI's other modes, not ported yet
    p.add_argument("--fleet", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--coord", type=str, default="", help=argparse.SUPPRESS)
    p.add_argument("--reliable", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--ckpt-dir", type=str, default="", help=argparse.SUPPRESS)
    p.add_argument("--metrics-dump", type=str, default="", help=argparse.SUPPRESS)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name in NOT_PORTED:
        if getattr(args, name):
            parser.error(f"--{name.replace('_', '-')} is not ported yet")
    if args.d_model % args.n_heads:
        parser.error(f"--d-model {args.d_model} must divide by --n-heads {args.n_heads}")
    return args


def build_engine(args):
    import torch

    from distributed_ml_pytorch_tpu_torch.models.transformer import TransformerLM
    from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine

    lm = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        max_len=args.max_len or max(args.cache_size, 256),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        pos_encoding=args.pos_encoding, seed=args.seed, device=args.backend)
    return ServingEngine(
        lm, slots=args.slots, cache_size=args.cache_size, decode_block=args.decode_block,
        kv_quant=args.kv_quant, max_queue=args.max_queue, prefill_bucket=args.prefill_bucket)


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


def run_demo(args, engine) -> int:
    import threading

    from distributed_ml_pytorch_tpu_torch.serving.frontend import (
        ServingClient,
        ServingFrontend,
    )
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    world = InProcessTransport.create_world(2)
    frontend = ServingFrontend(
        engine, world[0], slo_ttft_ms=args.slo_ttft_ms, shed_occupancy=args.shed_occupancy,
        brownout_occupancy=args.brownout_occupancy, brownout_max_new=args.brownout_max_new)
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
        print("serving demo complete")
        return 0
    finally:
        frontend.stop()
        server.join(timeout=5)
        for t in world.values():
            t.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    print(args)
    engine = build_engine(args)
    if args.demo:
        return run_demo(args, engine)

    from distributed_ml_pytorch_tpu_torch.serving.frontend import ServingFrontend
    from distributed_ml_pytorch_tpu_torch.utils.messaging import TCPTransport

    transport = TCPTransport(rank=0, world_size=1 + args.clients, master=args.master,
                             port=int(args.port))
    frontend = ServingFrontend(
        engine, transport, client_deadline=args.client_deadline,
        slo_ttft_ms=args.slo_ttft_ms, shed_occupancy=args.shed_occupancy,
        brownout_occupancy=args.brownout_occupancy, brownout_max_new=args.brownout_max_new)
    print(f"serving on {args.master}:{args.port} ({args.slots} slots x {args.cache_size} "
          f"rows, block {args.decode_block}" + (", int8 kv" if args.kv_quant else "") + ")")
    try:
        frontend.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        frontend.stop()
        transport.close()
        _print_summary(engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
