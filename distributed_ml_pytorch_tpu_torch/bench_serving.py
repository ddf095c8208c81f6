"""Serving benchmark of the port (counterpart of the root ``bench_serving.py``):
synthetic arrivals through the continuous-batching engine
(``distributed_ml_pytorch_tpu_torch/serving/``), fleet mode included.

An open-loop load generator with four arrival mixes (``--arrival``):

- ``poisson``  — exponential inter-arrivals at ``--rate``;
- ``diurnal``  — a sinusoidally-modulated Poisson process (mean ``--rate``,
  peak/trough ±``--diurnal-amp``, one full "day" per ``--diurnal-period``
  seconds of bench time) via thinning;
- ``bursty``   — a two-state Markov-modulated Poisson process: ON windows
  at ``burst_factor × rate`` alternating with near-idle OFF windows;
- ``herd``     — thundering herd: ``--herd-frac`` of all requests arrive in
  one instant at the front, the rest Poisson behind them.

Goodput is measured under SLO, not just throughput: every request carries
``--deadline-ms`` (0 = off) and a priority from ``--priority-levels``; the
JSON reports ``goodput_slo_tok_s`` (tokens of requests that completed within
their deadline / wall), ``shed_rate`` (explicitly rejected / offered) and, in
fleet mode, the migration MTTR.

``--engines N`` (N >= 2) runs the full fleet path — N engine replicas
behind a :class:`~distributed_ml_pytorch_tpu_torch.serving.fleet.FleetRouter`,
an in-process transport, and a real client — and ``--kill-engine-at T``
crashes one replica T seconds into the run, so the JSON's MTTR and goodput
price an engine death, not a happy path. ``--autoscale`` runs a coordinator
whose engine-scaling advice spawns and retires replicas
(``FleetAutoscaler``).

The flags, defaults and the JSON line are the root script's; ``--backend``
picks the card (default) or the CPU, and the line's ``platform`` is ``gpu``
or ``cpu`` (``device`` names the card). Prints exactly one JSON line on
stdout; narration goes to stderr.

    python -m distributed_ml_pytorch_tpu_torch.bench_serving --requests 32 --rate 8 --slots 4
    python -m distributed_ml_pytorch_tpu_torch.bench_serving --engines 3 --kill-engine-at 2 \
        --deadline-ms 4000
    python -m distributed_ml_pytorch_tpu_torch.bench_serving --backend cpu --requests 6
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--rate", type=float, default=8.0,
                   help="mean arrival rate, requests/sec")
    p.add_argument("--arrival", default="poisson",
                   choices=["poisson", "diurnal", "bursty", "herd"])
    p.add_argument("--diurnal-amp", type=float, default=0.8,
                   help="diurnal modulation depth in [0,1)")
    p.add_argument("--diurnal-period", type=float, default=8.0,
                   help="seconds per synthetic 'day'")
    p.add_argument("--burst-factor", type=float, default=6.0,
                   help="ON-state rate multiplier (bursty)")
    p.add_argument("--burst-on", type=float, default=0.5,
                   help="mean ON-window seconds (bursty)")
    p.add_argument("--burst-off", type=float, default=1.5,
                   help="mean OFF-window seconds (bursty)")
    p.add_argument("--herd-frac", type=float, default=0.5,
                   help="fraction of requests arriving at t=0 (herd)")
    p.add_argument("--deadline-ms", type=int, default=0,
                   help="per-request completion deadline (0 = no SLO; "
                        "goodput then equals throughput)")
    p.add_argument("--priority-levels", type=int, default=1,
                   help="requests draw priority uniformly from [0, L) — "
                        "the overload plane sheds lowest first")
    # fleet mode
    p.add_argument("--engines", type=int, default=1,
                   help=">= 2 runs the FleetRouter path (full transport + "
                        "client); 1 drives one engine directly")
    p.add_argument("--kill-engine-at", type=float, default=0.0,
                   help="crash one replica this many seconds into the "
                        "fleet run (0 = no kill) — prices migration")
    # autoscale mode: the coordinator's check_engine_scaling
    # advisory drives a REAL spawn/retire loop (FleetAutoscaler) instead
    # of just logging advice; the JSON reports the scale-up MTTR
    p.add_argument("--autoscale", action="store_true",
                   help="run a coordinator whose scaling advice actually "
                        "spawns/retires replicas (implies the fleet path)")
    p.add_argument("--autoscale-max", type=int, default=4,
                   help="replica ceiling for the autoscaler")
    p.add_argument("--scale-occ-high", type=float, default=0.85,
                   help="mean engine occupancy that advises scale-UP")
    p.add_argument("--scale-occ-low", type=float, default=0.15,
                   help="mean engine occupancy that advises scale-DOWN")
    p.add_argument("--scale-cooldown", type=float, default=1.0,
                   help="seconds between scaling decisions")
    p.add_argument("--shed-occupancy", type=float, default=0.0)
    p.add_argument("--brownout-occupancy", type=float, default=0.0)
    p.add_argument("--brownout-max-new", type=int, default=0)
    p.add_argument("--slo-ttft-ms", type=float, default=0.0)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--cache-size", type=int, default=160)
    p.add_argument("--decode-block", type=int, default=8)
    p.add_argument("--kv-quant", action="store_true")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--prefill-bucket", type=int, default=16)
    p.add_argument("--prompt-len", type=int, nargs=2, default=(4, 16),
                   metavar=("LO", "HI"))
    p.add_argument("--new-tokens", type=int, nargs=2, default=(8, 48),
                   metavar=("LO", "HI"))
    p.add_argument("--sampled-frac", type=float, default=0.5,
                   help="fraction of requests using temperature sampling")
    # tiny-LM shape: serving overhead is the subject, not model FLOPs
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json-out", type=str, default="",
                   help="also write the result JSON to this file")
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    return p


def make_arrivals(args, rng: np.random.Generator) -> np.ndarray:
    """Sorted arrival times (seconds from bench start) for ``--requests``
    requests under the chosen mix. Pure function of (args, rng) so a run
    is reproducible from its seed."""
    n, rate = args.requests, args.rate
    if args.arrival == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, n))
    if args.arrival == "diurnal":
        # thinning: candidates at the peak rate, kept w.p. rate(t)/peak
        amp = min(max(args.diurnal_amp, 0.0), 0.99)
        peak = rate * (1.0 + amp)
        out, t = [], 0.0
        while len(out) < n:
            t += rng.exponential(1.0 / peak)
            lam = rate * (1.0 + amp * np.sin(
                2.0 * np.pi * t / args.diurnal_period))
            if rng.uniform() * peak < lam:
                out.append(t)
        return np.asarray(out)
    if args.arrival == "bursty":
        # MMPP-2: exponential ON/OFF sojourns, Poisson within each state
        out, t, on = [], 0.0, True
        while len(out) < n:
            dwell = rng.exponential(args.burst_on if on else args.burst_off)
            lam = rate * (args.burst_factor if on else 0.1)
            tt = t + rng.exponential(1.0 / lam) if lam > 0 else t + dwell
            while tt < t + dwell and len(out) < n:
                out.append(tt)
                tt += rng.exponential(1.0 / lam)
            t += dwell
            on = not on
        return np.asarray(out)
    if args.arrival == "herd":
        k = int(round(n * min(max(args.herd_frac, 0.0), 1.0)))
        herd = np.zeros(k)  # everyone at once: the adversarial front
        tail = np.cumsum(rng.exponential(1.0 / rate, n - k)) if n > k else []
        return np.sort(np.concatenate([herd, np.asarray(tail)]))
    raise ValueError(f"unknown arrival mix {args.arrival!r}")


def make_plan(args, rng: np.random.Generator):
    plo, phi = args.prompt_len
    nlo, nhi = args.new_tokens
    return [
        dict(
            prompt=rng.integers(
                0, args.vocab, size=int(rng.integers(plo, phi + 1))),
            max_new_tokens=int(rng.integers(nlo, nhi + 1)),
            priority=int(rng.integers(0, max(1, args.priority_levels))),
            **({"temperature": 0.8, "top_k": 16, "seed": int(i)}
               if rng.random() < args.sampled_frac else {}),
        )
        for i in range(args.requests)
    ]


def _build_engine(args):
    import torch

    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine

    lm = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        max_len=max(args.cache_size, 256), dtype=torch.float32, seed=args.seed,
        device=args.backend)

    def make():
        return ServingEngine(
            lm, slots=args.slots, cache_size=args.cache_size,
            decode_block=args.decode_block, kv_quant=args.kv_quant,
            max_queue=args.max_queue, prefill_bucket=args.prefill_bucket)

    return make


def _warmup(args, engine) -> None:
    # warmup: run every prefill bucket the prompt-length range can hit plus
    # the decode block outside the timed window — a bucket's first call
    # (cuBLAS handles, the allocator) inside the loop would land in the
    # TTFT percentiles
    plo, phi = args.prompt_len
    for bucket_len in sorted({
            max(2, -(-int(L) // args.prefill_bucket) * args.prefill_bucket)
            for L in range(plo, phi + 1)}):
        # a bucket-length prompt maps exactly to its own bucket (a shorter
        # one can fall into a smaller bucket at --prefill-bucket 1)
        w = engine.submit(np.zeros(bucket_len, np.int32),
                          args.decode_block + 2)
        engine.run_until_idle()
        assert w.done
    engine.reset_metrics()  # warmup must not pollute the SLO samples


def run_single(args) -> dict:
    """One engine driven directly (the original path + SLO accounting)."""
    rng = np.random.default_rng(args.seed)
    engine = _build_engine(args)()
    _warmup(args, engine)
    arrivals = make_arrivals(args, rng)
    plan = make_plan(args, rng)
    for spec in plan:
        spec.pop("priority", None)  # engine API has no overload plane
    log(f"offered load: {args.requests} requests, {args.arrival} arrivals "
        f"at {args.rate}/s mean")
    handles, deadlines = [], []
    next_i = 0
    t0 = time.perf_counter()
    while len(handles) < args.requests or not all(h.done for h in handles):
        now = time.perf_counter() - t0
        while next_i < args.requests and arrivals[next_i] <= now:
            handles.append(engine.submit(**plan[next_i]))
            deadlines.append(
                now + args.deadline_ms / 1e3 if args.deadline_ms else None)
            next_i += 1
        if not engine.step():
            if next_i < args.requests:
                time.sleep(min(0.002, max(0.0, arrivals[next_i] - now)))
    wall = time.perf_counter() - t0
    good_tokens = total_tokens = 0
    met = 0
    for h, dl in zip(handles, deadlines):
        total_tokens += len(h.tokens)
        done_at = h.t_done - t0
        within = dl is None or done_at <= dl
        if within:
            met += 1
            good_tokens += len(h.tokens)
    return {
        "engine": engine, "wall": wall, "total_tokens": total_tokens,
        "good_tokens": good_tokens, "completed_in_slo": met,
        "shed": 0, "rejected_client_side": 0, "mttr_s": None,
        "migrations": 0, "summary": engine.slo_summary(),
    }


def run_fleet(args) -> dict:
    """N replicas behind a FleetRouter over a real in-process transport;
    optional mid-run engine kill to price migration."""
    import threading

    from distributed_ml_pytorch_tpu_torch.serving.fleet import (
        EngineMember,
        FleetRouter,
    )
    from distributed_ml_pytorch_tpu_torch.serving.frontend import ServingClient
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    rng = np.random.default_rng(args.seed)
    make = _build_engine(args)
    engines = [make() for _ in range(args.engines)]
    for e in engines:
        _warmup(args, e)
    coord = coord_thread = autoscaler = None
    if args.autoscale:
        # the full advisory->actuator loop: engine members lease into a
        # real coordinator, renewals carry occupancy/TTFT, and the
        # coordinator's check_engine_scaling advice lands on a
        # FleetAutoscaler that spawns/retires replicas on the router
        from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
        from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
        from distributed_ml_pytorch_tpu_torch.serving.fleet import FleetAutoscaler

        cap = max(args.autoscale_max, args.engines)
        coord_world = InProcessTransport.create_world(1 + cap)
        coord = Coordinator(
            coord_world[0], 1, lease=2.0, speculation=False,
            engine_occ_high=args.scale_occ_high,
            engine_occ_low=args.scale_occ_low,
            scale_cooldown=args.scale_cooldown)
        coord_thread = threading.Thread(
            target=coord.run, name="bench-coord", daemon=True)
        coord_thread.start()

        def _member(eid: int, engine) -> EngineMember:
            client = CoordClient(coord_world[1 + eid], "engine",
                                 renew_interval=0.1)
            return EngineMember(eid, engine, coord=client,
                                report_interval=0.1)

        members = [_member(i, e).start() for i, e in enumerate(engines)]
    else:
        members = [EngineMember(i, e).start() for i, e in enumerate(engines)]
    world = InProcessTransport.create_world(2)
    router = FleetRouter(
        world[0], members, probe_timeout=0.5,
        # the raw frame collector below never sends StreamAck, so the
        # silent-client reaper must stay out of the way — a reaped stream
        # would be counted as a (truncated) completion
        client_deadline=3600.0,
        slo_ttft_ms=args.slo_ttft_ms, shed_occupancy=args.shed_occupancy,
        brownout_occupancy=args.brownout_occupancy,
        brownout_max_new=args.brownout_max_new)
    if args.autoscale:
        def member_factory() -> EngineMember:
            used = set(router.members.keys())
            eid = next(i for i in range(cap) if i not in used)
            engine = make()
            _warmup(args, engine)
            engines.append(engine)
            log(f"autoscaler: spawning engine {eid}")
            return _member(eid, engine)

        autoscaler = FleetAutoscaler(
            router, member_factory, min_engines=1, max_engines=cap)
        coord.on_scale = autoscaler.on_scale
    server = threading.Thread(target=router.serve_forever, daemon=True)
    server.start()
    client = ServingClient(world[1])
    arrivals = make_arrivals(args, rng)
    plan = make_plan(args, rng)
    log(f"fleet: {args.engines} engines, {args.requests} requests, "
        f"{args.arrival} arrivals at {args.rate}/s mean"
        + (f", kill at {args.kill_engine_at}s" if args.kill_engine_at
           else ""))
    # collector state: rid -> [tokens, done_at, rejected]
    state = {}
    t0 = time.perf_counter()
    next_i, killed = 0, False
    submitted = []
    while True:
        now = time.perf_counter() - t0
        if (args.kill_engine_at and not killed
                and now >= args.kill_engine_at):
            members[0].crash()  # silent death; the router's probe detects
            killed = True
            log(f"killed engine 0 at {now:.2f}s")
        while next_i < args.requests and arrivals[next_i] <= now:
            spec = dict(plan[next_i])
            rid = client.submit(
                spec.pop("prompt"), spec.pop("max_new_tokens"),
                priority=spec.pop("priority", 0),
                deadline_ms=args.deadline_ms, **spec)
            state[rid] = [[], None, False]
            submitted.append(rid)
            next_i += 1
        # drain frames without the generator machinery (lossless wire)
        msg = world[1].recv(timeout=0.002)
        if msg is not None:
            _s, code, payload = msg
            if payload.size >= 1:
                rid = int(payload[0])
                entry = state.get(rid)
                if entry is not None:
                    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
                        MessageCode,
                    )

                    if code == MessageCode.ServeReject:
                        entry[2] = True
                        entry[1] = time.perf_counter() - t0
                    elif code == MessageCode.StreamTokens \
                            and payload.size >= 3:
                        start = int(payload[2])
                        toks = payload[3:].astype(np.int32).tolist()
                        have = entry[0]
                        fresh = toks[max(0, len(have) - start):]
                        if start <= len(have) and fresh:
                            have.extend(fresh)
                        if payload[1] and entry[1] is None \
                                and start + len(toks) <= len(have):
                            entry[1] = time.perf_counter() - t0
        if next_i >= args.requests and all(
                s[1] is not None for s in state.values()):
            break
        if time.perf_counter() - t0 > 600:
            log("bench safety timeout: giving up on stragglers")
            break
    wall = time.perf_counter() - t0
    router.stop()
    server.join(timeout=5)
    for t in world.values():
        t.close()
    autoscale_info = None
    if autoscaler is not None:
        autoscaler.quiesce()
        autoscale_info = autoscaler.summary()
        coord.stop()
        coord_thread.join(timeout=5)
        for t in coord_world.values():
            t.close()
        log(f"autoscaler: {autoscale_info}")
    good_tokens = total_tokens = met = shed = 0
    for i, rid in enumerate(submitted):
        toks, done_at, rejected = state[rid]
        total_tokens += len(toks)
        if rejected:
            shed += 1
            continue
        if done_at is None:
            continue
        dl = (arrivals[i] + args.deadline_ms / 1e3
              if args.deadline_ms else None)
        if dl is None or done_at <= dl:
            met += 1
            good_tokens += len(toks)
    return {
        "engine": engines[-1], "wall": wall, "total_tokens": total_tokens,
        "good_tokens": good_tokens, "completed_in_slo": met,
        "shed": router.shed + router.migration_failures,
        "rejected_client_side": shed, "mttr_s": router.mttr_s(),
        "migrations": router.migrations,
        "summary": engines[-1].slo_summary(),
        "autoscale": autoscale_info,
    }


def _platform(args):
    """``(platform, device name)`` of ``--backend``; the card must be there."""
    if args.backend == "cpu":
        return "cpu", "cpu"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("--backend cuda: no CUDA device (pass --backend cpu for the CPU)")
    return "gpu", torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    platform, device = _platform(args)
    r = (run_fleet(args) if args.engines >= 2 or args.autoscale
         else run_single(args))
    wall, total = r["wall"], r["total_tokens"]
    throughput = total / wall if wall > 0 else 0.0
    goodput = r["good_tokens"] / wall if wall > 0 else 0.0
    summary = r["summary"]
    log(f"served {args.requests} requests / {total} tokens in {wall:.2f}s "
        f"-> {throughput:.1f} tok/s ({goodput:.1f} goodput-under-SLO) on "
        f"{device}")

    result = {
        "metric": "serving_decode_throughput",
        "value": round(throughput, 2),
        "unit": "tokens/sec",
        "requests": args.requests,
        "offered_rate_rps": args.rate,
        "arrival": args.arrival,
        "wall_s": round(wall, 3),
        # --- goodput under SLO, not just throughput ---
        "deadline_ms": args.deadline_ms,
        "goodput_slo_tok_s": round(goodput, 2),
        "completed_in_slo": r["completed_in_slo"],
        "shed": r["shed"],
        "shed_rate": round(r["rejected_client_side"] / args.requests, 4),
        "migrations": r["migrations"],
        "migration_mttr_s": (round(r["mttr_s"], 4)
                             if r["mttr_s"] is not None else None),
        "engines": args.engines,
        # --- autoscale loop: advice -> actual spawn/retire ---
        "autoscaled": bool(r.get("autoscale")),
        "scaled_up": (r["autoscale"]["scaled_up"]
                      if r.get("autoscale") else 0),
        "scaled_down": (r["autoscale"]["scaled_down"]
                        if r.get("autoscale") else 0),
        "scale_up_mttr_s": (
            round(float(np.mean(r["autoscale"]["scale_up_mttr_s"])), 4)
            if r.get("autoscale") and r["autoscale"]["scale_up_mttr_s"]
            else None),
        "ttft_ms": summary["ttft_ms"],
        "tpot_ms": summary["tpot_ms"],
        "queue_depth": summary["queue_depth"],
        "slot_occupancy": round(summary["slot_occupancy"], 4),
        "slots": args.slots,
        "decode_block": args.decode_block,
        "kv_quant": bool(args.kv_quant),
        "platform": platform,
        "device": device,
    }
    line = json.dumps(result)
    print(line)
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            fh.write(line + "\n")
        log(f"wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
