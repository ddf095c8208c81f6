"""The port's serving fleet (``serving/fleet.py``: ``EngineMember``,
``FleetRouter`` with its KvMigrate handoff, ``FleetAutoscaler``), the
frontend's fleet hold and the serving CLI's ``--fleet``, ``--coord``,
``--reliable`` and ``--ckpt-dir``, on the CPU beside the JAX package's
(the counterparts of JAX ``tests/test_fleet.py``).

The model is tiny (vocab 64, d_model 32, 4 heads, 2 layers), float32, its
weights carried from the JAX model with ``utils/interop.params_from_jax``,
so a greedy stream of the port's fleet can be held to the JAX fleet's
token for token (where the JAX logits' top-2 margins are at least 1e-3,
asserted). Streams migrated across an engine's death are held to the
port's own single-engine ``generate()``, greedy and sampled.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models.transformer import TransformerLM as JLM
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.models.generate import generate
from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine
from distributed_ml_pytorch_tpu_torch.serving.fleet import (
    EngineMember,
    FleetAutoscaler,
    FleetRouter,
)
from distributed_ml_pytorch_tpu_torch.serving.frontend import (
    RequestRejected,
    ServingClient,
    ServingFrontend,
)
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosPlan, FaultRule, FaultyTransport
from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport, MessageCode

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=256)
MARGIN = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lm():
    jlm = JLM(**CFG)
    params = jlm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(**CFG, device="cpu")
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, params), model))
    return jlm, params, model


def make_engine(model, warm=True, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("cache_size", 200)
    kw.setdefault("decode_block", 4)
    kw.setdefault("prefill_bucket", 8)
    engine = ServingEngine(model, **kw)
    if warm:
        for bucket in (8, 16):
            if engine.pool.capacity_needed(bucket, bucket, 6) <= engine.pool.cache_size:
                w = engine.submit(np.zeros(bucket, np.int32), 6)
                engine.run_until_idle()
                assert w.done
        engine.reset_metrics()
    return engine


def expected(model, prompt, n, **kw):
    out = generate(model, np.asarray(prompt, np.int32)[None], n, **kw)
    return out[0, len(prompt):].tolist()


def fleet_world(model, n_engines=3, plan=None, router_kw=None, member_coords=None,
                member_kw=None):
    """N warmed engines behind a ``FleetRouter`` on a two-rank world (rank 0
    the hub, rank 1 the client), chaos-wrapped under ``plan``."""
    world = InProcessTransport.create_world(2)
    log = None
    if plan is not None:
        world, log = FaultyTransport.wrap_world(world, plan)
    members = [EngineMember(i, make_engine(model),
                            coord=member_coords[i] if member_coords else None,
                            **(member_kw or {})).start()
               for i in range(n_engines)]
    kw = {"probe_timeout": 0.5, **(router_kw or {})}
    router = FleetRouter(world[0], members, **kw)
    thread = threading.Thread(target=router.serve_forever, daemon=True)
    thread.start()
    return world, members, router, thread, log


def teardown_fleet(world, router, thread):
    router.stop()
    thread.join(timeout=10)
    for t in world.values():
        t.close()


def wait_for(cond, timeout=30.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def in_flight(router, victim, min_tokens=2):
    """True once a route has streamed ``min_tokens``; its engine goes into
    ``victim["id"]``."""
    with router._routes_lock:
        for r in router._routes.values():
            if not r.done and r.engine_id >= 0 and len(r.tokens) >= min_tokens:
                victim["id"] = r.engine_id
                return True
    return False


# ------------------------------------------------------------------ engine
def test_gen_offset_resume_is_token_identical(lm):
    model = lm[2]
    prompt = np.random.default_rng(1).integers(0, VOCAB, size=5)
    for kw in ({}, {"temperature": 0.8, "top_k": 8, "seed": 11}):
        want = expected(model, prompt, 20, **kw)
        engine_a = make_engine(model)
        full = engine_a.submit(prompt, 20, **kw)
        engine_a.run_until_idle()
        assert full.tokens == want
        for cut in (1, 7, 19):
            engine_b = make_engine(model, warm=False)
            resumed = engine_b.submit(np.concatenate([prompt, np.asarray(want[:cut], np.int32)]),
                                      20 - cut, gen_offset=cut, **kw)
            engine_b.run_until_idle()
            assert resumed.tokens == want[cut:], (kw, cut)


# ----------------------------------------------------------------- routing
def test_router_routes_by_occupancy_and_session_affinity(lm):
    world, members, router, thread, _ = fleet_world(lm[2], 2)
    try:
        client = ServingClient(world[1])
        rids = [client.submit(np.arange(4), 60) for _ in range(4)]
        assert wait_for(lambda: len(router._routes) == 4)
        with router._routes_lock:
            used = sorted(r.engine_id for r in router._routes.values())
        assert used.count(0) == 2 and used.count(1) == 2
        for rid in rids:
            assert len(list(client.stream(rid, timeout=120))) == 60
        sids = [client.submit(np.arange(4), 4, session=9) for _ in range(2)]
        assert wait_for(lambda: len([r for r in router._routes.values()
                                     if r.session == 9]) == 2)
        with router._routes_lock:
            pinned = {r.engine_id for r in router._routes.values() if r.session == 9}
        assert len(pinned) == 1
        for rid in sids:
            list(client.stream(rid, timeout=60))
    finally:
        teardown_fleet(world, router, thread)


def test_gray_probation_bends_new_work_away_without_removal(lm):
    world, members, router, thread, _ = fleet_world(lm[2], 2)
    try:
        router.note_gray(0)
        client = ServingClient(world[1])
        rid = client.submit(np.arange(4), 8)
        assert wait_for(lambda: len(router._routes) == 1)
        with router._routes_lock:
            assert [r.engine_id for r in router._routes.values()] == [1]
        assert len(list(client.stream(rid, timeout=60))) == 8
        assert router.fleet_summary()["engines"][0]["up"] is True
        router.clear_gray(0)
    finally:
        teardown_fleet(world, router, thread)


# --------------------------------------------------------------- migration
def _acceptance_plan():
    # faults on channels with deterministic indices only: the hub's first 8
    # StreamTokens frames (the client's resume recovers them) and the
    # client's 3 SubmitRequest frames (a duplicate replays, never resubmits)
    return ChaosPlan([FaultRule(code=int(MessageCode.StreamTokens), drop=0.4, until=8),
                      FaultRule(code=int(MessageCode.SubmitRequest), dup=0.3)], seed=29)


SPECS = [dict(n=120), dict(n=100, temperature=0.8, top_k=8, seed=3), dict(n=90)]


def _run_fleet_once(model, plan=None):
    world, members, router, thread, log = fleet_world(model, 3, plan=plan)
    try:
        client = ServingClient(world[1], resume_after=0.25)
        prompt = np.random.default_rng(0).integers(0, VOCAB, size=5)
        rids = []
        for s in SPECS:
            s = dict(s)
            rids.append(client.submit(prompt, s.pop("n"), **s))
        victim = {}
        assert wait_for(lambda: in_flight(router, victim)), "no stream ever got mid-decode"
        members[victim["id"]].crash()
        streams = [list(client.stream(r, timeout=180)) for r in rids]
        assert wait_for(lambda: router.migrations >= 1, timeout=5)
        return prompt, streams, (log.lines() if log is not None else ""), router.fleet_summary()
    finally:
        teardown_fleet(world, router, thread)


def test_fleet_migration_token_identical_3x(lm):
    """One engine killed mid-decode under seeded chaos: every in-flight
    stream completes token-identical to a single-engine ``generate()``,
    three runs, byte-identical chaos logs; the handoffs crossed KvMigrate
    frames."""
    model = lm[2]
    logs = []
    for _ in range(3):
        prompt, streams, lines, summary = _run_fleet_once(model, _acceptance_plan())
        for spec, got in zip(SPECS, streams):
            s = dict(spec)
            assert got == expected(model, prompt, s.pop("n"), **s), spec
        assert summary["migrations"] >= 1 and summary["migration_failures"] == 0
        assert summary["handoffs"] >= 1 and summary["handoff_drops"] == 0
        assert summary["mttr_s"] is not None
        logs.append(lines)
    assert logs[0] == logs[1] == logs[2] and logs[0]


def test_greedy_fleet_streams_equal_the_jax_fleets(lm):
    """The same requests through both packages' fleets of three engines,
    one of the port's crashed mid-stream and its streams migrated: the
    greedy streams equal the JAX fleet's token for token (and the JAX
    single-engine generate, on margins of at least 1e-3). The JAX fleet
    runs uninterrupted: under a loaded host its engines' first compiles
    of the longer re-prefill buckets once took the other engines down."""
    from distributed_ml_pytorch_tpu.models.generate import generate as jgenerate
    from distributed_ml_pytorch_tpu.serving.engine import ServingEngine as JEngine
    from distributed_ml_pytorch_tpu.serving.fleet import EngineMember as JMember
    from distributed_ml_pytorch_tpu.serving.fleet import FleetRouter as JRouter
    from distributed_ml_pytorch_tpu.serving.frontend import ServingClient as JClient
    from distributed_ml_pytorch_tpu.utils.messaging import InProcessTransport as JIPT

    jlm, params, model = lm
    specs = [dict(n=60), dict(n=48), dict(n=40)]
    prompt = np.random.default_rng(0).integers(0, VOCAB, size=5)

    def jax_engine():
        e = JEngine(jlm, params, slots=2, cache_size=200, decode_block=4, prefill_bucket=8)
        for bucket in (8, 16):
            w = e.submit(np.zeros(bucket, np.int32), 6)
            e.run_until_idle()
            assert w.done
        e.reset_metrics()
        return e

    def run(member_cls, router_cls, client_cls, ipt, make, crash):
        world = ipt.create_world(2)
        members = [member_cls(i, make()).start() for i in range(3)]
        # a crash reads as dead at once (``alive``); the long probe keeps a
        # JAX engine's first compile from reading as one
        router = router_cls(world[0], members, probe_timeout=30.0)
        thread = threading.Thread(target=router.serve_forever, daemon=True)
        thread.start()
        try:
            client = client_cls(world[1], resume_after=0.25)
            rids = [client.submit(prompt, s["n"]) for s in specs]
            if crash:
                victim = {}
                assert wait_for(lambda: in_flight(router, victim), timeout=60)
                members[victim["id"]].crash()
            out = [list(client.stream(r, timeout=180)) for r in rids]
            assert (router.migrations >= 1) == crash
            return out
        finally:
            teardown_fleet(world, router, thread)

    port = run(EngineMember, FleetRouter, ServingClient, InProcessTransport,
               lambda: make_engine(model), crash=True)
    jax_streams = run(JMember, JRouter, JClient, JIPT, jax_engine, crash=False)
    assert port == jax_streams
    for spec, got in zip(specs, jax_streams):
        want = np.asarray(jgenerate(jlm, params, jnp.asarray(prompt, jnp.int32)[None],
                                    spec["n"]))[0, len(prompt):].tolist()
        assert got == want
        seq = np.concatenate([prompt, got])[None].astype(np.int32)
        logits = np.asarray(jlm.apply({"params": params}, seq))[0, len(prompt) - 1:-1]
        top2 = np.sort(logits, -1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) >= MARGIN


def test_lease_expiry_triggers_migration(lm):
    """A member whose renewals stop while its serve loop beats: the
    coordinator's fleet view drops its rank, and that alone migrates its
    stream token-identically."""
    from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
    from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient

    model = lm[2]
    coord_world = InProcessTransport.create_world(4)
    coord = Coordinator(coord_world[0], n_params=8, lease=0.6)
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": 120}, daemon=True)
    coord_thread.start()
    clients = [CoordClient(coord_world[i], "engine", renew_interval=0.1) for i in (1, 2, 3)]
    world, members, router, thread, _ = fleet_world(
        model, 3, router_kw={"probe_timeout": 60.0, "fleet": coord}, member_coords=clients,
        member_kw={"throttle": 0.05})
    try:
        assert wait_for(lambda: len(coord.live_engine_ranks()) == 3, timeout=10)
        client = ServingClient(world[1], resume_after=0.25)
        prompt = np.random.default_rng(2).integers(0, VOCAB, size=6)
        rid = client.submit(prompt, 110)
        victim = {}
        assert wait_for(lambda: in_flight(router, victim))
        members[victim["id"]].coord.stop()  # only the control-plane life dies
        assert wait_for(lambda: victim["id"] not in
                        {m.engine_id for m in router._healthy_members()}, timeout=10)
        assert list(client.stream(rid, timeout=180)) == expected(model, prompt, 110)
        assert router.migrations >= 1
    finally:
        teardown_fleet(world, router, thread)
        coord.stop()
        coord_thread.join(timeout=10)
        for c in clients:
            c.stop()
        for t in coord_world.values():
            t.close()


def test_a_fleet_with_no_survivor_parks_and_resumes(lm):
    """Every engine down at once: the streams park (nothing is rejected),
    and a replica added later takes them, token-identical."""
    model = lm[2]
    world, members, router, thread, _ = fleet_world(model, 1)
    try:
        client = ServingClient(world[1], resume_after=0.25)
        prompt = np.random.default_rng(5).integers(0, VOCAB, size=4)
        rid = client.submit(prompt, 40)
        victim = {}
        assert wait_for(lambda: in_flight(router, victim))
        members[0].crash()
        assert wait_for(lambda: router.parked >= 1, timeout=10)
        router.add_member(EngineMember(7, make_engine(model)).start())
        assert list(client.stream(rid, timeout=120)) == expected(model, prompt, 40)
        assert router.migrations >= 1 and router.mttr_s() is not None
    finally:
        teardown_fleet(world, router, thread)


# ---------------------------------------------------------------- KvMigrate
class _DeadEngine:
    def __init__(self, kv):
        self.kv = kv
        self.cancelled = []

    def kv_lane(self, key):
        return self.kv

    def cancel(self, key):
        self.cancelled.append(key)


@pytest.mark.parametrize("with_kv", [True, False])
def test_kvmigrate_frames_equal_jax_bytes(with_kv):
    """One dying stream's handoff frame, built by both routers from the
    same token history and KV lane: equal bytes, and both decode it to
    the same tokens and lane."""
    from distributed_ml_pytorch_tpu.serving.fleet import FleetRouter as JRouter
    from distributed_ml_pytorch_tpu.serving.frontend import _Route as JRoute
    from distributed_ml_pytorch_tpu_torch.serving.frontend import _Route

    rng = np.random.default_rng(3)
    kv = rng.standard_normal(700).astype(np.float32) if with_kv else None
    tokens = [int(t) for t in rng.integers(0, 50000, size=37)]
    frames, decoded = [], []
    for cls, route_cls in ((FleetRouter, _Route), (JRouter, JRoute)):
        router = cls.__new__(cls)
        for name, v in dict(handoffs=0, handoff_drops=0, handoff_dense_floats=0,
                            handoff_wire_floats=0, _handoffs={}).items():
            setattr(router, name, v)
        sent = []
        router._send_handoff = lambda code, frame, sent=sent: sent.append((int(code), frame))
        dead = type("M", (), {"engine": _DeadEngine(kv)})()
        router._ship_handoff(123456789, route_cls(rank=1, rid=5, tokens=list(tokens)), dead)
        assert len(sent) == 1 and sent[0][0] == int(MessageCode.KvMigrate)
        frames.append(sent[0][1])
        router._on_handoff(0, MessageCode.KvMigrate, sent[0][1])
        decoded.append(router._handoffs[123456789])
        assert router.handoffs == 1 and router.handoff_drops == 0
        assert router.handoff_wire_floats == frames[-1].size
    assert frames[0].tobytes() == frames[1].tobytes()
    assert decoded[0][0] == decoded[1][0] == tokens
    if with_kv:
        np.testing.assert_array_equal(decoded[0][1], decoded[1][1])
        assert frames[0].size < len(tokens) + kv.size  # the coded wire is smaller
    else:
        assert decoded[0][1] is None and decoded[1][1] is None


def test_a_corrupt_handoff_is_dropped():
    from distributed_ml_pytorch_tpu_torch.serving.frontend import _Route

    router = FleetRouter.__new__(FleetRouter)
    for name, v in dict(handoffs=0, handoff_drops=0, handoff_dense_floats=0,
                        handoff_wire_floats=0, _handoffs={}).items():
        setattr(router, name, v)
    sent = []
    router._send_handoff = lambda code, frame: sent.append(frame)
    router._ship_handoff(9, _Route(rank=1, rid=1, tokens=[1, 2, 3]), None)
    frame = sent[0].copy()
    frame[-1] = np.float32(frame[-1] + 1.0)
    router._on_handoff(0, MessageCode.KvMigrate, frame)
    assert router.handoff_drops == 1 and 9 not in router._handoffs


# ---------------------------------------------------------------- overload
def overloaded_frontend(model, **kw):
    """A one-slot engine whose occupant keeps the pressure at 1 or more."""
    engine = make_engine(model, slots=1, cache_size=200, max_queue=16)
    world = InProcessTransport.create_world(2)
    frontend = ServingFrontend(engine, world[0], **kw)
    thread = threading.Thread(target=frontend.serve_forever, daemon=True)
    thread.start()
    return engine, world, frontend, thread


def _stop(frontend, thread, world):
    frontend.stop()
    if thread is not None:
        thread.join(timeout=10)
    for t in world.values():
        t.close()


def test_shed_lowest_priority_with_explicit_reject(lm):
    engine, world, frontend, thread = overloaded_frontend(lm[2], shed_occupancy=2.0)
    try:
        client = ServingClient(world[1])
        occupant = client.submit(np.arange(4), 120)
        assert wait_for(lambda: engine.pressure()[0] == 1)
        mid = client.submit(np.arange(4), 8, priority=2)
        assert wait_for(lambda: len(frontend._waiting_routes()) == 1)
        low = client.submit(np.arange(4), 8, priority=1)
        with pytest.raises(RequestRejected):
            list(client.stream(low, timeout=30))
        assert frontend.shed == 1
        high = client.submit(np.arange(4), 8, priority=5)
        with pytest.raises(RequestRejected):
            list(client.stream(mid, timeout=30))
        assert frontend.shed == 2
        assert len(list(client.stream(occupant, timeout=180))) == 120
        assert len(list(client.stream(high, timeout=60))) == 8
    finally:
        _stop(frontend, thread, world)


def test_brownout_caps_max_new_before_shedding(lm):
    engine, world, frontend, thread = overloaded_frontend(lm[2], brownout_occupancy=1.0,
                                                          brownout_max_new=5)
    try:
        client = ServingClient(world[1])
        occupant = client.submit(np.arange(4), 60)
        assert wait_for(lambda: engine.pressure()[0] == 1)
        dim = client.submit(np.arange(4), 40, priority=1)
        assert len(list(client.stream(dim, timeout=120))) == 5
        assert frontend.brownouts == 1 and frontend.shed == 0
        assert len(list(client.stream(occupant, timeout=120))) == 60
    finally:
        _stop(frontend, thread, world)


def test_deadline_expired_waiting_work_is_shed(lm):
    engine = make_engine(lm[2], slots=1, max_queue=16)
    world = InProcessTransport.create_world(2)
    frontend = ServingFrontend(engine, world[0])
    try:
        client = ServingClient(world[1])
        occupant = client.submit(np.arange(4), 30)
        doomed = client.submit(np.arange(4), 8, deadline_ms=100)
        assert wait_for(lambda: len(frontend._waiting_routes()) == 2)
        time.sleep(0.15)
        frontend._sweep(time.monotonic())
        assert frontend.shed == 1
        engine.run_until_idle()
        with pytest.raises(RequestRejected):
            list(client.stream(doomed, timeout=30))
        assert len(list(client.stream(occupant, timeout=60))) == 30
    finally:
        _stop(frontend, None, world)


# -------------------------------------------------------------- fleet hold
def test_frontend_fails_open_without_fleet(lm):
    engine = make_engine(lm[2])
    world = InProcessTransport.create_world(2)
    frontend = ServingFrontend(engine, world[0], fleet=None)
    thread = threading.Thread(target=frontend.serve_forever, daemon=True)
    thread.start()
    try:
        assert len(ServingClient(world[1]).generate(np.arange(5), 10, timeout=60)) == 10
        assert frontend.held_peak == 0
    finally:
        _stop(frontend, thread, world)


class _Fleet:
    def __init__(self, up=False, rollback=False):
        self.up = up
        self.rollback = rollback

    def engine_up(self):
        return self.up

    def rollback_active(self):
        return self.rollback


def test_hold_queue_overflow_under_down_fleet(lm):
    engine = make_engine(lm[2])
    fleet = _Fleet()
    world = InProcessTransport.create_world(2)
    frontend = ServingFrontend(engine, world[0], fleet=fleet, hold_queue=3)
    thread = threading.Thread(target=frontend.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(world[1])
        rids = [client.submit(np.arange(4), 6) for _ in range(5)]
        assert wait_for(lambda: frontend.held_peak == 3)
        with frontend._held_lock:
            assert len(frontend._held) == 3
        for rid in rids[3:]:
            with pytest.raises(RequestRejected):
                list(client.stream(rid, timeout=30))
        fleet.up = True
        for rid in rids[:3]:
            assert len(list(client.stream(rid, timeout=120))) == 6
        with frontend._held_lock:
            assert not frontend._held
    finally:
        _stop(frontend, thread, world)


def test_a_rollback_barrier_holds_submits_until_it_ends(lm):
    """The PS rollback hold: engines up, a barrier in flight; submits wait
    (a resume of a held request is not an error), and the end of the
    barrier re-admits them with their tokens intact."""
    model = lm[2]
    engine = make_engine(model)
    fleet = _Fleet(up=True, rollback=True)
    world = InProcessTransport.create_world(2)
    frontend = ServingFrontend(engine, world[0], fleet=fleet)
    thread = threading.Thread(target=frontend.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(world[1], resume_after=0.1)
        prompt = np.arange(5)
        rid = client.submit(prompt, 12)
        assert wait_for(lambda: frontend.held_peak == 1)
        time.sleep(0.3)  # resumes of the held request go unanswered, not rejected
        assert not frontend._routes
        fleet.rollback = False
        assert list(client.stream(rid, timeout=60)) == expected(model, prompt, 12)
    finally:
        _stop(frontend, thread, world)


# -------------------------------------------------------------- autoscaler
def test_autoscaler_acts_on_the_coordinators_advice(lm):
    """``Coordinator(on_scale=FleetAutoscaler.on_scale)``: engine renewals
    past ``engine_occ_high`` spawn a replica, below ``engine_occ_low``
    retire the emptiest; the bounds refuse past them."""
    from distributed_ml_pytorch_tpu_torch.coord.coordinator import (
        KIND_ENGINE,
        Coordinator,
        encode_join,
        encode_renew,
    )

    model = lm[2]
    world, members, router, thread, _ = fleet_world(model, 1)
    next_id = [10]

    def factory():
        next_id[0] += 1
        return EngineMember(next_id[0], make_engine(model, warm=False))

    scaler = FleetAutoscaler(router, factory, min_engines=1, max_engines=2)
    now = [100.0]
    coord = Coordinator(None, 8, engine_occ_high=0.8, engine_occ_low=0.2, scale_cooldown=1.0,
                        on_scale=scaler.on_scale, clock=lambda: now[0])
    try:
        coord.handle(1, MessageCode.CoordJoin, encode_join(KIND_ENGINE, 1))
        coord.handle(1, MessageCode.LeaseRenew, encode_renew(1, 95, 3, 40.0))
        assert coord.check_engine_scaling() == "up"
        assert scaler.quiesce(30)
        assert len(router.members) == 2 and scaler.scaled_up == 1
        assert wait_for(lambda: (scaler.poll() or scaler.scale_up_mttr_s), timeout=10)
        now[0] += 2.0
        assert coord.check_engine_scaling() == "up"  # past the bound: refused
        assert scaler.quiesce(30) and scaler.refused == 1 and len(router.members) == 2
        coord.handle(2, MessageCode.CoordJoin, encode_join(KIND_ENGINE, 1))
        coord.handle(1, MessageCode.LeaseRenew, encode_renew(1, 5, 0, 1.0))
        coord.handle(2, MessageCode.LeaseRenew, encode_renew(1, 5, 0, 1.0))
        now[0] += 2.0
        assert coord.check_engine_scaling() == "down"
        assert scaler.quiesce(30)
        assert len(router.members) == 1 and scaler.scaled_down == 1
        s = scaler.summary()
        assert s["n_engines"] == 1 and s["scale_up_mttr_s"]
        client = ServingClient(world[1])
        assert len(client.generate(np.arange(4), 6, timeout=60)) == 6
    finally:
        teardown_fleet(world, router, thread)


# --------------------------------------------------------------------- CLI
def test_serve_cli_fleet_demo_on_cpu(capsys):
    from distributed_ml_pytorch_tpu_torch.serving.cli import main

    rc = main(["--fleet", "2", "--demo", "4", "--backend", "cpu", "--vocab", "64",
               "--d-model", "32", "--n-heads", "4", "--n-layers", "1", "--d-ff", "64",
               "--slots", "2", "--cache-size", "64", "--decode-block", "4",
               "--prefill-bucket", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "serving demo complete" in out and "fleet summary:" in out


def test_serve_cli_flags_take_the_jax_names_and_defaults():
    from distributed_ml_pytorch_tpu.serving import cli as jcli
    from distributed_ml_pytorch_tpu_torch.serving import cli as tcli

    jargs, targs = vars(jcli.build_parser().parse_args([])), vars(tcli.parse_args([]))
    for name in ("fleet", "coord", "coord_rank", "reliable", "ckpt_dir"):
        assert targs[name] == jargs[name], name
    got = vars(tcli.parse_args(["--fleet", "3", "--coord", "h:1", "--coord-rank", "7",
                                "--reliable", "--ckpt-dir", "d"]))
    assert (got["fleet"], got["coord"], got["coord_rank"], got["reliable"],
            got["ckpt_dir"]) == (3, "h:1", 7, True, "d")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


SMALL = ["--backend", "cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
         "--n-layers", "1", "--d-ff", "64", "--slots", "2", "--cache-size", "64",
         "--decode-block", "4", "--prefill-bucket", "8"]


def test_serve_cli_fleet_registers_its_engines_with_the_coordinator(capsys):
    """``--fleet 2 --coord HOST:PORT --coord-rank 10``: each replica joins
    the coordination star as an engine of its own rank, and leaves at the
    end."""
    from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
    from distributed_ml_pytorch_tpu_torch.serving.cli import main
    from distributed_ml_pytorch_tpu_torch.utils.messaging import TCPTransport

    port = _free_port()
    hub = TCPTransport(rank=0, world_size=64, port=port, wait_for=0)
    coord = Coordinator(hub, 8, lease=5.0)
    t = threading.Thread(target=coord.run, kwargs={"timeout": 120}, daemon=True)
    t.start()
    try:
        assert main(["--fleet", "2", "--demo", "4", "--coord", f"localhost:{port}",
                     "--coord-rank", "10", *SMALL]) == 0
        events = list(coord.events)
        assert any("engine 10 joined" in e for e in events)
        assert any("engine 11 joined" in e for e in events)
        assert wait_for(lambda: not coord.members, timeout=10)  # both left
    finally:
        coord.stop()
        t.join(timeout=10)
        hub.close()


def test_serve_cli_reliable_coord_server_streams_to_a_reliable_client(lm, tmp_path):
    """``serve --reliable --coord``: a server process whose hub is a
    ``ReliableTransport`` and whose engine holds a lease; a reliable
    client streams a greedy request from it, equal to ``generate()`` on
    the CLI's seeded weights; SIGINT stops it with exit code 0."""
    from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
    from distributed_ml_pytorch_tpu_torch.serving import cli as tcli
    from distributed_ml_pytorch_tpu_torch.utils.messaging import ReliableTransport, TCPTransport

    cport, sport = _free_port(), _free_port()
    hub = TCPTransport(rank=0, world_size=64, port=cport, wait_for=0)
    coord = Coordinator(hub, 8, lease=5.0)
    t = threading.Thread(target=coord.run, kwargs={"timeout": 120}, daemon=True)
    t.start()
    argv = ["--port", str(sport), "--clients", "1", "--reliable", "--coord",
            f"localhost:{cport}", "--coord-rank", "9", *SMALL]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.serving.cli",
                             *argv], cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    client_t = None
    try:
        client_t = ReliableTransport(TCPTransport(rank=1, world_size=2, port=sport,
                                                  connect_timeout=60.0))
        prompt = np.arange(6)
        toks = ServingClient(client_t).generate(prompt, 10, timeout=60)
        model = tcli.build_model(tcli.parse_args(argv))
        assert toks == expected(model, prompt, 10)
        assert wait_for(lambda: 9 in coord.live_engine_ranks(), timeout=10)
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        if client_t is not None:
            client_t.close()
        coord.stop()
        t.join(timeout=10)
        hub.close()
    assert proc.returncode == 0, out[-2000:]
    assert "SLO summary" in out


def test_serve_cli_ckpt_dir_restores_train_lm_weights(tmp_path, capsys):
    """``--ckpt-dir`` serves the parameters ``train_lm --ckpt-dir`` saved
    (bit for bit), and refuses an empty directory with the JAX message."""
    from distributed_ml_pytorch_tpu_torch.serving import cli as tcli
    from distributed_ml_pytorch_tpu_torch.training import train_lm

    width = ["--vocab", "64", "--d-model", "32", "--n-heads", "4", "--n-layers", "1",
             "--d-ff", "64"]
    ck = str(tmp_path / "lm")
    assert train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", ck, "--ckpt-every", "1", *width]) == 0
    args = tcli.parse_args([*width, "--backend", "cpu", "--ckpt-dir", ck])
    restored = tcli.build_model(args)
    saved = torch.load(os.path.join(ck, "2", "state.pt"), weights_only=True)["params"]
    for k, v in restored.state_dict().items():
        assert torch.equal(v, saved[k]), k
    fresh = tcli.build_model(tcli.parse_args([*width, "--backend", "cpu"]))
    assert any(not torch.equal(v, fresh.state_dict()[k]) for k, v in saved.items())
    assert tcli.main([*width, "--backend", "cpu", "--ckpt-dir", ck, "--demo", "2",
                      "--slots", "2", "--cache-size", "64", "--decode-block", "4",
                      "--prefill-bucket", "8"]) == 0
    with pytest.raises(SystemExit, match="no checkpoint under"):
        tcli.build_model(tcli.parse_args(["--backend", "cpu", "--ckpt-dir",
                                          str(tmp_path / "empty")]))
