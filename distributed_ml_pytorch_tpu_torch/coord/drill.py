"""Disaster-recovery drills (counterpart of the JAX ``coord/drill.py``).

:func:`recovery_drill` stands up a fleet in one process (a coordinator, N
elastic shard servers with a WAL and checkpoints on disk, M DownPour
workers, each shard's star under ``FaultyTransport`` chaos and the
``ReliableTransport`` envelope) and runs the recovery script:

1. train; at a scripted step, drive a coordinator-aligned snapshot barrier
   (``SnapshotRequest`` / ``SnapshotDone`` → ``FleetManifest``);
2. train on past the snapshot, so acked updates exist that only the
   write-ahead logs hold;
3. kill a subset of the shards (all by default) silently: the serve loops
   die without a checkpoint, a leave or a WAL flush, and their endpoints
   raise like dead sockets;
4. restore from manifest and WAL: fresh server objects install their ranges
   from the manifest's map, replay their logs past the checkpoint and seed
   their transports' dedup; the workers' retries and pull probes reconnect;
5. run to the end and prove the recovery by sequence accounting: every
   acked push is in the restored server's applied counts (acked <= applied
   for every worker and shard).

:func:`sched_drill` runs the same fleet under the multi-tenant scheduler:
a training tenant owns every shard slot, a serving tenant of higher
priority wants one at the peak, and a node agent (a ``KIND_AGENT`` member)
actuates grants and resumes. The peak parks the last shard behind a
snapshot barrier (the workers hold their pushes to it), the off-peak
resumes it from the manifest and its WAL, and the drill proves the round
trip bit for bit.

:func:`coordfail_drill` kills the coordinator instead, right after it sent
a snapshot barrier (or, with ``kill_during="preempt"``, with a shard
parked by its scheduler): the data plane trains on under the last map, a
new life over the same ``durable_dir`` (epoch bumped, members, map, clocks
and the park table replayed) waits out its grace window while the members
re-attach, evicts no one, and drives a barrier of its own to a published
manifest (or resumes the parked shard).

Determinism: the injected faults sit on channels whose send sequences are
functions of the step script alone (worker 1's pull channel), and the kill
and restore are driven from worker 1's own step hook, so the
:class:`~..utils.chaos.ChaosLog` renders byte for byte the same on every
run and in either package. Pushes ride the envelope and are never faulted:
their loss-freedom must come from the WAL and the deferred acks.

The workers are the port's: a model of the fixture on its device (the card
by default), the synthetic CIFAR-10 set, ``loss_and_grads`` and the
optimizer's ``step``.

:func:`gray_drill` grays shard server 0 instead of killing it: a windowed
one-way partition on the workers' pull channels toward it, which its own
renewals never show. The gray-failure plane detects it from the workers'
link evidence, puts it on probation, checkpoint-parks it (quarantine) and
has the node agent resume it bit for bit, and the resumed life clears the
ladder back to OK: no eviction, no lease expiry, every acked push applied.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
from distributed_ml_pytorch_tpu_torch.coord.sched import FleetScheduler
from distributed_ml_pytorch_tpu_torch.coord.tenants import (
    TENANT_SERVING,
    TENANT_TRAINING,
    Tenant,
    TenantRegistry,
)
from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
from distributed_ml_pytorch_tpu_torch.coord.manifest import MANIFEST_NAME, FleetManifest
from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
from distributed_ml_pytorch_tpu_torch.utils.chaos import (
    ChaosLog,
    ChaosPlan,
    FaultRule,
    FaultyTransport,
    GrayRule,
)
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    InProcessTransport,
    MessageCode,
    ReliableTransport,
)

#: the codes a drill's world sends outside the envelope: pulls and their
#: replies are periodic, idempotent and driven by the cadence, so faulting
#: them is safe, and their channel indices follow the step script alone
DRILL_UNRELIABLE = (
    MessageCode.Heartbeat,
    MessageCode.LeaseRenew,
    MessageCode.ParameterRequest,
    MessageCode.ParameterUpdate,
)

#: the push codes a worker's acks are counted over
_PUSH_CODES = (MessageCode.ShardPush, MessageCode.GradientUpdate,
               MessageCode.CompressedUpdate)


def default_drill_plan(seed: int = 0) -> ChaosPlan:
    """Noise on worker 1's pull channel only (worker rank 1 to the server,
    rank 0, of every shard's star): worker 1 drives the kill and the
    restore from its own step hook, so its channel indices replay
    exactly."""
    return ChaosPlan([FaultRule(src=1, dst=0, code=int(MessageCode.ParameterRequest),
                                drop=0.2, dup=0.1)], seed=seed)


def wait_for(predicate, timeout: float, what: str, poll: float = 0.05):
    """Poll ``predicate`` until it is true; ``TimeoutError`` naming
    ``what`` after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(poll)
    raise TimeoutError(f"timed out after {timeout:.0f}s waiting for {what}")


class PsStars:
    """The parameter-server stars of an in-process drill: shard ``i`` is
    rank 0 of its own star, worker ``j`` rank ``j`` there. Every star is
    chaos-wrapped (one :class:`FaultyTransport` hub and its siblings, all
    on one ``log``; star ``i`` under ``plans[i]``), and each endpoint has a
    :class:`ReliableTransport` over it that sends ``unreliable`` codes
    plain. A hub's ``crash`` kills its shard's endpoint alone."""

    def __init__(self, n_shards: int, n_workers: int, plans: Sequence[ChaosPlan],
                 log: ChaosLog, unreliable: Sequence[MessageCode],
                 breaker_grace: Optional[float] = None):
        self.n_workers = n_workers
        self._unreliable = tuple(unreliable)
        self._breaker_grace = breaker_grace
        self.chaos: List[Dict[int, FaultyTransport]] = []
        for i in range(n_shards):
            world = InProcessTransport.create_world(1 + n_workers)
            hub = FaultyTransport(world[0], plans[i], log=log)
            star = {0: hub}
            for r in range(1, 1 + n_workers):
                star[r] = hub.sibling(world[r])
            self.chaos.append(star)
        self.workers: List[Dict[int, ReliableTransport]] = [
            {j: self._reliable(self.chaos[i][j], ack_on_delivery=True)
             for j in range(1, 1 + n_workers)} for i in range(n_shards)]

    def _reliable(self, inner, ack_on_delivery: bool) -> ReliableTransport:
        kw = {} if self._breaker_grace is None else {"breaker_grace": self._breaker_grace}
        return ReliableTransport(inner, ack_timeout=0.05, max_backoff=0.25, max_retries=120,
                                 unreliable_codes=self._unreliable,
                                 ack_on_delivery=ack_on_delivery, **kw)

    def server_transport(self, i: int) -> ReliableTransport:
        """A new server life's transport on star ``i`` (durable acks)."""
        return self._reliable(self.chaos[i][0], ack_on_delivery=False)

    def factory(self, j: int) -> Callable:
        """Worker ``j``'s transport factory: a map entry names its server's
        coordinator rank (shard ``i`` is rank ``1 + i``)."""
        return lambda entry: self.workers[entry.server_id - 1][j]

    def accounting(self, servers: Sequence[ElasticShardServer]):
        """``(acked, applied)``, shard index -> worker -> pushes."""
        acked, applied = {}, {}
        for i, srv in enumerate(servers):
            acked[i] = {j: sum(self.workers[i][j].acked_count(0, c) for c in _PUSH_CODES)
                        for j in range(1, 1 + self.n_workers)}
            applied[i] = {j: srv.ps.applied_by_sender.get(j, 0)
                          for j in range(1, 1 + self.n_workers)}
        return acked, applied

    def close(self, servers: Sequence[ElasticShardServer]) -> None:
        for star in self.workers:
            for t in star.values():
                t.close()
        for srv in servers:
            srv.transport.close()


def serve(srv: ElasticShardServer, threads: List[threading.Thread]) -> ElasticShardServer:
    """Start ``srv``'s serve loop on a thread of its own, kept in ``threads``
    for :func:`stop_servers`."""
    threads.append(threading.Thread(target=srv.run, kwargs={"timeout": 600}, daemon=True))
    threads[-1].start()
    return srv


def park_after_a_push(srv: ElasticShardServer, manifest_path: str,
                      timeout: float = 60.0) -> None:
    """Drill pacing: hand ``srv`` its ``PreemptRequest`` only once it has
    applied a push past its record in the barrier's manifest, so the park
    always leaves acked updates that only its WAL holds, which the resume
    must replay. The request reaches the server's mailbox late, never lost;
    if no such push comes within ``timeout`` it goes through as it is."""
    park = srv.coord.on_preempt

    def held(grant_id: int, snapshot_id: int) -> None:
        def release() -> None:
            try:
                base = FleetManifest.load(manifest_path).entry_for(srv.server_id).apply_seq
                wait_for(lambda: srv.ps._apply_seq > base, timeout,
                         "a push past the barrier before the park")
            except (ValueError, TimeoutError):
                pass  # the resume's own checks report what is missing
            park(grant_id, snapshot_id)

        threading.Thread(target=release, daemon=True).start()

    srv.coord.on_preempt = held


def stop_servers(servers: Sequence[ElasticShardServer],
                 threads: Sequence[threading.Thread]) -> None:
    """Stop the servers and wait for their serve loops, which checkpoint on
    the way out: nothing writes under the drill's directory afterwards."""
    for srv in servers:
        srv.stop()
    for t in threads:
        t.join(timeout=60)


def resolve_fixture(fixture, model: str, device, seed: int):
    """``(x, y, make_model, flat0)``: the given ``(x, y, make_model)``, or
    ``coord.demo.default_fixture`` of ``model`` on ``device``, and the
    model's flat initial vector."""
    from distributed_ml_pytorch_tpu_torch.coord.demo import default_fixture
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    x, y, make_model = fixture if fixture is not None else default_fixture(model, device, seed)
    flat0 = ravel_model_params(make_model()).cpu().numpy().astype(np.float32)
    return x, y, make_model, flat0


def run_worker_loop(j: int, client: CoordClient, stars: PsStars, x, y, make_model, *,
                    steps: int, lr: float, n_push: int, n_pull: int, batch: int,
                    losses: Dict[int, list], opts: Dict[int, object], step_hook=None,
                    loss_to_step: bool = False, compress: str = "",
                    more: Optional[Callable[[int], bool]] = None) -> None:
    """One drill worker: join, train ``steps`` steps of the elastic
    ``ShardedAsynchronous`` on the seeded batches of worker ``j``, calling
    ``step_hook(j, step)`` after each, then finish and leave. Past
    ``steps`` it goes on while ``more(step)`` holds (a flexible tail).
    ``loss_to_step`` hands the loss to ``step`` (it then skips the update
    of a nonfinite loss and the renewals carry the loss telemetry)."""
    import torch

    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads, to_device

    m = client.join(timeout=30)
    if m is None or not m.entries:
        raise RuntimeError("worker never got a shard map")
    factory = stars.factory(j)
    net = make_model()
    dev = next(net.parameters()).device
    opt = ShardedAsynchronous(net, lr=lr, n_push=n_push, n_pull=n_pull,
                              transports=[factory(e) for e in m.entries], coord=client,
                              transport_factory=factory, shard_map=m,
                              compress=compress or None)
    opts[j] = opt
    gen = torch.Generator(device=dev).manual_seed(100 + j)
    my_losses = losses.setdefault(j, [])
    step = 0
    while step < steps or (more is not None and more(step)):
        sel = np.random.default_rng(j * 1000 + step).integers(0, len(x), batch)
        loss = float(loss_and_grads(net, *to_device(x[sel], y[sel], dev), generator=gen))
        opt.step(loss if loss_to_step else None)
        my_losses.append(loss)
        if step_hook is not None:
            step_hook(j, step)
        step += 1
    opt.finish()


def recovery_drill(*, base_dir: str, seed: int = 0, steps: int = 18,
                   snapshot_at: Optional[int] = 6, kill_at: Optional[int] = 10,
                   outage_steps: int = 2, kill_shards: Optional[Sequence[int]] = None,
                   n_workers: int = 2, n_shards: int = 2, plan: Optional[ChaosPlan] = None,
                   lease: float = 5.0, lr: float = 0.05, n_push: int = 2, n_pull: int = 2,
                   batch: int = 16, wal_group_n: int = 4, fixture=None, compress: str = "",
                   server_opt: str = "", model: str = "lenet", device="cuda") -> Dict:
    """Run one kill-and-recover drill (the module docstring).

    ``snapshot_at``, ``kill_at`` and the restore (``kill_at +
    outage_steps``) are steps of worker 1's loop, driven from its step
    hook; ``kill_shards`` are the victims' shard indices (all by default);
    ``kill_at=None`` runs the fault-free baseline. Shard ``i``'s checkpoint
    and WAL live under ``base_dir/shard<i>``, the manifest under
    ``base_dir``. ``compress`` runs the pushes compressed; ``server_opt``
    gives every shard a server-side optimizer whose state must survive the
    kill. ``fixture`` is ``(x, y, make_model)`` (``coord.demo.
    default_fixture`` of ``model`` on ``device`` by default)."""
    x, y, make_model, flat0 = resolve_fixture(fixture, model, device, seed)
    n_params = int(flat0.shape[0])
    victims = (list(range(n_shards)) if kill_shards is None
               else sorted({int(i) for i in kill_shards}))

    log = ChaosLog()
    the_plan = plan if plan is not None else ChaosPlan(seed=seed)
    coord_world = InProcessTransport.create_world(1 + n_shards + n_workers)
    stars = PsStars(n_shards, n_workers, [the_plan] * n_shards, log, DRILL_UNRELIABLE)
    manifest_path = os.path.join(base_dir, MANIFEST_NAME)
    coord = Coordinator(coord_world[0], n_params, lease=lease, speculation=False,
                        manifest_dir=base_dir)
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": 600}, daemon=True)
    coord_thread.start()

    def make_optimizer():
        if not server_opt:
            return None
        from distributed_ml_pytorch_tpu_torch.parallel.optplane import ShardedOptimizer

        # momentum 0.5: lost or doubled state would show in the replayed
        # trajectory, and training still converges
        return ShardedOptimizer(server_opt, 0, 0, lr=1.0, momentum=0.5)

    def new_server(i: int) -> ElasticShardServer:
        client = CoordClient(coord_world[1 + i], "shard", renew_interval=lease / 4)
        return ElasticShardServer(
            server_id=1 + i, n_params=n_params, transport=stars.server_transport(i),
            coord=client, init_params=flat0, ckpt_dir=os.path.join(base_dir, f"shard{i}"),
            ckpt_every=0, wal=True, wal_group_n=wal_group_n, optimizer=make_optimizer())

    serve_threads: List[threading.Thread] = []
    servers: List[ElasticShardServer] = [serve(new_server(i), serve_threads)
                                         for i in range(n_shards)]
    wait_for(lambda: len(coord.shard_map.entries) == n_shards, 60,
              "all shard servers to join the map")

    timings: Dict[str, float] = {}
    losses: Dict[int, list] = {}
    opts: Dict[int, object] = {}
    errors: list = []
    restored = {"replayed": 0, "manifest": None, "replayed_codecs": [], "apply_seqs": {}}
    restored_evt = threading.Event()
    if kill_at is None:
        restored_evt.set()

    def kill_fleet() -> None:
        timings["killed"] = time.monotonic()
        for i in victims:
            servers[i].crash()
            stars.chaos[i][0].crash()

    def restore_fleet() -> None:
        t0 = time.monotonic()
        manifest = FleetManifest.load(manifest_path)  # refuses a bad manifest
        restored["manifest"] = manifest.to_dict()
        for i in victims:
            stars.chaos[i][0].restart()
            # the dead life's wrapper goes; its endpoint lives on
            servers[i].transport.detach()
            srv = new_server(i)
            srv.restore_from_manifest(manifest)
            restored["replayed"] += srv.ps.replayed_updates
            restored["apply_seqs"][i] = srv.ps._apply_seq
            # the codecs of the surviving log, read before a checkpoint
            # truncates it: a compressed run's replayed records say so
            recs, _stats = srv.ps.wal.replay()
            restored["replayed_codecs"].extend(r.codec for r in recs)
            servers[i] = serve(srv, serve_threads)
        timings["restored"] = time.monotonic()
        timings["restore_s"] = timings["restored"] - t0

    def step_hook(j: int, step: int) -> None:
        if j != 1:
            # the other workers wait at the kill step until the fleet is
            # restored: they cross the outage too, on unfaulted channels
            if kill_at is not None and step == kill_at:
                restored_evt.wait(300)
            return
        if snapshot_at is not None and step == snapshot_at:
            coord.trigger_snapshot()
            wait_for(lambda: os.path.exists(manifest_path) and coord.manifests_written > 0,
                      60, "the snapshot barrier to publish a manifest")
        if kill_at is not None:
            if step == kill_at:
                kill_fleet()
            elif step == kill_at + outage_steps:
                try:
                    restore_fleet()
                finally:
                    restored_evt.set()  # the waiting workers go on either way

    def run_worker(j: int) -> None:
        client = CoordClient(coord_world[n_shards + j], "worker", renew_interval=lease / 4)
        try:
            run_worker_loop(j, client, stars, x, y, make_model, steps=steps, lr=lr,
                            n_push=n_push, n_pull=n_pull, batch=batch, losses=losses,
                            opts=opts, step_hook=step_hook, compress=compress)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append((j, repr(e)))
            restored_evt.set()
        finally:
            client.close()

    # recovered = every restored shard has answered a pull again (a fresh
    # server's message counts start at 0)
    watch_stop = threading.Event()

    def watch_recovery() -> None:
        while "killed" not in timings:
            if watch_stop.wait(0.02):
                return
        while not watch_stop.is_set():
            if "restored" in timings and all(
                    servers[i].ps.message_counts.get(MessageCode.ParameterRequest, 0) > 0
                    for i in victims):
                timings["recovered"] = time.monotonic()
                return
            watch_stop.wait(0.02)

    watcher = None
    if kill_at is not None:
        watcher = threading.Thread(target=watch_recovery, daemon=True)
        watcher.start()
    worker_threads = [threading.Thread(target=run_worker, args=(j,), daemon=True)
                      for j in range(1, n_workers + 1)]
    for t in worker_threads:
        t.start()
    for t in worker_threads:
        t.join(timeout=600)
    stuck = [t for t in worker_threads if t.is_alive()]
    watch_stop.set()
    if watcher is not None:
        watcher.join(timeout=10)
    stop_servers(servers, serve_threads)
    coord.stop()
    coord_thread.join(timeout=30)

    acked, applied = stars.accounting(servers)
    accounting_ok = all(acked[i][j] <= applied[i][j]
                        for i in range(n_shards) for j in range(1, 1 + n_workers))
    served_again = all(servers[i].ps.message_counts.get(MessageCode.ParameterRequest, 0) > 0
                       for i in victims) if kill_at is not None else True
    stars.close(servers)
    for t in coord_world.values():
        t.close()
    mttr = (timings["recovered"] - timings["killed"]
            if "recovered" in timings and "killed" in timings else None)
    return {
        "ok": not stuck and not errors and accounting_ok,
        "errors": errors,
        "stuck_workers": len(stuck),
        "losses": losses,
        "acked": acked,
        "applied": applied,
        "accounting_ok": accounting_ok,
        "served_again": served_again,
        "replayed_updates": restored["replayed"],
        "replayed_codecs": restored["replayed_codecs"],
        "restored_apply_seqs": restored["apply_seqs"],
        "manifest": restored["manifest"],
        "chaos_lines": log.lines(),
        "chaos_counts": log.counts(),
        "events": list(coord.events),
        "stats": {srv.server_id: dict(srv.stats) for srv in servers},
        "mttr_s": mttr,
        "restore_s": timings.get("restore_s"),
        "servers": servers,
    }


#: the scheduler drills' tenant ids
TRAIN_ID, SERVE_ID = 1, 2


def drill_tenants(n_shards: int) -> TenantRegistry:
    """The drills' tenants: training owns every shard slot (its floor one
    below that), serving has a higher priority and no demand yet."""
    registry = TenantRegistry()
    registry.register(Tenant(TRAIN_ID, "train", kind=TENANT_TRAINING, priority=1,
                             demand=n_shards, min_slots=n_shards - 1))
    registry.register(Tenant(SERVE_ID, "serve", kind=TENANT_SERVING, priority=5, demand=0))
    return registry


class NodeAgent:
    """A drill's node agent: a ``KIND_AGENT`` member that records every
    ``SlotGrant`` in ``grants`` and runs ``resume(grant_id, rank,
    snapshot_id)`` for each ``ResumeRequest`` on a thread of its own, never
    on the client's listener."""

    def __init__(self, transport, lease: float, resume: Callable[[int, int, int], None]):
        self.grants: List[tuple] = []
        self._resume = resume
        self._jobs: List[tuple] = []
        self._ready = threading.Event()
        self._stop = threading.Event()
        self.client = CoordClient(transport, "agent", renew_interval=lease / 4)
        self.client.on_slot_grant = lambda *grant: self.grants.append(grant)
        self.client.on_resume = self._note_resume
        self.client.join(timeout=30)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _note_resume(self, grant_id: int, rank: int, snapshot_id: int) -> None:
        self._jobs.append((grant_id, rank, snapshot_id))
        self._ready.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._ready.wait(0.05):
                continue
            self._ready.clear()
            while self._jobs:
                self._resume(*self._jobs.pop(0))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.client.close()


def resume_parked_shard(old: ElasticShardServer, new_server: Callable[[], ElasticShardServer],
                        manifest_path: str, snapshot_id: int):
    """The agent's resume of a parked shard server: its successor on the
    same endpoint restores the manifest's checkpoint and replays the WAL.
    ``(server, identical)``: ``identical`` when its whole range, apply seq
    and per-sender applied counts equal the parked life's bit for bit, taken
    before any new traffic. ``FileNotFoundError`` when there is no manifest
    to restore (a park without the barrier)."""
    if snapshot_id <= 0 or not os.path.exists(manifest_path):
        raise FileNotFoundError(f"no manifest for snapshot {snapshot_id}")
    manifest = FleetManifest.load(manifest_path)
    detach = getattr(old.transport, "detach", None)
    if detach is not None:
        detach()  # the endpoint passes to the new life's wrapper
    srv = new_server()
    srv.restore_from_manifest(manifest)
    identical = (old.ps.central.tobytes() == srv.ps.central.tobytes()
                 and srv.ps._apply_seq == old.ps._apply_seq
                 and dict(srv.ps.applied_by_sender) == dict(old.ps.applied_by_sender))
    return srv, identical


class ShardResumer:
    """A drill agent's resume of parked shard servers, the ``resume``
    callback of :class:`NodeAgent`: :func:`resume_parked_shard` for the
    rank's server in ``servers``, then serves the new life in its place.
    A resume that finds no manifest appends ``lost`` to ``violations`` and
    sets ``failed``; one that differs from the parked life appends
    ``differs``. Both are formats over ``rank``, ``e`` (the error),
    ``parked`` and ``restored`` (the two lives' apply seqs)."""

    def __init__(self, servers: List[ElasticShardServer],
                 new_server: Callable[[int], ElasticShardServer], manifest_path: str,
                 serve_threads: List[threading.Thread], violations: List[str],
                 failed: threading.Event, *, lost: str, differs: str):
        self.servers, self.new_server, self.manifest_path = servers, new_server, manifest_path
        self.serve_threads, self.violations, self.failed = serve_threads, violations, failed
        self.lost, self.differs = lost, differs
        self.replayed = 0
        self.bit_identical: Optional[bool] = None
        self.apply_seq_parked: Optional[int] = None
        self.apply_seq_restored: Optional[int] = None

    def __call__(self, grant_id: int, rank: int, snapshot_id: int) -> None:
        i = rank - 1
        old = self.servers[i]
        try:
            srv, identical = resume_parked_shard(old, lambda: self.new_server(i),
                                                 self.manifest_path, snapshot_id)
        except Exception as e:  # noqa: BLE001 — the violation is the result
            self.violations.append(self.lost.format(rank=rank, e=e))
            self.failed.set()
            return
        self.replayed += srv.ps.replayed_updates
        self.apply_seq_parked, self.apply_seq_restored = old.ps._apply_seq, srv.ps._apply_seq
        self.bit_identical = identical
        if not identical:
            self.violations.append(self.differs.format(
                rank=rank, parked=old.ps._apply_seq, restored=srv.ps._apply_seq))
        self.servers[i] = serve(srv, self.serve_threads)


class ParkHold:
    """The workers' side of a park in a drill: once ``hold`` is set, each
    worker holds the victim's range at its next step boundary; once
    ``release`` is set (and ``failed`` is not), it releases it."""

    def __init__(self, opts: Dict[int, object], victim_sid: int, n_workers: int,
                 failed: threading.Event):
        self.opts, self.victim_sid, self.failed = opts, victim_sid, failed
        self.hold = threading.Event()
        self.release = threading.Event()
        self._held = {j: False for j in range(1, 1 + n_workers)}

    def follow(self, j: int) -> None:
        if self.hold.is_set() and not self.release.is_set() and not self._held[j]:
            self.opts[j].hold_shard(self.victim_sid)
            self._held[j] = True
        if self.release.is_set() and self._held[j] and not self.failed.is_set():
            self.opts[j].release_shard(self.victim_sid)
            self._held[j] = False


def _lost_pushes(acked, applied) -> List[str]:
    return [f"acked delta lost: shard {i} worker {j}: acked {acked[i][j]} > applied "
            f"{applied[i][j]}"
            for i in sorted(acked) for j in sorted(acked[i]) if acked[i][j] > applied[i][j]]


def sched_drill(*, base_dir: str, seed: int = 0, steps: int = 56, peak_at: int = 6,
                offpeak_at: int = 46, require_manifest: bool = True, n_workers: int = 2,
                n_shards: int = 2, plan: Optional[ChaosPlan] = None, lease: float = 2.0,
                lr: float = 0.05, n_push: int = 2, n_pull: int = 2, batch: int = 16,
                wal_group_n: int = 4, fixture=None, step_sleep: float = 0.05,
                model: str = "lenet", device="cuda") -> Dict:
    """One preempt, park and resume under the multi-tenant scheduler (the
    module docstring), driven from worker 1's step hook:

    1. at ``peak_at`` the serving tenant wants a slot; the scheduler drives
       a snapshot barrier, then parks the training tenant's last shard (the
       workers push through the barrier-to-park window, so acked updates
       exist that only the WAL holds);
    2. the workers see the park and hold the victim's range: that slice
       goes on with local SGD, its pushes held, not lost;
    3. at ``offpeak_at`` the demand drops; the grant is revoked and the
       agent restores the parked shard from the manifest and its WAL, a
       newer life of the same rank;
    4. the workers release the hold, and the drill proves the round trip:
       the restored server bit-identical to the parked one, acked <=
       applied for every worker and shard, a clean ledger, and a chaos log
       that is a function of the step script.

    ``require_manifest=False`` parks without the barrier, and the resume
    then finds no manifest: the violation in ``out["violations"]`` (empty
    when the protocol held). Chaos rides star 0 only, whose shard is never
    parked: the victim star's pull channel ends when the workers see the
    park, which is the coordinator's timing, not the script's."""
    if n_shards < 2:
        raise ValueError("sched_drill needs a survivor shard (n_shards >= 2)")
    x, y, make_model, flat0 = resolve_fixture(fixture, model, device, seed)
    n_params = int(flat0.shape[0])
    # the scheduler parks the training tenant's last slot
    victim = n_shards - 1
    victim_sid = 1 + victim

    log = ChaosLog()
    the_plan = plan if plan is not None else ChaosPlan(seed=seed)
    agent_rank = 1 + n_shards + n_workers
    coord_world = InProcessTransport.create_world(2 + n_shards + n_workers)
    stars = PsStars(n_shards, n_workers,
                    [the_plan if i == 0 else ChaosPlan(seed=seed) for i in range(n_shards)],
                    log, DRILL_UNRELIABLE)
    manifest_path = os.path.join(base_dir, MANIFEST_NAME)
    coord = Coordinator(coord_world[0], n_params, lease=lease, speculation=False,
                        manifest_dir=base_dir)
    registry = drill_tenants(n_shards)
    sched = FleetScheduler(coord, registry=registry, require_manifest=require_manifest,
                           actuator_rank=agent_rank, preempt_timeout=60.0, resume_timeout=60.0)
    for i in range(n_shards):
        sched.register_member_slot(1 + i, TRAIN_ID)
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": 600}, daemon=True)
    coord_thread.start()

    def new_server(i: int) -> ElasticShardServer:
        client = CoordClient(coord_world[1 + i], "shard", renew_interval=lease / 4)
        return ElasticShardServer(
            server_id=1 + i, n_params=n_params, transport=stars.server_transport(i),
            coord=client, init_params=flat0, ckpt_dir=os.path.join(base_dir, f"shard{i}"),
            ckpt_every=0, wal=True, wal_group_n=wal_group_n)

    serve_threads: List[threading.Thread] = []
    servers: List[ElasticShardServer] = [serve(new_server(i), serve_threads)
                                         for i in range(n_shards)]
    wait_for(lambda: len(coord.shard_map.entries) == n_shards, 60,
             "all shard servers to join the map")

    violations: List[str] = []
    resume_failed = threading.Event()
    resumed = ShardResumer(
        servers, new_server, manifest_path, serve_threads, violations, resume_failed,
        lost="resume lost acked state: rank {rank} parked without a usable manifest ({e!r})",
        differs="resume of rank {rank} not bit-identical: parked apply_seq {parked} vs "
                "restored {restored}")
    agent = NodeAgent(coord_world[agent_rank], lease, resumed)

    timings: Dict[str, float] = {}
    losses: Dict[int, list] = {}
    opts: Dict[int, object] = {}
    errors: list = []
    park = ParkHold(opts, victim_sid, n_workers, resume_failed)

    def step_hook(j: int, step: int) -> None:
        # every worker is paced, so the scheduler's wall-clock decisions
        # land inside the step script
        time.sleep(step_sleep)
        if j != 1:
            if step == offpeak_at:
                park.release.wait(300)
            park.follow(j)
            return
        if step == peak_at:
            timings["peak"] = time.monotonic()
            registry.set_demand(SERVE_ID, 1)
        if peak_at < step < offpeak_at and not park.hold.is_set() and sched.preempts_done > 0:
            park.hold.set()
        if step == offpeak_at:
            wait_for(lambda: sched.preempts_done > 0 or sched.preempts_aborted > 0, 120,
                     "the preempt to park the victim")
            park.hold.set()
            park.follow(1)
            timings["offpeak"] = time.monotonic()
            registry.set_demand(SERVE_ID, 0)
            wait_for(lambda: sched.resumes_done > 0 or resume_failed.is_set(), 120,
                     "the resume to settle")
            park.release.set()
        park.follow(1)

    def run_worker(j: int) -> None:
        client = CoordClient(coord_world[n_shards + j], "worker", renew_interval=lease / 4)
        try:
            run_worker_loop(j, client, stars, x, y, make_model, steps=steps, lr=lr,
                            n_push=n_push, n_pull=n_pull, batch=batch, losses=losses,
                            opts=opts, step_hook=step_hook)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append((j, repr(e)))
            park.release.set()  # never strand the other workers
        finally:
            client.close()

    worker_threads = [threading.Thread(target=run_worker, args=(j,), daemon=True)
                      for j in range(1, n_workers + 1)]
    timings["day_start"] = time.monotonic()
    for t in worker_threads:
        t.start()
    for t in worker_threads:
        t.join(timeout=600)
    timings["day_end"] = time.monotonic()
    stuck = [t for t in worker_threads if t.is_alive()]
    agent.close()
    stop_servers(servers, serve_threads)
    coord.stop()
    coord_thread.join(timeout=30)

    acked, applied = stars.accounting(servers)
    violations.extend(_lost_pushes(acked, applied))
    violations.extend(sched.ledger.audit())
    stars.close(servers)
    for t in coord_world.values():
        t.close()
    return {
        "ok": not stuck and not errors and not violations and sched.preempts_done > 0,
        "violations": violations,
        "errors": errors,
        "stuck_workers": len(stuck),
        "losses": losses,
        "acked": acked,
        "applied": applied,
        "replayed_updates": resumed.replayed,
        "bit_identical": resumed.bit_identical,
        "apply_seq_parked": resumed.apply_seq_parked,
        "apply_seq_restored": resumed.apply_seq_restored,
        "grants": agent.grants,
        "sched": sched.summary(),
        "events": list(coord.events),
        "chaos_lines": log.lines(),
        "chaos_counts": log.counts(),
        "held_pushes": {j: getattr(opts.get(j), "held_pushes", 0) for j in sorted(opts)},
        # the day's wall clock, and the seconds the borrowed slot served
        # (demand spike to demand drop): the sched leg's goodput accounting
        "wall_s": timings["day_end"] - timings["day_start"],
        "peak_window_s": (timings["offpeak"] - timings["peak"]
                          if "peak" in timings and "offpeak" in timings else None),
        "servers": servers,
    }


def default_gray_plan(seed: int = 0, n_workers: int = 2, gray_from: int = 30,
                      gray_until: int = 58) -> ChaosPlan:
    """A windowed one-way partition on every worker's pull channel toward
    shard server 0 (the gray victim): requests with channel send indices
    in ``[gray_from, gray_until)`` vanish; replies and renewals are never
    touched. The rules are index-windowed, so the chaos log is a function
    of the window whatever the detection and containment timing."""
    rules = [GrayRule(kind="partition", src=j, dst=0, code=int(MessageCode.ParameterRequest),
                      after=gray_from, until=gray_until)
             for j in range(1, 1 + n_workers)]
    return ChaosPlan(seed=seed, gray=tuple(rules))


def gray_drill(*, base_dir: str, seed: int = 0, steps: int = 170, gray_from: int = 30,
               gray_until: int = 58, n_workers: int = 2, n_shards: int = 2,
               plan: Optional[ChaosPlan] = None, lease: float = 1.0, lr: float = 0.05,
               n_push: int = 2, n_pull: int = 2, batch: int = 16, wal_group_n: int = 4,
               fixture=None, step_sleep: float = 0.05, extra_steps: int = 400,
               gray_knobs: Optional[dict] = None, contain: bool = True,
               model: str = "lenet", device="cuda") -> Dict:
    """One gray-failure containment drill.

    Mid-training, shard server 0 goes gray, not dead: a scheduled one-way
    partition eats the workers' pull requests toward it while its own
    lease renewals (another star) keep flowing. The coordinator must tell
    cut-off from dead and contain without killing:

    1. both workers' renewals carry per-link evidence (windowed pull
       requests against replies) naming the victim, the witness its own
       clean tail can never be;
    2. :class:`~.grayhealth.GrayHealth` confirms the suspicion over
       ``confirm_ticks`` and puts the victim on probation (detection
       latency measured);
    3. still suspect after ``quarantine_after`` ticks, it checkpoint-parks
       the victim through the park machinery: a snapshot barrier, a
       gray-granted ``PreemptRequest``, a logged park ticket, the lease
       exempt (containment MTTR measured). The victim never lease-expires
       and is never revoked;
    4. the partition heals, the cooldown ends, the node agent restores the
       parked shard from the manifest and its WAL (:func:`resume_parked_shard`:
       the whole range, apply seq and per-sender counts bit for bit), and
       the resumed life re-enters the ladder at probation, clearing to OK
       as clean windows accumulate.

    The workers do not hold the parked shard's range: their pushes to it
    ride the reliable layer's retransmissions into the resumed life.
    Workers run ``steps`` steps, then keep stepping (at most
    ``extra_steps`` more) until the ladder clears; the chaos rules are
    index-windowed, so the flexible tail cannot change the log.
    ``gray_knobs`` are more :class:`~.grayhealth.GrayHealth` options
    (``hysteresis=False``, ``asymmetric=False``,
    ``evict_on_first_suspicion=True``).

    ``contain=False`` is the comparison leg: the detector cannot fire
    (``raise_threshold`` 1e9), the workers run the fixed script only, and
    the ladder's contract is not asserted: the run measures what the same
    episode costs when nobody contains it. ``fixture`` is ``(x, y,
    make_model)`` (``coord.demo.default_fixture`` of ``model`` on
    ``device`` by default)."""
    from distributed_ml_pytorch_tpu_torch.coord.grayhealth import OK, GrayHealth

    if n_shards < 2:
        raise ValueError("gray_drill needs a healthy shard (n_shards >= 2)")
    x, y, make_model, flat0 = resolve_fixture(fixture, model, device, seed)
    n_params = int(flat0.shape[0])
    # the victim is shard server 0, the one star under the gray plan
    victim_rank = 1

    log = ChaosLog()
    the_plan = plan if plan is not None else default_gray_plan(
        seed, n_workers=n_workers, gray_from=gray_from, gray_until=gray_until)
    agent_rank = 1 + n_shards + n_workers
    coord_world = InProcessTransport.create_world(2 + n_shards + n_workers)
    stars = PsStars(n_shards, n_workers,
                    [the_plan if i == 0 else ChaosPlan(seed=seed) for i in range(n_shards)],
                    log, DRILL_UNRELIABLE)
    manifest_path = os.path.join(base_dir, MANIFEST_NAME)
    coord = Coordinator(coord_world[0], n_params, lease=lease, speculation=False,
                        manifest_dir=base_dir)
    knobs = dict(gray_knobs or {})
    if not contain:
        # evidence still flows on the renewals, but the detector never fires
        knobs["raise_threshold"] = 1e9
    gray = GrayHealth(coord, actuator_rank=agent_rank, confirm_ticks=2, clear_ticks=2,
                      quarantine_after=8, quarantine_cooldown=3.0, evict_after_quarantines=2,
                      **knobs)
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": 600}, daemon=True)
    coord_thread.start()

    def new_server(i: int) -> ElasticShardServer:
        client = CoordClient(coord_world[1 + i], "shard", renew_interval=lease / 4)
        return ElasticShardServer(
            server_id=1 + i, n_params=n_params, transport=stars.server_transport(i),
            coord=client, init_params=flat0, ckpt_dir=os.path.join(base_dir, f"shard{i}"),
            ckpt_every=0, wal=True, wal_group_n=wal_group_n)

    serve_threads: List[threading.Thread] = []
    servers: List[ElasticShardServer] = [serve(new_server(i), serve_threads)
                                         for i in range(n_shards)]
    wait_for(lambda: len(coord.shard_map.entries) == n_shards, 60,
             "all shard servers to join the map")

    violations: List[str] = []
    resume_failed = threading.Event()
    resumed = ShardResumer(
        servers, new_server, manifest_path, serve_threads, violations, resume_failed,
        lost="gray resume lost acked state: rank {rank} parked without a usable manifest "
             "({e!r})",
        differs="gray resume of rank {rank} not bit-identical: parked apply_seq {parked} vs "
                "restored {restored}")
    agent = NodeAgent(coord_world[agent_rank], lease, resumed)

    timings: Dict[str, float] = {}
    losses: Dict[int, list] = {}
    opts: Dict[int, object] = {}
    errors: list = []

    def recovered() -> bool:
        return ((gray.recoveries >= 1 and gray.state_of(victim_rank) == OK)
                or gray.evictions >= 1 or resume_failed.is_set())

    def step_hook(j: int, step: int) -> None:
        time.sleep(step_sleep)
        if step + 1 == steps:
            # the fixed script is the same work on both legs: its end is
            # the goodput denominator (the recovery tail would pad it)
            timings[f"fixed_done_w{j}"] = time.monotonic()

    def more(step: int) -> bool:
        # the flexible tail: keep the renew, pull and evidence cadence alive
        # until the ladder clears
        return contain and step < steps + extra_steps and not recovered()

    def run_worker(j: int) -> None:
        client = CoordClient(coord_world[n_shards + j], "worker", renew_interval=lease / 4)
        try:
            run_worker_loop(j, client, stars, x, y, make_model, steps=steps, lr=lr,
                            n_push=n_push, n_pull=n_pull, batch=batch, losses=losses,
                            opts=opts, step_hook=step_hook, more=more)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append((j, repr(e)))
        finally:
            client.close()

    worker_threads = [threading.Thread(target=run_worker, args=(j,), daemon=True)
                      for j in range(1, n_workers + 1)]
    timings["day_start"] = time.monotonic()
    for t in worker_threads:
        t.start()
    for t in worker_threads:
        t.join(timeout=600)
    timings["day_end"] = time.monotonic()
    stuck = [t for t in worker_threads if t.is_alive()]
    agent.close()
    stop_servers(servers, serve_threads)
    coord.stop()
    coord_thread.join(timeout=30)

    # the gray contract: contained, never killed
    if contain:
        if gray.probations < 1:
            violations.append("gray victim was never detected (no probation)")
        if gray.quarantines < 1:
            violations.append("gray victim was never contained (no quarantine)")
        if gray.evictions > 0:
            violations.append(f"gray plane EVICTED {gray.evictions} member(s) — containment "
                              "must degrade, not kill")
        if gray.recoveries < 1 and not resume_failed.is_set():
            violations.append("quarantined victim never earned its way back")
    expiry = [e for e in coord.events if "lease expired" in e and f" {victim_rank} " in e]
    if expiry:
        violations.append(f"renewing-but-gray victim lease-expired: {expiry[0]!r}")
    acked, applied = stars.accounting(servers)
    violations.extend(_lost_pushes(acked, applied))
    stars.close(servers)
    for t in coord_world.values():
        t.close()

    gstats = gray.stats()
    fixed = [timings[k] for k in timings if k.startswith("fixed_done_w")]
    return {
        "ok": not stuck and not errors and not violations,
        "violations": violations,
        "errors": errors,
        "stuck_workers": len(stuck),
        "losses": losses,
        "acked": acked,
        "applied": applied,
        "replayed_updates": resumed.replayed,
        "bit_identical": resumed.bit_identical,
        "gray": gstats,
        "detect_latency_s": (gstats["detection_latencies"][0]
                             if gstats["detection_latencies"] else None),
        "containment_mttr_s": (gstats["containment_mttrs"][0]
                               if gstats["containment_mttrs"] else None),
        "events": list(coord.events),
        "chaos_lines": log.lines(),
        "chaos_counts": log.counts(),
        "wall_s": timings["day_end"] - timings["day_start"],
        "fixed_wall_s": max(fixed) - timings["day_start"] if fixed else None,
        "servers": servers,
    }


def coordfail_drill(*, base_dir: str, seed: int = 0, steps: int = 20,
                    snapshot_at: Optional[int] = 4, kill_at: Optional[int] = 8,
                    outage_steps: int = 3, verify_at: Optional[int] = None,
                    kill_during: str = "snapshot", n_workers: int = 2, n_shards: int = 2,
                    plan: Optional[ChaosPlan] = None, lease: float = 2.0,
                    grace: Optional[float] = None, lr: float = 0.05, n_push: int = 2,
                    n_pull: int = 2, batch: int = 16, wal_group_n: int = 4, fixture=None,
                    step_sleep: float = 0.05, model: str = "lenet", device="cuda") -> Dict:
    """Kill the coordinator mid-flight and prove the fleet survives it.

    The coordinator's endpoint is a chaos rank (a ``FaultyTransport`` hub
    on the drill's log, the members reaching it through siblings), and
    worker 1's step script crashes it silently while the data plane trains
    on under the last map. ``kill_during="snapshot"`` crashes it right after
    it sent a snapshot barrier (the ``SnapshotDone`` frames land on a dead
    socket); at ``verify_at`` (default three steps after the restart)
    worker 1 waits for every member to re-attach and has the new life
    publish a manifest of its own. ``kill_during="preempt"`` runs a
    scheduler (the tenants and the node agent of :func:`sched_drill`): the
    serving tenant's demand spikes at ``snapshot_at``, and the coordinator
    dies with the last shard parked (the park logged) and its slot granted
    away; the new life must neither strand the parked rank nor grant its
    slot twice, and at ``verify_at`` the demand drops and it resumes the
    shard bit for bit. The workers wait out the preempt's barrier at
    ``snapshot_at + 1`` and the victim parks only after a push past the
    barrier (:func:`park_after_a_push`), so the resume always has WAL
    records to replay, however the host schedules the threads. In both
    variants the verify step also waits until every live member has heard
    from the new life (its epoch fence moved), which a member that only
    renewed learns from its next join retry's reply.

    The restart is a new :class:`Coordinator` over the same ``durable_dir``
    (``base_dir/coord``): its epoch is one higher, its members, map, clocks
    and park table are replayed, and its grace window holds lease expiry
    while the members' join retries re-attach them (a parked rank is
    exempt, not awaited). MTTR is the crash to the last re-attachment."""
    if kill_during not in ("snapshot", "preempt"):
        raise ValueError(f"kill_during must be 'snapshot' or 'preempt', got {kill_during!r}")
    with_sched = kill_during == "preempt"
    if with_sched and n_shards < 2:
        raise ValueError("the preempt variant needs a survivor shard (n_shards >= 2)")
    if verify_at is None and kill_at is not None:
        verify_at = kill_at + outage_steps + 3
    x, y, make_model, flat0 = resolve_fixture(fixture, model, device, seed)
    n_params = int(flat0.shape[0])
    victim_rank = n_shards  # the scheduler's pick: the last shard

    log = ChaosLog()
    the_plan = plan if plan is not None else default_drill_plan(seed)
    agent_rank = 1 + n_shards + n_workers
    coord_world = InProcessTransport.create_world((2 if with_sched else 1)
                                                  + n_shards + n_workers)
    # the coordinator is a crashable chaos rank on the drill's log; its
    # death is the scripted crash, never a fault rule
    coord_hub = FaultyTransport(coord_world[0], ChaosPlan(seed=seed), log=log)
    coord_star: Dict[int, FaultyTransport] = {0: coord_hub}
    for r in coord_world:
        if r != 0:
            coord_star[r] = coord_hub.sibling(coord_world[r])
    # the data-plane noise on star 0 only, as the JAX drill scopes it
    stars = PsStars(n_shards, n_workers,
                    [the_plan if i == 0 else ChaosPlan(seed=seed) for i in range(n_shards)],
                    log, DRILL_UNRELIABLE)
    manifest_path = os.path.join(base_dir, MANIFEST_NAME)
    coord_dir = os.path.join(base_dir, "coord")
    registry = drill_tenants(n_shards) if with_sched else None

    def make_coordinator() -> Coordinator:
        return Coordinator(coord_hub, n_params, lease=lease, speculation=False,
                           manifest_dir=base_dir, durable_dir=coord_dir, grace=grace)

    def make_scheduler(c: Coordinator) -> FleetScheduler:
        return FleetScheduler(c, registry=registry, require_manifest=True,
                              actuator_rank=agent_rank, preempt_timeout=60.0,
                              resume_timeout=60.0)

    life: Dict[str, object] = {"coord": make_coordinator()}
    if with_sched:
        life["sched"] = make_scheduler(life["coord"])
        for i in range(n_shards):
            life["sched"].register_member_slot(1 + i, TRAIN_ID)
    life["thread"] = threading.Thread(target=life["coord"].run, kwargs={"timeout": 600},
                                      daemon=True)
    life["thread"].start()

    def new_server(i: int) -> ElasticShardServer:
        client = CoordClient(coord_star[1 + i], "shard", renew_interval=lease / 4)
        return ElasticShardServer(
            server_id=1 + i, n_params=n_params, transport=stars.server_transport(i),
            coord=client, init_params=flat0, ckpt_dir=os.path.join(base_dir, f"shard{i}"),
            ckpt_every=0, wal=True, wal_group_n=wal_group_n)

    serve_threads: List[threading.Thread] = []
    servers: List[ElasticShardServer] = [serve(new_server(i), serve_threads)
                                         for i in range(n_shards)]
    wait_for(lambda: len(life["coord"].shard_map.entries) == n_shards, 60,
             "all shard servers to join the map")
    if with_sched:
        park_after_a_push(servers[victim_rank - 1], manifest_path)

    # the live ranks that must re-attach to the new life: a parked victim is
    # exempt by the durable park table, not re-attaching
    expected_live = set(range(1, 1 + n_shards + n_workers))
    if with_sched:
        expected_live.add(agent_rank)
        expected_live.discard(victim_rank)
    timings: Dict[str, float] = {}
    losses: Dict[int, list] = {}
    opts: Dict[int, object] = {}
    errors: list = []
    violations: List[str] = []
    member_epochs: Dict[int, int] = {}
    stale_drops: Dict[int, int] = {}
    resume_failed = threading.Event()
    verify_done = threading.Event()
    park = ParkHold(opts, victim_rank, n_workers, resume_failed)
    if kill_at is None:
        verify_done.set()

    agent = None
    resumed = ShardResumer(
        servers, new_server, manifest_path, serve_threads, violations, resume_failed,
        lost="resume lost the parked member: rank {rank} ({e!r})",
        differs="resume of rank {rank} not bit-identical across the coordinator restart")
    if with_sched:
        agent = NodeAgent(coord_star[agent_rank], lease, resumed)

    def kill_coordinator() -> None:
        # reap the serve loop first (stop sends nothing: a silent death),
        # then crash the endpoint so every member's control frames raise
        life["coord"].stop()
        life["thread"].join(timeout=30)
        coord_hub.crash()
        timings["killed"] = time.monotonic()
        timings["map_version_at_kill"] = life["coord"].shard_map.version

    def restore_coordinator() -> None:
        t0 = time.monotonic()
        coord_hub.restart()
        c2 = make_coordinator()
        if with_sched:
            life["sched2"] = make_scheduler(c2)
        t = threading.Thread(target=c2.run, kwargs={"timeout": 600}, daemon=True)
        life["coord2"], life["thread2"] = c2, t
        t.start()
        timings["restored"] = time.monotonic()
        timings["restore_s"] = timings["restored"] - t0

    # re-attached = the new life's grace window drained by traffic and every
    # expected live rank in its member table
    watch_stop = threading.Event()

    def watch_reattach() -> None:
        while "killed" not in timings:
            if watch_stop.wait(0.02):
                return
        while not watch_stop.is_set():
            c2 = life.get("coord2")
            if c2 is not None and not c2._grace_pending and expected_live <= set(c2.members):
                timings["reattached"] = time.monotonic()
                return
            watch_stop.wait(0.02)

    def step_hook(j: int, step: int) -> None:
        time.sleep(step_sleep)
        sched = life.get("sched")
        if with_sched and kill_at is not None and step == snapshot_at + 1:
            # every worker waits out the preempt's barrier here, so pushes
            # still flow between the manifest and the (gated) park
            wait_for(lambda: life["coord"].manifests_written > 0 or sched.preempts_aborted > 0,
                     120, "the preempt's snapshot barrier to publish")
        if j != 1:
            if kill_at is not None and step == verify_at:
                # the fleet must outlive the verify window: a finished worker
                # leaves, and everyone must re-attach
                verify_done.wait(300)
                if with_sched:
                    park.release.wait(300)
            if with_sched:
                park.follow(j)
            return
        if not with_sched and snapshot_at is not None and step == snapshot_at:
            life["coord"].trigger_snapshot()
            wait_for(lambda: os.path.exists(manifest_path)
                     and life["coord"].manifests_written > 0, 60,
                     "the pre-kill snapshot barrier to publish")
        if with_sched and kill_at is not None and step == snapshot_at:
            timings["peak"] = time.monotonic()
            registry.set_demand(SERVE_ID, 1)
        if with_sched and snapshot_at < step and not park.hold.is_set() \
                and sched.preempts_done > 0:
            park.hold.set()
        if kill_at is not None:
            if step == kill_at:
                if with_sched:
                    # mid-preemption: the victim parked (its park logged by
                    # the doomed life), the serving grant outstanding
                    wait_for(lambda: sched.preempts_done > 0 or sched.preempts_aborted > 0,
                             120, "the preempt to park the victim")
                    park.hold.set()
                    park.follow(1)
                else:
                    # mid-barrier: SnapshotRequest sent, then death
                    before = life["coord"]._snap_seq
                    life["coord"].trigger_snapshot()
                    wait_for(lambda: life["coord"]._snap_seq > before, 30,
                             "the doomed life to start its barrier", poll=0.001)
                kill_coordinator()
            elif step == kill_at + outage_steps:
                restore_coordinator()
            elif step == verify_at:
                try:
                    wait_for(lambda: "reattached" in timings, 120,
                             "the fleet to re-attach to the new life")
                    # and to hear from it: every live member's epoch fence
                    # moves to the new life (a member that only renewed
                    # learns it from its next join retry's reply)
                    wait_for(fenced, 60, "every live member to see the new life's epoch")
                    if with_sched:
                        timings["offpeak"] = time.monotonic()
                        registry.set_demand(SERVE_ID, 0)
                        wait_for(lambda: life["sched2"].resumes_done > 0
                                 or resume_failed.is_set(), 120,
                                 "the new life to resume the parked rank")
                        park.release.set()
                    else:
                        life["coord2"].trigger_snapshot()
                        wait_for(lambda: life["coord2"].manifests_written > 0, 60,
                                 "a post-restart snapshot to publish")
                finally:
                    verify_done.set()
                    park.release.set()
        if with_sched:
            park.follow(1)

    worker_clients: Dict[int, CoordClient] = {}

    def fenced() -> bool:
        epoch = life["coord2"].epoch
        live = {srv.server_id: srv.coord for srv in servers}
        live.update(worker_clients)
        if agent is not None:
            live[agent_rank] = agent.client
        return all(live[r].coord_epoch >= epoch for r in expected_live if r in live)

    def run_worker(j: int) -> None:
        client = CoordClient(coord_star[n_shards + j], "worker", renew_interval=lease / 4)
        worker_clients[n_shards + j] = client
        try:
            run_worker_loop(j, client, stars, x, y, make_model, steps=steps, lr=lr,
                            n_push=n_push, n_pull=n_pull, batch=batch, losses=losses,
                            opts=opts, step_hook=step_hook)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append((j, repr(e)))
            verify_done.set()
            park.release.set()
        finally:
            member_epochs[n_shards + j] = client.coord_epoch
            stale_drops[n_shards + j] = client.stale_epoch_dropped
            client.close()

    watcher = None
    if kill_at is not None:
        watcher = threading.Thread(target=watch_reattach, daemon=True)
        watcher.start()
    worker_threads = [threading.Thread(target=run_worker, args=(j,), daemon=True)
                      for j in range(1, n_workers + 1)]
    for t in worker_threads:
        t.start()
    for t in worker_threads:
        t.join(timeout=600)
    stuck = [t for t in worker_threads if t.is_alive()]
    watch_stop.set()
    if watcher is not None:
        watcher.join(timeout=10)
    if agent is not None:
        member_epochs[agent_rank] = agent.client.coord_epoch
        stale_drops[agent_rank] = agent.client.stale_epoch_dropped
        agent.close()
    for srv in servers:
        member_epochs[srv.server_id] = srv.coord.coord_epoch
        stale_drops[srv.server_id] = srv.coord.stale_epoch_dropped
    stop_servers(servers, serve_threads)
    coord2 = life.get("coord2")
    (coord2 or life["coord"]).stop()
    for key in ("thread", "thread2"):
        t = life.get(key)
        if t is not None:
            t.join(timeout=30)

    acked, applied = stars.accounting(servers)
    lost = _lost_pushes(acked, applied)
    violations.extend(lost)
    accounting_ok = not lost
    if "sched2" in life:
        violations.extend(life["sched2"].ledger.audit())
    stars.close(servers)
    for t in coord_world.values():
        t.close()
    events2 = list(coord2.events) if coord2 is not None else []
    evictions = [e for e in list(life["coord"].events) + events2 if "lease expired" in e]
    mttr = (timings["reattached"] - timings["killed"]
            if "reattached" in timings and "killed" in timings else None)
    ok = not stuck and not errors and not violations and not evictions
    if kill_at is not None:
        ok = (ok and coord2 is not None and mttr is not None
              and coord2.epoch == life["coord"].epoch + 1
              and coord2.shard_map.version >= timings["map_version_at_kill"])
        if with_sched:
            ok = ok and life["sched2"].resumes_done > 0 and bool(resumed.bit_identical)
        else:
            ok = ok and coord2.manifests_written > 0
    return {
        "ok": ok,
        "errors": errors,
        "stuck_workers": len(stuck),
        "violations": violations,
        "losses": losses,
        "acked": acked,
        "applied": applied,
        "accounting_ok": accounting_ok,
        "evictions": evictions,
        "epochs": (life["coord"].epoch, coord2.epoch if coord2 is not None else None),
        "map_versions": (timings.get("map_version_at_kill"),
                         (coord2 or life["coord"]).shard_map.version),
        "restored_members": coord2.restored_members if coord2 is not None else 0,
        "member_epochs": member_epochs,
        "stale_epoch_dropped": sum(stale_drops.values()),
        "manifests_written": (life["coord"].manifests_written,
                              coord2.manifests_written if coord2 is not None else None),
        "grants": agent.grants if agent is not None else [],
        "resumes_done": life["sched2"].resumes_done if "sched2" in life else None,
        "stranded": (sorted(coord2.parked_ranks()) if with_sched and coord2 is not None
                     else []),
        "bit_identical": resumed.bit_identical,
        "replayed_updates": resumed.replayed,
        "chaos_lines": log.lines(),
        "chaos_counts": log.counts(),
        "events": list(life["coord"].events),
        "events2": events2,
        "mttr_s": mttr,
        "outage_s": (timings["restored"] - timings["killed"]
                     if "restored" in timings and "killed" in timings else None),
        "restore_s": timings.get("restore_s"),
        "servers": servers,
    }


def drill_demo(seed: int = 0, base_dir: Optional[str] = None, model: str = "lenet",
               device="cuda") -> Dict:
    """One pass of the recovery drill (``coord/cli.py --drill``). Its files
    stay only under a ``base_dir`` the caller gives (``state_dir``)."""
    import contextlib
    import tempfile

    with contextlib.ExitStack() as stack:
        base = base_dir or stack.enter_context(tempfile.TemporaryDirectory(prefix="drill_"))
        out = recovery_drill(base_dir=base, seed=seed, plan=default_drill_plan(seed),
                             model=model, device=device)
    return {
        # > 0: the drill must have replayed acked updates only the logs held
        "ok": out["ok"] and out["replayed_updates"] > 0,
        "mttr_s": out["mttr_s"],
        "restore_s": out["restore_s"],
        "replayed_updates": out["replayed_updates"],
        "acked": out["acked"],
        "applied": out["applied"],
        "errors": out["errors"],
        "chaos": out["chaos_counts"],
        "events": out["events"],
        "manifest": out["manifest"],
        "state_dir": base_dir,
    }


def sched_demo(seed: int = 0, base_dir: Optional[str] = None, model: str = "lenet",
               device="cuda") -> Dict:
    """One pass of the scheduler drill (``coord/cli.py --sched-demo``). Its
    files stay only under a ``base_dir`` the caller gives (``state_dir``)."""
    import contextlib
    import tempfile

    with contextlib.ExitStack() as stack:
        base = base_dir or stack.enter_context(tempfile.TemporaryDirectory(prefix="sched_"))
        out = sched_drill(base_dir=base, seed=seed, plan=default_drill_plan(seed),
                          model=model, device=device)
    return {
        # > 0: the resume must have replayed acked updates only the log held
        "ok": out["ok"] and out["replayed_updates"] > 0,
        "violations": out["violations"],
        "preempt_mttr_s": out["sched"]["preempt_mttr_s"],
        "resume_mttr_s": out["sched"]["resume_mttr_s"],
        "replayed_updates": out["replayed_updates"],
        "bit_identical": out["bit_identical"],
        "acked": out["acked"],
        "applied": out["applied"],
        "held_pushes": out["held_pushes"],
        "grants": out["grants"],
        "errors": out["errors"],
        "events": out["events"],
        "chaos": out["chaos_counts"],
        "state_dir": base_dir,
    }
