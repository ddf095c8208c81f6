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

:func:`coordfail_drill` kills the coordinator instead, right after it sent
a snapshot barrier: the data plane trains on under the last map, a new
life over the same ``durable_dir`` (epoch bumped, members, map and clocks
replayed) waits out its grace window while the members re-attach, evicts
no one, and drives a barrier of its own to a published manifest.

Determinism: the injected faults sit on channels whose send sequences are
functions of the step script alone (worker 1's pull channel), and the kill
and restore are driven from worker 1's own step hook, so the
:class:`~..utils.chaos.ChaosLog` renders byte for byte the same on every
run and in either package. Pushes ride the envelope and are never faulted:
their loss-freedom must come from the WAL and the deferred acks.

The workers are the port's: a model of the fixture on its device (the card
by default), the synthetic CIFAR-10 set, ``loss_and_grads`` and the
optimizer's ``step``. Not in this package yet: the scheduler's drill, the
gray-failure drill and ``coordfail_drill(kill_during="preempt")``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
from distributed_ml_pytorch_tpu_torch.coord.manifest import MANIFEST_NAME, FleetManifest
from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
from distributed_ml_pytorch_tpu_torch.utils.chaos import (
    ChaosLog,
    ChaosPlan,
    FaultRule,
    FaultyTransport,
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
                    loss_to_step: bool = False, compress: str = "") -> None:
    """One drill worker: join, train ``steps`` steps of the elastic
    ``ShardedAsynchronous`` on the seeded batches of worker ``j``, calling
    ``step_hook(j, step)`` after each, then finish and leave.
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
    for step in range(steps):
        sel = np.random.default_rng(j * 1000 + step).integers(0, len(x), batch)
        loss = float(loss_and_grads(net, *to_device(x[sel], y[sel], dev), generator=gen))
        opt.step(loss if loss_to_step else None)
        my_losses.append(loss)
        if step_hook is not None:
            step_hook(j, step)
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

    def start(srv: ElasticShardServer) -> ElasticShardServer:
        serve_threads.append(threading.Thread(target=srv.run, kwargs={"timeout": 600},
                                              daemon=True))
        serve_threads[-1].start()
        return srv

    servers: List[ElasticShardServer] = [start(new_server(i)) for i in range(n_shards)]
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
            servers[i] = start(srv)
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
    worker 1's step script crashes it silently right after it sent a
    snapshot barrier (``kill_during="snapshot"``: the ``SnapshotDone``
    frames land on a dead socket) while the data plane trains on under the
    last map. The restart is a new :class:`Coordinator` over the same
    ``durable_dir`` (``base_dir/coord``): its epoch is one higher, its
    members, map and clocks are replayed, and its grace window holds lease
    expiry while the members' join retries re-attach them. At
    ``verify_at`` (default three steps after the restart) worker 1 waits
    for every member to re-attach and has the new life publish a manifest
    of its own. MTTR is the crash to the last re-attachment.

    ``kill_during="preempt"`` needs the multi-tenant scheduler, which this
    package does not have yet."""
    if kill_during != "snapshot":
        raise ValueError(f"coordfail_drill(kill_during={kill_during!r}): the multi-tenant "
                         "scheduler is not in this package yet")
    if verify_at is None and kill_at is not None:
        verify_at = kill_at + outage_steps + 3
    x, y, make_model, flat0 = resolve_fixture(fixture, model, device, seed)
    n_params = int(flat0.shape[0])

    log = ChaosLog()
    the_plan = plan if plan is not None else default_drill_plan(seed)
    coord_world = InProcessTransport.create_world(1 + n_shards + n_workers)
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

    def make_coordinator() -> Coordinator:
        return Coordinator(coord_hub, n_params, lease=lease, speculation=False,
                           manifest_dir=base_dir, durable_dir=coord_dir, grace=grace)

    life: Dict[str, object] = {"coord": make_coordinator()}
    life["thread"] = threading.Thread(target=life["coord"].run, kwargs={"timeout": 600},
                                      daemon=True)
    life["thread"].start()

    servers: List[ElasticShardServer] = []
    serve_threads: List[threading.Thread] = []
    for i in range(n_shards):
        client = CoordClient(coord_star[1 + i], "shard", renew_interval=lease / 4)
        srv = ElasticShardServer(
            server_id=1 + i, n_params=n_params, transport=stars.server_transport(i),
            coord=client, init_params=flat0, ckpt_dir=os.path.join(base_dir, f"shard{i}"),
            ckpt_every=0, wal=True, wal_group_n=wal_group_n)
        serve_threads.append(threading.Thread(target=srv.run, kwargs={"timeout": 600},
                                              daemon=True))
        serve_threads[-1].start()
        servers.append(srv)
    wait_for(lambda: len(life["coord"].shard_map.entries) == n_shards, 60,
              "all shard servers to join the map")

    expected_live = set(range(1, 1 + n_shards + n_workers))
    timings: Dict[str, float] = {}
    losses: Dict[int, list] = {}
    opts: Dict[int, object] = {}
    errors: list = []
    member_epochs: Dict[int, int] = {}
    stale_drops: Dict[int, int] = {}
    verify_done = threading.Event()
    if kill_at is None:
        verify_done.set()

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
        t = threading.Thread(target=c2.run, kwargs={"timeout": 600}, daemon=True)
        life["coord2"], life["thread2"] = c2, t
        t.start()
        timings["restored"] = time.monotonic()
        timings["restore_s"] = timings["restored"] - t0

    # re-attached = the new life's grace window drained by traffic and every
    # live rank in its member table
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
        if j != 1:
            if kill_at is not None and step == verify_at:
                # the fleet must outlive the verify window: a finished worker
                # leaves, and everyone must re-attach
                verify_done.wait(300)
            return
        if snapshot_at is not None and step == snapshot_at:
            life["coord"].trigger_snapshot()
            wait_for(lambda: os.path.exists(manifest_path)
                      and life["coord"].manifests_written > 0, 60,
                      "the pre-kill snapshot barrier to publish")
        if kill_at is None:
            return
        if step == kill_at:
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
                life["coord2"].trigger_snapshot()
                wait_for(lambda: life["coord2"].manifests_written > 0, 60,
                          "a post-restart snapshot to publish")
            finally:
                verify_done.set()

    def run_worker(j: int) -> None:
        client = CoordClient(coord_star[n_shards + j], "worker", renew_interval=lease / 4)
        try:
            run_worker_loop(j, client, stars, x, y, make_model, steps=steps, lr=lr,
                            n_push=n_push, n_pull=n_pull, batch=batch, losses=losses,
                            opts=opts, step_hook=step_hook)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append((j, repr(e)))
            verify_done.set()
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
    violations = [f"acked delta lost: shard {i} worker {j}: acked {acked[i][j]} > applied "
                  f"{applied[i][j]}"
                  for i in range(n_shards) for j in range(1, 1 + n_workers)
                  if acked[i][j] > applied[i][j]]
    accounting_ok = not violations
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
              and coord2.shard_map.version >= timings["map_version_at_kill"]
              and coord2.manifests_written > 0)
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
