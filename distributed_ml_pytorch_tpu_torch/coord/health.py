"""The numerical-health scenario (counterpart of the JAX
``coord/health.py``).

:func:`health_scenario` stands up the training immune system in one
process (a coordinator with the rollback watchdog and worker reputation, N
elastic shard servers with a WAL behind the admission gate, M DownPour
workers over reliable transports) and runs its script:

1. train cleanly; at a scripted step, drive a snapshot barrier, so a good
   :class:`~.manifest.FleetManifest` exists (the rollback target);
2. a poisoned worker's push channel suffers seeded silent data corruption:
   first a *scale* corruption (``x factor``, the envelope re-stamped, so
   the frame is bit-perfect on the wire) that slips the gate's z-score and
   drives the central parameters toward divergence, then *NaN* injection,
   which the gate catches, quarantines and nacks;
3. the fleet's loss telemetry diverges; the watchdog sends a
   ``RollbackRequest`` barrier: the shards restore the manifest's snapshot
   in place, the workers drop their accumulators and pull, training goes
   on, and the MTTR is measured;
4. the offender's nack count crosses the reputation limit and its lease is
   revoked (it may rejoin only after a cooldown);
5. the run ends in the fault-free corridor, every rejected update was
   nacked and none reached a WAL: the delivery envelope of every record a
   shard appended to its log is kept as it is appended, and no quarantined
   push's envelope is among them (``quarantined_in_wal``).

Each shard's rollback is also held against an independent restore: the
shard directories are copied when the manifest is published, and a fresh
``ParameterServer`` over the copy, rolled back to the manifest's apply
seq, must hold the same vector bit for bit (``rollback_bit_identical``).

Determinism: SDC decisions for enveloped pushes are keyed by the envelope's
sequence number, a function of the worker's step script alone (pushes are
the only enveloped worker traffic here), and a retransmit re-derives the
same corruption without logging it again, so the chaos log renders the
same bytes on every run and in either package.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
from distributed_ml_pytorch_tpu_torch.coord.drill import (
    PsStars,
    resolve_fixture,
    run_worker_loop,
    stop_servers,
    wait_for,
)
from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
from distributed_ml_pytorch_tpu_torch.coord.manifest import MANIFEST_NAME, FleetManifest
from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosLog, ChaosPlan, SDCRule
from distributed_ml_pytorch_tpu_torch.utils.health import GradientAdmission
from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport, MessageCode
from distributed_ml_pytorch_tpu_torch.utils.obs import SpanRecorder

#: the codes a health world sends outside the envelope (the drill's: the
#: enveloped sequence, which keys the SDC decisions, is then the push
#: script alone); ``UpdateNack`` stays enveloped: a reject is never silent
HEALTH_UNRELIABLE = (
    MessageCode.Heartbeat,
    MessageCode.LeaseRenew,
    MessageCode.ParameterRequest,
    MessageCode.ParameterUpdate,
)


def poisoned_worker_sdc(worker: int, *, scale_after: int, scale_until: int, nan_after: int,
                        nan_until: Optional[int] = None, factor: float = -8.0) -> tuple:
    """The poisoned worker's fault mix on its push channel: a window of
    *scale* SDC (``factor < 0`` turns descent into ascent, which the gate
    cannot see and the watchdog exists for), then *NaN* SDC (caught and
    nacked by the gate: the reputation's input), clean again past
    ``nan_until``. ``skip=6`` leaves ``ShardPush``'s version and range head
    alone. The windows are envelope seqs, which are push indices."""
    return (
        SDCRule(src=worker, dst=0, code=int(MessageCode.ShardPush), p=1.0, kind="scale",
                factor=factor, skip=6, after=scale_after, until=scale_until),
        SDCRule(src=worker, dst=0, code=int(MessageCode.ShardPush), p=1.0, kind="nan",
                skip=6, after=nan_after, until=nan_until),
    )


def _record_rollbacks(srv: ElasticShardServer, into: list) -> None:
    """Keep ``(server id, target seq, apply seq, vector)`` after each
    rollback of ``srv``'s server, for the independent restore."""
    restore = srv.ps.rollback_restore

    def recorded(target_seq: int) -> int:
        n = restore(target_seq)
        into.append((srv.server_id, int(target_seq), srv.ps._apply_seq,
                     np.array(srv.ps.central, copy=True)))
        return n

    srv.ps.rollback_restore = recorded


def _record_envelopes(srv: ElasticShardServer, appended: list, quarantined: list) -> None:
    """Keep the delivery envelope ``(sender, env_inc, env_seq)`` of each
    record ``srv``'s server appends to its WAL, and of each push its gate
    quarantines, as it happens: a rollback later drops the log's tail."""
    ps = srv.ps
    append, quarantine = ps.wal.append, ps._quarantine_update

    def appending(seq, payload, *, sender=0, env_inc=0, env_seq=0, **kw):
        appended.append((int(sender), int(env_inc), int(env_seq)))
        return append(seq, payload, sender=sender, env_inc=env_inc, env_seq=env_seq, **kw)

    def quarantining(sender, verdict):
        env_inc, env_seq = ps._envelope or (0, 0)
        quarantined.append((int(sender), int(env_inc), int(env_seq)))
        return quarantine(sender, verdict)

    ps.wal.append = appending
    ps._quarantine_update = quarantining


def _land_and_pull(opt, servers, j: int, pushed: int) -> None:
    """Hand worker ``j``'s pushes to the wire, wait until every shard has
    taken the first ``pushed`` of them, then pull every shard and install
    the replies: the next step trains on what the pushes did."""
    opt._flusher.drain()
    wait_for(lambda: all(srv.ps.applied_by_sender.get(j, 0)
                         + srv.ps.quarantined_by_sender.get(j, 0) >= pushed
                         for srv in servers), 180, f"push {pushed - 1} to reach every shard")
    before = [listener.replies for listener in opt.listeners]
    opt._pull_all()
    wait_for(lambda: all(listener.replies > n for listener, n in zip(opt.listeners, before)),
             60, "every shard's pull reply")
    opt._install_arrived()


def _probe_loss(opt, x, y, step: int, j: int, batch: int) -> None:
    """Install what worker ``j``'s pulls brought, fold the loss of its
    model on the step's batch (no gradients, dropout off) into the
    telemetry its renewals carry, and pull every shard again."""
    import torch

    from distributed_ml_pytorch_tpu_torch.training.trainer import cross_entropy_loss, to_device

    opt._install_arrived()
    net = opt.model
    sel = np.random.default_rng(j * 1000 + step).integers(0, len(x), batch)
    bx, by = to_device(x[sel], y[sel], next(net.parameters()).device)
    net.eval()
    with torch.no_grad():
        loss = float(cross_entropy_loss(net(bx), by))
    net.train()
    opt.observe_loss(loss)
    opt._report_progress()
    opt._pull_all()


def _independent_restore(copy_dir: str, size: int, target_seq: int):
    """A fresh server's rollback over a copy of a shard's directory:
    ``(apply seq, vector)``."""
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer

    fresh = ParameterServer(params=np.zeros(size, np.float32), ckpt_dir=copy_dir, wal=True)
    try:
        fresh.rollback_restore(target_seq)
        return fresh._apply_seq, fresh.central
    finally:
        fresh.wal.close()


def health_scenario(*, base_dir: str, seed: int = 0, steps: int = 64, n_workers: int = 2,
                    n_shards: int = 2, poison_worker: Optional[int] = 2, snapshot_at: int = 20,
                    scale_after: int = 11, scale_until: int = 16, nan_after: int = 16,
                    nan_until: Optional[int] = 22, poison_factor: float = -16.0,
                    rollback_wait_at: int = 36, watchdog_at: Optional[int] = None,
                    lease: float = 5.0, renew_interval: float = 0.1, lr: float = 0.05,
                    n_push: int = 2, n_pull: int = 2, batch: int = 16,
                    step_sleep: float = 0.1, z_max: float = 6.0, warmup: int = 2,
                    reputation_nacks: int = 6, reputation_cooldown: float = 60.0,
                    rollback_loss_factor: float = 1.2, rollback_timeout: float = 60.0,
                    wal_group_n: int = 4, fixture=None, model: str = "lenet",
                    device="cuda") -> Dict:
    """Run one pass of the script (the module docstring).

    ``poison_worker=None`` runs the fault-free baseline (no SDC, no
    rollback; the snapshot still fires). ``snapshot_at`` and
    ``rollback_wait_at`` are steps of worker 1's loop; ``scale_after``,
    ``scale_until``, ``nan_after`` and ``nan_until`` push indices on the
    poisoned worker's channel.

    The watchdog starts disarmed; the poisoned worker arms it at step
    ``watchdog_at`` (by default the step after its last scale-window push)
    once the whole window has passed through every shard, and waits there
    for the barrier to close, pulling every shard and reporting the loss of
    what it installed each 0.1 s (``probes``), so the watchdog judges the
    parameters the window left. A watchdog firing mid-window would restore
    while gate-slipping pushes still stream in, re-poisoning the restored
    state, and the cooldown (rightly) refuses a second barrier.

    Every worker sleeps ``step_sleep`` after a step. The poison diverges the
    fleet by feedback: the poisoned worker pulls what its scaled pushes did
    and pushes larger ones. On a loaded host its push thread falls behind
    the pulls, the worker trains on central parameters its pushes have not
    reached yet, and the divergence can stay under the watchdog's factor
    (the JAX scenario, at 0.03 s a step; with LeNet on 8 busy CPU cores,
    2 runs of the port's in 12 at 0.1 s never rolled back). So after each
    push of the scale window the poisoned worker waits until every shard
    has taken it and installs a fresh pull before its next step.
    ``fixture`` is ``(x, y, make_model)`` (``coord.demo.default_fixture``
    of ``model`` on ``device`` by default)."""
    x, y, make_model, flat0 = resolve_fixture(fixture, model, device, seed)
    n_params = int(flat0.shape[0])
    poisoned = poison_worker is not None
    plan = ChaosPlan(seed=seed, sdc=(poisoned_worker_sdc(
        poison_worker, scale_after=scale_after, scale_until=scale_until, nan_after=nan_after,
        nan_until=nan_until, factor=poison_factor) if poisoned else ()))

    log = ChaosLog()
    coord_world = InProcessTransport.create_world(1 + n_shards + n_workers)
    # the plan corrupts in place and never drops or delays, so a timeout
    # here is a starved thread, not a dead peer: a long breaker grace keeps
    # the retransmits flowing instead of opening the circuit
    stars = PsStars(n_shards, n_workers, [plan] * n_shards, log, HEALTH_UNRELIABLE,
                    breaker_grace=60.0)
    manifest_path = os.path.join(base_dir, MANIFEST_NAME)
    if watchdog_at is None:
        watchdog_at = scale_until * n_push  # the first step past the window
    coord = Coordinator(coord_world[0], n_params, lease=lease, speculation=False,
                        manifest_dir=base_dir, auto_rollback=False,
                        rollback_loss_factor=rollback_loss_factor,
                        # one rollback a run: the log and "exactly the
                        # scripted barrier" must not hang on how fast the
                        # telemetry recovers
                        rollback_cooldown=600.0, rollback_timeout=rollback_timeout,
                        reputation_nacks=reputation_nacks,
                        reputation_cooldown=reputation_cooldown)
    # the rollback barrier dumps the decision timeline to base_dir/obs, so
    # its MTTR ships with its window; the recorder only observes (the chaos
    # log is the same with it)
    coord.recorder = SpanRecorder("coord", "coord")
    coord.obs_dir = os.path.join(base_dir, "obs")
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": 600}, daemon=True)
    coord_thread.start()

    servers: List[ElasticShardServer] = []
    serve_threads: List[threading.Thread] = []
    rollbacks: list = []
    appended: Dict[int, list] = {}
    quarantined_envs: Dict[int, list] = {}
    for i in range(n_shards):
        client = CoordClient(coord_world[1 + i], "shard", renew_interval=renew_interval)
        srv = ElasticShardServer(
            server_id=1 + i, n_params=n_params, transport=stars.server_transport(i),
            coord=client, init_params=flat0, ckpt_dir=os.path.join(base_dir, f"shard{i}"),
            ckpt_every=0, wal=True, wal_group_n=wal_group_n,
            admission=GradientAdmission(z_max=z_max, warmup=warmup),
            manifest_path=manifest_path)
        _record_rollbacks(srv, rollbacks)
        _record_envelopes(srv, appended.setdefault(i, []), quarantined_envs.setdefault(i, []))
        servers.append(srv)
        serve_threads.append(threading.Thread(target=srv.run, kwargs={"timeout": 600},
                                              daemon=True))
        serve_threads[-1].start()
    wait_for(lambda: len(coord.shard_map.entries) == n_shards, 60,
              "all shard servers to join the map")

    losses: Dict[int, list] = {}
    opts: Dict[int, object] = {}
    errors: list = []
    probes = [0]
    snap_evt = threading.Event()
    at_snapshot = os.path.join(base_dir, "at_snapshot")

    def step_hook(j: int, step: int) -> None:
        if step_sleep > 0:
            time.sleep(step_sleep)
        if (poisoned and j == poison_worker and step % n_push == 0
                and scale_after <= step // n_push < scale_until):
            # the window's feedback, push by push, whatever the host's load
            _land_and_pull(opts[j], servers, j, step // n_push + 1)
        if poisoned and j == poison_worker and step == watchdog_at:
            # past the window, each of whose pushes has landed on every shard
            coord.auto_rollback = True

            # held until the barrier closes: the watchdog fires on this
            # worker's own telemetry, the losses of the parameters the
            # window left (its renewals flow while it waits)
            def rolled_back() -> bool:
                if coord.rollbacks_done >= 1:
                    return True
                _probe_loss(opts[j], x, y, step, j, batch)
                probes[0] += 1
                return False

            wait_for(rolled_back, 120, "the watchdog-triggered rollback to complete", poll=0.1)
        if j != 1:
            # every other worker waits at the snapshot step, so the
            # manifest predates its first poisonable push
            if step == snapshot_at:
                snap_evt.wait(300)
            return
        if step == snapshot_at:
            coord.trigger_snapshot()
            try:
                wait_for(lambda: os.path.exists(manifest_path) and coord.manifests_written > 0,
                          60, "the snapshot barrier to publish a manifest")
                # the state a rollback restores, for the independent restore
                for i in range(n_shards):
                    shutil.copytree(os.path.join(base_dir, f"shard{i}"),
                                    os.path.join(at_snapshot, f"shard{i}"))
            finally:
                snap_evt.set()
        if poisoned and step == rollback_wait_at:
            # at least one completed rollback inside the run, with steps
            # left to converge again
            wait_for(lambda: coord.rollbacks_done >= 1, 120,
                      "the coordinator's auto-rollback to complete")

    def run_worker(j: int) -> None:
        client = CoordClient(coord_world[n_shards + j], "worker", renew_interval=renew_interval)
        try:
            run_worker_loop(j, client, stars, x, y, make_model, steps=steps, lr=lr,
                            n_push=n_push, n_pull=n_pull, batch=batch, losses=losses,
                            opts=opts, step_hook=step_hook, loss_to_step=True)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append((j, repr(e)))
            snap_evt.set()  # never leave the other workers waiting
        finally:
            client.close()

    worker_threads = [threading.Thread(target=run_worker, args=(j,), daemon=True)
                      for j in range(1, n_workers + 1)]
    for t in worker_threads:
        t.start()
    for t in worker_threads:
        t.join(timeout=600)
    stuck = [t for t in worker_threads if t.is_alive()]
    stop_servers(servers, serve_threads)
    coord.stop()
    coord_thread.join(timeout=30)

    # every quarantined update was nacked, and the accounting closes:
    # acked <= applied + quarantined + rolled back
    acked, applied = stars.accounting(servers)
    quarantined = {i: {j: srv.ps.quarantined_by_sender.get(j, 0)
                       for j in range(1, 1 + n_workers)} for i, srv in enumerate(servers)}
    accounting_ok = all(
        acked[i][j] <= applied[i][j] + quarantined[i][j] + servers[i].ps.rolled_back_updates
        for i in range(n_shards) for j in range(1, 1 + n_workers))
    nacks_explicit = all(srv.ps.quarantined == srv.ps.nacks_sent for srv in servers)
    # every push logged or quarantined came in an envelope (a nonzero
    # incarnation), and no quarantined one was logged
    quarantined_in_wal = sum(len(set(quarantined_envs[i]) & set(appended[i]))
                             for i in range(n_shards))
    wal_clean = quarantined_in_wal == 0 and all(
        len(quarantined_envs[i]) == servers[i].ps.quarantined
        and all(env[1] > 0 for env in quarantined_envs[i] + appended[i])
        for i in range(n_shards))
    central_finite = all(bool(np.isfinite(srv.central).all()) for srv in servers)
    bit_identical = None
    if rollbacks and os.path.isdir(at_snapshot):
        manifest = FleetManifest.load(manifest_path)
        bit_identical = True
        for sid, target, seq, central in rollbacks:
            entry = manifest.entry_for(sid)
            fresh_seq, fresh = _independent_restore(
                os.path.join(at_snapshot, f"shard{sid - 1}"), entry.hi - entry.lo, target)
            bit_identical &= (target == entry.apply_seq and fresh_seq == seq
                              and np.array_equal(fresh, central))
    stars.close(servers)
    for t in coord_world.values():
        t.close()
    return {
        "ok": (not stuck and not errors and accounting_ok and nacks_explicit and central_finite
               and wal_clean),
        "errors": errors,
        "stuck_workers": len(stuck),
        "losses": losses,
        "acked": acked,
        "applied": applied,
        "quarantined": quarantined,
        "accounting_ok": accounting_ok,
        "nacks_explicit": nacks_explicit,
        "central_finite": central_finite,
        "wal_appended": {i: len(v) for i, v in appended.items()},
        "quarantined_in_wal": quarantined_in_wal,
        "wal_clean": wal_clean,
        "probes": probes[0],
        "worker_nacks": {j: getattr(opts.get(j), "nacks", 0) for j in range(1, 1 + n_workers)},
        "worker_rollbacks": {j: getattr(opts.get(j), "rollbacks_seen", 0)
                             for j in range(1, 1 + n_workers)},
        "quarantined_total": sum(srv.ps.quarantined for srv in servers),
        "nacks_sent_total": sum(srv.ps.nacks_sent for srv in servers),
        "rollbacks": coord.rollbacks_done,
        "rollbacks_abandoned": coord.rollbacks_abandoned,
        "rollback_mttr_s": coord.rollback_mttrs[0] if coord.rollback_mttrs else None,
        "rollback_reports": sorted({sid for sid, *_ in rollbacks}),
        "rollback_bit_identical": bit_identical,
        "revoked_workers": coord.revoked_workers,
        "chaos_lines": log.lines(),
        "chaos_counts": log.counts(),
        "events": list(coord.events),
        "stats": {srv.server_id: dict(srv.stats) for srv in servers},
        "servers": servers,
    }


def health_demo(seed: int = 0, base_dir: Optional[str] = None, model: str = "lenet",
                device="cuda") -> Dict:
    """One pass of the script (``coord/cli.py --health``). Its files stay
    only under a ``base_dir`` the caller gives (``state_dir``)."""
    import contextlib
    import tempfile

    with contextlib.ExitStack() as stack:
        base = base_dir or stack.enter_context(tempfile.TemporaryDirectory(prefix="health_"))
        out = health_scenario(base_dir=base, seed=seed, model=model, device=device)
    return {
        "ok": (out["ok"] and out["rollbacks"] >= 1 and out["quarantined_total"] > 0
               and out["revoked_workers"] >= 1),
        "rollbacks": out["rollbacks"],
        "rollback_mttr_s": out["rollback_mttr_s"],
        "rollback_bit_identical": out["rollback_bit_identical"],
        "quarantined": out["quarantined_total"],
        "nacks_sent": out["nacks_sent_total"],
        "worker_nacks": out["worker_nacks"],
        "revoked_workers": out["revoked_workers"],
        "first_losses": {j: round(float(np.mean(v[:4])), 3) for j, v in out["losses"].items()},
        "last_losses": {j: round(float(np.mean(v[-4:])), 3) for j, v in out["losses"].items()},
        "errors": out["errors"],
        "chaos": out["chaos_counts"],
        "events": out["events"],
        "state_dir": base_dir,
    }
