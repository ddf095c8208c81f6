"""The elastic world in one process (counterpart of the JAX
``coord/demo.py``).

:func:`elastic_scenario` stands up the whole control plane in one process —
a coordinator, N elastic shard servers and M DownPour workers as threads,
each shard's world optionally under a chaos plan — and runs the elastic
script: the workers train, a late worker may join mid-run, a shard server
may crash silently mid-run (its lease expires, the coordinator rebalances,
the survivor resizes and the workers cut over), and training runs to its
end. It returns what the checks read: per-worker losses, the coordinator's
decision log, per-server stats and the final map.

The workers are the port's: a model on an explicit ``device`` (the card by
default, where every step runs the ``relu_pool2`` and ``flat_axpy``
kernels for AlexNet), the synthetic CIFAR-10 set, and the step
``train_worker`` runs (``loss_and_grads``, then the optimizer's ``step``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport


# the coordinator's world: rank 0 is the coordinator, shard server i is rank
# 1 + i, worker j (from 1) is rank n_shards + j
def _shard_rank(i: int) -> int:
    return 1 + i


def _worker_rank(n_shards: int, j: int) -> int:
    return n_shards + j


class ElasticWorld:
    """The transports of one in-process elastic fleet. Shard server ``i``
    is rank 0 of its own star ``shard_worlds[i]`` (worker ``j`` is rank
    ``j`` there); everyone has a rank in ``coord_world``. The worlds are
    sized for ``max_workers`` from the start, so a late joiner has its
    mailboxes (and its chaos wrappers) ready."""

    def __init__(self, n_shards: int, max_workers: int, plan=None, log=None):
        from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosLog, FaultyTransport

        self.n_shards = n_shards
        self.max_workers = max_workers
        self.coord_world = InProcessTransport.create_world(1 + n_shards + max_workers)
        self.shard_worlds = []
        self.log = log
        if plan is not None and log is None:
            self.log = ChaosLog()
        for _i in range(n_shards):
            world = InProcessTransport.create_world(1 + max_workers)
            if plan is not None:
                world, _ = FaultyTransport.wrap_world(world, plan, log=self.log)
            self.shard_worlds.append(world)

    def worker_factory(self, j: int):
        """Worker ``j``'s transport factory: a map entry names its server's
        coordinator rank, resolved to ``j``'s transport in that star."""
        def factory(entry):
            return self.shard_worlds[entry.server_id - 1][j]

        return factory

    def close(self) -> None:
        for world in self.shard_worlds:
            for t in world.values():
                t.close()
        for t in self.coord_world.values():
            t.close()


def default_fixture(model: str = "lenet", device="cuda", seed: int = 0):
    """``(x, y, make_model)``: the synthetic CIFAR-10 set of 256 images and
    a builder of the seeded model on ``device`` (AlexNet with its fused
    ``relu_pool2`` epilogue)."""
    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.models import get_model

    x, y, *_ = load_cifar10(n_train=256, n_test=32, synthetic=True)

    def make_model():
        return get_model(model, fused_epilogue=True, seed=seed, device=device)

    return x, y, make_model


def elastic_scenario(*, seed: int = 0, steps: int = 16, n_workers: int = 2,
                     n_shards: int = 2, join_worker_at: Optional[int] = None,
                     join_worker_steps: int = 8, crash_shard_at: Optional[int] = None,
                     plan=None, lease: float = 0.6, lr: float = 0.05, n_push: int = 2,
                     n_pull: int = 2, batch: int = 16, slow_worker: Optional[int] = None,
                     slow_factor: float = 0.0, step_sleep: float = 0.0,
                     speculation: bool = False, fixture=None, model: str = "lenet",
                     device="cuda", step_hook=None) -> Dict:
    """Run the elastic script (the module docstring); a summary dict:
    ``losses`` per worker, ``events`` (the coordinator's log), ``stats`` per
    server, ``worker_map_versions``, ``map_version``, ``ok``.

    ``join_worker_at`` / ``crash_shard_at`` are steps of worker 1's loop at
    which the extra worker joins (with ``rejoin``, for ``join_worker_steps``
    steps) and shard server ``n_shards - 1`` crashes silently.
    ``slow_worker`` sleeps ``slow_factor`` s after each step, every worker
    ``step_sleep`` s; ``step_hook(j, step, opt)`` runs after each step.
    ``fixture`` is ``(x, y, make_model)`` (:func:`default_fixture` of
    ``model`` on ``device`` by default)."""
    import torch

    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads, to_device
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    x, y, make_model = fixture if fixture is not None else default_fixture(model, device, seed)
    flat0 = ravel_model_params(make_model()).cpu().numpy().astype(np.float32)
    n_params = int(flat0.shape[0])

    max_workers = n_workers + (1 if join_worker_at is not None else 0)
    world = ElasticWorld(n_shards, max_workers, plan=plan)
    coord = Coordinator(world.coord_world[0], n_params, lease=lease, speculation=speculation)
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": 300}, daemon=True)
    coord_thread.start()

    servers, server_threads = [], []
    for i in range(n_shards):
        client = CoordClient(world.coord_world[_shard_rank(i)], "shard",
                             renew_interval=lease / 4)
        srv = ElasticShardServer(server_id=_shard_rank(i), n_params=n_params,
                                 transport=world.shard_worlds[i][0], coord=client,
                                 init_params=flat0)
        servers.append(srv)
        t = threading.Thread(target=srv.run, kwargs={"timeout": 300}, daemon=True)
        t.start()
        server_threads.append(t)

    losses: Dict[int, list] = {}
    final_versions: Dict[int, int] = {}
    spec_tasks: Dict[int, list] = {}
    join_evt = threading.Event()
    crash_evt = threading.Event()
    errors: list = []

    def run_worker(j: int, my_steps: int, rejoin: bool) -> None:
        try:
            _run_worker(j, my_steps, rejoin)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append((j, repr(e)))

    def _run_worker(j: int, my_steps: int, rejoin: bool) -> None:
        tasks: list = []
        spec_tasks[j] = tasks
        client = CoordClient(world.coord_world[_worker_rank(n_shards, j)], "worker",
                             renew_interval=lease / 4,
                             on_speculate=lambda tid, victim, frm: tasks.append(
                                 (tid, victim, frm)))
        m = client.join(timeout=30)
        if m is None or not m.entries:
            raise RuntimeError("worker never got a shard map")
        factory = world.worker_factory(j)
        net = make_model()
        dev = next(net.parameters()).device
        opt = ShardedAsynchronous(net, lr=lr, n_push=n_push, n_pull=n_pull,
                                  transports=[factory(e) for e in m.entries], coord=client,
                                  transport_factory=factory, shard_map=m, rejoin=rejoin)
        gen = torch.Generator(device=dev).manual_seed(100 + j)
        my_losses = losses.setdefault(j, [])
        for step in range(my_steps):
            sel = np.random.default_rng(j * 1000 + step).integers(0, len(x), batch)
            loss = loss_and_grads(net, *to_device(x[sel], y[sel], dev), generator=gen)
            # the step reports the inter-step EWMA (the sleeps below included)
            opt.step()
            my_losses.append(float(loss))
            if step_sleep > 0:
                # paced so the lease events land while training still runs
                time.sleep(step_sleep)
            if slow_worker == j and slow_factor > 0:
                time.sleep(slow_factor)
            if step_hook is not None:
                step_hook(j, step, opt)
            if j == 1:
                if join_worker_at is not None and step == join_worker_at:
                    join_evt.set()
                if crash_shard_at is not None and step == crash_shard_at:
                    crash_evt.set()
        final_versions[j] = opt.map_version
        opt.finish()
        client.close()

    worker_threads = [threading.Thread(target=run_worker, args=(j, steps, False), daemon=True)
                      for j in range(1, n_workers + 1)]
    for t in worker_threads:
        t.start()
    if join_worker_at is not None:
        join_evt.wait(timeout=120)
        jt = threading.Thread(target=run_worker, args=(max_workers, join_worker_steps, True),
                              daemon=True)
        jt.start()
        worker_threads.append(jt)
    if crash_shard_at is not None:
        crash_evt.wait(timeout=120)
        # silent: the serve loop dies and the renewals stop, no leave is
        # sent — the coordinator must find the death
        servers[n_shards - 1].crash()
        if hasattr(world.shard_worlds[n_shards - 1][0], "crash"):
            world.shard_worlds[n_shards - 1][0].crash()

    for t in worker_threads:
        t.join(timeout=300)
    alive = [t for t in worker_threads if t.is_alive()]
    for srv in servers:
        srv.stop()
    for t in server_threads:
        t.join(timeout=30)
    coord.stop()
    coord_thread.join(timeout=30)
    world.close()
    return {
        "ok": not alive and not errors,
        "errors": errors,
        "stuck_workers": len(alive),
        "losses": losses,
        "worker_map_versions": final_versions,
        "events": list(coord.events),
        "stats": {srv.server_id: dict(srv.stats) for srv in servers},
        "spec_tasks": spec_tasks,
        "map_version": coord.shard_map.version,
        "final_map": coord.shard_map,
        "servers": servers,
        "chaos_counts": world.log.counts() if world.log else {},
    }


def elastic_demo(seed: int = 0, model: str = "lenet", device="cuda") -> Dict:
    """One pass of the elastic script under light chaos (``--demo``):
    two shards, two workers, a third joining at step 6, shard 2 crashing
    at step 10."""
    from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosPlan, FaultRule

    plan = ChaosPlan([FaultRule(drop=0.05, dup=0.02)], seed=seed)
    out = elastic_scenario(seed=seed, steps=16, n_workers=2, n_shards=2, join_worker_at=6,
                           join_worker_steps=8, crash_shard_at=10, plan=plan, model=model,
                           device=device)
    first = {j: round(float(np.mean(v[:4])), 3) for j, v in out["losses"].items()}
    last = {j: round(float(np.mean(v[-4:])), 3) for j, v in out["losses"].items()}
    return {
        "ok": out["ok"] and out["map_version"] >= 2,
        "map_version": out["map_version"],
        "first_losses": first,
        "last_losses": last,
        "coordinator_events": out["events"],
        "server_stats": out["stats"],
        "worker_map_versions": out["worker_map_versions"],
        "errors": out["errors"],
        "chaos": out["chaos_counts"],
    }
