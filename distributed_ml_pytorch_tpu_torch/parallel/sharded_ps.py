"""Sharded parameter server, the static world (counterpart of the JAX
``parallel/sharded_ps.py``; the DistBelief layout the reference descends
from).

Sharding is composition over the unsharded pieces. The central vector
splits into k contiguous ranges (:func:`shard_ranges`); shard ``s`` is an
unmodified :class:`~distributed_ml_pytorch_tpu_torch.parallel.async_ps.
ParameterServer` over ``flat[lo_s:hi_s]``, the server of its own transport
star (TCP: ``port + s``). A worker holds one transport per shard and runs the
DownPour cadence against all of them (:class:`ShardedAsynchronous`): a push
sends each server its slice of the accumulator, a pull asks every server,
and whatever slices have arrived are installed at the next step, so a worker
may hold shard A's fresh slice beside shard B's older one (DownPour's
staleness, per shard). There is no new wire format and no new server code,
so a worker of either package trains against shard servers of the other.
A shard server may carry a server-side optimizer over exactly its range
(``parallel/optplane.ShardedOptimizer``, the state a shard holds scaling as
1/k), and a worker may compress its pushes: one error-feedback encoder over
the whole flat vector frames each shard's slice as its own
``CompressedUpdate``.

A shard whose server dies degrades its slice to purely local SGD; the
other shards keep their service, and a pull still goes to the dead shard
as the probe that revives it. The sharded worker runs one step a dispatch:
it has no ``boundary``, as in the JAX package, so ``train_worker`` takes
the per-step path for it.

Not in this package yet: the elastic path (``coord/``: shard maps,
cutovers, range installs, the optimizer's ``resize`` on a cutover and the
stamped ``CompressedUpdate`` slices) and the scheduler's hold.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.parallel.async_ps import (
    DownpourClient,
    ParameterServer,
    PushFlusher,
)
from distributed_ml_pytorch_tpu_torch.parallel.optplane import (
    ShardedOptimizer,
    server_opt_from_args,
)
from distributed_ml_pytorch_tpu_torch.utils.health import admission_from_args
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    MessageCode,
    Transport,
    send_message,
)
from distributed_ml_pytorch_tpu_torch.utils.serialization import (
    ravel_model_params,
    unravel_model_params,
)


def shard_ranges(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal [lo, hi) ranges covering ``range(n)`` — the
    first ``n % n_shards`` shards are one element longer."""
    if n_shards < 1 or n_shards > n:
        raise ValueError(f"need 1 <= n_shards <= {n}, got {n_shards}")
    base, extra = divmod(n, n_shards)
    ranges, lo = [], 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < extra else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def make_shard_server(model: Optional[nn.Module] = None, *, shard: int, n_shards: int,
                      params: Optional[np.ndarray] = None,
                      transport: Optional[Transport] = None,
                      n_workers: Optional[int] = None,
                      worker_timeout: Optional[float] = None,
                      ckpt_dir: Optional[str] = None, ckpt_every: int = 500,
                      staleness_damping: float = 0.0, wal: bool = False,
                      admission=None, combine: str = "add",
                      server_opt: Optional[str] = None,
                      server_opt_kw: Optional[dict] = None) -> ParameterServer:
    """A plain :class:`ParameterServer` over shard ``shard``'s slice of the
    flat parameters (``params``, or ``model`` ravelled on the host).
    ``ckpt_dir`` should be the shard's own (``<dir>/shard<s>``): each server
    checkpoints, and with ``wal`` logs, only its slice. ``server_opt``
    (``"sgdm"`` or ``"adam"``, options ``server_opt_kw``) gives the shard an
    optimizer over exactly its ``[lo, hi)``."""
    flat = (np.asarray(params, np.float32) if params is not None
            else ravel_model_params(model).cpu().numpy().astype(np.float32))
    lo, hi = shard_ranges(flat.shape[0], n_shards)[shard]
    optimizer = (ShardedOptimizer(server_opt, lo, hi, **(server_opt_kw or {}))
                 if server_opt else None)
    return ParameterServer(params=flat[lo:hi], transport=transport, n_workers=n_workers,
                           worker_timeout=worker_timeout, ckpt_dir=ckpt_dir,
                           ckpt_every=ckpt_every, staleness_damping=staleness_damping,
                           wal=wal, admission=admission, combine=combine,
                           optimizer=optimizer)


class ShardedAsynchronous(DownpourClient):
    """DownPour client against k shard servers: :class:`~distributed_ml_pytorch_tpu_torch.
    parallel.async_ps.Asynchronous`'s cadence, accumulator, push, resync
    and finish (their :class:`~distributed_ml_pytorch_tpu_torch.parallel.
    async_ps.DownpourClient`), one transport per shard.

    Used like a torch optimizer: after ``loss.backward()``, ``opt.step()``
    installs whatever shard slices have arrived, asks every shard for its
    slice every ``n_pull`` steps, applies the local update while
    accumulating it into one flat accumulator, and every ``n_push`` steps
    hands a snapshot of it to the push thread, which slices it per shard.
    With one transport it is the unsharded client, push for push.

    Construction installs each server's slice of the model (or, with
    ``rejoin``, adopts every shard's slice, each awaited up to
    ``install_timeout`` seconds). ``heartbeats[s]`` (optional) is shard
    ``s``'s ``HeartbeatSender``: its ``peer_down`` degrades the shard before
    a send could block. A nack from any shard's admission gate pulls every
    shard and holds the updates until each has installed. ``step(loss)``
    with a nonfinite loss skips the update, the cadence unchanged.
    ``compress``/``compress_opts`` compress the pushes: one error-feedback
    encoder over the full length, one unstamped ``CompressedUpdate`` a
    shard's slice.
    """

    def __init__(self, model: nn.Module, lr: float, n_push: int, n_pull: int, *,
                 transports: Sequence[Transport], tx=None, rejoin: bool = False,
                 install_timeout: float = 5.0, heartbeats: Optional[Sequence] = None,
                 compress: Optional[str] = None, compress_opts: Optional[dict] = None):
        if not transports:
            raise ValueError("need at least one shard transport")
        if heartbeats and len(heartbeats) != len(transports):
            raise ValueError("need one heartbeat sender per shard transport")
        flat = self._setup(model, lr, n_push, n_pull, tx, transports, compress,
                           compress_opts)
        self.ranges = shard_ranges(self._flat_n, len(self.transports))
        self.shard_down = [False] * len(self.transports)
        self.heartbeats = list(heartbeats) if heartbeats else []
        self._owned_heartbeats = []  # the caller starts and stops them
        if rejoin:
            self._pull_all()
            for s, listener in enumerate(self.listeners):
                if not listener.wait_for_update(timeout=install_timeout):
                    print(f"worker: rejoin pull to shard {s} unanswered after "
                          f"{install_timeout:.1f}s — that slice starts from local init",
                          file=sys.stderr)
        else:
            for s, (lo, hi) in enumerate(self.ranges):
                self._send(s, MessageCode.ParameterUpdate, flat[lo:hi])
        # the fetched push vector is sliced per shard on the push thread, so
        # the training thread never waits on a copy or a socket
        self._flusher = PushFlusher(self._push_all)

    def _push_all(self, arr: np.ndarray) -> None:
        """Send every shard its slice of one fetched push vector, dense or
        compressed (unstamped: the static ranges never move)."""
        for s, (lo, hi) in enumerate(self.ranges):
            if self.encoder is None:
                self._send(s, MessageCode.GradientUpdate, arr[lo:hi])
            else:
                self._sendv(s, MessageCode.CompressedUpdate,
                            self.encoder.encode_range(arr, lo, hi))

    def _send(self, shard: int, code: MessageCode, payload: np.ndarray) -> None:
        """Send toward one shard server, under :meth:`_guarded_send`."""
        self._guarded_send(shard, code,
                           lambda t: send_message(code, payload, transport=t))

    def _sendv(self, shard: int, code: MessageCode, parts) -> None:
        """A frame of several parts toward one shard server, under
        :meth:`_guarded_send`."""
        self._guarded_send(shard, code, lambda t: t.sendv(code, parts))

    def _guarded_send(self, shard: int, code: MessageCode, do_send) -> None:
        """``do_send(transport)`` toward one shard server; its death
        degrades that slice, never the worker. A down shard still gets
        pulls: the pull cadence is the probe, and the reply of a restarted
        server is what :meth:`_mark_up` revives on."""
        if self.shard_down[shard]:
            if code != MessageCode.ParameterRequest:
                return
            try:
                do_send(self.transports[shard])
            except (OSError, ConnectionError):
                pass  # still down; the next pull probes again
            return
        if self.heartbeats and self.heartbeats[shard].peer_down:
            self._mark_down(shard)
            return
        try:
            do_send(self.transports[shard])
        except (OSError, ConnectionError):
            self._mark_down(shard)

    def _send_link(self, link: int, code: MessageCode, payload) -> None:
        self._send(link, code, payload)

    def _link_down(self, link: int) -> bool:
        return self.shard_down[link]

    def _link_name(self, link: int) -> str:
        return f"shard {link}"

    def _mark_down(self, shard: int) -> None:
        if self.shard_down[shard]:
            return
        self.shard_down[shard] = True
        lo, hi = self.ranges[shard]
        print(f"worker: shard {shard} state up->down (params [{lo},{hi})) — that slice "
              "continues with purely-local SGD until the server answers again",
              file=sys.stderr)

    def _mark_up(self, shard: int) -> None:
        """A reply from a down shard is evidence of life: resume its
        push/pull service."""
        self.shard_down[shard] = False
        if self.heartbeats:
            # the sender clears this itself on its next good send; clearing
            # here closes the race where the stale flag re-marks the shard
            self.heartbeats[shard].peer_down = False
        lo, hi = self.ranges[shard]
        print(f"worker: shard {shard} state down->up (params [{lo},{hi})) — push/pull "
              "service resumes", file=sys.stderr)

    def _install_arrived(self) -> None:
        """Copy whichever shard slices have arrived into the model, in
        place (between steps); the other slices keep their values. A slice
        of the wrong size raises: the ranges are fixed at launch, so a
        mismatch is a bug, never traffic to drop."""
        latest = [listener.take_latest() for listener in self.listeners]
        if all(sl is None for sl in latest):
            return
        device = self.accum.device
        flat = ravel_model_params(self.model)
        for s, ((lo, hi), sl) in enumerate(zip(self.ranges, latest)):
            if sl is None:
                continue
            if sl.shape[0] != hi - lo:
                raise ValueError(f"shard reply of {sl.shape[0]} params for a [{lo},{hi}) "
                                 "range — shard/worker ranges disagree")
            if self.shard_down[s]:
                self._mark_up(s)
            flat[lo:hi] = torch.from_numpy(sl).to(device)
            if self._hold_updates:
                self._fresh_installed.add(s)
        unravel_model_params(self.model, flat, unravel=self._unravel)


def run_sharded_ps_process(args) -> int:
    """CLI entry for one process of the sharded world (``--n-servers K``):
    global ranks 0..K-1 are shard servers, K.. are workers. Shard ``s``'s
    star is its own transport world on ``port + s`` (its server is star
    rank 0, worker ``r`` star rank ``r − K + 1``). Shard servers build
    their slice on the host and never touch the card; with ``--wal`` they
    ack a push only after the log's fsync, and ``--ckpt-dir`` lands in
    ``<dir>/shard<s>``. ``--combine`` and ``--server-opt`` reach every shard
    server, ``--compress`` every worker."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

    k = int(args.n_servers)
    n_workers = args.world_size - k
    if args.rank is None:
        raise SystemExit("--rank is required for distributed --mode ps runs")
    if n_workers < 1:
        raise SystemExit(f"--n-servers {k} leaves no workers in --world-size "
                         f"{args.world_size}")
    kind = getattr(args, "transport", "auto")
    reliable = getattr(args, "reliable", False)
    if args.rank >= k:
        return _run_static_worker(args, k, n_workers, kind, reliable)
    shard = args.rank
    model = get_model(getattr(args, "model", "alexnet"), seed=getattr(args, "seed", 0),
                      device="cpu")
    ckpt_dir = getattr(args, "ckpt_dir", "") or None
    # built before it listens, as run_ps_process's server is
    opt_kind, opt_kw = server_opt_from_args(args)
    server = make_shard_server(
        model, shard=shard, n_shards=k, n_workers=n_workers,
        worker_timeout=getattr(args, "worker_timeout", 0.0) or None,
        ckpt_dir=f"{ckpt_dir}/shard{shard}" if ckpt_dir else None,
        ckpt_every=getattr(args, "ckpt_every", 500),
        staleness_damping=getattr(args, "staleness_damping", 0.0),
        # unmasked: --wal without --ckpt-dir raises in ParameterServer
        wal=getattr(args, "wal", False), admission=admission_from_args(args),
        combine=getattr(args, "combine", "add") or "add", server_opt=opt_kind,
        server_opt_kw=opt_kw)
    transport = make_transport(0, n_workers + 1, args.master, int(args.port) + shard,
                               kind=kind, reliable=reliable,
                               durable_acks=getattr(args, "wal", False))
    server.transport = transport
    try:
        if getattr(args, "resume", False) and server.maybe_restore():
            print(f"shard server {shard}: resumed central params")
        server.run()
        print(f"shard server {shard}: done ({server.central.shape[0]} params held)")
    finally:
        transport.close()
    return 0


def _run_static_worker(args, k: int, n_workers: int, kind: str, reliable: bool) -> int:
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import train_worker
    from distributed_ml_pytorch_tpu_torch.utils.compress import compress_from_args
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

    star_rank = args.rank - k + 1
    transports = [make_transport(star_rank, n_workers + 1, args.master, int(args.port) + s,
                                 kind=kind, reliable=reliable)
                  for s in range(k)]
    heartbeats = []
    try:
        if args.heartbeat_interval > 0:
            # one sender per shard star, started before the model is built:
            # each shard's failure detector sees liveness from the start
            from distributed_ml_pytorch_tpu_torch.utils.failure import HeartbeatSender

            for t in transports:
                hb = HeartbeatSender(t, interval=args.heartbeat_interval)
                hb.start()
                heartbeats.append(hb)

        def factory(model, tx):
            return ShardedAsynchronous(model, lr=args.lr, n_push=args.num_push,
                                       n_pull=args.num_pull, tx=tx, transports=transports,
                                       rejoin=getattr(args, "rejoin", False),
                                       heartbeats=heartbeats or None,
                                       **compress_from_args(args))

        _model, logger = train_worker(args, transports[0], device=args.backend,
                                      opt_factory=factory)
        # worker CSVs keep the unsharded node1..N names whatever the number
        # of server ranks before them
        print("wrote", logger.to_csv("node{}.csv".format(star_rank)))
        print("Finished Training")
    finally:
        for hb in heartbeats:
            hb.stop()
        for t in transports:
            t.close()
    return 0
