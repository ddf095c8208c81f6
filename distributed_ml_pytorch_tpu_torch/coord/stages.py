"""Stage placement: the coordinator's side of the MPMD pipeline plane
(counterpart of the JAX ``coord/stages.py``, with ``parallel/mpmd.py``).

A :class:`StagePlacement` is to pipeline stages what ``ShardMap`` is to
parameter-server shards: the one versioned record of which member serves
which stage. Each entry carries the member's rank, its INCARNATION (a
changed incarnation means the endpoint lost its in-flight state), the
stage's flat-parameter range ``[lo, hi)`` and the member's microbatch
watermark (the recovery point its checkpoint promises). It rides the wire
as ``MessageCode.StageAssign``.

:class:`StageCoordinator` adds the stage lifecycle to the base
:class:`~.coordinator.Coordinator`:

- stage members join with kind ``stage`` and announce their stage with
  ``StageReady(stage, watermark)``; the coordinator assigns them into the
  placement, bumps its version and broadcasts it;
- a stage member silent past its lease is VACATED (the pipeline pauses at
  that stage: its neighbours hold their hand-offs); when a replacement
  announces ``StageReady`` the vacancy's length is the stage-restart MTTR;
- the placement is mirrored into the base ``shard_map`` (the stage ranges,
  ``server_id`` = the member's rank), so the snapshot barrier
  (``SnapshotRequest``/``SnapshotDone`` -> ``FleetManifest``) covers the
  stage checkpoints unchanged: a stage fleet's manifest tiles ``[0,
  n_params)`` as a shard fleet's does;
- speculation for stages: a member whose step-latency EWMA passes
  ``straggler_factor`` times the median gets its stage raced by an idle
  standby, which loads the victim's checkpoint and announces
  ``StageReady``; the placement flip is the first-wins dedup and the victim
  goes passive.

:func:`mpmd_scenario` is the acceptance machinery: one in-process fleet (a
``StageCoordinator``, S stage members and a driver, the data plane under
seeded chaos and ``ReliableTransport``) that trains, kills a middle stage
mid-schedule, restarts it from its stage checkpoint, and returns what the
acceptance criteria judge. Every member, the driver and the coordinator
carry a flight recorder (each member's also on its reliable wrapper); the
dumps land in ``<base_dir>/obs`` at each death, restore and stop, for
``analysis/timeline.py`` to merge.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.coordinator import (
    KIND_STAGE,
    Coordinator,
    encode_snapshot_request,
)
from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardEntry, ShardMap
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode, _join16, _split16
from distributed_ml_pytorch_tpu_torch.utils.obs import SpanRecorder, flight_dump


def encode_stage_ready(stage: int, incarnation: int, watermark: int) -> np.ndarray:
    return np.asarray([float(stage), *_split16(incarnation), *_split16(watermark)], np.float32)


@dataclasses.dataclass(frozen=True)
class StageEntry:
    """One stage's assignment: the member serving it (``rank < 0``: vacant),
    that member's incarnation, the stage's flat-parameter range and the
    watermark its checkpoint promises."""

    stage: int
    rank: int = -1
    inc: int = 0
    lo: int = 0
    hi: int = 0
    watermark: int = 0

    @property
    def vacant(self) -> bool:
        return self.rank < 0


@dataclasses.dataclass(frozen=True)
class StagePlacement:
    """An immutable, versioned assignment of pipeline stages to members."""

    version: int
    n_params: int
    entries: Tuple[StageEntry, ...] = ()

    def __init__(self, version: int, n_params: int, entries: Sequence[StageEntry] = ()):
        object.__setattr__(self, "version", int(version))
        object.__setattr__(self, "n_params", int(n_params))
        object.__setattr__(self, "entries", tuple(entries))

    def entry_for_rank(self, rank: int) -> Optional[StageEntry]:
        for e in self.entries:
            if e.rank == int(rank):
                return e
        return None

    @property
    def assigned(self) -> bool:
        return bool(self.entries) and all(not e.vacant for e in self.entries)

    def encode(self) -> np.ndarray:
        head = [*_split16(self.version), float(len(self.entries)), *_split16(self.n_params)]
        body: List[float] = []
        for e in self.entries:
            body += [float(e.stage), float(e.rank), *_split16(e.inc), *_split16(e.lo),
                     *_split16(e.hi), *_split16(e.watermark)]
        return np.asarray(head + body, np.float32)

    @classmethod
    def decode(cls, payload: np.ndarray) -> "StagePlacement":
        if payload.size < 5 or not np.isfinite(payload[:5]).all():
            raise ValueError(f"malformed StagePlacement frame (size {payload.size})")
        version = _join16(payload[0], payload[1])
        k = int(payload[2])
        n_params = _join16(payload[3], payload[4])
        if k < 0 or payload.size < 5 + 10 * k:
            raise ValueError(f"StagePlacement frame declares {k} entries but carries "
                             f"{payload.size} floats")
        entries = []
        for i in range(k):
            f = payload[5 + 10 * i: 5 + 10 * (i + 1)]
            if not np.isfinite(f).all():
                raise ValueError("non-finite StagePlacement entry")
            entries.append(StageEntry(stage=int(f[0]), rank=int(f[1]), inc=_join16(f[2], f[3]),
                                      lo=_join16(f[4], f[5]), hi=_join16(f[6], f[7]),
                                      watermark=_join16(f[8], f[9])))
        entries.sort(key=lambda e: e.stage)
        return cls(version, n_params, entries)


def placement_deltas(old: Optional[StagePlacement], new: StagePlacement, *,
                     inc_only: bool = False) -> List[StageEntry]:
    """The entries of ``new`` whose serving member CHANGED from ``old``: the
    one replay trigger both consumers share (``MpmdStage`` re-ships its
    retained hand-offs to them, ``MpmdDriver`` its retained data).
    ``inc_only`` fires on incarnation changes only: the driver ships
    everything up front and never into a vacancy, so a vacant-to-same-life
    re-admission has nothing of its to replay (and a needless re-ship would
    move the chaos log of its faulted channels); stage members hold
    hand-offs across a vacancy, so they also fire on a change of rank."""
    if old is None:
        return []  # first sight: nothing retained yet
    out = []
    for e in new.entries:
        if e.rank < 0 or e.stage >= len(old.entries):
            continue
        oe = old.entries[e.stage]
        if oe.inc == e.inc and (inc_only or oe.rank == e.rank):
            continue
        out.append(e)
    return out


class StageCoordinator(Coordinator):
    """The coordinator of an MPMD pipeline fleet (see the module
    docstring). ``stage_ranges`` are :func:`~..parallel.mpmd.
    stage_param_ranges`'s; ``straggler_factor`` > 0 arms the stage
    speculation; the other options are the base coordinator's (its worker
    speculation off by default)."""

    def __init__(self, transport, stage_ranges: Sequence[Tuple[int, int]], *,
                 straggler_factor: float = 0.0, straggler_after_steps: int = 3, **kwargs):
        ranges = [(int(lo), int(hi)) for lo, hi in stage_ranges]
        if not ranges:
            raise ValueError("stage_ranges must name at least one stage")
        kwargs.setdefault("speculation", False)
        super().__init__(transport, ranges[-1][1], **kwargs)
        self.stage_ranges = ranges
        self.n_stages = len(ranges)
        self.placement = StagePlacement(0, self.shard_map.n_params, [
            StageEntry(stage=s, lo=lo, hi=hi) for s, (lo, hi) in enumerate(ranges)])
        self.stage_straggler_factor = float(straggler_factor)
        self.stage_straggler_after = int(straggler_after_steps)
        self.stage_speculated: Dict[int, int] = {}  # victim rank -> task id
        self._vacant_since: Dict[int, float] = {}
        self.stage_mttrs = collections.deque(maxlen=256)
        self.stage_restarts = 0

    # ------------------------------------------------------------ placement
    def _set_entry(self, entry: StageEntry, why: str) -> None:
        entries = list(self.placement.entries)
        entries[entry.stage] = entry
        self.placement = StagePlacement(self.placement.version + 1, self.placement.n_params,
                                        entries)
        self._mirror_shard_map()
        if self._snap is not None:
            self._log(f"snapshot {self._snap['id']} aborted: stage placement moved to "
                      f"v{self.placement.version} mid-barrier")
            self._snap = None
        self._log(f"stage placement v{self.placement.version} on {why}: " + ", ".join(
            (f"s{e.stage}=r{e.rank}@{e.watermark}" if not e.vacant else f"s{e.stage}=VACANT")
            for e in self.placement.entries))
        self._announce()

    def _mirror_shard_map(self) -> None:
        """The placement IS the stage fleet's shard map: the stage ranges by
        member rank, so the snapshot barrier and the ``FleetManifest`` cover
        the stage checkpoints unchanged."""
        self.shard_map = ShardMap(self.placement.version, self.placement.n_params,
                                  [ShardEntry(e.rank, e.lo, e.hi)
                                   for e in self.placement.entries if not e.vacant])

    def _announce(self) -> None:
        super()._announce()
        if self.placement.version > 0:
            self._broadcast(MessageCode.StageAssign, self.placement.encode())

    # --------------------------------------------------------------- handle
    def handle(self, sender: int, code: MessageCode, payload) -> None:
        if code == MessageCode.StageReady and payload.size >= 5:
            if not np.isfinite(payload[:5]).all():
                return
            member = self.members.get(sender)
            if member is None or member.kind != KIND_STAGE:
                return  # before its join: the member's retry heals it
            member.last_seen = self._clock()
            self._on_stage_ready(sender, member, stage=int(payload[0]),
                                 inc=_join16(payload[1], payload[2]),
                                 watermark=_join16(payload[3], payload[4]))
            return
        super().handle(sender, code, payload)
        if (code == MessageCode.CoordJoin and sender in self.members
                and self.placement.version > 0):
            # a joiner (or an idempotent re-join) gets the placement at once:
            # the broadcast only covers membership events
            self._send(sender, MessageCode.StageAssign, self.placement.encode())

    def _on_stage_ready(self, sender: int, member, *, stage: int, inc: int,
                        watermark: int) -> None:
        if not (0 <= stage < self.n_stages):
            self._log(f"ignored StageReady for unknown stage {stage} from rank {sender}")
            return
        if inc < member.incarnation:
            self._log(f"ignored stale StageReady from rank {sender} "
                      f"(inc {inc} < {member.incarnation})")
            return
        cur = self.placement.entries[stage]
        if cur.rank == sender and cur.inc == member.incarnation:
            # an idempotent re-announce of the SAME life: answer it alone, no
            # bump; the entry keeps the life's FIRST watermark (its recovery
            # point, the replay boundary), not its advancing progress
            self._send(sender, MessageCode.StageAssign, self.placement.encode())
            return
        lo, hi = self.stage_ranges[stage]
        takeover = not cur.vacant and cur.rank != sender
        same_life = cur.vacant and cur.inc == member.incarnation
        vacated_at = self._vacant_since.pop(stage, None)
        if same_life:
            # a lease that lapsed for a moment, the life never died: nothing
            # was lost, no replay, no restart; re-admit at the ORIGINAL
            # recovery point
            self._set_entry(StageEntry(stage=stage, rank=sender, inc=member.incarnation,
                                       lo=lo, hi=hi, watermark=cur.watermark),
                            f"re-admission of rank {sender} after transient lease expiry "
                            "(same life)")
            return
        entry = StageEntry(stage=stage, rank=sender, inc=member.incarnation, lo=lo, hi=hi,
                           watermark=watermark)
        why = (f"StageReady from rank {sender} (watermark {watermark})"
               + (" — TAKEOVER" if takeover else ""))
        if vacated_at is not None:
            mttr = self._clock() - vacated_at
            self.stage_mttrs.append(mttr)
            self.stage_restarts += 1
            self._log(f"stage {stage} restored by rank {sender} after {mttr * 1e3:.0f} ms "
                      f"vacancy (watermark {watermark}: neighbors replay in-flight "
                      "microbatches past it)")
            # the stage's MTTR ships with its timeline
            self._flight_dump(f"stage{stage}-restored")
        self._set_entry(entry, why)

    # ----------------------------------------------------------------- tick
    def tick(self) -> bool:
        changed = super().tick()
        self._sync_placement()
        if self.stage_straggler_factor > 0:
            self.check_stage_stragglers()
        return changed

    def _sync_placement(self) -> None:
        """Vacate the entries whose member is gone (lease expiry or leave):
        the stage-death detection."""
        live = {m.rank for m in self._live(KIND_STAGE)}
        now = self._clock()
        for e in self.placement.entries:
            if e.vacant or e.rank in live:
                continue
            self._vacant_since.setdefault(e.stage, now)
            self.stage_speculated.pop(e.rank, None)
            # the incarnation and watermark outlive the vacancy: the next
            # StageReady tells a same-life re-admission from a replacement
            self._set_entry(StageEntry(stage=e.stage, inc=e.inc, lo=e.lo, hi=e.hi,
                                       watermark=e.watermark),
                            f"death of stage {e.stage} member rank {e.rank}")

    # ------------------------------------------------------ snapshot barrier
    def _start_snapshot(self, now: float) -> None:
        """A stage fleet snapshots as a shard fleet does, but only a FULLY
        assigned placement makes a manifest that tiles."""
        if self._snap is not None:
            self._log(f"snapshot request ignored: snapshot {self._snap['id']} still in flight")
            return
        if not self.placement.assigned:
            self._log("snapshot request ignored: stage placement has vacancies")
            return
        assigned = {e.rank for e in self.placement.entries}
        members = [m for m in self._live(KIND_STAGE) if m.rank in assigned]
        if len(members) < self.n_stages:
            self._log("snapshot request ignored: assigned stage members not all live")
            return
        self._snap_seq += 1
        self._snap = {"id": self._snap_seq, "map_version": self.shard_map.version,
                      "expected": {m.rank for m in members}, "got": {}, "started": now}
        self._log(f"snapshot {self._snap_seq} started: placement v{self.shard_map.version}, "
                  f"awaiting {sorted(self._snap['expected'])}")
        frame = encode_snapshot_request(self._snap_seq, self.shard_map.version)
        for m in members:
            self._send(m.rank, MessageCode.SnapshotRequest, frame)

    # ---------------------------------------------------------- speculation
    def check_stage_stragglers(self) -> Optional[int]:
        """When an assigned stage member's step-latency EWMA passes
        ``straggler_factor`` times the median, point an idle standby at it
        (``SpeculateTask``); the task id when one fired."""
        assigned = {e.rank: e for e in self.placement.entries if not e.vacant}
        members = [m for m in self._live(KIND_STAGE)
                   if m.rank in assigned and m.ewma_ms > 0
                   and m.step >= self.stage_straggler_after
                   and m.rank not in self.stage_speculated]
        if len(members) < 2:
            return None
        standbys = [m for m in self._live(KIND_STAGE) if m.rank not in assigned]
        if not standbys:
            return None
        by_speed = sorted(members, key=lambda m: m.ewma_ms)
        victim = by_speed[-1]
        median = by_speed[(len(by_speed) - 1) // 2].ewma_ms
        if median <= 0 or victim.ewma_ms < self.stage_straggler_factor * median:
            return None
        backup = standbys[0]
        task_id = self._next_task
        self._next_task += 1
        self.stage_speculated[victim.rank] = task_id
        e = assigned[victim.rank]
        self._log(f"stage straggler: stage {e.stage} member rank {victim.rank} at "
                  f"{victim.ewma_ms:.1f} ms/step (median {median:.1f}) — standby rank "
                  f"{backup.rank} races it as task {task_id}")
        frame = np.asarray([float(task_id), float(victim.rank), float(victim.step)],
                           np.float32)
        self._send(backup.rank, MessageCode.SpeculateTask, frame)
        self._send(victim.rank, MessageCode.SpeculateTask, frame)
        return task_id


# -------------------------------------------------------------------- scenario

def _wait_for(predicate, timeout: float, what: str, poll: float = 0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(poll)
    raise TimeoutError(f"mpmd: timed out after {timeout:.0f}s waiting for {what}")


def _load_factor(nominal: float = 0.002, rounds: int = 5) -> float:
    """How much longer than asked a short sleep takes on this host right now
    (about 1 when quiet, several times on a loaded host, at most 5). The
    scenario's barrier timeouts scale by it: a loaded run gets more wall
    clock, and the timeout stays a bound."""
    worst = 1.0
    for _ in range(rounds):
        t0 = time.monotonic()
        time.sleep(nominal)
        worst = max(worst, (time.monotonic() - t0) / nominal)
    return min(worst, 5.0)


def default_mpmd_plan(seed: int = 0, *, weather: bool = True):
    """Seeded drop and duplication, and network weather, on the DRIVER'S
    channels (tokens to stage 0, targets to the last stage, the reliable
    envelope's code).

    The driver ships every step's data up front, so these channels' send
    sequences are functions of the data; with the scenario's retransmit
    floor far above the in-process round trip, retransmissions follow the
    seeded losses, not the clock, and the chaos log is the same run after
    run. The channels of the killed stage carry no fault: their retries
    during the outage follow the wall clock."""
    from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosPlan, FaultRule, WeatherRule

    rules = [FaultRule(src=0, code=int(MessageCode.ReliableFrame), drop=0.05, dup=0.05)]
    weather_rules = ()
    if weather:
        weather_rules = (WeatherRule(src=0, code=int(MessageCode.ReliableFrame),
                                     latency=0.005, jitter=0.002),)
    return ChaosPlan(rules, seed=seed, weather=weather_rules)


def scenario_cfg(n_stages: int = 4, seq: int = 8):
    """The scenario's default model: the JAX scenario's widths (head_dim 8,
    which the float32 attention kernels take), one layer a stage."""
    from distributed_ml_pytorch_tpu_torch.parallel.pipeline import PipelineLMConfig

    return PipelineLMConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=n_stages, d_ff=32,
                            max_len=max(64, seq))


def scenario_data(seed: int, steps: int, n_microbatches: int, mb: int, seq: int, vocab: int):
    """The scenario's microbatches: ``(tokens_steps, targets_steps)``, each a
    list of ``(M, mb, seq)`` int32 arrays, the same for every run of one
    seed."""
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import next_token_targets

    M = int(n_microbatches)
    rng = np.random.default_rng(seed)
    tokens_steps, targets_steps = [], []
    for _t in range(steps):
        toks = rng.integers(0, vocab, size=(M * mb, seq)).astype(np.int32)
        tokens_steps.append(toks.reshape(M, mb, seq))
        targets_steps.append(next_token_targets(toks).reshape(M, mb, seq))
    return tokens_steps, targets_steps


def mpmd_scenario(*, base_dir: str, seed: int = 0, steps: int = 8, n_stages: int = 4,
                  n_microbatches: int = 4, mb: int = 4, seq: int = 8, lr: float = 0.1,
                  lease: float = 0.5, kill_stage: Optional[int] = None,
                  kill_at_step: Optional[int] = None, snapshot_at_step: Optional[int] = None,
                  restore_via_manifest: bool = False, plan=None,
                  throttle_stage: Optional[int] = None, throttle: float = 0.0,
                  standby: bool = False, straggler_factor: float = 0.0, cfg=None,
                  timeout: float = 240.0, act_codec: str = "dense", params=None,
                  device="cuda") -> Dict:
    """Run one MPMD pipeline fleet (see the module docstring).

    Ranks: stage ``i`` is rank ``1 + i`` in BOTH the coordination star and
    the data world; a standby member is rank ``n_stages + 1`` in both (a
    member the placement routes to holds one rank in both worlds); the
    driver is data rank 0 (the hub the chaos plan's ``src=0`` rules match)
    and takes the next free coordination rank. ``kill_stage`` and
    ``kill_at_step`` crash that member SILENTLY from its own step hook the
    moment it finishes that update (its checkpoint watermark is then
    exactly ``kill_at_step * M``); the main thread restarts it from its
    stage checkpoint (through the ``FleetManifest`` with
    ``restore_via_manifest``) once the coordinator has vacated the stage.
    ``params`` is the whole model's initial ``state_dict`` (drawn from
    ``seed`` when None); every member's tensors live on ``device``. The
    flight recorders' dumps go to ``<base_dir>/obs`` (``obs_dir`` in the
    result); they only observe, so the chaos log is the same with them."""
    import os

    from distributed_ml_pytorch_tpu_torch.coord.manifest import MANIFEST_NAME, FleetManifest
    from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
    from distributed_ml_pytorch_tpu_torch.parallel.mpmd import (
        MpmdDriver,
        MpmdStage,
        stage_param_ranges,
        stage_param_tree,
    )
    from distributed_ml_pytorch_tpu_torch.parallel.pipeline import init_pp_params
    from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosLog, FaultyTransport
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        InProcessTransport,
        ReliableTransport,
    )

    S, M = int(n_stages), int(n_microbatches)
    if cfg is None:
        cfg = scenario_cfg(S, seq)
    ranges = stage_param_ranges(cfg, S)
    full = params if params is not None else init_pp_params(cfg, seed)
    n_extra = 1 if standby else 0
    standby_rank = S + 1  # data AND coordination rank
    driver_coord_rank = S + 1 + n_extra

    tokens_steps, targets_steps = scenario_data(seed, steps, M, mb, seq, cfg.vocab_size)

    # the worlds: a plain coordination star and the chaos-wrapped data plane
    coord_world = InProcessTransport.create_world(2 + S + n_extra)
    data_world = InProcessTransport.create_world(1 + S + n_extra)
    log = None
    if plan is not None:
        log = ChaosLog()
        data_world, _ = FaultyTransport.wrap_world(data_world, plan, log=log)

    #: a retransmit floor far above the in-process round trip and the
    #: weather, and above a stage's slowest compute, so retransmits follow
    #: the seeded losses (the same chaos log run after run); breaker_grace
    #: keeps a long stall from reading as a dead peer
    rel_opts = dict(ack_timeout=4.0, max_backoff=8.0, max_retries=120, send_window=32,
                    breaker_grace=60.0)

    def rel(rank: int) -> ReliableTransport:
        return ReliableTransport(data_world[rank], **rel_opts)

    obs_dir = os.path.join(base_dir, "obs")

    def make_recorder(member: str, transport) -> SpanRecorder:
        rec = SpanRecorder(member, "mpmd")
        if hasattr(transport, "recorder"):
            transport.recorder = rec  # the wire's blocked spans and retransmits
        return rec

    coord = StageCoordinator(coord_world[0], ranges, lease=lease, manifest_dir=base_dir,
                             straggler_factor=straggler_factor)
    coord.recorder = SpanRecorder("coord", "coord")
    coord.obs_dir = obs_dir
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": timeout + 60},
                                    daemon=True)
    coord_thread.start()

    crash_evt = threading.Event()
    retired: List[MpmdStage] = []
    errors: List[tuple] = []
    timings: Dict[str, float] = {}
    manifest_path = os.path.join(base_dir, MANIFEST_NAME)

    def make_stage(i: int, transport) -> MpmdStage:
        client = CoordClient(coord_world[1 + i], "stage", renew_interval=lease / 4)

        def hook(srv: MpmdStage, new_step: int) -> None:
            if (kill_stage == i and kill_at_step is not None and new_step == kill_at_step
                    and not crash_evt.is_set()):
                timings["killed"] = time.monotonic()
                srv.crash()
                if hasattr(data_world[1 + i], "crash"):
                    data_world[1 + i].crash()
                crash_evt.set()

        return MpmdStage(i, cfg, S, M, transport, client, mb_size=mb, seq_len=seq, lr=lr,
                         seed=seed, ckpt_dir=os.path.join(base_dir, f"stage{i}"),
                         throttle=(throttle if throttle_stage == i else 0.0), step_hook=hook,
                         recorder=make_recorder(f"stage{i}", transport), obs_dir=obs_dir,
                         act_codec=act_codec, params=stage_param_tree(cfg, full, i, S),
                         device=device)

    stages: List[MpmdStage] = []
    stage_threads: List[threading.Thread] = []
    for i in range(S):
        srv = make_stage(i, rel(1 + i))
        stages.append(srv)
        t = threading.Thread(target=srv.run, kwargs={"timeout": timeout + 60}, daemon=True)
        t.start()
        stage_threads.append(t)

    standby_member = None
    if standby:
        client = CoordClient(coord_world[standby_rank], "stage", renew_interval=lease / 4)
        standby_transport = rel(standby_rank)
        standby_member = MpmdStage(None, cfg, S, M, standby_transport, client, mb_size=mb,
                                   seq_len=seq, lr=lr, seed=seed, ckpt_root=base_dir,
                                   recorder=make_recorder("standby", standby_transport),
                                   obs_dir=obs_dir, act_codec=act_codec, device=device)
        t = threading.Thread(target=standby_member.run, kwargs={"timeout": timeout + 60},
                             daemon=True)
        t.start()
        stage_threads.append(t)

    # the restart watcher: once the coordinator vacates the killed stage,
    # stand its replacement up from the stage checkpoint
    def restart_victim() -> None:
        try:
            crash_evt.wait(timeout)
            if kill_stage is None or not crash_evt.is_set():
                return
            _wait_for(lambda: coord.placement.entries[kill_stage].vacant, timeout,
                      f"the coordinator to vacate stage {kill_stage}")
            timings["vacated"] = time.monotonic()
            old = stages[kill_stage]
            retired.append(old)
            detach = getattr(old.transport, "detach", None)
            if detach is not None:
                detach()
            if hasattr(data_world[1 + kill_stage], "restart"):
                data_world[1 + kill_stage].restart()
            srv = make_stage(kill_stage, rel(1 + kill_stage))
            manifest = FleetManifest.load(manifest_path) if restore_via_manifest else None
            srv.restore(manifest=manifest)
            stages[kill_stage] = srv
            timings["restored"] = time.monotonic()
            t = threading.Thread(target=srv.run, kwargs={"timeout": timeout + 60},
                                 daemon=True)
            t.start()
            stage_threads.append(t)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append(("restart", repr(e)))
            crash_evt.set()

    restarter = None
    if kill_stage is not None:
        restarter = threading.Thread(target=restart_victim, daemon=True)
        restarter.start()

    driver_client = CoordClient(coord_world[driver_coord_rank], "worker",
                                renew_interval=lease / 4)
    driver_transport = rel(0)
    driver = MpmdDriver(driver_transport, driver_client, S, M,
                        recorder=make_recorder("driver", driver_transport), obs_dir=obs_dir)
    barrier_timeout = 60 * _load_factor()

    def driver_hook(t: int, _loss: float) -> None:
        if snapshot_at_step is not None and t == snapshot_at_step:
            coord.trigger_snapshot()

            def manifest_published() -> bool:
                if coord.manifests_written > 0 and os.path.exists(manifest_path):
                    return True
                # a trigger the barrier could not take (a transient vacancy
                # on a loaded host) is consumed: re-arm it; one in flight
                # ignores the repeat, and the barrier's frames never cross
                # the faulted channels
                coord.trigger_snapshot()
                return False

            _wait_for(manifest_published, barrier_timeout,
                      "the stage snapshot barrier to publish a manifest")

    losses: List[float] = []
    try:
        losses = driver.run(tokens_steps, targets_steps, timeout=timeout,
                            step_hook=driver_hook)

        # the driver has every loss once the last stage is done, but the
        # earlier stages' backwards of the last step may still drain: the
        # accounting below judges a finished schedule
        def drained() -> bool:
            active = [s for s in stages if not s._superseded]
            if standby_member is not None and standby_member.stage is not None:
                active.append(standby_member)
            return all(s.step >= steps for s in active)

        _wait_for(drained, barrier_timeout, "all stages to drain their final backwards")
    except TimeoutError as e:
        errors.append(("driver", repr(e)))
    finally:
        driver_client.close()

    for srv in stages:
        srv.stop()
    if standby_member is not None:
        standby_member.stop()
    coord.stop()
    coord_thread.join(timeout=30)
    if restarter is not None:
        crash_evt.set()
        restarter.join(timeout=10)
    for t in stage_threads:
        t.join(timeout=10)

    standbys = [standby_member] if standby_member is not None else []
    for srv in stages + retired + standbys:
        if srv.error is not None:
            errors.append((f"stage{srv.stage}", srv.error))

    # the accounting: every (step, mb) applied exactly once per stage in the
    # OWNER LINEAGE: earlier lives count below the final owner's watermark,
    # the owner at or above it. A speculation loser's applications past the
    # takeover watermark are DISCARDED work (first wins: its sends were
    # suppressed, its parameters abandoned), counted apart
    applied_ok = True
    discarded_applies = 0
    applied: Dict[int, Dict[Tuple[int, int], int]] = {}
    all_members = list(stages) + retired + standbys
    expected = {(t, mbi) for t in range(steps) for mbi in range(M)}
    for i in range(S):
        cutoff = coord.placement.entries[i].watermark
        if (standby_member is not None and standby_member.stage == i
                and not standby_member._superseded):
            owner = standby_member
        elif not stages[i]._superseded:
            owner = stages[i]
        else:
            owner = None
        counts: collections.Counter = collections.Counter()
        for srv in all_members:
            if srv.stage != i:
                continue
            for key in srv.applied_log:
                if (key[0] * M + key[1] >= cutoff) == (srv is owner):
                    counts[key] += 1
                else:
                    discarded_applies += 1
        applied[i] = dict(counts)
        if set(counts) != expected or any(v != 1 for v in counts.values()):
            applied_ok = False

    stats = {f"stage{i}": dict(stages[i].stats) for i in range(S)}
    for k, srv in enumerate(retired):
        stats[f"retired{k}"] = dict(srv.stats)
    if standby_member is not None:
        stats["standby"] = dict(standby_member.stats)
    busy_s = sum(s.get("busy_s", 0.0) for s in stats.values())
    wall_s = (driver.step_times[-1] - driver.step_times[0]
              if len(driver.step_times) >= 2 else None)

    # close the reliable wrappers (their retry threads), then the worlds
    wrappers = [driver.transport] + [srv.transport for srv in stages + retired + standbys]
    for t in wrappers + list(data_world.values()) + list(coord_world.values()):
        close = getattr(t, "close", None)
        if close is not None:
            close()
    # the coordinator's decision timeline joins the members' dumps
    flight_dump(coord.recorder, obs_dir, "stop")

    mttr = coord.stage_mttrs[0] if coord.stage_mttrs else None
    return {
        "ok": not errors and len(losses) == steps and applied_ok,
        "obs_dir": obs_dir,
        "errors": errors,
        "losses": losses,
        "step_times": list(driver.step_times),
        "applied_ok": applied_ok,
        "applied": applied,
        "discarded_applies": discarded_applies,
        "stats": stats,
        "driver_stats": dict(driver.stats),
        "events": list(coord.events),
        "placement_version": coord.placement.version,
        "placement": coord.placement,
        "stage_mttr_s": mttr,
        "stage_restarts": coord.stage_restarts,
        #: the outage's wall clock: killed -> vacated (lease expiry) ->
        #: restored (the replacement serving)
        "timings": dict(timings),
        "chaos_lines": log.lines() if log is not None else "",
        "chaos_counts": log.counts() if log is not None else {},
        "busy_s": busy_s,
        "wall_s": wall_s,
        "stages": stages,
        "retired": retired,
        "standby": standby_member,
        "coordinator": coord,
    }


def mpmd_demo(seed: int = 0, base_dir: Optional[str] = None, device="cuda") -> Dict:
    """One pass of the MPMD acceptance script (``coord/cli.py --mpmd``): 4
    stages under drop, duplication and weather, the middle stage killed
    mid-schedule and restarted from its checkpoint. Its files stay only
    under a ``base_dir`` the caller gives (``state_dir``)."""
    import contextlib
    import tempfile

    with contextlib.ExitStack() as stack:
        base = base_dir or stack.enter_context(tempfile.TemporaryDirectory(prefix="mpmd_"))
        out = mpmd_scenario(base_dir=base, seed=seed, steps=8, kill_stage=1, kill_at_step=3,
                            snapshot_at_step=1, plan=default_mpmd_plan(seed), device=device)
    return {
        "ok": out["ok"] and out["stage_restarts"] >= 1,
        "losses": [round(float(x), 4) for x in out["losses"]],
        "stage_mttr_ms": (None if out["stage_mttr_s"] is None
                          else round(out["stage_mttr_s"] * 1e3, 1)),
        "applied_ok": out["applied_ok"],
        "chaos": out["chaos_counts"],
        "events": out["events"],
        "state_dir": base_dir,
    }
