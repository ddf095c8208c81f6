"""The port's flight recorder, metrics registry and verbose report against
the JAX package's (``tests/test_obs.py`` is the list mirrored).

- ``SpanRecorder``: the ring keeps the newest spans and counts what it
  dropped; a disabled one records nothing; a span survives a raise; the
  JSONL and Chrome-trace exports are the JAX ones field for field (the
  thread id aside); ``flight_dump`` names its files as JAX does.
- Correlation ids: thread-local, ``corr_scope`` nests, a recorder adopts
  the thread's id; the id rides the reliable envelope.
- ``StateClock``: exclusive states whose seconds sum to the wall clock.
- The port's dumps, read by the JAX ``analysis.timeline.analyze`` and by the
  port's, give equal reports.
- ``Registry``, ``Counter``, ``Gauge`` and the EWMA as the JAX ones are, bit
  for bit; ``make_transport`` attaches the wire's counters; the training,
  serving and coordinator CLIs' ``--metrics-dump``.
- The coordinator promotes its log to its recorder and dumps it at a
  rollback; the reliable wrapper's ``wire-stats`` at close; a recorder never
  moves a byte of a chaos log.
- ``print_classification_report``: numpy alone, the JAX (scikit-learn)
  text on the same predictions.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.analysis import timeline as jtimeline
from distributed_ml_pytorch_tpu.utils import metrics as jmetrics
from distributed_ml_pytorch_tpu.utils import obs as jobs
from distributed_ml_pytorch_tpu_torch.analysis import timeline
from distributed_ml_pytorch_tpu_torch.utils import metrics
from distributed_ml_pytorch_tpu_torch.utils import obs

PKGS = {"port": obs, "jax": jobs}


# ------------------------------------------------------------ SpanRecorder

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_recorder_ring_bounds_and_drop_accounting(pkg):
    rec = PKGS[pkg].SpanRecorder("m", "mpmd", capacity=8)
    for i in range(20):
        rec.event(f"e{i}")
    assert (rec.total, len(rec.snapshot()), rec.dropped) == (20, 8, 12)
    # the ring keeps the newest window, the one that explains a crash
    assert [s["name"] for s in rec.snapshot()] == [f"e{i}" for i in range(12, 20)]
    assert rec.header()["dropped"] == 12
    rec.clear()
    assert rec.total == 0 and rec.snapshot() == []


def test_disabled_recorder_records_nothing():
    rec = obs.SpanRecorder("m", "mpmd", enabled=False)
    rec.event("e")
    with rec.span("s"):
        pass
    assert rec.total == 0 and rec.snapshot() == []


def test_span_context_times_and_survives_raise():
    rec = obs.SpanRecorder("m", "mpmd")
    with pytest.raises(RuntimeError):
        with rec.span("boom", state="compute"):
            raise RuntimeError("x")
    (s,) = rec.snapshot()
    assert s["name"] == "boom" and s["state"] == "compute" and s["t1_ns"] >= s["t0_ns"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_corr_thread_local_and_scope_nesting(pkg):
    o = PKGS[pkg]
    o.set_corr(0)
    with o.corr_scope(111):
        assert o.current_corr() == 111
        with o.corr_scope(222):
            assert o.current_corr() == 222
        assert o.current_corr() == 111
    assert o.current_corr() == 0
    seen = {}
    with o.corr_scope(333):
        t = threading.Thread(target=lambda: seen.update(corr=o.current_corr()))
        t.start()
        t.join()
    assert seen["corr"] == 0
    with o.corr_scope() as fresh:
        assert fresh != 0 and o.current_corr() == fresh


def test_recorder_adopts_thread_corr_and_explicit_overrides():
    rec = obs.SpanRecorder("m", "mpmd")
    with obs.corr_scope(42):
        rec.event("implicit")
        rec.event("explicit", corr=7)
    assert [r["corr"] for r in rec.snapshot()] == [42, 7]


def _record_script(o, rec):
    """The same spans and events, at fixed times, on either package."""
    rec.record("fwd", "compute", 1_000, 5_000, corr=5, meta={"mb": 1})
    rec.record("idle", "idle", 5_000, 9_000, corr=0)
    rec.record("mark", "event", 9_000, 9_000, corr=5, meta={"step": 3})
    rec.record("blocked", "wire-blocked", 9_000, 12_500, corr=None)


def test_exports_match_jax_field_for_field(tmp_path):
    out = {}
    for pkg, o in PKGS.items():
        rec = o.SpanRecorder("stage1", "mpmd", capacity=16, run="r1")
        with o.corr_scope(9):
            _record_script(o, rec)
        lines = open(rec.dump_jsonl(str(tmp_path / pkg / "d.jsonl"))).read().splitlines()
        trace = json.load(open(rec.chrome_trace(str(tmp_path / pkg / "t.json"))))
        spans = [json.loads(x) for x in lines]
        for s in spans[1:]:
            s.pop("tid")
        for e in trace["traceEvents"]:
            e.pop("tid")
        out[pkg] = (spans, trace)
    assert out["port"] == out["jax"]
    spans, trace = out["port"]
    assert spans[0] == {"kind": "meta", "member": "stage1", "plane": "mpmd", "capacity": 16,
                        "total": 4, "dropped": 0, "run": "r1"}
    assert spans[4]["corr"] == 9  # adopted from the scope
    assert {e["name"]: e["ph"] for e in trace["traceEvents"]} == {
        "fwd": "X", "idle": "X", "mark": "i", "blocked": "X"}


def test_flight_dump_names_and_writes_as_jax(tmp_path):
    names = {}
    for pkg, o in PKGS.items():
        rec = o.SpanRecorder("stage/1 bad", "mpmd")
        rec.event("e")
        (path,) = o.flight_dump([rec, None], str(tmp_path / pkg), "why: because!")
        names[pkg] = os.path.basename(path)
        assert json.loads(open(path).readline())["reason"] == "why: because!"
        assert o.flight_dump(None, str(tmp_path / pkg), "x") == []
    assert names["port"] == names["jax"] == "flight_stage-1-bad_why--because-.jsonl"


# -------------------------------------------------------------- StateClock

def test_state_clock_attribution_sums_to_wall():
    rec = obs.SpanRecorder("m", "mpmd")
    clk = obs.StateClock(rec, "idle", min_span_us=0)
    clk.set("compute")
    time.sleep(0.02)
    clk.set("wait-act")
    time.sleep(0.01)
    seconds = clk.flush()
    assert set(seconds) <= {"idle", "compute", "wait-act"} and seconds["compute"] >= 0.015
    (attr,) = [e for e in rec.snapshot() if e["name"] == "attribution"]
    # exclusive states: their seconds are the whole wall clock
    assert sum(seconds.values()) == pytest.approx(attr["meta"]["wall_s"], abs=1e-3)
    assert clk.state == "wait-act"


def test_state_clock_carve_moves_seconds():
    clk = obs.StateClock(None, "compute", min_span_us=0)
    time.sleep(0.01)
    clk.carve("wire-blocked", 0.004)
    clk.carve("wire-blocked", 0.0)
    seconds = clk.flush()
    assert seconds["wire-blocked"] == pytest.approx(0.004)
    assert seconds["compute"] >= 0.005 and sum(seconds.values()) < 0.2


# ------------------------------------------------- dumps, both analyzers

def _fleet_dumps(obs_dir):
    """Three members' dumps from the port: two stages through their state
    clocks (one dumped at its death), a driver with correlation journeys
    and the wire's counters."""
    driver = obs.SpanRecorder("driver", "mpmd")
    stages = [obs.SpanRecorder(f"stage{i}", "mpmd") for i in range(2)]
    corrs = [obs.next_corr() for _ in range(3)]
    clocks = [obs.StateClock(r, "idle", min_span_us=0) for r in stages]
    for c in corrs:
        with obs.corr_scope(c):
            driver.event("ship")
        for clk, rec in zip(clocks, stages):
            clk.set("compute", corr=c)
            time.sleep(0.002)
            with rec.span("fwd", state="compute", corr=c):
                pass
            clk.set("wait-act")
            time.sleep(0.001)
            clk.carve("wire-blocked", 0.0005)
    clocks[0].flush()
    driver.event("wire-stats", corr=0, sent=40, retries=2, acked=38, acks_tx=3,
                 cum_acks_tx=9, window_blocked_s=0.125, window_blocked=2)
    obs.flight_dump(stages[0], obs_dir, "stop")
    obs.flight_dump(stages[1], obs_dir, "death")
    obs.flight_dump(driver, obs_dir, "stop")
    return corrs


def test_port_dumps_give_equal_reports_in_both_analyzers(tmp_path):
    obs_dir = str(tmp_path / "obs")
    _fleet_dumps(obs_dir)
    with open(os.path.join(obs_dir, "flight_stage1_death.jsonl"), "a") as fh:
        fh.write('{"name": "torn", "t0_ns": 1\n')  # a tail torn by the crash
    mine, ref = timeline.analyze(obs_dir), jtimeline.analyze(obs_dir)
    assert mine == ref
    assert timeline.render(mine) == jtimeline.render(ref)
    assert mine["n_dumps"] == 3 and mine["torn_lines"] == 1
    b = mine["bubble_attribution"]
    assert b["stages"] == 2 and abs(sum(b["fractions"].values()) - 1.0) < 0.02
    assert mine["wire_attribution"]["retransmit_share"] == pytest.approx(0.05)
    assert mine["journeys"]["cross_member_units"] == 3


# ---------------------------------------------------------------- Registry

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_registry_owned_metrics_attach_and_failure_isolation(pkg, tmp_path):
    m = metrics if pkg == "port" else jmetrics
    r = m.Registry("t")
    r.counter("pushes").inc(3)
    r.gauge("occupancy").set(0.5)
    r.ewma("lat_ms").update(10.0)
    with pytest.raises(ValueError):
        r.gauge("pushes")
    with pytest.raises(ValueError, match="alpha"):
        r.ewma("lat_ms", alpha=0.25)
    r.attach("wire", lambda: {"sent": 7, "acked": 6})
    r.attach("bad", lambda: 1 / 0)
    text = r.dump_json(str(tmp_path / pkg / "m.json"))
    snap = json.loads(text)
    assert json.loads((tmp_path / pkg / "m.json").read_text()) == snap
    assert (snap["pushes"], snap["occupancy"], snap["lat_ms"]) == (3, 0.5, 10.0)
    assert snap["wire.sent"] == 7 and "division" in snap["bad.error"]
    r.detach("bad")
    assert "bad.error" not in r.snapshot()


def test_registry_snapshots_equal_jax():
    snaps = []
    for m in (metrics, jmetrics):
        r = m.Registry("t")
        c, g, e = r.counter("n"), r.gauge("g"), r.ewma("e", alpha=0.5)
        assert c.inc() == 1 and c.inc(4) == 5 and g.set(2.5) == 2.5
        for x in (2.0, 4.0, 1.0):
            e.update(x)
        r.attach("p", lambda: {"b": 2, "a": 1})
        snaps.append(r.dump_json())
    assert snaps[0] == snaps[1]
    assert metrics.get_registry() is metrics.get_registry()


def test_ewma_bit_identical_to_hand_rolled_idiom():
    """The registry's EWMA reproduces ``x if e == 0.0 else 0.7*e + 0.3*x``
    and the JAX one exactly."""
    xs = np.random.default_rng(0).uniform(0.1, 50.0, size=200)
    hand = 0.0
    mine, ref = metrics.Registry().ewma("x"), jmetrics.Ewma()
    for x in map(float, xs):
        hand = x if hand == 0.0 else 0.7 * hand + 0.3 * x
        assert mine.update(x) == hand == ref.update(x)


def test_make_transport_attaches_the_wires_counters():
    from distributed_ml_pytorch_tpu_torch.launch import _free_port
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        MessageCode,
        ReliableTransport,
        make_transport,
    )

    port = int(_free_port())
    server = make_transport(0, 2, "localhost", port, kind="python", reliable=True)
    worker = make_transport(1, 2, "localhost", port, kind="python", reliable=True)
    try:
        assert isinstance(worker, ReliableTransport)
        worker.send(MessageCode.GradientUpdate, np.ones(4, np.float32))
        assert server.recv(timeout=5) is not None and worker.flush(timeout=5)
        snap = metrics.get_registry().snapshot()
        assert snap["wire.rank1.sent"] == 1 and snap["wire.rank0.delivered"] == 1
    finally:
        worker.close()
        server.close()


# -------------------------------------------------------- the CLIs' dumps

def test_training_cli_metrics_dump(tmp_path):
    from distributed_ml_pytorch_tpu_torch.training import cli

    path = tmp_path / "m" / "metrics.json"
    metrics.get_registry().attach("probe", lambda: {"x": 1})
    try:
        assert cli.main(["--no-distributed", "--backend", "cpu", "--model", "lenet",
                         "--synthetic-data", "--synthetic-train-size", "32",
                         "--synthetic-test-size", "16", "--batch-size", "8", "--epochs", "1",
                         "--log-dir", str(tmp_path), "--metrics-dump", str(path)]) == 0
    finally:
        metrics.get_registry().detach("probe")
    assert json.loads(path.read_text())["probe.x"] == 1


def test_serving_cli_metrics_dump_holds_the_engines_slo_summary(tmp_path, capsys):
    from distributed_ml_pytorch_tpu_torch.serving import cli

    path = tmp_path / "serve.json"
    assert cli.main(["--backend", "cpu", "--demo", "2", "--vocab", "32", "--d-model", "16",
                     "--n-heads", "2", "--n-layers", "1", "--d-ff", "32", "--slots", "2",
                     "--cache-size", "64", "--decode-block", "4", "--prefill-bucket", "8",
                     "--metrics-dump", str(path)]) == 0
    snap = json.loads(path.read_text())
    assert snap["engine.completed"] == 2
    assert f"metrics snapshot -> {path}" in capsys.readouterr().out


def test_coordinator_cli_metrics_dump(capsys):
    from distributed_ml_pytorch_tpu_torch.coord import cli
    from distributed_ml_pytorch_tpu_torch.launch import _free_port

    assert cli.main(["--port", _free_port(), "--n-params", "100", "--timeout", "0.3",
                     "--metrics-dump", "-"]) == 0
    out = capsys.readouterr().out
    snap = json.loads(out[out.index("{\n"):])
    assert snap["coord.events_dropped"] == 0 and "coord.fleet.events_total" in snap


# ------------------------------------------------------------ coordinator

def test_coordinator_log_promotes_to_recorder():
    from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator

    c = Coordinator(None, 16, lease=10.0)
    c.recorder = obs.SpanRecorder("coord", "coord")
    c._log("hello plane")
    rows = [e for e in c.recorder.snapshot() if e["name"] == "coord"]
    assert rows and rows[-1]["meta"]["msg"] == "hello plane"


def test_rollback_completion_writes_flight_dump(tmp_path):
    """A completed rollback barrier writes the coordinator's timeline: the
    MTTR ships with the window that explains it (the JAX test's script)."""
    from distributed_ml_pytorch_tpu_torch.coord.coordinator import (
        KIND_SHARD,
        KIND_WORKER,
        Coordinator,
        encode_join,
        encode_renew,
        encode_rollback_done,
        encode_snapshot_done,
    )
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    clock = [0.0]
    c = Coordinator(None, 100, lease=100.0, speculation=False, clock=lambda: clock[0],
                    manifest_dir=str(tmp_path), auto_rollback=True, rollback_loss_factor=1.5,
                    rollback_cooldown=50.0, rollback_timeout=20.0)
    c.recorder = obs.SpanRecorder("coord", "coord")
    c.obs_dir = str(tmp_path / "obs")
    c.handle(1, MessageCode.CoordJoin, encode_join(KIND_SHARD, 3))
    c.handle(4, MessageCode.CoordJoin, encode_join(KIND_WORKER, 5))
    mv = c.shard_map.version
    c.trigger_snapshot()
    c.tick()
    c.handle(1, MessageCode.SnapshotDone, encode_snapshot_done(1, mv, 0, 100, 12, 12))
    c.handle(4, MessageCode.LeaseRenew, encode_renew(5, 1, 1, 1.0, loss_ewma=2.0))
    clock[0] = 1.0
    c.tick()
    c.handle(4, MessageCode.LeaseRenew, encode_renew(5, 2, 2, 1.0, loss_ewma=3.5))
    clock[0] = 2.0
    c.tick()
    assert c._roll is not None
    c.handle(1, MessageCode.RollbackDone, encode_rollback_done(1, mv, 0, 100, 12))
    assert c.rollbacks_done == 1
    (dump,) = [d for d in os.listdir(c.obs_dir) if "rollback1" in d]
    text = open(os.path.join(c.obs_dir, dump)).read()
    assert "ROLLBACK 1 started" in text and "complete" in text


# ---------------------------------------------------------- reliable wire

def _pair(**opts):
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_world

    world, _ = make_world(2, reliable=True, reliable_opts=opts)
    return world[0], world[1]


def test_corr_id_rides_reliability_envelope():
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    a, b = _pair()
    try:
        with obs.corr_scope(31337):
            b.send(MessageCode.GradientUpdate, np.arange(4, dtype=np.float32))
        obs.set_corr(0)
        msg = a.recv(timeout=5)
        assert msg is not None and obs.current_corr() == 31337
    finally:
        obs.set_corr(0)
        a.close()
        b.close()


def test_transport_emits_wire_stats_event_on_close():
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    a, b = _pair()
    rec = obs.SpanRecorder("w", "wire")
    b.recorder = rec
    b.send(MessageCode.GradientUpdate, np.ones(4, np.float32))
    assert a.recv(timeout=5) is not None and b.flush(timeout=5)
    a.close()
    b.close()
    (stats,) = [e for e in rec.snapshot() if e["name"] == "wire-stats"]
    assert stats["meta"]["sent"] == 1 and stats["meta"]["acked"] == 1


def _chaos_log_lines(with_recorder: bool) -> str:
    """The JAX test's script: 30 pushes through a faulty reliable world
    whose timeout never fires; the chaos log is a function of the seed."""
    from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosPlan, FaultRule
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode, make_world

    plan = ChaosPlan([FaultRule(code=int(MessageCode.ReliableFrame), drop=0.2, dup=0.2)],
                     seed=11)
    world, log = make_world(2, reliable=True, plan=plan,
                            reliable_opts=dict(ack_timeout=30.0, max_backoff=60.0))
    a, b = world[0], world[1]
    recs = []
    if with_recorder:
        for i, t in enumerate((a, b)):
            t.recorder = obs.SpanRecorder(f"r{i}", "wire")
            recs.append(t.recorder)
    got = 0
    try:
        for i in range(30):
            with obs.corr_scope():
                b.send(MessageCode.GradientUpdate, np.full(8, float(i), np.float32))
        idle_since = time.monotonic()
        while time.monotonic() - idle_since < 0.3:
            if a.recv(timeout=0.1) is not None:
                got += 1
                idle_since = time.monotonic()
    finally:
        obs.set_corr(0)
        a.detach()
        b.detach()
    assert got > 0
    if with_recorder:
        assert sum(r.total for r in recs) > 0
    return log.lines()


def test_recorder_never_perturbs_chaos_log():
    without = _chaos_log_lines(with_recorder=False)
    assert _chaos_log_lines(with_recorder=True) == without
    assert "drop" in without or "dup" in without


# ------------------------------------------------------ the verbose report

@pytest.mark.parametrize("case", ["mixed", "perfect", "all_wrong"])
def test_classification_report_prints_the_jax_text(case, capsys):
    pytest.importorskip("sklearn")
    from distributed_ml_pytorch_tpu.data import CIFAR10_CLASSES

    rng = np.random.default_rng(3)
    y_true = rng.integers(0, 10, 300)
    y_pred = {"mixed": np.where(rng.random(300) < 0.6, y_true, rng.integers(0, 10, 300)),
              "perfect": y_true.copy(), "all_wrong": (y_true + 1) % 10}[case]
    acc = float((y_pred == y_true).mean())
    jmetrics.print_classification_report(y_true, y_pred, CIFAR10_CLASSES, 1.25, acc)
    ref = capsys.readouterr().out
    metrics.print_classification_report(y_true, y_pred, CIFAR10_CLASSES, 1.25, acc)
    assert capsys.readouterr().out == ref and "weighted avg" in ref


def test_trainer_verbose_eval_prints_the_report(capsys):
    import torch

    from distributed_ml_pytorch_tpu_torch.data import CIFAR10_CLASSES
    from distributed_ml_pytorch_tpu_torch.training.trainer import evaluate

    y = np.arange(20) % 10

    def eval_step(images, labels):
        return torch.tensor(0.5), labels.clone()

    loss, acc = evaluate(eval_step, np.zeros((20, 1), np.float32), y, 8, "cpu", verbose=True)
    out = capsys.readouterr().out
    assert acc == 1.0 and loss == 1.5
    assert out.startswith("Loss: 1.500\nAccuracy: 1.000\n")
    assert all(name in out for name in CIFAR10_CLASSES) and "macro avg" in out
