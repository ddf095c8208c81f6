"""The port's MPMD pipeline fleet (``coord/stages.mpmd_scenario``: a
``StageCoordinator``, four ``MpmdStage`` members and an ``MpmdDriver`` on
the reliable in-process wire) on the CPU, case for case as the JAX
``tests/test_mpmd.py``'s fleet tests, at its ``small_cfg``.

- The fleet computes what ``MpmdLocal`` computes: the fault-free run (the
  corridor, seed 0, 8 steps) equals the port's local runner at rtol 1e-5;
  ``MpmdLocal`` is held to the JAX one in ``tests/test_torch_mpmd.py``.
- A stage dies under chaos once: seeded drop, duplication and weather on
  the driver's channels, stage 1 killed at step 3 after a snapshot at step
  1; lease-expiry detection, one restart from the stage checkpoint, every
  ``(step, mb)`` applied exactly once, and the losses equal to the corridor
  at rtol 1e-5 / atol 1e-6. The chaos log is held to the JAX chaos layer's
  decisions on the driver's send script (``_jax_driver_log``: the same
  frames through a JAX ``ReliableTransport`` on the JAX ``FaultyTransport``
  under the JAX plan), not to a JAX fleet run.
- The int8 activation corridor once: the same chaos and death with
  activations and their cotangents on the int8 codec, the losses within
  rtol 5e-3 of the corridor, each stage that shipped at least 3x fewer
  floats on the wire than dense, and the same chaos log (the driver's
  frames stay dense).
- The manifest restore: stage 2 killed at step 4 and restored THROUGH the
  snapshot's ``FleetManifest``, whose records are the stage ranges.
- Speculation: a throttled stage raced and taken over by a standby; the
  loser's applications past the takeover are discarded, never applied twice.

The JAX acceptance tests take the ``lock_witness`` fixture (the JAX lock
witness of the observability plane, A 9, which this package does not have
yet): their counterparts here run without it.
"""

import tempfile
import threading

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu_torch.coord import stages as tst
from distributed_ml_pytorch_tpu_torch.parallel import mpmd

STEPS, M, S = 8, 4, 4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(**kw):
    return tst.mpmd_scenario(base_dir=tempfile.mkdtemp(prefix="mpmd_t_"), seed=0, steps=STEPS,
                             device="cpu", **kw)


@pytest.fixture(scope="module")
def corridor():
    """The fault-free fleet at seed 0: the trajectory every faulted run is
    held to."""
    out = _run()
    assert out["ok"], (out["errors"], out["events"])
    return out


def _jax_driver_log(ack_timeout: float = 2.0) -> str:
    """The JAX chaos layer's decisions for the driver's send script: each
    step's microbatch tokens to stage 0 (rank 1) and targets to the last
    stage (rank 4), 8 x 4 of each, through a JAX ``ReliableTransport`` on
    a JAX ``FaultyTransport`` world under ``default_mpmd_plan(0)``, every
    endpoint receiving until the sender's window is acked (so every
    retransmission follows a seeded loss)."""
    from distributed_ml_pytorch_tpu.coord import stages as jst
    from distributed_ml_pytorch_tpu.utils import chaos as jchaos
    from distributed_ml_pytorch_tpu.utils import messaging as jmsg

    log = jchaos.ChaosLog()
    world, _ = jchaos.FaultyTransport.wrap_world(
        jmsg.InProcessTransport.create_world(1 + S), jst.default_mpmd_plan(0), log=log)
    rel = {r: jmsg.ReliableTransport(world[r], ack_timeout=ack_timeout,
                                     max_backoff=2 * ack_timeout, max_retries=120,
                                     send_window=32, breaker_grace=60.0)
           for r in (0, 1, S)}
    got = {1: 0, S: 0}
    stop = threading.Event()

    def serve(r):
        while not stop.is_set():
            if rel[r].recv(timeout=0.05) is not None and r in got:
                got[r] += 1

    threads = [threading.Thread(target=serve, args=(r,), daemon=True) for r in rel]
    for t in threads:
        t.start()
    body = np.zeros(7 + 4 * 8, np.float32)
    try:
        for _step in range(STEPS):
            for _mb in range(M):
                rel[0].send(jmsg.MessageCode.ActivationShip, body, dst=1)
                rel[0].send(jmsg.MessageCode.ActivationShip, body, dst=S)
        assert rel[0].flush(60.0)
        assert got == {1: STEPS * M, S: STEPS * M}, got
    finally:
        stop.set()
        for t in threads:
            t.join(5)
        for r in rel.values():
            r.close()
    return log.lines()


@pytest.fixture(scope="module")
def jax_log():
    return _jax_driver_log()


def test_mpmd_fleet_matches_local_runner(corridor):
    """The fleet computes what the one-thread runner computes: the same
    losses on the same data from the same seed."""
    local = mpmd.MpmdLocal(tst.scenario_cfg(), S, M, 0.1, 0, device="cpu")
    toks, tgts = tst.scenario_data(0, STEPS, M, 4, 8, 32)
    np.testing.assert_allclose(corridor["losses"], [local.step(t, g) for t, g in
                                                    zip(toks, tgts)], rtol=1e-5)
    assert corridor["applied_ok"] and corridor["discarded_applies"] == 0
    assert corridor["stage_restarts"] == 0 and corridor["chaos_lines"] == ""


def _death_gates(out, corridor):
    assert out["ok"], (out["errors"], out["events"])
    assert out["stage_restarts"] == 1
    assert out["stage_mttr_s"] is not None and out["stage_mttr_s"] > 0
    assert any("lease expired" in e for e in out["events"])
    assert any("restored by rank" in e for e in out["events"])
    assert out["applied_ok"] and out["discarded_applies"] == 0
    assert out["chaos_counts"].get("drop", 0) > 0 and out["chaos_counts"].get("dup", 0) > 0
    assert any(k.startswith("weather") for k in out["chaos_counts"])


def test_mpmd_acceptance_stage_death_under_chaos(corridor, jax_log):
    """Stage 1 killed at step 3 under seeded drop, duplication and weather:
    detected by lease expiry, restarted from its checkpoint, the in-flight
    microbatches replayed past its watermark, nothing applied twice, and the
    loss trajectory the corridor's. The chaos log is the JAX chaos layer's
    for the same driver script. (The JAX test's lock witness belongs to the
    observability plane, A 9: not here.)"""
    out = _run(kill_stage=1, kill_at_step=3, snapshot_at_step=1,
               plan=tst.default_mpmd_plan(0))
    _death_gates(out, corridor)
    np.testing.assert_allclose(out["losses"], corridor["losses"], rtol=1e-5, atol=1e-6)
    assert out["chaos_lines"] and out["chaos_lines"] == jax_log
    assert out["timings"]["killed"] <= out["timings"]["vacated"] <= out["timings"]["restored"]


def test_mpmd_acceptance_int8_activation_corridor(corridor, jax_log):
    """The same death under chaos with activations and cotangents on the
    int8 codec: near the dense corridor, at least 3x fewer floats on each
    stage's wire, the same chaos log. (No lock witness: A 9.)"""
    out = _run(kill_stage=1, kill_at_step=3, snapshot_at_step=1,
               plan=tst.default_mpmd_plan(0), act_codec="int8")
    _death_gates(out, corridor)
    np.testing.assert_allclose(out["losses"], corridor["losses"], rtol=5e-3)
    lossy = {k: s for k, s in out["stats"].items() if s.get("act_dense_floats")}
    assert len(lossy) >= S, out["stats"]
    for name, s in lossy.items():
        assert s["act_wire_floats"] * 3 <= s["act_dense_floats"], (name, s)
    assert out["chaos_lines"] == jax_log


def test_mpmd_stage_drill_manifest_restore():
    """The snapshot barrier covers the stage checkpoints (a manifest whose
    records are the stage ranges); stage 2, killed at step 4, restores
    THROUGH it (range and apply seq checked) and replay fills the gap."""
    import os

    from distributed_ml_pytorch_tpu_torch.coord.manifest import FleetManifest

    base = tempfile.mkdtemp(prefix="mpmd_d_")
    out = tst.mpmd_scenario(base_dir=base, seed=0, steps=STEPS, kill_stage=2, kill_at_step=4,
                            snapshot_at_step=1, restore_via_manifest=True, device="cpu")
    assert out["ok"], (out["errors"], out["events"])
    manifest = FleetManifest.load(os.path.join(base, "fleet_manifest.json"))
    assert [(r.lo, r.hi) for r in manifest.shards] == mpmd.stage_param_ranges(tst.scenario_cfg(), S)
    assert out["stage_restarts"] == 1 and out["applied_ok"] and out["discarded_applies"] == 0
    assert any("snapshot 1 complete" in e for e in out["events"])
    assert out["stats"]["stage2"]["updates"] >= STEPS - 4


def test_mpmd_speculation_standby_takeover():
    """A throttled stage member is raced by a standby that loads its
    checkpoint: the placement flips to the standby, which did the work; the
    victim goes passive and its racing applications are discarded."""
    out = tst.mpmd_scenario(base_dir=tempfile.mkdtemp(prefix="mpmd_s_"), seed=0, steps=12,
                            throttle_stage=1, throttle=0.2, standby=True,
                            straggler_factor=5.0, lease=0.5, device="cpu")
    assert out["ok"], (out["errors"], out["events"])
    assert any("stage straggler" in e for e in out["events"])
    assert any("TAKEOVER" in e or ("restored by rank" in e and "stage 1" in e)
               for e in out["events"]), out["events"]
    assert out["standby"].stats["updates"] > 0
    assert out["placement"].entries[1].rank == out["standby"].rank
    assert out["applied_ok"]


def test_mpmd_leg_on_cpu_emits_the_jax_metric_names(capsys):
    """``bench_all --legs mpmd --tiny`` on the CPU: the JAX ``mpmd_phase``'s
    metric names and units in order, positive values, the applied
    accounting in the MTTR's note, and the bubble fraction's
    ``bubble_attribution`` from the flight recorders' timeline, which the
    JAX ``check_bubble_attribution`` accepts too (its fractions sum to 1
    within 0.02). At ``--tiny`` the window after the death is too short to
    rate."""
    import json
    import os
    import sys

    from distributed_ml_pytorch_tpu_torch import bench_all

    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "mpmd"]) == 0
    cap = capsys.readouterr()
    recs = [json.loads(line) for line in cap.out.splitlines() if line.startswith("{")]
    assert [(r["metric"], r["unit"]) for r in recs] == [
        ("mpmd_pipeline_steady", "tokens/sec"), ("mpmd_bubble_fraction", "%"),
        ("mpmd_stage_restart_mttr", "ms"), ("mpmd_stage_kill_throughput_before", "tokens/sec"),
        ("mpmd_stage_kill_throughput_during", "tokens/sec")]
    assert all(r["config"] == 3 and r["value"] > 0
               and r["hardware"] == "in-process fleet, CPU" for r in recs)
    assert "applied accounting OK" in recs[2]["note"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import bench_all as jax_bench
    finally:
        sys.path.remove(root)
    attr = recs[1]["bubble_attribution"]
    assert bench_all.check_bubble_attribution(attr) == jax_bench.check_bubble_attribution(attr)
    assert attr["stages"] == 4 and abs(sum(attr["fractions"].values()) - 1.0) <= 0.02
    assert "window after too short" in cap.out + cap.err
    with open(os.path.join(root, "bench_all.py")) as fh:
        jax_src = fh.read()
    for r in recs:
        name = r["metric"].replace("_before", "_{name}").replace("_during", "_{name}")
        assert f'"{r["metric"]}"' in jax_src or f'f"{name}"' in jax_src, r["metric"]
