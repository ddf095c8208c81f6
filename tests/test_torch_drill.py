"""The port's drills and scenarios (``coord/drill.py``, ``coord/health.py``,
``coord.cli --drill`` and ``--health``) on the CPU at LeNet, against the
JAX package's.

- ``coord.cli --drill`` (``recovery_drill`` at seed 0 under the default
  plan): exits 0; a snapshot publishes a complete manifest, every shard is
  killed and restored from it and its WAL, the restored apply seqs are at
  least the manifest's, updates only the logs held were replayed, acked <=
  applied for every worker and shard, every shard serves pulls again, and
  the chaos log is the JAX drill's byte for byte.
- ``coordfail_drill(kill_during="snapshot")`` at seed 0: epochs 1 then 2,
  no member evicted, the new life publishes a manifest, the accounting
  closes, and the chaos log is the JAX drill's byte for byte.
- ``coord.cli --sched-demo`` (``sched_drill`` at seed 0 under the default
  plan): exits 0; one preempt and one resume, a clean ledger, updates only
  the log held replayed, the resumed shard bit-identical to the parked one,
  acked <= applied for every worker and shard, drops in the chaos log, and
  the chaos log, the grants and the scheduler's decisions equal the JAX
  drill's. Without the manifest gate (``require_manifest=False``) both
  packages report the same violation: the resume finds no manifest.
- ``coordfail_drill(kill_during="preempt")`` at seed 0: the coordinator
  dies with a shard parked, the new life (epoch 2) restores the park,
  evicts no one, strands nothing and resumes the shard bit for bit, and the
  chaos log is the JAX drill's byte for byte.
- ``coord.cli --health`` (``health_scenario`` at seed 0): exits 0; at least
  one watchdog rollback with every shard reporting, each shard's rolled
  back vector equal to a fresh server's restore of the same files bit for
  bit, the poisoned worker revoked, every quarantined push nacked and no
  quarantined push's delivery envelope among the records appended to a
  WAL, and the chaos log equal to the JAX chaos layer's decisions for the
  same push script.
- Both CLI runs leave nothing under the temporary directory.

A drill's chaos log is a function of the plan and the step script, not of
the model (the faults sit on the pull channel, and the SDC decisions are
keyed by push index), so the JAX drills run on a one-layer model here: they
then take seconds instead of minutes. The JAX health scenario itself is
not run (its own acceptance test is marked slow in the JAX suite): the
JAX side is its chaos layer, fed the poisoned worker's push script through
a JAX ``ReliableTransport`` on both shard stars.
"""

import os
import re
import tempfile

import numpy as np
import pytest

from distributed_ml_pytorch_tpu_torch.coord import cli as tcli
from distributed_ml_pytorch_tpu_torch.coord import drill as tdrill
from distributed_ml_pytorch_tpu_torch.coord import health as thealth
from distributed_ml_pytorch_tpu_torch.coord.manifest import FleetManifest


@pytest.fixture(scope="module")
def jax_fixture():
    """A one-layer softmax model over the synthetic CIFAR-10 set, the JAX
    drills' ``(x, y, grad_fn, params0)``."""
    import jax
    import jax.numpy as jnp

    from distributed_ml_pytorch_tpu.data import load_cifar10

    x, y, *_ = load_cifar10(n_train=256, n_test=32, synthetic=True)

    @jax.jit
    def grad_fn(p, bx, by, rng):
        def loss_fn(q):
            logits = bx.reshape(bx.shape[0], -1) @ q["w"] + q["b"]
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.take_along_axis(logp, by[:, None], 1))

        return jax.value_and_grad(loss_fn)(p)

    p0 = {"w": 1e-3 * jax.random.normal(jax.random.key(0), (3072, 10)), "b": jnp.zeros(10)}
    return x, y, grad_fn, p0


def _capture(monkeypatch, tmp_path, mod, name):
    """Wrap ``mod.name`` so the CLI's run keeps its whole result, its state
    under ``tmp_path``; the demo's own temporary directory goes under
    ``tmp_path/demo``, which the run must leave empty."""
    kept = {}
    real = getattr(mod, name)

    def wrapped(**kw):
        kw["base_dir"] = str(tmp_path / name)
        os.makedirs(kw["base_dir"], exist_ok=True)
        kept["out"] = real(**kw)
        return kept["out"]

    monkeypatch.setattr(mod, name, wrapped)
    os.makedirs(tmp_path / "demo")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "demo"))
    return kept


def test_cli_drill_recovers_every_shard_lossfree_with_the_jax_chaos_log(
        monkeypatch, tmp_path, jax_fixture):
    from distributed_ml_pytorch_tpu.coord import drill as jdrill

    kept = _capture(monkeypatch, tmp_path, tdrill, "recovery_drill")
    assert tcli.main(["--drill", "--backend", "cpu", "--model", "lenet", "--seed", "0"]) == 0
    assert os.listdir(tmp_path / "demo") == []
    out = kept["out"]
    assert out["ok"] and not out["errors"], (out["errors"], out["events"][-5:])
    manifest = FleetManifest.from_dict(out["manifest"]).validate()
    assert sorted(out["restored_apply_seqs"]) == [0, 1]
    for i, seq in out["restored_apply_seqs"].items():
        assert seq >= manifest.entry_for(1 + i).apply_seq
    assert out["replayed_updates"] > 0 and out["served_again"]
    for i, by_worker in out["acked"].items():
        for j, acked in by_worker.items():
            assert acked <= out["applied"][i][j], (i, j, out["acked"], out["applied"])
    assert out["mttr_s"] is not None and out["restore_s"] is not None
    ref = jdrill.recovery_drill(base_dir=str(tmp_path / "jax"), seed=0,
                                plan=jdrill.default_drill_plan(0), fixture=jax_fixture)
    assert ref["ok"], ref["errors"]
    assert out["chaos_lines"] and out["chaos_lines"] == ref["chaos_lines"]


def test_coordfail_drill_survives_the_coordinators_death_with_the_jax_chaos_log(
        tmp_path, jax_fixture):
    from distributed_ml_pytorch_tpu.coord import drill as jdrill

    out = tdrill.coordfail_drill(base_dir=str(tmp_path / "port"), seed=0, device="cpu")
    assert out["ok"], (out["errors"], out["violations"], out["events"], out["events2"])
    assert out["epochs"] == (1, 2) and out["evictions"] == []
    assert out["manifests_written"][1] >= 1 and out["accounting_ok"]
    assert out["map_versions"][1] >= out["map_versions"][0]
    assert set(out["member_epochs"].values()) == {2}
    assert out["mttr_s"] is not None
    assert sum(len(v) for v in out["losses"].values()) == 2 * 20  # no step lost
    ref = jdrill.coordfail_drill(base_dir=str(tmp_path / "jax"), seed=0, fixture=jax_fixture)
    assert ref["ok"], (ref["errors"], ref["violations"])
    assert out["chaos_lines"] and out["chaos_lines"] == ref["chaos_lines"]


def _sched_gates(out):
    s = out["sched"]
    assert out["ok"] and not out["errors"] and not out["violations"], (
        out["errors"], out["violations"], out["events"][-8:])
    assert (s["preempts_done"], s["resumes_done"], s["audit"]) == (1, 1, [])
    assert out["replayed_updates"] > 0 and out["bit_identical"] is True
    for i, by_worker in out["acked"].items():
        for j, acked in by_worker.items():
            assert acked <= out["applied"][i][j], (i, j, out["acked"], out["applied"])
    assert out["chaos_counts"].get("drop", 0) > 0
    assert all(n > 0 for n in out["held_pushes"].values())


def test_cli_sched_demo_parks_and_resumes_bit_for_bit_with_the_jax_chaos_log(
        monkeypatch, tmp_path, jax_fixture):
    from distributed_ml_pytorch_tpu.coord import drill as jdrill

    kept = _capture(monkeypatch, tmp_path, tdrill, "sched_drill")
    assert tcli.main(["--sched-demo", "--backend", "cpu", "--model", "lenet", "--seed",
                      "0"]) == 0
    assert os.listdir(tmp_path / "demo") == []
    out = kept["out"]
    _sched_gates(out)
    assert out["apply_seq_parked"] == out["apply_seq_restored"]
    ref = jdrill.sched_drill(base_dir=str(tmp_path / "jax"), seed=0,
                             plan=jdrill.default_drill_plan(0), fixture=jax_fixture)
    assert ref["ok"], (ref["errors"], ref["violations"])
    assert out["chaos_lines"] and out["chaos_lines"] == ref["chaos_lines"]
    assert out["grants"] == [tuple(g) for g in ref["grants"]]
    # the same decisions, but for what depends on the model and the clock:
    # the range, the apply seq, the incarnation and the measured times
    def decisions(events):
        return [re.sub(r"\[\d+,\d+\)|apply seq \d+|inc \d+|\(\d+ ms\)", "#", e)
                for e in events if e.startswith("sched ")]

    assert decisions(out["events"]) == decisions(ref["events"])
    assert len(decisions(out["events"])) == 7


def test_sched_drill_without_the_manifest_gate_reports_the_jax_violation(tmp_path,
                                                                         jax_fixture):
    from distributed_ml_pytorch_tpu.coord import drill as jdrill

    out = tdrill.sched_drill(base_dir=str(tmp_path / "port"), seed=0, require_manifest=False,
                             plan=tdrill.default_drill_plan(0), device="cpu")
    ref = jdrill.sched_drill(base_dir=str(tmp_path / "jax"), seed=0, require_manifest=False,
                             plan=jdrill.default_drill_plan(0), fixture=jax_fixture)
    assert not out["ok"] and not out["errors"] and out["sched"]["preempts_done"] == 1
    assert out["violations"] == ref["violations"] == [
        "resume lost acked state: rank 2 parked without a usable manifest "
        "(FileNotFoundError('no manifest for snapshot 0'))"]
    assert out["bit_identical"] is None and out["sched"]["resumes_done"] == 0


def test_coordfail_drill_preempt_variant_never_strands_the_parked_rank(tmp_path, jax_fixture):
    from distributed_ml_pytorch_tpu.coord import drill as jdrill

    out = tdrill.coordfail_drill(base_dir=str(tmp_path / "port"), seed=0,
                                 kill_during="preempt", device="cpu")
    assert out["ok"], (out["errors"], out["violations"], out["events"][-5:],
                       out["events2"][-8:])
    assert out["epochs"] == (1, 2) and out["evictions"] == [] and out["stranded"] == []
    assert out["resumes_done"] == 1 and out["bit_identical"] is True
    assert out["accounting_ok"] and out["replayed_updates"] > 0
    assert any("parked rank(s)" in e and "1 parked" in e for e in out["events2"])
    assert sum(len(v) for v in out["losses"].values()) == 2 * 20  # no step lost
    ref = jdrill.coordfail_drill(base_dir=str(tmp_path / "jax"), seed=0, kill_during="preempt",
                                 fixture=jax_fixture)
    assert ref["ok"], (ref["errors"], ref["violations"])
    assert out["chaos_lines"] and out["chaos_lines"] == ref["chaos_lines"]


def _jax_health_log(n_pushes: int) -> str:
    """The JAX chaos layer's decisions for the health scenario's push
    script: ``n_pushes`` ``ShardPush`` frames from worker 2 on each of the
    two shard stars, under the JAX plan at seed 0."""
    from distributed_ml_pytorch_tpu.coord import health as jhealth
    from distributed_ml_pytorch_tpu.utils import chaos as jchaos
    from distributed_ml_pytorch_tpu.utils import messaging as jmsg

    plan = jchaos.ChaosPlan(seed=0, sdc=jhealth.poisoned_worker_sdc(
        2, scale_after=11, scale_until=16, nan_after=16, nan_until=22, factor=-16.0))
    log = jchaos.ChaosLog()
    for _star in range(2):
        world = jmsg.InProcessTransport.create_world(3)
        hub = jchaos.FaultyTransport(world[0], plan, log=log)
        server = jmsg.ReliableTransport(hub, ack_timeout=0.05,
                                        unreliable_codes=jhealth.HEALTH_UNRELIABLE)
        worker = jmsg.ReliableTransport(hub.sibling(world[2]), ack_timeout=0.05,
                                        unreliable_codes=jhealth.HEALTH_UNRELIABLE)
        try:
            for k in range(n_pushes):
                push = np.concatenate([np.asarray([2, 0, 0, 0, 9, 0], np.float32),
                                       np.full(9, k, np.float32)])
                worker.send(jmsg.MessageCode.ShardPush, push, dst=0)
                assert server.recv(timeout=2.0) is not None
        finally:
            worker.close()
            server.close()
    return log.lines()


def test_cli_health_rolls_back_revokes_and_matches_the_jax_chaos_layer(monkeypatch, tmp_path):
    kept = _capture(monkeypatch, tmp_path, thealth, "health_scenario")
    assert tcli.main(["--health", "--backend", "cpu", "--model", "lenet", "--seed", "0"]) == 0
    assert os.listdir(tmp_path / "demo") == []
    out = kept["out"]
    assert out["ok"] and not out["errors"], (out["errors"], out["events"][-8:])
    assert out["rollbacks"] >= 1 and out["rollback_reports"] == [1, 2]
    assert out["rollback_bit_identical"] is True
    assert any("worker 4 lease REVOKED" in e for e in out["events"])  # worker 2, rank 4
    assert out["quarantined_total"] > 0 and out["nacks_explicit"] and out["accounting_ok"]
    assert out["worker_nacks"][2] > 0 and all(n >= 1 for n in out["worker_rollbacks"].values())
    # no quarantined push's envelope among the records appended to a WAL,
    # the scaled (finite) ones as well as the NaN ones
    assert out["wal_clean"] and out["quarantined_in_wal"] == 0 and out["probes"] >= 1
    assert all(n > 0 for n in out["wal_appended"].values())
    assert out["chaos_lines"] == _jax_health_log(33)
    assert out["chaos_counts"] == {"sdc-scale": 10, "sdc-nan": 12}
