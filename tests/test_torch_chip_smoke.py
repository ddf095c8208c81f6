"""``chip_smoke.py`` phases 18, 19 and 20 rehearsed on the CPU at tiny widths
(phase 20 with LeNet: its worlds run host code beside the kernels),
phases 21, 22 and 23 (the elastic plane, the durability and health
barriers, the multi-tenant scheduler) with LeNet, and phase 24 (gray
failure with LeNet, the serving fleet at a narrow width).

There is no card here, so ``ops.attention``'s CUDA wrappers are routed to
their plain versions, counting a launch where the kernel would launch, and
the CPU path's plain versions are routed through those wrappers: the
phases' recording of one layer's tensors, their launch-count checks, the
row-chunked plain check, the K-step and resume comparisons and the bench
legs then run as on the card (the error checks compare plain with plain).
The fused backward's dQ-partials cap is lowered so that the tiny batch 4
takes the split backward and batch 1 keeps the fused one, as 4 × 32768 and
1 × 32768 do at the real cap.
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from distributed_ml_pytorch_tpu_torch.ops import attention as at  # noqa: E402


@pytest.fixture
def routed(monkeypatch, tmp_path):
    plain_fwd, plain_bwd = at.flash_fwd_plain, at.flash_bwd_fused_plain

    def counted(name, fn):
        def launch(*args):
            at.launches[name] += 1
            return fn(*args)
        return launch

    monkeypatch.setattr(at, "flash_fwd_cuda", counted("flash_fwd", plain_fwd))
    monkeypatch.setattr(at, "flash_bwd_fused_cuda", counted("flash_bwd_fused", plain_bwd))
    monkeypatch.setattr(at, "flash_bwd_dq_cuda",
                        counted("flash_bwd_dq", lambda *a: plain_bwd(*a)[0]))
    monkeypatch.setattr(at, "flash_bwd_dkv_cuda",
                        counted("flash_bwd_dkv", lambda *a: plain_bwd(*a)[1:]))
    monkeypatch.setattr(at, "flash_fwd_plain", lambda *a: at.flash_fwd_cuda(*a))
    monkeypatch.setattr(at, "flash_bwd_fused_plain", lambda *a: at.flash_bwd_fused_cuda(*a))
    monkeypatch.setattr(at, "flash_bwd_split_plain",
                        lambda *a: (at.flash_bwd_dq_cuda(*a), *at.flash_bwd_dkv_cuda(*a)))
    # the tiny shape (2 heads of 32, 256 tokens): batch 1's partials equal
    # the cap (the comparison is strict: fused), batch 4's pass it (split)
    monkeypatch.setattr(at, "FUSED_BWD_PARTIALS_CAP", 1 * 2 * 256 * 32 * 4)
    monkeypatch.setattr(cs, "device_ms", lambda fn, iters=200: float(fn() is not None))
    monkeypatch.setattr(cs, "SMOKE_LM_DIR", str(tmp_path / "smoke_lm"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lines(capsys):
    return {d["phase"]: d for d in (json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                                    if ln.startswith('{"phase"'))}


def test_long_context_phase(routed, capsys):
    launches, errors = cs.phase_long_context(torch, device="cpu", tiny=True)
    # (a) 4 steps of 2 layers: K4 twice a layer (remat), K5 once; (b) 2 steps
    assert launches == {"flash_fwd": 16 + 8, "flash_bwd_fused": 8, "flash_bwd_dq": 4,
                        "flash_bwd_dkv": 4}
    assert all(0.0 <= e <= 1e-5 for e in errors.values())
    lines = _lines(capsys)
    fused, split = lines["long_context_fused"], lines["long_context_split"]
    assert fused["ok"] and fused["checked_bh"] == [0, 1]
    assert set(fused["kernels"]) == {"flash_fwd", "flash_bwd_fused"}
    assert split["ok"] and split["checked_bh"] == [0, 7]
    assert set(split["kernels"]) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    assert split["kernels"]["flash_bwd_dq"]["launches_per_step"] == 2


def test_long_context_phase_fails_where_the_rule_keeps_the_fused_backward(routed,
                                                                          monkeypatch):
    monkeypatch.setattr(at, "FUSED_BWD_PARTIALS_CAP", 6 * 1024 ** 3)
    with pytest.raises(cs.SmokeFailure, match="must pick the split backward"):
        cs.phase_long_context(torch, device="cpu", tiny=True)


def test_lm_flags_phase(routed, capsys):
    cycle = {"metric": "async_ps_chunked_device_cycle", "value": 1.0}
    launches = cs.phase_lm_flags(torch, cycle, device="cpu", tiny=True)
    # the counted runs: each backward's graphed 8-step run, 2 layers, remat
    assert launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 16
    assert launches["flash_bwd_fused"] == 16 and launches["flash_fwd"] == 64
    lines = _lines(capsys)
    split, fused = lines["lm_flags"]["split"], lines["lm_flags"]["fused"]
    assert split["graphed_equals_eager"] and split["resumed_equals_uninterrupted"]
    assert split["checkpoints"] == [4, 8] and split["resumed_from"] == 4
    # on the CPU the fused backward is deterministic too
    assert fused["graphed_vs_eager_rel_l2"] == fused["resumed_vs_uninterrupted_rel_l2"] == 0.0
    records = lines["main_path_bench_legs"]["records"]
    assert records[0] == cycle
    assert [r["metric"] for r in records[1:3]] == ["steps_to_99pct_test_accuracy",
                                                   "ps_transport_roundtrip_python_acks_off"]


def test_codec_plane_phase(capsys, monkeypatch, tmp_path):
    """Phase 20 rehearsed on the CPU with LeNet (no kernel launches there):
    (a) int8 pushes under Adasum across three processes, every push at the
    int8 frame size of LeNet's vector, sent = acked = applied and a restore
    bit for bit; (b) the sharded world with top-k pushes and a server-side
    sgdm over each shard's range, restored with its m and v; (c) delta
    pulls, every pull after the first a top-k delta; (d) the wire_bytes
    leg at ``--tiny``."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.utils.serialization import flat_size

    monkeypatch.setattr(cs, "SMOKE_CODEC_DIR", str(tmp_path / "codec"))
    monkeypatch.setattr(cs, "SMOKE_CODEC_SHARDED_DIR", str(tmp_path / "codec_sharded"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        launches = cs.phase_codec_plane(
            torch, {}, None, {}, backend="cpu", model="lenet",
            bench_args=("--legs", "wire_bytes", "--device", "cpu", "--tiny"))
    finally:
        torch.set_num_threads(prev)
    lines = _lines(capsys)
    sizes = cs.codec_sizes(flat_size(get_model("lenet", device="cpu")))
    a = lines["codec_processes"]
    assert a["apply_seq"] == sum(w["pushes_sent"] for w in a["per_worker"].values()) > 0
    assert all(w["frame_floats"] == sizes["int8_push"] and w["acked_pushes"] == w["pushes_sent"]
               for w in a["per_worker"].values())
    assert a["restored_bit_equal"] and a["server_messages"].get("GradientUpdate") is None
    b = lines["codec_sharded_processes"]
    assert [s["topk_pairs"] for s in b["per_shard"].values()] == sizes["shard_topk_pairs"]
    assert all(s["optimizer"]["state_floats"] == 2 * (s["range"][1] - s["range"][0])
               for s in b["per_shard"].values())
    c = lines["codec_delta_pull"]
    assert c["full_installs"] == 1 and c["delta_installs"] == c["pulls_answered"] - 1
    assert c["reply_floats_delta"] == sizes["delta_reply"] and c["view_bit_equal"]
    assert len(lines["wire_bytes_bench_leg"]["records"]) == cs.WIRE_BYTES_RECORDS
    assert cs.codec_sizes(2_472_266) == cs.ALEXNET_CODEC_SIZES
    assert not any(launches.values())  # the CPU runs the plain versions


def test_elastic_processes_phase(capsys, monkeypatch, tmp_path):
    """Phase 21 (a) rehearsed on the CPU with LeNet: the coordinator's
    process and four ranks through the CLI entries, a third worker joining,
    shard rank 1 killed; the map sequence v1, v2, v3 (and v4, empty, once
    the survivor leaves), one install of the fresh half whose CRC is the
    first installer's, the survivor's pushes accounted exactly and no
    timeout on a live link."""
    monkeypatch.setattr(cs, "SMOKE_ELASTIC_DIR", str(tmp_path / "elastic"))
    # LeNet on the CPU runs ~100 steps/s: a shorter lease and a paced step
    # keep the death and its detection inside every worker's run
    monkeypatch.setattr(cs, "ELASTIC_LEASE", 1.0)
    monkeypatch.setenv("SMOKE_ELASTIC_STEP_S", "0.01")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    launches = cs.phase_elastic_processes(backend="cpu", model="lenet", steps=250,
                                          joiner_steps=200, join_at=20, kill_at=60,
                                          joiner_warm=5, batch=16, epochs=1,
                                          joiner_epochs=1)
    a = _lines(capsys)["elastic_processes"]
    assert a["ok"] and len(a["map_events"]) == 4
    surv = a["survivor"]
    assert surv["stats"]["installs"] == 1 and surv["applied"] + surv["stale_dropped"] == \
        surv["sent_to_it"]
    assert set(a["per_worker"]) == {"2", "3", "4"}
    assert all(w["adopted_v3_s_after_kill"] > 0 for w in a["per_worker"].values())
    assert not any(launches.values())  # the CPU runs the plain versions


def test_elastic_chaos_and_speculation_phases(capsys, monkeypatch):
    """Phase 21 (b) and (c) rehearsed on the CPU with LeNet: the chaos
    acceptance world's log byte-identical across runs and devices, and a
    speculated straggler's tail applied once a shard."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        log = cs.phase_chaos_world(torch, model="lenet", device="cpu")
        cs.phase_speculation(model="lenet", device="cpu")
    finally:
        torch.set_num_threads(prev)
    lines = _lines(capsys)
    b, c = lines["elastic_chaos_world"], lines["elastic_speculation"]
    assert b["ok"] and log and b["counts"]["drop"] > 0 and b["counts"]["dup"] > 0
    assert c["ok"] and len(c["straggler_decisions"]) == 1
    assert all(s["spec_applied"] == 1 and s["spec_dropped"] == 1
               for s in c["shard_stats"].values())


def test_durability_phase_recovery_drill(capsys, tmp_path):
    """Phase 22 (a) rehearsed on the CPU with LeNet: the recovery drill's
    gates (a validated manifest, restored apply seqs at least its own, WAL
    records replayed, acked <= applied, every shard serving again) and the
    chaos log equal across two runs."""
    counts = cs.phase_recovery_drill(torch, str(tmp_path), model="lenet", device="cpu")
    a = _lines(capsys)["recovery_drill"]
    assert a["ok"] and a["replayed_records"] > 0 and a["mttr_ms"] > 0
    for shard, seq in a["restored_apply_seqs"].items():
        assert seq >= a["manifest_apply_seqs"][str(1 + int(shard))]
    assert not any(counts.values())  # the CPU runs the plain versions


def test_durability_phase_health_and_coordfail(capsys, tmp_path):
    """Phase 22 (b) and (c) rehearsed on the CPU with LeNet, through
    ``phase_durability``'s parts: a watchdog rollback that a fresh restore
    reproduces bit for bit, the poisoned worker revoked, and the
    coordinator's death survived with no member evicted."""
    cs.phase_health(torch, str(tmp_path), model="lenet", device="cpu")
    cs.phase_coordfail(torch, str(tmp_path), model="lenet", device="cpu")
    lines = _lines(capsys)
    b, c = lines["health"], lines["coordfail"]
    assert b["ok"] and b["rollbacks"] >= 1 and b["revoked_workers"] >= 1
    assert 0 < b["reject_rate_pct"] < 100 and b["nack_round_trips"] > 0
    assert c["ok"] and c["epochs"] == [1, 2] and c["steps_lost"] == 0


def test_sched_phase(capsys):
    """Phase 23 rehearsed on the CPU with LeNet: the scheduler drill's gates
    (one preempt and one resume, a clean ledger, WAL records replayed, the
    resumed shard bit-identical, acked <= applied, drops, the chaos log equal
    across three runs), the coordinator's death with a shard parked (epochs
    1 then 2, no eviction, nothing stranded) and the serving burst that
    prices the borrowed slot."""
    launches = cs.phase_sched(torch, model="lenet", device="cpu")
    lines = _lines(capsys)
    a, b, c = lines["sched_drill"], lines["coordfail_preempt"], lines["sched_serving"]
    assert a["ok"] and a["replayed_records"] > 0 and a["preempt_mttr_ms"] > 0
    assert a["resume_mttr_ms"] > 0 and all(n > 0 for n in a["held_pushes"].values())
    assert b["ok"] and b["epochs"] == [1, 2] and b["steps_lost"] == 0
    assert c["ok"] and c["serve_tokens_per_s"] > 0 and c["sched_goodput_uplift"] > 0
    assert c["decode_steps"] > 0 and c["reference_calls"] == 2 * c["decode_steps"]
    assert not any(launches.values())  # the CPU runs the plain versions



def test_gray_fleet_phase(capsys):
    """Phase 24 rehearsed on the CPU: the gray drill with LeNet (the
    contract, the unmanaged leg with no probation and the same chaos log)
    and the serving fleet at a narrow width (probation bends the first
    request, every stream token-identical to the uninterrupted run across
    the crash, a KvMigrate handoff, the autoscaler's spawn and retire, and
    the reference once a layer and decode step, K8 never)."""
    launches = cs.phase_gray_fleet(torch, model="lenet", device="cpu",
                                   width=["--d-model", "32", "--n-heads", "4", "--d-ff", "64",
                                          "--vocab", "64"])
    lines = _lines(capsys)
    a, b = lines["gray_drill"], lines["fleet"]
    assert a["ok"] and a["gray"]["quarantines"] >= 1 and a["gray"]["evictions"] == 0
    assert a["detect_latency_ms"] >= 0 and a["containment_mttr_ms"] > 0
    assert a["victim_slice_goodput_contained"] > 0 and a["victim_slice_goodput_unmanaged"] > 0
    assert b["ok"] and b["migrations"] >= 1 and b["handoffs"] >= 1 and b["gray_first_engine"] != 0
    assert b["autoscaler"]["scaled_up"] == 1 and b["autoscaler"]["scaled_down"] == 1
    assert b["decode_steps"] > 0 and b["reference_calls"] == 2 * b["decode_steps"]
    assert not any(launches.values())  # the CPU runs the plain versions


def test_model_families_phase(routed, capsys):
    """Phase 25 at the rehearsal's sizes: ResNet trainer steps (both stems,
    both dtypes), the ResNet-18 DownPour world, the MoE LM's steps with one
    layer's attention checked and its blocked generate against the plain
    decode path."""
    launches, errors = cs.phase_model_families(torch, device="cpu", tiny=True)
    lines = _lines(capsys)
    assert list(lines) == ["resnet_trainer_steps", "resnet_downpour_world", "moe_lm_steps",
                           "moe_generate", "model_families"]
    runs = lines["resnet_trainer_steps"]["runs"]
    assert [(r["model"], r["dtype"]) for r in runs] == [
        ("resnet18", "float32"), ("resnet18", "bfloat16"), ("resnet50", "float32"),
        ("resnet50", "bfloat16")]
    assert all(r["losses"][-1] < r["losses"][0] for r in runs)
    assert lines["resnet_downpour_world"]["flat_floats"] == 11_173_962
    n_layers = 2  # bench_all.TINY_LM
    assert launches == {"flash_fwd": n_layers * cs.MOE_STEPS,
                        "flash_bwd_fused": n_layers * cs.MOE_STEPS,
                        "decode_attention": 0, "flat_axpy": 0}
    gen = lines["moe_generate"]
    assert gen["reference_calls"] == n_layers * gen["padded_steps"]
    assert gen["rows_equal_plain_path"] == gen["batch"]
    assert set(errors) == {"flash_fwd", "flash_bwd_fused", "flat_axpy"}
