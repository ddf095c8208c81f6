"""The port's ``bench_all`` legs on the CPU at tiny widths, and the timing and
FLOP plumbing under them (``utils/devtime.py``, ``utils/flops.py``) against
the JAX package's."""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.utils import flops as jflops
from distributed_ml_pytorch_tpu_torch import bench_all
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.utils import flops as tflops
from distributed_ml_pytorch_tpu_torch.utils.devtime import DeviceTiming, device_time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(bench_all.TINY_LM, pos_encoding="rope")
LM_METRICS = ["transformer_lm_seq8192_train_throughput", "gpt2_small_seq2048_train_throughput",
              "gpt2_small_seq8192_train_throughput"]
LADDER_METRICS = [f"conv_epilogue_{name}_{tag}_fwdbwd"
                  for name in ("conv1_tail", "conv2_tail", "conv5_tail", "bias_relu")
                  for tag in ("unfused", "fused")]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def spies(monkeypatch):
    """Count which train-step builder ``bench_lm`` takes."""
    calls = {"fused_head": 0, "ad": 0}

    def spy(key, real):
        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(bench_all, "make_fused_head_sgd_step",
                        spy("fused_head", bench_all.make_fused_head_sgd_step))
    monkeypatch.setattr(bench_all, "make_fsdp_lm_train_step",
                        spy("ad", bench_all.make_fsdp_lm_train_step))
    return calls


@pytest.mark.parametrize("head", [True, False])
def test_bench_lm_takes_the_fused_head_step_for_a_head_model(spies, head):
    # head=False returns hidden states, so the AD step's CE runs over d_model
    # classes: keep the vocabulary within them
    lm = TransformerLM(**dict(TINY, vocab_size=64), head=head, device="cpu")
    before = [p.detach().clone() for p in lm.parameters()]
    rate = bench_all.bench_lm(lm, batch=2, seq=32, n_long=2, tag="tiny")
    assert spies == ({"fused_head": 1, "ad": 0} if head else {"fused_head": 0, "ad": 1})
    assert rate.step_kind == ("fused-head" if head else "AD")
    assert rate > 0 and rate.source == "wallclock" and rate.step_seconds > 0
    assert rate.mfu is None  # no peak for the CPU
    # 2 warm-up + 2 timed steps trained the model
    assert any(not torch.equal(a, p) for a, p in zip(before, lm.parameters()))
    dense = sum(m.weight.numel() for m in lm.modules() if isinstance(m, torch.nn.Linear))
    assert rate.flops_per_step >= 6 * dense * 2 * 32


def test_bench_all_main_on_cpu_emits_the_jax_metric_names(capsys, spies):
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "lm,conv_epilogue"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == LM_METRICS + LADDER_METRICS
    assert spies == {"fused_head": 3, "ad": 0}
    for r in recs:
        assert set(r) >= {"config", "metric", "value", "unit", "hardware", "note"}
        assert r["hardware"] == "1x cpu" and r["value"] > 0
        assert r["config"] == (6 if r["metric"] in LM_METRICS else 1)
        assert "wallclock" in r["note"]
    assert all("--tiny" in r["note"] for r in recs[:3])
    # the names are the JAX harness's own
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        src = fh.read()
    for m in LM_METRICS:
        assert f'"{m}"' in src, m
    assert 'f"conv_epilogue_{name}_{tag}_fwdbwd"' in src
    assert 'f"conv_epilogue_bias_relu_{tag}_fwdbwd"' in src


ALEXNET_METRICS = ["alexnet_cifar10_train_throughput",
                   "alexnet_cifar10_train_throughput_large_batch",
                   "alexnet_cifar10_train_throughput_large_batch_unfused",
                   "alexnet_cifar10_train_throughput_grad_accum"]


def test_alexnet_leg_on_cpu_emits_the_jax_metric_names(capsys):
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "alexnet"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == ALEXNET_METRICS
    k = bench_all.TINY_SCAN_K
    for r, (batch, fused, micro) in zip(recs, [(4, False, None), (8, True, None),
                                               (8, False, None), (8, True, 2)]):
        assert r["config"] == 1 and r["unit"] == "images/sec/chip" and r["value"] > 0
        assert r["hardware"] == "1x cpu" and "wallclock" in r["note"] and "--tiny" in r["note"]
        assert r["batch"] == batch and r["fused_epilogue"] is fused
        assert r["steps_per_dispatch"] == k and r["microbatch"] == micro
        assert r["flops_per_step"] == 6 * 14_957_056 * batch
        # two warm-up dispatches of K steps
        assert len(r["warmup_losses"]) == 2 * k and all(np.isfinite(r["warmup_losses"]))
    # the fused and unfused large-batch legs train the same weights on the
    # same batches: the epilogue changes kernels, never numerics
    assert recs[1]["warmup_losses"] == recs[2]["warmup_losses"]
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        src = fh.read()
    for m in ALEXNET_METRICS[:2] + ALEXNET_METRICS[3:]:
        assert f'"{m}"' in src, m


def test_alexnet_macs_per_layer_match_a_hand_count():
    from distributed_ml_pytorch_tpu_torch.models import get_model

    macs = tflops.conv_linear_macs(get_model("alexnet", device="cpu"), (1, 32, 32, 3))
    # out H*W * out C * in C * k*k: 8*8*64*3*11*11, 4*4*192*64*5*5, 2*2*384*192*3*3,
    # 2*2*256*384*3*3, 2*2*256*256*3*3; classifier 256*10
    assert macs == {"conv1": 1_486_848, "conv2": 4_915_200, "conv3": 2_654_208,
                    "conv4": 3_538_944, "conv5": 2_359_296, "classifier": 2_560}
    fused = get_model("alexnet", fused_epilogue=True, device="cpu")
    assert tflops.conv_linear_macs(fused, (2, 32, 32, 3)) == {k: 2 * v for k, v in macs.items()}
    assert tflops.cnn_train_flops(sum(macs.values()), 1024) == 6 * 14_957_056 * 1024


def test_make_batch_is_the_jax_harness_batch():
    import bench

    images, labels = bench_all.make_batch(16)
    ref_images, ref_labels = bench.make_batch(16)
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(labels, ref_labels)
    assert labels.dtype == np.int64


def test_alexnet_downpour_step_launches_no_kernel_on_cpu():
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv, fused_update

    before = (dict(fused_conv.launches), fused_update.launches)
    step = bench_all.alexnet_step(2, True, "cpu", downpour=True)
    losses = [float(step()) for _ in range(2)]
    assert all(np.isfinite(losses)) and losses[0] != losses[1]
    assert (dict(fused_conv.launches), fused_update.launches) == before


def test_bench_all_main_rejects_unknown_legs(capsys):
    with pytest.raises(SystemExit):
        bench_all.main(["--device", "cpu", "--legs", "vgg"])
    assert "unknown" in capsys.readouterr().err


def test_compute_microbench_phase_on_cpu():
    out = bench_all.compute_microbench_phase("cpu", batch=4)
    assert list(out) == LADDER_METRICS
    assert all(v["fwd_us"] > 0 and v["fwdbwd_us"] > 0 for v in out.values())


# ------------------------------------------------------------------ devtime, flops

def test_device_time_on_cpu_is_wallclock():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    t = device_time(fn, torch.ones(3), calls=4, warmup=2)
    assert isinstance(t, DeviceTiming) and t.source == "wallclock"
    assert t.calls == 4 and len(calls) == 6 and t.per_call_s > 0
    assert t.per_call_ms == t.per_call_s * 1e3
    with pytest.raises(ValueError, match="warmup"):
        device_time(fn, torch.ones(1), warmup=0)
    with pytest.raises(ValueError, match="no tensor"):
        device_time(lambda: None, calls=1, warmup=1)
    # the first tensor of a nested result places the timing
    assert device_time(lambda: {"a": [None, torch.zeros(1)]}, calls=1, warmup=1).source == \
        "wallclock"


def _event(name, corr, device, start_us=0.0, end_us=0.0):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, id=corr, device_type=device,
                           time_range=SimpleNamespace(start=start_us, end=end_us),
                           self_device_time_total=end_us - start_us)


@pytest.mark.parametrize("kernels_back,lost", [((1, 2, 3), 0), ((2, 3), 1), ((), 3)])
def test_tally_counts_launches_whose_kernel_the_profiler_lost(kernels_back, lost):
    # three launches (correlation ids 1-3) and a memset with no launch call;
    # the kernels that came back are timed, gapped and counted by name
    from distributed_ml_pytorch_tpu_torch.utils.devprof import tally

    cpu, gpu = "cpu", "cuda"
    events = [_event("aten::relu", 0, cpu), _event("cudaLaunchKernel", 1, cpu),
              _event("cudaLaunchKernel", 2, cpu), _event("cuLaunchKernelEx", 3, cpu),
              _event("Memset (Device)", 9, gpu, 0.0, 1.0)]
    spans = {1: ("k_a", 10.0, 14.0), 2: ("k_b", 20.0, 30.0), 3: ("k_a", 31.0, 35.0)}
    events += [_event(spans[c][0], c, gpu, *spans[c][1:]) for c in kernels_back]
    per_kernel, calls, gaps, n_lost = tally(events, gpu)
    assert n_lost == lost
    want_calls = {"Memset (Device)": 1}
    for c in kernels_back:
        want_calls[spans[c][0]] = want_calls.get(spans[c][0], 0) + 1
    assert calls == want_calls
    assert per_kernel["Memset (Device)"] == pytest.approx(1e-3)
    if kernels_back == (1, 2, 3):
        assert per_kernel == pytest.approx({"Memset (Device)": 1e-3, "k_a": 8e-3, "k_b": 10e-3})
        # idle before each kernel: k_a 9 µs after the memset and 1 µs after k_b
        assert gaps == pytest.approx({"k_a": 10e-3, "k_b": 6e-3})


def test_tally_leaves_out_the_first_launches_and_their_kernels():
    # two warm-up launches (the first lost, as the profiler may lose the
    # first kernel after it starts), then the profiled launches 5 and 6
    from distributed_ml_pytorch_tpu_torch.utils.devprof import tally

    cpu, gpu = "cpu", "cuda"
    events = [_event("cudaLaunchKernel", 6, cpu, 40.0), _event("cudaLaunchKernel", 1, cpu, 1.0),
              _event("cudaLaunchKernel", 2, cpu, 2.0), _event("cudaLaunchKernel", 5, cpu, 30.0),
              _event("warm_add", 2, gpu, 3.0, 4.0), _event("k_a", 5, gpu, 50.0, 52.0),
              _event("k_b", 6, gpu, 55.0, 58.0)]
    per_kernel, calls, gaps, lost = tally(events, gpu, skip_launches=2)
    assert lost == 0 and calls == {"k_a": 1, "k_b": 1}
    assert per_kernel == pytest.approx({"k_a": 2e-3, "k_b": 3e-3})
    assert gaps == pytest.approx({"k_b": 3e-3})
    # without the skip, the lost warm-up launch is counted
    assert tally(events, gpu)[3] == 1


def test_tally_does_not_count_captured_launches_as_lost():
    # launch 2 is made inside a stream capture (a graph node: nothing runs);
    # the graph's replay (correlation 7) brings back two kernels
    from distributed_ml_pytorch_tpu_torch.utils.devprof import _captured, tally

    cpu, gpu = "cpu", "cuda"
    events = [_event("cudaLaunchKernel", 1, cpu, 1.0),
              _event("cudaStreamBeginCapture", 3, cpu, 2.0),
              _event("cudaLaunchKernel", 2, cpu, 3.0), _event("cudaStreamEndCapture", 4, cpu, 4.0),
              _event("cudaGraphLaunch", 7, cpu, 5.0), _event("k_a", 1, gpu, 6.0, 7.0),
              _event("k_a", 7, gpu, 8.0, 9.0), _event("k_b", 7, gpu, 9.0, 11.0)]
    per_kernel, calls, _gaps, lost = tally(events, gpu)
    assert lost == 0 and _captured(events, gpu) == {2}
    assert calls == {"k_a": 2, "k_b": 1}
    # without the capture window the captured launch reads as lost
    assert tally([e for e in events if "Capture" not in e.name], gpu)[3] == 1


@pytest.mark.parametrize("hybrid,analytic", [(1.0e12, 1.1e12), (1.0e12, 2.0e12), (None, 1e12),
                                             (5.0, 0.0)])
def test_check_flops_agreement_matches_jax(hybrid, analytic):
    assert tflops.check_flops_agreement(hybrid, analytic) == \
        jflops.check_flops_agreement(hybrid, analytic)


def test_utilization():
    name = "NVIDIA H100 80GB HBM3"
    # the float32 (non-tensor) peak: 67 TFLOP/s
    assert tflops.utilization(67e12 * 0.5, 1.0, name, "f32")[1] == pytest.approx(0.5)
    tf, mfu = tflops.utilization(989.4e12 * 0.25, 1.0, name)
    assert tf == pytest.approx(247.35) and mfu == pytest.approx(0.25)
    assert tflops.utilization(1e12, 2.0, "cpu") == (0.5, None)
    assert tflops.utilization(None, 1.0, name) == (None, None)
    assert tflops.utilization(1e12, 0.0, name) == (None, None)
    # the JAX function's arithmetic, where both know the device
    jtf, _ = jflops.utilization(3e12, 1.5)
    assert tflops.utilization(3e12, 1.5, "cpu")[0] == pytest.approx(jtf)


def test_rate_record_fields():
    r = bench_all.Rate.make(1000.0, 2e12, 0.5, "NVIDIA H100 80GB HBM3")
    rec = r.record_fields()
    assert rec["flops_per_step"] == 2e12 and rec["tflops"] == 4.0
    assert rec["mfu"] == round(4e12 / 989.4e12, 4)
    assert "MFU" in r.mfu_note() and float(r) == 1000.0
    assert rec["mfu_peak"] == "bf16" and "peak" not in r.mfu_note()
    r32 = bench_all.Rate.make(1000.0, 67e12, 1.0, "NVIDIA H100 80GB HBM3", peak="f32")
    assert r32.record_fields()["mfu"] == 1.0 and r32.record_fields()["mfu_peak"] == "f32"
    assert "of the f32 peak" in r32.mfu_note()
    assert bench_all.Rate.make(1.0, None, 0.5).record_fields() == {}
    assert np.isclose(bench_all.Rate.make(1.0, 1e12, 1.0, "cpu").tflops, 1.0)


PS_METRICS = ["async_ps_4worker_aggregate_throughput", "async_ps_gpu_worker_throughput",
              "single_mode_scanned_throughput", "async_ps_push_pull_overhead",
              "async_ps_chunked_device_cycle"]


def test_ps_legs_on_cpu_emit_the_jax_metric_names(capsys, monkeypatch, tmp_path):
    """Config 3's legs at ``--tiny`` on the CPU: five processes, then a
    server and a chunked worker against single mode, then the chunked device
    cycle; every record under the JAX metric name, the rates positive."""
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "ps"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == PS_METRICS
    assert all(r["config"] == 3 and "--tiny" in r["note"] for r in recs)
    assert all(r["value"] > 0 for r in recs[:3])
    assert recs[0]["hardware"] == "1x cpu, 5 processes"
    assert os.listdir(tmp_path) == []  # every CSV went to a temporary directory


def test_steady_rate_from_csv_matches_a_hand_made_csv(tmp_path):
    """Ten records: gaps 1, 1, 1, 1, then 0.5, 0, 0, 1, 0.5 s. The second
    half of the nine gaps is the last five (mean 0.4 s): 64 / 0.4 = 160
    images/s over 10 records; fewer than 8 records or a missing file give
    None."""
    path = tmp_path / "node1.csv"
    offsets = [0, 1, 2, 3, 4, 4.5, 4.5, 4.5, 5.5, 6.0]
    rows = ["index,timestamp,iteration,training_loss"] + [
        f"{i},2026-01-02 03:04:{5 + t:09.6f},{i},2.3" for i, t in enumerate(offsets)]
    path.write_text("\n".join(rows) + "\n")
    rate, n = bench_all._steady_rate_from_csv(str(path), 64)
    assert n == 10 and rate == pytest.approx(160.0, rel=1e-12)
    # the JAX harness's pandas reader on the same file
    pytest.importorskip("pandas")
    sys.path.insert(0, ROOT)
    try:
        import bench_all as jbench
    finally:
        sys.path.remove(ROOT)
    jrate, jn = jbench._steady_rate_from_csv(str(path), 64)
    assert jn == n and jrate == pytest.approx(rate, rel=1e-12)
    path.write_text("\n".join(rows[:8]) + "\n")
    assert bench_all._steady_rate_from_csv(str(path), 64) is None
    assert bench_all._steady_rate_from_csv(str(tmp_path / "missing.csv"), 64) is None


SHARDED_METRICS = (["sharded_ps_per_shard_apply_k1", "sharded_ps_per_shard_apply_k2",
                    "sharded_ps_per_shard_apply_k4", "sharded_ps_e2e_push_rtt_k1",
                    "sharded_ps_e2e_push_rtt_k2"]
                   + [f"sharded_ps_k{k}_aggregate_throughput" for k in (1, 2, 4)])


def test_sharded_ps_leg_on_cpu_emits_the_jax_metric_names(capsys, monkeypatch, tmp_path):
    """Config 3's sharded leg at ``--tiny`` on the CPU: the apply microbench
    on AlexNet's slices, the round trips against 1 and 2 shard server
    processes, and the worlds at k = 1, 2, 4; every record under the JAX
    metric name, every value positive, the apply cost falling with k."""
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "sharded_ps"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == SHARDED_METRICS
    assert all(r["config"] == 3 and r["value"] > 0 for r in recs)
    assert recs[0]["value"] > recs[2]["value"]  # 9.9 MB against 2.5 MB
    assert recs[-1]["hardware"] == "1x cpu, 6 processes" and "--tiny" in recs[-1]["note"]
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        src = fh.read()
    for name in ('f"sharded_ps_per_shard_apply_k{k}"', 'f"sharded_ps_e2e_push_rtt_k{k}"',
                 'f"sharded_ps_k{k}_aggregate_throughput"'):
        assert name in src
    assert os.listdir(tmp_path) == []


def test_transport_leg_on_cpu_emits_the_jax_metric_names(capsys):
    """Config 7's wire leg on the CPU: a 9.9 MB echo over the native and the
    Python transport, each a positive rate under the JAX metric name."""
    assert bench_all.main(["--device", "cpu", "--legs", "transport"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == ["ps_transport_roundtrip_native",
                                           "ps_transport_roundtrip_python"]
    assert all(r["config"] == 7 and r["value"] > 0 for r in recs)
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        assert 'f"ps_transport_roundtrip_{kind}"' in fh.read()


def test_lm_32k_leg_on_cpu_emits_the_jax_metric_name(capsys):
    """Config 6's long-context leg at ``--tiny`` widths: one (1, S) sequence,
    remat and the chunked loss, two warm-up and two timed steps, every loss
    in the record; the FLOPs are the JAX leg's 6ND with remat."""
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "lm_32k"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == ["gpt2_small_seq32768_train_throughput"]
    r = recs[0]
    assert r["config"] == 6 and r["value"] > 0 and "--tiny" in r["note"]
    assert r["seq"] == bench_all.TINY_32K_SEQ and r["loss_chunk"] == bench_all.TINY_32K_CHUNK
    assert len(r["losses"]) == 4 and all(np.isfinite(r["losses"]))
    lm = TransformerLM(**bench_all.TINY_LM, max_len=bench_all.TINY_32K_SEQ, device="cpu")
    n = sum(p.numel() for name, p in lm.named_parameters() if "embed" not in name)
    tiny = bench_all.TINY_LM
    assert r["flops_per_step"] == jflops.lm_train_flops_6nd(
        n, 1, bench_all.TINY_32K_SEQ, tiny["n_heads"], tiny["d_model"] // tiny["n_heads"],
        tiny["n_layers"], remat=True)
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        assert '"gpt2_small_seq32768_train_throughput"' in fh.read()
    assert (bench_all.LM_32K_SEQ, bench_all.LM_32K_CHUNK) == (32768, 2048)


def test_device_cycle_is_the_cadence_of_one_push_and_one_pull(capsys):
    """The device cycle's two dispatches are the DownPour schedule's runs at
    n_push = n_pull = 10 in both packages (1 step, then 9), and the leg
    emits the JAX metric name; on the CPU nothing is captured or launched."""
    from distributed_ml_pytorch_tpu.parallel.async_ps import (
        downpour_chunk_schedule as jschedule,
    )
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import downpour_chunk_schedule

    runs = downpour_chunk_schedule(10, 10, 0, 10)
    assert [tuple(r) for r in jschedule(10, 10, 0, 10)] == [tuple(r) for r in runs]
    assert tuple(length for _gap, length in runs) == bench_all.CYCLE_RUNS == (1, 9)
    rate = bench_all.ps_device_cycle_phase("cpu", tiny=True)
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == ["async_ps_chunked_device_cycle"]
    r = recs[0]
    assert r["config"] == 3 and r["value"] == round(rate, 1) > 0
    assert r["k1_launches"] == 0 and r["captures"] == 0
    assert r["host_fed_images_per_s"] > 0 and r["batch"] == bench_all.TINY_CYCLE_BATCH
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        assert '"async_ps_chunked_device_cycle"' in fh.read()


RELIABILITY_METRICS = [f"ps_transport_roundtrip_python_acks_{m}" for m in ("off", "legacy", "on")
                       ] + ["ps_reliability_layer_overhead", "ps_reliability_ack_tax_recovered"]


def test_reliability_leg_on_cpu_emits_the_jax_metric_names(capsys):
    """Config 7's reliability leg at ``--tiny``: the Python echo with the
    reliable layer off, on the older envelope and on the current one, each
    against an echo process; the five JAX metric names, positive rates."""
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "reliability"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == RELIABILITY_METRICS
    assert all(r["config"] == 7 and "--tiny" in r["note"] for r in recs)
    assert all(r["value"] > 0 for r in recs[:3])
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        src = fh.read()
    for name in ('f"ps_transport_roundtrip_python_acks_{acks}"',
                 '"ps_reliability_layer_overhead"', '"ps_reliability_ack_tax_recovered"'):
        assert name in src


def test_steps_to_accuracy_matches_jax_at_identical_init(monkeypatch):
    """The port's half of ``bench_steps_to_accuracy`` against the JAX
    function's own pieces (its synthetic set, index stream, AlexNet,
    ``make_scan_train_step`` and ``make_eval_fn``) from JAX's seeded init,
    carried across by ``utils/interop``, cut to 20 steps in two dispatches
    of 10 and evals of 256 images (XLA's CPU convolutions take ~0.4 s a
    step): each eval's accuracy within one image (1/256), each dispatch's
    losses within the trainer tests' rtol 1e-5. The port reads the JAX
    loader's arrays (``tests/test_torch_data.py`` holds the two loaders
    equal), which saves a second 60,000-image synthesis."""
    import jax
    import jax.numpy as jnp

    from distributed_ml_pytorch_tpu import data as jdata
    from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
    from distributed_ml_pytorch_tpu.training import trainer as jtr
    from distributed_ml_pytorch_tpu_torch import data as tdata

    max_steps, eval_every, n_eval = 20, 10, 256
    loaded = jdata.load_cifar10(synthetic=True)
    monkeypatch.setattr(tdata, "load_cifar10", lambda synthetic: loaded)
    x, y, xt, yt, _ = loaded
    xe, ye = jnp.asarray(xt[:n_eval]), yt[:n_eval]
    idx = np.random.default_rng(0).integers(0, len(x), size=(max_steps // eval_every,
                                                             eval_every, 64))
    model = JAlexNet()
    state, tx = jtr.create_train_state(model, jax.random.key(0), lr=bench_all.ALEXNET_LR)
    init = jax.tree.map(np.asarray, state.params)
    scan, ev = jtr.make_scan_train_step(model, tx), jtr.make_eval_fn(model)
    curve, losses = [], []
    for sel in idx:
        state, chunk_losses = scan(state, jnp.asarray(x[sel]), jnp.asarray(y[sel]),
                                   jax.random.key(1))
        losses.append(np.asarray(chunk_losses))
        _, preds = ev(state.params, xe, jnp.asarray(ye))
        curve.append(float((np.asarray(preds) == ye).mean()))
    res = bench_all.bench_steps_to_accuracy("cpu", max_steps=max_steps, eval_every=eval_every,
                                            n_eval=n_eval, init=init)
    assert res["steps"] is None and len(res["curve"]) == len(curve) == 2
    np.testing.assert_allclose(res["curve"], curve, rtol=0, atol=1 / n_eval + 1e-12)
    assert res["accuracy"] == res["curve"][-1]
    for got, want in zip(res["losses"], losses):
        np.testing.assert_allclose(got, want, rtol=1e-5)


WIRE_METRICS = ([f"ps_{kind}_{mode}" for mode in ("dense", "int8", "topk")
                 for kind in ("wire_bytes_per_push", "push_roundtrips")]
                + ["ps_wire_compression_ratio_int8", "ps_wire_compression_ratio_topk"]
                + [name for tag, ratio in (("act", "act_wire_compression_ratio_int8"),
                                           ("kv_migrate", "kv_migrate_compression_ratio_int8"))
                   for name in [f"{tag}_{kind}_{mode}" for mode in ("dense", "int8")
                                for kind in ("wire_bytes_per_frame", "codec_frames_per_s")]
                   + [ratio]]
                + ["pull_reply_bytes_full", "pull_reply_bytes_delta_steady",
                   "pull_reply_roundtrips_delta", "pull_reply_compression_ratio_delta"])


def test_wire_bytes_leg_on_cpu_emits_the_jax_metric_names_and_exact_bytes(capsys):
    """Config 7's compressed-wire ladder at ``--tiny`` (65,536 floats): the
    JAX metric names in the JAX order, every frame's bytes the exact frame
    arithmetic of the codecs, every rate positive."""
    from distributed_ml_pytorch_tpu_torch.utils import codecs
    from distributed_ml_pytorch_tpu_torch.utils.compress import make_codec

    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "wire_bytes"]) == 0
    recs = {r["metric"]: r for r in (json.loads(line) for line in
                                     capsys.readouterr().out.splitlines()
                                     if line.startswith("{"))}
    assert list(recs) == WIRE_METRICS
    assert all(r["config"] == 7 and r["value"] > 0 and "--tiny" in r["note"]
               for r in recs.values())
    n = bench_all.TINY_WIRE_N
    assert recs["ps_wire_bytes_per_push_dense"]["value"] == 4 * n
    assert recs["ps_wire_bytes_per_push_int8"]["value"] == 4 * (
        12 + make_codec("int8").wire_floats(n))
    assert recs["ps_wire_bytes_per_push_topk"]["value"] == 4 * (
        12 + make_codec("topk").wire_floats(n))
    assert recs["pull_reply_bytes_full"]["value"] == 4 * (14 + n)
    assert recs["pull_reply_bytes_delta_steady"]["value"] == 4 * (
        14 + codecs.wire_floats("DeltaParams", n))
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        src = fh.read()
    for name in ('f"ps_wire_bytes_per_push_{mode}"', 'f"{tag}_codec_frames_per_s_{mode}"',
                 '"pull_reply_compression_ratio_delta"'):
        assert name in src


def test_elastic_leg_on_cpu_emits_the_jax_metric_names(capsys):
    """Config 3's elastic leg at ``--tiny`` (36 steps, the crash at 12): the
    three JAX names in order, positive rates, and the windows split at the
    crash and at worker 1's first step on the post-crash map."""
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "elastic"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == [f"elastic_rebalance_throughput_{w}"
                                           for w in ("before", "during", "after")]
    assert all(r["config"] == 3 and r["value"] > 0 and r["unit"] == "images/sec/worker"
               and "--tiny" in r["note"] for r in recs)
    assert "steps 4-12" in recs[0]["note"] and "steps 12-" in recs[1]["note"]
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        assert 'f"elastic_rebalance_throughput_{name}"' in fh.read()


DURABILITY_LEGS = {
    "recovery": [("recovery_mttr", "ms"), ("recovery_restore", "ms")],
    "coordfail": [("coordfail_mttr", "ms"), ("coordfail_restore", "ms")],
    "health": [("health_reject_rate", "%"), ("health_nack_roundtrips", "nacks"),
               ("health_rollback_mttr", "ms")],
    "sched": [("sched_preempt_mttr", "ms"), ("sched_resume_mttr", "ms"),
              ("sched_goodput_uplift", "x")],
    "gray": [("gray_victim_slice_goodput_contained", "applied updates/s"),
             ("gray_victim_slice_goodput_unmanaged", "applied updates/s"),
             ("gray_detect_latency", "ms"), ("gray_containment_mttr", "ms")],
}


@pytest.mark.parametrize("leg", list(DURABILITY_LEGS))
def test_durability_and_health_legs_on_cpu_emit_the_jax_metric_names(capsys, leg):
    """Config 3's ``recovery``, ``coordfail``, ``health``, ``sched`` and
    ``gray`` legs at ``--tiny`` (their in-process LeNet fleets): the JAX
    names and units in order, positive values, and the claims in the notes
    (zero acked loss, no worker step lost, nacks explicit, a bit-identical
    resume, the goodput breakdown, and the gray leg's host-clock figures)."""
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", leg]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["metric"], r["unit"]) for r in recs] == DURABILITY_LEGS[leg]
    # the uplift is derived from the fleet's measured day
    hw = {"sched_goodput_uplift": "derived"}
    assert all(r["config"] == 3 and r["value"] > 0
               and r["hardware"] == hw.get(r["metric"], "in-process fleet, CPU") for r in recs)
    note = recs[0]["note"]
    if leg == "recovery":
        acked, applied = (int(v) for v in re.search(r"acked=(\d+) <= applied=(\d+)",
                                                    note).groups())
        assert acked <= applied
    elif leg == "coordfail":
        assert "0 of 40 worker steps" in note and "epoch 1 -> 2" in note
    elif leg == "gray":
        assert "bit_identical=True" in note and "evictions=0" in note
        assert all("host clock" in r["note"] for r in recs)
    elif leg == "sched":
        assert "(bit-identical: True)" in recs[1]["note"]
        assert recs[2]["shared"]["train_steps"] == 112 and recs[2]["serve_tokens_per_s"] > 0
    else:
        assert "every one explicitly nacked" in note
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        src = fh.read()
    for metric, _unit in DURABILITY_LEGS[leg]:
        assert f'"{metric}"' in src, metric


# ------------------------------------------------------------------ ResNet, MoE, decode legs

RESNET_METRICS = ["resnet18_cifar10_train_throughput", "resnet18_cifar10_train_throughput_bf16",
                  "resnet50_imagenet_shape_train_throughput",
                  "resnet50_imagenet_shape_train_throughput_bf16",
                  "resnet50_hostfed_overlapped_input_throughput"]
MOE_METRICS = ["moe_lm_4expert_seq2048_train_throughput"]
DECODE_METRICS = ["gpt2_small_decode_throughput", "gpt2_small_decode_hbm_utilization",
                  "gpt2_small_decode_throughput_int8_kv"]


def _jax_src():
    with open(os.path.join(ROOT, "bench_all.py")) as fh:
        return fh.read()


def test_resnet_moe_decode_legs_on_cpu_emit_the_jax_metric_names(capsys, spies):
    assert bench_all.main(["--device", "cpu", "--tiny", "--legs", "resnet,moe,decode"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["metric"] for r in recs] == RESNET_METRICS + MOE_METRICS + DECODE_METRICS
    src = _jax_src()
    for r in recs:
        assert f'"{r["metric"]}"' in src, r["metric"]
        assert r["hardware"] == "1x cpu" and r["value"] > 0 and "--tiny" in r["note"]
    configs = [r["config"] for r in recs]
    assert configs == [4, 4, 5, 5, 5, 6, 8, 8, 8]
    # the ResNet legs' FLOPs are 6 x the MACs of a float32 copy at the leg's shape
    macs = {32: bench_all.resnet_macs("resnet18", 32, 10),
            72: bench_all.resnet_macs("resnet50", 72, 10)}
    for r in recs[:4]:
        assert r["flops_per_step"] == 6 * macs[r["image"]] * r["batch"]
        assert len(r["warmup_losses"]) == 2 * bench_all.TINY_RESNET_K
    # the MoE model has no detachable head: the AD step, as JAX's leg
    assert spies == {"fused_head": 0, "ad": 1}
    moe = recs[5]
    assert moe["capacity"] == int(2.0 * bench_all.TINY_MOE_SEQ / 4)
    assert recs[6]["new_tokens"] == bench_all.TINY_DECODE_NEW
    assert 0 < recs[7]["value"] < 100 and recs[7]["stream_bytes_per_s"] > 0


def test_moe_flops_count_the_products_run():
    """A hand count at B 1, S 8, D 4, H 2, F 6, E 2, C 8, V 5, one layer."""
    t, d, f, e, c, v = 8, 4, 6, 2, 8, 5
    dense = 2 * t * d * (4 * d + e)
    experts = 2 * 2 * e * c * d * f
    route = 2 * t * e * c * d
    attn = tflops.flash_attention_train_flops(1, 2, 8, 2, 1, causal=True)
    want = 3 * (dense + experts + route) + 2 * route + 3 * 2 * t * d * v + attn
    assert tflops.moe_lm_train_flops(1, 8, v, d, 2, 1, f, e, c) == want
    # the count the leg uses reads the model's own capacity
    from distributed_ml_pytorch_tpu_torch.models import MoETransformerLM

    moe = MoETransformerLM(vocab_size=v, d_model=d, n_heads=2, n_layers=1, d_ff=f,
                           n_experts=e, capacity_factor=2.0, max_len=8, device="cpu")
    assert bench_all.moe_lm_flops(moe, 1, 8) == want


def test_decode_timing_is_the_smoke_phase_timing():
    """``chip_smoke.py`` phase 8 times ``generate()`` through the leg's
    ``timed_generate``: one synchronized host-clock call."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        assert "bench_all.timed_generate(model, prompt, new, quant)" in fh.read()
    lm = TransformerLM(**dict(bench_all.TINY_LM, max_len=64), device="cpu")
    prompt = torch.zeros((2, 4), dtype=torch.long)
    out, seconds = bench_all.timed_generate(lm, prompt, 3)
    assert out.shape == (2, 7) and seconds > 0
