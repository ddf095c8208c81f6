"""The port's ``bench_all`` legs on the CPU at tiny widths, and the timing and
FLOP plumbing under them (``utils/devtime.py``, ``utils/flops.py``) against
the JAX package's."""

import json
import os
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
        bench_all.main(["--device", "cpu", "--legs", "moe"])
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
              "single_mode_scanned_throughput", "async_ps_push_pull_overhead"]


def test_ps_legs_on_cpu_emit_the_jax_metric_names(capsys, monkeypatch, tmp_path):
    """Config 3's legs at ``--tiny`` on the CPU: five processes, then a
    server and a chunked worker against single mode; every record under the
    JAX metric name, the rates positive."""
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
